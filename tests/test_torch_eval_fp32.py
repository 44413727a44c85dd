"""The fp32 evaluation forward (what ``test`` and every epoch's validation
run) and the bf16 serving forward, checked on the CPU.

On the card their attentions take the keep-masked tensor-core kernel with
its keep multiply compiled out ("mma_nokeep": every unmasked fp32 call at
head sizes 32/64/128 over at most 128 keys; bf16's one query over more than
16 keys) and ``fused_patch_select`` runs its seven products against a plan
(``ops.gemm.gemm_plan``), in fp32 on ``gemm_tf32x3``. Here: (a) the plan
in Python at every attention of both forwards, and the calls that keep
their kernels; (b) the products and attentions the CUDA sources launch,
parsed, against the rows the wrappers plan; (c) the plain versions, which
the CPU runs and the card's kernels are held to, against the JAX package
in fp32 at 1e-6 of the largest JAX output (the Pallas kernels in interpret
mode), and the whole eval forward at a narrow width.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qa_tiger_tpu.models import clip_text as j_clip_text
from qa_tiger_tpu.models import modules as JM
from qa_tiger_tpu.models.qa_tiger import qa_tiger_config as j_config
from qa_tiger_tpu.models.qa_tiger import qa_tiger_forward, qa_tiger_init
from qa_tiger_tpu.ops.pallas.attention import attention_wide as j_attention_wide
from qa_tiger_tpu.ops.pallas.patch_select import fused_patch_select as j_patch_select
from qa_tiger_tpu_torch.convert import params_from_jax
from qa_tiger_tpu_torch.models import clip_text as t_clip_text
from qa_tiger_tpu_torch.models import qa_tiger_config
from qa_tiger_tpu_torch.models.modules import PatchSelecter
from qa_tiger_tpu_torch.ops import attention as A
from qa_tiger_tpu_torch.ops import gemm as GM
from qa_tiger_tpu_torch.ops import patch_select as PS
from qa_tiger_tpu_torch.training import AVQARunner

CSRC = Path(__file__).resolve().parents[1] / "qa_tiger_tpu_torch" / "csrc"
F32, BF = torch.float32, torch.bfloat16
T, P, S = 60, 14, 77
# (Sq, Sk) of each attention of one forward at configs/qa-tiger/vitl14.py
# (8 heads of 64): AVQ's question-guided, self and cross attention,
# TempMoE's and QstGrounding's one query, PatchSelecter's self- and
# cross-attention
EVAL_CALLS = {"avq_qst": (T, S), "avq_self": (T, T), "avq_cross": (T, T), "tempmoe": (1, T),
              "grounding": (1, 2), "patch_self": (P, P), "patch_cross": (2, P)}
# the kernel each bf16 serving call takes: only TempMoE's is new
BF16_KERNELS = {"avq_qst": "mma", "avq_self": "mma", "avq_cross": "mma",
                "tempmoe": "mma_nokeep", "grounding": "mma_short", "patch_self": "mma_short",
                "patch_cross": "mma_short"}


def _within(got, want, rel: float = 1e-6) -> None:
    """|got - want| <= rel * max|want| everywhere."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


# ---------------------------------------------------------------------------
# (a) the plan at every attention of the two forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", sorted(EVAL_CALLS))
def test_eval_and_serving_attentions_plan_onto_tensor_cores(call):
    """fp32: every call of the eval forward plans "mma_nokeep" at its own
    head size; bf16: TempMoE's 1 x 60 does too, the others keep the mma and
    short kernels; each within an H100's opt-in shared memory."""
    sq, sk = EVAL_CALLS[call]
    for dtype, kernel in ((F32, "mma_nokeep"), (BF, BF16_KERNELS[call])):
        plan = A.attention_plan(dtype, sq, sk, 64)
        assert (plan.kernel, plan.head) == (kernel, 64)
        assert plan.route == A.KERNEL_ROUTES[kernel] != "fma"
        assert 0 < plan.smem_bytes <= A.H100_SMEM_OPTIN


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("call", sorted(EVAL_CALLS))
def test_calls_the_new_kernel_does_not_take_keep_their_kernels(call, dtype):
    """A mask or a key bias, a keep mask, more than 128 keys, or an fp32 head
    of 256 or 512 lanes: in bf16 the kernel each took before "mma_nokeep"
    (the staged FMA kernel, the mma and short kernels, "mma_keep", the tiled
    FMA kernel); in fp32 a mask or key bias stays on "mma_nokeep", more than
    128 keys take its key-tiled form, a wide head the lane split, a keep
    mask "mma_keep"."""
    sq, sk = EVAL_CALLS[call]
    biased = A.attention_plan(dtype, sq, sk, 64, has_bias=True).kernel
    assert biased == ("mma_nokeep" if dtype == F32 else
                      "staged" if call == "tempmoe" else BF16_KERNELS[call])
    assert A.attention_plan(dtype, sq, sk, 64, has_keep=True).kernel == "mma_keep"
    long_keys = A.attention_plan(dtype, sq, 129, 64).kernel
    assert long_keys == ("mma_nokeep_tiled" if dtype == F32 else "tiled" if sq < 16 else "mma")
    if dtype == F32:
        for hd in (256, 512):
            assert A.attention_plan(F32, sq, sk, hd).kernel == "lane_split"


def test_kernel_names_and_routes_match_the_library_codes():
    """The C codes (common.cuh AttentionKernel / AttentionRoute, read here
    from the source) and the Python names agree for "mma_keep" and
    "mma_nokeep"."""
    text = (CSRC / "common.cuh").read_text()
    kernels = re.search(r"enum AttentionKernel \{(.*?)\};", text, re.S).group(1)
    codes = dict((name, int(code)) for name, code in
                 re.findall(r"ATT_KERNEL_(\w+) = (-?\d+)", kernels))
    assert codes["MMA_NOKEEP"] == A.KERNEL_NAMES.index("mma_nokeep") == 8
    assert codes["MMA_KEEP"] == A.KERNEL_NAMES.index("mma_keep")
    routes = re.search(r"enum AttentionRoute \{(.*?)\};", text, re.S).group(1)
    rcodes = dict((name, int(code)) for name, code in re.findall(r"ATT_ROUTE_(\w+) = (\d+)",
                                                                 routes))
    assert rcodes["MMA_NOKEEP"] == A.ROUTES.index("mma_nokeep") == 4
    assert A.KERNEL_ROUTES["mma_nokeep"] == "mma_nokeep"


@pytest.mark.parametrize("sq,sk,hd,dtype,want", [
    (1, 60, 64, BF, 2 * (16 + 128) * 72),     # one warp a block: 16 q rows, k and v
    (1, 60, 64, F32, 4 * (16 + 128) * 68),
    (60, 77, 64, F32, 4 * (64 + 160) * 68),   # 64 query rows a block
    (14, 14, 64, F32, 4 * 4 * 3 * 16 * 68),   # four problems a block
    (1, 2, 64, F32, 4 * 4 * 3 * 16 * 68),
    (2, 128, 128, F32, 4 * (16 + 256) * 132),
])
def test_nokeep_shared_memory(sq, sk, hd, dtype, want):
    """The forward's shared memory by form (common.cuh
    attention_keep_smem_bytes): rows of hd lanes plus 16 bytes. A keep mask
    keeps the 64-row form at one query over more than 16 keys."""
    assert A.attention_plan(dtype, sq, sk, hd).smem_bytes == want
    keep = A.attention_plan(dtype, sq, sk, hd, has_keep=True).smem_bytes
    if sq <= 16 < sk:
        es = 2 if dtype == BF else 4
        assert keep == es * (64 + 2 * -(-sk // 16) * 16) * (hd + 16 // es)
    else:
        assert keep == want


def test_fp32_operands_of_nokeep_are_aligned_copies():
    """The wrapper hands "mma_nokeep" 16-byte readable fp32 operands: a row
    stride off 4 floats or a base off 16 bytes is copied exactly; the FMA
    kernels take the same views as they are."""
    odd_rows = torch.randn(2, 60, 3 * 128 + 1)[..., :128]
    off_base = torch.randn(2, 60, 3 * 128 + 4)[..., 1:129]
    for view in (odd_rows, off_base):
        got = A._kernel_operand(view, 2, 64, 64, "mma_nokeep")
        assert got is not view and got.is_contiguous() and torch.equal(got, view)
        assert A._kernel_operand(view, 2, 64, 64, "staged") is view
    aligned = torch.randn(2, 60, 384)[..., 128:256]
    assert A._kernel_operand(aligned, 2, 64, 64, "mma_nokeep") is aligned


# ---------------------------------------------------------------------------
# (b) what csrc/patch_select.cu launches against the wrappers' plans
# ---------------------------------------------------------------------------

def _args(text: str, start: int) -> list:
    """The top-level comma-separated arguments of the call whose "(" is at
    ``start``."""
    depth, args, cur = 0, [], ""
    for ch in text[start:]:
        if ch in "({[":
            depth += 1
            if depth == 1:
                continue
        elif ch in ")}]":
            depth -= 1
            if depth == 0:
                args.append(cur.strip())
                return args
        if ch == "," and depth == 1:
            args.append(cur.strip())
            cur = ""
        else:
            cur += ch
    raise ValueError("unbalanced call")


def _body(fn: str) -> str:
    text = (CSRC / "patch_select.cu").read_text()
    start = text.index(f"cudaError_t {fn}(")
    return text[start:text.index("\n}\n", start)]


def _launched(fn: str, env: dict) -> tuple[list, list]:
    """(M, N, K) of every planned_gemm of ``fn`` in patch_select.cu and
    (Sq, Sk) of every plan row its attentions write, in order, evaluated
    with the function's integer locals ``env``."""
    body = _body(fn)
    products = [tuple(int(eval(e, {}, dict(env))) for e in _args(body, m.end() - 1)[3:6])
                for m in re.finditer(r"planned_gemm<T, true>\(", body)]
    attns = [tuple(int(eval(e, {}, dict(env))) for e in _args(body, m.end() - 1))
             for m in re.finditer(r"plan\.attention\(", body)]
    return products, attns


@pytest.mark.parametrize("b,t,d", [(1, 3, 64), (2, 4, 512), (32, 60, 512)])
def test_eval_launch_plans_its_seven_products(b, t, d):
    """``run`` in patch_select.cu launches the seven products of
    ``patch_select_gemm_shapes`` in order, every one through planned_gemm
    (nothing through gemm_rows or gemm_tile), and its two attentions write
    the rows (P, P) and (2, P); in fp32 the plan splits none (K <= 512),
    so the launch needs no workspace."""
    bt = b * t
    env = {"M": bt * P, "Q": 2 * bt, "Dh": d // 2, "D": d, "P": P}
    products, attns = _launched("run", env)
    shapes = GM.patch_select_gemm_shapes(bt, P, d)
    assert products == shapes and attns == [(P, P), (2, P)]
    body = _body("run")
    assert "gemm_rows" not in body and "qt::gemm<" not in body and "PairLoad" not in body
    for dtype in (F32, BF):
        rows = GM.gemm_plan(dtype, shapes, 132).tolist()
        assert [tuple(r[:3]) for r in rows] == shapes and all(r[4] == -1 for r in rows)
        assert GM.plan_workspace(dtype, shapes, 132) == 0
    assert A.keep_rows(attns).tolist() == [[P, P, -1], [2, P, -1]]


@pytest.mark.parametrize("tp", [2, 4])
def test_eval_tp_stages_plan_their_products(tp):
    """The three eval stages launch, in order, the products the wrappers
    plan (``patch_select_train_tp_gemm_shapes``' tp_self, tp_cross and
    tp_mlp: the train stages' forward products), so that a rank's fp32
    products take gemm_tf32x3 as tp = 1's do; tp_self and tp_cross each
    write one attention row."""
    bt, d = 2 * 60, 512
    wl = d // tp
    want = GM.patch_select_train_tp_gemm_shapes(bt, P, d, wl)
    env = {"M": bt * P, "Q": 2 * bt, "D": d, "Wl": wl, "Hl": wl // 2, "P": P}
    for stage, attns in (("tp_self", [(P, P)]), ("tp_cross", [(2, P)]), ("tp_mlp", [])):
        products, launched_attns = _launched(stage, env)
        assert products == want[stage] and launched_attns == attns, stage
        assert "gemm_rows" not in _body(stage)


def test_planned_routes_tally_from_the_rows():
    """The routes a launch writes into its plan and attention rows are what
    ``fused_patch_select`` tallies: tf32x3 x 7 and mma_nokeep x 2 in fp32."""
    shapes = GM.patch_select_gemm_shapes(4, P, 64)
    plan = GM.gemm_plan(F32, shapes, 132)
    rows = A.keep_rows([(P, P), (2, P)])
    plan[:, 4] = 3
    rows[:, 2] = A.KERNEL_NAMES.index("mma_nokeep")

    class Kernel:
        gemm_routes, attn_routes = {}, {}

    PS.note_launch_plan(Kernel, plan, rows)
    assert Kernel.gemm_routes == {"tf32x3": 7}
    assert Kernel.attn_routes == {"mma_nokeep": 2}


# ---------------------------------------------------------------------------
# (c) the plain versions against JAX, fp32, 1e-6 of the largest JAX output
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", ["avq_qst", "avq_self", "tempmoe", "grounding"])
def test_attention_wide_plain_at_the_eval_shapes(call):
    """attention_wide's plain version (what "mma_nokeep" is held to on the
    card) at the eval forward's four shapes, 8 heads of 64, B = 2, against
    ``fused_attention_wide`` in interpret mode."""
    sq, sk = EVAL_CALLS[call]
    rng = np.random.default_rng(sq * 100 + sk)
    q, k, v = (rng.standard_normal((2, s, 512)).astype(np.float32) for s in (sq, sk, sk))
    want = j_attention_wide(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, 0.125, 8,
                            interpret=True)
    got = A.attention_wide(torch.tensor(q), torch.tensor(k), torch.tensor(v), None, 0.125, 8)
    _within(got.numpy(), want)


def test_fused_patch_select_plain_at_b2_t4():
    """fused_patch_select's plain version (the card's kernel is held to it)
    at B = 2, T = 4, the recipe's width (512, 8 heads of 64), against the
    Pallas kernel in interpret mode."""
    B, T4, D, heads = 2, 4, 512, 8
    p = jax.tree_util.tree_map(np.asarray, JM.patch_selecter_init(jax.random.PRNGKey(5), D))
    mod = PatchSelecter(D, torch.Generator().manual_seed(0))
    mod.load_state_dict(params_from_jax(p), strict=True)
    rng = np.random.default_rng(23)
    patch = rng.standard_normal((B, T4, P, D)).astype(np.float32)
    audio = rng.standard_normal((B, T4, D)).astype(np.float32)
    video = rng.standard_normal((B, T4, D)).astype(np.float32)
    want = j_patch_select(jnp.asarray(patch), jnp.asarray(audio), jnp.asarray(video), p,
                          heads, 4, True)
    got = PS.fused_patch_select(torch.tensor(patch), torch.tensor(audio), torch.tensor(video),
                                mod, heads)
    for g, w in zip(got, want):
        _within(g.detach().numpy(), w)


TINY_TOWER = dict(width=128, heads=4, layers=2, embed_dim=128)
# a narrow QA-TIGER whose attentions run at head size 32 (d_model 256, 8
# heads), one of the new kernel's head sizes
NARROW = dict(d_model=256, video_dim=128, patch_dim=96, audio_dim=32, topK=2,
              num_experts=4, num_labels=42, encoder_type="tiny-test")


def test_eval_forward_at_a_narrow_width(monkeypatch):
    """The runner's eval forward (``eval_step``'s, fp32, the plain versions
    on the CPU) against JAX's ``qa_tiger_forward`` (its fused functions
    through their plain references, as on any CPU): logits within 1e-5 of
    the largest, not the kernels' 1e-6, as the two frameworks' fp32 sums
    take other orders through the tower's two layers and the model's ~20
    products and attentions (about 1.1e-6 measured here); the loss
    ``eval_step`` reports against JAX's on the same batch."""
    from qa_tiger_tpu.training import metrics as jmet

    monkeypatch.setitem(j_clip_text.CLIP_TEXT_CONFIGS, "tiny-test", TINY_TOWER)
    monkeypatch.setitem(t_clip_text.CLIP_TEXT_CONFIGS, "tiny-test", TINY_TOWER)
    params = jax.tree_util.tree_map(np.asarray,
                                    qa_tiger_init(jax.random.PRNGKey(2), j_config(**NARROW)))
    rng = np.random.default_rng(9)
    b, t = 3, 8
    quest = np.zeros((b, S), np.int64)
    for i in range(b):
        n = int(rng.integers(5, 30))
        quest[i, 0], quest[i, 1:n], quest[i, n] = 49406, rng.integers(1, 49406, n - 1), 49407
    batch = {"quest": quest,
             "audio": rng.standard_normal((b, t, 32)).astype(np.float32),
             "video": rng.standard_normal((b, t, 128)).astype(np.float32),
             "patch": rng.standard_normal((b, t, P, 96)).astype(np.float32),
             "label": rng.integers(0, 42, b).astype(np.int32),
             "qtype_label": rng.integers(0, 9, b).astype(np.int32),
             "valid": np.ones(b, bool)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = qa_tiger_forward(jax.tree_util.tree_map(jnp.asarray, params), jb,
                            dict(j_config(**NARROW), use_fused=True))["out"]
    cfg = {"log_interval": 1, "debug": False,
           "hyper_params": {"optim": dict(lr=1e-3, betas=(0.95, 0.999), weight_decay=0.0,
                                          encoder_lr=None)}}
    runner = AVQARunner(cfg, qa_tiger_config(**NARROW), device="cpu", init_params=params)
    with torch.no_grad():
        out = runner._forward(runner._device_batch(batch), runner._eval_dtype, True)["out"]
    _within(out.numpy(), want, 1e-5)
    ce = runner.eval_step(batch)[0]
    np.testing.assert_allclose(
        ce.item(), float(jmet.masked_cross_entropy(want, jb["label"], jb["valid"])), rtol=1e-5)
