"""The fp32 extraction forward off the FMA kernels, checked on the CPU.

On the card every fp32 attention of the extraction forward runs on 3xTF32
tensor cores: at head sizes 32/64/128 the keep-masked kernel without its
keep multiply ("mma_nokeep", a mask and a key bias added to the scaled
scores) up to 128 keys and its key-tiled two-pass form past that
("mma_nokeep_tiled"); TSPM's one-head calls at 512 lanes the lane split's
two stages at one rank ("lane_split", route "tf32x3"); and
``fused_attn_ln2``'s two fp32 products run on ``gemm_tf32x3`` against the
plan its wrapper builds. Here: (a) the plans in pure Python at every path
shape (the CLIP image and text towers, ToMe's layers, TSPM's calls), the
bf16 plans unchanged, and the C source's codes and tiles against the
Python ones; (b) the port's plain versions, which the CPU runs and the
card's kernels are held to, against the JAX package in fp32 (the Pallas
kernels in interpret mode) at small widths: Sq = Sk = 150 and 200 over two
heads of 32 with a causal mask and with a key bias, one head of 256 lanes,
and ``fused_attn_ln2`` at 150 tokens; (c) on the card (``gpu`` marker,
skipped here) each new kernel against its plain version, twice bitwise,
the kernel it read back, and the library's plan against
``attention_plan``. The JAX package is imported inside the tests of (b),
so that the card's machine, which has no JAX, runs (a) and (c) with
``--noconftest``.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from qa_tiger_tpu_torch.convert import params_from_jax
from qa_tiger_tpu_torch.models.clip_text import ResidualAttentionBlock, causal_mask
from qa_tiger_tpu_torch.ops import attention as A
from qa_tiger_tpu_torch.ops import gemm as GM
from qa_tiger_tpu_torch.ops import resblock as R

CSRC = Path(__file__).resolve().parents[1] / "qa_tiger_tpu_torch" / "csrc"
F32, BF = torch.float32, torch.bfloat16
H100 = A.H100_SMEM_OPTIN


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def _nokeep_bytes(sq: int, sk: int, hd: int) -> int:
    """The fp32 forms of "mma_nokeep", restated: four problems a block at
    most 16 queries and keys, one warp a block for fewer queries over more
    keys, else 64 query rows with the problem's k and v; rows of hd + 4."""
    ld = 4 * (hd + 4)
    if sq <= 16 and sk <= 16:
        return 4 * 3 * 16 * ld
    return ((16 if sq <= 16 else 64) + 2 * _pad16(sk)) * ld


def _tiled_bytes(hd: int) -> int:
    """"mma_nokeep_tiled": 128 query rows, two stages of 64 K rows and two
    of 64 V rows, rows of hd + 4 floats."""
    return 4 * (128 + 4 * 64) * (hd + 4)


# ToMe's layers at r = 25 (``encode_tome``): 577 tokens at layer 0 without a
# key bias, 577 - 25 l at layer l with one
TOME_TOKENS = [577 - 25 * layer for layer in range(24)]
# (label, Sq, Sk, head size, mask or key bias) of each fp32 attention on the
# extraction path and TSPM's eval forward
PATH_CALLS = ([("clip_image", 577, 577, 64, False), ("text_vitl14", 77, 77, 64, True),
               ("text_rn50", 77, 77, 64, True), ("tspm_av_attn", 60, 60, 512, False),
               ("tspm_tokens_attn", 14, 14, 512, False), ("tspm_attn_ffn", 1, 14, 128, False),
               ("tspm_qst_temp", 1, 10, 128, False)]
              + [(f"tome_layer{layer}", n, n, 64, layer > 0)
                 for layer, n in enumerate(TOME_TOKENS)])


def _want_fp32(sq, sk, hd, bias):
    if hd == 512:
        return ("tf32x3", "lane_split", 2 * 128 * 144)
    if sk > 128:
        return ("mma_nokeep", "mma_nokeep_tiled", _tiled_bytes(hd))
    return ("mma_nokeep", "mma_nokeep", _nokeep_bytes(sq, sk, hd))


@pytest.mark.parametrize("label,sq,sk,hd,bias", PATH_CALLS, ids=[c[0] for c in PATH_CALLS])
def test_extraction_path_plans(label, sq, sk, hd, bias):
    """Every fp32 attention of the extraction path and TSPM's eval forward
    takes a 3xTF32 kernel at its own head size, within an H100's limit;
    none an FMA kernel."""
    plan = A.attention_plan(F32, sq, sk, hd, has_bias=bias)
    assert (plan.route, plan.kernel, plan.smem_bytes) == _want_fp32(sq, sk, hd, bias)
    assert plan.head == hd and plan.smem_bytes <= H100
    assert A.KERNEL_ROUTES[plan.kernel] == plan.route != "fma"


def _want_bf16(sq, sk, hd):
    if hd == 512:
        return "mma_wide_short" if sq <= 16 and sk <= 16 else "mma_wide"
    if sq <= 16 and sk <= 16:
        return "mma_short"
    if sq >= 16 and sk > 128 and hd == 64 and A.sm90_faster(sk):
        return "mma_sm90"
    return "mma" if sq >= 16 else "mma_nokeep"


@pytest.mark.parametrize("label,sq,sk,hd,bias", PATH_CALLS, ids=[c[0] for c in PATH_CALLS])
def test_bf16_plans_unchanged(label, sq, sk, hd, bias):
    """The same calls in bf16 keep the kernels they took before: mma, the
    short and wide kernels, "mma_nokeep" only for one query over more than
    16 keys without a mask or key bias; past 128 keys at head size 64 the
    Hopper kernel ("mma_sm90") that replaced mma's two-pass form where the
    measured rule says it is faster."""
    assert A.attention_plan(BF, sq, sk, hd, has_bias=bias).kernel == _want_bf16(sq, sk, hd)


@pytest.mark.parametrize("sq,sk,hd,limit,bias,want", [
    (60, 60, 512, H100, True, ("fma", "wide")),        # a mask or key bias at 512 lanes
    (14, 14, 512, H100, True, ("fma", "staged")),
    (577, 577, 64, 100_000, False, ("fma", "tiled")),   # the tiled form past the limit
    (77, 77, 64, 50_000, True, ("fma", "staged")),
    (577, 577, 128, H100, False, ("mma_nokeep", "mma_nokeep_tiled")),
    (129, 129, 32, H100, True, ("mma_nokeep", "mma_nokeep_tiled")),
    (300, 300, 48, H100, True, ("mma_nokeep", "mma_nokeep_tiled")),  # padded to 64
    (60, 300, 200, H100, False, ("tf32x3", "lane_split")),           # padded to 256
])
def test_fp32_plan_edges(sq, sk, hd, limit, bias, want):
    """Where a 3xTF32 kernel does not take an fp32 call (a mask or a key
    bias at 256/512 lanes, a shared-memory limit it passes) the FMA kernels
    do, as before; other head sizes run zero-padded on the next one."""
    plan = A.attention_plan(F32, sq, sk, hd, limit=limit, has_bias=bias)
    assert (plan.route, plan.kernel) == want
    assert plan.smem_bytes <= limit


def test_keep_mask_plans_unchanged():
    """A keep mask keeps "mma_keep" up to 128 keys and the FMA kernels
    past them, in both dtypes."""
    for dtype in (F32, BF):
        assert A.attention_plan(dtype, 60, 77, 64, has_keep=True).kernel == "mma_keep"
        assert A.attention_plan(dtype, 60, 129, 64, has_keep=True).route == "fma"
        assert A.attention_plan(dtype, 60, 60, 512, has_keep=True).route == "fma"


def test_c_codes_and_tiles_match_python():
    """common.cuh's kernel and route codes, the key-tiled kernel's tiles and
    the lane split's shared memory, read from the source, are the Python
    plan's."""
    text = (CSRC / "common.cuh").read_text()
    kernels = dict(re.findall(r"ATT_KERNEL_(\w+) = (-?\d+)",
                              re.search(r"enum AttentionKernel \{(.*?)\};", text, re.S).group(1)))
    assert int(kernels["MMA_NOKEEP_TILED"]) == A.KERNEL_NAMES.index("mma_nokeep_tiled") == 9
    assert int(kernels["LANES"]) == A.KERNEL_NAMES.index("lane_split") == 10
    assert len(A.KERNEL_NAMES) == len(kernels) - 1  # ATT_KERNEL_NONE
    routes = dict(re.findall(r"ATT_ROUTE_(\w+) = (\d+)",
                             re.search(r"enum AttentionRoute \{(.*?)\};", text, re.S).group(1)))
    assert int(routes["TF32X3"]) == A.ROUTES.index("tf32x3") == 5
    tiles = re.search(r"constexpr int AKT_WARPS = (\d+), AKT_THREADS = [^,]+, "
                      r"AKT_Q = AKT_WARPS \* AK_ROWS,\s+AKT_K = (\d+);", text)
    assert (16 * int(tiles.group(1)), int(tiles.group(2))) == (A._AKT_Q, A._AKT_K)
    lanes = re.search(r"ATT_LANES_SMEM = (\d+) \* (\d+) \* (\d+);", text)
    assert np.prod([int(g) for g in lanes.groups()]) == A.LANE_SPLIT_SMEM


@pytest.mark.parametrize("rows,width", [(120 * 577, 1024), (60 * 577, 1024), (256 * 77, 768),
                                        (42 * 77, 512), (4 * 77, 768)])
def test_fused_attn_ln2_gemm_plans(rows, width):
    """The fp32 plan of one fused_attn_ln2 launch: its two products (the
    qkv projection over ln_1's staged rows, out_proj) in launch order,
    unsplit, no workspace, route -1 until the kernel writes it."""
    shapes = GM.attn_gemm_shapes(rows, width)
    plan = GM.gemm_plan(F32, shapes, 132)
    assert plan[:, :3].tolist() == [list(s) for s in shapes]
    assert (plan[:, 3] >= width).all() and (plan[:, 4] == -1).all()
    assert GM.plan_workspace(F32, shapes, 132) == 0
    assert GM.gemm_plan(BF, shapes, 132)[:, 3].tolist() == [0, 0]


# ---------------------------------------------------------------------------
# (b) the plain versions against the JAX package, fp32
# ---------------------------------------------------------------------------

def _within(got, want, rel: float = 1e-6) -> None:
    """|got - want| <= rel * max|want| everywhere."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("s", [150, 200])
@pytest.mark.parametrize("masked,bias", [(True, False), (False, True), (True, True)])
def test_attention_wide_plain_against_jax(s, masked, bias):
    """attention_wide's plain version at Sq = Sk past 128 keys (the
    key-tiled kernel's calls), two heads of 32, with a causal mask and with
    ToMe's key bias, against the JAX kernel in interpret mode."""
    import jax.numpy as jnp

    from qa_tiger_tpu.models.clip_text import causal_mask as j_causal_mask
    from qa_tiger_tpu.ops.pallas.attention import attention_wide as j_attention_wide

    rng = np.random.default_rng(s + 2 * masked + bias)
    B, W, heads = 2, 64, 2
    q, k, v = (rng.standard_normal((B, s, W)).astype(np.float32) for _ in range(3))
    kb = np.log(rng.integers(1, 41, (B, s))).astype(np.float32) if bias else None
    mask = np.asarray(j_causal_mask(s)) if masked else None
    scale = 32 ** -0.5
    want = j_attention_wide(*(jnp.asarray(t) for t in (q, k, v)),
                            None if mask is None else jnp.asarray(mask), scale, heads,
                            interpret=True, key_bias=None if kb is None else jnp.asarray(kb))
    got = A.attention_wide(*(torch.from_numpy(t) for t in (q, k, v)),
                           None if mask is None else torch.from_numpy(mask), scale, heads,
                           key_bias=None if kb is None else torch.from_numpy(kb))
    assert A.attention_plan(F32, s, s, 32, has_bias=True).kernel == "mma_nokeep_tiled"
    _within(got.numpy(), np.asarray(want))


def test_one_head_256_lanes_plain_against_jax():
    """A one-head 256-lane call (the lane split's at one rank) against the
    JAX kernel in interpret mode."""
    import jax.numpy as jnp

    from qa_tiger_tpu.ops.pallas.attention import attention_wide as j_attention_wide

    rng = np.random.default_rng(256)
    q, k, v = (rng.standard_normal((2, 20, 256)).astype(np.float32) for _ in range(3))
    want = j_attention_wide(*(jnp.asarray(t) for t in (q, k, v)), None, 256 ** -0.5, 1,
                            interpret=True)
    got = A.attention_wide(*(torch.from_numpy(t) for t in (q, k, v)), None, 256 ** -0.5, 1)
    assert A.attention_plan(F32, 20, 20, 256).kernel == "lane_split"
    _within(got.numpy(), np.asarray(want))


def _ln2_params(width, seed=0):
    import jax
    import jax.numpy as jnp

    from qa_tiger_tpu.models.clip_text import resblock_init

    p = resblock_init(jax.random.PRNGKey(seed), width)
    ks = jax.random.split(jax.random.PRNGKey(seed + 1), 2)
    p["attn"]["in_proj_weight"] = 0.05 * jax.random.normal(ks[0], (3 * width, width))
    p["attn"]["in_proj_bias"] = 0.01 * jnp.arange(3 * width, dtype=jnp.float32) / width
    p["attn"]["out_proj"]["weight"] = 0.05 * jax.random.normal(ks[1], (width, width))
    p["ln_1"]["weight"] = 1.0 + 0.1 * jnp.sin(jnp.arange(width))
    p["ln_1"]["bias"] = 0.1 * jnp.cos(jnp.arange(width))
    p["ln_2"]["bias"] = 0.1 * jnp.cos(jnp.arange(width))
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.mark.parametrize("causal", [True, False])
def test_fused_attn_ln2_plain_against_jax(causal):
    """fused_attn_ln2's plain version (ln_1 as the staged rows hold it, the
    two products, the attention past 128 keys, ln_2) against the JAX
    function, its Pallas kernel in interpret mode, at 150 tokens of width
    128, four heads of 32: both outputs within 2e-6 of the largest."""
    import jax.numpy as jnp

    from qa_tiger_tpu.models.clip_text import causal_mask as j_causal_mask
    from qa_tiger_tpu.ops.pallas.resblock import fused_attn_ln2 as j_attn_ln2

    W, heads, B, S = 128, 4, 2, 150
    p = _ln2_params(W)
    block = ResidualAttentionBlock(W, 2, torch.Generator().manual_seed(0))
    block.load_state_dict(params_from_jax(p), strict=True)
    x = np.random.default_rng(5).standard_normal((B, S, W)).astype(np.float32)
    want = j_attn_ln2(jnp.asarray(x), p, j_causal_mask(S) if causal else None, heads, True)
    got = R.fused_attn_ln2(torch.from_numpy(x), block, causal_mask(S) if causal else None, heads)
    for g, w in zip(got, want):
        _within(g.detach().numpy(), np.asarray(w), 2e-6)


# ---------------------------------------------------------------------------
# (c) on the card: each new kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()


def _close(got, want) -> None:
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-4 * max(1.0, want.float().abs().max().item()), err


# (B, Sq, Sk, heads, head size, masked, key bias) at the path's shapes, fewer rows
CARD_CASES = [(2, 577, 577, 16, 64, False, False), (2, 552, 552, 16, 64, False, True),
              (3, 27, 27, 16, 64, False, True), (3, 77, 77, 12, 64, True, False),
              (2, 200, 200, 2, 32, True, True), (2, 150, 150, 3, 128, True, False),
              (5, 60, 60, 1, 512, False, False), (7, 14, 14, 1, 512, False, False),
              (2, 577, 577, 4, 256, False, False), (3, 1, 14, 4, 128, True, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,heads,hd,masked,bias", CARD_CASES)
def test_fp32_attention_kernels(cuda, b, sq, sk, heads, hd, masked, bias):
    """fp32 attention_wide on the kernel attention_plan names (read back
    from the launch), within 1e-4 of its plain version, twice bitwise; the
    library's plan is the Python one."""
    rng = np.random.default_rng(sq + sk + hd)
    qkv = _rn(rng, b, sq, 3 * heads * hd) if sq == sk else None
    W = heads * hd
    q, k, v = ((qkv[..., :W], qkv[..., W:2 * W], qkv[..., 2 * W:]) if qkv is not None
               else (_rn(rng, b, sq, W), _rn(rng, b, sk, W), _rn(rng, b, sk, W)))
    mask = torch.triu(torch.full((sq, sk), float("-inf"), device=cuda), 1) if masked else None
    kb = (torch.from_numpy(np.log(rng.integers(1, 41, (b, sk))).astype(np.float32)).cuda()
          if bias else None)
    plan = A.attention_plan(F32, sq, sk, hd, limit=A.smem_limit(cuda),
                            has_bias=masked or bias)
    assert plan.route != "fma"
    assert A.library_plan(F32, sq, sk, plan.head, has_bias=masked or bias) == (
        plan.kernel, plan.smem_bytes)
    A.attention_wide.attn_routes = {}
    got = A.attention_wide(q, k, v, mask, hd ** -0.5, heads, key_bias=kb)
    assert A.attention_wide.attn_routes == {plan.kernel: 1}
    _close(got, A._wide_reference(q, k, v, mask, hd ** -0.5, heads, kb))
    assert torch.equal(got, A.attention_wide(q, k, v, mask, hd ** -0.5, heads, key_bias=kb))


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,w,heads,causal", [(2, 577, 1024, 16, False), (4, 77, 768, 12, True),
                                                (3, 77, 512, 8, True)])
def test_fp32_fused_attn_ln2_on_tensor_cores(cuda, b, s, w, heads, causal):
    """fp32 fused_attn_ln2 at the CLIP image and text towers' blocks: both
    products on gemm_tf32x3 and the attention on its 3xTF32 kernel, as the
    launch reads them back, within 1e-4 of the plain version, twice
    bitwise."""
    rng = np.random.default_rng(s + w)
    blk = ResidualAttentionBlock(w, heads, torch.Generator().manual_seed(0)).cuda()
    x = _rn(rng, b, s, w)
    mask = causal_mask(s, device=cuda) if causal else None
    kernel = A.attention_plan(F32, s, s, w // heads, has_bias=causal).kernel
    R.fused_attn_ln2.gemm_routes, R.fused_attn_ln2.attn_routes = {}, {}
    y, h = R.fused_attn_ln2(x, blk, mask, heads)
    assert R.fused_attn_ln2.gemm_routes == {"tf32x3": 2}
    assert R.fused_attn_ln2.attn_routes == {kernel: 1}
    for g, want in zip((y, h), R._attn_ln2_plain(blk, x, heads=heads, mask=mask)):
        _close(g, want)
    y2, h2 = R.fused_attn_ln2(x, blk, mask, heads)
    assert torch.equal(y, y2) and torch.equal(h, h2)
