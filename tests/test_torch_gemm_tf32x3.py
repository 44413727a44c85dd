"""The fp32 tensor-core GEMM of the train kernels (``gemm_tf32x3``), on the CPU.

On the card the fp32 products of the forwards and backwards of
``fused_patch_select_train`` and ``fused_avq_train`` run as 3xTF32: each operand
split as x = hi + lo (both tf32, round to nearest, ties away from zero), the
product summed as lo·hi + hi·lo + hi·hi, the weight gradients cut along K
(split-K). What is plain PyTorch is checked here: the split, the plain
version of the product (against fp64 and against JAX's
``jnp.dot(precision=HIGHEST)``), the split-K plan the wrappers size the
workspace from, the plan a planned launch takes, and the lists of the
products the CUDA train forwards and backwards launch (on the card a launch
also refuses a plan that does not name its products), and of the two that
the resblock MLP half launches.

Tolerance of a product: max|got - ref| <= 1e-4 * max(1, max|ref|), the
train kernels' fp32 rule (``chip_smoke.FP32_TOL``): 3xTF32 keeps each
product to within 2^-21 of its value, so what remains is fp32 summation
order over up to 26,880 terms.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qa_tiger_tpu_torch.ops import gemm as GM

FP32_TOL = 1e-4
CSRC = Path(__file__).resolve().parents[1] / "qa_tiger_tpu_torch" / "csrc"


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _from_bits(*words: int) -> torch.Tensor:
    return torch.tensor(np.array(words, dtype=np.uint32).view(np.int32)).view(torch.float32)


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7e4, 1e30])
def test_split_drops_13_bits_and_rebuilds_x(scale):
    rng = np.random.default_rng(int(np.log10(scale) + 40))
    x = torch.from_numpy((scale * rng.standard_normal(4096)).astype(np.float32))
    hi, lo = GM.tf32_split(x)
    assert int((_bits(hi) & 0x1FFF).abs().max()) == 0
    assert int((_bits(lo) & 0x1FFF).abs().max()) == 0
    x64 = x.double()
    err = (hi.double() + lo.double() - x64).abs()
    assert bool((err <= 2.0 ** -22 * x64.abs()).all()), (err / x64.abs()).max().item()
    # hi alone keeps 11 significant bits: within 2^-11 of x
    assert bool(((hi.double() - x64).abs() <= 2.0 ** -11 * x64.abs()).all())


@pytest.mark.parametrize("word,want", [
    (0x3F801000, 0x3F802000),  # 1 + 2^-11, a tie: away from zero (even would stay at 1)
    (0xBF801000, 0xBF802000),  # the same, negative
    (0x3F803000, 0x3F804000),  # a tie above an odd kept bit
    (0x3F800FFF, 0x3F800000),  # just below a tie: down
    (0x3F801001, 0x3F802000),  # just above: up
    (0x3FFFF000, 0x40000000),  # the carry reaches the exponent: 2.0
    (0x00001000, 0x00002000),  # a subnormal tie
    (0x7F7FF000, 0x7F800000),  # past the largest tf32: inf
])
def test_split_rounds_ties_away_from_zero(word, want):
    hi, _ = GM.tf32_split(_from_bits(word))
    assert int(_bits(hi)[0]) & 0xFFFFFFFF == want


def test_split_keeps_zeros_and_infinities():
    x = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan")])
    hi, lo = GM.tf32_split(x)
    assert [int(w) & 0xFFFFFFFF for w in _bits(hi[:4])] == [0, 0x80000000, 0x7F800000, 0xFF800000]
    assert lo[:2].tolist() == [0.0, 0.0]
    assert bool(torch.isnan(lo[2:]).all()) and bool(torch.isnan(hi[4]))


# ---------------------------------------------------------------------------
# the product's plain version
# ---------------------------------------------------------------------------

# scaled-down backward products, (M, N, K): a weight gradient over the patch
# rows and over the AVQ rows, the MLP's 256-wide ones, dgrads
PRODUCTS = [(64, 64, 26880), (32, 64, 3840), (64, 32, 3840), (48, 64, 1536),
            (64, 48, 1024), (17, 33, 129), (1, 1, 1), (5, 3, 7)]


def _operands(m, n, k, a_col_major, b_nk, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((k, m) if a_col_major else (m, k), dtype=np.float32)
    b = rng.standard_normal((n, k) if b_nk else (k, n), dtype=np.float32)
    a_mat = a.T if a_col_major else a
    b_mat = b.T if b_nk else b
    return a, b, a_mat, b_mat


@pytest.mark.parametrize("b_nk", [False, True])
@pytest.mark.parametrize("a_col_major", [False, True])
@pytest.mark.parametrize("m,n,k", PRODUCTS)
def test_plain_product_against_fp64(m, n, k, a_col_major, b_nk):
    a, b, a_mat, b_mat = _operands(m, n, k, a_col_major, b_nk, m * 31 + n * 7 + k)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = GM.gemm_tf32x3_plain(ta, tb, a_col_major=a_col_major, b_nk=b_nk)
    ref = torch.from_numpy(a_mat.astype(np.float64) @ b_mat.astype(np.float64))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    err = (got.double() - ref).abs().max().item()
    assert err <= FP32_TOL * max(1.0, ref.abs().max().item()), err
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(GM.gemm_tf32x3(ta, tb, a_col_major=a_col_major, b_nk=b_nk), got)


@pytest.mark.parametrize("a_col_major", [False, True])
@pytest.mark.parametrize("m,n,k", PRODUCTS[:5])
def test_plain_product_against_jax_highest(m, n, k, a_col_major):
    a, b, a_mat, b_mat = _operands(m, n, k, a_col_major, False, m + 3 * n + k)
    got = GM.gemm_tf32x3_plain(torch.from_numpy(a), torch.from_numpy(b), a_col_major=a_col_major)
    ref = np.asarray(jnp.dot(jnp.asarray(a_mat), jnp.asarray(b_mat),
                             precision=jax.lax.Precision.HIGHEST))
    err = np.abs(got.numpy() - ref).max()
    assert err <= FP32_TOL * max(1.0, np.abs(ref).max()), err


def test_three_passes_are_needed():
    """hi·hi alone (one TF32 pass) misses the rule by orders of magnitude at a
    weight gradient's K; the three passes keep it."""
    a, b, a_mat, b_mat = _operands(64, 64, 26880, True, False, 0)
    ref = a_mat.astype(np.float64) @ b_mat.astype(np.float64)
    ah, _ = GM.tf32_split(torch.from_numpy(a_mat.copy()))
    bh, _ = GM.tf32_split(torch.from_numpy(b_mat.copy()))
    one = np.abs((ah @ bh).numpy() - ref).max()
    three = np.abs(GM.gemm_tf32x3_plain(torch.from_numpy(a), torch.from_numpy(b),
                                        a_col_major=True).numpy() - ref).max()
    limit = FP32_TOL * max(1.0, np.abs(ref).max())
    assert three <= limit < one and one > 30 * three, (one, three)


# ---------------------------------------------------------------------------
# the Hopper kernel's tile and shared memory (csrc/gemm_tf32x3.cuh)
# ---------------------------------------------------------------------------

def _kernel_constant(name: str) -> int:
    text = (CSRC / "gemm_tf32x3.cuh").read_text()
    return int(re.search(rf"\b{name} = (\d+)", text).group(1))


@pytest.mark.parametrize("name,index", [("TF_BM", 0), ("TF_BN", 1), ("TF_BK", 2)])
def test_plan_tile_is_the_kernels(name, index):
    """The split-K plan cuts K in the kernel's slabs and counts its tiles."""
    assert _kernel_constant(name) == GM.TF32X3_TILE[index]


@pytest.mark.parametrize("batch", [2, 4, 32, 64, 256, 512])
def test_moe_second_product_is_timed_as_it_runs(batch):
    """``fused_gaussian_moe``'s second product (s [b, E*H] times W2
    [E*H, D], A row-major, B as [K, N]) at every batch its main-path calls
    take is among the shapes the card checks and times ``gemm_tf32x3`` at
    (``chip_smoke.tf32x3_gemm_shapes``, which ``chip_ab.py --phases gemm``
    times for two checkouts), in bf16 and fp32 alike."""
    import chip_smoke

    D, E, H = 512, 7, 256
    shapes = chip_smoke.tf32x3_gemm_shapes()
    assert "fused_gaussian_moe" in shapes[(batch, D, E * H, False, False)]


# ---------------------------------------------------------------------------
# the split-K plan
# ---------------------------------------------------------------------------

def _backward_shapes(b):
    return (GM.patch_select_train_bwd_gemm_shapes(b * 60, 14, 512)
            + GM.avq_train_bwd_gemm_shapes(2 * b, 60, 77, 512))


PLAN_SHAPES = sorted(set(_backward_shapes(32) + _backward_shapes(2)
                         + [(1, 1, 1), (129, 127, 33), (4096, 4096, 64)]))


@pytest.mark.parametrize("sms", [132, 114, 8])
@pytest.mark.parametrize("m,n,k", PLAN_SHAPES)
def test_splitk_plan_covers_k_once(m, n, k, sms):
    bm, bn, bk = GM.TF32X3_TILE
    plan = GM.splitk_plan(m, n, k, sms)
    tiles = -(-m // bm) * -(-n // bn)
    assert plan.chunk % bk == 0 and plan.splits >= 1
    starts = [s * plan.chunk for s in range(plan.splits)]
    covered = np.zeros(k, dtype=np.int64)
    for s in starts:
        assert s < k  # no empty chunk
        covered[s:min(k, s + plan.chunk)] += 1
    assert (covered == 1).all()
    assert plan.workspace == (plan.splits * m * n if plan.splits > 1 else 0)
    if tiles >= sms:
        assert plan.splits == 1
    if plan.splits > 1:
        assert plan.chunk >= GM.MIN_SPLIT_SLABS * bk
    # blocks run one per SM: the waves each chunk's share of K costs are
    # within 10% of the fewest any allowed count gives
    waves = lambda s: -(-tiles * s // sms) / s  # noqa: E731
    allowed = range(1, max(1, -(-k // bk) // GM.MIN_SPLIT_SLABS) + 1)
    if tiles < sms:
        assert waves(plan.splits) <= min(waves(s) for s in allowed) / 0.9


@pytest.mark.parametrize("want", [1, 2, 3, 7, 100, 10_000])
@pytest.mark.parametrize("k", [1, 31, 32, 33, 3840, 26880])
def test_splitk_plan_honours_an_explicit_split(k, want):
    plan = GM.splitk_plan(64, 64, k, 132, want)
    slabs = -(-k // GM.TF32X3_TILE[2])
    assert plan.splits <= min(want, slabs)
    assert (plan.splits - 1) * plan.chunk < k <= plan.splits * plan.chunk
    # the plan of its own split count is the same plan
    assert GM.splitk_plan(64, 64, k, 132, plan.splits) == plan


def test_recipe_plans_and_workspace():
    """At B=32 on 132 SMs: the 512 x 512 weight gradients over the patch rows
    in 8 chunks (one wave of 128 blocks), 1024 x 512 in 4 (one wave),
    1536 x 512 in 8 (3 waves of 384 blocks, not one of 96), the dgrads
    (M = 26,880 or 3,840) whole; one workspace of the largest plan per
    backward, none in bf16."""
    plan = GM.splitk_plan
    assert plan(512, 512, 26880, 132).splits == 8
    assert plan(1024, 512, 26880, 132).splits == 4
    assert plan(1536, 512, 26880, 132).splits == 8
    for m, n, k in [(26880, 512, 512), (26880, 512, 1024), (26880, 512, 1536),
                    (3840, 512, 512), (3840, 256, 512), (3840, 512, 256), (4928, 512, 1024)]:
        assert plan(m, n, k, 132).splits == 1
    ps = GM.patch_select_train_bwd_gemm_shapes(32 * 60, 14, 512)
    avq = GM.avq_train_bwd_gemm_shapes(64, 60, 77, 512)
    assert GM.plan_workspace(torch.float32, ps, 132) == 8 * 1536 * 512
    assert GM.plan_workspace(torch.float32, avq, 132) == max(
        plan(m, n, k, 132).workspace for m, n, k in avq)
    assert GM.plan_workspace(torch.bfloat16, ps, 132) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [32, 1])
def test_backward_plan_rows(b, dtype):
    """The plan a backward is launched with: one int32 row (M, N, K, chunk,
    route) per product in launch order, the chunk of ``splitk_plan`` in
    fp32 and 0 in bf16, the route left for the backward to write; the
    routes it writes are tallied by name."""
    for shapes in (GM.patch_select_train_bwd_gemm_shapes(b * 60, 14, 512),
                   GM.avq_train_bwd_gemm_shapes(2 * b + 1, 60, 77, 512)):
        plan = GM.gemm_plan(dtype, shapes, 132)
        assert plan.dtype == torch.int32 and tuple(plan.shape) == (len(shapes), 5)
        for row, (m, n, k) in zip(plan.tolist(), shapes):
            chunk = GM.splitk_plan(m, n, k, 132).chunk if dtype == torch.float32 else 0
            assert row == [m, n, k, chunk, -1]
        plan[:, 4] = 3 if dtype == torch.float32 else 1

        class Kernel:
            gemm_routes = {"tf32x3": 1}

        GM.note_plan_routes(Kernel, plan)
        want = {"tf32x3": 1 + len(shapes)} if dtype == torch.float32 else {
            "tf32x3": 1, "wmma": len(shapes)}
        assert Kernel.gemm_routes == want


# ---------------------------------------------------------------------------
# the shapes lists against the CUDA backwards
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


def _launched_products(source: str, env: dict, fn: str = "backward") -> list:
    """(M, N, K) of every planned_gemm / bwd_weight_grad that ``fn`` (the
    backward or the forward) in ``source`` launches, in order, an
    attn_block_bwd call expanded into its own, evaluated with the function's
    integer locals ``env``."""
    text = (CSRC / source).read_text()
    call = re.compile(r"(planned_gemm<T, (?:true|false)>|bwd_weight_grad<T>|attn_block_bwd<T>)\(")

    def products(body):
        out = []
        for found in call.finditer(body):
            name = found.group(1)
            if name.startswith("attn_block_bwd"):
                out += block
                continue
            args = _args(body, found.end() - 1)
            mnk = args[3:6] if name.startswith("planned_gemm") else args[4:7]
            out.append(tuple(int(eval(e, {}, dict(env))) for e in mnk))
        return out

    block = []
    if "attn_block_bwd" in text:
        start = text.index("cudaError_t attn_block_bwd(")
        block = products(text[start:text.index("\n}\n", start)])
    start = text.index(f"cudaError_t {fn}(")
    return products(text[start:text.index("\n}\n", start)])


@pytest.mark.parametrize("b,t", [(1, 3), (2, 6)])
def test_patch_select_backward_shapes_are_the_launched_ones(b, t):
    bt, p, d = b * t, 14, 64
    env = {"R": bt * p, "Q2": 2 * bt, "Dh": d // 2, "D": d}
    want = _launched_products("patch_select_train.cu", env)
    assert len(want) == 14
    assert GM.patch_select_train_bwd_gemm_shapes(bt, p, d) == want


@pytest.mark.parametrize("n,t,s", [(2, 3, 5), (4, 6, 7)])
def test_avq_backward_shapes_are_the_launched_ones(n, t, s):
    d = 64
    env = {"R": n * t, "RS": n * s, "D": d}
    want = _launched_products("avq.cu", env)
    assert len(want) == 20
    assert GM.avq_train_bwd_gemm_shapes(n, t, s, d) == want


# ---------------------------------------------------------------------------
# the PatchSelecter train forward's plan
# ---------------------------------------------------------------------------

def _plan_accepts(rows: list, launched: list) -> bool:
    """planned_gemm's rule (csrc/gemm_tf32x3.cuh) replayed over a launch:
    each product takes the plan's next row, whose (M, N, K) must be its
    own, and no row may be left over (GemmPlan::done)."""
    for i, mnk in enumerate(launched):
        if i >= len(rows) or tuple(rows[i][:3]) != mnk:
            return False
    return len(rows) == len(launched)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 3, 32])
def test_patch_select_forward_plan(b, dtype):
    """The plan ``fused_patch_select_train``'s forward is launched with:
    one row per product of ``forward`` in patch_select_train.cu, in launch
    order (the seven of ``patch_select_gemm_shapes``: qkv, out_proj, k|v
    over the B*60*14 patch rows; query, out_proj, the MLP's two layers over
    the 2*B*60 query rows), none split at K <= 512; a plan one product short,
    one long or with a wrong M is not accepted; the routes the forward
    writes are tallied."""
    bt, p, d = b * 60, 14, 512
    env = {"R": bt * p, "Q2": 2 * bt, "Dh": d // 2, "D": d}
    launched = _launched_products("patch_select_train.cu", env, fn="forward")
    shapes = GM.patch_select_gemm_shapes(bt, p, d)
    assert len(launched) == 7 and shapes == launched
    plan = GM.gemm_plan(dtype, shapes, 132)
    rows = plan.tolist()
    fp32 = dtype == torch.float32
    for row, (m, n, k) in zip(rows, shapes):
        assert row == [m, n, k, GM.splitk_plan(m, n, k, 132).chunk if fp32 else 0, -1]
        assert GM.splitk_plan(m, n, k, 132).splits == 1
    assert GM.plan_workspace(dtype, shapes, 132) == 0
    assert _plan_accepts(rows, launched)
    assert not _plan_accepts(rows[:-1], launched)
    assert not _plan_accepts(rows + rows[-1:], launched)
    assert not _plan_accepts([[rows[0][0] + 4] + rows[0][1:]] + rows[1:], launched)
    plan[:, 4] = 3 if fp32 else 2

    class Kernel:
        gemm_routes = {}

    GM.note_plan_routes(Kernel, plan)
    assert Kernel.gemm_routes == {"tf32x3" if fp32 else "wgmma": 7}


# ---------------------------------------------------------------------------
# the AVQ train forward's plan, and the MLP half's products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,t,s", [(2, 3, 5), (4, 6, 7), (64, 60, 77)])
def test_avq_forward_shapes_are_the_launched_ones(n, t, s):
    d = 512
    env = {"R": n * t, "RS": n * s, "D": d}
    want = _launched_products("avq.cu", env, fn="forward")
    assert len(want) == 10
    assert GM.avq_train_fwd_gemm_shapes(n, t, s, d) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 6, 64])
def test_avq_forward_plan(n, dtype):
    """The plan ``fused_avq_train``'s forward is launched with: one row per
    product of ``forward`` in avq.cu, in launch order (the ten of
    ``avq_train_fwd_gemm_shapes`` over n*60 rows and n*77 words), none split
    at K = 512, so no workspace; a plan one product short, one long or with
    a wrong M is not accepted; the routes the forward writes are
    tallied."""
    t, s, d = 60, 77, 512
    launched = _launched_products("avq.cu", {"R": n * t, "RS": n * s, "D": d}, fn="forward")
    shapes = GM.avq_train_fwd_gemm_shapes(n, t, s, d)
    assert len(launched) == 10 and shapes == launched
    plan = GM.gemm_plan(dtype, shapes, 132)
    rows = plan.tolist()
    fp32 = dtype == torch.float32
    for row, (m, nn, k) in zip(rows, shapes):
        assert row == [m, nn, k, GM.splitk_plan(m, nn, k, 132).chunk if fp32 else 0, -1]
        assert GM.splitk_plan(m, nn, k, 132).splits == 1
    assert GM.plan_workspace(dtype, shapes, 132) == 0
    assert _plan_accepts(rows, launched)
    assert not _plan_accepts(rows[:-1], launched)
    assert not _plan_accepts(rows + rows[-1:], launched)
    assert not _plan_accepts([[rows[0][0] + 4] + rows[0][1:]] + rows[1:], launched)
    plan[:, 4] = 3 if fp32 else 2

    class Kernel:
        gemm_routes = {}

    GM.note_plan_routes(Kernel, plan)
    assert Kernel.gemm_routes == {"tf32x3" if fp32 else "wgmma": 10}


def _gemm_calls(source: str, fn: str, callee: str, first: int, env: dict) -> list:
    """(M, N, K) of every call of ``callee`` in ``fn`` of ``source``, in
    order: the three arguments from index ``first``, evaluated with ``env``."""
    text = (CSRC / source).read_text()
    start = text.index(f"cudaError_t {fn}(")
    body = text[start:text.index("\n}\n", start)]
    out = []
    for found in re.finditer(re.escape(callee) + r"\(", body):
        args = _args(body, found.end() - 1)
        out.append(tuple(int(eval(e, {}, dict(env))) for e in args[first:first + 3]))
    return out


@pytest.mark.parametrize("rows,width", [(77, 64), (3 * 77, 768), (256 * 77, 768)])
def test_mlp_half_shapes_are_the_launched_ones(rows, width):
    """``mlp`` in resblock.cu launches c_fc then c_proj through gemm_rows
    (gemm_sm90 on the bf16 wgmma route), and its fp32 route's c_fc through
    gemm_tile with ln_2 in the A load: the shapes the wrapper tallies in
    ``fused_resblock.gemm_routes`` (``mlp_gemm_shapes``)."""
    env = {"M": rows, "W": width, "Hd": 4 * width}
    shapes = GM.mlp_gemm_shapes(rows, width)
    assert _gemm_calls("resblock.cu", "mlp", "qt::gemm_rows<T>", 4, env) == shapes
    assert _gemm_calls("resblock.cu", "mlp", "qt::gemm<T, true>", 3, env) == shapes[:1]
