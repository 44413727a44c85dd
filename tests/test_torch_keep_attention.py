"""The keep-masked (dropout) attention's plain versions against the JAX
package, on the CPU, and the plan that sends such calls to the tensor-core
kernel ("mma_keep", ``csrc/attention_keep.cu``).

``keep_attention`` / ``keep_attention_bwd`` (``ops/avq.py``) are the plain
versions the card's kernels are held to. Here they are held to the bodies
of the Pallas kernels those kernels replace: JAX's ``_attn_fwd`` and
``_attn_bwd`` (``qa_tiger_tpu/ops/pallas/avq.py``; the fp32 probability,
both of its layouts, ``AVQ_V`` "stack" and "loop") and
``_packed_heads_attn(keep2d=)`` (``qa_tiger_tpu/ops/pallas/patch_select.py``;
the probability rounded first), whose backward is ``_attn_bwd``'s rule fed
the rounded probabilities, as ``_kernel_bwd`` computes it. The keep masks
come from JAX's samplers (``make_avq_dropout_masks``,
``make_patch_dropout_masks``) and enter both sides unchanged.

Tolerances: fp32 max|port - jax| <= 1e-6 * max|jax| (the two frameworks sum
the products in another order). bf16: each element within one bf16 ulp of
JAX's, plus the terms of its sum whose rounded intermediate (pd in ctx and
dv, dS in dq and dk) lies at a rounding boundary: the frameworks' fp32
scores and sums differ in their last bits, so such a value may round the
other way on either side, and that step enters every sum that reads it;
where the sum cancels, it is far more than one ulp of the result (a ctx
element of 0.0142 moved by 0.0003 from one pd at a boundary). A value
counts as at a boundary where its fp32 value, from the port's own
arithmetic, lies within 2^-16 of its size (pd; the probability too where it
is rounded first) or 2^-14 of the size of its terms (dS) from the midpoint
between two bf16 values, and its term then adds two of its ulps times the
other factor, and each term adds 2^-16 of its size for the order of the
fp32 sum (``_keep_bounds.flips``). Every other rounding must agree: the
cases that drop a rounding point (``test_bf16_bound_sees_a_dropped_rounding``)
fail.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qa_tiger_tpu.models import modules as JM
from qa_tiger_tpu.ops.pallas import avq as javq
from qa_tiger_tpu.ops.pallas import patch_select as jps
from _keep_bounds import check_bf16
from _keep_bounds import flips as keep_flips
from qa_tiger_tpu_torch.ops import attention as A
from qa_tiger_tpu_torch.ops import avq as AV

HD = 64
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = [torch.float32, torch.bfloat16]
# (Sq, Sk, heads): AVQ's question-guided 60 x 77 and self / cross 60 x 60,
# PatchSelecter's 14 x 14 and 1 x 14, and ragged others
SHAPES = [(60, 77, 8), (60, 60, 8), (14, 14, 4), (1, 14, 8), (2, 14, 2), (14, 60, 2),
          (2, 77, 4), (60, 14, 2)]


def _close(got: torch.Tensor, want, dtype, what: str, flips=None) -> None:
    """fp32: within 1e-6 of JAX's largest element; bf16: each element within
    one ulp plus ``flips`` (its terms at a rounding boundary,
    ``_keep_bounds.flips``)."""
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, what
    if dtype == torch.float32:
        err, scale = np.abs(got - want).max(), float(np.abs(want).max())
        assert err <= 1e-6 * scale, f"{what}: {err:.3e} of {scale:.3e}"
    else:
        check_bf16(got, want, flips, what)


def _inputs(seed: int, N: int, Sq: int, Sk: int, heads: int, dtype):
    """q, g [N, Sq, W] and k, v [N, Sk, W] (numpy, fp32, rounded to dtype)."""
    rng = np.random.default_rng(seed)
    W = heads * HD

    def rn(*shape):
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype)
        return x.float().numpy()

    return rn(N, Sq, W), rn(N, Sk, W), rn(N, Sk, W), rn(N, Sq, W)


def _avq_keep(seed: int, N: int, Sq: int, Sk: int, heads: int, dtype) -> np.ndarray:
    """The question-guided probability mask of JAX's AVQ sampler at T = Sq,
    S = Sk: [N*Sq, pad128(heads*Sk)], lane h*Sk + key, scaled by 1/(1-p)."""
    masks = JM.make_avq_dropout_masks(jax.random.PRNGKey(seed), N, Sq, Sk, heads * HD,
                                      nhead=heads, dropout_p=0.1, dtype=JDT[dtype])
    return np.asarray(masks["qst"].astype(jnp.float32))


def _t(a, dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype):
    return jnp.asarray(a, jnp.float32).astype(JDT[dtype])


def _jax_avq(mode: str, q, k, v, g, keep, heads: int, dtype, monkeypatch):
    """JAX's _attn_fwd and _attn_bwd in AVQ_V ``mode``: (ctx, dq, dk, dv)."""
    monkeypatch.setattr(javq, "AVQ_V", mode)
    Sq, Sk = q.shape[1], k.shape[1]
    jk = _j(keep, dtype)
    if mode == "stack":
        jk = javq._stack_mask(jk, Sq, heads, Sk)
    q3, k3, v3, g3 = (_j(x, dtype) for x in (q, k, v, g))
    kw = dict(heads=heads, scale=1.0 / math.sqrt(HD), dt=JDT[dtype])
    ctx, Ps, Pds = javq._attn_fwd(q3, k3, v3, jk, want_probs=True, **kw)
    return (ctx, *javq._attn_bwd(g3, q3, k3, v3, Ps, Pds, jk, **kw))


@pytest.mark.parametrize("mode", ["stack", "loop"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Sq,Sk,heads", SHAPES)
def test_keep_attention_matches_jax_attn(mode, dtype, Sq, Sk, heads, monkeypatch):
    """The AVQ contract (fp32 probability times keep): forward against
    ``_attn_fwd``, dq, dk, dv against ``_attn_bwd``."""
    N = 2
    q, k, v, g = _inputs(Sq * 131 + Sk, N, Sq, Sk, heads, dtype)
    keep = _avq_keep(Sq + Sk, N, Sq, Sk, heads, dtype)
    want = _jax_avq(mode, q, k, v, g, keep, heads, dtype, monkeypatch)
    args = [_t(x, dtype) for x in (q, k, v)]
    tk, tg = _t(keep, dtype), _t(g, dtype)
    flips = keep_flips(*args, tg, tk, heads)
    _close(AV.keep_attention(*args, tk, heads), want[0], dtype, "ctx", flips[0])
    got = AV.keep_attention_bwd(*args, tg, tk, heads)
    for name, gt, wt, fl in zip(("dq", "dk", "dv"), got, want[1:], flips[1:]):
        _close(gt, wt, dtype, name, fl)


def _patch_keep(seed: int, BT: int, P: int, heads: int, dtype, cross: bool) -> np.ndarray:
    masks = JM.make_patch_dropout_masks(jax.random.PRNGKey(seed), BT, P, heads * HD,
                                        nhead=heads, dropout_p=0.1, dtype=JDT[dtype])
    return np.asarray(masks["crs_v" if cross else "slf"].astype(jnp.float32))


def _jax_patch(q, k, v, g, keep, heads: int, dtype, monkeypatch):
    """The PatchSelecter's attention in JAX over frames of P = Sk patches:
    ctx from ``_packed_heads_attn(keep2d=)``, packed block-diagonally, and
    (dq, dk, dv) from ``_attn_bwd``'s rule fed the rounded probabilities, as
    ``_kernel_bwd`` computes it."""
    BT, Sq, W = q.shape
    P = k.shape[1]
    scale, jdt = 1.0 / math.sqrt(HD), JDT[dtype]
    ctx = jps._packed_heads_attn(_j(q.reshape(BT * Sq, W), dtype),
                                 _j(k.reshape(BT * P, W), dtype),
                                 _j(v.reshape(BT * P, W), dtype), heads=heads, sq=Sq, sk=P,
                                 scale=scale, dtype=jdt, keep2d=_j(keep, dtype))
    monkeypatch.setattr(javq, "AVQ_V", "loop")
    q3, k3, v3, g3 = (_j(x, dtype) for x in (q, k, v, g))
    jk = _j(keep, dtype)
    kw = dict(heads=heads, scale=scale, dt=jdt)
    _, Ps, _ = javq._attn_fwd(q3, k3, v3, jk, want_probs=True, **kw)
    Pr = [p.astype(jdt).astype(jnp.float32) for p in Ps]
    Pds = [(p * jk[:, h * P:(h + 1) * P].reshape(BT, Sq, P).astype(jnp.float32)).astype(jdt)
           for h, p in enumerate(Pr)]
    return (ctx.reshape(BT, Sq, W), *javq._attn_bwd(g3, q3, k3, v3, Pr, Pds, jk, **kw))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Sq,heads", [(14, 8), (1, 8), (14, 2), (1, 4)])
def test_keep_attention_rounds_p_first_as_packed_heads_attn(dtype, Sq, heads, monkeypatch):
    """The PatchSelecter contract (the probability rounded, then times
    keep): forward against ``_packed_heads_attn(keep2d=)`` over frames
    packed block-diagonally; the backward against ``_attn_bwd``'s rule fed
    the rounded probabilities, as ``_kernel_bwd`` computes it. Sq = 14 is
    the self-attention (mask ``slf``), Sq = 1 a cross stream (``crs_v``)."""
    P, BT = 14, 3
    q, k, v, g = _inputs(Sq * 7 + heads, BT, Sq, P, heads, dtype)
    keep = _patch_keep(Sq + heads, BT, P, heads, dtype, cross=Sq == 1)
    want = _jax_patch(q, k, v, g, keep, heads, dtype, monkeypatch)
    args = [_t(x, dtype) for x in (q, k, v)]
    tk, tg = _t(keep, dtype), _t(g, dtype)
    flips = keep_flips(*args, tg, tk, heads, round_p_first=True)
    _close(AV.keep_attention(*args, tk, heads, round_p_first=True), want[0], dtype, "ctx",
           flips[0])
    got = AV.keep_attention_bwd(*args, tg, tk, heads, round_p_first=True)
    for name, gt, wt, fl in zip(("dq", "dk", "dv"), got, want[1:], flips[1:]):
        _close(gt, wt, dtype, name, fl)


def _unrounded_pd_ctx(q, k, v, keep, heads: int) -> torch.Tensor:
    """``keep_attention`` with pd left in fp32 (a dropped rounding point)."""
    N, Sq, W = q.shape
    pd = AV._keep_probs(q, k, heads, False) * AV._keep_heads(keep, N, Sq, k.shape[1], heads)
    ctx = torch.einsum("nhqk,nkhd->nqhd", pd, AV._split_heads(v, heads))
    return ctx.to(q.dtype).reshape(N, Sq, W)


def _unrounded_ds_grads(q, k, v, g, keep, heads: int) -> tuple:
    """(dq, dk) of ``keep_attention_bwd`` with dS left in fp32 (a dropped
    rounding point)."""
    N, Sq, W = q.shape
    Sk = k.shape[1]
    p = AV._keep_probs(q, k, heads, False)
    kp = AV._keep_heads(keep, N, Sq, Sk, heads)
    dp = torch.einsum("nqhd,nkhd->nhqk", AV._split_heads(g, heads),
                      AV._split_heads(v, heads)) * kp
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) / math.sqrt(HD)
    dq = torch.einsum("nhqk,nkhd->nqhd", ds, AV._split_heads(k, heads))
    dk = torch.einsum("nhqk,nqhd->nkhd", ds, AV._split_heads(q, heads))
    return dq.to(q.dtype).reshape(N, Sq, W), dk.to(q.dtype).reshape(N, Sk, W)


@pytest.mark.parametrize("dropped", ["pd", "dS", "round_p_first fwd", "round_p_first bwd"])
def test_bf16_bound_sees_a_dropped_rounding(dropped, monkeypatch):
    """The bf16 bound is tight enough to see a plain version that leaves out
    one of JAX's rounding points: pd (ctx at AVQ's 60 x 77), dS (dq and dk
    at 60 x 60), or the PatchSelecter's probability rounded first (ctx, and
    dq, dk, dv, at 14 x 14): each such version fails ``_close``."""
    dt = torch.bfloat16
    if dropped.startswith("round_p_first"):
        P, BT, heads = 14, 3, 8
        q, k, v, g = _inputs(7, BT, P, P, heads, dt)
        keep = _patch_keep(3, BT, P, heads, dt, cross=False)
        want = _jax_patch(q, k, v, g, keep, heads, dt, monkeypatch)
        rpf = True
    else:
        Sq, Sk, heads = (60, 77, 8) if dropped == "pd" else (60, 60, 8)
        q, k, v, g = _inputs(Sq * 131 + Sk, 2, Sq, Sk, heads, dt)
        keep = _avq_keep(Sq + Sk, 2, Sq, Sk, heads, dt)
        want = _jax_avq("loop", q, k, v, g, keep, heads, dt, monkeypatch)
        rpf = False
    args = [_t(x, dt) for x in (q, k, v)]
    tk, tg = _t(keep, dt), _t(g, dt)
    flips = keep_flips(*args, tg, tk, heads, round_p_first=rpf)
    if dropped == "pd":
        checks = [(_unrounded_pd_ctx(*args, tk, heads), want[0], flips[0])]
    elif dropped == "dS":
        checks = list(zip(_unrounded_ds_grads(*args, tg, tk, heads), want[1:3], flips[1:3]))
    elif dropped.endswith("fwd"):
        checks = [(AV.keep_attention(*args, tk, heads), want[0], flips[0])]
    else:
        checks = list(zip(AV.keep_attention_bwd(*args, tg, tk, heads), want[1:], flips[1:]))
    for got, wt, fl in checks:
        with pytest.raises(AssertionError, match="over their bound"):
            _close(got, wt, dt, dropped, fl)


@pytest.mark.parametrize("dtype", DTYPES)
def test_keep_wrappers_on_cpu_are_the_plain_versions(dtype):
    """On a CPU tensor ``attention_keep`` and ``attention_keep_bwd`` run the
    plain versions; ``accumulate_kv`` adds the second stream's rounded dk,
    dv to the first's and rounds the sum, as two launches on the card do;
    neither counts a launch."""
    q, k, v, g = (_t(x, dtype) for x in _inputs(5, 2, 1, 14, 2, dtype))
    q2, g2 = (_t(x, dtype) for x in _inputs(6, 2, 1, 14, 2, dtype)[::3])
    keep = _t(_patch_keep(1, 2, 14, 2, dtype, cross=True), dtype)
    n_fwd, n_bwd = AV.attention_keep.launches, AV.attention_keep_bwd.launches
    assert torch.equal(AV.attention_keep(q, k, v, keep, 2, True),
                       AV.keep_attention(q, k, v, keep, 2, True))
    dq, dk, dv = AV.attention_keep_bwd(q, k, v, g, keep, 2, True)
    want = AV.keep_attention_bwd(q, k, v, g, keep, 2, True)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), want))
    _, dk2, dv2 = AV.keep_attention_bwd(q2, k, v, g2, keep, 2, True)
    acc = (dk.clone(), dv.clone())
    _, dka, dva = AV.attention_keep_bwd(q2, k, v, g2, keep, 2, True, accumulate_kv=acc)
    assert dka is acc[0] and dva is acc[1]
    assert torch.equal(dka, (dk.float() + dk2.float()).to(dtype))
    assert torch.equal(dva, (dv.float() + dv2.float()).to(dtype))
    assert (AV.attention_keep.launches, AV.attention_keep_bwd.launches) == (n_fwd, n_bwd)


# the recipe's keep-masked calls (8 heads of 64 lanes): AVQ's question-guided
# 60 x 77 and self / cross 60 x 60, PatchSelecter's 14 x 14 and 1 x 14; the
# tensor-parallel ranks' are the same shapes with fewer heads
RECIPE_SHAPES = [(60, 77), (60, 60), (14, 14), (1, 14)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_keep_plan_takes_the_tensor_core_kernel(dtype, hd):
    """With a keep mask at head sizes 32, 64 and 128 over at most 128 keys
    both plans name the keep-masked tensor-core kernel (route "mma_keep"),
    in bf16 and fp32, within an H100's 232,448 bytes of shared memory per
    block at every recipe shape; the backward's shared memory grows with
    the queries (at 128 lanes in fp32 over 128 keys up to 32); past 128 keys
    both take the FMA kernels."""
    shapes = [*RECIPE_SHAPES, (16, 16), (17, 16), (1, 128), (32, 128)]
    for sq, sk in [*shapes, (65, 128)]:
        plan = A.attention_plan(dtype, sq, sk, hd, has_keep=True)
        assert (plan.route, plan.kernel, plan.head) == ("mma_keep", "mma_keep", hd)
        assert plan.smem_bytes <= A.H100_SMEM_OPTIN
    for sq, sk in shapes:
        plan = A.attention_bwd_plan(dtype, sq, sk, hd)
        assert (plan.route, plan.kernel, plan.head) == ("mma_keep", "mma_keep", hd)
        assert plan.smem_bytes <= A.H100_SMEM_OPTIN
    assert A.attention_plan(dtype, 60, 129, hd, has_keep=True).route == "fma"
    assert A.attention_bwd_plan(dtype, 14, 129, hd).kernel == "staged"
    assert A.attention_bwd_plan(dtype, 60, 77, hd, has_keep=False).kernel == "staged"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [256, 512])
def test_keep_plan_wide_heads_stay_on_fma(dtype, hd):
    """Keep masks at head sizes 256 and 512 (no path runs them) keep the
    FMA kernels, forward and backward."""
    for sq, sk in ((60, 60), (14, 14), (1, 14)):
        assert A.attention_plan(dtype, sq, sk, hd, has_keep=True).route == "fma"
    for sq, sk in ((14, 14), (1, 14)):
        bwd = A.attention_bwd_plan(dtype, sq, sk, hd)
        assert (bwd.route, bwd.kernel) == ("fma", "staged")


def test_keep_plan_shared_memory_pinned():
    """The recipe shapes' shared memory per block, as the launchers ask for
    it: forward (short form at 14 x 14 and 1 x 14: four warps a block, q, k
    and v of 16 rows each; long form at 60 queries: 64 query rows and the
    problem's k and v), backward (q, g, k, v, dS and pd)."""
    f32, bf = torch.float32, torch.bfloat16
    assert A.attention_plan(f32, 60, 77, 64, has_keep=True).smem_bytes == 60_928
    assert A.attention_plan(f32, 14, 14, 64, has_keep=True).smem_bytes == 52_224
    assert A.attention_plan(bf, 60, 77, 64, has_keep=True).smem_bytes == 32_256
    assert A.attention_bwd_plan(f32, 60, 77, 64).smem_bytes == 121_344
    assert A.attention_bwd_plan(f32, 60, 60, 64).smem_bytes == 104_448
    assert A.attention_bwd_plan(f32, 1, 14, 64).smem_bytes == 79_872
    assert A.attention_bwd_plan(bf, 14, 14, 64).smem_bytes == 43_008
    # where the tensor-core backward passes the limit the FMA backward takes
    # the call if its own shared memory fits
    assert A.attention_bwd_plan(f32, 47, 128, 128).kernel == "staged"
    with pytest.raises(ValueError, match=r"Sq=1000, Sk=128, head size 128"):
        A.attention_bwd_plan(f32, 1000, 128, 128)
