"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA device every test here skips. On the card
(no JAX there, so without the repository's conftest):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

Tolerances: fp32 max|k - p| <= 1e-4 * max(1, max|p|) (summation order);
bf16 3e-2 * max(1, max|p|) (bf16 rounding of outputs and intermediates);
the keep-masked attention's bf16 kernels, each element within one bf16 ulp
of the plain version's plus its terms whose pd or dS lies at a rounding
boundary (``_keep_bounds``: every other rounding point must agree).
bf16 gradients of the train kernels: the kernel and the plain version in
bf16 are both held to the plain version in fp32 on the same values, and the
kernel may be off by at most max(2 x the plain version's error,
3e-2 * max(1, max|ref|)): bf16 rounding in sums over many rows moves both.
"""
import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from _keep_bounds import check_bf16
from _keep_bounds import flips as keep_flips
from _keep_bounds import wide_flips
from qa_tiger_tpu_torch.models.clip_text import ResidualAttentionBlock, causal_mask
from qa_tiger_tpu_torch.models.modules import (
    AVQCrossAttn,
    PatchSelecter,
    make_avq_dropout_masks,
    make_patch_dropout_masks,
)
from qa_tiger_tpu_torch.ops import avq as AV
from qa_tiger_tpu_torch.ops import attention as A
from qa_tiger_tpu_torch.ops import gaussian_moe as G
from qa_tiger_tpu_torch.ops import gemm as GM
from qa_tiger_tpu_torch.ops import patch_select as PS
from qa_tiger_tpu_torch.ops import resblock as R

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rn(rng, *shape, dtype, scale=1.0):
    return torch.from_numpy(scale * rng.standard_normal(shape, dtype=np.float32)).to("cuda", dtype)


def _check(kernel_fn, plain_fn, dtype):
    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    got = [got] if torch.is_tensor(got) else list(got)
    want = [want] if torch.is_tensor(want) else list(want)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == dtype
        assert torch.isfinite(g).all()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= TOL[dtype] * max(1.0, w.float().abs().max().item()), err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sq,sk,masked", [(60, 77, False), (13, 13, True), (1, 60, False)])
def test_attention_wide(cuda, dtype, sq, sk, masked):
    rng = np.random.default_rng(0)
    q, k, v = (_rn(rng, 3, s, 512, dtype=dtype) for s in (sq, sk, sk))
    mask = causal_mask(sq, device=cuda) if masked else None
    n = A.attention_wide.launches
    _check(lambda: A.attention_wide(q, k, v, mask, 0.125, 8),
           lambda: A._wide_reference(q, k, v, mask, 0.125, 8), dtype)
    assert A.attention_wide.launches == n + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,bias,masked", [(552, True, False), (27, True, False),
                                           (577, False, False), (300, True, True)])
def test_attention_wide_long_keys_and_key_bias(cuda, dtype, n, bias, masked):
    """The ToMe and CLIP image shapes: q, k and v column slices of one
    packed qkv [B, N, 3W], 16 heads of 64, a key bias of log integer sizes
    1-40. In fp32 the tiled FMA kernel runs over 128 keys, the staged one at
    27; in bf16 the tensor-core kernel runs at all four."""
    rng = np.random.default_rng(7)
    W = 1024
    qkv = _rn(rng, 2, n, 3 * W, dtype=dtype)
    q, k, v = qkv[..., :W], qkv[..., W:2 * W], qkv[..., 2 * W:]
    kb = torch.from_numpy(np.log(rng.integers(1, 41, (2, n))).astype(np.float32)).to(cuda) \
        if bias else None
    mask = causal_mask(n, device=cuda) if masked else None
    n_all, n_kb = A.attention_wide.launches, A.attention_wide_key_bias.launches
    _check(lambda: A.attention_wide(q, k, v, mask, 0.125, 16, key_bias=kb),
           lambda: A._wide_reference(q, k, v, mask, 0.125, 16, kb), dtype)
    assert A.attention_wide.launches == n_all + 1
    assert A.attention_wide_key_bias.launches == n_kb + int(bias)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_attn_ln2_clip_image_shape(cuda, dtype):
    """The CLIP ViT-L/14@336px block: 577 tokens, width 1024, 16 heads, no
    mask (the tensor-core attention inside in bf16, its 3xTF32 key-tiled
    form in fp32)."""
    rng = np.random.default_rng(8)
    blk = ResidualAttentionBlock(1024, 24, torch.Generator().manual_seed(0)).to(cuda, dtype)
    x = _rn(rng, 2, 577, 1024, dtype=dtype)
    assert A.attention_route(dtype, 577, 577, 64) == ("wgmma" if dtype == torch.bfloat16
                                                      else "mma_nokeep")
    _check(lambda: R.fused_attn_ln2(x, blk, None, 16),
           lambda: R._attn_ln2_plain(blk, x, heads=16, mask=None), dtype)


# ---------------------------------------------------------------------------
# the tensor-core route of qt::attention (bf16, no keep mask, Sq, Sk >= 16)
# ---------------------------------------------------------------------------

def _packed_qkv(rng, B, sq, sk, W, dtype, cuda, pad=0):
    """q, k and v as column slices of one packed [B, max(sq, sk), 3W + pad]
    buffer, as the models' fused projections give them."""
    buf = _rn(rng, B, max(sq, sk), 3 * W + pad, dtype=dtype)
    return buf[:, :sq, :W], buf[:, :sk, W:2 * W], buf[:, :sk, 2 * W:3 * W]


def _causal(sq, sk, cuda):
    return torch.triu(torch.full((sq, sk), float("-inf"), device=cuda), 1)


@pytest.mark.parametrize("sq", [16, 17, 63, 65, 577])
@pytest.mark.parametrize("sk", [16, 65, 127, 128, 129, 552, 577])
@pytest.mark.parametrize("bias,masked", [(False, False), (True, False), (False, True),
                                         (True, True)])
def test_attention_mma_route(cuda, sq, sk, bias, masked):
    """bf16 against the plain version at query and key lengths around the
    64-row tiles, the one-pass limit (128 keys) and the raw-media shapes;
    2 heads of 64, a key bias of log integer sizes, a causal mask (16 x 16
    runs on the short kernel)."""
    rng = np.random.default_rng(sq * 1000 + sk)
    dt, B, H = torch.bfloat16, 2, 2
    q, k, v = _packed_qkv(rng, B, sq, sk, 64 * H, dt, cuda)
    kb = torch.from_numpy(np.log(rng.integers(1, 41, (B, sk))).astype(np.float32)).to(cuda) \
        if bias else None
    mask = _causal(sq, sk, cuda) if masked else None
    # 16 x 16 is also a short problem, which the one-warp kernel takes; past
    # 128 keys the Hopper kernel where the measured rule takes it
    assert A.attention_route(dt, sq, sk, 64) == ("mma_short" if max(sq, sk) <= 16 else
                                                 "wgmma" if sk > 128 and A.sm90_faster(sk)
                                                 else "mma")
    n = A.attention_wide.launches
    _check(lambda: A.attention_wide(q, k, v, mask, 0.125, H, key_bias=kb),
           lambda: A._wide_reference(q, k, v, mask, 0.125, H, kb), dt)
    assert A.attention_wide.launches == n + 1


@pytest.mark.parametrize("hd,sk", [(32, 77), (32, 300), (128, 77), (128, 300)])
def test_attention_mma_route_head_sizes(cuda, hd, sk):
    rng = np.random.default_rng(hd + sk)
    dt, B, H, sq = torch.bfloat16, 2, 3, 70
    q, k, v = _packed_qkv(rng, B, sq, sk, hd * H, dt, cuda)
    assert A.attention_route(dt, sq, sk, hd) == "mma"
    _check(lambda: A.attention_wide(q, k, v, None, hd ** -0.5, H),
           lambda: A._wide_reference(q, k, v, None, hd ** -0.5, H), dt)


def test_attention_route_rule(cuda):
    """The route is a function of dtype, shape, a keep mask and whether the
    call adds a mask or a key bias."""
    bf, f32 = torch.bfloat16, torch.float32
    assert A.attention_route(bf, 16, 16, 64) == "mma_short"   # one m16 tile, two n8 tiles
    assert A.attention_route(bf, 17, 16, 64) == "mma"
    assert A.attention_route(bf, 16, 17, 64) == "mma"
    assert A.attention_route(bf, 60, 77, 64) == "mma"
    assert A.attention_route(bf, 577, 577, 64) == "wgmma"     # the Hopper kernel
    assert A.attention_route(bf, 60, 128, 64) == "mma"        # one pass
    assert A.attention_route(bf, 60, 129, 64) == "mma"        # the rule: one key past
    assert A.attention_route(bf, 60, 200, 64) == "wgmma"
    assert A.attention_route(bf, 577, 577, 32) == "mma"       # no Hopper build for 32, 128
    assert A.attention_route(bf, 577, 577, 128) == "mma"
    assert A.attention_route(f32, 577, 577, 64) == "mma_nokeep"   # its key-tiled form
    assert A.attention_route(bf, 60, 77, 64, has_keep=True) == "mma_keep"  # train dropout
    assert A.attention_route(f32, 60, 77, 64, has_keep=True) == "mma_keep"
    assert A.attention_route(f32, 60, 129, 64, has_keep=True) == "fma"
    assert A.attention_route(bf, 14, 14, 64) == "mma_short"   # PatchSelecter, packed route
    assert A.attention_route(bf, 2, 14, 64) == "mma_short"    # PatchSelecter cross
    assert A.attention_route(bf, 1, 2, 64) == "mma_short"     # QstGrounding
    assert A.attention_route(f32, 14, 14, 64) == "mma_nokeep"  # the fp32 eval forward
    assert A.attention_route(f32, 14, 14, 64, has_bias=True) == "mma_nokeep"
    assert A.attention_route(f32, 60, 77, 64) == "mma_nokeep"
    assert A.attention_route(f32, 1, 2, 64) == "mma_nokeep"
    assert A.attention_route(bf, 14, 14, 64, has_keep=True) == "mma_keep"  # train kernels
    assert A.attention_route(f32, 1, 14, 64, has_keep=True) == "mma_keep"
    assert A.attention_route(bf, 1, 60, 64) == "mma_nokeep"    # TempMoE
    assert A.attention_route(bf, 1, 60, 64, has_bias=True) == "fma"
    assert A.attention_route(bf, 1, 129, 64) == "fma"
    assert A.attention_route(bf, 60, 15, 64) == "fma"
    assert A.attention_route(bf, 60, 77, 48) == "fma"   # no mma build for hd 48
    assert A.attention_route(bf, 14, 14, 48) == "fma"
    # head sizes 256 and 512: the wide tensor-core kernels at any length
    # whose probabilities fit the block's shared memory
    assert A.attention_route(bf, 60, 60, 512) == "mma"        # TSPM AV_Attn
    assert A.attention_route(bf, 14, 14, 512) == "mma_short"  # TSPM TokensAttn
    assert A.attention_route(bf, 1, 60, 512) == "mma"
    assert A.attention_route(bf, 577, 577, 256) == "mma"
    assert A.attention_route(bf, 60, 300, 200) == "mma"       # padded to 256
    assert A.attention_route(bf, 60, 2000, 512) == "fma"      # p past the limit
    assert A.attention_route(f32, 60, 60, 512) == "tf32x3"    # the lane split
    assert A.attention_route(f32, 60, 60, 512, has_bias=True) == "fma"
    assert A.attention_route(bf, 60, 60, 512, has_keep=True) == "fma"


# ---------------------------------------------------------------------------
# the keep-masked tensor-core kernel ("mma_keep"): the train kernels'
# dropout attentions, forward and backward, alone against their plain
# versions (ops/avq.py keep_attention, keep_attention_bwd)
# ---------------------------------------------------------------------------

def _keep_case(rng, N, sq, sk, heads, hd, dtype, lane0=0, ld_extra=0):
    """q, g [N, sq, W] and k, v [N, sk, W] on the card; keep [N*sq, heads*sk
    (+ ld_extra)] from the train masks' sampler geometry (0 or 1/(1-p)),
    its rows starting lane0 lanes into a wider buffer (a base and row
    stride off 16 bytes)."""
    W = heads * hd
    q, g = (_rn(rng, N, sq, W, dtype=dtype) for _ in range(2))
    k, v = (_rn(rng, N, sk, W, dtype=dtype) for _ in range(2))
    drop = rng.random((N * sq, lane0 + heads * sk + ld_extra)) < 0.1
    full = torch.from_numpy(np.where(drop, 0.0, 1.0 / 0.9).astype(np.float32)).to("cuda", dtype)
    return q, k, v, g, full[:, lane0:lane0 + heads * sk]


def _keep_check(q, k, v, g, keep, heads, dtype, round_p_first=False):
    """The kernel pair against the plain versions, launches counted; in
    bf16 each element also within one ulp plus its terms at a rounding
    boundary (``_keep_bounds``); the outputs as (ctx, dq, dk, dv)."""
    n_fwd, n_bwd = AV.attention_keep.launches, AV.attention_keep_bwd.launches
    got = [AV.attention_keep(q, k, v, keep, heads, round_p_first),
           *AV.attention_keep_bwd(q, k, v, g, keep, heads, round_p_first)]
    want = [AV.keep_attention(q, k, v, keep, heads, round_p_first),
            *AV.keep_attention_bwd(q, k, v, g, keep, heads, round_p_first)]
    _check(lambda: got, lambda: want, dtype)
    if dtype == torch.bfloat16:
        host = [t.cpu() for t in (q, k, v, g, keep)]
        bounds = keep_flips(*host, heads, round_p_first)
        for name, a, b, bound in zip(("ctx", "dq", "dk", "dv"), got, want, bounds):
            check_bf16(a.float().cpu().numpy(), b.float().cpu().numpy(), bound, name)
    assert (AV.attention_keep.launches, AV.attention_keep_bwd.launches) == (n_fwd + 1,
                                                                           n_bwd + 1)
    return got


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sk", [14, 60, 77, 128])
@pytest.mark.parametrize("sq", [1, 2, 14, 16, 17, 60, 64, 65])
def test_keep_attention_kernel_ragged(cuda, sq, sk, dtype):
    """Both kernels at ragged lengths (the short form at most 16 queries
    and keys, the long one otherwise; rows past Sq and keys past Sk masked)
    against their plain versions, and each launch repeated bitwise."""
    rng = np.random.default_rng(sq * 1000 + sk)
    heads = 3
    case = _keep_case(rng, 2, sq, sk, heads, 64, dtype)
    assert A.attention_plan(dtype, sq, sk, 64, has_keep=True).kernel == "mma_keep"
    assert A.attention_bwd_plan(dtype, sq, sk, 64).kernel == "mma_keep"
    first = _keep_check(*case, heads, dtype, round_p_first=sq <= 16)
    again = [AV.attention_keep(*case[:3], case[4], heads, sq <= 16),
             *AV.attention_keep_bwd(*case, heads, sq <= 16)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("sq,sk", [(14, 14), (1, 14), (60, 77), (17, 128)])
def test_keep_attention_kernel_head_sizes(cuda, hd, sq, sk, dtype):
    """Head sizes 32 and 128 (no model path runs them)."""
    rng = np.random.default_rng(hd + sq + sk)
    _keep_check(*_keep_case(rng, 3, sq, sk, 2, hd, dtype), 2, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lane0,ld_extra", [(1, 0), (3, 5), (0, 51)])
def test_keep_attention_kernel_misaligned_keep_rows(cuda, dtype, lane0, ld_extra):
    """Keep rows off 16 bytes: a base lane0 lanes into a wider buffer and a
    row stride that is no multiple of 16 bytes, at AVQ's 60 x 77 (head h's
    keys at lane 77 h) and PatchSelecter's 14 x 14; the kernel reads the
    keep mask from device memory straight into its fragments, so nothing
    is copied and the route stays."""
    rng = np.random.default_rng(lane0 + ld_extra)
    for sq, sk in ((60, 77), (14, 14)):
        case = _keep_case(rng, 2, sq, sk, 4, 64, dtype, lane0, ld_extra)
        keep = case[4]
        assert keep.data_ptr() % 16 or keep.stride(0) % (16 // keep.element_size())
        _keep_check(*case, 4, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_keep_attention_kernel_strided_packed_qkv(cuda, dtype):
    """q, k and v as column slices of a packed [N, S, 3W] projection (the
    train kernels' self-attention), and the PatchSelecter's two cross
    streams over one k|v, the second adding its key and value gradients to
    the first's (accumulate_kv: round(out + round(new)))."""
    rng = np.random.default_rng(3)
    heads, hd = 4, 64
    W = heads * hd
    for sq in (60, 14):
        qkv = _rn(rng, 2, sq, 3 * W, dtype=dtype)
        q, k, v = qkv[..., :W], qkv[..., W:2 * W], qkv[..., 2 * W:]
        g = _rn(rng, 2, sq, W, dtype=dtype)
        keep = _keep_case(rng, 2, sq, sq, heads, hd, dtype)[4]
        _keep_check(q, k, v, g, keep, heads, dtype, round_p_first=sq == 14)
    P = 14
    kv = _rn(rng, 5, P, 2 * W, dtype=dtype)
    k, v = kv[..., :W], kv[..., W:]
    streams = [_keep_case(rng, 5, 1, P, heads, hd, dtype) for _ in range(2)]
    dq0, dk, dv = AV.attention_keep_bwd(streams[0][0], k, v, streams[0][3], streams[0][4],
                                        heads, True)
    acc = (dk.clone(), dv.clone())
    dq1, dka, dva = AV.attention_keep_bwd(streams[1][0], k, v, streams[1][3], streams[1][4],
                                          heads, True, accumulate_kv=acc)
    want0 = AV.keep_attention_bwd(streams[0][0], k, v, streams[0][3], streams[0][4], heads, True)
    want1 = AV.keep_attention_bwd(streams[1][0], k, v, streams[1][3], streams[1][4], heads, True)
    want_k = (want0[1].float() + want1[1].float()).to(dtype)
    want_v = (want0[2].float() + want1[2].float()).to(dtype)
    _check(lambda: [dq0, dq1, dka, dva], lambda: [want0[0], want1[0], want_k, want_v], dtype)
    assert dka is acc[0] and dva is acc[1]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tp", [2, 4])
def test_keep_attention_kernel_tp_lane_cut(cuda, dtype, tp):
    """A model rank's share under tensor parallelism: its heads' q, k and v
    lanes and the keep mask cut to its heads' lanes (``head_lanes``,
    re-padded to 128), against the plain version on the same share and
    against the whole call's lanes of those heads."""
    from qa_tiger_tpu_torch.parallel.tensor import head_lanes

    rng = np.random.default_rng(tp)
    heads, hd = 8, 64
    for sq, sk in ((60, 77), (14, 14), (1, 14)):
        q, k, v, g, keep = _keep_case(rng, 2, sq, sk, heads, hd, dtype)
        Lp = -(-heads * sk // 128) * 128
        keep = torch.nn.functional.pad(keep, (0, Lp - heads * sk)).contiguous()
        whole = [AV.attention_keep(q, k, v, keep, heads),
                 *AV.attention_keep_bwd(q, k, v, g, keep, heads)]
        hl, W = heads // tp, heads * hd // tp
        for r in range(tp):
            lanes = slice(r * W, (r + 1) * W)
            share = [t[..., lanes] for t in (q, k, v, g)]
            got = _keep_check(*share, head_lanes(keep, heads, sk, r, tp), hl, dtype)
            for a, b in zip(got, whole):
                assert torch.equal(a, b[..., lanes])


# ---------------------------------------------------------------------------
# the keep-masked kernel without a keep mask ("mma_nokeep"): every unmasked
# fp32 call at head sizes 32/64/128 over at most 128 keys (the fp32 eval
# forward), and bf16 calls of fewer than 16 queries over more than 16 keys
# (TempMoE's 1 x 60); the kernel each launch took read back from the library
# ---------------------------------------------------------------------------

# (Sq, Sk, rows per batch element) of the fp32 eval forward's attention_wide
# calls: AVQ's question-guided, self and cross attention over 2B; TempMoE's
# and QstGrounding's one query over B
EVAL_ATTN = [(60, 77, 2), (60, 60, 2), (1, 60, 1), (1, 2, 1)]


@pytest.mark.parametrize("B", [2, 32])
@pytest.mark.parametrize("sq,sk,per", EVAL_ATTN)
def test_attention_nokeep_eval_shapes_fp32(cuda, B, sq, sk, per):
    """fp32 at the eval forward's shapes (8 heads of 64, B = 2 and the
    eval batch 32): the plan and the library's name "mma_nokeep", the
    launch against the plain version, twice bitwise, its kernel read back."""
    rng = np.random.default_rng(1000 * sq + sk + B)
    f32 = torch.float32
    q, k, v = (_rn(rng, per * B, s, 512, dtype=f32) for s in (sq, sk, sk))
    plan = A.attention_plan(f32, sq, sk, 64, limit=A.smem_limit(cuda))
    assert plan.kernel == "mma_nokeep"
    assert A.library_plan(f32, sq, sk, 64) == (plan.kernel, plan.smem_bytes)
    A.attention_wide.attn_routes = {}
    first = A.attention_wide(q, k, v, None, 0.125, 8)
    _check(lambda: first, lambda: A._wide_reference(q, k, v, None, 0.125, 8), f32)
    assert torch.equal(first, A.attention_wide(q, k, v, None, 0.125, 8))
    assert A.attention_wide.attn_routes == {"mma_nokeep": 2}


def test_attention_nokeep_bf16_one_query_b256(cuda):
    """TempMoE's bf16 call of the serving forward, one query over 60 keys at
    B = 256, 8 heads of 64: within the keep-masked kernel's bf16 bound of the
    plain version (``_keep_bounds`` with keep = 1: one ulp plus the terms
    whose probability lies at a rounding boundary), twice bitwise, its
    kernel read back."""
    rng = np.random.default_rng(60)
    bf = torch.bfloat16
    q, k, v = _rn(rng, 256, 1, 512, dtype=bf), _rn(rng, 256, 60, 512, dtype=bf), \
        _rn(rng, 256, 60, 512, dtype=bf)
    A.attention_wide.attn_routes = {}
    got = A.attention_wide(q, k, v, None, 0.125, 8)
    want = A._wide_reference(q, k, v, None, 0.125, 8)
    _check(lambda: got, lambda: want, bf)
    host = [t.cpu() for t in (q, k, v)]
    keep = torch.ones(256, 8 * 60, dtype=bf)
    bound = keep_flips(*host, torch.zeros_like(host[0]), keep, 8)[0]
    check_bf16(got.float().cpu().numpy(), want.float().cpu().numpy(), bound, "ctx")
    assert torch.equal(got, A.attention_wide(q, k, v, None, 0.125, 8))
    assert A.attention_wide.attn_routes == {"mma_nokeep": 2}


# (dtype, Sq, Sk) of the three forms at their edges: fp32 at every length,
# bf16 where it takes this kernel (fewer than 16 queries over more keys)
NOKEEP_FORMS = [(dt, sq, sk) for dt in DTYPES
                for sq, sk in ((1, 17), (2, 77), (15, 128), (1, 2), (14, 14), (16, 16),
                               (17, 60), (60, 77), (64, 128), (65, 33))
                if dt == torch.float32 or sq < 16 < sk]


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("dtype,sq,sk", NOKEEP_FORMS)
def test_attention_nokeep_forms(cuda, dtype, sq, sk, hd):
    """The three forms at their edges (a warp per problem at most 16
    queries and keys, four a block; one warp a block at most 16 queries
    over more keys; 64 query rows a block), 3 heads as column slices of a
    packed buffer, against the plain version, twice bitwise, the library's
    plan the Python one."""
    rng = np.random.default_rng(sq * 1000 + sk + hd)
    q, k, v = _packed_qkv(rng, 3, sq, sk, hd * 3, dtype, cuda)
    plan = A.attention_plan(dtype, sq, sk, hd, limit=A.smem_limit(cuda))
    assert plan.kernel == "mma_nokeep" and plan.head == hd
    assert A.library_plan(dtype, sq, sk, hd) == (plan.kernel, plan.smem_bytes)
    assert A.attention_route(dtype, sq, sk, hd) == "mma_nokeep"
    A.attention_wide.attn_routes = {}
    first = A.attention_wide(q, k, v, None, hd ** -0.5, 3)
    _check(lambda: first, lambda: A._wide_reference(q, k, v, None, hd ** -0.5, 3), dtype)
    assert torch.equal(first, A.attention_wide(q, k, v, None, hd ** -0.5, 3))
    assert A.attention_wide.attn_routes == {"mma_nokeep": 2}


def test_attention_nokeep_copies_misaligned_fp32_rows(cuda):
    """An fp32 row stride off a whole 16 bytes, or a base 4 bytes past a
    16-byte boundary: the wrapper copies the operand and launches the same
    kernel, which gives the aligned operands' result."""
    rng = np.random.default_rng(21)
    f32 = torch.float32
    q, k, v = _packed_qkv(rng, 2, 60, 77, 128, f32, cuda, pad=1)
    assert q.stride(1) % 4 == 1
    buf = _rn(rng, 2, 77, 3 * 128 + 4, dtype=f32)
    q2, k2, v2 = buf[:, :60, 1:129], buf[..., 129:257], buf[..., 257:385]
    assert q2.data_ptr() % 16 == 4
    A.attention_wide.attn_routes = {}
    for a, b_, c in ((q, k, v), (q2, k2, v2)):
        got = A.attention_wide(a, b_, c, None, 0.125, 2)
        _check(lambda: got, lambda: A._wide_reference(a, b_, c, None, 0.125, 2), f32)
        aligned = A.attention_wide(*(t.contiguous() for t in (a, b_, c)), None, 0.125, 2)
        assert torch.equal(got, aligned)
    assert A.attention_wide.attn_routes == {"mma_nokeep": 4}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sq,sk", [(60, 77), (1, 60), (14, 14)])
def test_attention_with_a_mask_or_key_bias_stays_off_nokeep(cuda, sq, sk, dtype):
    """A bf16 call that adds a mask, a key bias or both keeps the kernel it
    took before "mma_nokeep" existed (the staged FMA kernel, the mma and
    short kernels), an fp32 one takes "mma_nokeep" with them, which the
    launch reports; the same call without them takes "mma_nokeep" where
    the rule gives it."""
    rng = np.random.default_rng(sq + sk)
    q, k, v = (_rn(rng, 4, s, 256, dtype=dtype) for s in (sq, sk, sk))
    mask = torch.from_numpy(np.where(rng.random((sq, sk)) < 0.2, -1e9, 0.0)
                            .astype(np.float32)).to(cuda)
    kb = torch.from_numpy(np.log(rng.integers(1, 41, (4, sk))).astype(np.float32)).to(cuda)
    want = A.attention_plan(dtype, sq, sk, 64, has_bias=True, limit=A.smem_limit(cuda)).kernel
    assert (want == "mma_nokeep") == (dtype == torch.float32)
    for m, b_ in ((mask, None), (None, kb), (mask, kb)):
        A.attention_wide.attn_routes = {}
        _check(lambda: A.attention_wide(q, k, v, m, 0.125, 4, key_bias=b_),
               lambda: A._wide_reference(q, k, v, m, 0.125, 4, b_), dtype)
        assert A.attention_wide.attn_routes == {want: 1}
    A.attention_wide.attn_routes = {}
    A.attention_wide(q, k, v, None, 0.125, 4)
    nokeep = dtype == torch.float32 or sq < 16 < sk
    assert A.attention_wide.attn_routes == {"mma_nokeep" if nokeep else want: 1}


# ---------------------------------------------------------------------------
# the short tensor-core route (bf16, no keep mask, Sq, Sk <= 16): one warp
# per (batch element, head) problem
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("sk", [2, 14, 16])
@pytest.mark.parametrize("sq", [1, 2, 13, 14, 16])
def test_attention_short_route(cuda, sq, sk, hd):
    """fused_attention's [BH, S, hd] layout against its plain version, at
    BH = 75 problems (not a multiple of the block's 4 warps), and a second
    launch bitwise the same."""
    rng = np.random.default_rng(sq * 10000 + sk * 100 + hd)
    q, k, v = (_rn(rng, 75, s, hd, dtype=torch.bfloat16) for s in (sq, sk, sk))
    assert A.attention_route(torch.bfloat16, sq, sk, hd) == "mma_short"
    n = A.fused_attention.launches
    scale = hd ** -0.5
    _check(lambda: A.fused_attention(q, k, v, None, scale),
           lambda: A._fused_attention_plain(q, k, v, mask=None, scale=scale), torch.bfloat16)
    assert torch.equal(A.fused_attention(q, k, v, None, scale),
                       A.fused_attention(q, k, v, None, scale))
    assert A.fused_attention.launches == n + 3


@pytest.mark.parametrize("sq", [14, 2])
@pytest.mark.parametrize("bias,masked", [(False, False), (True, False), (False, True),
                                         (True, True)])
def test_attention_short_route_patch_select_layout(cuda, sq, bias, masked):
    """PatchSelecter's own operands (csrc/patch_select.cu): q, k and v column
    slices of one packed qkv [BT, 14, 3 * 512], 8 heads of 64 (sq = 14, the
    self-attention), or 2 query rows over the slices of a packed kv (sq = 2,
    the cross-attention); an additive mask [sq, 14] and a key bias [BT, 14]
    of log integer sizes; BT = 37 frames."""
    rng = np.random.default_rng(100 * sq + 10 * bias + masked)
    BT, P, W, H = 37, 14, 512, 8
    qkv = _rn(rng, BT, P, 3 * W, dtype=torch.bfloat16)
    q, k, v = qkv[:, :sq, :W], qkv[..., W:2 * W], qkv[..., 2 * W:]
    kb = torch.from_numpy(np.log(rng.integers(1, 41, (BT, P))).astype(np.float32)).to(cuda) \
        if bias else None
    mask = torch.from_numpy(rng.standard_normal((sq, P), dtype=np.float32)).to(cuda) \
        if masked else None
    assert A.attention_route(torch.bfloat16, sq, P, W // H) == "mma_short"
    n = A.attention_wide.launches
    _check(lambda: A.attention_wide(q, k, v, mask, 0.125, H, key_bias=kb),
           lambda: A._wide_reference(q, k, v, mask, 0.125, H, kb), torch.bfloat16)
    assert A.attention_wide.launches == n + 1


def test_attention_short_route_copies_misaligned_rows(cuda):
    """A row stride that is not a multiple of 8 elements or a base off 16
    bytes: the wrapper copies the operand and launches the same short
    kernel, which gives the plain result."""
    rng = np.random.default_rng(12)
    q, k, v = _packed_qkv(rng, 5, 14, 14, 128, torch.bfloat16, cuda, pad=4)
    assert q.stride(1) % 8 == 4
    assert A.attention_route(torch.bfloat16, 14, 14, 64) == "mma_short"
    n = A.attention_wide.launches
    _check(lambda: A.attention_wide(q, k, v, None, 0.125, 2),
           lambda: A._wide_reference(q, k, v, None, 0.125, 2), torch.bfloat16)
    buf = _rn(rng, 5, 14, 3 * 128 + 8, dtype=torch.bfloat16)
    q2, k2, v2 = buf[..., 4:132], buf[..., 132:260], buf[..., 260:388]
    assert q2.data_ptr() % 16 == 8
    _check(lambda: A.attention_wide(q2, k2, v2, None, 0.125, 2),
           lambda: A._wide_reference(q2, k2, v2, None, 0.125, 2), torch.bfloat16)
    assert A.attention_wide.launches == n + 2


def test_attention_short_route_grid_stride(cuda):
    """More problems than the card holds warps at once (each warp strides
    over several, through its two-stage ring) with a ragged tail: 10,001
    problems of 14 x 14 x 64 against the plain version, and two launches
    bitwise the same."""
    rng = np.random.default_rng(13)
    q, k, v = (_rn(rng, 10001, 14, 64, dtype=torch.bfloat16) for _ in range(3))
    first = A.fused_attention(q, k, v, None, 0.125)
    _check(lambda: first, lambda: A._fused_attention_plain(q, k, v, mask=None, scale=0.125),
           torch.bfloat16)
    assert torch.equal(first, A.fused_attention(q, k, v, None, 0.125))


def test_attention_mma_route_copies_misaligned_rows(cuda):
    """A row stride that is not a multiple of 8 elements, or a base pointer
    off 16 bytes, cannot feed cp.async: the wrapper copies such an operand
    to a contiguous tensor and launches the same tensor-core kernel (the
    route depends on dtype and shape alone), which gives the plain result;
    the fp32 route takes the same geometry as it is."""
    rng = np.random.default_rng(11)
    q, k, v = _packed_qkv(rng, 2, 64, 64, 128, torch.bfloat16, cuda, pad=4)
    assert q.stride(1) % 8 == 4
    assert A.attention_route(torch.bfloat16, 64, 64, 64) == "mma"
    n = A.attention_wide.launches
    _check(lambda: A.attention_wide(q, k, v, None, 0.125, 2),
           lambda: A._wide_reference(q, k, v, None, 0.125, 2), torch.bfloat16)
    assert A.attention_wide.launches == n + 1
    buf = _rn(rng, 2, 64, 3 * 128 + 8, dtype=torch.bfloat16)
    q2, k2, v2 = buf[..., 4:132], buf[..., 132:260], buf[..., 260:388]
    assert q2.data_ptr() % 16 == 8  # 8 bytes past a 16-byte boundary
    _check(lambda: A.attention_wide(q2, k2, v2, None, 0.125, 2),
           lambda: A._wide_reference(q2, k2, v2, None, 0.125, 2), torch.bfloat16)
    assert A.attention_wide.launches == n + 2
    q, k, v = _packed_qkv(rng, 2, 64, 64, 128, torch.float32, cuda, pad=4)
    _check(lambda: A.attention_wide(q, k, v, None, 0.125, 2),
           lambda: A._wide_reference(q, k, v, None, 0.125, 2), torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sk", [129, 577])
@pytest.mark.parametrize("hd", [48, 80])
def test_attention_odd_head_sizes_over_128_keys(cuda, hd, sk, dtype):
    """Head sizes the kernels are not built for, over 128 keys: the wrapper
    zero-pads each head to the next built size (64, 128) and drops the
    padded context columns; in bf16 the padded call takes the tensor-core
    kernel. Also through fused_attention (one head per row) and the
    gradient (the plain version's, on the unpadded inputs)."""
    rng = np.random.default_rng(hd * 1000 + sk)
    H, sq = 3, 70
    q, k, v = _packed_qkv(rng, 2, sq, sk, hd * H, dtype, cuda)
    kb = torch.from_numpy(np.log(rng.integers(1, 41, (2, sk))).astype(np.float32)).to(cuda)
    scale = hd ** -0.5
    want_route = ("mma_nokeep" if dtype == torch.float32 else  # 48 padded to 64:
                  "wgmma" if hd == 48 and A.sm90_faster(sk) else "mma")  # the Hopper kernel
    assert A.attention_route(dtype, sq, sk, hd) == want_route
    n = A.attention_wide.launches
    _check(lambda: A.attention_wide(q, k, v, None, scale, H, key_bias=kb),
           lambda: A._wide_reference(q, k, v, None, scale, H, kb), dtype)
    assert A.attention_wide.launches == n + 1
    qf, kf, vf = (_rn(rng, 4, s, hd, dtype=dtype) for s in (sq, sk, sk))
    nf = A.fused_attention.launches
    _check(lambda: A.fused_attention(qf, kf, vf, None, scale),
           lambda: A._fused_attention_plain(qf, kf, vf, mask=None, scale=scale), dtype)
    assert A.fused_attention.launches == nf + 1
    if dtype == torch.float32:
        ins = [_leaf(t) for t in (q, k, v)]
        cot = [_rn(rng, 2, sq, hd * H, dtype=dtype)]
        got = torch.autograd.grad(A.attention_wide(*ins, None, scale, H), ins, cot)
        want = torch.autograd.grad(A._wide_reference(*ins, None, scale, H), ins, cot)
        for g, w in zip(got, want):
            err = (g - w).abs().max().item()
            assert err <= TOL[dtype] * max(1.0, w.abs().max().item()), err


# ---------------------------------------------------------------------------
# the Hopper kernel ("mma_sm90", route "wgmma"): bf16 past 128 keys at head
# size 64 (csrc/attention_sm90.cuh)
# ---------------------------------------------------------------------------

# (Sq, Sk): key lengths past one 128-key tile (129), ToMe's layers (152,
# 552), the CLIP image tower's 577, and 1000 keys, whose eight key tiles
# wrap the five K stages in each pass; query lengths off 64 and 128
SM90_SHAPES = [(17, 129), (129, 129), (100, 152), (152, 152), (552, 552), (577, 577),
               (200, 1000), (1000, 1000)]


def _sm90_case(rng, B, sq, sk, H, bias, masked, cuda, pad=0):
    q, k, v = _packed_qkv(rng, B, sq, sk, 64 * H, torch.bfloat16, cuda, pad=pad)
    kb = torch.from_numpy(np.log(rng.integers(1, 41, (B, sk))).astype(np.float32)).to(cuda) \
        if bias else None
    return q, k, v, kb, _causal(sq, sk, cuda) if masked else None


@pytest.fixture
def sm90_always(cuda):
    """The Hopper kernel at every head-64 length past 128 keys, also where
    the plan's measured rule keeps attention_mma_kernel; set back after."""
    before = A.set_sm90_mode("always")
    yield
    A.set_sm90_mode(before)


@pytest.mark.parametrize("sq,sk", SM90_SHAPES)
@pytest.mark.parametrize("bias,masked", [(False, False), (True, False), (False, True),
                                         (True, True)])
def test_attention_sm90(cuda, sm90_always, sq, sk, bias, masked):
    """The Hopper kernel against the plain version, q, k and v column slices
    of one interleaved qkv (row stride 3W), 3 batch elements of 2 heads,
    with and without a key bias and a causal mask; the launch reads back
    "mma_sm90" (at 129 and 152 keys only with the switch at "always")."""
    rng = np.random.default_rng(sq * 7919 + sk)
    q, k, v, kb, mask = _sm90_case(rng, 3, sq, sk, 2, bias, masked, cuda)
    assert q.stride(1) == 3 * 128
    assert A.attention_route(torch.bfloat16, sq, sk, 64, has_bias=bias or masked) == "wgmma"
    A.attention_wide.attn_routes = {}
    _check(lambda: A.attention_wide(q, k, v, mask, 0.125, 2, key_bias=kb),
           lambda: A._wide_reference(q, k, v, mask, 0.125, 2, kb), torch.bfloat16)
    assert A.attention_wide.attn_routes == {"mma_sm90": 1}


@pytest.mark.parametrize("sk", [129, 152, 177, 277, 302])
def test_attention_sm90_rule_keeps_mma(cuda, sk):
    """Lengths the measured rule declines (a last 128-key tile at most half
    full, at most 3 tiles: ToMe's 152, 177, 277 and 302 tokens) keep
    attention_mma_kernel by default."""
    rng = np.random.default_rng(sk)
    q, k, v, kb, _ = _sm90_case(rng, 2, sk, sk, 2, True, False, cuda)
    assert not A.sm90_faster(sk)
    A.attention_wide.attn_routes = {}
    _check(lambda: A.attention_wide(q, k, v, None, 0.125, 2, key_bias=kb),
           lambda: A._wide_reference(q, k, v, None, 0.125, 2, kb), torch.bfloat16)
    assert A.attention_wide.attn_routes == {"mma": 1}


def test_attention_sm90_fully_masked_rows(cuda):
    """Rows whose keys are all masked to -inf give what attention_mma_kernel
    gives (NaN: the row's sum is 0), the other rows the plain result."""
    rng = np.random.default_rng(5)
    q, k, v, _, mask = _sm90_case(rng, 2, 400, 400, 2, False, True, cuda)
    mask[:5] = float("-inf")
    mask[130:133] = float("-inf")
    got = A.attention_wide(q, k, v, mask, 0.125, 2)
    before = A.set_sm90_mode("off")
    try:
        A.attention_wide.attn_routes = {}
        old = A.attention_wide(q, k, v, mask, 0.125, 2)
        assert A.attention_wide.attn_routes == {"mma": 1}
    finally:
        A.set_sm90_mode(before)
    want = A._wide_reference(q, k, v, mask, 0.125, 2).float()
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(old))
    assert bool(torch.isnan(got[:, :5]).all()) and bool(torch.isnan(got[:, 130:133]).all())
    live = torch.ones(400, dtype=torch.bool, device=cuda)
    live[:5] = live[130:133] = False
    err = (got.float() - want)[:, live].abs().max().item()
    assert err <= TOL[torch.bfloat16] * max(1.0, want[:, live].abs().max().item()), err


@pytest.mark.parametrize("hd", [32, 128])
def test_attention_sm90_head_sizes_keep_mma(cuda, hd):
    """Head sizes 32 and 128 past 128 keys stay on attention_mma_kernel's
    two-pass form (the Hopper kernel is built for 64 lanes)."""
    rng = np.random.default_rng(hd)
    q, k, v = _packed_qkv(rng, 2, 150, 577, hd * 2, torch.bfloat16, cuda)
    assert A.attention_plan(torch.bfloat16, 150, 577, hd).kernel == "mma"
    A.attention_wide.attn_routes = {}
    _check(lambda: A.attention_wide(q, k, v, None, hd ** -0.5, 2),
           lambda: A._wide_reference(q, k, v, None, hd ** -0.5, 2), torch.bfloat16)
    assert A.attention_wide.attn_routes == {"mma": 1}


def test_attention_sm90_copies_misaligned_rows(cuda):
    """A row stride off 8 elements or a base off 16 bytes cannot feed TMA:
    the wrapper copies the operand and the Hopper kernel runs on the copy."""
    rng = np.random.default_rng(12)
    q, k, v, kb, _ = _sm90_case(rng, 2, 200, 400, 2, True, False, cuda, pad=4)
    assert q.stride(1) % 8 == 4
    buf = _rn(rng, 2 * 200 * 128 + 8, dtype=torch.bfloat16)
    q2 = buf[4:4 + 2 * 200 * 128].view(2, 200, 128)
    assert q2.data_ptr() % 16 == 8
    for qq in (q, q2):
        A.attention_wide.attn_routes = {}
        _check(lambda: A.attention_wide(qq, k, v, None, 0.125, 2, key_bias=kb),
               lambda: A._wide_reference(qq, k, v, None, 0.125, 2, kb), torch.bfloat16)
        assert A.attention_wide.attn_routes == {"mma_sm90": 1}


def test_attention_sm90_fused_attention(cuda):
    """fused_attention's head rows [BH, S, 64] past 128 keys take the Hopper
    kernel too."""
    rng = np.random.default_rng(13)
    qf, kf, vf = (_rn(rng, 6, s, 64, dtype=torch.bfloat16) for s in (200, 577, 577))
    _check(lambda: A.fused_attention(qf, kf, vf, None, 0.125),
           lambda: A._fused_attention_plain(qf, kf, vf, mask=None, scale=0.125), torch.bfloat16)


# (Sq, Sk, key bias, causal mask, switch, kernel): the CLIP image tower's
# 577 tokens and ToMe's key-bias 552 on the Hopper kernel, 1000 masked keys
# under "always"; ToMe's 152 and the image tower's 577 on
# attention_mma_kernel's two-pass form (the rule's choice, and "off")
SM90_TIGHT = [(577, 577, False, False, "default", "mma_sm90"),
              (552, 552, True, False, "default", "mma_sm90"),
              (300, 1000, True, True, "always", "mma_sm90"),
              (152, 152, True, False, "default", "mma"),
              (577, 577, False, False, "off", "mma")]


@pytest.mark.parametrize("sq,sk,bias,masked,mode,kernel", SM90_TIGHT)
def test_attention_sm90_tight_bf16_bound(cuda, sq, sk, bias, masked, mode, kernel):
    """The two-pass kernels past 128 keys at the tight bf16 bound
    (``_keep_bounds.wide_flips``: one ulp of each context element plus the
    terms whose p lies at a rounding boundary and the fp32 order of the
    sum), which a version with p rounded elsewhere fails
    (``test_torch_attention_sm90_plan.py::test_bf16_bound_sees_a_moved_rounding``):
    the contract's rounding point p = round(exp(s - m) / l) kept. 2 batch
    elements of 2 heads, packed qkv; the launch read back."""
    rng = np.random.default_rng(sq * 31 + sk)
    q, k, v, kb, mask = _sm90_case(rng, 2, sq, sk, 2, bias, masked, cuda)
    before = A.set_sm90_mode(mode)
    try:
        A.attention_wide.attn_routes = {}
        got = A.attention_wide(q, k, v, mask, 0.125, 2, key_bias=kb)
        torch.cuda.synchronize()
        assert A.attention_wide.attn_routes == {kernel: 1}
    finally:
        A.set_sm90_mode(before)
    host = [None if t is None else t.cpu() for t in (q, k, v, mask, kb)]
    want = A._wide_reference(*host[:4], 0.125, 2, host[4])
    bound = wide_flips(*host[:4], 0.125, 2, host[4])
    check_bf16(got.float().cpu().numpy(), want.float().numpy(), bound, f"ctx {kernel}")


def test_attention_sm90_library_plan(cuda):
    """The library's plan equals the Python one over a grid that crosses
    the one-pass limit (128 keys), the five resident K tiles (640 keys) and
    the head sizes, with and without a mask or key bias."""
    limit = A.smem_limit(cuda)
    for sq in (1, 15, 16, 64, 577):
        for sk in (16, 64, 127, 128, 129, 130, 577, 640, 641, 1000):
            for hd in (32, 48, 64, 128):
                for bias in (False, True):
                    plan = A.attention_plan(torch.bfloat16, sq, sk, hd, limit=limit,
                                            has_bias=bias)
                    assert A.library_plan(torch.bfloat16, sq, sk, plan.head, has_bias=bias) == (
                        plan.kernel, plan.smem_bytes), (sq, sk, hd, bias)
                    assert A.attention_route(torch.bfloat16, sq, sk, hd,
                                             has_bias=bias) == plan.route


def test_fused_attn_ln2_bf16_reads_back_its_attention(cuda):
    """A bf16 attention half past 128 tokens writes its attention's kernel
    into its one attention row: the CLIP image block's 577 tokens
    "mma_sm90", ToMe-like 152 "mma" (the rule declines it); the text
    tower's 77 passes no row and tallies nothing."""
    rng = np.random.default_rng(14)
    for W, H, S_, mask, want in ((1024, 16, 577, None, {"mma_sm90": 1}),
                                 (1024, 16, 152, None, {"mma": 1}),
                                 (768, 12, 77, causal_mask(77, device=cuda), {})):
        blk = ResidualAttentionBlock(W, H, torch.Generator().manual_seed(0)).to(
            cuda, torch.bfloat16)
        x = _rn(rng, 2, S_, W, dtype=torch.bfloat16)
        R.fused_attn_ln2.attn_routes = {}
        _check(lambda: R.fused_attn_ln2(x, blk, mask, H),
               lambda: R._attn_ln2_plain(blk, x, heads=H, mask=mask), torch.bfloat16)
        assert R.fused_attn_ln2.attn_routes == want


def _moe_args(rng, B, T, E, H, D, dtype, cuda):
    x = _rn(rng, B, T, D, dtype=dtype)
    w1t, b1 = _rn(rng, E, D, H, dtype=dtype, scale=0.05), _rn(rng, E, H, dtype=dtype, scale=0.1)
    w2t, b2 = _rn(rng, E, H, D, dtype=dtype, scale=0.05), _rn(rng, E, D, dtype=dtype, scale=0.1)
    w = torch.from_numpy(0.05 * rng.random((B, E, T), dtype=np.float32)).to(cuda, dtype)
    return x, w1t, b1, w2t, b2, w


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_gaussian_moe(cuda, dtype):
    rng = np.random.default_rng(1)
    args = _moe_args(rng, 5, 60, 7, 256, 512, dtype, cuda)
    _check(lambda: G.fused_gaussian_moe(*args), lambda: G._reference_impl(*args), dtype)


# (B, T, E, H, D): odd B (a pair with one sample), T on both sides of the
# 64-row chunk (1, 7, 60, 64, 65, 130), one expert, H not a multiple of 64
# or of 128 (expert edges inside a column tile), D not a multiple of 8 (the
# wrapper pads it) and D = 768 (bf16 past the wgmma route's 512)
MOE_EDGES = [(3, 1, 7, 256, 512), (5, 7, 1, 40, 512), (1, 60, 7, 256, 512),
             (3, 64, 7, 256, 512), (3, 65, 7, 200, 512), (2, 130, 7, 256, 512),
             (64, 60, 7, 256, 512), (3, 60, 7, 100, 36), (2, 60, 3, 256, 768)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,e,h,d", MOE_EDGES)
def test_fused_gaussian_moe_edges(cuda, b, t, e, h, d, dtype):
    """The kernel against its plain version at the T / B / E / H / D edges
    of its tiling, the routes it tallies (``moe_route``'s for the hidden
    product, tf32x3 for the second), and two launches bitwise the same."""
    args = _moe_args(np.random.default_rng(b * 1000 + t), b, t, e, h, d, dtype, cuda)
    G.fused_gaussian_moe.gemm_routes = {}
    first = G.fused_gaussian_moe(*args)
    second = G.fused_gaussian_moe(*args)
    want = G._reference_impl(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    route = G.moe_route(dtype, d)
    assert G.fused_gaussian_moe.gemm_routes == (
        {"tf32x3": 4} if route == "tf32x3" else {route: 2, "tf32x3": 2})
    assert first.dtype == dtype and torch.isfinite(first).all()
    err = (first.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * max(1.0, want.float().abs().max().item()), err


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_attn_ln2(cuda, dtype):
    rng = np.random.default_rng(2)
    blk = ResidualAttentionBlock(768, 12, torch.Generator().manual_seed(0)).to(cuda, dtype)
    x = _rn(rng, 3, 77, 768, dtype=dtype)
    mask = causal_mask(77, device=cuda)
    _check(lambda: R.fused_attn_ln2(x, blk, mask, 12),
           lambda: R._attn_ln2_plain(blk, x, heads=12, mask=mask), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_patch_select(cuda, dtype):
    rng = np.random.default_rng(3)
    ps = PatchSelecter(512, torch.Generator().manual_seed(0)).to(cuda, dtype)
    patch = _rn(rng, 2, 7, 14, 512, dtype=dtype)
    audio, video = _rn(rng, 2, 7, 512, dtype=dtype), _rn(rng, 2, 7, 512, dtype=dtype)
    _check(lambda: PS.fused_patch_select(patch, audio, video, ps, 8),
           lambda: PS.patch_selecter_plain(ps, patch, audio, video, nhead=8), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,sq,sk,masked", [(24, 77, 77, True), (512, 14, 14, False),
                                             (6, 150, 150, False)])
def test_fused_attention(cuda, dtype, bh, sq, sk, masked):
    """The text tower's head-split shape (causal), the packed route's tiny
    unmasked one (the short tensor-core kernel in bf16, an FMA kernel in
    fp32), and keys past 128 (the tiled FMA kernel in fp32, the tensor-core
    kernel in bf16)."""
    rng = np.random.default_rng(9)
    q, k, v = (_rn(rng, bh, s, 64, dtype=dtype) for s in (sq, sk, sk))
    mask = causal_mask(sq, device=cuda) if masked else None
    n = A.fused_attention.launches
    _check(lambda: A.fused_attention(q, k, v, mask, 0.125),
           lambda: A._fused_attention_plain(q, k, v, mask=mask, scale=0.125), dtype)
    assert A.fused_attention.launches == n + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 3, 256])
def test_fused_attn_half_and_resblock(cuda, b, dtype):
    """The text tower's block at B = 1, 3 and 256: ``fused_attn_half``
    launches its kernel once, ``fused_resblock`` the attention half and the
    MLP half, whose two products take gemm_sm90 (wgmma) in bf16 and
    gemm_tile's FMA loop in fp32."""
    rng = np.random.default_rng(10)
    blk = ResidualAttentionBlock(768, 12, torch.Generator().manual_seed(0)).to(cuda, dtype)
    x = _rn(rng, b, 77, 768, dtype=dtype)
    mask = causal_mask(77, device=cuda)
    half, res = R.fused_attn_half.launches, R.fused_resblock.launches
    _check(lambda: R.fused_attn_half(x, blk, mask, 12),
           lambda: R._attn_half_flat(x, *R._attn_params(blk), heads=12, mask=mask), dtype)
    R.fused_resblock.gemm_routes = {}
    _check(lambda: R.fused_resblock(x, blk, mask, 12),
           lambda: R._resblock_flat(x, *R._resblock_params(blk), heads=12, mask=mask), dtype)
    assert (R.fused_attn_half.launches, R.fused_resblock.launches) == (half + 2, res + 1)
    assert R.fused_resblock.gemm_routes == {"wgmma" if dtype == torch.bfloat16 else "fma": 2}


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(2, 5, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        A.attention_wide(x, x, x, None, 1.0, 4)
    y = torch.zeros(2, 5, 64, device=cuda)
    with pytest.raises(ValueError, match="mask"):
        A.attention_wide(y, y, y, torch.zeros(3, 3, device=cuda), 1.0, 4)


# ---------------------------------------------------------------------------
# gradients: the slice-1 kernels' autograd Functions, the train kernel pairs
# ---------------------------------------------------------------------------

def _leaf(t):
    return t.detach().clone().requires_grad_(True)


def _outs_and_grads(outs, ins, cots):
    outs = [outs] if torch.is_tensor(outs) else list(outs)
    for o in outs:
        assert o.grad_fn is not None, "the kernel's output carries no gradient"
    return outs + list(torch.autograd.grad(outs, ins, cots))


def _slice1_case(name, rng, cuda):
    dt = torch.float32
    gen = torch.Generator().manual_seed(0)
    if name == "fused_attn_ln2":
        blk = ResidualAttentionBlock(768, 12, gen).to(cuda, dt)
        x, mask = _leaf(_rn(rng, 2, 13, 768, dtype=dt)), causal_mask(13, device=cuda)
        return (lambda: R.fused_attn_ln2(x, blk, mask, 12),
                lambda: R._attn_ln2_plain(blk, x, heads=12, mask=mask),
                [x] + R._block_params(blk), [_rn(rng, 2, 13, 768, dtype=dt)] * 2)
    if name == "attention_wide":
        q, k, v = (_leaf(_rn(rng, 3, s, 512, dtype=dt)) for s in (60, 77, 77))
        return (lambda: A.attention_wide(q, k, v, None, 0.125, 8),
                lambda: A._wide_reference(q, k, v, None, 0.125, 8), [q, k, v],
                [_rn(rng, 3, 60, 512, dtype=dt)])
    if name == "fused_attention":
        q, k, v = (_leaf(_rn(rng, 36, 77, 64, dtype=dt)) for _ in range(3))
        mask = causal_mask(77, device=cuda)
        return (lambda: A.fused_attention(q, k, v, mask, 0.125),
                lambda: A._fused_attention_rule(q, k, v, mask=mask, scale=0.125), [q, k, v],
                [_rn(rng, 36, 77, 64, dtype=dt)])
    if name in ("fused_attn_half", "fused_resblock"):
        blk = ResidualAttentionBlock(768, 12, gen).to(cuda, dt)
        x, mask = _leaf(_rn(rng, 2, 13, 768, dtype=dt)), causal_mask(13, device=cuda)
        if name == "fused_attn_half":
            params = R._attn_params(blk)
            return (lambda: R.fused_attn_half(x, blk, mask, 12),
                    lambda: R._attn_half_flat(x, *params, heads=12, mask=mask),
                    [x] + params, [_rn(rng, 2, 13, 768, dtype=dt)])
        params = R._resblock_params(blk)
        return (lambda: R.fused_resblock(x, blk, mask, 12),
                lambda: R._resblock_rule(x, *params, heads=12, mask=mask),
                [x] + params, [_rn(rng, 2, 13, 768, dtype=dt)])
    if name == "attention_wide_key_bias":
        q = _leaf(_rn(rng, 2, 40, 512, dtype=dt))
        k, v = (_leaf(_rn(rng, 2, 150, 512, dtype=dt)) for _ in range(2))
        kb = _leaf(torch.from_numpy(np.log(rng.integers(1, 41, (2, 150))).astype(np.float32))
                   .to(cuda))
        return (lambda: A.attention_wide_key_bias(q, k, v, kb, 0.125, 8),
                lambda: A._wide_reference(q, k, v, None, 0.125, 8, kb), [q, k, v, kb],
                [_rn(rng, 2, 40, 512, dtype=dt)])
    if name == "fused_patch_select":
        ps = PatchSelecter(512, gen).to(cuda, dt)
        patch = _leaf(_rn(rng, 2, 5, 14, 512, dtype=dt))
        audio, video = _leaf(_rn(rng, 2, 5, 512, dtype=dt)), _leaf(_rn(rng, 2, 5, 512, dtype=dt))
        return (lambda: PS.fused_patch_select(patch, audio, video, ps, 8),
                lambda: tuple(PS.patch_selecter_plain(ps, patch, audio, video, nhead=8)),
                [patch, audio, video] + list(ps.parameters()),
                [_rn(rng, 2, 5, 512, dtype=dt), _rn(rng, 2, 5, 512, dtype=dt)])
    x = _leaf(_rn(rng, 4, 60, 512, dtype=dt))
    w1t, b1 = _leaf(_rn(rng, 7, 512, 256, dtype=dt, scale=0.05)), _leaf(_rn(rng, 7, 256, dtype=dt))
    w2t, b2 = _leaf(_rn(rng, 7, 256, 512, dtype=dt, scale=0.05)), _leaf(_rn(rng, 7, 512, dtype=dt))
    w = _leaf(torch.from_numpy(0.05 * rng.random((4, 7, 60), dtype=np.float32)).to(cuda))
    ins = [x, w1t, b1, w2t, b2, w]
    return (lambda: G.fused_gaussian_moe(*ins), lambda: G._reference_impl(*ins), ins,
            [_rn(rng, 4, 512, dtype=dt)])


@pytest.mark.parametrize("name", ["fused_attn_ln2", "attention_wide", "attention_wide_key_bias",
                                  "fused_patch_select", "fused_gaussian_moe", "fused_attention",
                                  "fused_attn_half", "fused_resblock"])
def test_slice1_kernel_gradients(cuda, name):
    """On the card the kernels' outputs carry the plain version's gradient
    (the JAX custom_vjp rule): every input and parameter gradient equals
    autograd's through the plain version, the key bias's included
    (``fused_resblock``: through ``_resblock_rule``, the JAX rule's)."""
    kernel, plain, ins, cots = _slice1_case(name, np.random.default_rng(5), cuda)
    got, want = _outs_and_grads(kernel(), ins, cots), _outs_and_grads(plain(), ins, cots)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs().max().item()
        assert err <= TOL[torch.float32] * max(1.0, w.float().abs().max().item()), err


def _mask_case(name, rng, dev):
    """(kernel call, differentiated inputs, cotangents) of each wrapper that
    gives an additive mask its cotangent, the mask a finite [Sq, Sk] leaf,
    built on ``dev`` from the same seed on either device."""
    dt = torch.float32

    def rn(*shape):
        return _leaf(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev))

    if name == "attention_wide":
        q, k, v, mask = rn(3, 12, 256), rn(3, 20, 256), rn(3, 20, 256), rn(12, 20)
        return lambda: A.attention_wide(q, k, v, mask, 0.125, 4), [q, k, v, mask], \
            [rn(3, 12, 256).detach()]
    if name == "fused_attention":
        q, k, v, mask = rn(8, 14, 64), rn(8, 14, 64), rn(8, 14, 64), rn(14, 14)
        return lambda: A.fused_attention(q, k, v, mask, 0.125), [q, k, v, mask], \
            [rn(8, 14, 64).detach()]
    blk = ResidualAttentionBlock(256, 4, torch.Generator().manual_seed(0)).to(dev, dt)
    x, mask = rn(2, 13, 256), rn(13, 13)
    if name == "fused_attn_ln2":
        return lambda: R.fused_attn_ln2(x, blk, mask, 4), [x, mask] + R._block_params(blk), \
            [rn(2, 13, 256).detach(), rn(2, 13, 256).detach()]
    return lambda: R.fused_attn_half(x, blk, mask, 4), [x, mask] + R._attn_params(blk), \
        [rn(2, 13, 256).detach()]


@pytest.mark.parametrize("name", ["attention_wide", "fused_attn_ln2", "fused_attention",
                                  "fused_attn_half"])
def test_mask_cotangent_card_equals_cpu(cuda, name):
    """A mask that requires grad gets the same gradient through the kernel
    on the card as through the plain version on the CPU (the JAX rules give
    it a real cotangent), and so does every other input."""
    got, want = ([g.float().cpu() for g in _outs_and_grads(call(), ins, cots)]
                 for call, ins, cots in (_mask_case(name, np.random.default_rng(11), dev)
                                         for dev in (cuda, "cpu")))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        err = (g - w).abs().max().item()
        assert err <= TOL[torch.float32] * max(1.0, w.abs().max().item()), err


# a train kernel pair's (N, T, S) for "avq", (B, T, P) for "patch_select":
# the train recipe's (B = 32: N = 64 AVQ rows, 32 x 60 PatchSelecter
# frames), and row counts that are not multiples of 4 (AVQ: 15 rows over
# 231 words; PatchSelecter: 6 query rows over 42 patch rows)
RECIPE_DIMS = {"avq": (64, 60, 77), "patch_select": (32, 60, 14)}
RAGGED_DIMS = {"avq": (3, 5, 77), "patch_select": (1, 3, 14)}


def _train_case(kind, dtype, cuda, rng, dims=None):
    """A train kernel pair's inputs at a small shape, or at ``dims``."""
    gen = torch.Generator().manual_seed(0)
    mgen = torch.Generator(device=cuda).manual_seed(1)
    D, H = 512, 8
    if kind == "avq":
        N, T, S = dims or (4, 6, 9)
        mod = AVQCrossAttn(D, gen).to(cuda, dtype)
        acts = [_leaf(_rn(rng, N, T, D, dtype=dtype)), _leaf(_rn(rng, N, T, D, dtype=dtype)),
                _leaf(_rn(rng, N, S, D, dtype=dtype))]
        masks = make_avq_dropout_masks(mgen, N, T, S, D, nhead=H, dropout_p=0.1, dtype=dtype)
        cots = [_rn(rng, N, T, D, dtype=dtype)]
        kernel = lambda m, a, mk: AV.fused_avq_train(*a, m, mk, H)  # noqa: E731
        plain = lambda m, a, mk: AV.avq_sub_forward_masked(m, *a, mk, nhead=H)  # noqa: E731
        counters = (AV.fused_avq_train, AV.fused_avq_train_bwd)
    else:
        B, T, P = dims or (2, 4, 14)
        mod = PatchSelecter(D, gen).to(cuda, dtype)
        acts = [_leaf(_rn(rng, B, T, P, D, dtype=dtype)), _leaf(_rn(rng, B, T, D, dtype=dtype)),
                _leaf(_rn(rng, B, T, D, dtype=dtype))]
        masks = make_patch_dropout_masks(mgen, B * T, P, D, nhead=H, dropout_p=0.1, dtype=dtype)
        cots = [_rn(rng, B, T, D, dtype=dtype), _rn(rng, B, T, D, dtype=dtype)]
        kernel = lambda m, a, mk: PS.fused_patch_select_train(*a, m, mk, H)  # noqa: E731
        plain = lambda m, a, mk: tuple(PS.patch_selecter_plain(m, *a, nhead=H,  # noqa: E731
                                                               masks=mk))
        counters = (PS.fused_patch_select_train, PS.fused_patch_select_train_bwd)
    return mod, acts, masks, cots, kernel, plain, counters


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["avq", "patch_select"])
def test_train_kernels_forward_and_backward(cuda, kind, dtype):
    """One forward and one backward launch; the outputs, the input
    gradients and the (fp32) parameter gradients against the plain version
    on the same masks."""
    mod, acts, masks, cots, kernel, plain, (fwd, bwd) = _train_case(
        kind, dtype, cuda, np.random.default_rng(6))
    ins = acts + list(mod.parameters())
    n_fwd, n_bwd = fwd.launches, bwd.launches
    got = _outs_and_grads(kernel(mod, acts, masks), ins, cots)
    assert (fwd.launches, bwd.launches) == (n_fwd + 1, n_bwd + 1)
    want = _outs_and_grads(plain(mod, acts, masks), ins, cots)
    n_out = len(got) - len(ins)
    if dtype == torch.float32:
        ref, plain_err = want, [0.0] * len(want)
    else:
        m32 = copy.deepcopy(mod).float()
        a32 = [_leaf(a.detach().float()) for a in acts]
        ref = _outs_and_grads(plain(m32, a32, {k: v.float() for k, v in masks.items()}),
                              a32 + list(m32.parameters()), [c.float() for c in cots])
        plain_err = [(w.float() - r).abs().max().item() for w, r in zip(want, ref)]
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.device.type == "cuda" and torch.isfinite(g).all()
        assert g.dtype == (dtype if i < len(acts) + n_out else w.dtype), i
        target = w if i < n_out else ref[i]
        err = (g.float() - target.float()).abs().max().item()
        limit = TOL[dtype] * max(1.0, target.float().abs().max().item())
        if i >= n_out:
            limit = max(limit, 2 * plain_err[i])
        assert err <= limit, (i, err, limit)


# ---------------------------------------------------------------------------
# the Hopper GEMM (gemm_sm90: TMA + wgmma) under the fused bf16 kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("epilogue", ["bias", "residual", "f32"])
@pytest.mark.parametrize("k", [256, 512, 768, 1024])
@pytest.mark.parametrize("n", [256, 512, 768, 2304, 3072])
@pytest.mark.parametrize("m", [1, 127, 129, 2464, 69240])
def test_gemm_sm90(cuda, m, n, k, epilogue):
    """gemm_sm90 against the fp32 product of the same bf16 operands, through
    each epilogue the fused kernels use, at ragged M (no M of the paths is a
    multiple of 128) and the paths' widths (N >= 2304 takes 128 x 256 tiles).
    The bf16 epilogues are held to bf16 rounding, the fp32 one to the sum's
    order."""
    rng = np.random.default_rng(m + 7 * n + 13 * k)
    dt = torch.bfloat16
    a, b = _rn(rng, m, k, dtype=dt), _rn(rng, n, k, dtype=dt, scale=k ** -0.5)
    bias, res = _rn(rng, n, dtype=dt), _rn(rng, m, n, dtype=dt)
    kw = dict(epilogue=epilogue, bias=bias, res=res if epilogue == "residual" else None,
              relu=epilogue == "bias" and k % 512 == 0)
    launches = GM.gemm_sm90.launches
    got, want = GM.gemm_sm90(a, b, **kw), GM.gemm_plain(a, b, **kw)
    torch.cuda.synchronize()
    assert GM.gemm_sm90.launches == launches + 1
    assert got.dtype == want.dtype and tuple(got.shape) == (m, n)
    assert torch.isfinite(got).all()
    tol = TOL[torch.float32 if epilogue == "f32" else dt]
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(1.0, want.float().abs().max().item()), err


# (M, N, K) of every product the two fused kernels launch on the four paths:
# the text tower at B = 256 (serving, bench_resblock), 32 (train) and 2 (raw
# media); the CLIP image tower at 120 frames; PatchSelecter at B*T = 15360
# (serving) and 120 (raw media)
PATH_GEMMS = sorted({(r, n, k) for r in (256 * 77, 32 * 77, 2 * 77) for n, k in
                     ((2304, 768), (768, 768))}
                    | {(120 * 577, n, 1024) for n in (3072, 1024)}
                    | {(bt * 14, n, 512) for bt in (15360, 120) for n in (1536, 512, 1024)}
                    | {(2 * bt, n, k) for bt in (15360, 120) for n, k in
                       ((512, 512), (256, 512), (512, 256))}
                    | set(GM.mlp_gemm_shapes(256 * 77, 768))
                    | set(GM.avq_train_fwd_gemm_shapes(64, 60, 77, 512)))


@pytest.mark.parametrize("m,n,k", PATH_GEMMS)
def test_gemm_route_on_path_shapes(cuda, m, n, k):
    assert GM.gemm_route(torch.bfloat16, m, n, k) == "wgmma"
    assert GM.gemm_route(torch.float32, m, n, k) == "fma"
    assert GM.gemm_route(torch.bfloat16, m, n + 4, k) == "wmma"
    assert GM.gemm_route(torch.bfloat16, m, n, k + 4) == "wmma"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,b,s,w,heads", [("text", 256, 77, 768, 12),
                                              ("clip_image", 24, 577, 1024, 16)])
def test_fused_attn_kernels_on_the_gemm_route(cuda, kind, b, s, w, heads, dtype):
    """fused_attn_ln2 and fused_attn_half at the text tower's serving shape
    (causal) and the CLIP image tower's (577 tokens, no mask) against their
    plain versions; both products on gemm_sm90 in bf16 and on gemm_tf32x3 in
    fp32, as each launch's tally reads back."""
    rng = np.random.default_rng(b + s)
    blk = ResidualAttentionBlock(w, heads, torch.Generator().manual_seed(0)).to(cuda, dtype)
    x = _rn(rng, b, s, w, dtype=dtype)
    mask = causal_mask(s, device=cuda) if kind == "text" else None
    route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    if dtype == torch.bfloat16:
        assert GM.gemm_route(dtype, b * s, 3 * w, w) == route
        assert GM.gemm_route(dtype, b * s, w, w) == route
    n_ln2, n_half = R.fused_attn_ln2.launches, R.fused_attn_half.launches
    R.fused_attn_ln2.gemm_routes, R.fused_attn_half.gemm_routes = {}, {}
    _check(lambda: R.fused_attn_ln2(x, blk, mask, heads),
           lambda: R._attn_ln2_plain(blk, x, heads=heads, mask=mask), dtype)
    _check(lambda: R.fused_attn_half(x, blk, mask, heads),
           lambda: R._attn_half_flat(x, *R._attn_params(blk), heads=heads, mask=mask), dtype)
    assert (R.fused_attn_ln2.launches, R.fused_attn_half.launches) == (n_ln2 + 1, n_half + 1)
    assert R.fused_attn_ln2.gemm_routes == R.fused_attn_half.gemm_routes == {route: 2}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t", [(256, 60), (2, 60)])
def test_fused_patch_select_on_the_gemm_route(cuda, b, t, dtype):
    """fused_patch_select at the serving shape (B=256, T=60) and the raw
    media one (B=2) against its plain version; its seven products on
    gemm_sm90 in bf16 and gemm_tf32x3 in fp32, as the plan rows the launch
    wrote say, its two attentions on the short kernel in bf16 and the
    keep-masked kernel without a keep mask in fp32."""
    rng = np.random.default_rng(b)
    D = 512
    ps = PatchSelecter(D, torch.Generator().manual_seed(0)).to(cuda, dtype)
    patch = _rn(rng, b, t, 14, D, dtype=dtype)
    audio, video = _rn(rng, b, t, D, dtype=dtype), _rn(rng, b, t, D, dtype=dtype)
    route = "wgmma" if dtype == torch.bfloat16 else "fma"
    for m, n, k in ((b * t * 14, 3 * D, D), (b * t * 14, D, D), (b * t * 14, 2 * D, D),
                    (2 * b * t, D, D), (2 * b * t, D // 2, D), (2 * b * t, D, D // 2)):
        assert GM.gemm_route(dtype, m, n, k) == route
    n = PS.fused_patch_select.launches
    PS.fused_patch_select.gemm_routes, PS.fused_patch_select.attn_routes = {}, {}
    _check(lambda: PS.fused_patch_select(patch, audio, video, ps, 8),
           lambda: PS.patch_selecter_plain(ps, patch, audio, video, nhead=8), dtype)
    assert PS.fused_patch_select.launches == n + 1
    bf16 = dtype == torch.bfloat16
    assert PS.fused_patch_select.gemm_routes == {"wgmma" if bf16 else "tf32x3": 7}
    assert PS.fused_patch_select.attn_routes == {"mma_short" if bf16 else "mma_nokeep": 2}


@pytest.mark.parametrize("b", [2, 32])
def test_fused_patch_select_fp32_eval_batch(cuda, b):
    """fp32 at B = 2 and the eval batch 32 (T = 60): against the plain
    version, twice bitwise, its products tf32x3 x 7 and its attentions
    mma_nokeep x 2, read back from the launch."""
    rng = np.random.default_rng(b + 7)
    f32, D = torch.float32, 512
    ps = PatchSelecter(D, torch.Generator().manual_seed(1)).to(cuda, f32)
    patch = _rn(rng, b, 60, 14, D, dtype=f32)
    audio, video = _rn(rng, b, 60, D, dtype=f32), _rn(rng, b, 60, D, dtype=f32)
    PS.fused_patch_select.gemm_routes, PS.fused_patch_select.attn_routes = {}, {}
    first = PS.fused_patch_select(patch, audio, video, ps, 8)
    _check(lambda: first, lambda: PS.patch_selecter_plain(ps, patch, audio, video, nhead=8), f32)
    assert PS.fused_patch_select.gemm_routes == {"tf32x3": 7}
    assert PS.fused_patch_select.attn_routes == {"mma_nokeep": 2}
    again = PS.fused_patch_select(patch, audio, video, ps, 8)
    assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tp", [2, 4])
def test_fused_patch_select_tp_stages_planned(cuda, tp, dtype):
    """Each eval stage on each model rank against its plain version, its
    products on the plan (tf32x3 in fp32, wgmma in bf16) and its attention
    on the kernel tp = 1 takes, read back from the launch."""
    from qa_tiger_tpu_torch.parallel.tensor import Grid, shard_module_

    rng = np.random.default_rng(tp)
    D, H, B, T = 512, 8, 2, 60
    ps = PatchSelecter(D, torch.Generator().manual_seed(tp)).to(cuda, dtype)
    patch = _rn(rng, B, T, 14, D, dtype=dtype)
    audio, video = _rn(rng, B, T, D, dtype=dtype), _rn(rng, B, T, D, dtype=dtype)
    x1 = _rn(rng, B, T, 14, D, dtype=dtype)
    crs = _rn(rng, B, T, 2, D, dtype=dtype)
    route = "tf32x3" if dtype == torch.float32 else "wgmma"
    attn = "mma_nokeep" if dtype == torch.float32 else "mma_short"
    heads = H // tp
    for r in range(tp):
        s = shard_module_(copy.deepcopy(ps), Grid(model_rank=r, model_size=tp))
        stages = [
            (PS.fused_patch_select_tp_self,
             lambda: PS.fused_patch_select_tp_self(patch, s.slf_attn, heads),
             lambda: PS._tp_self_plain(patch, s.slf_attn.in_proj_weight,
                                       s.slf_attn.in_proj_bias, s.slf_attn.out_proj.weight,
                                       heads), 2, {attn: 1}),
            (PS.fused_patch_select_tp_cross,
             lambda: PS.fused_patch_select_tp_cross(x1, audio, video, s.crs_attn, heads),
             lambda: PS._tp_cross_plain(x1, audio, video, s.crs_attn.in_proj_weight,
                                        s.crs_attn.in_proj_bias, s.crs_attn.out_proj.weight,
                                        heads), 3, {attn: 1}),
            (PS.fused_patch_select_tp_mlp, lambda: PS.fused_patch_select_tp_mlp(crs, s.mlp),
             lambda: PS._tp_mlp_plain(crs, s.mlp[0].weight, s.mlp[0].bias, s.mlp[2].weight),
             2, None)]
        for stage, kernel, plain, products, attn_routes in stages:
            stage.gemm_routes = {}
            if attn_routes is not None:
                stage.attn_routes = {}
            got, want = kernel(), plain()  # fp32 partials; bf16 inputs round as bf16
            err = (got - want).abs().max().item()
            assert err <= TOL[dtype] * max(1.0, want.abs().max().item()), err
            assert stage.gemm_routes == {route: products}
            if attn_routes is not None:
                assert stage.attn_routes == attn_routes


def test_fused_patch_select_fp32_plan_refusal_raises(cuda):
    """A width whose fp32 rows gemm_tf32x3 cannot read in 16-byte chunks
    (D = 18: a row stride off 4 floats) is refused by the planned product
    and raises; nothing falls back to gemm_tile."""
    rng = np.random.default_rng(18)
    f32 = torch.float32
    ps = PatchSelecter(18, torch.Generator().manual_seed(0)).to(cuda, f32)
    patch = _rn(rng, 1, 2, 14, 18, dtype=f32)
    audio, video = _rn(rng, 1, 2, 18, dtype=f32), _rn(rng, 1, 2, 18, dtype=f32)
    with pytest.raises(RuntimeError, match="qt_patch_select"):
        PS.fused_patch_select(patch, audio, video, ps, 2)
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the fp32 tensor-core GEMM under every planned fp32 product (gemm_tf32x3:
# 3xTF32 on the Hopper kernel, TMA + wgmma)
# ---------------------------------------------------------------------------

# ragged extents, the AVQ rows (3,840) and the patch rows (26,880); M x K is
# kept to the largest backward operand
TF32X3_SHAPES = [(m, n, k) for m in (1, 127, 129, 3840, 26880) for n in (1, 127, 512)
                 for k in (1, 129, 3840, 26880) if m * k <= 26880 * 1536]


def _padded(rng, rows, cols, cuda):
    """A [rows, cols] fp32 view with unit column stride and a row stride of
    cols rounded up to a multiple of 4, plus 4 (a 16-byte aligned base)."""
    ld = -(-cols // 4) * 4 + 4
    buf = torch.from_numpy(rng.standard_normal((rows, ld), dtype=np.float32)).to(cuda)
    return buf[:, :cols]


@pytest.mark.parametrize("splits", [None, 1])
@pytest.mark.parametrize("a_col_major,b_nk", [(False, False), (True, False), (False, True),
                                              (True, True)])
@pytest.mark.parametrize("m,n,k", TF32X3_SHAPES)
def test_gemm_tf32x3(cuda, m, n, k, a_col_major, b_nk, splits):
    """gemm_tf32x3 against its plain version (the same split, three fp32
    products) and against the fp64 product, both within 1e-4 * max(1,
    max|ref|), in both A and both B layouts, with the backwards' split-K
    plan and with K whole."""
    rng = np.random.default_rng(m + 3 * n + 7 * k)
    a = _padded(rng, k, m, cuda) if a_col_major else _padded(rng, m, k, cuda)
    b = _padded(rng, n, k, cuda) if b_nk else _padded(rng, k, n, cuda)
    kw = dict(a_col_major=a_col_major, b_nk=b_nk)
    launches = GM.gemm_tf32x3.launches
    got = GM.gemm_tf32x3(a, b, splits=splits, **kw)
    want = GM.gemm_tf32x3_plain(a, b, **kw)
    ref = (a.double().t() if a_col_major else a.double()) @ (b.double().t() if b_nk
                                                              else b.double())
    torch.cuda.synchronize()
    assert GM.gemm_tf32x3.launches == launches + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    assert torch.isfinite(got).all()
    for target in (want.double(), ref):
        err = (got.double() - target).abs().max().item()
        assert err <= TOL[torch.float32] * max(1.0, target.abs().max().item()), err


@pytest.mark.parametrize("splits", [None, 1])
@pytest.mark.parametrize("m,n", [(512, 512), (1536, 512), (127, 129)])
def test_gemm_tf32x3_long_k_against_fp64(cuda, m, n, splits):
    """A weight gradient's K = 26,880 patch rows, with the recipe's split-K
    plan and as one chunk (840 slabs, each slab's products folded into the
    fp32 accumulator by IEEE adds): within 1e-4 * max(1, max|ref|) of the
    fp64 product, and of the plain version."""
    rng = np.random.default_rng(m + n)
    a, b = _padded(rng, 26880, m, cuda), _padded(rng, 26880, n, cuda)
    got = GM.gemm_tf32x3(a, b, a_col_major=True, splits=splits)
    ref = a.double().t() @ b.double()
    want = GM.gemm_tf32x3_plain(a, b, a_col_major=True)
    torch.cuda.synchronize()
    for target in (ref, want.double()):
        err = (got.double() - target).abs().max().item()
        assert err <= TOL[torch.float32] * max(1.0, target.abs().max().item()), err


@pytest.mark.parametrize("splits", [2, 3, 8, 50])
def test_gemm_tf32x3_forced_splits_are_deterministic(cuda, splits):
    """An explicit split-K: the same result as K whole to fp32 summation
    order, and bitwise the same from call to call (a fixed-order sum of the
    partials, no atomics)."""
    rng = np.random.default_rng(splits)
    a, b = _padded(rng, 26880, 512, cuda), _padded(rng, 26880, 512, cuda)
    one = GM.gemm_tf32x3(a, b, a_col_major=True, splits=1)
    first = GM.gemm_tf32x3(a, b, a_col_major=True, splits=splits)
    second = GM.gemm_tf32x3(a, b, a_col_major=True, splits=splits)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    err = (first - one).abs().max().item()
    assert err <= TOL[torch.float32] * max(1.0, one.abs().max().item()), err


def test_gemm_tf32x3_raises_on_misaligned_operands(cuda):
    """The routine reads 16-byte chunks: a base off 16 bytes or a row
    stride not a multiple of 4 floats is refused (cudaErrorInvalidValue),
    never rerouted; operands on two devices are refused before a launch."""
    buf = torch.randn(257 * 132, device=cuda)
    good = buf[:256 * 132].view(256, 132)[:, :128]
    off = buf[1:1 + 256 * 132].view(256, 132)[:, :128]  # base 4 bytes off
    odd = buf[:256 * 129].view(256, 129)[:, :128]       # row stride 129
    GM.gemm_tf32x3(good, good, b_nk=True)
    with pytest.raises(ValueError, match="on cpu"):
        GM.gemm_tf32x3(good, good.cpu(), b_nk=True)
    for a, b in ((off, good), (good, off), (odd, good), (good, odd)):
        n = GM.gemm_tf32x3.launches
        with pytest.raises(RuntimeError, match="qt_gemm_tf32x3"):
            GM.gemm_tf32x3(a, b, b_nk=True)
        assert GM.gemm_tf32x3.launches == n


@pytest.mark.parametrize("fault", ["short", "long", "wrong"])
@pytest.mark.parametrize("kind", ["avq", "patch_select"])
def test_train_backward_refuses_a_plan_it_does_not_launch(cuda, kind, fault, monkeypatch):
    """A backward checks each product against its plan (``gemm_plan``):
    a plan one product short, one product long, or with a wrong M is
    refused (cudaErrorInvalidValue) and the wrapper raises."""
    mod, acts, masks, cots, kernel, _, _ = _train_case(
        kind, torch.float32, cuda, np.random.default_rng(9))
    owner, name = (AV, "avq_train_bwd_gemm_shapes") if kind == "avq" else (
        PS, "patch_select_train_bwd_gemm_shapes")
    shapes = getattr(owner, name)

    def faulty(*args):
        got = shapes(*args)
        if fault == "short":
            return got[:-1]
        if fault == "long":
            return got + got[-1:]
        return [(got[0][0] + 4,) + tuple(got[0][1:])] + got[1:]

    monkeypatch.setattr(owner, name, faulty)
    outs = kernel(mod, acts, masks)
    with pytest.raises(RuntimeError, match="train_bwd"):
        torch.autograd.grad(outs, acts + list(mod.parameters()), cots)
        torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["avq", "patch_select"])
@pytest.mark.parametrize("ragged", [False, True])
def test_train_backward_routes(cuda, kind, dtype, ragged):
    """The routes one backward launch reports: all 14 or 20 products on
    tf32x3 in fp32, on gemm_tile's WMMA loop in bf16, at row counts that
    are multiples of 4 and at ones that are not; its three attention
    backwards on the keep-masked tensor-core kernel, as the launcher wrote
    them into its attention rows."""
    mod, acts, masks, cots, kernel, _, (_, bwd) = _train_case(
        kind, dtype, cuda, np.random.default_rng(7), RAGGED_DIMS[kind] if ragged else None)
    bwd.gemm_routes, bwd.attn_routes = {}, {}
    outs = kernel(mod, acts, masks)
    torch.autograd.grad(outs, acts + list(mod.parameters()), cots)
    torch.cuda.synchronize()
    count = 20 if kind == "avq" else 14
    assert bwd.gemm_routes == {"tf32x3" if dtype == torch.float32 else "wmma": count}
    assert bwd.attn_routes == {"mma_keep": 3}


@pytest.mark.parametrize("kind", ["avq", "patch_select"])
def test_recipe_train_products_on_the_hopper_tf32x3_kernel(cuda, kind):
    """One fp32 train step's launch of each train kernel at the recipe
    shape (B = 32): every product of the forward (10 or 7) and of the
    backward (20 or 14), as the launches wrote them into their plan rows,
    took route tf32x3, which only the Hopper kernel of gemm_tf32x3.cuh
    (TMA + wgmma) launches; the outputs agree with the plain version at
    1e-4 * max(1, max|p|) and the gradients are finite and bitwise the same
    from a second backward. (The gradients' values against the plain version
    are held at a seed without a ReLU unit on its kink by
    test_train_backward_bitwise_deterministic: a unit whose pre-activation
    lies within the products' rounding of 0 takes the other branch and
    moves an input gradient by a weight's size.)"""
    mod, acts, masks, cots, kernel, plain, (fwd, bwd) = _train_case(
        kind, torch.float32, cuda, np.random.default_rng(11), RECIPE_DIMS[kind])
    for fn in (fwd, bwd):
        fn.gemm_routes = {}
    ins = acts + list(mod.parameters())
    outs = kernel(mod, acts, masks)
    first = torch.autograd.grad(outs, ins, cots, retain_graph=True)
    second = torch.autograd.grad(outs, ins, cots)
    with torch.no_grad():
        want = plain(mod, acts, masks)
    torch.cuda.synchronize()
    assert fwd.gemm_routes == {"tf32x3": 10 if kind == "avq" else 7}
    assert bwd.gemm_routes == {"tf32x3": 40 if kind == "avq" else 28}
    outs, want = ([t] if torch.is_tensor(t) else list(t) for t in (outs, want))
    for g, w in zip(outs, want):
        err = (g - w).abs().max().item()
        assert err <= TOL[torch.float32] * max(1.0, w.abs().max().item()), err
    for i, (g1, g2) in enumerate(zip(first, second)):
        assert torch.isfinite(g1).all() and torch.equal(g1, g2), i


@pytest.mark.parametrize("dims", [RECIPE_DIMS, RAGGED_DIMS], ids=["recipe", "ragged"])
@pytest.mark.parametrize("kind", ["avq", "patch_select"])
def test_train_backward_bitwise_deterministic(cuda, kind, dims):
    """Two backward launches of each train kernel in fp32, at the recipe
    shape and at row counts that are not multiples of 4, give bitwise the
    same input and parameter gradients, and agree with the plain version at
    1e-4 * max(1, max|p|)."""
    mod, acts, masks, cots, kernel, plain, _ = _train_case(
        kind, torch.float32, cuda, np.random.default_rng(8), dims[kind])
    ins = acts + list(mod.parameters())
    outs = kernel(mod, acts, masks)
    first = torch.autograd.grad(outs, ins, cots, retain_graph=True)
    second = torch.autograd.grad(outs, ins, cots)
    want = torch.autograd.grad(plain(mod, acts, masks), ins, cots)
    torch.cuda.synchronize()
    for i, (g1, g2, w) in enumerate(zip(first, second, want)):
        assert torch.equal(g1, g2), i
        err = (g1.float() - w.float()).abs().max().item()
        assert err <= TOL[torch.float32] * max(1.0, w.float().abs().max().item()), (i, err)


# (kind, dims) of the train forwards' route checks: the PatchSelecter at
# B = 1, 3, 32 (60 frames of 14 patches), the AVQ block at N = 2, 6, 64
# rows of 60 frames and 77 words
FORWARD_DIMS = [("patch_select", (b, 60, 14)) for b in (1, 3, 32)] + [
    ("avq", (n, 60, 77)) for n in (2, 6, 64)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,dims", FORWARD_DIMS)
def test_train_forward_routes(cuda, kind, dims, dtype):
    """One train forward: its products (seven for the PatchSelecter, ten
    for the AVQ block) on tf32x3 in fp32 and on gemm_sm90 (wgmma) in bf16,
    its three attentions on the keep-masked tensor-core kernel (as the
    launcher wrote them into its attention rows); its outputs against the
    plain version on the same masks; a second launch bitwise the same."""
    mod, acts, masks, _, kernel, plain, (fwd, _) = _train_case(
        kind, dtype, cuda, np.random.default_rng(10), dims)
    fwd.gemm_routes, fwd.attn_routes = {}, {}
    with torch.no_grad():
        got, want = kernel(mod, acts, masks), plain(mod, acts, masks)
        routes, attn = dict(fwd.gemm_routes), dict(fwd.attn_routes)
        again = kernel(mod, acts, masks)
    torch.cuda.synchronize()
    count = 10 if kind == "avq" else 7
    assert routes == {"tf32x3" if dtype == torch.float32 else "wgmma": count}
    assert attn == {"mma_keep": 3}
    got, want, again = ([t] if torch.is_tensor(t) else list(t) for t in (got, want, again))
    for g, w, a in zip(got, want, again):
        assert torch.equal(g, a)
        err = (g.float() - w.float()).abs().max().item()
        assert err <= TOL[dtype] * max(1.0, w.float().abs().max().item()), err


@pytest.mark.parametrize("fault", ["short", "long", "wrong"])
@pytest.mark.parametrize("kind", ["avq", "patch_select"])
def test_train_forward_refuses_a_plan_it_does_not_launch(cuda, kind, fault, monkeypatch):
    """A train forward checks each product against its plan (``gemm_plan``
    of ``avq_train_fwd_gemm_shapes`` / ``patch_select_gemm_shapes``): a plan
    one product short, one long, or with a wrong M is refused and the
    wrapper raises."""
    mod, acts, masks, _, kernel, _, _ = _train_case(
        kind, torch.float32, cuda, np.random.default_rng(11))
    owner, name = (AV, "avq_train_fwd_gemm_shapes") if kind == "avq" else (
        PS, "patch_select_gemm_shapes")
    shapes = getattr(owner, name)

    def faulty(*args):
        got = shapes(*args)
        if fault == "short":
            return got[:-1]
        if fault == "long":
            return got + got[-1:]
        return [(got[0][0] + 4,) + tuple(got[0][1:])] + got[1:]

    monkeypatch.setattr(owner, name, faulty)
    with pytest.raises(RuntimeError, match="train_fwd"):
        kernel(mod, acts, masks)
        torch.cuda.synchronize()


@pytest.mark.parametrize("fault", ["short", "long", "wrong"])
@pytest.mark.parametrize("kind", ["avq", "patch_select"])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_train_refuses_attention_rows_it_does_not_launch(cuda, kind, fault, direction,
                                                         monkeypatch):
    """A train launch checks each keep-masked attention against its
    attention rows (``ops.attention.keep_rows``), forward and backward:
    rows one attention short, one long, or with a wrong Sq are refused and
    the wrapper raises."""
    mod, acts, masks, cots, kernel, _, _ = _train_case(
        kind, torch.float32, cuda, np.random.default_rng(12))
    owner = AV if kind == "avq" else PS
    rows = owner.keep_rows

    def faulty(shapes):
        got = rows(shapes)
        if fault == "short":
            return got[:-1]
        if fault == "long":
            return torch.cat([got, got[-1:]])
        got[0, 0] += 1
        return got

    if direction == "fwd":
        monkeypatch.setattr(owner, "keep_rows", faulty)
        with pytest.raises(RuntimeError, match="train_fwd"):
            kernel(mod, acts, masks)
            torch.cuda.synchronize()
        return
    outs = kernel(mod, acts, masks)
    monkeypatch.setattr(owner, "keep_rows", faulty)
    with pytest.raises(RuntimeError, match="train_bwd"):
        torch.autograd.grad(outs, acts + list(mod.parameters()), cots)
        torch.cuda.synchronize()


def test_train_then_test_entry_points(cuda, tmp_path, monkeypatch):
    """``train`` then ``test`` of tests/test_torch_cli.py on the card (no
    ``platform`` in the config): the parameters on the card, the features
    read by the native loader, ``best.npz`` and the result file written,
    the test entry's report equal to the train run's final test."""
    from qa_tiger_tpu_torch import test as t_test
    from qa_tiger_tpu_torch import train as t_train
    from qa_tiger_tpu_torch.data import native_loader
    from qa_tiger_tpu_torch.models import clip_text
    from torch_corpus import val_questions, write_config, write_corpus, write_merges

    monkeypatch.setitem(clip_text.CLIP_TEXT_CONFIGS, "tiny-gpu",
                        dict(width=64, heads=2, layers=2, embed_dim=64))
    write_merges(tmp_path / "vocab.txt.gz", [q["question_content"] for q in val_questions()])
    monkeypatch.setenv("QA_TIGER_BPE_VOCAB", str(tmp_path / "vocab.txt.gz"))
    write_corpus(tmp_path / "data", {"train": (0, 40), "val": (40, 56), "test": (56, 72)},
                 {"vggish": (12, 16), "clip": (12, 64), "tome": (12, 4, 24)})
    model = dict(d_model=64, video_dim=64, patch_dim=24, audio_dim=16, topK=2, num_experts=4,
                 encoder_type="tiny-gpu")
    cfg = write_config(tmp_path / "tiny.py", tmp_path / "data", tmp_path / "out", model)
    runners, real = [], t_train.build_runner

    def spy(cfg, device):
        runners.append(real(cfg, device))
        return runners[-1]

    monkeypatch.setattr(t_train, "build_runner", spy)
    monkeypatch.setattr(t_test, "build_runner", spy)
    native_loader.reset_counts()
    summary = t_train.main(["--config", str(cfg)])
    assert native_loader.native_available()
    assert native_loader.counts["native"] > 0 and native_loader.counts["numpy"] == 0
    run = Path(summary["run_dir"])
    assert (run / "best.npz").exists() and (run / "last_state" / "state.pt").exists()
    t_test.main(["--config", str(cfg), "--weight", str(run / "best.npz"),
                 "--output_path", str(tmp_path / "eval")])
    assert len(runners) == 2
    for r in runners:
        assert r.device.type == "cuda"
        assert all(p.device.type == "cuda" for p in r.model.parameters())

    def report(path):
        return [line.split("]:", 1)[1].strip() for line in path.read_text().splitlines()
                if "]:Test " in line and "accuracy:" in line]

    got = report(tmp_path / "eval" / "best_result.txt")
    assert len(got) == 13 and got == report(run / "log.txt")


def test_service_on_the_card(cuda, tmp_path, monkeypatch):
    """The serving ``Service`` on the card at a tiny config, bf16, batch 8:
    ``_dispatch`` on the device-cache path and on the host path, bitwise
    equal to each other and within the bf16 tolerance of the Predictor on
    the same rows assembled and padded the same way (same top-1), on a full
    and a padded batch; one dispatch of each path under
    ``torch.cuda.set_sync_debug_mode("error")`` (no hidden host sync);
    ``predict_many`` through the batcher."""
    from qa_tiger_tpu_torch import bench_serve
    from qa_tiger_tpu_torch.models import clip_text
    from torch_corpus import write_config

    monkeypatch.setitem(clip_text.CLIP_TEXT_CONFIGS, "tiny-gpu",
                        dict(width=64, heads=2, layers=2, embed_dim=64))
    model = dict(d_model=64, video_dim=64, patch_dim=24, audio_dim=16, topK=2, num_experts=4,
                 encoder_type="tiny-gpu")
    base = write_config(tmp_path / "tiny.py", tmp_path / "data", tmp_path / "out", model)
    config, vocab = bench_serve.build_corpus(tmp_path / "serve", base, frames=12, patches=4,
                                             n_videos=3)
    svc = bench_serve.start_service(config, vocab, batch=8, dtype="bfloat16", device_cache=3,
                                    timeout=600)
    try:
        assert svc.device.type == "cuda"
        items = bench_serve.requests(8, n_videos=3)
        cached = [svc._make_row(it["question"], it["video"]) for it in items]
        assert all(r["slot"] is not None for r in cached)
        host = [dict(r, slot=None, feats=svc.store.get(r["video"])) for r in cached]
        for n in (8, 5):
            got_c, got_h = svc._step(cached[:n]), svc._step(host[:n])
            assert np.array_equal(got_c, got_h), n
            pad = svc.batch_size - n
            feats = [r["feats"] for r in host[:n]] + [host[0]["feats"]] * pad
            batch = {k: np.stack([f[k] for f in feats]) for k in feats[0]}
            batch["quest"] = np.stack([r["tokens"] for r in host[:n]] + [host[0]["tokens"]] * pad)
            want = torch.softmax(svc.predictor.logits(batch).float(), -1).cpu().numpy()[:n]
            assert np.abs(got_h - want).max() <= TOL[torch.bfloat16]
            assert (got_h.argmax(1) == want.argmax(1)).all()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            handles = [svc._dispatch(cached[:5]), svc._dispatch(host)]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for handle in handles:
            assert np.isfinite(np.asarray(handle)).all()
        out = svc.predict_many(items, topk=2)
        assert len(out) == 8 and all(len(r["topk"]) == 2 for r in out)
    finally:
        svc.shutdown()


RECIPE_MODEL = dict(d_model=512, video_dim=768, patch_dim=1024, audio_dim=128, topK=7,
                    num_experts=7, num_labels=42, encoder_type="ViT-L/14@336px")


def _recipe_batch(rng, b, t=60, p=14):
    quest = rng.integers(1, 49406, (b, 77)).astype(np.int64)
    quest[:, 20] = 49407  # the EOT, where the tower pools
    return {"quest": quest,
            "audio": rng.standard_normal((b, t, 128), dtype=np.float32),
            "video": rng.standard_normal((b, t, 768), dtype=np.float32),
            "patch": rng.standard_normal((b, t, p, 1024), dtype=np.float32),
            "label": rng.integers(0, 42, b), "qtype_label": rng.integers(0, 9, b),
            "valid": np.ones(b, bool)}


@pytest.mark.parametrize("train_dtype", [None, "bfloat16"])
def test_train_graph_matches_eager(cuda, train_dtype):
    """``steps_per_dispatch`` 2 at the recipe's widths, B=4, dropout on: 5
    batches through the train step's CUDA graph (a warm-up, a capture, four
    replays) and through the same static-input step run eagerly: every
    loss, parameter, Adam moment and step count and the dropout stream
    bitwise equal, and a replay counts the eager step's launches."""
    from qa_tiger_tpu_torch import ops
    from qa_tiger_tpu_torch.models import qa_tiger_config
    from qa_tiger_tpu_torch.training import AVQARunner

    hp = {"optim": dict(lr=1e-4, betas=(0.95, 0.999), weight_decay=0.0, encoder_lr=None),
          "steps_per_dispatch": 2}
    if train_dtype:
        hp["train_dtype"] = train_dtype
    cfg = {"log_interval": 1, "debug": False, "hyper_params": hp}
    graph, eager = (AVQARunner(cfg, qa_tiger_config(**RECIPE_MODEL), device=cuda, seed=0)
                    for _ in range(2))
    eager.graph_capture = False
    rng = np.random.default_rng(0)
    batches = [graph.stage_batch(_recipe_batch(rng, 4)) for _ in range(5)]
    losses, counts = [], []
    for r in (graph, eager):
        out = []
        for i in range(0, 4, 2):
            out += r.train_window(batches[i:i + 2], 1e-4)
        torch.cuda.synchronize()
        ops.reset_launches()
        out += r.train_window(batches[4:], 1e-4)
        torch.cuda.synchronize()
        counts.append((ops.launch_counts(), dict(ops.fused_avq_train_bwd.gemm_routes)))
        losses.append(out)
    assert graph._step_graph.replays == 4 and graph._step_graph.graph is not None
    assert counts[0] == counts[1] and counts[0][0]["fused_avq_train"] == 1
    for a, b in zip(*losses):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(graph._step_generator.get_state(), eager._step_generator.get_state())
    for (name, pa), (_, pb) in zip(graph.trainable(), eager.trainable()):
        assert torch.equal(pa, pb), name
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(graph.optimizer.state[pa][key],
                               eager.optimizer.state[pb][key]), (name, key)


@pytest.mark.parametrize("accum", [1, 2])
def test_nccl_step_graph_is_the_single_process(cuda, tmp_path, accum):
    """Data parallelism at world 1 over NCCL, ``steps_per_dispatch`` 2 at the
    recipe's widths, B=4, dropout on: the step's CUDA graph holds the count
    and gradient all-reduces, and 5 batches through it (a warm-up, a
    capture, four replays) are bitwise those of a runner without a process
    group stepping the same batches eagerly: losses, parameters, the
    dropout stream."""
    import torch.distributed as dist

    from qa_tiger_tpu_torch import parallel
    from qa_tiger_tpu_torch.models import qa_tiger_config
    from qa_tiger_tpu_torch.training import AVQARunner

    hp = {"optim": dict(lr=1e-4, betas=(0.95, 0.999), weight_decay=0.0, encoder_lr=None,
                        grad_accum=accum), "steps_per_dispatch": 2}
    cfg = {"log_interval": 1, "debug": False, "hyper_params": hp}
    graph, eager = (AVQARunner(cfg, qa_tiger_config(**RECIPE_MODEL), device=cuda, seed=0)
                    for _ in range(2))
    eager.graph_capture = False
    rng = np.random.default_rng(1)
    batches = [graph.stage_batch(_recipe_batch(rng, 4)) for _ in range(5)]

    def run(runner):
        return sum((runner.train_window(batches[i:i + 2], 1e-4) for i in (0, 2, 4)), [])

    e_losses = run(eager)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        assert parallel.backend() == "nccl"
        g_losses = run(graph)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert graph._step_graph.replays == 4 and graph._step_graph.graph is not None
    for a, b in zip(g_losses, e_losses):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(graph._step_generator.get_state(), eager._step_generator.get_state())
    for (name, pa), (_, pb) in zip(graph.trainable(), eager.trainable()):
        assert torch.equal(pa, pb), name


# ---------------------------------------------------------------------------
# head sizes 256 and 512 (TSPM's one-head attentions): in bf16 without a keep
# mask the wide tensor-core kernels (a warp per problem at most 16 queries
# and keys, 64 query rows per block otherwise); in fp32 the staged kernel
# where K_h and V_h fit the block's shared memory, the wide-head kernel
# otherwise; the plan in Python is the library's
# ---------------------------------------------------------------------------

WIDE_HEAD_CASES = [(60, 60, 512, 1), (14, 14, 512, 1), (60, 54, 512, 1), (60, 55, 512, 1),
                   (33, 100, 512, 2), (1, 60, 512, 1), (70, 577, 256, 2), (17, 129, 256, 3),
                   (70, 300, 200, 2)]


def _wide_want(dtype, sq, sk):
    """(route, kernel) of a wide-head call without a mask or key bias: the
    tensor-core kernels in bf16, the lane split's 3xTF32 stages in fp32."""
    if dtype == torch.bfloat16:
        return ("mma_short", "mma_wide_short") if sq <= 16 and sk <= 16 else ("mma", "mma_wide")
    return ("tf32x3", "lane_split")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sq,sk,hd,heads", WIDE_HEAD_CASES)
@pytest.mark.parametrize("bias,masked", [(False, False), (True, False), (False, True),
                                         (True, True)])
def test_attention_wide_heads(cuda, sq, sk, hd, heads, bias, masked, dtype):
    """q, k and v column slices of one packed buffer, with a key bias and a
    causal mask or neither; the route and kernel of the plan without them
    (the tensor-core kernels in bf16, the lane split in fp32); the
    library's plan (kernel, shared memory) is attention_plan's at the card's
    limit; a second launch bitwise the same."""
    rng = np.random.default_rng(sq * 1000 + sk + hd)
    q, k, v = _packed_qkv(rng, 3, sq, sk, hd * heads, dtype, cuda)
    kb = (torch.from_numpy(np.log(rng.integers(1, 41, (3, sk))).astype(np.float32)).to(cuda)
          if bias else None)
    mask = _causal(sq, sk, cuda) if masked else None
    plan = A.attention_plan(dtype, sq, sk, hd, limit=A.smem_limit(cuda))
    assert plan.smem_bytes <= A.smem_limit(cuda)
    assert A.library_plan(dtype, sq, sk, plan.head) == (plan.kernel, plan.smem_bytes)
    route, kernel = _wide_want(dtype, sq, sk)
    assert A.attention_route(dtype, sq, sk, hd) == plan.route == route
    assert plan.kernel == kernel if kernel else plan.kernel in ("staged", "wide")
    scale = hd ** -0.5
    n = A.attention_wide.launches
    _check(lambda: A.attention_wide(q, k, v, mask, scale, heads, key_bias=kb),
           lambda: A._wide_reference(q, k, v, mask, scale, heads, kb), dtype)
    assert A.attention_wide.launches == n + 1
    assert torch.equal(A.attention_wide(q, k, v, mask, scale, heads, key_bias=kb),
                       A.attention_wide(q, k, v, mask, scale, heads, key_bias=kb))


@pytest.mark.parametrize("hd", [256, 512])
@pytest.mark.parametrize("sk", [16, 17, 64, 65, 128, 129, 577])
@pytest.mark.parametrize("sq", [1, 14, 16, 17, 60, 64, 65])
@pytest.mark.parametrize("extras", [False, True])
def test_attention_wide_tc_edges(cuda, sq, sk, hd, extras):
    """The wide tensor-core kernels in bf16 at their edges: query counts
    around the 16-row tile and the 64-row block, key counts around the
    short kernel's 16, the 64-key tiles and the mma kernel's one-pass limit
    (128), and 577; 2 heads as column slices of a packed buffer, with a
    causal mask and a key bias or neither; against the plain version, the
    library's plan equal to attention_plan's, and a second launch bitwise
    the same."""
    dt, B, H = torch.bfloat16, 3, 2
    rng = np.random.default_rng(sq * 10000 + sk * 10 + hd + extras)
    q, k, v = _packed_qkv(rng, B, sq, sk, hd * H, dt, cuda)
    kb = mask = None
    if extras:
        kb = torch.from_numpy(np.log(rng.integers(1, 41, (B, sk))).astype(np.float32)).to(cuda)
        mask = _causal(sq, sk, cuda)
    plan = A.attention_plan(dt, sq, sk, hd, limit=A.smem_limit(cuda))
    assert (plan.route, plan.kernel) == _wide_want(dt, sq, sk) and plan.head == hd
    assert A.library_plan(dt, sq, sk, hd) == (plan.kernel, plan.smem_bytes)
    scale = hd ** -0.5
    n = A.attention_wide.launches
    first = A.attention_wide(q, k, v, mask, scale, H, key_bias=kb)
    _check(lambda: first, lambda: A._wide_reference(q, k, v, mask, scale, H, kb), dt)
    assert torch.equal(first, A.attention_wide(q, k, v, mask, scale, H, key_bias=kb))
    assert A.attention_wide.launches == n + 2


@pytest.mark.parametrize("sq,sk", [(14, 14), (60, 60)])
def test_attention_wide_tc_copies_misaligned_rows(cuda, sq, sk):
    """A row stride that is not a multiple of 8 elements, or a base off 16
    bytes, at 512 lanes: the wrapper copies the operand and launches the
    same wide tensor-core kernel, which gives the plain result, the same as
    on aligned copies of the operands."""
    rng = np.random.default_rng(sq + sk)
    dt = torch.bfloat16
    q, k, v = _packed_qkv(rng, 3, sq, sk, 512, dt, cuda, pad=4)
    assert q.stride(1) % 8 == 4
    buf = _rn(rng, 3, max(sq, sk), 3 * 512 + 8, dtype=dt)
    q2, k2, v2 = buf[:, :sq, 4:516], buf[:, :sk, 516:1028], buf[:, :sk, 1028:1540]
    assert q2.data_ptr() % 16 == 8
    assert A.attention_plan(dt, sq, sk, 512).kernel == _wide_want(dt, sq, sk)[1]
    n = A.attention_wide.launches
    for a, b_, c in ((q, k, v), (q2, k2, v2)):
        got = A.attention_wide(a, b_, c, None, 512 ** -0.5, 1)
        _check(lambda: got, lambda: A._wide_reference(a, b_, c, None, 512 ** -0.5, 1), dt)
        aligned = A.attention_wide(*(t.contiguous() for t in (a, b_, c)), None, 512 ** -0.5, 1)
        assert torch.equal(got, aligned)
    assert A.attention_wide.launches == n + 4


def test_attention_wide_head_plans(cuda):
    """TSPM's calls take the kernels the CPU tests plan for them."""
    limit = A.smem_limit(cuda)
    assert limit >= 232_448
    f32, bf = torch.float32, torch.bfloat16
    assert A.attention_plan(f32, 60, 60, 512, limit=limit).kernel == "lane_split"
    assert A.attention_plan(f32, 14, 14, 512, limit=limit).kernel == "lane_split"
    assert A.attention_plan(f32, 577, 577, 256, limit=limit).kernel == "lane_split"
    assert A.attention_plan(bf, 60, 60, 512, limit=limit).kernel == "mma_wide"
    assert A.attention_plan(bf, 14, 14, 512, limit=limit).kernel == "mma_wide_short"
    assert A.attention_plan(bf, 577, 577, 256, limit=limit).kernel == "mma_wide"
    for args in ((60, 60, 512), (14, 14, 512), (577, 577, 256), (60, 2000, 512)):
        plan = A.attention_plan(bf, *args, limit=limit)
        assert A.library_plan(bf, *args) == (plan.kernel, plan.smem_bytes)
    with pytest.raises(ValueError, match="head size 1024"):
        A.attention_wide(*(torch.zeros(1, 60, 1024, device=cuda) for _ in range(3)), None,
                         1.0, 1)


def _tspm_batch(rng, b, T=60, N=14):
    return {"audio": rng.standard_normal((b, T, 128), dtype=np.float32),
            "video": rng.standard_normal((b, T, 768), dtype=np.float32),
            "patch": rng.standard_normal((b, T, N, 1024), dtype=np.float32),
            "quest": rng.standard_normal((b, 1, 768), dtype=np.float32),
            "prompt": rng.standard_normal((b, 768), dtype=np.float32)}


def test_tspm_forward_card_against_cpu(cuda):
    """configs/tspm/vitl14.py's widths, fp32 B=2: the card's logits within
    rtol 2e-3 / atol 5e-4 of the same weights on the CPU, the same top-K
    frames, six attention_wide launches per forward; bf16 B=4 finite."""
    from qa_tiger_tpu_torch.models import TSPM, tspm_config

    cpu = TSPM(tspm_config(), seed=0).eval()
    card = TSPM(tspm_config(), seed=0).eval().to(cuda)
    batch = _tspm_batch(np.random.default_rng(0), 2)
    with torch.no_grad():
        want = cpu({k: torch.from_numpy(v) for k, v in batch.items()}, aux=True)
        n = A.attention_wide.launches
        got = card({k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}, aux=True)
        torch.cuda.synchronize()
        assert A.attention_wide.launches == n + 6
    torch.testing.assert_close(got["out"].cpu(), want["out"], rtol=2e-3, atol=5e-4)
    assert torch.equal(got["topk_idx"].cpu(), want["topk_idx"])
    card = card.to(torch.bfloat16)
    with torch.no_grad():
        out = card({k: torch.from_numpy(v).to(cuda, torch.bfloat16)
                    for k, v in _tspm_batch(np.random.default_rng(1), 4).items()})["out"]
    assert out.shape == (4, 42) and torch.isfinite(out).all()


def test_tspm_train_graph_matches_eager(cuda):
    """``steps_per_dispatch`` 2 with TSPM at its widths, B=4, dropout on:
    the step's CUDA graph (its four dropout sites registered) bitwise the
    same static-input step run eagerly over 5 batches."""
    from qa_tiger_tpu_torch.models import tspm_config
    from qa_tiger_tpu_torch.training import AVQARunner

    hp = {"optim": dict(lr=1e-4, betas=(0.95, 0.999), weight_decay=0.0, encoder_lr=None),
          "steps_per_dispatch": 2}
    cfg = {"log_interval": 1, "debug": False, "hyper_params": hp}
    graph, eager = (AVQARunner(cfg, tspm_config(), device=cuda, seed=0) for _ in range(2))
    eager.graph_capture = False
    rng = np.random.default_rng(0)

    def batch():
        b = _tspm_batch(rng, 4)
        b.update(label=rng.integers(0, 42, 4), qtype_label=rng.integers(0, 9, 4),
                 valid=np.ones(4, bool))
        return graph.stage_batch(b)

    batches = [batch() for _ in range(5)]
    losses = []
    for r in (graph, eager):
        out = []
        for i in range(0, 5, 2):
            out += r.train_window(batches[i:i + 2], 1e-4)
        losses.append(out)
    torch.cuda.synchronize()
    assert graph._step_graph.replays == 4 and graph._step_graph.graph is not None
    for a, b in zip(*losses):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(graph._step_generator.get_state(), eager._step_generator.get_state())
    for (name, pa), (_, pb) in zip(graph.trainable(), eager.trainable()):
        assert torch.equal(pa, pb), name
        for key in ("exp_avg", "exp_avg_sq", "step"):
            if key in graph.optimizer.state[pa]:
                assert torch.equal(graph.optimizer.state[pa][key],
                                   eager.optimizer.state[pb][key]), (name, key)


# attention_wide's two stages for one head split by lanes: (batch, Sq, Sk) of
# AV_Attn and TokensAttn at B=256, and a masked call over two key tiles
TP_LANE_CASES = [(512, 60, 60, False), (2560, 14, 14, False), (3, 70, 130, True)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("b,sq,sk,masked", TP_LANE_CASES)
def test_attention_wide_tp_stages(cuda, b, sq, sk, masked, tp, dtype):
    """Each rank's stages against their plain versions (q, k and v the
    rank's lanes of one packed [q; k; v], as the model projects them), the
    partial scores summed in rank order, and the ranks' context lanes
    against the single-rank kernel on the whole 512-lane head."""
    rng = np.random.default_rng(sq)
    W, wl = 512, 512 // tp
    if sq == sk:
        buf = _rn(rng, b, sq, 3 * W, dtype=dtype)
        q, k, v = buf[..., :W], buf[..., W:2 * W], buf[..., 2 * W:]
    else:
        q, k, v = (_rn(rng, b, s, W, dtype=dtype) for s in (sq, sk, sk))
    mask = torch.triu(torch.full((sq, sk), float("-inf"), device=cuda), 1) if masked else None
    scale = W ** -0.5
    lanes = [slice(r * wl, (r + 1) * wl) for r in range(tp)]
    n, ns = A.attention_wide.launches, A.attention_wide_tp_scores.launches
    parts = []
    for c in lanes:
        _check(lambda c=c: A.attention_wide_tp_scores(q[..., c], k[..., c]),
               lambda c=c: A.tp_partial_scores(q[..., c], k[..., c]), torch.float32)
        parts.append(A.attention_wide_tp_scores(q[..., c], k[..., c]))
    assert A.attention_wide.launches - n == A.attention_wide_tp_scores.launches - ns == 2 * tp
    scores = parts[0].clone()
    for part in parts[1:]:
        scores += part
    npv = A.attention_wide_tp_pv.launches
    for c in lanes:
        _check(lambda c=c: A.attention_wide_tp_pv(scores, v[..., c], mask, scale),
               lambda c=c: A._tp_pv_plain(scores, v[..., c], mask=mask, scale=scale), dtype)
    got = torch.cat([A.attention_wide_tp_pv(scores, v[..., c], mask, scale) for c in lanes], -1)
    assert A.attention_wide_tp_pv.launches - npv == 2 * tp
    _check(lambda: got, lambda: A.attention_wide(q, k, v, mask, scale, 1), dtype)


# the lane split's kernels at odd lengths: every (Sq, Sk) of these, at 64,
# 128 and 256 lanes a rank, masked on every other pair
TP_ODD_LENGTHS = (1, 15, 17, 60, 77, 129)
TP_ODD_CASES = [(sq, sk, (i + j) % 2 == 1) for i, sq in enumerate(TP_ODD_LENGTHS)
                for j, sk in enumerate(TP_ODD_LENGTHS)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w", [64, 128, 256])
@pytest.mark.parametrize("sq,sk,masked", TP_ODD_CASES)
def test_attention_wide_tp_stages_odd_lengths(cuda, sq, sk, masked, w, dtype):
    """Both stages against their plain versions at ragged query and key
    counts (one 16-row tile; one 64-key tile, whose p the pv kernel holds in
    registers, and several, where it forms p per tile), each launch counted
    once; in fp32 the scores also against an fp64 product: within 2^-18 of
    sum_l |q_l k_l| per element (3xTF32 keeps about fp32's accuracy, where
    one TF32 pass would be off by up to 2^-11)."""
    rng = np.random.default_rng(1000 * sq + sk)
    q, k, v = (_rn(rng, 3, s, w, dtype=dtype) for s in (sq, sk, sk))
    mask = (torch.triu(torch.full((sq, sk), -1e9, device=cuda), sk // 2 + 1)
            if masked else None)
    ns, npv = A.attention_wide_tp_scores.launches, A.attention_wide_tp_pv.launches
    _check(lambda: A.attention_wide_tp_scores(q, k), lambda: A.tp_partial_scores(q, k),
           torch.float32)
    s = A.attention_wide_tp_scores(q, k)
    assert A.attention_wide_tp_scores.launches - ns == 2
    if dtype == torch.float32:
        want = torch.einsum("bqd,bkd->bqk", q.double(), k.double())
        size = torch.einsum("bqd,bkd->bqk", q.double().abs(), k.double().abs())
        assert bool(((s.double() - want).abs() <= 2.0 ** -18 * size).all())
    _check(lambda: A.attention_wide_tp_pv(s, v, mask, w ** -0.5),
           lambda: A._tp_pv_plain(s, v, mask=mask, scale=w ** -0.5), dtype)
    assert A.attention_wide_tp_pv.launches - npv == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_wide_tp_stages_copy_misaligned_operands(cuda, dtype):
    """Operands the kernels' 16-byte copies cannot read as they are: lanes
    of a packed buffer at an odd offset (the wrapper copies them), and a
    width off whole slabs (zero-padded lanes, dropped from the context)."""
    rng = np.random.default_rng(7)
    for w, off in ((72, 1), (40, 0), (256, 3)):
        buf = _rn(rng, 5, 60, 3 * w + off, dtype=dtype)
        q, k, v = (buf[..., off + i * w:off + (i + 1) * w] for i in range(3))
        _check(lambda: A.attention_wide_tp_scores(q, k), lambda: A.tp_partial_scores(q, k),
               torch.float32)
        s = A.attention_wide_tp_scores(q, k)
        got = A.attention_wide_tp_pv(s, v, None, 0.1)
        assert got.shape == v.shape
        _check(lambda: got, lambda: A._tp_pv_plain(s, v, mask=None, scale=0.1), dtype)
