"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA device every test here skips. On the card
(no JAX there, so without the repository's conftest):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

Tolerances: fp32 max|k - p| <= 1e-4 * max(1, max|p|) (summation order);
bf16 3e-2 * max(1, max|p|) (bf16 rounding of outputs and intermediates).
"""
import numpy as np
import pytest
import torch

from qa_tiger_tpu_torch.models.clip_text import ResidualAttentionBlock, causal_mask
from qa_tiger_tpu_torch.models.modules import PatchSelecter
from qa_tiger_tpu_torch.ops import attention as A
from qa_tiger_tpu_torch.ops import gaussian_moe as G
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
def test_fused_gaussian_moe(cuda, dtype):
    rng = np.random.default_rng(1)
    E, D, H, B, T = 7, 512, 256, 5, 60
    x = _rn(rng, B, T, D, dtype=dtype)
    w1t, b1 = _rn(rng, E, D, H, dtype=dtype, scale=0.05), _rn(rng, E, H, dtype=dtype, scale=0.1)
    w2t, b2 = _rn(rng, E, H, D, dtype=dtype, scale=0.05), _rn(rng, E, D, dtype=dtype, scale=0.1)
    w = torch.from_numpy(0.05 * rng.random((B, E, T), dtype=np.float32)).to(cuda, dtype)
    _check(lambda: G.fused_gaussian_moe(x, w1t, b1, w2t, b2, w),
           lambda: G._reference_impl(x, w1t, b1, w2t, b2, w), dtype)


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


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(2, 5, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        A.attention_wide(x, x, x, None, 1.0, 4)
    y = torch.zeros(2, 5, 64, device=cuda)
    with pytest.raises(ValueError, match="mask"):
        A.attention_wide(y, y, y, torch.zeros(3, 3, device=cuda), 1.0, 4)
