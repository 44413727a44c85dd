"""What the attention wrappers hand the CUDA kernels, checked on the CPU.

On the card ``attention_wide`` and ``fused_attention`` zero-pad a head no
kernel takes at its own size to the next size one takes and copy a
bf16 operand that the tensor-core kernel cannot read with 16-byte copies.
Both are plain PyTorch, so they are checked here: the padded operands give
the same attention (to fp32 rounding: the sums gain zero terms only), the
copies are exact and aligned, and the padded sizes are the built ones.
"""
import numpy as np
import pytest
import torch

from qa_tiger_tpu_torch.ops import attention as A
from qa_tiger_tpu_torch.ops import gemm as GM


@pytest.mark.parametrize("hd,sk,want", [(48, 129, 64), (80, 577, 128), (32, 300, 32),
                                        (64, 129, 64), (128, 577, 128), (48, 128, 48),
                                        (80, 77, 80), (12, 200, 32)])
def test_kernel_head_sizes(hd, sk, want):
    assert A._kernel_head(hd, sk) == want


def test_kernel_head_refuses_heads_over_128_with_long_keys():
    """Over 128 keys a head past 128 lanes runs on the wide-head kernel,
    zero-padded to 256 or 512; past 512 no kernel takes it, and the error
    names the shape."""
    assert A._kernel_head(160, 129) == 256 and A._kernel_head(512, 577) == 512
    with pytest.raises(ValueError, match="Sk=129, head size 640"):
        A._kernel_head(640, 129)


@pytest.mark.parametrize("key_bias", [False, True])
@pytest.mark.parametrize("hd,sk", [(48, 129), (80, 577)])
def test_padded_heads_compute_the_same_attention(hd, sk, key_bias):
    """_wide_reference on the padded operands, its padded context columns
    dropped as the wrapper drops them, equals it on the originals."""
    rng = np.random.default_rng(hd + sk)
    H, B, sq = 3, 2, 40
    buf = torch.from_numpy(rng.standard_normal((B, sk, 3 * H * hd), dtype=np.float32))
    q, k, v = buf[:, :sq, :H * hd], buf[:, :, H * hd:2 * H * hd], buf[:, :, 2 * H * hd:]
    kb = torch.from_numpy(np.log(rng.integers(1, 41, (B, sk))).astype(np.float32)) \
        if key_bias else None
    hdp = A._kernel_head(hd, sk)
    qp, kp, vp = (A._kernel_operand(t, H, hd, hdp) for t in (q, k, v))
    assert qp.shape == (B, sq, H * hdp) and qp.is_contiguous()
    assert torch.equal(qp.reshape(B, sq, H, hdp)[..., hd:], torch.zeros(B, sq, H, hdp - hd))
    got = A._wide_reference(qp, kp, vp, None, hd ** -0.5, H, kb)
    got = got.reshape(B, sq, H, hdp)[..., :hd].reshape(B, sq, H * hd)
    want = A._wide_reference(q, k, v, None, hd ** -0.5, H, kb)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_misaligned_bf16_operands_are_copied_exactly():
    """A row stride off a multiple of 8 elements and a base 8 bytes past a
    16-byte boundary give a contiguous copy; an aligned view and any fp32
    operand pass through as they are."""
    odd_rows = torch.randn(2, 64, 3 * 128 + 4).to(torch.bfloat16)[..., :128]
    off_base = torch.randn(2, 64, 3 * 128 + 8).to(torch.bfloat16)[..., 4:132]
    assert odd_rows.stride(1) % 8 == 4 and off_base.data_ptr() % 16 == 8
    for view in (odd_rows, off_base):
        got = A._kernel_operand(view, 2, 64, 64)
        assert got is not view and got.is_contiguous() and torch.equal(got, view)
    aligned = torch.randn(2, 64, 384).to(torch.bfloat16)[..., 128:256]
    assert A._kernel_operand(aligned, 2, 64, 64) is aligned
    f32 = torch.randn(2, 64, 3 * 128 + 4)[..., :128]
    assert A._kernel_operand(f32, 2, 64, 64) is f32


def test_tma_operands_are_aligned_copies():
    w = torch.randn(4 * 512 + 4).to(torch.bfloat16)
    off = w[4:].view(4, 512)
    assert off.data_ptr() % 16 == 8
    got = GM.tma_ready(off)
    assert got is not off and torch.equal(got, off)
    on = w[:2048].view(4, 512)
    assert on.data_ptr() % 16 == 0 and GM.tma_ready(on) is on


@pytest.mark.parametrize("epilogue", ["bias", "residual", "f32"])
def test_gemm_plain_is_the_epilogue_arithmetic(epilogue):
    """The plain version of gemm_sm90 on the CPU: the fp32 product, then
    the epilogue functor's arithmetic (bias, ReLU or the rounded residual)."""
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(torch.bfloat16)
            for s in ((5, 16), (8, 16)))
    bias = torch.from_numpy(rng.standard_normal(8, dtype=np.float32)).to(torch.bfloat16)
    res = torch.from_numpy(rng.standard_normal((5, 8), dtype=np.float32)).to(torch.bfloat16)
    got = GM.gemm_sm90(a, b, epilogue=epilogue, bias=bias, res=res, relu=True)
    acc = a.double() @ b.double().t() + bias.double()
    want = {"bias": acc.relu().to(torch.bfloat16),
            "residual": (res.double() + acc.to(torch.bfloat16).double()).to(torch.bfloat16),
            "f32": acc.float()}[epilogue]
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=1e-2, atol=1e-2)


def test_gemm_shape_helpers_name_every_product():
    """The products the fused kernels launch, as chip_smoke.py and the
    route tally count them: two per attention half, two per MLP half, seven
    per PatchSelecter, ten per AVQ train forward (chip_smoke.py's flop
    count: twelve D x D products over the rows, k|v over the words)."""
    assert GM.attn_gemm_shapes(19712, 768) == [(19712, 2304, 768), (19712, 768, 768)]
    assert GM.mlp_gemm_shapes(19712, 768) == [(19712, 3072, 768), (19712, 768, 3072)]
    shapes = GM.patch_select_gemm_shapes(15360, 14, 512)
    assert len(shapes) == 7
    assert sum(2 * m * n * k for m, n, k in shapes) == \
        2 * 15360 * 14 * 512 * 512 * 6 + 2 * 30720 * 512 * 512 * 3
    shapes = GM.avq_train_fwd_gemm_shapes(64, 60, 77, 512)
    assert len(shapes) == 10
    assert sum(2 * m * n * k for m, n, k in shapes) == \
        2 * 3840 * 512 * 512 * 12 + 4 * 4928 * 512 * 512
