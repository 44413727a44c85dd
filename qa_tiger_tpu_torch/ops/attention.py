"""Multi-head attention on dense heads-in-lanes [B, S, W] tensors.

Port of ``qa_tiger_tpu/ops/pallas/attention.py:attention_wide``: the CUDA
kernel in ``csrc/attention.cu`` for CUDA tensors, the plain version
``_wide_reference`` for CPU tensors. On CUDA its gradient is that of the plain
version, recomputed (``ops/_grad.py``), the JAX ``custom_vjp`` rule.
"""
from __future__ import annotations

import torch

from qa_tiger_tpu_torch.ops import _build, _grad


def _wide_reference(q, k, v, mask, scale, heads):
    """Plain version: fp32 scores, fp32 softmax, probabilities cast to v's
    dtype, context in q's dtype."""
    B, Sq, W = q.shape
    Sk = k.shape[1]
    hd = W // heads
    q4 = q.reshape(B, Sq, heads, hd).float()
    k4 = k.reshape(B, Sk, heads, hd).float()
    v4 = v.reshape(B, Sk, heads, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q4, k4) * scale
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v4.float())
    return ctx.to(q.dtype).reshape(B, Sq, W)


def _check_rows(name: str, t: torch.Tensor, B: int, W: int) -> None:
    if t.dim() != 3 or t.shape[0] != B or t.shape[2] != W:
        raise ValueError(f"{name} must be [B={B}, S, W={W}], got {tuple(t.shape)}")
    if t.stride(2) != 1:
        raise ValueError(f"{name} needs unit stride along its last dim")


def attention_wide(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor | None, scale: float, heads: int,
                   key_bias: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q_h k_h^T * scale + mask) v_h for every head h, concatenated
    back along lanes -> [B, Sq, W].

    q [B, Sq, W], k/v [B, Sk, W]; each may be a column slice of a packed
    projection (rows strided, last dim contiguous). ``mask`` is an additive
    [Sq, Sk] mask or None.
    """
    if key_bias is not None:
        raise NotImplementedError(
            "attention_wide(key_bias=) is ToMe's proportional attention; it "
            "comes with the offline-pipeline slice (ROADMAP.md)")
    if q.device.type == "cpu":
        return _wide_reference(q, k, v, mask, scale, heads)
    if q.device.type != "cuda":
        raise ValueError(f"attention_wide runs on cpu or cuda, not {q.device}")
    B, Sq, W = q.shape
    Sk = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_rows(name, t, B, W)
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's dtype and device")
    if v.shape[1] != Sk:
        raise ValueError("k and v need the same length")
    if W % heads:
        raise ValueError(f"width {W} does not split into {heads} heads")
    if mask is not None:
        if tuple(mask.shape) != (Sq, Sk):
            raise ValueError(f"mask must be [{Sq}, {Sk}], got {tuple(mask.shape)}")
        mask = mask.to(device=q.device, dtype=torch.float32).contiguous()
    return _grad.KernelWithPlainGrad.apply(
        _launch, _wide_reference, dict(mask=mask, scale=scale, heads=heads), q, k, v)


def _launch(q, k, v, *, mask, scale, heads):
    B, Sq, W = q.shape
    out = torch.empty(B, Sq, W, dtype=q.dtype, device=q.device)
    _build.launch(
        "qt_attention", _build.dtype_code(q),
        q.data_ptr(), q.stride(0), q.stride(1),
        k.data_ptr(), k.stride(0), k.stride(1),
        v.data_ptr(), v.stride(0), v.stride(1),
        out.data_ptr(), out.stride(0), out.stride(1),
        _build.ptr(mask), B, Sq, k.shape[1], heads, W // heads, float(scale))
    attention_wide.launches += 1
    return out


attention_wide.launches = 0
