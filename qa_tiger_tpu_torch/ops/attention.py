"""Multi-head attention on dense heads-in-lanes [B, S, W] tensors.

Port of ``qa_tiger_tpu/ops/pallas/attention.py:attention_wide``, with its
optional per-(batch element, key) bias (ToMe's proportional attention): the
CUDA kernels in ``csrc/attention.cu`` for CUDA tensors (whole keys staged in
shared memory up to 128 keys, 64-key tiles in two passes beyond), the plain
version ``_wide_reference`` for CPU tensors. On CUDA its gradient is that of
the plain version, recomputed (``ops/_grad.py``), the JAX ``custom_vjp``
rule: q, k, v and ``key_bias`` get real cotangents, the mask none.
"""
from __future__ import annotations

import torch

from qa_tiger_tpu_torch.ops import _build, _grad

# over this many keys the kernel streams them in tiles, for head sizes 32,
# 64 and 128 only (csrc/common.cuh, ATT_STAGED_MAX_SK)
STAGED_MAX_SK = 128


def _wide_reference(q, k, v, mask, scale, heads, key_bias=None):
    """Plain version: fp32 scores (plus mask and key bias), fp32 softmax,
    probabilities cast to v's dtype, context in q's dtype."""
    B, Sq, W = q.shape
    Sk = k.shape[1]
    hd = W // heads
    q4 = q.reshape(B, Sq, heads, hd).float()
    k4 = k.reshape(B, Sk, heads, hd).float()
    v4 = v.reshape(B, Sk, heads, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q4, k4) * scale
    if mask is not None:
        logits = logits + mask.float()
    if key_bias is not None:
        logits = logits + key_bias.float()[:, None, None, :]
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
    """softmax(q_h k_h^T * scale + mask + key_bias[:, None, :]) v_h for every
    head h, concatenated back along lanes -> [B, Sq, W].

    q [B, Sq, W], k/v [B, Sk, W]; each may be a column slice of a packed
    projection (rows strided, last dim contiguous). ``mask`` is an additive
    [Sq, Sk] mask or None; ``key_bias`` a [B, Sk] bias (taken in fp32) or
    None.
    """
    if q.device.type == "cpu":
        return _wide_reference(q, k, v, mask, scale, heads, key_bias)
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
    if Sk > STAGED_MAX_SK and W // heads not in (32, 64, 128):
        raise ValueError(f"over {STAGED_MAX_SK} keys the kernel takes head sizes 32, 64 "
                         f"and 128, not {W // heads}")
    if mask is not None:
        if tuple(mask.shape) != (Sq, Sk):
            raise ValueError(f"mask must be [{Sq}, {Sk}], got {tuple(mask.shape)}")
        mask = mask.to(device=q.device, dtype=torch.float32).contiguous()
    consts = dict(mask=mask, scale=scale, heads=heads)
    if key_bias is None:
        return _grad.KernelWithPlainGrad.apply(_launch, _wide_reference, consts, q, k, v)
    if tuple(key_bias.shape) != (B, Sk) or key_bias.device != q.device:
        raise ValueError(f"key_bias must be [{B}, {Sk}] on {q.device}, got "
                         f"{tuple(key_bias.shape)} on {key_bias.device}")
    key_bias = key_bias.float().contiguous()
    return _grad.KernelWithPlainGrad.apply(_launch, _wide_reference_kb, consts, q, k, v,
                                           key_bias)


def attention_wide_key_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            key_bias: torch.Tensor, scale: float, heads: int,
                            mask: torch.Tensor | None = None) -> torch.Tensor:
    """``attention_wide`` with a key bias: ToMe's proportional attention
    (``models/vit.py``). Its ``launches`` counts the key-bias launches,
    which ``attention_wide.launches`` counts too."""
    return attention_wide(q, k, v, mask, scale, heads, key_bias=key_bias)


def _wide_reference_kb(q, k, v, key_bias, *, mask, scale, heads):
    return _wide_reference(q, k, v, mask, scale, heads, key_bias)


def _launch(q, k, v, key_bias=None, *, mask, scale, heads):
    B, Sq, W = q.shape
    out = torch.empty(B, Sq, W, dtype=q.dtype, device=q.device)
    _build.launch(
        "qt_attention", _build.dtype_code(q),
        q.data_ptr(), q.stride(0), q.stride(1),
        k.data_ptr(), k.stride(0), k.stride(1),
        v.data_ptr(), v.stride(0), v.stride(1),
        out.data_ptr(), out.stride(0), out.stride(1),
        _build.ptr(mask), _build.ptr(key_bias), B, Sq, k.shape[1], heads, W // heads,
        float(scale))
    attention_wide.launches += 1
    if key_bias is not None:
        attention_wide_key_bias.launches += 1
    return out


attention_wide.launches = 0
attention_wide_key_bias.launches = 0
