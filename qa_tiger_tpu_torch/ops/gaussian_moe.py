"""Fused Gaussian-weighted expert MLP aggregation (the TempMoE hot op).

Port of ``qa_tiger_tpu/ops/pallas/gaussian_moe.py:fused_gaussian_moe``:

    out[b] = sum_e sum_t w[b, e, t] * (relu(x[b, t] W1_e + b1_e) W2_e + b2_e)

with T contracted before the second Linear. The CUDA kernel in
``csrc/gaussian_moe.cu`` runs for CUDA tensors, the plain version
``_reference_impl`` for CPU tensors. On CUDA its gradient is that of the
plain version, recomputed (``ops/_grad.py``), as the JAX ``custom_vjp``
(gaussian_moe.py:183) recomputes through its reference.
"""
from __future__ import annotations

import torch

from qa_tiger_tpu_torch.ops import _build, _grad


def _reference_impl(x, w1t, b1, w2t, b2, w):
    """Plain version, fp32 throughout; never builds the [B, T, E, D] tensor."""
    h = torch.relu(torch.einsum("btd,edh->bteh", x.float(), w1t.float())
                   + b1.float())
    wf = w.float()
    s = torch.einsum("bet,bteh->beh", wf, h)
    out = torch.einsum("beh,ehd->bd", s, w2t.float())
    out = out + torch.einsum("bet,ed->bd", wf, b2.float())
    return out.to(x.dtype)


def fused_gaussian_moe(x: torch.Tensor,    # [B, T, D]
                       w1t: torch.Tensor,  # [E, D, H]
                       b1: torch.Tensor,   # [E, H]
                       w2t: torch.Tensor,  # [E, H, D]
                       b2: torch.Tensor,   # [E, D]
                       w: torch.Tensor,    # [B, E, T] combined weights
                       ) -> torch.Tensor:
    """sum_{e,t} w[b,e,t] * MLP_e(x[b,t]) -> [B, D]."""
    if x.device.type == "cpu":
        return _reference_impl(x, w1t, b1, w2t, b2, w)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gaussian_moe runs on cpu or cuda, not {x.device}")
    B, T, D = x.shape
    E, _, H = w1t.shape
    shapes = {"x": (x, (B, T, D)), "w1t": (w1t, (E, D, H)), "b1": (b1, (E, H)),
              "w2t": (w2t, (E, H, D)), "b2": (b2, (E, D)), "w": (w, (B, E, T))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name} must match x's dtype and device")
    return _grad.KernelWithPlainGrad.apply(_launch, _reference_impl, {}, x, w1t, b1, w2t, b2, w)


def _launch(x, w1t, b1, w2t, b2, w):
    B, T, D = x.shape
    E, _, H = w1t.shape
    s = torch.empty(B, E, H, dtype=torch.float32, device=x.device)
    wsum = torch.empty(B, E, dtype=torch.float32, device=x.device)
    out = torch.empty(B, D, dtype=x.dtype, device=x.device)
    _build.launch("qt_gaussian_moe", _build.dtype_code(x), x.data_ptr(),
                  w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
                  w.data_ptr(), s.data_ptr(), wsum.data_ptr(), out.data_ptr(),
                  B, T, D, H, E)
    fused_gaussian_moe.launches += 1
    return out


fused_gaussian_moe.launches = 0
