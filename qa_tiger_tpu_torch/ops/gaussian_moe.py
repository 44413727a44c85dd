"""Fused Gaussian-weighted expert MLP aggregation (the TempMoE hot op).

Port of ``qa_tiger_tpu/ops/pallas/gaussian_moe.py:fused_gaussian_moe``:

    out[b] = sum_e sum_t w[b, e, t] * (relu(x[b, t] W1_e + b1_e) W2_e + b2_e)

with T contracted before the second Linear. The CUDA kernel in
``csrc/gaussian_moe.cu`` runs for CUDA tensors, the plain version
``_reference_impl`` for CPU tensors. On CUDA its gradient is that of the
plain version, recomputed (``ops/_grad.py``), as the JAX ``custom_vjp``
(gaussian_moe.py:183) recomputes through its reference.

The kernel computes the first Linear of every expert as one [B*T, E*H]
product whose 64-row tiles are one sample's T chunk each (rows past T
weigh 0; the weighted sum over t carried over the chunks), on ``wgmma``
(bf16, D <= 512) or on ``gemm_tf32x3``'s 3xTF32 tile (fp32, and bf16 at
wider D on fp32 copies): ``moe_route`` names which. The second Linear is
one ``gemm_tf32x3`` product over K = E*H. Each launch tallies the routes of
its two products in ``fused_gaussian_moe.gemm_routes``.

Under tensor parallelism (``parallel/tensor.py``) each model rank runs
``fused_gaussian_moe_partial`` on its H/tp hidden columns of every expert:
the same two launches with an fp32 output and no b2 term; the caller sums
the partials over the ranks, adds b2's term (``bias_term``) on every rank
alike and rounds once. It counts as a ``fused_gaussian_moe`` launch; its
gradient is its plain version's, recomputed, as the whole kernel's is.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from qa_tiger_tpu_torch.ops import _build, _grad
from qa_tiger_tpu_torch.ops.gemm import ROUTES, aligned16, sm_count, splitk_plan, tally_routes

# csrc/gaussian_moe.cu MOE_MAX_D: the widest D whose two samples' x chunks
# stay in shared memory on the wgmma route
MOE_WGMMA_MAX_D = 512
ROUTE_CODES = {name: code for code, name in ROUTES.items()}


def _reference_f32(x, w1t, b1, w2t, b2, w):
    """Plain version, fp32 throughout and returned unrounded; never builds
    the [B, T, E, D] tensor."""
    h = torch.relu(torch.einsum("btd,edh->bteh", x.float(), w1t.float())
                   + b1.float())
    wf = w.float()
    s = torch.einsum("bet,bteh->beh", wf, h)
    out = torch.einsum("beh,ehd->bd", s, w2t.float())
    return out + torch.einsum("bet,ed->bd", wf, b2.float())


def _reference_impl(x, w1t, b1, w2t, b2, w):
    """Plain version: ``_reference_f32`` rounded once to x's dtype."""
    return _reference_f32(x, w1t, b1, w2t, b2, w).to(x.dtype)


def moe_route(dtype: torch.dtype, d: int) -> str:
    """The routine of the kernel's first product: "wgmma" for bf16 where
    both samples' [64, D] x chunks fit in shared memory, "tf32x3" otherwise
    (fp32, and bf16 at wider D on widened copies). A function of dtype and
    width only; the second product is always "tf32x3"."""
    return "wgmma" if dtype == torch.bfloat16 and d <= MOE_WGMMA_MAX_D else "tf32x3"


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
    _check(x, w1t, b1, w2t, b2, w)
    return _grad.KernelWithPlainGrad.apply(_launch, _reference_impl, {}, x, w1t, b1, w2t, b2, w)


def _partial_f32(x, w1t, b1, w2t, w):
    """Plain version of the partial: ``_reference_f32`` without b2's term."""
    h = torch.relu(torch.einsum("btd,edh->bteh", x.float(), w1t.float()) + b1.float())
    s = torch.einsum("bet,bteh->beh", w.float(), h)
    return torch.einsum("beh,ehd->bd", s, w2t.float())


def bias_term(b2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """b2's term of ``fused_gaussian_moe``, sum_{e,t} w[b,e,t] b2[e] -> fp32
    [B, D]: what the ranks' partials leave out."""
    return torch.einsum("bet,ed->bd", w.float(), b2.float())


def fused_gaussian_moe_partial(x: torch.Tensor, w1t: torch.Tensor, b1: torch.Tensor,
                               w2t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One model rank's share of ``fused_gaussian_moe`` without b2's term:
    w1t [E, D, Hl], b1 [E, Hl] and w2t [E, Hl, D] its hidden columns of
    every expert -> the fp32 [B, D] partial, unrounded."""
    if x.device.type == "cpu":
        return _partial_f32(x, w1t, b1, w2t, w)
    _check(x, w1t, b1, w2t, None, w)
    return _grad.KernelWithPlainGrad.apply(_launch_partial, _partial_f32, {}, x, w1t, b1, w2t,
                                           w)


def _launch_partial(x, w1t, b1, w2t, w):
    fused_gaussian_moe_partial.launches += 1
    b2 = torch.zeros(w1t.shape[0], x.shape[-1], dtype=x.dtype, device=x.device)
    return _launch(x, w1t, b1, w2t, b2, w, out_f32=True)


def _check(x, w1t, b1, w2t, b2, w) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"fused_gaussian_moe runs on cpu or cuda, not {x.device}")
    B, T, D = x.shape
    E, _, H = w1t.shape
    shapes = {"x": (x, (B, T, D)), "w1t": (w1t, (E, D, H)), "b1": (b1, (E, H)),
              "w2t": (w2t, (E, H, D)), "b2": (b2, (E, D)), "w": (w, (B, E, T))}
    for name, (t, shape) in shapes.items():
        if t is None:  # the partial's absent b2
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name} must match x's dtype and device")


def _pad_cols(t: torch.Tensor, multiple: int) -> torch.Tensor:
    """``t`` with its last dimension zero-padded to a multiple of
    ``multiple``, contiguous and 16-byte aligned (zero columns add nothing
    to a product over that dimension)."""
    extra = -t.shape[-1] % multiple
    return aligned16((F.pad(t, (0, extra)) if extra else t).contiguous())


def _launch(x, w1t, b1, w2t, b2, w, out_f32: bool = False):
    B, T, D = x.shape
    E, _, H = w1t.shape
    N = E * H
    route = moe_route(x.dtype, D)
    # the first product's operands: x and W1^T [E*H, D] (K-major), bf16 for
    # wgmma (TMA's rows: D a multiple of 8), fp32 for tf32x3 (D a multiple of 4)
    op, multiple = (torch.bfloat16, 8) if route == "wgmma" else (torch.float32, 4)
    xk = _pad_cols(x.to(op), multiple)
    w1k = _pad_cols(w1t.transpose(1, 2).reshape(N, D).to(op), multiple)
    w2 = _pad_cols(w2t.reshape(N, D).float(), 4)  # the second product's B, fp32 [E*H, D]
    lds = -(-N // 4) * 4
    dev = x.device
    s = torch.empty(B, lds, dtype=torch.float32, device=dev)
    wsum = torch.empty(B, E, dtype=torch.float32, device=dev)
    out = torch.empty(B, D, dtype=torch.float32 if out_f32 else x.dtype, device=dev)
    plan = splitk_plan(B, D, N, sm_count(dev))
    # the output epilogue runs in the split-K pass, at one chunk too
    # (csrc/gaussian_moe.cu EpiMoeOut): room for every chunk's sums
    ws_floats = plan.splits * B * D
    ws = torch.empty(ws_floats, dtype=torch.float32, device=dev)
    _build.launch("qt_gaussian_moe", _build.dtype_code(x), ROUTE_CODES[route], int(out_f32),
                  xk.data_ptr(),
                  w1k.data_ptr(), b1.data_ptr(), w2.data_ptr(), w2.stride(0), b2.data_ptr(),
                  w.data_ptr(), s.data_ptr(), lds, wsum.data_ptr(), out.data_ptr(),
                  ws.data_ptr(), ws_floats, plan.chunk, B, T, xk.shape[-1], D, H, E)
    fused_gaussian_moe.launches += 1
    tally_routes(fused_gaussian_moe, (route, "tf32x3"))
    return out


fused_gaussian_moe.launches = 0
fused_gaussian_moe.gemm_routes = {}  # the routine of each of its two products launched
fused_gaussian_moe_partial.launches = 0
