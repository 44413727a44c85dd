"""The post-reduce epilogue of the tensor-parallel stages.

Under tensor parallelism (``parallel/tensor.py``) a row-parallel product
leaves each model rank an fp32 partial sum; the caller sums the partials
over the model ranks and one epilogue gives the value the single-rank
kernel's GEMM epilogue writes, rounded once where that kernel rounds it
(``csrc/common.cuh`` ``reduce_epilogue_kernel``, launched through
``qt_reduce_epilogue``):

    res given:       out = res + round(total + bias)
    no res:          out = round(total + bias)
    out_f32:         out = total + bias                  (fp32)

with an optional LayerNorm of the written row; the bias may be absent.
``reduce_epilogue_plain`` is its plain version. The eval stages of the
frozen text tower (``fused_attn_ln2_partial`` / ``_post``) take no gradient
(``no_grad_stage``); every other stage has one.
"""
from __future__ import annotations

import functools

import torch

from qa_tiger_tpu_torch.ops import _build


def tp_stage(plain):
    """A train kernel's tensor-parallel stage ``kernel(state, *args)`` that
    runs ``plain(state, *args)`` instead where the state's tensors lie on
    the CPU (``state.cuda``, read from their device); ``stage.plain`` is
    that plain version, callable on card tensors too."""
    def wrap(kernel):
        @functools.wraps(kernel)
        def stage(st, *args):
            return kernel(st, *args) if st.cuda else plain(st, *args)
        stage.plain = plain
        return stage
    return wrap


def no_grad_stage(name: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would record a stage that has no gradient: the
    frozen text tower's, which runs under ``torch.no_grad()``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} takes no gradient: it belongs to the frozen text tower "
                           "(run it under torch.no_grad())")


def reduce_epilogue_plain(total: torch.Tensor, bias: torch.Tensor | None, *,
                          res: torch.Tensor | None = None,
                          dtype: torch.dtype) -> torch.Tensor:
    """``res + round(total + bias)`` (res given) or ``round(total + bias)``
    in ``dtype``; fp32 ``dtype`` keeps the sum unrounded."""
    v = total if bias is None else total + bias.float()
    if res is None:
        return v.to(dtype)
    return (res.float() + v.to(res.dtype).float()).to(res.dtype)


def launch_epilogue(total: torch.Tensor, bias: torch.Tensor | None, res: torch.Tensor | None,
                    out: torch.Tensor, ln: tuple | None = None,
                    dtype: torch.dtype | None = None) -> None:
    """Launch ``qt_reduce_epilogue`` over ``total`` (fp32 [..., D]) into
    ``out`` (the activations' type, or fp32; may be ``total`` itself);
    ``ln`` = (weight, bias, h) adds h = LayerNorm(out). ``bias`` [D] (or
    None) and ``res`` are in the activations' type: ``dtype``, by default
    ``bias``'s."""
    D = total.shape[-1]
    for t in (total, bias, res, out) + tuple(ln or ()):
        if t is not None and (t.device != total.device or not t.is_contiguous()):
            raise ValueError("the epilogue's tensors must be contiguous on one device")
    if total.dtype != torch.float32 or tuple(out.shape) != tuple(total.shape) \
            or (bias is not None and tuple(bias.shape) != (D,)):
        raise ValueError("the reduced sum must be fp32 and shaped as the output, the "
                         "bias [D]")
    ln_w, ln_b, h = ln or (None, None, None)
    _build.launch("qt_reduce_epilogue", _build.dtype_code(dtype or bias.dtype),
                  int(out.dtype == torch.float32), total.data_ptr(), _build.ptr(bias),
                  _build.ptr(res), out.data_ptr(), _build.ptr(ln_w), _build.ptr(ln_b),
                  _build.ptr(h), total.numel() // D, D)
