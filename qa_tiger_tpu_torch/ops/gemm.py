"""The GEMM routines under the fused kernels, as the card's dispatch picks them.

``fused_attn_ln2``, ``fused_attn_half`` and ``fused_patch_select`` run their
projections on one of two device routines (``csrc/gemm_sm90.cuh``):
``gemm_sm90``, a bf16 Hopper GEMM (TMA loads into a ring of shared-memory
stages, ``wgmma`` products), for every bf16 product whose N and K are
multiples of 8; ``gemm_tile`` (``csrc/common.cuh``) otherwise, on WMMA in
bf16 and on an FMA loop in fp32. ``gemm_route`` names the routine a product
takes. ``gemm_sm90`` here calls the Hopper GEMM alone, through one of the
epilogues the fused kernels use, so that it can be checked and timed by
itself; no model path calls it.
"""
from __future__ import annotations

import functools

import torch

from qa_tiger_tpu_torch.ops import _build

ROUTES = {0: "fma", 1: "wmma", 2: "wgmma"}
EPILOGUES = {"bias": 0, "residual": 1, "f32": 2}


def gemm_route(dtype: torch.dtype, m: int, n: int, k: int) -> str:
    """The routine a fused kernel's [m, k] x [n, k] product takes on the
    card: "wgmma" (``gemm_sm90``), "wmma" or "fma" (``gemm_tile``). Asks
    the kernel library, so it builds it on first use."""
    return _route(_build.dtype_code(dtype), m, n, k)


@functools.lru_cache(maxsize=None)
def _route(code: int, m: int, n: int, k: int) -> str:
    return ROUTES[_build.library().qt_gemm_route(code, m, n, k)]


def attn_gemm_shapes(rows: int, width: int) -> list:
    """(M, N, K) of the two products of one attention half over ``rows``
    token rows of ``width``: the ln_1-fused qkv projection, out_proj."""
    return [(rows, 3 * width, width), (rows, width, width)]


def patch_select_gemm_shapes(frames: int, patches: int, width: int) -> list:
    """(M, N, K) of the seven products of one PatchSelecter launch: over the
    patch rows the self-attention's qkv and out_proj and the cross
    attention's k|v; over the 2 query rows per frame the query projection,
    out_proj and the MLP's two layers."""
    rows, queries = frames * patches, 2 * frames
    return [(rows, 3 * width, width), (rows, width, width), (rows, 2 * width, width),
            (queries, width, width), (queries, width, width),
            (queries, width // 2, width), (queries, width, width // 2)]


def note_routes(kernel, dtype: torch.dtype, shapes) -> None:
    """Adds one to ``kernel.gemm_routes[route]`` for the route each of a
    launch's products takes, so that a run can show which routine its
    calls went through (``ops.reset_launches`` clears it)."""
    for m, n, k in shapes:
        route = gemm_route(dtype, m, n, k)
        kernel.gemm_routes[route] = kernel.gemm_routes.get(route, 0) + 1


def tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` where TMA can read it (a 16-byte aligned base), else an
    aligned contiguous copy: alignment never decides a route or makes a call
    raise. Only bf16 tensors feed TMA."""
    if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
        return t.clone(memory_format=torch.contiguous_format)
    return t


def gemm_plain(a, b, *, epilogue: str = "bias", bias=None, res=None, relu: bool = False):
    """Plain version: C = a b^T summed in fp32, then the epilogue as the
    kernels' functors apply it: "bias" round(act(C + bias)); "residual"
    res + round(C + bias), summed in fp32 and rounded; "f32" C + bias in
    fp32."""
    acc = a.float() @ b.float().t()
    if bias is not None:
        acc = acc + bias.float()
    if epilogue == "bias":
        return (acc.relu() if relu else acc).to(a.dtype)
    if epilogue == "residual":
        return (res.float() + acc.to(a.dtype).float()).to(a.dtype)
    if epilogue == "f32":
        return acc
    raise ValueError(f"unknown epilogue {epilogue!r}")


def gemm_sm90(a: torch.Tensor, b: torch.Tensor, *, epilogue: str = "bias",
              bias: torch.Tensor | None = None, res: torch.Tensor | None = None,
              relu: bool = False) -> torch.Tensor:
    """C = a [M, K] b [N, K]^T through one epilogue (``gemm_plain`` says
    which), bf16 in, on ``gemm_sm90`` for CUDA tensors and ``gemm_plain``
    for CPU tensors. ``a`` needs unit stride along K, ``b`` and ``res``
    contiguous."""
    if a.device.type == "cpu":
        return gemm_plain(a, b, epilogue=epilogue, bias=bias, res=res, relu=relu)
    M, K = a.shape
    N = b.shape[0]
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or a.stride(1) != 1:
        raise ValueError("gemm_sm90 takes bf16 a with unit stride along K and bf16 b")
    if tuple(b.shape) != (N, K) or gemm_route(a.dtype, M, N, K) != "wgmma":
        raise ValueError(f"gemm_sm90 does not take [{M}, {K}] x {tuple(b.shape)}")
    if epilogue == "f32" and bias is None:
        raise ValueError("the f32 epilogue needs a bias")
    if epilogue == "residual" and (res is None or tuple(res.shape) != (M, N)):
        raise ValueError(f"the residual epilogue needs res [{M}, {N}]")
    b = tma_ready(b.contiguous())
    if a.data_ptr() % 16 or a.stride(0) % 8:
        a = a.clone(memory_format=torch.contiguous_format)
    bias = None if bias is None else bias.to(torch.bfloat16).contiguous()
    res = None if res is None else res.to(torch.bfloat16).contiguous()
    out = torch.empty(M, N, device=a.device,
                      dtype=torch.float32 if epilogue == "f32" else torch.bfloat16)
    _build.launch("qt_gemm_sm90", EPILOGUES[epilogue], a.data_ptr(), a.stride(0),
                  b.data_ptr(), b.stride(0), out.data_ptr(), out.stride(0),
                  _build.ptr(bias), _build.ptr(res), N, int(relu), M, N, K)
    gemm_sm90.launches += 1
    return out


gemm_sm90.launches = 0
