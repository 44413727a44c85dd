"""The bf16 bound the keep-masked attention's checks hold an output to:
each element within one bf16 ulp of the reference, plus the terms of its
sum whose rounded intermediate (pd in ctx and dv, dS in dq and dk) lies at
a rounding boundary, where two implementations' fp32 arithmetic, equal but
for its last bits, may round it either way, plus 2^-16 of the sum's
absolute terms for its fp32 summation order (``flips``). Every other
rounding point must agree: a version that drops one fails. Shared by
``test_torch_keep_attention.py`` (the plain versions against JAX, on the
CPU) and ``test_torch_cuda.py`` (the card's kernels against the plain
versions); ``wide_flips`` is the same bound for ``attention_wide``'s ctx
over any number of keys, with a mask and a key bias. Imports no JAX.
"""
import math

import numpy as np
import torch

from qa_tiger_tpu_torch.ops import avq as AV


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits), the smallest normal's at 0."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _ulp(x: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(bf16_ulp(x.numpy()).astype(np.float32))


def at_boundary(x: torch.Tensor, window) -> torch.Tensor:
    """Where the fp32 ``x`` lies within ``window`` of a bf16 rounding
    midpoint (so that a last-bit difference may round it the other way)."""
    ulp = _ulp(x)
    return (torch.remainder(x.abs() / ulp, 1.0) - 0.5).abs() * ulp <= window


def flips(q, k, v, g, keep, heads: int, round_p_first: bool = False) -> tuple:
    """Each output element's bound on what rounding-boundary flips and the
    fp32 summation order may move it by, from the fp32 values of the plain
    versions' arithmetic on these (CPU) inputs: over its contraction, 2
    ulp(pd) |v| (ctx), 2 ulp(pd) |g| (dv), 2 scale ulp(dS) |k| (dq), 2
    scale ulp(dS) |q| (dk) for each term whose pd or dS lies at a boundary
    (pd within 2^-16 of its size, dS within 2^-14 of the size of its
    terms), and 2^-16 of every term's |pd| |v| (and so on) for the order of
    the fp32 sum (at most 128 terms: 2^-17 of them). Where the probability
    P is rounded first, a P within 2^-16 of a boundary marks its pd, and
    its flip's shift of dS (its own and, through the row sum, its row's)
    widens the dS window. -> (ctx, dq, dk, dv) bounds in the outputs' [N,
    S, W] layouts."""
    N, Sq, W = q.shape
    Sk, hd = k.shape[1], W // heads
    scale = 1.0 / math.sqrt(hd)
    p0 = AV._keep_probs(q, k, heads, False)
    kp = AV._keep_heads(keep, N, Sq, Sk, heads)
    q4, k4, v4, g4 = (x.float().reshape(N, -1, heads, hd) for x in (q, k, v, g))
    if round_p_first:
        P = p0.to(torch.bfloat16).float()
        flip_p = at_boundary(p0, 2.0 ** -16 * p0.abs())
    else:
        P, flip_p = p0, torch.zeros_like(p0, dtype=torch.bool)
    pd_raw = P * kp
    flip_pd = at_boundary(pd_raw, 2.0 ** -16 * pd_raw.abs()) | flip_p
    dp = torch.einsum("nqhd,nkhd->nhqk", g4, v4) * kp
    rs = (dp * P).sum(-1, keepdim=True)
    ds_raw = P * (dp - rs)
    dp_abs = torch.einsum("nqhd,nkhd->nhqk", g4.abs(), v4.abs()) * kp
    window = 2.0 ** -14 * P * (dp_abs + (dp_abs * P).sum(-1, keepdim=True))
    if round_p_first:
        step = torch.where(flip_p, _ulp(p0), torch.zeros_like(p0))
        window = (window + P * (step * dp.abs()).sum(-1, keepdim=True)
                  + step * (dp - rs).abs())
    flip_ds = at_boundary(ds_raw, window)
    pd_f = (torch.where(flip_pd, 2 * _ulp(pd_raw), torch.zeros_like(pd_raw))
            + 2.0 ** -16 * pd_raw.to(torch.bfloat16).float().abs())
    ds_f = (torch.where(flip_ds, 2 * _ulp(ds_raw), torch.zeros_like(ds_raw))
            + 2.0 ** -16 * ds_raw.to(torch.bfloat16).float().abs())
    return (torch.einsum("nhqk,nkhd->nqhd", pd_f, v4.abs()).reshape(N, Sq, W),
            scale * torch.einsum("nhqk,nkhd->nqhd", ds_f, k4.abs()).reshape(N, Sq, W),
            scale * torch.einsum("nhqk,nqhd->nkhd", ds_f, q4.abs()).reshape(N, Sk, W),
            torch.einsum("nhqk,nqhd->nkhd", pd_f, g4.abs()).reshape(N, Sk, W))


def wide_flips(q, k, v, mask, scale: float, heads: int, key_bias=None) -> torch.Tensor:
    """``flips``' ctx bound for ``attention_wide``'s plain version (fp32
    scores plus the mask and the key bias, p = round(exp(s - m) / l), ctx =
    round(sum p v)) on CPU inputs: 2 ulp(p) |v| for each term whose p lies
    within 2^-16 of its size of a bf16 rounding midpoint, and max(2^-16, Sk
    2^-24) of every term's |p| |v| for the order of the fp32 sum over Sk
    keys (Sk 2^-24: the worst case of any order; at most 256 keys 2^-16 as
    ``flips``). -> [B, Sq, W]."""
    B, Sq, W = q.shape
    Sk, hd = k.shape[1], W // heads
    q4, k4, v4 = (x.float().reshape(B, -1, heads, hd) for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q4, k4) * scale
    if mask is not None:
        s = s + mask.float()
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    flip = at_boundary(p, 2.0 ** -16 * p)
    pf = (torch.where(flip, 2 * _ulp(p), torch.zeros_like(p))
          + max(2.0 ** -16, Sk * 2.0 ** -24) * p.to(torch.bfloat16).float())
    return torch.einsum("bhqk,bkhd->bqhd", pf, v4.abs()).reshape(B, Sq, W)


def check_bf16(got: np.ndarray, want: np.ndarray, flip: torch.Tensor, what: str) -> None:
    """Each element of ``got`` within one bf16 ulp of ``want`` (of the larger
    of the two) plus its ``flips`` bound."""
    assert got.shape == want.shape, what
    err = np.abs(got - want)
    limit = bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + flip.numpy()
    worst = int(np.argmax(err - limit))
    assert (err <= limit).all(), (f"{what}: {int((err > limit).sum())} elements over "
                                  f"their bound, e.g. {got.flat[worst]} vs "
                                  f"{want.flat[worst]} (bound {limit.flat[worst]:.3e})")
