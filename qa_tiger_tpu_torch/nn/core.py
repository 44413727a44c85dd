"""Plain PyTorch layers with the JAX package's parameter names and numerics.

Weights keep torch's ``[out, in]`` layout, so every module's ``state_dict()``
carries the same dotted names as the JAX parameter pytree flattened
(``proj.weight``, ``mlp.0.bias``, ...). Initializers draw from an explicit
``torch.Generator`` on the CPU; the caller moves the module afterwards.

Numerics follow ``qa_tiger_tpu.nn.core``: matrix products accumulate in fp32
(``F.linear``), LayerNorm takes its statistics in fp32 with eps 1e-5 and
casts back to the activation dtype. ``dropout`` is inverted dropout drawn
from an explicit ``torch.Generator``, the identity without one.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None) -> torch.Tensor:
    """y = x @ W.T + b, fp32 accumulation, output in x's dtype."""
    return F.linear(x, weight, bias)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """torch ``nn.LayerNorm`` over the last dim with fp32 statistics."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return out.to(x.dtype)


def dropout(x: torch.Tensor, p: float, generator: torch.Generator | None,
            share: tuple | None = None) -> torch.Tensor:
    """Inverted dropout, ``nn.Dropout``'s semantics: each element is kept
    with probability 1 - p and then divided by it. The identity when the
    generator is None or p is 0, as the JAX package's ``dropout`` is when
    its key is None. The generator must live on x's device. ``share`` =
    (whole shape, index): x is that share of a tensor of the whole shape;
    the mask is drawn over the whole shape, as for the whole tensor, and
    indexed, so every holder of a share advances the generator alike."""
    if generator is None or p <= 0.0:
        return x
    keep = 1.0 - p
    shape, index = share if share is not None else (x.shape, ...)
    mask = torch.rand(shape, generator=generator, device=x.device)[index] < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, *,
           attn_mask: torch.Tensor | None = None, drop=None) -> tuple:
    """Plain multi-head attention from projections q [B, Sq, W], k/v [B, Sk,
    W] of ``heads`` heads: the 1/sqrt(head_dim) scale, an fp32 softmax
    (after the additive ``attn_mask``), ``drop(probs)`` on the [B, heads,
    Sq, Sk] probabilities (dropout or a keep mask; none when None), and the
    context from them cast to v's dtype -> (ctx [B, Sq, W] in q's dtype,
    the probabilities before ``drop``)."""
    B, Sq, W = q.shape
    Sk, head_dim = k.shape[1], W // heads
    q4 = q.reshape(B, Sq, heads, head_dim)
    k4 = k.reshape(B, Sk, heads, head_dim)
    v4 = v.reshape(B, Sk, heads, head_dim)
    scale = 1.0 / math.sqrt(head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", (q4 * scale).float(), k4.float())
    if attn_mask is not None:
        logits = logits + attn_mask.float()
    probs = torch.softmax(logits, dim=-1)
    dropped = probs if drop is None else drop(probs)
    ctx = torch.einsum("bhqk,bkhd->bqhd", dropped.to(v.dtype).float(), v4.float())
    return ctx.to(q.dtype).reshape(B, Sq, W), probs


def trunc_normal(shape, generator: torch.Generator, std: float = 0.02) -> torch.Tensor:
    """std * a normal truncated to [-2, 2], by the inverse CDF."""
    hi = (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2
    u = (1.0 - hi) + (2.0 * hi - 1.0) * torch.rand(shape, generator=generator,
                                                   dtype=torch.float64)
    return (std * math.sqrt(2.0) * torch.erfinv(2 * u - 1)).float()


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def mlp2(x: torch.Tensor, mlp: nn.Module) -> torch.Tensor:
    """Linear -> ReLU -> Linear over an ``MLP2`` (children '0' and '2')."""
    h = torch.relu(linear(x, mlp[0].weight, mlp[0].bias))
    return linear(h, mlp[2].weight, mlp[2].bias)


class Linear(nn.Module):
    """Parameters ``weight [out, in]`` and ``bias [out]``.

    ``init="torch"`` is nn.Linear's default (uniform +-1/sqrt(fan_in) on
    both); ``init="kaiming"`` is kaiming-normal (fan_in, gain sqrt 2) with a
    zero bias, the reference's explicit init for its own layers.
    """

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator, init: str = "kaiming"):
        super().__init__()
        if init == "kaiming":
            std = math.sqrt(2.0 / in_features)
            w = torch.randn(out_features, in_features, generator=generator) * std
            b = torch.zeros(out_features)
        elif init == "torch":
            bound = 1.0 / math.sqrt(in_features)
            w = (torch.rand(out_features, in_features, generator=generator)
                 * 2 - 1) * bound
            b = (torch.rand(out_features, generator=generator) * 2 - 1) * bound
        else:
            raise ValueError(f"unknown init {init!r}")
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias)


class MLP2(nn.Sequential):
    """Linear -> ReLU -> Linear, children '0' and '2' as in the reference's
    ``nn.Sequential``."""

    def __init__(self, in_features: int, hidden: int, out_features: int,
                 generator: torch.Generator, init: str = "kaiming"):
        super().__init__(Linear(in_features, hidden, generator, init),
                         nn.ReLU(),
                         Linear(hidden, out_features, generator, init))
