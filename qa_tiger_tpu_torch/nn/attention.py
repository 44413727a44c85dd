"""torch-semantics multi-head attention on batch-first tensors.

The packed ``in_proj_weight [3D, D]`` / ``in_proj_bias [3D]`` and the
``out_proj`` Linear carry ``nn.MultiheadAttention``'s names. ``mha`` follows
``qa_tiger_tpu.nn.attention.mha``: one fused projection for self-attention,
a fused [D, 2D] key/value projection when key is value, three projections
otherwise; the 1/sqrt(head_dim) scale; an fp32 softmax whose probabilities
are cast to v's dtype; post-softmax dropout, drawn from a generator or given
as an explicit multiplicative ``prob_mask``; head-averaged weights when
asked for.

Routing, as the JAX ``mha`` routes: a call with ``need_weights=False``, no
``prob_mask`` and no active dropout goes to ``attention_wide``, which
launches the CUDA kernel for a CUDA tensor and runs its plain version for a
CPU tensor, whatever the sequence lengths (Sq=1 included). Every other call
runs the plain PyTorch path.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from qa_tiger_tpu_torch.nn.core import Linear, dropout, linear
from qa_tiger_tpu_torch.ops.attention import attention_wide


class MultiheadAttention(nn.Module):
    """Parameters of torch ``nn.MultiheadAttention`` with its default init:
    xavier-uniform packed in_proj, zero biases, nn.Linear's default on
    out_proj's weight."""

    def __init__(self, d_model: int, generator: torch.Generator):
        super().__init__()
        bound = math.sqrt(6.0 / (3 * d_model + d_model))
        self.in_proj_weight = nn.Parameter(
            (torch.rand(3 * d_model, d_model, generator=generator) * 2 - 1)
            * bound)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Linear(d_model, d_model, generator, init="torch")
        with torch.no_grad():
            self.out_proj.bias.zero_()


def mha(p: MultiheadAttention, query: torch.Tensor, key: torch.Tensor,
        value: torch.Tensor, *, num_heads: int,
        attn_mask: torch.Tensor | None = None, need_weights: bool = True,
        dropout_p: float = 0.0, generator: torch.Generator | None = None,
        prob_mask: torch.Tensor | None = None):
    """Returns (out [B, Sq, D], head-averaged weights [B, Sq, Sk] or None).

    ``attn_mask`` is an additive [Sq, Sk] mask. Dropout on the attention
    probabilities is active when ``generator`` is given and ``dropout_p`` >
    0; ``prob_mask`` [B, H, Sq, Sk] (already scaled by 1/(1-p)) replaces the
    sampling with an explicit realization. The weights are those before
    dropout, as torch returns them.
    """
    B, Sq, D = query.shape
    Sk = key.shape[1]
    head_dim = D // num_heads
    if head_dim * num_heads != D:
        raise ValueError(f"d_model {D} must divide into {num_heads} heads")
    w, b = p.in_proj_weight, p.in_proj_bias
    if query is key and key is value:
        q, k, v = linear(query, w, b).split(D, dim=-1)
    elif key is value:
        q = linear(query, w[:D], b[:D])
        k, v = linear(key, w[D:], b[D:]).split(D, dim=-1)
    else:
        q = linear(query, w[:D], b[:D])
        k = linear(key, w[D:2 * D], b[D:2 * D])
        v = linear(value, w[2 * D:], b[2 * D:])
    scale = 1.0 / math.sqrt(head_dim)
    sampling = generator is not None and dropout_p > 0.0

    if not need_weights and prob_mask is None and not sampling:
        ctx = attention_wide(q, k, v, attn_mask, scale, num_heads)
        return linear(ctx, p.out_proj.weight, p.out_proj.bias), None

    q4 = q.reshape(B, Sq, num_heads, head_dim)
    k4 = k.reshape(B, Sk, num_heads, head_dim)
    v4 = v.reshape(B, Sk, num_heads, head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", (q4 * scale).float(), k4.float())
    if attn_mask is not None:
        logits = logits + attn_mask.float()
    probs = torch.softmax(logits, dim=-1)
    if prob_mask is not None:
        dropped = probs * prob_mask.float()
    else:
        dropped = dropout(probs, dropout_p, generator)
    ctx = torch.einsum("bhqk,bkhd->bqhd", dropped.to(v.dtype).float(),
                       v4.float()).to(q.dtype).reshape(B, Sq, D)
    out = linear(ctx, p.out_proj.weight, p.out_proj.bias)
    return out, probs.mean(dim=1).to(query.dtype) if need_weights else None
