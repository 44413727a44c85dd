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

Under a ``grid`` of model size tp > 1 (``parallel/tensor.py``) ``p`` holds
this rank's shards: in_proj [3 D/tp, D] (its heads' q, k and v rows) and
out_proj.weight [D, D/tp]. The rank projects its num_heads/tp heads (the
same head size and scale), runs ``attention_wide`` on D/tp lanes, and
forms the out-projection without its bias as an fp32 partial; the model
group sums the partials, then the bias is added and the value rounded once,
where the single-rank path rounds it. Only the eval call exists there:
``need_weights``, ``prob_mask`` and dropout raise (ROADMAP.md A7b.2).
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from qa_tiger_tpu_torch.nn.core import Linear, dropout, linear
from qa_tiger_tpu_torch.ops.attention import attention_wide
from qa_tiger_tpu_torch.parallel.tensor import all_reduce_model


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
        prob_mask: torch.Tensor | None = None, grid=None):
    """Returns (out [B, Sq, D], head-averaged weights [B, Sq, Sk] or None).

    ``attn_mask`` is an additive [Sq, Sk] mask. Dropout on the attention
    probabilities is active when ``generator`` is given and ``dropout_p`` >
    0; ``prob_mask`` [B, H, Sq, Sk] (already scaled by 1/(1-p)) replaces the
    sampling with an explicit realization. The weights are those before
    dropout, as torch returns them.
    """
    sampling = generator is not None and dropout_p > 0.0
    if grid is not None and grid.model_size > 1:
        if need_weights or prob_mask is not None or sampling:
            raise NotImplementedError(
                "mha under a model axis is the eval call only (no weights, prob_mask or "
                "dropout): the train step under the grid is ROADMAP A7b.2")
        return _mha_tp(p, query, key, value, num_heads, attn_mask, grid), None
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


def _mha_tp(p: MultiheadAttention, query, key, value, num_heads: int, attn_mask, grid):
    """The eval ``mha`` on one model rank of ``grid``: out [B, Sq, D]."""
    tp = grid.model_size
    D = query.shape[-1]
    if num_heads % tp or D % num_heads:
        raise ValueError(f"{num_heads} heads of d_model {D} do not split over "
                         f"model_parallel={tp}")
    w, b = p.in_proj_weight, p.in_proj_bias
    Dl = w.shape[0] // 3
    if Dl * tp != D:
        raise ValueError(f"in_proj holds {Dl} rows per head group, not d_model/{tp}: "
                         "load the rank's shard (parallel.shard_state_dict)")
    if query is key and key is value:
        q, k, v = linear(query, w, b).split(Dl, dim=-1)
    elif key is value:
        q = linear(query, w[:Dl], b[:Dl])
        k, v = linear(key, w[Dl:], b[Dl:]).split(Dl, dim=-1)
    else:
        q = linear(query, w[:Dl], b[:Dl])
        k = linear(key, w[Dl:2 * Dl], b[Dl:2 * Dl])
        v = linear(value, w[2 * Dl:], b[2 * Dl:])
    ctx = attention_wide(q, k, v, attn_mask, 1.0 / math.sqrt(D // num_heads), num_heads // tp)
    part = all_reduce_model(F.linear(ctx.float(), p.out_proj.weight.float()), grid)
    return (part + p.out_proj.bias.float()).to(query.dtype)
