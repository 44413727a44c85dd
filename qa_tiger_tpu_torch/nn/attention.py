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
group sums the partials (``reduce_from_model``), then the bias is added and
the value rounded once, where the single-rank path rounds it. The inputs
enter through ``copy_to_model``, so the rank's partial input gradients are
summed over the model group in the backward. Dropout draws the whole
[B, H, Sq, Sk] mask, as the single-rank path draws it, and keeps the rank's
heads, so the generator advances alike on every rank; a given
``prob_mask`` is whole too and sliced the same way. ``need_weights`` raises
there: no caller under a grid asks for them.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from qa_tiger_tpu_torch.nn.core import Linear, attend, dropout, linear
from qa_tiger_tpu_torch.ops.attention import attention_wide
from qa_tiger_tpu_torch.parallel.tensor import copy_to_model, reduce_from_model


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
        if need_weights:
            raise NotImplementedError("mha under a model axis returns no weights")
        return _mha_tp(p, query, key, value, num_heads, attn_mask, grid,
                       dropout_p if sampling else 0.0, generator, prob_mask), None
    D = query.shape[-1]
    if (D // num_heads) * num_heads != D:
        raise ValueError(f"d_model {D} must divide into {num_heads} heads")
    q, k, v = _project(p, query, key, value, D)
    if not need_weights and prob_mask is None and not sampling:
        ctx = attention_wide(q, k, v, attn_mask, 1.0 / math.sqrt(D // num_heads), num_heads)
        return linear(ctx, p.out_proj.weight, p.out_proj.bias), None

    def drop(probs):
        if prob_mask is not None:
            return probs * prob_mask.float()
        return dropout(probs, dropout_p, generator)

    ctx, probs = attend(q, k, v, num_heads, attn_mask=attn_mask, drop=drop)
    out = linear(ctx, p.out_proj.weight, p.out_proj.bias)
    return out, probs.mean(dim=1).to(query.dtype) if need_weights else None


def _project(p: MultiheadAttention, query, key, value, width: int):
    """q, k, v from ``p``'s packed in_proj, ``width`` rows each: one fused
    product for self-attention, a fused key/value product when key is
    value, three otherwise."""
    w, b = p.in_proj_weight, p.in_proj_bias
    if query is key and key is value:
        return linear(query, w, b).split(width, dim=-1)
    q = linear(query, w[:width], b[:width])
    if key is value:
        return (q, *linear(key, w[width:], b[width:]).split(width, dim=-1))
    return (q, linear(key, w[width:2 * width], b[width:2 * width]),
            linear(value, w[2 * width:], b[2 * width:]))


def _mha_tp(p: MultiheadAttention, query, key, value, num_heads: int, attn_mask, grid,
            dropout_p: float = 0.0, generator=None, prob_mask=None):
    """``mha`` on one model rank of ``grid``: out [B, Sq, D]. Dropout (or a
    whole ``prob_mask``) sends it to the plain path, as at tp 1."""
    tp = grid.model_size
    B, Sq, D = query.shape
    Sk = key.shape[1]
    if num_heads % tp or D % num_heads:
        raise ValueError(f"{num_heads} heads of d_model {D} do not split over "
                         f"model_parallel={tp}")
    Dl = p.in_proj_weight.shape[0] // 3
    if Dl * tp != D:
        raise ValueError(f"in_proj holds {Dl} rows per head group, not d_model/{tp}: "
                         "load the rank's shard (parallel.shard_state_dict)")
    heads = num_heads // tp
    q_in = copy_to_model(query, grid)
    k_in = q_in if key is query else copy_to_model(key, grid)
    v_in = k_in if value is key else copy_to_model(value, grid)
    q, k, v = _project(p, q_in, k_in, v_in, Dl)
    if dropout_p == 0.0 and prob_mask is None:
        ctx = attention_wide(q, k, v, attn_mask, 1.0 / math.sqrt(D // num_heads), heads)
    else:
        mine = (slice(None), slice(grid.model_rank * heads, (grid.model_rank + 1) * heads))

        def drop(probs):
            if prob_mask is not None:
                return probs * prob_mask[mine].float()
            return dropout(probs, dropout_p, generator, share=((B, num_heads, Sq, Sk), mine))

        ctx, _ = attend(q, k, v, heads, attn_mask=attn_mask, drop=drop)
    part = reduce_from_model(F.linear(ctx.float(), p.out_proj.weight.float()), grid)
    return (part + p.out_proj.bias.float()).to(query.dtype)
