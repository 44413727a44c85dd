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
this rank's shards: in_proj [3 D/tp, D] (its q, k and v rows) and
out_proj.weight [D, D/tp]. The inputs enter through ``copy_to_model``, so
the rank's partial input gradients are summed over the model group in the
backward; the out-projection is row-parallel (``row_linear``): an fp32
partial without the bias, summed over the model group, then the bias added
and the value rounded once, where the single-rank path rounds it. Between the two, by head count:

- num_heads divisible by tp: the rank projects its num_heads/tp heads (the
  same head size and scale) and runs ``attention_wide`` on them;
- one head (TSPM's 512-lane AV_Attn and TokensAttn): the head's lanes are
  split, [r D/tp, (r+1) D/tp) on rank r. ``attention_wide_tp_scores`` gives
  the rank's fp32 partial of q kᵀ, the model group sums it, and
  ``attention_wide_tp_pv`` scales, masks and normalises the whole scores
  and forms the rank's context lanes. The summed scores enter the second
  stage through ``copy_to_model``: each rank's context lanes give only a
  partial of their gradient, which the backward sums over the group;
- any other count raises.

Dropout, a ``prob_mask`` or ``need_weights`` sends either form to the
plain path (the same split, the plain stages). Dropout draws the whole
[B, H, Sq, Sk] mask, as the single-rank path draws it, and keeps the
rank's heads (one head: the whole mask, the probabilities being whole
after the score sum), so the generator advances alike on every rank; a
given ``prob_mask`` is whole too and sliced the same way. The weights are
the pre-dropout probabilities summed over the rank's heads in fp32, summed
over the model group, divided by num_heads and cast (one head: the whole
probabilities), so every rank holds the same weights, bitwise.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from qa_tiger_tpu_torch.nn.core import Linear, attend, dropout, linear
from qa_tiger_tpu_torch.ops.attention import (
    attention_wide,
    attention_wide_tp_pv,
    attention_wide_tp_scores,
    tp_context,
    tp_partial_scores,
    tp_probs,
)
from qa_tiger_tpu_torch.parallel.tensor import copy_to_model, reduce_from_model, row_linear


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
        return _mha_tp(p, query, key, value, num_heads, attn_mask, grid,
                       dropout_p if sampling else 0.0, generator, prob_mask, need_weights)
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
            dropout_p: float = 0.0, generator=None, prob_mask=None, need_weights: bool = False):
    """``mha`` on one model rank of ``grid``: (out [B, Sq, D], the weights or
    None). Dropout, a whole ``prob_mask`` or ``need_weights`` sends it to
    the plain path, as at tp 1."""
    tp = grid.model_size
    B, Sq, D = query.shape
    Sk = key.shape[1]
    lanes = num_heads == 1
    if (num_heads % tp and not lanes) or D % num_heads:
        raise ValueError(f"{num_heads} heads of d_model {D} do not split over "
                         f"model_parallel={tp}")
    Dl = p.in_proj_weight.shape[0] // 3
    if Dl * tp != D:
        raise ValueError(f"in_proj holds {Dl} rows per head group, not d_model/{tp}: "
                         "load the rank's shard (parallel.shard_state_dict)")
    q_in = copy_to_model(query, grid)
    k_in = q_in if key is query else copy_to_model(key, grid)
    v_in = k_in if value is key else copy_to_model(value, grid)
    q, k, v = _project(p, q_in, k_in, v_in, Dl)
    scale = 1.0 / math.sqrt(D // num_heads)
    plain = dropout_p > 0.0 or prob_mask is not None or need_weights
    weights = None
    if lanes and not plain:
        scores = reduce_from_model(attention_wide_tp_scores(q, k), grid)
        ctx = attention_wide_tp_pv(copy_to_model(scores, grid), v, attn_mask, scale)
    elif lanes:
        # q * scale rounds in q's dtype before the product, as in ``attend``
        probs = tp_probs(reduce_from_model(tp_partial_scores(q * scale, k), grid), attn_mask, 1.0)
        dropped = copy_to_model(probs, grid)
        if prob_mask is not None:
            dropped = dropped * prob_mask[:, 0].float()
        else:
            dropped = dropout(dropped, dropout_p, generator,
                              share=((B, 1, Sq, Sk), (slice(None), 0)))
        ctx = tp_context(dropped, v)
        if need_weights:
            weights = probs.to(query.dtype)
    elif not plain:
        ctx = attention_wide(q, k, v, attn_mask, scale, num_heads // tp)
    else:
        heads = num_heads // tp
        mine = (slice(None), slice(grid.model_rank * heads, (grid.model_rank + 1) * heads))

        def drop(probs):
            if prob_mask is not None:
                return probs * prob_mask[mine].float()
            return dropout(probs, dropout_p, generator, share=((B, num_heads, Sq, Sk), mine))

        ctx, probs = attend(q, k, v, heads, attn_mask=attn_mask, drop=drop)
        if need_weights:
            total = reduce_from_model(probs.sum(dim=1), grid)
            weights = (total / num_heads).to(query.dtype)
    return row_linear(ctx, p.out_proj, grid), weights
