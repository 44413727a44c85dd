"""QA-TIGER building blocks, PyTorch edition.

Port of ``qa_tiger_tpu/models/modules.py``. Each module's parameters carry
the JAX pytree's names (``qst_attn.in_proj_weight``, ``experts.0.0.weight``,
``norm1.bias``, ...), and each forward computes what the JAX function
computes:

- ``Projection``    — ``projection``
- ``AVQCrossAttn``  — ``avq_cross_attn``: both directions as one 2B batch
- ``QstGrounding``  — ``qst_grounding``
- ``TempMoE``       — ``temp_moe``: both streams of the visual branch in one
                      2B ``fused_gaussian_moe`` launch
- ``PatchSelecter`` — ``patch_selecter``: one ``fused_patch_select`` call

Dropout follows the JAX routing. It is active when a ``torch.Generator`` is
given and the rate is above 0 (JAX: ``train`` with a key); without one every
module computes its eval function. Under dropout AVQCrossAttn and
PatchSelecter sample their realization once as explicit masks
(``make_avq_dropout_masks``, ``make_patch_dropout_masks``) and run the
fused train kernels (``fused_avq_train``, ``fused_patch_select_train``); a
``masks=`` argument feeds a given realization instead. QstGrounding and
TempMoE drop attention probabilities at the hard-coded p=0.1 of the
reference, whatever the configured rate, on the plain ``mha`` path.

Under a ``grid`` of model size tp > 1 (``parallel/tensor.py``) each module
holds this rank's shards and computes its function in tensor-parallel
form, every row product's partial in fp32, summed over the model group and
rounded once where the single-rank path rounds it: AVQCrossAttn's three
``mha`` and ``linear1`` by column / ``linear2`` by row; QstGrounding's
``mha`` and ``mlp.0`` / ``mlp.2``; TempMoE's ``mha``, its router and
``gauss_pred`` whole on the reduced question vector, and the experts
through ``fused_gaussian_moe_partial`` (b2's term added after the sum, on
every rank alike); PatchSelecter through the ``fused_patch_select_tp_*``
stages. A replicated input enters a split block through ``copy_to_model``
and a partial leaves it through ``reduce_from_model``, so the backward
sums the partial input gradients over the model group and every
replicated parameter gets the same gradient on every rank. Under dropout
(or with ``masks``) AVQCrossAttn and PatchSelecter draw their whole
realization, as one process draws it, take the rank's share
(``shard_avq_masks``, ``shard_patch_masks``) and run the train kernels'
tensor-parallel forms (``fused_avq_train_tp``,
``fused_patch_select_train_tp``); the attention dropout of QstGrounding
and TempMoE draws the whole mask and keeps the rank's heads (``mha``).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from qa_tiger_tpu_torch.nn.attention import MultiheadAttention, mha
from qa_tiger_tpu_torch.nn.core import MLP2, LayerNorm, Linear, dropout, layer_norm, mlp2
from qa_tiger_tpu_torch.ops.avq import (
    avq_sub_forward_masked,
    fused_avq_train,
    fused_avq_train_tp,
    shard_avq_masks,
)
from qa_tiger_tpu_torch.ops.gaussian_moe import (
    bias_term,
    fused_gaussian_moe,
    fused_gaussian_moe_partial,
)
from qa_tiger_tpu_torch.ops.patch_select import (
    fused_patch_select,
    fused_patch_select_tp_cross,
    fused_patch_select_tp_cross_post,
    fused_patch_select_tp_mlp,
    fused_patch_select_tp_out,
    fused_patch_select_tp_self,
    fused_patch_select_tp_self_post,
    fused_patch_select_train,
    fused_patch_select_train_tp,
    patch_selecter_plain,
    shard_patch_masks,
)
from qa_tiger_tpu_torch.parallel.tensor import copy_to_model, reduce_from_model, row_linear
from qa_tiger_tpu_torch.ops.tempmoe import (
    combined_expert_weights,
    gaussian_weights,
    topk_renormalized,
)


# QstGrounding's and TempMoE's attention dropout, fixed whatever the configured
# rate (qa_tiger_tpu/models/modules.py:296, :359)
ATTN_DROPOUT = 0.1

__all__ = ["AVQCrossAttn", "PatchSelecter", "Projection", "QstGrounding", "TempMoE",
           "avq_sub_forward_masked", "make_avq_dropout_masks", "make_patch_dropout_masks",
           "patch_selecter_plain"]


def _pad128(n: int) -> int:
    return -(-n // 128) * 128


def _bernoulli(generator: torch.Generator, shape, keep: float, dtype,
               pad_to: int | None = None) -> torch.Tensor:
    """A Bernoulli(keep) mask scaled by 1/keep, on the generator's device, its
    lanes zero-padded to ``pad_to``."""
    m = (torch.rand(shape, generator=generator, device=generator.device) < keep).to(dtype)
    m = m * (1.0 / keep)
    if pad_to and pad_to != shape[1]:
        m = F.pad(m, (0, pad_to - shape[1]))
    return m


def make_avq_dropout_masks(generator: torch.Generator, N: int, T: int, S: int, D: int, *,
                           nhead: int, dropout_p: float, dtype=torch.float32) -> dict:
    """The AVQ sub-forward's eight dropout realizations, sampled once per
    step in the fused kernels' 2D geometry, pre-scaled by 1/(1-p)
    (``make_avq_dropout_masks`` :198):

    - ``qst``/``slf``/``crs`` [N*T, pad128(H*Sk)]: attention-probability
      masks, row n*T+t, lane h*Sk+key (Sk is S for qst, T for the others);
      the padded lanes are zero and never read;
    - ``d_slf``/``d_crs``/``d_qst`` [N*T, D]: the residual dropouts;
    - ``ffn1`` [N*T, D] after the FFN's ReLU, ``ffn2`` [N*T, D] on its output.

    Drawn in that order from ``generator``, on its device."""
    keep = 1.0 - dropout_p
    masks = {"qst": _bernoulli(generator, (N * T, nhead * S), keep, dtype, _pad128(nhead * S))}
    for key in ("slf", "crs"):
        masks[key] = _bernoulli(generator, (N * T, nhead * T), keep, dtype, _pad128(nhead * T))
    for key in ("d_slf", "d_crs", "d_qst", "ffn1", "ffn2"):
        masks[key] = _bernoulli(generator, (N * T, D), keep, dtype)
    return masks


def make_patch_dropout_masks(generator: torch.Generator, BT: int, P: int, D: int, *,
                             nhead: int, dropout_p: float, dtype=torch.float32) -> dict:
    """The PatchSelecter's dropout realizations, sampled once per step in the
    fused kernels' 2D geometry, pre-scaled by 1/(1-p)
    (``make_patch_dropout_masks`` :469):

    - ``slf`` [BT*P, pad128(H*P)]: entry (bt*P+qi, h*P+ki) masks the
      self-attention probability of frame bt, head h, query qi, key ki;
    - ``crs_v``/``crs_a`` [BT, pad128(H*P)]: the cross-attention
      probability masks of the video- and audio-query streams;
    - ``out_v``/``out_a`` [BT, D]: the pre-MLP dropout per stream.

    Drawn in that order from ``generator``, on its device."""
    keep = 1.0 - dropout_p
    L = nhead * P
    return {"slf": _bernoulli(generator, (BT * P, L), keep, dtype, _pad128(L)),
            "crs_v": _bernoulli(generator, (BT, L), keep, dtype, _pad128(L)),
            "crs_a": _bernoulli(generator, (BT, L), keep, dtype, _pad128(L)),
            "out_v": _bernoulli(generator, (BT, D), keep, dtype),
            "out_a": _bernoulli(generator, (BT, D), keep, dtype)}


def _dropping(generator, dropout_p: float) -> bool:
    return generator is not None and dropout_p > 0.0


def _tp(grid) -> bool:
    """True under a model axis."""
    return grid is not None and grid.model_size > 1


def _heads(nhead: int, grid) -> int:
    if nhead % grid.model_size:
        raise ValueError(f"{nhead} heads do not split over model_parallel={grid.model_size}")
    return nhead // grid.model_size


def _mlp2_tp(x: torch.Tensor, mlp, grid) -> torch.Tensor:
    """``mlp2`` with mlp.0 by column and mlp.2 by row."""
    return row_linear(torch.relu(mlp[0](copy_to_model(x, grid))), mlp[2], grid)


class Projection(nn.Module):
    """``proj``: a kaiming-initialised Linear."""

    def __init__(self, inp_dim: int, d_model: int, generator: torch.Generator):
        super().__init__()
        self.proj = Linear(inp_dim, d_model, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class AVQCrossAttn(nn.Module):
    def __init__(self, d_model: int, generator: torch.Generator):
        super().__init__()
        self.qst_attn = MultiheadAttention(d_model, generator)
        self.crs_attn = MultiheadAttention(d_model, generator)
        self.slf_attn = MultiheadAttention(d_model, generator)
        self.linear1 = Linear(d_model, d_model, generator)
        self.linear2 = Linear(d_model, d_model, generator)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, src_q: torch.Tensor, src_v: torch.Tensor,
                query: torch.Tensor, *, nhead: int = 8, dropout_p: float = 0.0,
                generator: torch.Generator | None = None, masks: dict | None = None,
                grid=None):
        """Both directions share the parameters, so they run as one pass
        over a 2B batch: rows [:B] attend from src_q, rows [B:] from src_v.
        Returns (src1, src2), each [B, T, D]. Under dropout (or with
        ``masks``) the pass is ``fused_avq_train``."""
        B = src_q.shape[0]
        q_cat = torch.cat([src_q, src_v], dim=0)
        v_cat = torch.cat([src_v, src_q], dim=0)
        query_cat = torch.cat([query, query], dim=0)
        tp = _tp(grid)
        N, T, D = q_cat.shape
        S = query_cat.shape[1]
        if masks is None and _dropping(generator, dropout_p):
            masks = make_avq_dropout_masks(generator, N, T, S, D, nhead=nhead,
                                           dropout_p=dropout_p, dtype=q_cat.dtype)
        if masks is not None and tp:
            mine = shard_avq_masks(masks, nhead, S, T, grid.model_rank, grid.model_size)
            out = fused_avq_train_tp(q_cat, v_cat, query_cat, self, mine,
                                     _heads(nhead, grid), grid)
            return out[:B], out[B:]
        if masks is not None:
            out = fused_avq_train(q_cat, v_cat, query_cat, self, masks, nhead)
            return out[:B], out[B:]
        qst_out, _ = mha(self.qst_attn, q_cat, query_cat, query_cat,
                         num_heads=nhead, need_weights=False, grid=grid)
        slf, _ = mha(self.slf_attn, q_cat, q_cat, q_cat, num_heads=nhead,
                     need_weights=False, grid=grid)
        crs, _ = mha(self.crs_attn, q_cat, v_cat, v_cat, num_heads=nhead,
                     need_weights=False, grid=grid)
        x = q_cat + slf + crs + qst_out
        x = layer_norm(x, self.norm1.weight, self.norm1.bias)
        hid = torch.relu(self.linear1(copy_to_model(x, grid) if tp else x))
        ffn = row_linear(hid, self.linear2, grid) if tp else self.linear2(hid)
        out = layer_norm(x + ffn, self.norm2.weight, self.norm2.bias)
        return out[:B], out[B:]


class QstGrounding(nn.Module):
    def __init__(self, d_model: int, generator: torch.Generator):
        super().__init__()
        self.attn = MultiheadAttention(d_model, generator)
        self.mlp = MLP2(d_model, d_model // 2, d_model, generator)
        self.norm = LayerNorm(d_model)

    def forward(self, qst: torch.Tensor, data, *, nhead: int = 8, dropout_p: float = 0.0,
                generator: torch.Generator | None = None, grid=None) -> torch.Tensor:
        """out = LayerNorm(mean_seq(data) + dropout(MLP(attn(qst, data, data)))).
        ``data`` may be a list of [B, S_i, D] streams joined along seq."""
        if isinstance(data, (list, tuple)):
            data = torch.cat(list(data), dim=1)
        attn_out, _ = mha(self.attn, qst[:, None, :], data, data, num_heads=nhead,
                          need_weights=False, dropout_p=ATTN_DROPOUT, generator=generator,
                          grid=grid)
        mlp = _mlp2_tp(attn_out[:, 0], self.mlp, grid) if _tp(grid) else mlp2(attn_out[:, 0],
                                                                              self.mlp)
        feat = data.mean(dim=1) + dropout(mlp, dropout_p, generator)
        return layer_norm(feat, self.norm.weight, self.norm.bias)


class TempMoE(nn.Module):
    """Question-aware temporal Gaussian mixture of experts."""

    def __init__(self, d_model: int, n_experts: int, generator: torch.Generator,
                 vis_branch: bool = False):
        super().__init__()
        self.n_experts = n_experts
        self.qst_attn = MultiheadAttention(d_model, generator)
        self.gauss_pred = nn.Sequential(Linear(d_model, 2 * n_experts, generator))
        self.router = nn.Sequential(Linear(d_model, n_experts, generator))
        self.experts = nn.ModuleList(
            MLP2(d_model, d_model // 2, d_model, generator) for _ in range(n_experts))
        if vis_branch:
            self.anorm = LayerNorm(d_model)
            self.vnorm = LayerNorm(d_model)
        else:
            self.norm = LayerNorm(d_model)

    def stacked_experts(self):
        """(w1t [E, D, H], b1 [E, H], w2t [E, H, D], b2 [E, D]), the layout
        ``fused_gaussian_moe`` takes."""
        w1t = torch.stack([e[0].weight.t() for e in self.experts])
        b1 = torch.stack([e[0].bias for e in self.experts])
        w2t = torch.stack([e[2].weight.t() for e in self.experts])
        b2 = torch.stack([e[2].bias for e in self.experts])
        return w1t, b1, w2t, b2

    def forward(self, qst: torch.Tensor, data: torch.Tensor, sub_data=None, *,
                nhead: int = 8, topK: int = 5, sigma: float = 9.0,
                gather_mode: str = "reference", generator: torch.Generator | None = None,
                grid=None):
        """[B, 1, D], or a pair of them for the visual branch (``sub_data``
        = [a_patch, v_patch]). The base centres are re-derived from
        ``n_experts``; they are never a parameter."""
        B, T, _ = data.shape
        E = self.n_experts
        margin = 1.0 / (E * 2)
        base_centers = torch.linspace(margin, 1.0 - margin, E,
                                      dtype=torch.float32, device=data.device)
        tp = _tp(grid)
        temp_w, _ = mha(self.qst_attn, qst[:, None, :], data, data, num_heads=nhead,
                        need_weights=False, dropout_p=ATTN_DROPOUT, generator=generator,
                        grid=grid)
        temp_w = temp_w[:, 0]
        router_probs = torch.softmax(self.router(temp_w).float(), dim=-1)
        topk_probs, topk_inds = topk_renormalized(router_probs, topK)
        gauss_cw = self.gauss_pred(temp_w).reshape(B, E, 2).float()
        centers = base_centers[None, :] + torch.tanh(gauss_cw[:, :, 0]) * margin
        widths = torch.sigmoid(gauss_cw[:, :, 1])
        gauss_w = gaussian_weights(centers.gather(1, topk_inds),
                                   widths.gather(1, topk_inds), T, sigma)
        w_bet = combined_expert_weights(gauss_w, topk_inds, topk_probs, E,
                                        gather_mode)
        experts = self.stacked_experts()

        def aggregate(stream: torch.Tensor) -> torch.Tensor:
            # streams stacked along the batch share the per-sample weights
            reps = stream.shape[0] // B
            w = w_bet.repeat(reps, 1, 1).to(stream.dtype)
            if tp:  # the hidden columns split; b2's term added whole after the sum
                w1t, b1, w2t, b2 = experts
                part = fused_gaussian_moe_partial(copy_to_model(stream, grid), w1t, b1, w2t,
                                                  copy_to_model(w, grid))
                total = reduce_from_model(part, grid) + bias_term(b2, w)
                return total.to(stream.dtype)[:, None, :]
            return fused_gaussian_moe(stream, *experts, w)[:, None, :]

        if sub_data is not None:
            both = aggregate(torch.cat([data + sub_data[0], data + sub_data[1]], dim=0))
            return (layer_norm(both[:B], self.anorm.weight, self.anorm.bias),
                    layer_norm(both[B:], self.vnorm.weight, self.vnorm.bias))
        return layer_norm(aggregate(data), self.norm.weight, self.norm.bias)


class PatchSelecter(nn.Module):
    def __init__(self, d_model: int, generator: torch.Generator):
        super().__init__()
        self.slf_attn = MultiheadAttention(d_model, generator)
        self.crs_attn = MultiheadAttention(d_model, generator)
        self.mlp = MLP2(d_model, d_model // 2, d_model, generator)
        self.anorm = LayerNorm(d_model)
        self.vnorm = LayerNorm(d_model)

    def forward(self, patch: torch.Tensor, audio: torch.Tensor,
                video: torch.Tensor, *, nhead: int = 8, dropout_p: float = 0.0,
                generator: torch.Generator | None = None, masks: dict | None = None,
                grid=None):
        """Per-frame audio/video-guided patch summary -> [a_patch, v_patch],
        each [B, T, D]. Under dropout (or with ``masks``) the pass is
        ``fused_patch_select_train``."""
        B, T, P, D = patch.shape
        if masks is None and _dropping(generator, dropout_p):
            masks = make_patch_dropout_masks(generator, B * T, P, D, nhead=nhead,
                                             dropout_p=dropout_p, dtype=patch.dtype)
        if masks is not None and _tp(grid):
            mine = shard_patch_masks(masks, nhead, P, grid.model_rank, grid.model_size)
            return list(fused_patch_select_train_tp(patch, audio, video, self, mine,
                                                    _heads(nhead, grid), grid))
        if masks is not None:
            return list(fused_patch_select_train(patch, audio, video, self, masks, nhead))
        if _tp(grid):
            return list(self._forward_tp(patch, audio, video, nhead, grid))
        return list(fused_patch_select(patch, audio, video, self, nhead))

    def _forward_tp(self, patch, audio, video, nhead: int, grid):
        """The eval pass on one model rank: three stages, each partial summed
        over the model group before its epilogue (differentiable: a train
        step without dropout takes it)."""
        heads = _heads(nhead, grid)
        copy = lambda t: copy_to_model(t, grid)  # noqa: E731
        part = reduce_from_model(fused_patch_select_tp_self(copy(patch), self.slf_attn, heads),
                                 grid)
        x1 = fused_patch_select_tp_self_post(part, patch, self.slf_attn.out_proj.bias)
        part = reduce_from_model(
            fused_patch_select_tp_cross(copy(x1), copy(audio), copy(video), self.crs_attn,
                                        heads), grid)
        crs = fused_patch_select_tp_cross_post(part, self.crs_attn.out_proj.bias, patch.dtype)
        part = reduce_from_model(fused_patch_select_tp_mlp(copy(crs), self.mlp), grid)
        return fused_patch_select_tp_out(part, self.mlp[2].bias, self.anorm, self.vnorm,
                                         patch.dtype)
