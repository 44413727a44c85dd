"""QA-TIGER building blocks, eval paths, PyTorch edition.

Port of ``qa_tiger_tpu/models/modules.py``. Each module's parameters carry
the JAX pytree's names (``qst_attn.in_proj_weight``, ``experts.0.0.weight``,
``norm1.bias``, ...), and each forward computes what the JAX function
computes with ``train=False`` (dropout is the identity):

- ``Projection``    — ``projection``
- ``AVQCrossAttn``  — ``avq_cross_attn``: both directions as one 2B batch
- ``QstGrounding``  — ``qst_grounding``
- ``TempMoE``       — ``temp_moe``: both streams of the visual branch in one
                      2B ``fused_gaussian_moe`` launch
- ``PatchSelecter`` — ``patch_selecter``: one ``fused_patch_select`` call

The train-mode dropout-mask samplers come with the training slice.
"""
from __future__ import annotations

import torch
from torch import nn

from qa_tiger_tpu_torch.nn.attention import MultiheadAttention, mha
from qa_tiger_tpu_torch.nn.core import MLP2, LayerNorm, Linear, layer_norm, linear, mlp2
from qa_tiger_tpu_torch.ops.gaussian_moe import fused_gaussian_moe
from qa_tiger_tpu_torch.ops.patch_select import fused_patch_select
from qa_tiger_tpu_torch.ops.tempmoe import (
    combined_expert_weights,
    gaussian_weights,
    topk_renormalized,
)


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
                query: torch.Tensor, *, nhead: int = 8):
        """Both directions share the parameters, so they run as one pass
        over a 2B batch: rows [:B] attend from src_q, rows [B:] from src_v.
        Returns (src1, src2), each [B, T, D]."""
        B = src_q.shape[0]
        q_cat = torch.cat([src_q, src_v], dim=0)
        v_cat = torch.cat([src_v, src_q], dim=0)
        query_cat = torch.cat([query, query], dim=0)
        qst_out, _ = mha(self.qst_attn, q_cat, query_cat, query_cat,
                         num_heads=nhead, need_weights=False)
        slf, _ = mha(self.slf_attn, q_cat, q_cat, q_cat, num_heads=nhead,
                     need_weights=False)
        crs, _ = mha(self.crs_attn, q_cat, v_cat, v_cat, num_heads=nhead,
                     need_weights=False)
        x = q_cat + slf + crs + qst_out
        x = layer_norm(x, self.norm1.weight, self.norm1.bias)
        ffn = self.linear2(torch.relu(self.linear1(x)))
        out = layer_norm(x + ffn, self.norm2.weight, self.norm2.bias)
        return out[:B], out[B:]


class QstGrounding(nn.Module):
    def __init__(self, d_model: int, generator: torch.Generator):
        super().__init__()
        self.attn = MultiheadAttention(d_model, generator)
        self.mlp = MLP2(d_model, d_model // 2, d_model, generator)
        self.norm = LayerNorm(d_model)

    def forward(self, qst: torch.Tensor, data, *, nhead: int = 8) -> torch.Tensor:
        """out = LayerNorm(mean_seq(data) + MLP(attn(qst, data, data))).
        ``data`` may be a list of [B, S_i, D] streams joined along seq."""
        if isinstance(data, (list, tuple)):
            data = torch.cat(list(data), dim=1)
        attn_out, _ = mha(self.attn, qst[:, None, :], data, data,
                          num_heads=nhead, need_weights=False)
        feat = data.mean(dim=1) + mlp2(attn_out[:, 0], self.mlp)
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
                gather_mode: str = "reference"):
        """[B, 1, D], or a pair of them for the visual branch (``sub_data``
        = [a_patch, v_patch]). The base centres are re-derived from
        ``n_experts``; they are never a parameter."""
        B, T, _ = data.shape
        E = self.n_experts
        margin = 1.0 / (E * 2)
        base_centers = torch.linspace(margin, 1.0 - margin, E,
                                      dtype=torch.float32, device=data.device)
        temp_w, _ = mha(self.qst_attn, qst[:, None, :], data, data,
                        num_heads=nhead, need_weights=False)
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
                video: torch.Tensor, *, nhead: int = 8):
        """Per-frame audio/video-guided patch summary -> [a_patch, v_patch],
        each [B, T, D]."""
        return list(fused_patch_select(patch, audio, video, self, nhead))
