"""Gaussian-expert temporal aggregation math (TempMoE), plain PyTorch.

Port of ``qa_tiger_tpu/ops/tempmoe.py``. The reference's semantics are kept:
peak-normalised Gaussians (centres clamped to [0, 1], widths clamped to
>= 0.09 then divided by sigma), top-K gates renormalised to sum 1, and the
``"reference"`` expert gather, in which row (b, t) of the flattened batch
takes the routing of sample (b*T + t) mod B, as the published checkpoints
were trained.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

MIN_WIDTH = 0.09


def gaussian_weights(centers: torch.Tensor, widths: torch.Tensor, T: int,
                     sigma: float) -> torch.Tensor:
    """Peak-normalised Gaussian temporal masks [B, K, T] from centres and
    sigmoid widths [B, K]."""
    t_axis = torch.linspace(0.0, 1.0, T, dtype=torch.float32,
                            device=centers.device)
    c = centers.clamp(0.0, 1.0)[..., None]
    w = (widths.clamp(min=MIN_WIDTH) / sigma)[..., None]
    g = torch.exp(-(t_axis - c).square() / (2.0 * w.square()))
    return g / g.amax(dim=-1, keepdim=True)


def _rotated_routing(topk_inds: torch.Tensor, T: int) -> torch.Tensor:
    """[B, T, K]: row (b, t) takes sample (b*T + t) % B's top-K ids."""
    B = topk_inds.shape[0]
    ar = torch.arange(B, device=topk_inds.device)[:, None] * T
    r = (ar + torch.arange(T, device=topk_inds.device)[None, :]) % B
    return topk_inds[r]


def gaussian_expert_aggregate(expert_out: torch.Tensor,  # [B, T, E, D]
                              gauss_weight: torch.Tensor,  # [B, K, T]
                              topk_inds: torch.Tensor,  # [B, K]
                              topk_probs: torch.Tensor,  # [B, K]
                              gather_mode: str = "reference") -> torch.Tensor:
    """Gate-mixed, Gaussian-weighted temporal sum -> [B, D]."""
    B, T, E, D = expert_out.shape
    K = topk_inds.shape[1]
    if gather_mode == "reference":
        sel_idx = _rotated_routing(topk_inds, T)
    elif gather_mode == "paper":
        sel_idx = topk_inds[:, None, :].expand(B, T, K)
    else:
        raise ValueError(f"unknown gather_mode {gather_mode!r}")
    sel = torch.gather(expert_out, 2, sel_idx[..., None].expand(B, T, K, D))
    w = (topk_probs[:, :, None] * gauss_weight).to(expert_out.dtype)
    out = torch.einsum("bkt,btkd->bd", w.float(), sel.float())
    return out.to(expert_out.dtype)


def combined_expert_weights(gauss_weight: torch.Tensor,  # [B, K, T]
                            topk_inds: torch.Tensor,  # [B, K]
                            topk_probs: torch.Tensor,  # [B, K]
                            n_experts: int,
                            gather_mode: str = "reference") -> torch.Tensor:
    """Fold gates, Gaussians and the gather mode into w [B, E, T] (fp32) such
    that out[b] = sum_{e,t} w[b,e,t] * MLP_e(x[b,t]) reproduces
    ``gaussian_expert_aggregate``."""
    T = gauss_weight.shape[2]
    pg = (topk_probs[:, :, None] * gauss_weight).float()
    if gather_mode == "paper":
        onehot = F.one_hot(topk_inds.long(), n_experts).float()
        return torch.einsum("bke,bkt->bet", onehot, pg)
    if gather_mode == "reference":
        onehot = F.one_hot(_rotated_routing(topk_inds, T).long(),
                           n_experts).float()
        return torch.einsum("btke,bkt->bet", onehot, pg)
    raise ValueError(f"unknown gather_mode {gather_mode!r}")


def topk_renormalized(router_probs: torch.Tensor, k: int):
    """Top-K gates in descending order, renormalised to sum 1.

    Ties go to the lower expert index, as ``jax.lax.top_k`` orders them
    (``torch.topk`` does not promise an order among equal values, and can
    pick a different set at the k-th edge): a stable descending sort, then
    the first k."""
    sorted_probs, order = torch.sort(router_probs, dim=-1, descending=True, stable=True)
    topk_probs, topk_inds = sorted_probs[..., :k], order[..., :k]
    return topk_probs / topk_probs.sum(dim=-1, keepdim=True), topk_inds


def experts_forward(stacked_w1: torch.Tensor,  # [E, H, D]
                    stacked_b1: torch.Tensor,  # [E, H]
                    stacked_w2: torch.Tensor,  # [E, D, H]
                    stacked_b2: torch.Tensor,  # [E, D]
                    x: torch.Tensor,  # [B, T, D]
                    ) -> torch.Tensor:
    """All expert MLPs -> [B, T, E, D]."""
    h = torch.einsum("btd,ehd->bteh", x.float(), stacked_w1.float()) \
        + stacked_b1.float()
    h = torch.relu(h).to(x.dtype)
    y = torch.einsum("bteh,edh->bted", h.float(), stacked_w2.float()) \
        + stacked_b2.float()
    return y.to(x.dtype)
