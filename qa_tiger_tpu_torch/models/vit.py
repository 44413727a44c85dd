"""timm-style Vision Transformer with ToMe token merging, PyTorch edition.

Port of ``qa_tiger_tpu/models/vit.py``: the patch-feature extractor is
timm's ``vit_large_patch16_384`` with ToMe (reference
scripts/extract_ToMe/extract_tome14.py:97-101: ``r=[25]*23``, 577 -> 14
tokens). Each block's attention adds ToMe's proportional-attention term
``log(size)`` to the scores through ``attention_wide``'s key bias (the CUDA
kernel on the card) and returns ``k.mean(heads)`` as the merge metric;
merging runs between attention and MLP.

Parameters carry timm's ``state_dict`` names (``cls_token``, ``pos_embed``,
``patch_embed.proj`` in OIHW, ``blocks.N.{norm1, attn.qkv, attn.proj,
norm2, mlp.fc1, mlp.fc2}``, ``norm``, optional ``fc_norm``), which are the
JAX tree's flattened names. Images come in NHWC. LayerNorm eps is 1e-6 and
runs in plain PyTorch (the CUDA LayerNorm is CLIP's, eps 1e-5); GELU is
exact.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from qa_tiger_tpu_torch.nn.core import layer_norm, linear, trunc_normal
from qa_tiger_tpu_torch.ops.attention import attention_wide
from qa_tiger_tpu_torch.ops.tome import (
    bipartite_soft_matching,
    merge_source,
    merge_wavg,
    parse_r,
)

VIT_CONFIGS: dict[str, dict] = {
    # the extraction recipe's model (scripts/extract_ToMe/extract_tome14.py)
    "vit_large_patch16_384": dict(img_size=384, patch_size=16, width=1024,
                                  depth=24, heads=16, ln_eps=1e-6),
    "vit_large_patch16_224": dict(img_size=224, patch_size=16, width=1024,
                                  depth=24, heads=16, ln_eps=1e-6),
    "vit_base_patch16_384": dict(img_size=384, patch_size=16, width=768,
                                 depth=12, heads=12, ln_eps=1e-6),
    "vit_base_patch16_224": dict(img_size=224, patch_size=16, width=768,
                                 depth=12, heads=12, ln_eps=1e-6),
    "vit_base_patch32_224": dict(img_size=224, patch_size=32, width=768,
                                 depth=12, heads=12, ln_eps=1e-6),
    "vit_small_patch16_224": dict(img_size=224, patch_size=16, width=384,
                                  depth=12, heads=6, ln_eps=1e-6),
    "vit_huge_patch14_224": dict(img_size=224, patch_size=14, width=1280,
                                 depth=32, heads=16, ln_eps=1e-6),
}


def vit_config(name: str) -> dict:
    cfg = dict(VIT_CONFIGS[name])
    cfg["grid"] = cfg["img_size"] // cfg["patch_size"]
    cfg["tokens"] = cfg["grid"] ** 2 + 1
    return cfg


def _linear(n_in: int, n_out: int, gen: torch.Generator) -> nn.Module:
    m = nn.Module()
    m.weight = nn.Parameter(trunc_normal((n_out, n_in), gen))
    m.bias = nn.Parameter(torch.zeros(n_out))
    return m


def _norm(width: int) -> nn.Module:
    m = nn.Module()
    m.weight = nn.Parameter(torch.ones(width))
    m.bias = nn.Parameter(torch.zeros(width))
    return m


class VisionTransformer(nn.Module):
    """The timm-named ViT's parameters (``vit_forward`` runs it). Weights from
    ``seed`` with the JAX package's init statistics (truncated normal, std
    0.02; zero biases and class token)."""

    def __init__(self, name: str = "vit_large_patch16_384", seed: int = 0,
                 fc_norm: bool = False):
        super().__init__()
        cfg = vit_config(name)
        self.name, self.cfg = name, cfg
        g = torch.Generator().manual_seed(seed)
        w, p = cfg["width"], cfg["patch_size"]
        self.cls_token = nn.Parameter(torch.zeros(1, 1, w))
        self.pos_embed = nn.Parameter(trunc_normal((1, cfg["tokens"], w), g))
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Module()
        self.patch_embed.proj.weight = nn.Parameter(trunc_normal((w, 3, p, p), g))
        self.patch_embed.proj.bias = nn.Parameter(torch.zeros(w))
        self.blocks = nn.ModuleList()
        for _ in range(cfg["depth"]):
            blk = nn.Module()
            blk.norm1, blk.norm2 = _norm(w), _norm(w)
            blk.attn = nn.Module()
            blk.attn.qkv = _linear(w, 3 * w, g)
            blk.attn.proj = _linear(w, w, g)
            blk.mlp = nn.Module()
            blk.mlp.fc1 = _linear(w, 4 * w, g)
            blk.mlp.fc2 = _linear(4 * w, w, g)
            self.blocks.append(blk)
        self.norm = _norm(w)
        if fc_norm:
            self.fc_norm = _norm(w)


def patch_embed(proj: nn.Module, images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, grid*grid, width] by a strided convolution."""
    x = F.conv2d(images.permute(0, 3, 1, 2), proj.weight, proj.bias, stride=patch_size)
    return x.flatten(2).transpose(1, 2)


def _attention(p: nn.Module, x: torch.Tensor, heads: int, size: torch.Tensor | None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """timm attention with ToMe's hooks: proportional attention from the
    token sizes, and the metric k.mean(heads) (src/tome/patch/timm.py:74-107).
    q, k and v stay column slices of the packed projection."""
    B, N, C = x.shape
    hd = C // heads
    qkv = linear(x, p.qkv.weight, p.qkv.bias)        # [B, N, 3C]
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    # log in x's dtype, then fp32 for the kernel (as the JAX package)
    key_bias = torch.log(size)[:, :, 0] if size is not None else None
    out = attention_wide(q, k, v, None, hd ** -0.5, heads, key_bias=key_bias)
    out = linear(out, p.proj.weight, p.proj.bias)
    metric = k.reshape(B, N, heads, hd).mean(dim=2)  # [B, N, hd]
    return out, metric


def vit_forward(model: VisionTransformer, images: torch.Tensor, *,
                tome_r: Sequence[int] | None = None, prop_attn: bool = True,
                trace_source: bool = False, global_pool: bool = False) -> dict:
    """[B, H, W, 3] images -> dict of

    - ``tokens``: [B, T_final, width] final-norm token states, class token
      first (with ``tome_r`` the merged tokens the extractor saves),
    - ``cls``: [B, width]; ``size``: merged-token sizes or None;
      ``tokens_pre_norm``,
    - ``merges``: each merging layer's ``merge.indices`` (ops/tome.py),
    - ``gap`` with ``global_pool``: the MAE pooling of the pre-norm states,
      weighted by token size (src/tome/patch/mae.py:50-61), through
      ``fc_norm`` when the model has one,
    - ``source`` with ``trace_source``: the token-provenance matrix.
    """
    cfg = model.cfg
    heads, eps = cfg["heads"], cfg["ln_eps"]
    x = patch_embed(model.patch_embed.proj, images, cfg["patch_size"])
    n_patches = x.shape[1]
    cls = model.cls_token.expand(x.shape[0], 1, x.shape[-1]).to(x.dtype)
    x = torch.cat([cls, x], dim=1) + model.pos_embed

    rs = parse_r(cfg["depth"], list(tome_r) if tome_r is not None else 0)
    size = source = None
    merges = []
    for blk, r in zip(model.blocks, rs):
        h = layer_norm(x, blk.norm1.weight, blk.norm1.bias, eps=eps)
        attn_out, metric = _attention(blk.attn, h, heads, size if prop_attn else None)
        x = x + attn_out
        if r > 0:
            merge, _ = bipartite_soft_matching(metric, r, class_token=True)
            merges.append(getattr(merge, "indices", None))
            if trace_source:
                source = merge_source(merge, x, source)
            x, size = merge_wavg(merge, x, size)
        h = layer_norm(x, blk.norm2.weight, blk.norm2.bias, eps=eps)
        h = F.gelu(linear(h, blk.mlp.fc1.weight, blk.mlp.fc1.bias))
        x = x + linear(h, blk.mlp.fc2.weight, blk.mlp.fc2.bias)
    pre_norm = x
    x = layer_norm(x, model.norm.weight, model.norm.bias, eps=eps)
    out = {"tokens": x, "cls": x[:, 0], "size": size, "tokens_pre_norm": pre_norm,
           "merges": merges}
    if global_pool:
        if size is not None:
            gap = (pre_norm * size)[:, 1:, :].sum(dim=1) / n_patches
        else:
            gap = pre_norm[:, 1:, :].mean(dim=1)
        if hasattr(model, "fc_norm"):
            gap = layer_norm(gap, model.fc_norm.weight, model.fc_norm.bias, eps=eps)
        out["gap"] = gap
    if trace_source:
        out["source"] = source
    return out


def swag_state_dict_to_vit(state_dict) -> dict[str, torch.Tensor]:
    """A SWAG (torchvision-style) ViT state_dict -> this module's timm names,
    as one flat state_dict of fp32 tensors. SWAG's blocks use
    nn.MultiheadAttention (in_proj_weight / in_proj_bias / out_proj, the
    packed-qkv layout of timm's attn.qkv / attn.proj) and torchvision's MLP
    indices; after renaming, ``vit_forward`` is SWAG's ToMe forward
    (src/tome/patch/swag.py:23-101)."""
    flat = {}
    for key, value in state_dict.items():
        k = (key.replace("conv_proj.", "patch_embed.proj.")
             .replace("class_token", "cls_token")
             .replace("encoder.pos_embedding", "pos_embed")
             .replace("encoder.ln.", "norm."))
        if k.startswith("encoder.layers.encoder_layer_"):
            idx, _, tail = k[len("encoder.layers.encoder_layer_"):].partition(".")
            tail = (tail.replace("ln_1.", "norm1.")
                    .replace("ln_2.", "norm2.")
                    .replace("self_attention.in_proj_weight", "attn.qkv.weight")
                    .replace("self_attention.in_proj_bias", "attn.qkv.bias")
                    .replace("self_attention.out_proj.", "attn.proj.")
                    .replace("mlp.0.", "mlp.fc1.")
                    .replace("mlp.3.", "mlp.fc2.")
                    .replace("mlp.linear_1.", "mlp.fc1.")
                    .replace("mlp.linear_2.", "mlp.fc2."))
            k = f"blocks.{idx}.{tail}"
        flat[k] = torch.as_tensor(value, dtype=torch.float32)
    return flat
