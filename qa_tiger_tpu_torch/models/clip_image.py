"""The CLIP ViT image tower (the frame-feature extractor), PyTorch edition.

Port of ``qa_tiger_tpu/models/clip_image.py`` (the reference's vendored
OpenAI CLIP VisionTransformer, src/models/base/clip_base.py:257-299): patch
convolution without bias, class embedding, positional embedding, ln_pre,
pre-LN QuickGELU blocks without a mask, ln_post over all tokens, and
``(cls @ proj, patch tokens)``. The blocks are the text tower's
``ResidualAttentionBlock``, so each layer's attention half runs through
``fused_attn_ln2`` (at ViT-L/14@336px: 577 tokens, width 1024, 16 heads).

Parameter names are CLIP's ``visual.*`` names (``conv1.weight`` in OIHW,
``class_embedding``, ``positional_embedding``, ``ln_pre``,
``transformer.resblocks.N``, ``ln_post``, ``proj``). Images come in NHWC.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from qa_tiger_tpu_torch.models.clip_text import Transformer
from qa_tiger_tpu_torch.nn.core import LayerNorm

CLIP_VISION_CONFIGS: dict[str, dict] = {
    "ViT-L/14@336px": dict(input_resolution=336, patch_size=14, width=1024,
                           layers=24, heads=16, output_dim=768),
    "ViT-L/14": dict(input_resolution=224, patch_size=14, width=1024,
                     layers=24, heads=16, output_dim=768),
    "ViT-B/32": dict(input_resolution=224, patch_size=32, width=768,
                     layers=12, heads=12, output_dim=512),
    "ViT-B/16": dict(input_resolution=224, patch_size=16, width=768,
                     layers=12, heads=12, output_dim=512),
}

# CLIP image normalisation (reference src/models/clip.py:79-86)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def vision_config(name: str) -> dict:
    cfg = dict(CLIP_VISION_CONFIGS[name])
    cfg["grid"] = cfg["input_resolution"] // cfg["patch_size"]
    return cfg


class CLIPVisionTower(nn.Module):
    """CLIP's ``visual`` parameters (``clip_vision_encode`` runs them);
    weights from ``seed`` with the JAX package's init statistics."""

    def __init__(self, name: str = "ViT-L/14@336px", seed: int = 0):
        super().__init__()
        cfg = vision_config(name)
        self.name, self.cfg = name, cfg
        g = torch.Generator().manual_seed(seed)
        w, p = cfg["width"], cfg["patch_size"]
        scale = w ** -0.5
        self.transformer = Transformer(w, cfg["layers"], g)
        self.conv1 = nn.Module()
        self.conv1.weight = nn.Parameter(scale * torch.randn(w, 3, p, p, generator=g))
        self.class_embedding = nn.Parameter(scale * torch.randn(w, generator=g))
        self.positional_embedding = nn.Parameter(
            scale * torch.randn(cfg["grid"] ** 2 + 1, w, generator=g))
        self.ln_pre = LayerNorm(w)
        self.ln_post = LayerNorm(w)
        self.proj = nn.Parameter(scale * torch.randn(w, cfg["output_dim"], generator=g))


def clip_vision_encode(model: CLIPVisionTower, images: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W, 3] CLIP-normalised images -> (cls_proj [B, output_dim],
    tokens [B, grid*grid, width])."""
    cfg = model.cfg
    x = F.conv2d(images.permute(0, 3, 1, 2), model.conv1.weight, stride=cfg["patch_size"])
    x = x.flatten(2).transpose(1, 2)                 # [B, grid*grid, width]
    B, _, w = x.shape
    cls = model.class_embedding.expand(B, 1, w).to(x.dtype)
    x = torch.cat([cls, x], dim=1) + model.positional_embedding
    x = model.ln_pre(x)
    for block in model.transformer.resblocks:
        x = block(x, heads=cfg["heads"], mask=None)
    x = model.ln_post(x)
    cls_proj = (x[:, 0].float() @ model.proj.float()).to(x.dtype)
    return cls_proj, x[:, 1:]


def preprocess_frames(frames_uint8: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> CLIP-normalised float32 (the normalise step of
    the reference's transform; resizing happens before)."""
    x = frames_uint8.float() / 255.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std
