"""The frozen CLIP text tower (question encoder), PyTorch edition.

Port of ``qa_tiger_tpu/models/clip_text.py``: token + positional embedding
(sliced to the input length), pre-LN causal blocks with QuickGELU MLPs,
ln_final, and EOT pooling by ``argmax(token_ids)`` (the EOT token has the
largest id). ``words`` is the ln_final output before ``text_projection``.
Each block's attention half runs through ``fused_attn_ln2``.

Under a ``grid`` of model size tp > 1 (``parallel/tensor.py``) each block
holds this rank's shards and runs the tensor-parallel form:
``fused_attn_ln2_partial`` over heads/tp heads, the model-group sum, then
``fused_attn_ln2_post`` (y = x + round(sum + b_out), h = ln_2(y)); c_fc by
column with QuickGELU, c_proj by row into an fp32 partial, the sum, then
y + round(sum + b). Embeddings, ln_final and the projection stay whole.
"""
from __future__ import annotations

import torch
from torch import nn

from qa_tiger_tpu_torch.nn.attention import MultiheadAttention
from qa_tiger_tpu_torch.nn.core import LayerNorm, Linear, linear, quick_gelu
from qa_tiger_tpu_torch.ops.resblock import (
    fused_attn_ln2,
    fused_attn_ln2_partial,
    fused_attn_ln2_post,
)
from qa_tiger_tpu_torch.parallel.tensor import reduce_from_model, row_linear

CLIP_TEXT_CONFIGS = {
    "ViT-L/14@336px": dict(width=768, heads=12, layers=12, embed_dim=768),
    "ViT-L/14": dict(width=768, heads=12, layers=12, embed_dim=768),
    "ViT-B/32": dict(width=512, heads=8, layers=12, embed_dim=512),
    "ViT-B/16": dict(width=512, heads=8, layers=12, embed_dim=512),
    "RN50": dict(width=512, heads=8, layers=12, embed_dim=1024),
}
CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408


def text_config(encoder_type: str) -> dict:
    if encoder_type not in CLIP_TEXT_CONFIGS:
        raise KeyError(f"unknown CLIP encoder type {encoder_type!r}; "
                       f"known: {sorted(CLIP_TEXT_CONFIGS)}")
    cfg = dict(CLIP_TEXT_CONFIGS[encoder_type])
    cfg["context_length"] = CONTEXT_LENGTH
    cfg["vocab_size"] = VOCAB_SIZE
    return cfg


def causal_mask(length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Additive upper-triangular -inf mask [length, length]."""
    return torch.full((length, length), float("-inf"), dtype=dtype,
                      device=device).triu(1)


class ResidualAttentionBlock(nn.Module):
    """attn, ln_1, mlp.c_fc, mlp.c_proj, ln_2 with CLIP's init statistics."""

    def __init__(self, width: int, layers: int, generator: torch.Generator):
        super().__init__()
        self.attn = MultiheadAttention(width, generator)
        self.ln_1 = LayerNorm(width)
        self.mlp = nn.ModuleDict({"c_fc": Linear(width, 4 * width, generator),
                                  "c_proj": Linear(4 * width, width, generator)})
        self.ln_2 = LayerNorm(width)
        proj_std = (width ** -0.5) * ((2 * layers) ** -0.5)
        with torch.no_grad():
            self.attn.in_proj_weight.normal_(0.0, width ** -0.5, generator=generator)
            self.attn.out_proj.weight.normal_(0.0, proj_std, generator=generator)
            self.mlp.c_fc.weight.normal_(0.0, (2 * width) ** -0.5, generator=generator)
            self.mlp.c_proj.weight.normal_(0.0, proj_std, generator=generator)
            for lin in (self.attn.out_proj, self.mlp.c_fc, self.mlp.c_proj):
                lin.bias.zero_()

    def forward(self, x: torch.Tensor, *, heads: int,
                mask: torch.Tensor | None, grid=None) -> torch.Tensor:
        if grid is not None and grid.model_size > 1:
            return self._forward_tp(x, heads, mask, grid)
        y, h = fused_attn_ln2(x, self, mask, heads)
        h = quick_gelu(linear(h, self.mlp.c_fc.weight, self.mlp.c_fc.bias))
        return y + linear(h, self.mlp.c_proj.weight, self.mlp.c_proj.bias)

    def _forward_tp(self, x, heads: int, mask, grid) -> torch.Tensor:
        tp = grid.model_size
        if heads % tp:
            raise ValueError(f"{heads} heads do not split over model_parallel={tp}")
        part = reduce_from_model(fused_attn_ln2_partial(x, self, mask, heads // tp), grid)
        y, h = fused_attn_ln2_post(x, part, self)
        h = quick_gelu(linear(h, self.mlp.c_fc.weight, self.mlp.c_fc.bias))
        return y + row_linear(h, self.mlp.c_proj, grid)


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, generator: torch.Generator):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, layers, generator) for _ in range(layers))


class CLIPTextTower(nn.Module):
    """state_dict names of the reference's ``CLIP_TEncoder``
    (quest_encoder.token_embedding.weight, ...transformer.resblocks.N...)."""

    def __init__(self, encoder_type: str, generator: torch.Generator):
        super().__init__()
        cfg = text_config(encoder_type)
        self.cfg = cfg
        width = cfg["width"]
        self.token_embedding = nn.Embedding(
            cfg["vocab_size"], width,
            _weight=0.02 * torch.randn(cfg["vocab_size"], width, generator=generator))
        self.positional_embedding = nn.Parameter(
            0.01 * torch.randn(cfg["context_length"], width, generator=generator))
        self.transformer = Transformer(width, cfg["layers"], generator)
        self.ln_final = LayerNorm(width)
        self.text_projection = nn.Parameter(
            (width ** -0.5) * torch.randn(width, cfg["embed_dim"], generator=generator))
        self.logit_scale = nn.Parameter(torch.tensor(2.6592))

    def forward(self, text: torch.Tensor, grid=None):
        """token ids [B, L] -> (pooled [B, embed_dim], words [B, L, width]);
        ``grid``: the tensor-parallel blocks on its model ranks."""
        L = text.shape[1]
        x = self.token_embedding.weight[text] + self.positional_embedding[:L]
        mask = causal_mask(L, device=x.device)
        for block in self.transformer.resblocks:
            x = block(x, heads=self.cfg["heads"], mask=mask, grid=grid)
        x = self.ln_final(x)
        eot = text.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        pooled = (pooled.float() @ self.text_projection.float()).to(x.dtype)
        return pooled, x
