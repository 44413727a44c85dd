"""OpenAI CLIP checkpoint -> the port's state_dicts.

Port of ``qa_tiger_tpu/convert/clip_import.py``. Splits a CLIP state_dict
(from the released ``.pt`` archives, TorchScript or plain: the files the
reference downloads, src/models/clip.py:30-72,131-147) into:

- the text tower's state_dict, the names of ``models/clip_text.py``
  ``CLIPTextTower`` (the ``quest_encoder`` of QA-TIGER checkpoints);
- the vision tower's, ``visual.`` stripped.

Floating tensors are cast to fp32 (the reference loads fp32 on the CPU,
src/models/clip.py:145-146). ``infer_clip_config`` reads the model's shape
from the state_dict, as the reference's ``build_model`` does
(src/models/base/clip_base.py:461-499). The JAX package returns the same
names as nested pytrees; here they stay flat.
"""
from __future__ import annotations

from collections.abc import Mapping
from pathlib import Path
from typing import Any

import numpy as np
import torch

from qa_tiger_tpu_torch.convert import state_dict_to_flat

TEXT_KEYS = ("transformer.", "token_embedding.", "positional_embedding",
             "ln_final.", "text_projection", "logit_scale")


def load_clip_state_dict(path: str | Path) -> dict[str, Any]:
    """Read a CLIP .pt file: a TorchScript archive or a plain state_dict
    (read with ``weights_only=True``)."""
    try:
        return torch.jit.load(str(path), map_location="cpu").state_dict()
    except RuntimeError:
        state = torch.load(path, map_location="cpu", weights_only=True)
        return state.get("state_dict", state)


def split_clip_state_dict(state_dict: Mapping[str, Any]
                          ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """-> (text, vision) state_dicts of fp32 CPU tensors."""
    text = {k: v for k, v in state_dict.items() if k.startswith(TEXT_KEYS)}
    vision = {k[len("visual."):]: v for k, v in state_dict.items() if k.startswith("visual.")}
    return state_dict_to_flat(text), state_dict_to_flat(vision)


def infer_clip_config(state_dict: Mapping[str, Any]) -> dict:
    """The architecture (text and vision) read from a state_dict's shapes."""
    def shape(key):
        return tuple(np.shape(state_dict[key]))

    embed_dim = shape("text_projection")[1]
    text_width = shape("ln_final.weight")[0]
    text_layers = len({k.split(".")[2] for k in state_dict
                       if k.startswith("transformer.resblocks.")})
    cfg = dict(embed_dim=embed_dim, text_width=text_width,
               text_layers=text_layers, text_heads=text_width // 64,
               vocab_size=shape("token_embedding.weight")[0],
               context_length=shape("positional_embedding")[0])
    if "visual.layer1.0.conv1.weight" in state_dict:
        # ModifiedResNet tower (the reference's clip_base.py:461-476 reads the
        # same keys): the stem conv1's out-channels are width // 2, the
        # attnpool positional embedding gives the 1/32-scale grid
        vision_width = shape("visual.conv1.weight")[0] * 2
        counts = tuple(
            len({k.split(".")[2] for k in state_dict
                 if k.startswith(f"visual.layer{b}.")}) for b in range(1, 5))
        grid = int(round((shape("visual.attnpool.positional_embedding")[0] - 1) ** 0.5))
        cfg.update(vision_kind="resnet", vision_width=vision_width,
                   vision_layers=counts, input_resolution=grid * 32,
                   vision_heads=vision_width * 32 // 64,
                   vision_output_dim=shape("visual.attnpool.c_proj.weight")[0])
    elif "visual.conv1.weight" in state_dict:
        conv = shape("visual.conv1.weight")
        vision_width, patch = conv[0], conv[-1]
        grid = int(round((shape("visual.positional_embedding")[0] - 1) ** 0.5))
        cfg.update(vision_kind="vit", vision_width=vision_width,
                   patch_size=patch, input_resolution=grid * patch,
                   vision_layers=len({k.split(".")[3] for k in state_dict
                                      if k.startswith("visual.transformer.resblocks.")}),
                   vision_heads=vision_width // 64)
    return cfg


def convert_clip_checkpoint(path: str | Path
                            ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor], dict]:
    """-> (text state_dict, vision state_dict, inferred config)."""
    sd = load_clip_state_dict(path)
    cfg = infer_clip_config(sd)
    text, vision = split_clip_state_dict(sd)
    return text, vision, cfg
