"""The CLIP model surface: the table of released models, the loader and
the contrastive forward, PyTorch edition.

Port of ``qa_tiger_tpu/models/clip.py`` (the reference's vendored
``clip.load()`` surface, src/models/clip.py:30-147):

- ``_MODELS`` / ``available_models``: the released names, their URLs and,
  in each URL, the file's SHA256; ``download`` fetches one (it needs the
  network; offline, put the file at ``<root>/<basename>`` yourself);
- ``load``: a local ``.pt`` (or a released name, downloaded) -> the text
  and vision state_dicts and the inferred config
  (``convert.clip_import.convert_clip_checkpoint``);
- ``build_towers``: those state_dicts strictly loaded into
  ``CLIPTextTower`` and ``CLIPVisionTower`` or ``CLIPResNetTower`` on a
  device (the card unless another is named);
- ``clip_forward``: (logits_per_image, logits_per_text) of
  src/models/base/clip_base.py:302-434 ``CLIP.forward``.

    text, vision, cfg = load("RN50.pt")
    text_tower, vision_tower = build_towers(text, vision, "RN50")
    logits_per_image, logits_per_text = clip_forward(
        text_tower, vision_tower, images, tokens, encoder_type="RN50")

``images`` are CLIP-normalised [B, H, W, 3] on the towers' device, ``tokens``
[N, 77] token ids.
"""
from __future__ import annotations

import hashlib
import os
import urllib.request
import warnings
from pathlib import Path

import torch

from qa_tiger_tpu_torch.convert.clip_import import convert_clip_checkpoint
from qa_tiger_tpu_torch.models.clip_image import CLIPVisionTower, clip_vision_encode
from qa_tiger_tpu_torch.models.clip_resnet import CLIPResNetTower, clip_resnet_encode
from qa_tiger_tpu_torch.models.clip_text import CLIPTextTower, text_config
from qa_tiger_tpu_torch.models.registry import resolve_device

# released OpenAI CLIP checkpoints (the table the reference vendors,
# src/models/clip.py:30-44); the URL's last directory is the file's SHA256
_MODELS = {
    "RN50": "https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
    "ViT-B/32": "https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "ViT-B/16": "https://openaipublic.azureedge.net/clip/models/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
    "ViT-L/14": "https://openaipublic.azureedge.net/clip/models/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
    "ViT-L/14@336px": "https://openaipublic.azureedge.net/clip/models/3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02/ViT-L-14-336px.pt",
}


def available_models():
    return list(_MODELS)


def download(name: str, root: str | None = None) -> str:
    """Fetch a released checkpoint with SHA256 verification (ref
    src/models/clip.py:47-72). Requires network access; offline environments
    should place the file at ``<root>/<basename>`` manually."""
    if name not in _MODELS:
        raise KeyError(f"unknown model {name!r}; available: {available_models()}")
    url = _MODELS[name]
    root = root or os.path.expanduser("~/.cache/clip")
    os.makedirs(root, exist_ok=True)
    expected_sha = url.split("/")[-2]
    target = Path(root) / url.split("/")[-1]
    if target.exists():
        digest = hashlib.sha256(target.read_bytes()).hexdigest()
        if digest == expected_sha:
            return str(target)
        warnings.warn(f"{target} checksum mismatch; re-downloading")
    urllib.request.urlretrieve(url, target)
    digest = hashlib.sha256(target.read_bytes()).hexdigest()
    if digest != expected_sha:
        raise RuntimeError(f"downloaded {name} has wrong SHA256")
    return str(target)


def load(name_or_path: str, download_root: str | None = None
         ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor], dict]:
    """-> (text state_dict, vision state_dict, config) of a CLIP model.

    ``name_or_path`` is a local ``.pt`` file (TorchScript or a plain
    state_dict) or a released model name (downloaded when the environment
    has network access)."""
    path = name_or_path
    if not os.path.exists(path):
        path = download(name_or_path, download_root)
    return convert_clip_checkpoint(path)


def build_towers(text_state: dict[str, torch.Tensor], vision_state: dict[str, torch.Tensor],
                 encoder_type: str, *, device: str | torch.device | None = None,
                 dtype: torch.dtype = torch.float32
                 ) -> tuple[CLIPTextTower, CLIPVisionTower | CLIPResNetTower]:
    """The eval-mode text and image towers of ``encoder_type`` (an "RN"
    name builds the ModifiedResNet, any other the ViT) with the state_dicts
    of ``load`` loaded strictly (BatchNorm's ``num_batches_tracked``
    entries, which ``.pt`` archives carry, are dropped first), on ``device``
    (the card unless given) in ``dtype``."""
    device = resolve_device(device)
    text = CLIPTextTower(encoder_type, torch.Generator().manual_seed(0))
    text.load_state_dict(text_state, strict=True)
    tower = CLIPResNetTower if encoder_type.startswith("RN") else CLIPVisionTower
    vision = tower(encoder_type)
    vision.load_state_dict({k: v for k, v in vision_state.items()
                            if not k.endswith(".num_batches_tracked")}, strict=True)
    return tuple(m.eval().requires_grad_(False).to(device, dtype) for m in (text, vision))


def clip_forward(text_tower: CLIPTextTower, vision_tower: CLIPVisionTower | CLIPResNetTower,
                 images: torch.Tensor, text: torch.Tensor, *,
                 encoder_type: str = "ViT-L/14@336px") -> tuple[torch.Tensor, torch.Tensor]:
    """Contrastive forward: (logits_per_image [B, N], logits_per_text
    [N, B]) for CLIP-normalised images [B, H, W, 3] and token ids [N, L].

    An "RN" ``encoder_type`` runs the ModifiedResNet image path, any other
    the ViT's. An encoder type without a text config (RN101, RN50x4) raises
    ``KeyError``, as the JAX package's does."""
    text_config(encoder_type)
    if encoder_type.startswith("RN"):
        image_features, _ = clip_resnet_encode(vision_tower, images)
    else:
        image_features, _ = clip_vision_encode(vision_tower, images)
    text_features, _ = text_tower(text)
    image_features = image_features / torch.linalg.vector_norm(image_features, dim=-1,
                                                               keepdim=True)
    text_features = text_features / torch.linalg.vector_norm(text_features, dim=-1,
                                                             keepdim=True)
    scale = text_tower.logit_scale.exp()
    logits_per_image = scale * image_features @ text_features.T
    return logits_per_image, logits_per_image.T
