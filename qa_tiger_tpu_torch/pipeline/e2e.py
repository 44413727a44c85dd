"""Raw media to answer logits in one forward, PyTorch edition.

Port of ``qa_tiger_tpu/pipeline/e2e.py``. The reference is a two-stage
system (offline extraction to .npy, then the model); here the whole chain
runs on the card:

    frames [B,T,336,336,3] -- CLIP ViT-L/14@336px ----------> video [B,T,768]
    frames [B,T,384,384,3] -- ToMe ViT-L/16-384 (577->14) ---> patch [B,T,14,1024]
    audio  [B,T,16000] f32 -- log-mel + VGGish --------------> audio [B,T,128]
    question tokens [B,77] -- frozen CLIP text tower --\\
                               QA-TIGER eval forward -------> logits [B,42]

Frames arrive normalised (CLIP statistics for the CLIP tower, 0.5/0.5 for
the ToMe tower); ffmpeg and the resize stay on the host.
"""
from __future__ import annotations

import torch
from torch import nn

from qa_tiger_tpu_torch.models.clip_image import CLIPVisionTower, clip_vision_encode
from qa_tiger_tpu_torch.models.qa_tiger import QATiger
from qa_tiger_tpu_torch.models.registry import resolve_device
from qa_tiger_tpu_torch.models.vit import VisionTransformer, vit_forward
from qa_tiger_tpu_torch.ops.mel import waveform_to_examples
from qa_tiger_tpu_torch.pipeline.vggish import VGGish, vggish_forward


def e2e_config(model_cfg: dict, clip_encoder: str = "ViT-L/14@336px",
               tome_model: str = "vit_large_patch16_384", tome_r: int = 25,
               tome_layers: int = 23) -> dict:
    return dict(model=model_cfg, clip_encoder=clip_encoder, tome_model=tome_model,
                tome_r=[tome_r] * tome_layers)


class E2EModel(nn.Module):
    """The four towers (``e2e_forward`` runs them), named as the JAX
    ``e2e_init`` tree (``clip_vision``, ``tome_vit``, ``vggish``,
    ``qa_tiger``) so that its flattened names load strictly. Weights from
    ``seed``."""

    def __init__(self, cfg: dict, seed: int = 0):
        super().__init__()
        self.clip_vision = CLIPVisionTower(cfg["clip_encoder"], seed=seed)
        self.tome_vit = VisionTransformer(cfg["tome_model"], seed=seed + 1)
        self.vggish = VGGish(seed=seed + 2)
        self.qa_tiger = QATiger(cfg["model"], seed=seed + 3)


def e2e_init(cfg: dict, seed: int = 0, device: str | torch.device | None = None,
             dtype: torch.dtype = torch.float32) -> E2EModel:
    """The eval-mode model with weights from ``seed``, on ``device`` (cuda
    unless given) in ``dtype``."""
    model = E2EModel(cfg, seed=seed).eval().requires_grad_(False)
    return model.to(resolve_device(device), dtype)


def encode_media(model: E2EModel, clip_frames: torch.Tensor, tome_frames: torch.Tensor,
                 audio_pcm: torch.Tensor, cfg: dict) -> dict[str, torch.Tensor]:
    """Normalised media -> the three feature streams.

    clip_frames [B, T, H, W, 3]; tome_frames [B, T, H', W', 3]; audio_pcm
    [B, T, sample_rate] mono in [-1, 1], taken in fp32.
    """
    B, T = clip_frames.shape[:2]
    video, _ = clip_vision_encode(model.clip_vision, clip_frames.flatten(0, 1))
    patch = vit_forward(model.tome_vit, tome_frames.flatten(0, 1),
                        tome_r=cfg["tome_r"])["tokens"]
    mel = waveform_to_examples(audio_pcm.reshape(B * T, -1))   # [B*T, 1, 96, 64]
    audio = vggish_forward(model.vggish, mel[:, 0])
    return {"video": video.reshape(B, T, -1),
            "patch": patch.reshape(B, T, *patch.shape[-2:]),
            "audio": audio.reshape(B, T, -1)}


def e2e_forward(model: E2EModel, clip_frames: torch.Tensor, tome_frames: torch.Tensor,
                audio_pcm: torch.Tensor, quest_tokens: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Raw media and question token ids -> answer logits [B, num_labels]."""
    batch = encode_media(model, clip_frames, tome_frames, audio_pcm, cfg)
    batch["quest"] = quest_tokens
    return model.qa_tiger(batch)["out"]
