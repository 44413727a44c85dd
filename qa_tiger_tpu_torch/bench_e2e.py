"""Raw-media throughput: pixels, PCM and tokens to answer logits.

    python -m qa_tiger_tpu_torch.bench_e2e [--batch 2] [--frames 60] [--iters 5]
        [--repeats 3] [--dtype bfloat16] [--device cuda|cpu]

Counterpart of ``scripts/bench_e2e.py``: ``pipeline.e2e.e2e_forward`` at
that script's towers (CLIP ViT-L/14@336px frames, the ToMe
vit_large_patch16_384 at r=[25]*23, log-mel + VGGish, the frozen CLIP
text tower and ``configs/qa-tiger/vitl14.py``'s QA-TIGER), weights from
seed 0 in ``--dtype``, for B videos of T one-second frames. Every call
draws its normalised frames and PCM on the device from a generator seeded
7 (the JAX script draws them inside its jitted call: a host-to-device copy
would time the copy), the tokens come from numpy seed 0. Two calls warm
up, each ended by reading the logits back; then ``--repeats`` runs of
``--iters`` calls, each ended the same way, and the median rate.

Prints one JSON line with the JAX script's keys: ``metric``
(``e2e_raw_media_videos_per_sec``), ``value`` (videos/s), ``unit``,
``frames_per_video``, ``realtime_factor`` (media seconds per second),
``qa_pairs_per_sec`` (one question per video), and the device's name. The
device is cuda unless ``--device`` names another; without a card that
raises.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from qa_tiger_tpu_torch.models import qa_tiger_config
from qa_tiger_tpu_torch.models.clip_image import vision_config
from qa_tiger_tpu_torch.models.registry import resolve_device
from qa_tiger_tpu_torch.models.vit import vit_config
from qa_tiger_tpu_torch.pipeline.e2e import e2e_config, e2e_forward, e2e_init

SR = 16000
# the JAX script's model (configs/qa-tiger/vitl14.py's)
MODEL = dict(d_model=512, video_dim=768, patch_dim=1024, audio_dim=128, topK=7,
             num_experts=7, num_labels=42, encoder_type="ViT-L/14@336px")


@torch.inference_mode()
def measure(cfg: dict, *, batch: int, frames: int, iters: int, repeats: int,
            dtype: torch.dtype, device) -> list[float]:
    """videos/s of each repeat for the raw-media config ``cfg``
    (``e2e_config``); the frame sizes are its towers' inputs."""
    model = e2e_init(cfg, seed=0, device=device, dtype=dtype)
    clip_px = vision_config(cfg["clip_encoder"])["input_resolution"]
    tome_px = vit_config(cfg["tome_model"])["img_size"]
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(1, 49406, (batch, 77))).to(device)
    g = torch.Generator(device=device).manual_seed(7)

    def run() -> torch.Tensor:
        clip = torch.randn(batch, frames, clip_px, clip_px, 3, generator=g, device=device,
                           dtype=dtype)
        tome = torch.randn(batch, frames, tome_px, tome_px, 3, generator=g, device=device,
                           dtype=dtype)
        pcm = 0.1 * torch.randn(batch, frames, SR, generator=g, device=device)
        return e2e_forward(model, clip, tome, pcm, tokens, cfg)

    run().cpu()
    run().cpu()
    rates = []
    for _ in range(repeats):
        start = time.perf_counter()
        for _ in range(iters):
            out = run()
        out.cpu()
        rates.append(batch * iters / (time.perf_counter() - start))
    return rates


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default=None, help="cuda unless given")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rates = measure(e2e_config(qa_tiger_config(**MODEL)), batch=args.batch,
                    frames=args.frames, iters=args.iters, repeats=args.repeats,
                    dtype=getattr(torch, args.dtype), device=device)
    vps = statistics.median(rates)
    line = {"metric": "e2e_raw_media_videos_per_sec", "value": round(vps, 3),
            "unit": "videos/s", "frames_per_video": args.frames,
            "realtime_factor": round(vps * args.frames, 1), "qa_pairs_per_sec": round(vps, 3),
            "rates": rates,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
