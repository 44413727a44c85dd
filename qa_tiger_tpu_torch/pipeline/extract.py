"""Offline feature-extraction stages, PyTorch edition.

Port of ``qa_tiger_tpu/pipeline/extract.py`` (the reference's ``scripts/``
layer). One CLI, one subcommand per stage:

  frames       video dir -> 1-fps jpgs per video         (ffmpeg)
  audio        video dir -> 16 kHz mono wavs             (ffmpeg)
  vggish       wavs -> [60, 128] VGGish embeddings
  clip         frame dirs -> [60, 768] CLIP CLS features
  clip-tokens  frame dirs -> [60, grid*grid, width] CLIP patch tokens
  tome         frame dirs -> [60, 14, 1024] ToMe-merged tokens
  questions    annotations -> one [1, 768] question feature per question_id
  prompts      annotations -> one [1, 768] QA-prompt feature per question_id

    python -m qa_tiger_tpu_torch.pipeline.extract tome --src F --dst O --random-weights
    python -m qa_tiger_tpu_torch.pipeline.extract questions --annot A.json --dst O \
        --weights clip_text.npz

Each model stage is two parts: a function that encodes one video's decoded
array on the model's device (``encode_clip``, ``encode_clip_tokens``,
``encode_tome``, ``vggish.vggish_embed_seconds``), and the loop that
decodes, encodes and saves one ``.npy`` per video, skipping videos whose
output exists (the reference's resumability rule). A whole video's 60
frames or seconds go through one forward.

The ``questions`` and ``prompts`` stages feed TSPM: each question's text
with its template slots filled (``data.annotations.substitute_template``)
or its QA prompt (``data.prompts.match_prompt``), tokenized by
``data.ClipTokenizer`` (the merges file ``QA_TIGER_BPE_VOCAB`` names), runs
through the CLIP text tower (``models.clip_text``) in chunks of 256 texts,
and its pooled feature is saved as ``<question_id>.npy`` [1, embed_dim];
ids already written are skipped.

Weights: ``--weights model.npz`` (a state_dict of the stage's module, as
``convert.load_npz`` reads it) or ``--random-weights`` (seed 0). The models
run on ``--device`` (cuda unless given) in fp32.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from collections.abc import Callable, Sequence
from pathlib import Path

import numpy as np
import torch

from qa_tiger_tpu_torch.convert import load_npz
from qa_tiger_tpu_torch.data.annotations import load_annotations, substitute_template
from qa_tiger_tpu_torch.data.prompts import match_prompt
from qa_tiger_tpu_torch.data.tokenizer import ClipTokenizer
from qa_tiger_tpu_torch.models import clip_image as CI
from qa_tiger_tpu_torch.models import clip_text as CT
from qa_tiger_tpu_torch.models import vit as VT
from qa_tiger_tpu_torch.models.registry import resolve_device
from qa_tiger_tpu_torch.ops.mel import SAMPLE_RATE
from qa_tiger_tpu_torch.pipeline import vggish as V

TARGET_FRAMES = 60
TEXT_CHUNK = 256  # texts per text-tower forward
VIDEO_SUFFIXES = (".mp4", ".avi", ".mkv", ".webm")
# timm vit_large_patch16_384 normalises inception-style
TOME_MEAN = TOME_STD = (0.5, 0.5, 0.5)


# ---------------------------------------------------------------------------
# ffmpeg stages
# ---------------------------------------------------------------------------

def extract_frames(video_file: Path, dst_dir: Path, fps: int = 1) -> None:
    """ffmpeg -i video -r 1 dst/%06d.jpg (ref extract_frames.py:7-17)."""
    dst_dir.mkdir(parents=True, exist_ok=True)
    subprocess.run(["ffmpeg", "-nostdin", "-loglevel", "error", "-i", str(video_file),
                    "-y", "-r", str(fps), str(dst_dir / "%06d.jpg")], check=True)


def extract_audio(video_file: Path, dst_wav: Path, sr: int = 16000) -> None:
    """Demux the audio to a 16 kHz mono wav (ref extract_audio.py:11-15)."""
    dst_wav.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(["ffmpeg", "-nostdin", "-loglevel", "error", "-i", str(video_file),
                    "-y", "-vn", "-ac", "1", "-ar", str(sr), str(dst_wav)], check=True)


# ---------------------------------------------------------------------------
# frame selection and image IO
# ---------------------------------------------------------------------------

def select_frame_paths(paths: Sequence[Path], target: int = TARGET_FRAMES) -> list[Path]:
    """At least ``target`` frames: a uniform sample by round(linspace);
    fewer: all of them, padded with the last (ref
    extract_frames_ViT-L14@336px.py:125-139)."""
    paths = list(paths)
    n = len(paths)
    if n == 0:
        raise ValueError("no frames")
    if n >= target:
        return [paths[i] for i in np.round(np.linspace(0, n - 1, target)).astype(int)]
    return paths + [paths[-1]] * (target - n)


def load_image_batch(paths: Sequence[Path], size: int, mean, std) -> np.ndarray:
    """Resize the shorter side, centre crop, normalise: [N, size, size, 3]
    float32, CLIP/timm style."""
    from PIL import Image

    out = np.empty((len(paths), size, size, 3), np.float32)
    for i, p in enumerate(paths):
        img = Image.open(p).convert("RGB")
        w, h = img.size
        scale = size / min(w, h)
        img = img.resize((max(size, int(round(w * scale))), max(size, int(round(h * scale)))),
                         Image.BICUBIC)
        w, h = img.size
        left, top = (w - size) // 2, (h - size) // 2
        img = img.crop((left, top, left + size, top + size))
        out[i] = np.asarray(img, np.float32) / 255.0
    return (out - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def _iter_videos(src: Path, dst: Path, suffix: str = ".npy"):
    """Sorted videos whose output does not exist yet."""
    dst.mkdir(parents=True, exist_ok=True)
    for video_dir in sorted(src.iterdir()):
        out_file = dst / (video_dir.name.removesuffix(".wav") + suffix)
        if out_file.exists():
            continue
        yield video_dir, out_file


# ---------------------------------------------------------------------------
# per-video encoders (one video's decoded array, on the model's device)
# ---------------------------------------------------------------------------

def encode_clip(model, frames: torch.Tensor) -> torch.Tensor:
    """[T, H, W, 3] CLIP-normalised frames -> [T, output_dim] CLS features."""
    return CI.clip_vision_encode(model, frames)[0]


def encode_clip_tokens(model, frames: torch.Tensor) -> torch.Tensor:
    """[T, H, W, 3] -> [T, grid*grid, width] patch tokens (the reference's
    token-level variant, extract_token-level_feat.py)."""
    return CI.clip_vision_encode(model, frames)[1]


def encode_tome(model, frames: torch.Tensor, rs: Sequence[int]) -> torch.Tensor:
    """[T, H, W, 3] 0.5/0.5-normalised frames -> [T, tokens, width] merged
    tokens, class token first (ref extract_tome14.py:75-188)."""
    return VT.vit_forward(model, frames, tome_r=rs)["tokens"]


def read_seconds(wav_file: Path, num_secs: int) -> np.ndarray:
    """A wav -> [num_secs, 16000] float32 mono seconds: the last second
    tiled up to ``num_secs``, channels averaged, /32768, resampled to 16 kHz
    (ref audio_feature_extractor.py:80-143)."""
    from scipy.io import wavfile

    sr, snd = wavfile.read(str(wav_file))
    snd = np.asarray(snd)
    if snd.ndim == 1:
        snd = snd[:, None]
    snd = V.pad_audio_last_second(snd, sr, num_secs)
    wav = snd[: sr * num_secs].mean(axis=1) / 32768.0
    if sr != SAMPLE_RATE:
        wav = V._resample(wav, sr, SAMPLE_RATE)
    return wav[: SAMPLE_RATE * num_secs].reshape(num_secs, SAMPLE_RATE).astype(np.float32)


# ---------------------------------------------------------------------------
# model-backed stages
# ---------------------------------------------------------------------------

def _load_params(args, build: Callable[[], torch.nn.Module]) -> torch.nn.Module:
    """The stage's module with ``--weights`` (strict) or ``--random-weights``,
    in eval mode on ``--device``."""
    if not (args.weights or args.random_weights):
        raise SystemExit("pass --weights CKPT.npz or --random-weights")
    model = build()
    if args.weights:
        model.load_state_dict(load_npz(args.weights), strict=True)
    return model.eval().requires_grad_(False).to(resolve_device(args.device))


def _save(out_file: Path, feats: torch.Tensor) -> None:
    arr = feats.float().cpu().numpy()
    np.save(out_file, arr)
    print(f"{out_file.name}: {arr.shape}")


@torch.inference_mode()
def run_vggish(args) -> None:
    model = _load_params(args, V.VGGish)
    device = next(model.parameters()).device
    for wav_file, out_file in _iter_videos(Path(args.src), Path(args.dst)):
        seconds = torch.from_numpy(read_seconds(wav_file, args.num_secs)).to(device)
        _save(out_file, V.vggish_embed_seconds(model, seconds))


def _run_frames(args, model, size: int, mean, std, encode) -> None:
    device = next(model.parameters()).device
    for frames_dir, out_file in _iter_videos(Path(args.src), Path(args.dst)):
        paths = select_frame_paths(sorted(frames_dir.glob("*.jpg")))
        imgs = torch.from_numpy(load_image_batch(paths, size, mean, std)).to(device)
        _save(out_file, encode(model, imgs))


@torch.inference_mode()
def run_clip_frames(args) -> None:
    model = _load_params(args, lambda: CI.CLIPVisionTower(args.encoder))
    _run_frames(args, model, model.cfg["input_resolution"], CI.CLIP_MEAN, CI.CLIP_STD,
                encode_clip)


@torch.inference_mode()
def run_clip_tokens(args) -> None:
    model = _load_params(args, lambda: CI.CLIPVisionTower(args.encoder))
    _run_frames(args, model, model.cfg["input_resolution"], CI.CLIP_MEAN, CI.CLIP_STD,
                encode_clip_tokens)


@torch.inference_mode()
def run_tome(args) -> None:
    model = _load_params(args, lambda: VT.VisionTransformer(args.model))
    rs = [args.r] * args.layers
    _run_frames(args, model, model.cfg["img_size"], TOME_MEAN, TOME_STD,
                lambda m, x: encode_tome(m, x, rs))


@torch.inference_mode()
def encode_texts(model, texts: Sequence[str], chunk: int = TEXT_CHUNK) -> np.ndarray:
    """Texts -> [N, embed_dim] pooled text-tower features (fp32 numpy),
    ``chunk`` texts per forward on the model's device."""
    device = next(model.parameters()).device
    tok = ClipTokenizer()
    out = [np.zeros((0, model.cfg["embed_dim"]), np.float32)]
    for i in range(0, len(texts), chunk):
        ids = torch.from_numpy(tok(list(texts[i:i + chunk]), truncate=True)).to(device)
        out.append(model(ids)[0].float().cpu().numpy())
    return np.concatenate(out)


def stage_texts(samples: Sequence[dict], use_prompt: bool) -> list[str]:
    """Each annotation's question with its slots filled, or its QA prompt."""
    fill = match_prompt if use_prompt else substitute_template
    return [fill(s["question_content"], s["templ_values"]) for s in samples]


def run_questions(args, use_prompt: bool = False) -> None:
    """The ``questions`` / ``prompts`` stage over ``--annot``: one
    ``<question_id>.npy`` [1, embed_dim] in ``--dst`` per question not
    written yet."""
    samples = load_annotations(args.annot)
    dst = Path(args.dst)
    dst.mkdir(parents=True, exist_ok=True)
    todo = [s for s in samples if not (dst / f"{int(s['question_id'])}.npy").exists()]
    feats = np.zeros((0,))
    if todo:
        model = _load_params(args, lambda: CT.CLIPTextTower(
            args.encoder, torch.Generator().manual_seed(0)))
        feats = encode_texts(model, stage_texts(todo, use_prompt))
    for s, f in zip(todo, feats):
        np.save(dst / f"{int(s['question_id'])}.npy", f[None])
    print(f"encoded {len(todo)} texts -> {dst}")


def _ffmpeg_stage(src: Path, dst: Path, fps_or_sr: int, wav: bool) -> None:
    for video_file in sorted(src.iterdir()):
        if video_file.suffix not in VIDEO_SUFFIXES:
            continue
        if wav:
            out = dst / (video_file.stem + ".wav")
            if not out.exists():
                extract_audio(video_file, out, fps_or_sr)
        else:
            out = dst / video_file.stem
            if not out.exists():
                extract_frames(video_file, out, fps_or_sr)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)

    def stage(name: str, weights: bool = True):
        p = sub.add_parser(name)
        p.add_argument("--src", required=True)
        p.add_argument("--dst", required=True)
        if weights:
            p.add_argument("--weights", default=None)
            p.add_argument("--random-weights", action="store_true")
            p.add_argument("--device", default=None, help="cuda unless given")
        return p

    stage("frames", weights=False).add_argument("--fps", type=int, default=1)
    stage("audio", weights=False).add_argument("--sr", type=int, default=16000)
    stage("vggish").add_argument("--num-secs", type=int, default=60)
    stage("clip").add_argument("--encoder", default="ViT-L/14@336px")
    stage("clip-tokens").add_argument("--encoder", default="ViT-B/32")
    p = stage("tome")
    p.add_argument("--model", default="vit_large_patch16_384")
    p.add_argument("--r", type=int, default=25)
    p.add_argument("--layers", type=int, default=23)
    for name in ("questions", "prompts"):
        p = sub.add_parser(name)
        p.add_argument("--annot", required=True)
        p.add_argument("--dst", required=True)
        p.add_argument("--encoder", default="ViT-L/14@336px")
        p.add_argument("--weights", default=None)
        p.add_argument("--random-weights", action="store_true")
        p.add_argument("--device", default=None, help="cuda unless given")

    args = parser.parse_args(argv)
    if args.cmd == "frames":
        _ffmpeg_stage(Path(args.src), Path(args.dst), args.fps, wav=False)
    elif args.cmd == "audio":
        _ffmpeg_stage(Path(args.src), Path(args.dst), args.sr, wav=True)
    elif args.cmd in ("questions", "prompts"):
        run_questions(args, use_prompt=args.cmd == "prompts")
    else:
        {"vggish": run_vggish, "clip": run_clip_frames, "clip-tokens": run_clip_tokens,
         "tome": run_tome}[args.cmd](args)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    main()
