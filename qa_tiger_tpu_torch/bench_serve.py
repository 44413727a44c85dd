"""Served rate of the batch server (``qa_tiger_tpu_torch.serve``) under load:
``python -m qa_tiger_tpu_torch.bench_serve``.

Port of ``scripts/bench_serve.py``. It writes a corpus at the shipped
shapes to a temporary directory (8 videos of T=60 frames: [60, 128] VGGish,
[60, 768] CLIP, [60, 14, 1024] ToMe features in fp32 from numpy seed 0, 42
answers, a BPE merges file learned from its four questions), starts the
``Service`` in-process at ``configs/qa-tiger/vitl14.py``'s widths (weights
from its seed; the HTTP layer adds only JSON framing), warms it up,
preloads the device feature cache with one batch, then drives ``--threads`` client threads through
``predict_many`` and prints one JSON line: qa-pairs/s over the client
window, with the window's batches, their fill and how many took the cached
path; then the dispatcher-only rate, every row built beforehand and
enqueued in full batches (``server_side_qps``: batch assembly, dispatch,
materialisation and fan-out, without the clients' per-row work).

    python -m qa_tiger_tpu_torch.bench_serve [--batch 256] [--requests 4096]
        [--threads 4] [--dtype bfloat16] [--device-cache 8]

It runs on the card (the config names no ``hyper_params.platform``).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from qa_tiger_tpu_torch.data.bpe import write_merges
from qa_tiger_tpu_torch.serve import Service
from qa_tiger_tpu_torch.utils.config import load_config_module

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "qa-tiger" / "vitl14.py"
T, P, N_VIDEOS, N_ANSWERS = 60, 14, 8, 42
QUESTIONS = [
    "How many instruments are playing in the video?",
    "Is the ukulele louder than the cello?",
    "Where is the first sounding instrument?",
    "What is the instrument on the left of the piano?",
]


def videos(n: int = N_VIDEOS) -> list[str]:
    return [f"v{i:02d}" for i in range(n)]


def build_corpus(root: Path, config: Path = CONFIG, frames: int = T, patches: int = P,
                 n_videos: int = N_VIDEOS) -> tuple[Path, Path]:
    """Under ``root``: fp32 features of ``n_videos`` videos at ``config``'s
    model widths from numpy seed 0, ``answer2idx.json`` with 42 answers, a
    merges file learned from QUESTIONS, and ``config`` over them (its
    model and ``hyper_params.platform`` kept). Returns (the config file,
    the merges file)."""
    cfg = load_config_module(str(config)).to_dict()
    model = cfg["hyper_params"]["model"]
    data = root / "data"
    rng = np.random.default_rng(0)
    for sub, shape in (("vggish", (frames, model["audio_dim"])),
                       ("clip", (frames, model["video_dim"])),
                       ("tome", (frames, patches, model["patch_dim"]))):
        (data / sub).mkdir(parents=True)
        for vid in videos(n_videos):
            np.save(data / sub / f"{vid}.npy", rng.standard_normal(shape, dtype=np.float32))
    (data / "answer2idx.json").write_text(json.dumps(
        {"ans2ix": {str(i): i for i in range(N_ANSWERS)}, "max_que_len": 24}))
    cfg["data"].update(root=str(data), num_frames=frames, frame_sample_rate=1,
                       ans_quelen="answer2idx.json", audio_feat="vggish",
                       video_feat="clip", patch_feat="tome")
    cfg.update(num_labels=N_ANSWERS, weight="")
    path = root / "serve_cfg.py"
    path.write_text(f"config = {cfg!r}\n")
    return path, write_merges(root / "vocab.txt.gz", QUESTIONS)


def start_service(config: Path, vocab: Path, batch: int, dtype: str,
                  device_cache: int, timeout: float = 1200.0) -> Service:
    """The in-process Service over ``build_corpus``'s files, warmed up;
    raises if the warm-up failed or did not end within ``timeout``."""
    old = os.environ.get("QA_TIGER_BPE_VOCAB")
    os.environ["QA_TIGER_BPE_VOCAB"] = str(vocab)
    try:
        svc = Service(SimpleNamespace(config=str(config), weight="", batch_size=batch,
                                      max_wait_ms=5.0, dtype=dtype,
                                      device_cache=device_cache))
    finally:
        if old is None:
            os.environ.pop("QA_TIGER_BPE_VOCAB", None)
        else:
            os.environ["QA_TIGER_BPE_VOCAB"] = old
    if not svc.ready.wait(timeout) or svc.failed:
        svc.shutdown()
        raise RuntimeError(f"the service did not become ready: {svc.failed or 'timeout'}")
    return svc


def requests(n: int, n_videos: int = N_VIDEOS) -> list[dict]:
    vids = videos(n_videos)
    return [{"question": QUESTIONS[i % len(QUESTIONS)], "video": vids[i % len(vids)]}
            for i in range(n)]


def drive(svc: Service, items: list[dict], threads: int, server_side: bool = True) -> dict:
    """The measured protocol: one batch of ``items`` first (fills the device
    cache), then ``threads`` clients each send their share of ``items``
    through ``predict_many``; then (``server_side``) the same items again as
    rows built beforehand, enqueued in full batches. Returns the JSON line's
    fields."""
    svc.predict_many(items[:svc.batch_size], topk=1)
    before = dict(svc.stats)
    per_thread = len(items) // threads
    done: list = []
    lock = threading.Lock()

    def client(tid):
        out = svc.predict_many(items[tid * per_thread:(tid + 1) * per_thread], topk=1)
        with lock:
            done.extend(out)

    start = time.perf_counter()
    workers = [threading.Thread(target=client, args=(i,)) for i in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    seconds = time.perf_counter() - start
    window = {k: svc.stats[k] - before[k] for k in before}
    result = {
        "metric": "serving_qa_pairs_per_sec", "value": len(done) / seconds, "unit": "qa/s",
        "seconds": seconds, "batch_size": svc.batch_size, "requests": len(done),
        "threads": threads, "dtype": str(svc.dtype).removeprefix("torch."),
        "device_cache": svc.cache_cap, "cached_videos": len(svc._dev_slots),
        "batches": window["batches"], "cached_batches": window["cached_batches"],
        "avg_fill": window["served"] / max(1, window["rows"]),
    }
    if not server_side:
        return result
    rows = [svc._make_row(it["question"], it["video"]) for it in items]
    futs = [{"event": threading.Event()} for _ in items]
    start = time.perf_counter()
    for i in range(0, len(rows), svc.batch_size):
        svc.queue.put((rows[i:i + svc.batch_size], futs[i:i + svc.batch_size]))
    for f in futs:
        svc._await(f)
    server_seconds = time.perf_counter() - start
    return {**result, "server_side_qps": len(futs) / server_seconds}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--requests", type=int, default=4096)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--device-cache", type=int, default=N_VIDEOS)
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        config, vocab = build_corpus(Path(tmp), CONFIG, T, P, N_VIDEOS)
        svc = start_service(config, vocab, args.batch, args.dtype, args.device_cache)
        try:
            result = drive(svc, requests(args.requests, N_VIDEOS), args.threads)
        finally:
            svc.shutdown()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
