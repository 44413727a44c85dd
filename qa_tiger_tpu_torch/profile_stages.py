"""Per-stage timing of the QA-TIGER eval forward on one card.

    python -m qa_tiger_tpu_torch.profile_stages [--batch 256] [--dtype bfloat16]
        [--trace DIR] [--device cuda|cpu]

Counterpart of ``scripts/profile_stages.py``: ``configs/qa-tiger/vitl14.py``'s
network (the frozen CLIP ViT-L/14@336px text tower on 77 token ids
included) with weights from seed 0 in ``--dtype``, one synthetic batch at
the shipped shapes (T=60 frames of P=14 patches) from numpy seed 0, and
each stage timed as its own function on inputs staged on the device
beforehand: the FULL forward, the text tower, the projections (the text
tower included), ``avq_cross_attn``, ``patch_selecter``, ``temp_moe``
over the audio stream and over the visual stream with its two patch
streams, and the two grounding steps with the head. A stage is called
once, twice more to warm up, then 10 times, and its time is the mean of
those 10, ended by reading a sum of its outputs back to the host. The
stages after the text tower partition the forward, so their sum stands
beside FULL.

``--trace DIR`` first writes a ``torch.profiler`` Chrome trace of 3 FULL
forwards (``profile_stages.json``, through ``utils.profiling.trace``; read
it with ``python -m qa_tiger_tpu_torch.trace_summary DIR``), and the kernel
wrappers' launches over the traced block are printed and returned beside
it.

Prints one line per stage and one JSON line (``metric``
``profile_stages_ms``, the stages, FULL, the sum, the device). The device
is cuda unless ``--device`` names another; without a card that raises.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from qa_tiger_tpu_torch import ops
from qa_tiger_tpu_torch.models import build_model
from qa_tiger_tpu_torch.models.registry import resolve_device
from qa_tiger_tpu_torch.utils.benchmark import tensor_leaves
from qa_tiger_tpu_torch.utils.profiling import trace

# the shipped config's model (configs/qa-tiger/vitl14.py), as the JAX script
MODEL = dict(d_model=512, video_dim=768, patch_dim=1024, audio_dim=128, topK=7,
             num_experts=7, encoder_type="ViT-L/14@336px")
T, P = 60, 14
ITERS = 10
TRACE_FILE = "profile_stages.json"
# the stages whose times add up to the forward (the text tower runs inside
# the projections)
PARTITION = ("projections(all)", "avq_cross_attn", "patch_selecter", "temp_moe(audio)",
             "temp_moe(visual,2str)", "grounding x2 + head")


def _force(out) -> float:
    """A device-to-host read of the sum of ``out``'s tensors."""
    return float(sum(t.float().sum() for t in tensor_leaves(out)))


def timed(name: str, fn) -> float:
    """Mean ms of ``fn()`` over ITERS calls after a first call and two
    warm-up calls; printed as the JAX script prints it."""
    _force(fn())
    for _ in range(2):
        _force(fn())
    start = time.perf_counter()
    for _ in range(ITERS):
        out = fn()
    _force(out)
    dt = (time.perf_counter() - start) / ITERS * 1e3
    print(f"{name:>28}: {dt:8.2f} ms", flush=True)
    return dt


def make_batch(batch: int, cfg: dict, device, dtype) -> dict:
    """The JAX script's synthetic batch from numpy seed 0, on the device."""
    rng = np.random.default_rng(0)
    host = {
        "quest": rng.integers(1, 49406, (batch, 77)).astype(np.int64),
        "audio": rng.standard_normal((batch, T, cfg["audio_dim"])).astype(np.float32),
        "video": rng.standard_normal((batch, T, cfg["video_dim"])).astype(np.float32),
        "patch": rng.standard_normal((batch, T, P, cfg["patch_dim"])).astype(np.float32),
    }
    return {k: torch.from_numpy(v).to(device, dtype if v.dtype == np.float32 else None)
            for k, v in host.items()}


@torch.inference_mode()
def run(model_kwargs: dict, batch: int, dtype: torch.dtype, device, trace_dir: str = "") -> dict:
    """Times every stage of the network ``model_kwargs`` configures; returns
    the stages' ms, FULL's, the sum of PARTITION's and, with ``trace_dir``,
    the wrappers' launches over the traced block."""
    net = build_model("QA-TIGER", model_kwargs, num_labels=42, device=device, seed=0).to(dtype)
    cfg = net.cfg
    b = make_batch(batch, cfg, device, dtype)
    nhead = cfg["nhead"]
    moe = dict(nhead=nhead, topK=cfg["topK"], sigma=cfg["sigma"],
               gather_mode=cfg["gather_mode"])
    traced = {}
    if trace_dir:
        # first, while the process is young: the profiler drops the first
        # device events of a session, more the older the process
        _force(net(b)["out"])
        before = ops.launch_state()
        with trace(trace_dir, TRACE_FILE):
            for _ in range(3):
                out = net(b)["out"]
            _force(out)
        traced = {"trace": str(trace_dir),
                  "trace_launches": {name: n for name, (n, _) in
                                     ops.launch_delta(before, ops.launch_state()).items()}}
        print(f"trace written to {trace_dir}/{TRACE_FILE}; wrapper launches "
              f"{traced['trace_launches']}", flush=True)
    stages = {}
    stages["FULL forward"] = timed("FULL forward", lambda: net(b)["out"])
    stages["text tower"] = timed("text tower", lambda: net.quest_encoder(b["quest"]))

    def stage_inputs():
        quest, words = net.encode_question(b["quest"])
        return (net.quest_proj(quest), net.words_proj(words), net.audio_proj(b["audio"]),
                net.video_proj(b["video"]), net.patch_proj(b["patch"]))

    stages["projections(all)"] = timed("projections(all)", stage_inputs)
    quest, words, audio, video, patch = stage_inputs()
    av = lambda: net.crs_attn(audio, video, words, nhead=nhead)  # noqa: E731
    stages["avq_cross_attn"] = timed("avq_cross_attn", av)
    a2, v2 = av()
    ps = lambda: net.patch_selecter(patch, a2, v2, nhead=nhead)  # noqa: E731
    stages["patch_selecter"] = timed("patch_selecter", ps)
    pair = ps()
    tm_a = lambda: net.at_aggregator(quest, a2, None, **moe)  # noqa: E731
    stages["temp_moe(audio)"] = timed("temp_moe(audio)", tm_a)
    tm_v = lambda: net.vt_aggregator(quest, v2, pair, **moe)  # noqa: E731
    stages["temp_moe(visual,2str)"] = timed("temp_moe(visual,2str)", tm_v)
    a_g = tm_a()
    ap_g, vp_g = tm_v()

    def grounding():
        g = net.quest_grounding
        fusion = g(quest, [ap_g, vp_g], nhead=nhead)
        fusion = g(quest, [fusion[:, None, :], a_g], nhead=nhead)
        return net.head(torch.relu(fusion))

    stages["grounding x2 + head"] = timed("grounding x2 + head", grounding)
    total = sum(stages[name] for name in PARTITION)
    print(f"{'SUM of stages vs full':>28}: sum={total:.2f} ms "
          f"full={stages['FULL forward']:.2f} ms", flush=True)
    return {"stages_ms": stages, "full_ms": stages["FULL forward"], "sum_ms": total, **traced}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--trace", default="", help="write a Chrome trace of 3 forwards here")
    ap.add_argument("--device", default=None, help="cuda unless given")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    result = run(MODEL, args.batch, getattr(torch, args.dtype), device, args.trace)
    line = {"metric": "profile_stages_ms", "batch": args.batch, "dtype": args.dtype,
            **result,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
