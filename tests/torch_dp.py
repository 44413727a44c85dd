"""Ranks for the port's data-parallel tests: ``spawn(fn, world, ...)`` runs
``fn(rank, *args)`` in ``world`` fresh processes joined in a gloo process
group over a ``file://`` store and returns each rank's result. This module
imports no JAX (the ranks are port processes); the rank functions below
build their runner from a plain config dict and numpy weights.
"""
from __future__ import annotations

import os
import socket
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TINY_TOWER = dict(width=32, heads=4, layers=2, embed_dim=32)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, tmp: str, fn, args) -> None:
    from qa_tiger_tpu_torch.models import clip_text

    torch.set_num_threads(1)
    clip_text.CLIP_TEXT_CONFIGS.setdefault("tiny-test", TINY_TOWER)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    try:
        out = fn(rank, *args)
    except Exception:  # the parent re-raises it with the rank's traceback
        out = {"error": traceback.format_exc()}
    finally:
        dist.destroy_process_group()
    torch.save(out, f"{tmp}/rank{rank}.pt")


def spawn(fn, world: int, tmp: Path, *args) -> list:
    """``fn(rank, *args)`` on each of ``world`` gloo ranks; their results in
    rank order. A rank that raised raises here with its traceback."""
    tmp.mkdir(parents=True, exist_ok=True)
    mp.spawn(_entry, args=(world, str(tmp), fn, args), nprocs=world, join=True)
    outs = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]
    for r, out in enumerate(outs):
        if isinstance(out, dict) and "error" in out:
            raise RuntimeError(f"rank {r} failed:\n{out['error']}")
    return outs


# ---------------------------------------------------------------------------
# rank functions


class Writer:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, int(step), float(value)))


def _runner(cfg: dict, model_cfg: dict, params):
    from qa_tiger_tpu_torch.training import AVQARunner
    from qa_tiger_tpu_torch.utils import Box

    return AVQARunner(Box(cfg), model_cfg, device="cpu", seed=0, init_params=params)


def _dataset(cfg: dict, mode: str):
    from qa_tiger_tpu_torch.data import AVQADataset
    from qa_tiger_tpu_torch.utils import Box

    return AVQADataset(Box(cfg), mode=mode)


def _trainable(runner) -> dict:
    return {n: p.detach().numpy().copy() for n, p in runner.trainable()}


def train_epoch(rank: int, cfg: dict, model_cfg: dict, params) -> dict:
    """One epoch of ``cfg``'s train split on this rank's shard (batch
    ``batch_size // world``, shuffled from ``cfg['seed']``), the attention
    dropout of QstGrounding and TempMoE off (``model_cfg``'s ``dropout``
    rules the other sites): the logged losses, the trainable parameters,
    their last gradients and the dropout stream's state."""
    from qa_tiger_tpu_torch.data import BatchLoader
    from qa_tiger_tpu_torch.models import modules

    modules.ATTN_DROPOUT = 0.0

    world = dist.get_world_size()
    loader = BatchLoader(_dataset(cfg, "train"), cfg["data"]["batch_size"] // world,
                         shuffle=True, seed=cfg["seed"], shard_id=rank, num_shards=world)
    runner = _runner(cfg, model_cfg, params)
    writer = Writer()
    runner.train_epoch(1, loader, cfg["hyper_params"]["optim"]["lr"], writer)
    return {"scalars": writer.scalars, "params": _trainable(runner),
            "grads": {n: p.grad.numpy().copy() for n, p in runner.trainable()
                      if p.grad is not None},
            "step_rng": runner._step_generator.get_state(), "steps": len(loader)}


def run_eval(rank: int, cfg: dict, model_cfg: dict, params) -> tuple:
    """``_run_eval`` over this rank's shard of the test split, at
    ``eval_batch_size // world`` rows per batch."""
    from qa_tiger_tpu_torch.data import BatchLoader

    world = dist.get_world_size()
    loader = BatchLoader(_dataset(cfg, "test"), cfg["data"]["eval_batch_size"] // world,
                         shard_id=rank, num_shards=world)
    loss, cor, tot, cor9, tot9 = _runner(cfg, model_cfg, params)._run_eval(loader, debug=False)
    return loss, cor, tot, np.asarray(cor9), np.asarray(tot9), len(loader)


def shard_logits(rank: int, cfg: dict, model_cfg: dict, params) -> list:
    """The eval logits of each batch of this rank's shard of the test
    split, computed under the process group."""
    from qa_tiger_tpu_torch.data import BatchLoader

    world = dist.get_world_size()
    loader = BatchLoader(_dataset(cfg, "test"), cfg["data"]["eval_batch_size"] // world,
                         shard_id=rank, num_shards=world)
    runner = _runner(cfg, model_cfg, params)
    with torch.no_grad():
        return [runner.model(runner._device_batch(b))["out"].numpy() for b in loader]


def train_main(rank: int, argv: list, env: dict) -> dict:
    """``train.main(argv)`` as a torchrun rank (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK`` and ``env`` set; the process group the spawner made is
    the one ``--distributed`` keeps): the summary, and for each runner the
    entry point built, its parameters right after ``restore_train_state``
    and at the end."""
    from qa_tiger_tpu_torch import train

    os.environ.update(env, RANK=str(rank), WORLD_SIZE=str(dist.get_world_size()),
                      LOCAL_RANK=str(rank))
    runners, restored = [], []
    build = train.build_runner

    def recording_build(cfg, device):
        runner = build(cfg, device)
        restore = runner.restore_train_state

        def recording_restore(state):
            out = restore(state)
            restored.append(_trainable(runner))
            return out

        runner.restore_train_state = recording_restore
        runners.append(runner)
        return runner

    train.build_runner = recording_build
    try:
        summary = train.main(argv)
    finally:
        train.build_runner = build
    return {"summary": summary, "restored": restored,
            "final": [_trainable(r) for r in runners]}
