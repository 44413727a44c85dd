"""Tensor-parallel ranks for the port's tests, without JAX.

``run_ranks(tp, fn)`` simulates the ``tp`` model ranks of one data rank as
threads of this process: each calls ``fn(grid)`` with a ``ThreadGrid``
whose model-group sum adds every rank's tensor in rank order (so the ranks
end bitwise equal) and whose gather hands each rank every rank's tensor.
The rank functions below run in spawned gloo processes (``torch_dp.spawn``)
under a real ``parallel.make_grid``.
"""
from __future__ import annotations

import copy
import threading
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from qa_tiger_tpu_torch.parallel import Grid, make_grid, shard_module_

TIMEOUT = 120.0


class Bus:
    """Where the threads of ``run_ranks`` meet: each posts a tensor, waits
    for the others, reads them all, and waits again before the next
    exchange."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n, timeout=TIMEOUT)
        self.slots: list = [None] * n

    def exchange(self, rank: int, t: torch.Tensor) -> list[torch.Tensor]:
        self.slots[rank] = t.clone()
        self.barrier.wait()
        parts = list(self.slots)
        self.barrier.wait()
        return parts


@dataclass(frozen=True, eq=False)
class ThreadGrid(Grid):
    bus: Any = None

    def reduce_model(self, t: torch.Tensor) -> torch.Tensor:
        parts = self.bus.exchange(self.model_rank, t)
        total = parts[0].clone()
        for part in parts[1:]:
            total += part
        return t.copy_(total)

    def gather_model(self, t: torch.Tensor) -> list[torch.Tensor]:
        return self.bus.exchange(self.model_rank, t)


def run_ranks(tp: int, fn) -> list:
    """``fn(grid)`` on ``tp`` threads, one per model rank; their results in
    rank order. A rank that raised raises here."""
    bus = Bus(tp)
    results: list = [None] * tp
    errors: list = []

    def body(rank: int) -> None:
        try:
            results[rank] = fn(ThreadGrid(model_rank=rank, model_size=tp, bus=bus))
        except BaseException as exc:  # re-raised below, after the join
            errors.append(exc)
            bus.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a simulated rank hung"
    if errors:
        raise errors[0]
    return results


def sharded(module: torch.nn.Module, grid: Grid) -> torch.nn.Module:
    """A copy of ``module`` holding ``grid``'s rank's shards."""
    return shard_module_(copy.deepcopy(module), grid)


# ---------------------------------------------------------------------------
# rank functions (torch_dp.spawn)


def tp_eval(rank: int, cfg: dict, model_cfg: dict, params, tp: int) -> dict:
    """``_run_eval`` over the test split on a grid of ``model_parallel=tp``:
    the counters, the batch count, whether ``params()`` gathers back the
    loaded weights bitwise, and the error a train step raises."""
    from qa_tiger_tpu_torch.convert import params_from_jax
    from qa_tiger_tpu_torch.data import AVQADataset, BatchLoader
    from qa_tiger_tpu_torch.training import AVQARunner
    from qa_tiger_tpu_torch.utils import Box

    grid = make_grid(tp)
    box = Box(cfg)
    loader = BatchLoader(AVQADataset(box, mode="test"),
                         cfg["data"]["eval_batch_size"] // grid.data_size, **grid.loader_shard)
    runner = AVQARunner(box, model_cfg, device="cpu", seed=0, init_params=params, grid=grid)
    loss, cor, tot, cor9, tot9 = runner._run_eval(loader, debug=False)
    whole = params_from_jax(params)
    gathered = runner.params
    bitwise = set(gathered) == set(whole) and all(
        torch.equal(gathered[n], whole[n]) for n in whole)
    train_error = None
    try:
        runner.train_step(next(iter(loader)), 1e-3)
    except NotImplementedError as exc:
        train_error = str(exc)
    return {"eval": (loss, cor, tot, np.asarray(cor9), np.asarray(tot9)),
            "batches": len(loader), "params_bitwise": bitwise, "train_error": train_error,
            "grid": (grid.data_rank, grid.data_size, grid.model_rank, grid.model_size),
            "world": dist.get_world_size()}
