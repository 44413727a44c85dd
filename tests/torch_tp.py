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
        return t.copy_(sum_in_rank_order(self.bus.exchange(self.model_rank, t)))

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


def sum_in_rank_order(parts: list) -> torch.Tensor:
    """The ranks' partials summed in rank order, as ``ThreadGrid`` sums
    them."""
    total = parts[0].clone()
    for part in parts[1:]:
        total += part
    return total


def sharded(module: torch.nn.Module, grid: Grid) -> torch.nn.Module:
    """A copy of ``module`` holding ``grid``'s rank's shards."""
    return shard_module_(copy.deepcopy(module), grid)


# ---------------------------------------------------------------------------
# rank functions (torch_dp.spawn)


def tp_eval(rank: int, cfg: dict, model_cfg: dict, params, tp: int) -> dict:
    """``_run_eval`` over the test split on a grid of ``model_parallel=tp``:
    the counters, the batch count, whether ``params()`` gathers back the
    loaded weights bitwise, then one train step's loss (or the error it
    raises)."""
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
    train_error, train_loss = None, None
    try:
        train_loss = float(runner.train_step(next(iter(loader)), 1e-3)["total_loss"])
    except NotImplementedError as exc:
        train_error = str(exc)
    return {"eval": (loss, cor, tot, np.asarray(cor9), np.asarray(tot9)),
            "batches": len(loader), "params_bitwise": bitwise, "train_error": train_error,
            "train_loss": train_loss,
            "grid": (grid.data_rank, grid.data_size, grid.model_rank, grid.model_size),
            "world": dist.get_world_size()}


def _train_runner(cfg: dict, model_cfg: dict, params, grid, seed: int = 0):
    from qa_tiger_tpu_torch.training import AVQARunner
    from qa_tiger_tpu_torch.utils import Box

    return AVQARunner(Box(cfg), model_cfg, device="cpu", seed=seed, init_params=params, grid=grid)


def _whole(runner, tensors: dict) -> dict:
    """``tensors`` (this rank's shards, by parameter name) gathered to whole
    numpy arrays (a collective over the model group)."""
    from qa_tiger_tpu_torch.parallel import gather_state_dict

    local = {n: t.detach() for n, t in tensors.items()}
    if runner.grid is not None and runner.grid.model_size > 1:
        local = gather_state_dict(local, runner.grid, runner._whole_shapes)
    return {n: t.numpy().copy() for n, t in local.items()}


def _replicated(runner) -> dict:
    """This rank's replicated trainable parameters (whole on every model
    rank), by name."""
    from qa_tiger_tpu_torch.parallel import tp_spec

    tp = runner.grid.model_size
    return {n: p.detach().numpy().copy() for n, p in runner.trainable()
            if not tp_spec(n, runner._whole_shapes[n], tp)}


def train_epoch(rank: int, cfg: dict, model_cfg: dict, params, tp: int) -> dict:
    """One epoch of ``cfg``'s train split on a grid of ``model_parallel=tp``
    (this data rank's shard, ``batch_size // data_size`` rows, shuffled from
    ``cfg['seed']``), QstGrounding's and TempMoE's attention dropout off:
    the logged losses, the trainable parameters and their last gradients
    gathered whole, and the replicated parameters as this rank holds them."""
    from qa_tiger_tpu_torch.data import AVQADataset, BatchLoader
    from qa_tiger_tpu_torch.models import modules
    from qa_tiger_tpu_torch.utils import Box

    import torch_dp

    modules.ATTN_DROPOUT = 0.0
    grid = make_grid(tp)
    loader = BatchLoader(AVQADataset(Box(cfg), mode="train"),
                         cfg["data"]["batch_size"] // grid.data_size, shuffle=True,
                         seed=cfg["seed"], **grid.loader_shard)
    runner = _train_runner(cfg, model_cfg, params, grid)
    writer = torch_dp.Writer()
    runner.train_epoch(1, loader, cfg["hyper_params"]["optim"]["lr"], writer)
    trainable = dict(runner.trainable())
    return {"scalars": writer.scalars, "params": _whole(runner, trainable),
            "grads": _whole(runner, {n: p.grad for n, p in trainable.items()
                                     if p.grad is not None}),
            "replicated": _replicated(runner), "steps": len(loader),
            "grid": (grid.data_rank, grid.data_size, grid.model_rank, grid.model_size)}


def train_steps(rank: int, cfg: dict, model_cfg: dict, params, batches: list, lr: float,
                state_dir: str, single_state: str) -> dict:
    """dp1 x tp2, dropout on, from seed 0: three ``train_step`` calls from
    the runner's step generator (the losses, the first step's gradients
    gathered, the replicated parameters after the third, the launch and
    stage counts), the train state after the second step saved to
    ``state_dir`` (by rank 0) and restored into a fresh grid runner for a
    third step (resume within one grid), and the single process's state
    ``single_state`` restored into another for one step (the losses and the
    parameters gathered)."""
    from qa_tiger_tpu_torch import ops
    from qa_tiger_tpu_torch.training.checkpoint import load_train_state, save_train_state

    grid = make_grid(2)
    runner = _train_runner(cfg, model_cfg, params, grid)
    losses, first_grads, state = [], None, None
    ops.reset_launches()
    for i, batch in enumerate(batches):
        if i == 2:
            state = runner.train_state(epoch=1)
            if rank == 0:
                save_train_state(state, state_dir)
            dist.barrier()
        losses.append({k: float(v) for k, v in runner.train_step(
            batch, lr, runner._step_generator).items()})
        if i == 0:
            first_grads = _whole(runner, {n: p.grad for n, p in runner.trainable()
                                          if p.grad is not None})
            launches, stages = ops.launch_counts(), ops.stage_counts()
    final = {n: p.detach().clone() for n, p in runner.trainable()}
    out = {"losses": losses, "first_grads": first_grads, "launches": launches,
           "stages": stages, "replicated": _replicated(runner),
           "params": _whole(runner, final)}

    resumed = _train_runner(cfg, model_cfg, params, grid, seed=5)
    resumed.restore_train_state(load_train_state(state_dir))
    out["resume_loss"] = {k: float(v) for k, v in resumed.train_step(
        batches[2], lr, resumed._step_generator).items()}
    out["resume_bitwise"] = all(torch.equal(p, final[n]) for n, p in resumed.trainable())
    out["resume_rng_equal"] = torch.equal(resumed._step_generator.get_state(),
                                          runner._step_generator.get_state())

    crossed = _train_runner(cfg, model_cfg, params, grid, seed=6)
    crossed.restore_train_state(load_train_state(single_state))
    out["from_single_loss"] = {k: float(v) for k, v in crossed.train_step(
        batches[2], lr, crossed._step_generator).items()}
    out["from_single_params"] = _whole(crossed, dict(crossed.trainable()))
    return out


def model_size_one(rank: int, cfg: dict, model_cfg: dict, params) -> dict:
    """One epoch at world 2 with a grid of model size 1 and again without a
    grid (the data-parallel step), dropout on: the logged losses, the
    trainable parameters and the dropout stream of each."""
    from qa_tiger_tpu_torch.data import AVQADataset, BatchLoader
    from qa_tiger_tpu_torch.utils import Box

    import torch_dp

    out = {}
    for name, grid in (("grid", make_grid(1)), ("plain", None)):
        loader = BatchLoader(AVQADataset(Box(cfg), mode="train"),
                             cfg["data"]["batch_size"] // 2, shuffle=True, seed=cfg["seed"],
                             shard_id=rank, num_shards=2)
        runner = _train_runner(cfg, model_cfg, params, grid, seed=3)
        writer = torch_dp.Writer()
        runner.train_epoch(1, loader, cfg["hyper_params"]["optim"]["lr"], writer)
        out[name] = {"scalars": writer.scalars,
                     "params": {n: p.detach().clone() for n, p in runner.trainable()},
                     "rng": runner._step_generator.get_state()}
    return out


class ListLoader(list):
    """Host batches in a list: what ``train_epoch`` takes of a loader."""

    def set_epoch(self, epoch):
        pass


def eval_and_train(rank: int, cfg: dict, model_cfg: dict, params, tp: int) -> dict:
    """``tp_eval`` then ``train_epoch`` on grids of ``model_parallel=tp``,
    in one spawn."""
    return {"eval": tp_eval(rank, cfg, model_cfg, params, tp),
            "train": train_epoch(rank, cfg, model_cfg, params, tp)}


def window_epochs(rank: int, cfg: dict, model_cfg: dict, params, batches: list,
                  k: int) -> dict:
    """dp1 x tp2, dropout on: one epoch over ``batches`` (host batches, in
    order) at ``steps_per_dispatch`` 1 and again, from the same seed, at
    ``k`` (the step graph's static-input step, run eagerly as on the CPU):
    each run's logged losses, its parameters and Adam moments as this rank
    holds them, its dropout stream and whether the window went through the
    step graph; then the error of a ``StepGraph`` that would capture under
    gloo."""
    from qa_tiger_tpu_torch.training.step_graph import StepGraph

    import torch_dp

    grid = make_grid(2)
    out = {}
    for key, steps in (("k1", 1), ("k", k)):
        run_cfg = copy.deepcopy(cfg)
        run_cfg["hyper_params"]["steps_per_dispatch"] = steps
        runner = _train_runner(run_cfg, model_cfg, params, grid)
        writer = torch_dp.Writer()
        runner.train_epoch(1, ListLoader(batches), run_cfg["hyper_params"]["optim"]["lr"],
                           writer)
        state = runner.optimizer.state
        out[key] = {"scalars": writer.scalars,
                    "params": {n: p.detach().clone() for n, p in runner.trainable()},
                    "moments": {n: [state[p][m].clone() for m in ("exp_avg", "exp_avg_sq")]
                                for n, p in runner.trainable() if p in state},
                    "rng": runner._step_generator.get_state(),
                    "graph": runner._step_graph is not None,
                    "replicated": _replicated(runner)}
    try:
        StepGraph(lambda batch, sites: {}, runner.stage_batch(batches[0]), accum=1,
                  device=torch.device("cpu"), capture=True)
        out["capture_error"] = None
    except RuntimeError as exc:
        out["capture_error"] = str(exc)
    return out
