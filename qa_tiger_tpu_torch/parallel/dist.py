"""Data parallelism over ``torch.distributed``: one process per card.

This package's counterpart of ``qa_tiger_tpu/parallel/mesh.py``. The JAX
package shards each batch over a ``('data', 'model')`` mesh and lets GSPMD
insert the reductions; the upstream reference's distributed surface is DDP
over NCCL with its losses and counters all-reduced (SURVEY.md §2.6). Here,
as in the reference, each process owns one card (``cuda:LOCAL_RANK``), reads
its own strided shard of every batch, and the runner reduces explicitly:

- ``init_distributed(platform)``: the process group of a ``torchrun``
  launch (``python -m torch.distributed.run --nproc-per-node N ...``), read
  from ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` with
  ``init_method="env://"``; NCCL on the card, gloo with ``platform='cpu'``;
- ``rank()``, ``world()``, ``local_rank()``, ``is_main()``,
  ``distributed()`` and ``backend()``: 0, 1, 0, True, False and None
  without a process group;
- ``sync_processes(name)``: a barrier, a no-op on one process
  (``mesh.py:29-35``); ``shutdown()`` leaves the process group;
- ``all_reduce_grads(params, extra, group=)``: every gradient of ``params``
  and the scalars of ``extra`` summed over the ranks (of ``group``: under a
  data x model grid its data group) in one flat fp32 buffer, one
  collective per call, the parameters in the order given (the same on
  every rank); the gradients become views of the reduced buffer;
- ``all_reduce_sum(tensors)``: tensors of any dtype summed over the ranks
  in one float64 buffer (the eval counters: integers stay exact below
  2**53);
- ``broadcast_params(module)``: rank 0's parameters and buffers to every
  rank, at start-up.

The tensor-parallel layout of ``mesh.py:38-114`` (``make_mesh(n,
model_parallel=tp)``, ``param_shardings``) is ``parallel/tensor.py``'s:
``make_grid``, ``tp_spec``, the state-dict sharding and the model-group
all-reduce of the eval forward's tensor-parallel forms.
"""
from __future__ import annotations

import os
from collections.abc import Iterable, Mapping, Sequence

import torch
import torch.distributed as dist

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def distributed() -> bool:
    """True when a process group is up."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def world() -> int:
    return dist.get_world_size() if distributed() else 1


def local_rank() -> int:
    """This process's card on its host: torchrun's ``LOCAL_RANK``, 0
    without one."""
    return int(os.environ.get("LOCAL_RANK", 0)) if distributed() else 0


def is_main() -> bool:
    return rank() == 0


def backend() -> str | None:
    return str(dist.get_backend()) if distributed() else None


def init_distributed(platform: str | None) -> None:
    """Join the process group of a torchrun launch: gloo for
    ``platform='cpu'``, else NCCL with this process on ``cuda:LOCAL_RANK``.
    A process group that is already up is kept. Raises when the torchrun
    environment is missing, or NCCL is asked for without a card."""
    if distributed():
        return
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed needs the environment torchrun sets ({', '.join(missing)} "
            "missing): launch with `python -m torch.distributed.run --nproc-per-node N "
            "-m qa_tiger_tpu_torch.train --config C --distributed`")
    if platform == "cpu":
        dist.init_process_group("gloo", init_method="env://")
        return
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path on the CPU")
    device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method="env://", device_id=device)


def shutdown() -> None:
    """Leave the process group, if one is up (the end of a torchrun
    process)."""
    if distributed():
        dist.destroy_process_group()


def sync_processes(name: str = "barrier") -> None:
    """A barrier over every rank (the reference's dist.barrier); a no-op on
    one process. ``name`` says what it waits for, in the error a hang
    raises."""
    if world() <= 1:
        return
    try:
        if backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
    except RuntimeError as exc:
        raise RuntimeError(f"sync_processes({name!r}) failed: {exc}") from exc


def all_reduce_grads(params: Iterable[torch.nn.Parameter],
                     extra: Mapping[str, torch.Tensor] | None = None,
                     group=None) -> dict[str, torch.Tensor]:
    """Sum the gradients of ``params`` and the scalars of ``extra`` over the
    ranks of ``group`` (all of them by default; under a grid its data group:
    every model rank of a data rank holds the same rows, and a sharded
    parameter's gradient belongs to its model rank) in one fp32 buffer: one
    collective, its layout the order of
    ``params``, which every rank must give alike. A parameter without a
    gradient is left out (which parameters have one is the model's, the
    same on every rank). Each gradient becomes its view of the reduced
    buffer; returns ``extra`` reduced, in its dtypes. Reads nothing back to
    the host, so a CUDA graph may capture it (over NCCL)."""
    with_grad = [p for p in params if p.grad is not None]
    extra = dict(extra or {})
    flat = torch.cat([p.grad.reshape(-1).float() for p in with_grad]
                     + [v.reshape(1).float() for v in extra.values()])
    dist.all_reduce(flat, group=group)
    offset = 0
    for p in with_grad:
        n = p.numel()
        p.grad = flat[offset:offset + n].view(p.shape).to(p.grad.dtype)
        offset += n
    out = {}
    for key, value in extra.items():
        out[key] = flat[offset].to(value.dtype)
        offset += 1
    return out


def all_reduce_sum(tensors: Sequence[torch.Tensor], group=None) -> list[torch.Tensor]:
    """``tensors`` (on one device) summed over the ranks of ``group`` (all
    of them by default) in one float64 buffer, one collective; returned in
    their shapes and dtypes."""
    flat = torch.cat([t.reshape(-1).double() for t in tensors])
    dist.all_reduce(flat, group=group)
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()].view(t.shape).to(t.dtype))
        offset += t.numel()
    return out


@torch.no_grad()
def broadcast_params(module: torch.nn.Module) -> None:
    """Every parameter and buffer of ``module`` set to rank 0's; a no-op on
    one process."""
    if world() <= 1:
        return
    for tensor in module.state_dict().values():
        dist.broadcast(tensor, src=0)
