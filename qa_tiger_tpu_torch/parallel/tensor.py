"""Tensor parallelism over a data x model process grid.

The counterpart of ``qa_tiger_tpu/parallel/mesh.py:38-114``: JAX builds a
``('data', 'model')`` mesh (``make_mesh(n, model_parallel=tp)``) and lets
GSPMD split Megatron-style (``param_shardings``): column splits of
``in_proj_*``, ``linear1``, ``c_fc`` and Sequential index ``0``, row splits
of ``out_proj``, ``linear2``, ``c_proj`` and index ``2``. GSPMD gathers
whatever a Pallas call cannot split, so there the layout is a hint and the
numbers do not change. This package has no GSPMD: each fused kernel is
split at the point where the all-reduce falls (the ``*_partial`` /
``*_tp_*`` stages of ``ops``), each rank computes an fp32 partial over its
shard, the model group sums the partials, and one epilogue rounds the
value once, where the single-rank kernel rounds it:

- ``make_grid(model_parallel)``: the process grid of an initialised process
  group, ``mesh.py:50``'s layout (global rank = data_rank * tp +
  model_rank), one ``data_group`` and one ``model_group`` per rank;
- ``tp_spec(name, shape, tp)``: this package's copy of ``_spec_for``
  (``mesh.py:68-96``) with two deliberate differences (ROADMAP.md §C):
  ``in_proj_weight`` / ``in_proj_bias`` split by head (``QKV``: each rank
  takes rows [r D/tp, (r+1) D/tp) of each of q, k and v, so it can run its
  heads' attention alone, or, for one head (TSPM's 512-lane attentions),
  its lanes of the head, whose fp32 partial scores the group sums; JAX's
  ``P('model', None)`` on the stacked [3D, D] would give rank 0 all of q
  and half of k), and a column Linear with no
  row partner stays replicated (``gauss_pred.0`` and ``router.0``, the
  single-Linear Sequentials whose outputs feed the router math whole);
- ``shard_state_dict`` / ``gather_state_dict`` / ``shard_module_``: a
  rank's shard of a whole state dict, the whole one back from the shards
  and the whole shapes (bitwise), and a module's parameters replaced by
  their shards;
- ``reduce_from_model`` / ``copy_to_model``: the model group's collectives
  made differentiable (Megatron's pair); ``row_linear``, a row-parallel
  Linear's partial summed over the group and rounded once.
  ``reduce_from_model`` sums a partial over the model group (in place
  without autograd) and passes the gradient through; ``copy_to_model``
  passes a replicated input through and sums its gradient over the model
  group, so that every model rank ends with the whole input gradient and
  every replicated parameter upstream gets the same gradient on each rank;
- ``head_lanes`` / ``column_shard``: a rank's share of a dropout mask drawn
  whole (its heads' lanes of a probability mask, re-padded to the kernels'
  128-lane width; its columns of a hidden activation's mask), so that every
  rank draws the same realization from the same stream.

The counters and the train step's valid counts and gradients are summed
over the data group only (``Grid.reduce_data``): every model rank of a data
rank holds the same rows.
"""
from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from qa_tiger_tpu_torch.parallel.dist import all_reduce_sum, distributed

# the specs: per dimension, "model" (split over the model axis) or None;
# QKV splits dimension 0 of a stacked [q; k; v] by head
COL = ("model", None)
ROW = (None, "model")
VEC = ("model",)
QKV = ("model:qkv", None)
QKV_VEC = ("model:qkv",)
REPLICATED = ()

_COL_KEYS = ("linear1", "c_fc", "0")  # leaf parent names, as mesh.py:65
_ROW_KEYS = ("linear2", "c_proj", "2")
# single-Linear Sequentials: their "0" has no row partner
_SOLO = ("gauss_pred", "router")


@dataclass(frozen=True, eq=False)
class Grid:
    """This rank's place in the data x model grid and its two groups.
    ``Grid()`` is one process (no groups). A subclass may reduce and gather
    by other means (the tests simulate ranks as threads)."""

    data_rank: int = 0
    data_size: int = 1
    model_rank: int = 0
    model_size: int = 1
    data_group: Any = None
    model_group: Any = None

    def reduce_model(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the model group, in place."""
        dist.all_reduce(t, group=self.model_group)
        return t

    def gather_model(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every model rank's ``t`` (same shape on each), in rank order, on
        ``t``'s device (gloo gathers on the host)."""
        on_host = dist.get_backend(self.model_group) != "nccl"
        src = (t.cpu() if on_host else t).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.model_size)]
        dist.all_gather(parts, src, group=self.model_group)
        return [p.to(t.device) for p in parts]

    def reduce_data(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """``tensors`` summed over the data group (``all_reduce_sum``)."""
        return all_reduce_sum(tensors, group=self.data_group)

    @property
    def loader_shard(self) -> dict:
        """``BatchLoader``'s sharding for this rank: over the data axis, so
        the model ranks of one data rank read the same rows."""
        return {"shard_id": self.data_rank, "num_shards": self.data_size}


def make_grid(model_parallel: int = 1) -> Grid:
    """The grid of the process group that is up: ``world // model_parallel``
    data ranks of ``model_parallel`` model ranks each, global rank =
    data_rank * model_parallel + model_rank. Every rank must call it (the
    groups are made in the same order on each). Without a process group,
    ``Grid()`` at model_parallel 1; raises when the world is not a multiple
    of ``model_parallel`` (``mesh.py:46-48``)."""
    tp = int(model_parallel)
    if tp < 1:
        raise ValueError(f"model_parallel must be >= 1, got {model_parallel}")
    if not distributed():
        if tp != 1:
            raise RuntimeError(f"model_parallel={tp} needs a process group of at least "
                               f"{tp} ranks")
        return Grid()
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % tp:
        raise ValueError(f"{world} ranks not divisible by model_parallel={tp}")
    data_size = world // tp
    model_groups = [dist.new_group(list(range(d * tp, (d + 1) * tp))) for d in range(data_size)]
    data_groups = [dist.new_group(list(range(m, world, tp))) for m in range(tp)]
    return Grid(data_rank=rank // tp, data_size=data_size, model_rank=rank % tp,
                model_size=tp, data_group=data_groups[rank % tp],
                model_group=model_groups[rank // tp])


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid):
        return grid.reduce_model(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid):
        ctx.grid = grid
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.grid.reduce_model(g.clone()), None


def reduce_from_model(t: torch.Tensor, grid: Grid) -> torch.Tensor:
    """A partial summed over the model group; its gradient passes through
    unchanged (every rank's partial gets the whole, replicated gradient).
    Without autograd it sums ``t`` in place; ``t`` itself at model size 1."""
    if grid.model_size <= 1:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return _ReduceFromModel.apply(t, grid)
    return grid.reduce_model(t)


def row_linear(h: torch.Tensor, lin, grid: Grid) -> torch.Tensor:
    """A row-parallel Linear on one model rank: h [.., H/tp] against the
    rank's weight columns (``lin.weight`` [out, H/tp]), the fp32 partial
    summed over the model group, then round(sum + bias) in h's dtype."""
    part = reduce_from_model(torch.nn.functional.linear(h.float(), lin.weight.float()), grid)
    return (part + lin.bias.float()).to(h.dtype)


def copy_to_model(t: torch.Tensor, grid: Grid) -> torch.Tensor:
    """A replicated input of a model-parallel block: ``t`` itself forward;
    backward, its gradient (each rank's partial: the block's column shards)
    summed over the model group. ``t`` itself at model size 1 or without
    autograd."""
    if grid.model_size <= 1 or not (torch.is_grad_enabled() and t.requires_grad):
        return t
    return _CopyToModel.apply(t, grid)


def _pad128(n: int) -> int:
    return -(-n // 128) * 128


def head_lanes(mask: torch.Tensor, heads: int, keys: int, rank: int, tp: int) -> torch.Tensor:
    """Model rank ``rank``'s share of a probability mask [rows, pad128(heads
    keys)] (lane h keys + key): the lanes of its heads/tp heads,
    [r heads/tp keys, (r+1) heads/tp keys), zero-padded again to
    pad128(heads/tp keys), contiguous."""
    width = heads // tp * keys
    part = mask[:, rank * width:(rank + 1) * width]
    return torch.nn.functional.pad(part, (0, _pad128(width) - width)).contiguous()


def column_shard(t: torch.Tensor, rank: int, tp: int) -> torch.Tensor:
    """Model rank ``rank``'s columns of ``t`` [..., C] (a column split's
    activation or its mask), contiguous."""
    return t.chunk(tp, dim=-1)[rank].contiguous()


def tp_spec(name: str, shape, tp: int) -> tuple:
    """How the parameter ``name`` (a dotted state_dict name) of ``shape`` is
    split over ``tp`` model ranks: COL, ROW, VEC, QKV, QKV_VEC or
    REPLICATED. ``mesh.py``'s ``_spec_for`` but for the head-aligned
    ``in_proj_*`` (QKV, QKV_VEC: D = shape[0] / 3 must divide by tp) and
    the replicated ``gauss_pred.0`` / ``router.0``. A dimension that does
    not divide by tp is replicated, as in JAX."""
    shape = tuple(shape)
    parts = name.split(".")
    if tp <= 1 or len(parts) < 2:
        return REPLICATED
    parent, leaf = parts[-2], parts[-1]
    if leaf in ("in_proj_weight", "in_proj_bias") and shape[0] % (3 * tp) == 0:
        return QKV if leaf == "in_proj_weight" else QKV_VEC
    if parent in _COL_KEYS and not (parent == "0" and len(parts) >= 3 and parts[-3] in _SOLO):
        if leaf == "weight" and len(shape) == 2 and shape[0] % tp == 0:
            return COL
        if leaf == "bias" and len(shape) == 1 and shape[0] % tp == 0:
            return VEC
    if (parent in _ROW_KEYS or parent == "out_proj") and leaf == "weight" \
            and len(shape) == 2 and shape[1] % tp == 0:
        return ROW
    return REPLICATED


def take_shard(t: torch.Tensor, spec: tuple, rank: int, tp: int) -> torch.Tensor:
    """Model rank ``rank``'s shard of ``t`` under ``spec``, contiguous."""
    if spec in (COL, VEC):
        return t.chunk(tp, dim=0)[rank].contiguous()
    if spec == ROW:
        return t.chunk(tp, dim=1)[rank].contiguous()
    if spec in (QKV, QKV_VEC):
        d = t.shape[0] // 3
        return t.reshape(3, d, *t.shape[1:]).chunk(tp, dim=1)[rank] \
            .reshape(3 * d // tp, *t.shape[1:]).contiguous()
    return t


def merge_shards(shards: list[torch.Tensor], spec: tuple) -> torch.Tensor:
    """The whole tensor from every model rank's shard, in rank order (the
    inverse of ``take_shard``)."""
    if spec in (COL, VEC):
        return torch.cat(shards, dim=0)
    if spec == ROW:
        return torch.cat(shards, dim=1)
    if spec in (QKV, QKV_VEC):
        rest = shards[0].shape[1:]
        d = shards[0].shape[0] // 3
        return torch.cat([s.reshape(3, d, *rest) for s in shards], dim=1) \
            .reshape(3 * d * len(shards), *rest)
    return shards[0]


def shard_state_dict(sd: Mapping[str, torch.Tensor], grid: Grid) -> dict[str, torch.Tensor]:
    """``grid``'s rank's shard of the whole state dict ``sd`` (names as
    ``tp_spec`` reads them); ``sd`` itself at model size 1."""
    tp = grid.model_size
    if tp <= 1:
        return dict(sd)
    return {n: take_shard(t, tp_spec(n, t.shape, tp), grid.model_rank, tp)
            for n, t in sd.items()}


def gather_state_dict(local: Mapping[str, torch.Tensor], grid: Grid,
                      shapes: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The whole state dict from every model rank's ``local`` shard (a
    collective over the model group), bitwise the one sharded; ``shapes``
    gives each parameter's whole shape, which decides its spec (a shard's
    own shape cannot: a dimension that does not divide stays whole).
    ``local`` itself at model size 1."""
    tp = grid.model_size
    if tp <= 1:
        return dict(local)
    out = {}
    for name, t in local.items():
        spec = tp_spec(name, shapes[name], tp)
        out[name] = merge_shards(grid.gather_model(t), spec) if spec else t
    return out


@torch.no_grad()
def shard_module_(module: torch.nn.Module, grid: Grid) -> torch.nn.Module:
    """Replace each parameter of ``module`` (whole, as built) by ``grid``'s
    rank's shard, in place; the module at model size 1."""
    tp = grid.model_size
    if tp > 1:
        for name, p in module.named_parameters():
            spec = tp_spec(name, p.shape, tp)
            if spec:
                p.data = take_shard(p.data, spec, grid.model_rank, tp).clone()
    return module
