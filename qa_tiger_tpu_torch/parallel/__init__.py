"""Data parallelism over ``torch.distributed``. Port of
``qa_tiger_tpu/parallel`` (its tensor-parallel layout hints excepted:
ROADMAP.md A7b)."""
from qa_tiger_tpu_torch.parallel.dist import (
    all_reduce_grads,
    all_reduce_sum,
    backend,
    broadcast_params,
    distributed,
    init_distributed,
    is_main,
    local_rank,
    rank,
    shutdown,
    sync_processes,
    world,
)

__all__ = [
    "all_reduce_grads",
    "all_reduce_sum",
    "backend",
    "broadcast_params",
    "distributed",
    "init_distributed",
    "is_main",
    "local_rank",
    "rank",
    "shutdown",
    "sync_processes",
    "world",
]
