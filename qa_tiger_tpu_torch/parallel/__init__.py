"""Data and tensor parallelism over ``torch.distributed``. Port of
``qa_tiger_tpu/parallel``: ``dist`` (one process per card, the data axis)
and ``tensor`` (the data x model grid of the tensor-parallel forms, eval
and train)."""
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
from qa_tiger_tpu_torch.parallel.tensor import (
    Grid,
    column_shard,
    copy_to_model,
    gather_state_dict,
    head_lanes,
    make_grid,
    reduce_from_model,
    shard_module_,
    shard_state_dict,
    tp_spec,
)

__all__ = [
    "Grid",
    "column_shard",
    "copy_to_model",
    "gather_state_dict",
    "head_lanes",
    "make_grid",
    "reduce_from_model",
    "shard_module_",
    "shard_state_dict",
    "tp_spec",
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
