"""Throughput benchmark harness, PyTorch edition.

Port of ``qa_tiger_tpu/utils/benchmark.py`` (the reference's
``tome.utils.benchmark``, src/tome/utils.py:15-77): the steady-state
throughput of a function, a warm-up fraction of the runs discarded.

- The first call (the kernels' build or load, the allocator's first
  requests) and the warm-up runs are outside the clock.
- The clock stops only after the last call's outputs have been read back to
  the host: CUDA calls return before the card has run them.
- ``use_bf16`` casts the floating tensors among the arguments to bfloat16
  (the reference's fp16 autocast flag; the JAX package's bf16 cast).
"""
from __future__ import annotations

import time
from collections.abc import Callable

import torch


def _cast_bf16(obj):
    if torch.is_tensor(obj):
        return obj.to(torch.bfloat16) if obj.is_floating_point() else obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cast_bf16(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _cast_bf16(v) for k, v in obj.items()}
    return obj


def tensor_leaves(obj):
    """The tensors of a tensor or of a nest of lists, tuples and dicts."""
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from tensor_leaves(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from tensor_leaves(o)


def _materialize(out) -> None:
    """Read every tensor of ``out`` back to the host."""
    for t in tensor_leaves(out):
        t.cpu()


def benchmark(fn: Callable, *args, runs: int = 40, throw_out: float = 0.25,
              use_bf16: bool = False, items_per_call: int = 1, verbose: bool = False,
              **kwargs) -> float:
    """Items per second of ``fn(*args, **kwargs)`` at steady state.

    ``throw_out``: the fraction of the runs discarded as warm-up (the
    reference's default 0.25, at least one run). ``items_per_call``: e.g.
    the batch size, so that the result is images/s or qa-pairs/s."""
    if use_bf16:
        args, kwargs = _cast_bf16(args), _cast_bf16(kwargs)
    warmup = max(1, int(runs * throw_out))
    timed = runs - warmup
    if timed < 1:
        raise ValueError(f"runs={runs} leaves no timed run after {warmup} warm-up runs")
    _materialize(fn(*args, **kwargs))
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    _materialize(out)

    start = time.perf_counter()
    for _ in range(timed):
        out = fn(*args, **kwargs)
    _materialize(out)
    elapsed = time.perf_counter() - start
    ips = items_per_call * timed / elapsed
    if verbose:
        print(f"Throughput: {ips:.2f} items/sec ({elapsed / timed * 1e3:.3f} ms/call)")
    return ips
