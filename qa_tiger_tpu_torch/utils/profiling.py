"""Tracing and profiling helpers, PyTorch edition.

Port of ``qa_tiger_tpu/utils/profiling.py``:

- ``trace(logdir, name)``: a ``torch.profiler`` context (CPU activity, and
  CUDA activity where a card is present) that writes a Chrome trace
  (chrome://tracing, Perfetto; ``python -m qa_tiger_tpu_torch.trace_summary``
  reads it) to ``logdir/name`` on exit, after the card has finished the
  traced work; a no-op when ``logdir`` is empty. It yields the profiler, so
  that a caller can also read ``key_averages()`` after the block. The
  port's trace writers (``bench_train --trace``, ``train_epoch``'s
  ``profile_dir``, ``profile_stages --trace``) all go through it.
- ``annotate(name)``: a named region in the trace
  (``torch.profiler.record_function``).
- ``AverageMeter``: running means per key (reference src/trainutils.py:29-44).
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from collections.abc import Iterable, Iterator
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str | Path | None, name: str = TRACE_FILE
          ) -> Iterator[profile | None]:
    """Profile the block and write its Chrome trace to ``logdir/name``
    (no-op, yielding None, when ``logdir`` is empty)."""
    if not logdir:
        yield None
        return
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        path = Path(logdir)
        path.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path / name))


def annotate(name: str) -> record_function:
    """A named region that shows up in the profiler's timeline."""
    return record_function(name)


class AverageMeter:
    """Running means over named values (reference src/trainutils.py:29-44)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.values = defaultdict(float)
        self.count = 0

    def update(self, vals: Iterable[tuple[str, float]], step_n: int) -> None:
        for key, val in vals:
            self.values[key] += float(val)
        self.count += step_n

    def get(self, key: str) -> float:
        return self.values[key] / max(self.count, 1)
