"""``steps_per_dispatch``: the train step as one CUDA graph.

Port of the JAX runner's multi-step dispatch (``qa_tiger_tpu/training/
loop.py``: ``_train_multi``, ``_multi_step_impl``, K steps in one
``lax.scan``). PyTorch's counterpart of one executable per dispatch is a
CUDA graph of one whole train step (the forward with dropout, the loss, the
backward and Adam), replayed once per batch, K batches per window, with no
host read inside a window (``AVQARunner.train_window``).

``StepGraph`` owns the step's static inputs (one batch on the device; with
the question cache, the ``ds_idx`` rows the step gathers itself) and one
persistent generator per dropout site (``SITES`` per microbatch). A call
copies a staged batch into the static inputs, reseeds the site generators
with the seeds an eager step draws from the same stream (``site_seeds``)
and runs the step:

- on the card its first call runs the step eagerly on a side stream (the
  warm-up: Adam's state, the kernels' one-time host setup and cuBLAS's
  handles come into being outside the capture), its second captures the
  step on that stream and replays it, and every later call replays it. The
  site generators are registered with the graph, so a replay draws the
  masks that an eager step seeded the same way draws;
- with ``capture=False`` (the CPU, which has no graphs, or a card run that
  holds the graph against the same step run eagerly) every call runs the
  step eagerly.

The kernel wrappers count their launches in Python, which a replay does not
run: the capture's counts are taken off again and added once per replay
(``ops.add_launches``). A capture that fails raises; nothing falls back to
the eager step.

The step's collectives are captured with it: under data parallelism the
valid count before the forward and the flat gradient buffer after the
backward, under a model axis also the model group's all-reduces of the
tensor-parallel forms (``parallel/tensor.py``). NCCL allows that and gloo
does not, so a graph that captures (``capture=True``) under any backend
but NCCL raises, naming it; the eager static-input step (``capture=False``,
the CPU) runs under any backend. The fake backend of PyTorch's test
utilities (``torch.testing._internal.distributed.fake_pg``, collectives
that do nothing) is let through too: one process can then capture one
rank's whole step on one card, its collectives and all.
"""
from __future__ import annotations

from collections.abc import Callable
from contextlib import nullcontext

import torch

from qa_tiger_tpu_torch import ops, parallel
from qa_tiger_tpu_torch.models.qa_tiger import SITES, split_generator, split_seeds

# the process-group backends whose collectives a CUDA graph can hold (None:
# no process group)
CAPTURABLE_BACKENDS = (None, "nccl", "fake")


def batch_key(batch: dict) -> tuple:
    """The names, shapes and dtypes of a staged batch: a graph's static
    inputs take only batches of its own key."""
    return tuple((k, tuple(v.shape), v.dtype) for k, v in batch.items())


def site_seeds(generator: torch.Generator, accum: int, device,
               sites: int = SITES) -> list[list[int]]:
    """The seeds of one step's dropout sites, one row of ``sites`` (the
    model's ``SITES``, QA-TIGER's by default) per microbatch, drawn from ``generator`` in the order
    an eager step draws them: ``sites`` seeds (the forward's
    ``split_generator``), or with ``accum`` > 1 first ``accum`` microbatch
    generators on ``device`` (as ``AVQARunner._accumulated_backward`` splits
    the stream) and then ``sites`` seeds from each."""
    if accum <= 1:
        return [split_seeds(generator, sites)]
    return [split_seeds(g, sites) for g in split_generator(generator, accum, device)]


class StepGraph:
    """One train step on static inputs, captured as a CUDA graph when
    ``capture``.

    ``step(batch, sites)`` is the step on device tensors: it reads the
    batch, draws dropout from ``sites`` (one list of ``sites`` generators,
    the model's SITES, per microbatch), updates the parameters and returns
    the losses as device scalars. ``batch`` is a staged batch whose key the
    graph takes; ``cache`` the question cache the step gathers from, kept so
    that its owner can tell when the cache changed."""

    def __init__(self, step: Callable, batch: dict, *, accum: int, device: torch.device,
                 capture: bool, cache=None, sites: int = SITES):
        backend = parallel.backend()
        if capture and backend not in CAPTURABLE_BACKENDS:
            raise RuntimeError(
                f"steps_per_dispatch > 1 captures the step's all-reduces in a CUDA graph, "
                f"which the {backend} backend cannot do: run one card per rank over NCCL, "
                "or set steps_per_dispatch to 1")
        self.step = step
        self.key = batch_key(batch)
        self.cache = cache
        self.accum = max(accum, 1)
        self.device = device
        self.capture = capture
        self.static = {k: torch.empty_like(v) for k, v in batch.items()}
        self.n_sites = sites
        self.sites = [[torch.Generator(device=device) for _ in range(sites)]
                      for _ in range(self.accum)]
        self.side = torch.cuda.Stream(device) if capture else None
        self.graph: torch.cuda.CUDAGraph | None = None
        self.warm = False
        self.losses: dict | None = None  # the graph's loss outputs
        self.delta: dict = {}            # the kernel launches of one replay
        self.replays = 0

    def __call__(self, batch: dict, generator: torch.Generator) -> dict:
        """One step on ``batch`` (of this graph's key), its dropout seeded
        from ``generator``; returns the losses as device scalars."""
        seeds = self._seeds(generator)
        for key, value in batch.items():
            self.static[key].copy_(value)
        for gens, row in zip(self.sites, seeds):
            for gen, seed in zip(gens, row):
                gen.manual_seed(seed)
        if not self.capture:
            return self.step(self.static, self.sites)
        if self.graph is None:
            if not self.warm:
                self.warm = True
                return self._on_side(lambda: self.step(self.static, self.sites))
            self._capture()
        self.graph.replay()
        ops.add_launches(self.delta)
        self.replays += 1
        return {k: v.clone() for k, v in self.losses.items()}

    def _seeds(self, generator) -> list[list[int]]:
        # with accum > 1 the microbatch generators live on the card and the
        # seeds are read back: on the idle side stream, so that the read
        # waits for no step in flight
        stream = torch.cuda.stream(self.side) if self.accum > 1 and self.side else nullcontext()
        with stream:
            return site_seeds(generator, self.accum, self.device, self.n_sites)

    def _on_side(self, fn: Callable):
        main = torch.cuda.current_stream(self.device)
        self.side.wait_stream(main)
        with torch.cuda.stream(self.side):
            out = fn()
        main.wait_stream(self.side)
        return out

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        for gens in self.sites:
            for gen in gens:
                graph.register_generator_state(gen)
        before = ops.launch_state()
        try:
            with torch.cuda.graph(graph, stream=self.side, capture_error_mode="thread_local"):
                self.losses = self.step(self.static, self.sites)
        except RuntimeError as exc:
            raise RuntimeError(f"capturing the train step as a CUDA graph failed: {exc}") from exc
        finally:
            after = ops.launch_state()
            ops.restore_launches(before)
        self.delta = ops.launch_delta(before, after)
        self.graph = graph
