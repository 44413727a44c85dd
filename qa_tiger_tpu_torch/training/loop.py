"""Training and evaluation runner.

Port of ``qa_tiger_tpu/training/loop.py`` (the reference's
src/trainutils.py:253-462), on one card, or on one card per rank under a
process group (``qa_tiger_tpu_torch.parallel``):

- the frozen text tower is split off the trained parameters
  (``requires_grad_(False)``, no Adam state), runs under ``no_grad`` in its
  own ``encoder_dtype`` (bf16 on the card unless the config says otherwise,
  fp32 on the CPU, as the JAX runner does on its accelerator), and its
  outputs reach the trainable projections in their dtype;
- ``train_step``: forward with dropout drawn from a ``torch.Generator``, CE
  plus any ``*loss*`` outputs, backward, Adam with the scheduled LR times
  each group's multiplier; ``grad_accum`` microbatches weighted by their
  valid rows; opt-in ``train_dtype`` computes in that dtype from fp32
  master weights;
- eval accumulates the loss and the 9-way counters on the device;
- ``train_epoch`` and ``evaluate``/``test`` take any loader with
  ``__len__``, ``__iter__`` and ``set_epoch`` and read the device once per
  log window; ``train_epoch`` keeps its steps, wall seconds and the seconds
  it waited on the loader in ``epoch_stats``;
- ``build_question_cache(dataset)`` runs every question of a tokenizing
  dataset through the frozen tower once, and its batches then gather rows
  by ``ds_idx``;
- ``debug`` stops each loop at batch 10 like the reference's smoke mode;
- ``train_state`` / ``restore_train_state`` snapshot and restore what a
  bitwise resume needs (``training/checkpoint.py`` writes it), and
  ``load_clip_text_weights`` loads OpenAI CLIP text weights into the frozen
  tower;
- ``hyper_params.steps_per_dispatch = K`` > 1 (the JAX runner's K steps in
  one scanned call): ``train_epoch`` stages K batches on the device and
  steps them as one window (``train_window``) through a CUDA graph of the
  whole step (``training/step_graph.py``), flushing at K, at a log boundary
  and at the epoch tail as the JAX runner does; a batch of another shape
  takes the eager step. The dropout stream, and so ``_step_generator``
  after a window, is the K=1 run's. On the CPU, which has no graphs, the
  same static-input step runs eagerly. ``debug`` and ``profile_dir`` keep
  K=1;
- ``profile_dir`` (config key, or ``QA_TIGER_PROFILE_DIR``): a
  ``torch.profiler`` trace of steps 1-3 of epoch 1 written there;
- data parallelism (a process group is up; each rank steps on its strided
  shard of the global batch): the CE is the global batch's masked mean,
  each rank's sum of NLL over valid rows divided by the valid count summed
  over the ranks (one collective before the forward), ``*loss*`` outputs
  are averaged over the ranks, and the gradients and the reported losses
  are summed over the ranks in one flat buffer after the backward
  (``parallel.all_reduce_grads``); with ``grad_accum`` the microbatches'
  weights are their global valid counts. Dropout draws from the step's
  stream split by rank (``_rank_generator``): rows of different ranks never
  share a mask, and at world 1 the stream is the single process's. Eval
  sums the counters and the per-batch NLL over the ranks when it reads
  them back, so ``evaluate`` and ``test`` report what one process reports
  over the same global batches. The TempMoE gather of
  ``gather_mode="reference"`` rotates within the batch it sees: each
  rank's shard, as under the reference's DDP;
- tensor parallelism (``grid=``, ``parallel.make_grid(tp)``: the
  counterpart of the JAX runner's ``mesh=`` with a ``model`` axis): the
  model holds this rank's shards (``parallel.shard_module_``), the eval
  forward runs the modules' tensor-parallel forms, ``load_params`` shards
  what it is given and ``params`` gathers the whole state dict back (so
  ``best.npz`` keeps its format and loads at any grid); a loader shards
  over the data axis (``grid.loader_shard``), and eval sums its counters
  over the data group only. ``train_step`` and ``train_epoch`` (one step
  per dispatch) run the train forward's tensor-parallel form: the valid
  counts are summed over the data group, ``*loss*`` outputs divided by the
  data size, the gradients all-reduced over the data group (every model
  rank of a data rank holds the same rows; a sharded parameter's gradient
  is its rank's), and the dropout stream is split by data rank, so every
  model rank of a data rank draws the same masks and at one data rank the
  stream is the single process's. ``train_state`` gathers the trainable
  parameters and Adam's moments to whole tensors and
  ``restore_train_state`` shards them back, so a checkpoint resumes at any
  grid. ``train_window`` (``steps_per_dispatch`` > 1) runs the same step
  through the step graph: the model ranks of a data rank seed their site
  generators alike, and on the card the graph holds the model group's
  all-reduces with the data group's (NCCL). QA-TIGER and TSPM both split.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections.abc import Mapping
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch.func import functional_call

from qa_tiger_tpu_torch import parallel
from qa_tiger_tpu_torch.convert import params_from_jax
from qa_tiger_tpu_torch.models.qa_tiger import check_text_ctx, split_generator, split_seeds
from qa_tiger_tpu_torch.models.registry import model_class, resolve_device
from qa_tiger_tpu_torch.parallel.tensor import (
    Grid,
    gather_state_dict,
    shard_module_,
    shard_state_dict,
)
from qa_tiger_tpu_torch.training.checkpoint import TENSOR_ENTRIES, load_clip_text_state
from qa_tiger_tpu_torch.training.metrics import (
    accuracy_report,
    masked_cross_entropy,
    masked_nll_sum,
    qtype_counters,
)
from qa_tiger_tpu_torch.training.optim import (
    lr_multipliers,
    make_optimizer,
    set_capturable,
    set_lr,
)
from qa_tiger_tpu_torch.training.step_graph import StepGraph, batch_key
from qa_tiger_tpu_torch.utils.logging import get_logger
from qa_tiger_tpu_torch.utils.profiling import trace

BATCH_KEYS = ("quest", "audio", "video", "patch", "prompt", "label", "qtype_label", "valid")
EVAL_CAST_KEYS = ("audio", "video", "patch", "quest", "prompt", "quest_words")
# train_epoch's profile_dir trace, in that directory
TRACE_FILE = "train_steps_1-3.json"


def _dtype(name: str | None) -> torch.dtype | None:
    return getattr(torch, name) if name else None


def _as_state(params: Mapping) -> dict[str, torch.Tensor]:
    """A state_dict (flat names -> tensors) as it is; a JAX parameter pytree
    or a flat dict of numpy arrays through ``params_from_jax``."""
    if all(torch.is_tensor(v) for v in params.values()):
        return dict(params)
    return params_from_jax(params)


def _timed(loader, waited: list):
    """Iterate ``loader``, adding to ``waited[0]`` the seconds each batch
    took to arrive."""
    it = iter(loader)
    while True:
        start = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return
        waited[0] += time.perf_counter() - start
        yield batch


class AVQARunner:
    """Owns the model, the optimizer and the step functions.

    ``cfg``: the config dict (``hyper_params.optim``: lr, betas,
    weight_decay, encoder_lr, grad_accum; ``hyper_params.train_dtype`` /
    ``eval_dtype`` / ``steps_per_dispatch``; ``log_interval``; ``debug``;
    ``profile_dir``). ``model_cfg``: the model's
    hyperparameters (``models.model_config``: QA-TIGER's, or TSPM's, whose
    model has no frozen tower and reads precomputed question and prompt
    features). The model runs on ``device`` (``cuda`` unless given, no
    fallback). Weights come from ``seed``, or from ``init_params`` (a
    state_dict or a JAX pytree). ``grid`` (``parallel.make_grid``): this
    rank's place in a data x model grid; a model size above 1 shards the
    model.
    """

    grid: Grid | None = None

    def __init__(self, cfg: Mapping, model_cfg: Mapping, *,
                 device: str | torch.device | None = None, seed: int = 0,
                 init_params: Mapping | None = None, grid: Grid | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.logger = get_logger()
        self.model_cfg = dict(model_cfg)
        enc_dt = self.model_cfg.get("encoder_dtype")
        if enc_dt is None and self.device.type == "cuda":
            enc_dt = "bfloat16"
        self.model_cfg["encoder_dtype"] = enc_dt
        self._encoder_dtype = _dtype(enc_dt)
        self.model = model_class(self.model_cfg)(self.model_cfg, seed=seed)
        self.grid = grid
        if self._model_axis:
            # the whole state dict's shapes, which gather_state_dict reads
            self._whole_shapes = {n: tuple(t.shape) for n, t in self.model.state_dict().items()}
            self.model.check_model_parallel(grid.model_size)
            shard_module_(self.model, grid)
        self._frozen_prefixes = self.model.FROZEN_PREFIXES
        for name, p in self.model.named_parameters():
            if self._frozen(name):
                p.requires_grad_(False)
        self.model.to(self.device)
        hp = cfg["hyper_params"]
        self._optim_cfg = dict(hp["optim"])
        self._train_dtype = _dtype(hp.get("train_dtype"))
        self._eval_dtype = _dtype(hp.get("eval_dtype"))
        self._grad_accum = int(self._optim_cfg.get("grad_accum", 1) or 1)
        self.steps_per_dispatch = int(hp.get("steps_per_dispatch", 1) or 1)
        # K > 1 on the card steps through a CUDA graph, whose Adam must be
        # the capturable form; K = 1 and the CPU (where torch refuses it)
        # keep the eager form (training/optim.py)
        self._capturable = self.device.type == "cuda" and self.steps_per_dispatch > 1
        # on the card a window's steps are captured and replayed; False runs
        # the same static-input step eagerly (the CPU has no graphs; a card
        # run sets it to hold the graph against that step)
        self.graph_capture = self.device.type == "cuda"
        self._step_graph: StepGraph | None = None
        if init_params is not None:
            self.load_params(init_params)
        else:
            self._cast_frozen()
            self._make_optimizer()
        # the dropout stream of train_epoch; on the host, as it only seeds the
        # per-site generators on the device (split_generator), so drawing from
        # it never waits for the card
        self._step_generator = torch.Generator().manual_seed(seed + 1)
        # opt-in question cache: per-dataset (pooled, words) tables on the
        # device, keyed by the dataset's id(); see build_question_cache_from_tokens
        self._qst_caches: dict[Any, tuple[torch.Tensor, torch.Tensor]] = {}
        self._active_qst_cache: tuple[torch.Tensor, torch.Tensor] | None = None
        # steps, wall seconds and loader wait of the last train_epoch
        self.epoch_stats: dict[str, float] | None = None

    # ------------------------------------------------------------------
    @property
    def _model_axis(self) -> bool:
        return self.grid is not None and self.grid.model_size > 1

    @property
    def _data_parallel(self) -> bool:
        """Whether the step sums over data ranks: under a model axis, more
        than one data rank; otherwise a process group of any size (the
        data-parallel step without a grid, kept bitwise)."""
        return self.grid.data_size > 1 if self._model_axis else parallel.distributed()

    @property
    def _data_size(self) -> int:
        return self.grid.data_size if self._model_axis else parallel.world()

    @property
    def _data_rank(self) -> int:
        return self.grid.data_rank if self._model_axis else parallel.rank()

    def _map_moments(self, opt_state: dict, fn) -> dict:
        """``optimizer.state_dict()`` with each parameter's Adam moments
        replaced by ``fn(name, moment)``."""
        names = self._state_names()
        state = {i: {**entry, **{k: fn(names[i], entry[k]) for k in ("exp_avg", "exp_avg_sq")}}
                 for i, entry in opt_state["state"].items()}
        return {**opt_state, "state": state}

    def _state_names(self) -> dict[int, str]:
        """The parameter name of each index of Adam's ``state_dict``: its
        groups' parameters in order."""
        by_id = {id(p): n for n, p in self.trainable()}
        ps = [p for group in self.optimizer.param_groups for p in group["params"]]
        return {i: by_id[id(p)] for i, p in enumerate(ps)}

    def _frozen(self, name: str) -> bool:
        return name.split(".")[0] in self._frozen_prefixes

    def trainable(self) -> list[tuple[str, torch.nn.Parameter]]:
        return [(n, p) for n, p in self.model.named_parameters() if not self._frozen(n)]

    def _make_optimizer(self) -> None:
        oc = self._optim_cfg
        names = [n for n, _ in self.trainable()]
        self.optimizer = make_optimizer(
            self.trainable(), betas=tuple(oc.get("betas", (0.9, 0.999))),
            weight_decay=oc.get("weight_decay", 0.0) or 0.0,
            lr_mults=lr_multipliers(names, oc.get("encoder_lr"), oc.get("lr", 1e-4)),
            capturable=self._capturable)
        # a captured step would update the old optimizer's state
        self._step_graph = None

    def _cast_frozen(self) -> None:
        """The frozen tower in ``encoder_dtype``; a model without one (TSPM)
        has nothing to cast."""
        tower = getattr(self.model, "quest_encoder", None)
        if tower is not None and self._encoder_dtype is not None:
            tower.to(self._encoder_dtype)

    @property
    def params(self) -> dict[str, torch.Tensor]:
        """Every parameter, trainable and frozen, by its dotted name; under a
        model axis the whole tensors, gathered from the model ranks."""
        if self._model_axis:
            return gather_state_dict(self.model.state_dict(), self.grid, self._whole_shapes)
        return self.model.state_dict()

    def load_params(self, params: Mapping) -> None:
        """Load a state_dict or a JAX pytree: every trainable parameter must
        be there; the frozen tower may be left out (it keeps its weights).
        Adam's state starts afresh."""
        state = _as_state(params)
        if self._model_axis:
            state = shard_state_dict(state, self.grid)
        missing, unexpected = self.model.load_state_dict(state, strict=False)
        missing = [n for n in missing if not self._frozen(n)]
        if missing or unexpected:
            raise KeyError(f"load_params: missing {missing}, unexpected {unexpected}")
        self._cast_frozen()
        self._make_optimizer()

    def load_clip_text_weights(self, path: str | Path) -> None:
        """Load OpenAI CLIP text weights into the frozen ``quest_encoder``:
        whatever ``training.checkpoint.load_clip_text_state`` reads. The
        load is strict, into the tower only, which is then cast to
        ``encoder_dtype``: the counterpart of the reference's clip.load()
        inside CLIP_TEncoder (src/models/encoders.py:13). A model without
        the tower (TSPM) reads the file and keeps nothing: the JAX runner
        adds the weights to its frozen parameters, which its forward never
        reads."""
        state = load_clip_text_state(path)
        if getattr(self.model, "quest_encoder", None) is None:
            self.logger.info(f"loaded frozen CLIP text tower from {path} (unused: the model "
                             "reads precomputed question features)")
            return
        if self._model_axis:
            state = {n[len("quest_encoder."):]: t for n, t in shard_state_dict(
                {f"quest_encoder.{n}": t for n, t in state.items()}, self.grid).items()}
        self.model.quest_encoder.load_state_dict(state, strict=True)
        self._cast_frozen()
        self._step_graph = None  # the cast may have replaced the tower's tensors
        self.logger.info(f"loaded frozen CLIP text tower from {path}")

    def train_state(self, **scalars) -> dict[str, Any]:
        """What a mid-training resume needs: the trainable parameters,
        Adam's state (``optimizer.state_dict()``), the state of the dropout
        stream ``train_epoch`` draws from, and the caller's host scalars
        (epoch, best accuracy, ...). With the generator state a resumed run
        draws the dropout an uninterrupted one would have, so resume is
        bitwise. The tensors are the live ones: ``save_train_state`` writes
        them at once, ``save_train_state_async`` copies them first. Adam's
        groups are saved in the eager form (float LRs), whatever
        ``steps_per_dispatch`` the run used."""
        opt_state = self.optimizer.state_dict()
        for group in opt_state["param_groups"]:
            group["lr"], group["capturable"] = float(group["lr"]), False
        params = {n: p.detach() for n, p in self.trainable()}
        if self._model_axis:  # whole tensors, as one process saves them
            params = gather_state_dict(params, self.grid, self._whole_shapes)
            opt_state = self._map_moments(opt_state, lambda n, t: gather_state_dict(
                {n: t}, self.grid, self._whole_shapes)[n])
        return {"params": params, "opt_state": opt_state,
                "step_rng": self._step_generator.get_state(), **scalars}

    def restore_train_state(self, state: Mapping[str, Any]) -> dict[str, Any]:
        """Takes what ``train_state`` gave (every trainable parameter must
        be there), Adam's state and the dropout stream included; returns the
        host scalars."""
        self.load_params(state["params"])
        opt_state = state["opt_state"]
        if self._model_axis:
            opt_state = self._map_moments(
                opt_state, lambda n, t: shard_state_dict({n: t}, self.grid)[n])
        self.optimizer.load_state_dict(opt_state)
        set_capturable(self.optimizer, self._capturable)
        self._step_graph = None
        if state.get("step_rng") is not None:
            self._step_generator.set_state(state["step_rng"])
        return {k: v for k, v in state.items() if k not in TENSOR_ENTRIES}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def build_question_cache_from_tokens(self, tokens, key: Any, chunk: int = 512) -> None:
        """Encode token ids [N, L] through the frozen tower once and keep
        (pooled [N, Dq], words [N, L, W]) on the device under ``key``, in
        the tower's dtype; a batch that carries ``ds_idx`` then gathers rows
        of the active table instead of running the tower."""
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int64)
        ctx = self.model_cfg.get("text_ctx")
        if ctx and ctx < toks.shape[1]:
            toks = toks[:, :ctx]
        pooled, words = [], []
        for i in range(0, toks.shape[0], chunk):
            p, w = self.model.quest_encoder(toks[i:i + chunk].to(self.device), grid=self.grid)
            pooled.append(p)
            words.append(w)
        cache = (torch.cat(pooled), torch.cat(words))
        self._qst_caches[key] = cache
        self.logger.info(
            f"question cache built: {toks.shape[0]} questions, words "
            f"{tuple(cache[1].shape)} {cache[1].dtype} "
            f"({cache[1].numel() * cache[1].element_size() / 1e6:.1f} MB resident)")

    def build_question_cache(self, dataset, chunk: int = 512) -> bool:
        """The question cache of ``dataset``: every ``question_content``
        through the dataset's tokenizer, then
        ``build_question_cache_from_tokens`` under ``id(dataset)``. A
        dataset that serves precomputed question features has no tower to
        skip. Returns True if a cache was built or exists."""
        key = id(dataset)
        if key in self._qst_caches:
            return True
        if getattr(dataset, "tokenizer", None) is None:
            self.logger.info("question cache skipped: dataset serves "
                             "precomputed question features")
            return False
        if not any(self._frozen(n) for n, _ in self.model.named_parameters()):
            self.logger.info("question cache skipped: no frozen text tower")
            return False
        texts = [s["question_content"] for s in dataset.samples]
        tokens = dataset.tokenizer(texts, truncate=True)
        self.build_question_cache_from_tokens(tokens, key, chunk=chunk)
        return True

    def _select_qst_cache(self, loader) -> None:
        self._active_qst_cache = self._qst_caches.get(id(getattr(loader, "dataset", None)))

    def stage_batch(self, batch: Mapping) -> dict[str, torch.Tensor]:
        """numpy arrays or tensors -> tensors on the device (floats keep
        their dtype; token ids, labels and qtypes as int64; valid as bool).
        With a question cache active a batch's ``ds_idx`` comes along as an
        int64 index in place of its token ids (``_gather_questions``)."""
        check_text_ctx(batch.get("quest"), self.model_cfg.get("text_ctx"))
        out = {}
        if self._active_qst_cache is not None and "ds_idx" in batch:
            out["ds_idx"] = torch.as_tensor(batch["ds_idx"], dtype=torch.int64).to(self.device)
        for key in BATCH_KEYS:
            if key == "quest" and "ds_idx" in out:
                continue
            if key in batch and batch[key] is not None:
                t = torch.as_tensor(batch[key])
                if key == "valid":
                    t = t.bool()
                elif not torch.is_floating_point(t):
                    t = t.long()
                out[key] = t.to(self.device)
        return out

    @staticmethod
    def _gather_questions(batch: dict, cache) -> dict:
        """A staged batch with its ``ds_idx`` replaced by the cache rows
        (pooled question, words) it names."""
        if "ds_idx" not in batch:
            return batch
        batch = dict(batch)
        idx = batch.pop("ds_idx")
        batch["quest"], batch["quest_words"] = cache[0][idx], cache[1][idx]
        return batch

    def _device_batch(self, batch: Mapping) -> dict[str, torch.Tensor]:
        return self._gather_questions(self.stage_batch(batch), self._active_qst_cache)

    # ------------------------------------------------------------------
    def _forward(self, batch: dict, dtype: torch.dtype | None, include_frozen: bool,
                 **kwargs) -> dict:
        """The model's forward, computed in ``dtype`` when given: the
        parameters (the trainable ones, or all) and the float inputs are cast
        copies, so gradients flow back to the fp32 masters."""
        if dtype is None:
            return self.model(batch, **kwargs)
        named = self.model.named_parameters() if include_frozen else self.trainable()
        params = {n: p.to(dtype) for n, p in named}
        keys = EVAL_CAST_KEYS if include_frozen else batch.keys()
        batch = {k: v.to(dtype) if k in keys and torch.is_floating_point(v) else v
                 for k, v in batch.items()}
        return functional_call(self.model, params, (batch,), kwargs)

    def _losses(self, batch: dict, generator, sites=None,
                count: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        """The CE over ``batch``'s valid rows plus any ``*loss*`` output.
        Under data parallelism ``count`` is the valid count of the global
        batch: the CE is this rank's share of its masked mean and each
        ``*loss*`` output is divided by the number of data ranks, so that
        their sums over the data ranks are the global batch's."""
        extra = {"grid": self.grid} if self._model_axis else {}
        out = self._forward(batch, self._train_dtype, False, train=True, generator=generator,
                            sites=sites, **extra)
        if count is None:
            ce, world = masked_cross_entropy(out["out"], batch["label"], batch["valid"]), 1
        else:
            ce = masked_nll_sum(out["out"], batch["label"], batch["valid"]) / count.clamp(min=1.0)
            world = self._data_size
        losses = {"ce_loss": ce}
        total = ce
        for key, value in out.items():
            if "loss" in key:
                losses[key] = value if world == 1 else value / world
                total = total + losses[key]
        losses["total_loss"] = total
        return losses

    def train_step(self, batch: Mapping, lr: float,
                   generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """One optimizer step; returns the losses as device scalars. Dropout
        draws from ``generator`` (none without one). The parameter gradients
        stay in ``.grad`` until the next step."""
        batch = self._device_batch(batch)
        set_lr(self.optimizer, lr)
        return self._step(batch, generator)

    def _step(self, batch: dict, generator=None, sites=None) -> dict[str, torch.Tensor]:
        """Forward, backward and Adam on a device batch at the LR already
        set; dropout from ``generator`` (split by rank, then per site) or
        from ``sites`` (one list of per-site generators per microbatch,
        seeded: the step graph's). Under data parallelism the gradients and
        the losses are summed over the data ranks before Adam."""
        self.optimizer.zero_grad(set_to_none=True)
        generator = self._rank_generator(generator)
        accum = self._grad_accum
        dp = self._data_parallel
        if accum <= 1:
            count = self._global_counts([batch])[0] if dp else None
            losses = self._losses(batch, generator, None if sites is None else sites[0], count)
            losses["total_loss"].backward()
        else:
            losses = self._accumulated_backward(batch, generator, accum, sites)
        losses = {k: v.detach() for k, v in losses.items()}
        if dp:
            group = self.grid.data_group if self._model_axis else None
            losses = parallel.all_reduce_grads([p for _, p in self.trainable()], losses,
                                               group=group)
        self.optimizer.step()
        return losses

    def _rank_generator(self, generator):
        """This rank's dropout stream for one step: ``generator`` itself on
        one process or at one data rank; otherwise a generator seeded with
        this data rank's of ``data_size`` seeds drawn from it, so that every
        rank advances the shared stream alike, every data rank draws masks
        of its own and the model ranks of one data rank draw the same."""
        size = self._data_size
        if generator is None or size <= 1:
            return generator
        seed = split_seeds(generator, size)[self._data_rank]
        return torch.Generator(device=generator.device).manual_seed(seed)

    def _global_counts(self, mbs: list[dict]) -> torch.Tensor:
        """The valid-row count of each (micro)batch, summed over the data
        ranks under data parallelism: [len(mbs)] fp32, one collective."""
        counts = torch.stack([mb["valid"].float().sum() for mb in mbs])
        if self._model_axis:
            return self.grid.reduce_data([counts])[0]
        return parallel.all_reduce_sum([counts])[0]

    def train_window(self, batches: list[dict], lr: float) -> list[dict[str, torch.Tensor]]:
        """Steps over staged batches (``stage_batch``) in order, dropout from
        ``_step_generator`` as ``train_step`` draws it; returns each step's
        losses as device scalars and reads nothing back. A batch of the step
        graph's shapes goes through it (``StepGraph``: captured on the card
        at its second batch, replayed from then on); one of other shapes
        through the eager step. Under a model axis the step is the grid's,
        its dropout from ``_rank_generator`` (the same on every model
        rank of a data rank)."""
        set_lr(self.optimizer, lr)
        out = []
        for batch in batches:
            graph = self._graph_for(batch)
            if graph is None:
                batch = self._gather_questions(batch, self._active_qst_cache)
                out.append(self._step(batch, self._step_generator))
            else:
                out.append(graph(batch, self._rank_generator(self._step_generator)))
        return out

    def _graph_for(self, batch: dict) -> StepGraph | None:
        """The step graph that takes ``batch``: made at the first batch
        after it was dropped or the question cache changed; None for a batch
        of other shapes."""
        cache = self._active_qst_cache
        graph = self._step_graph
        if graph is None or graph.cache is not cache:
            def step(static: dict, sites) -> dict[str, torch.Tensor]:
                return self._step(self._gather_questions(static, cache), sites=sites)

            graph = self._step_graph = StepGraph(step, batch, accum=self._grad_accum,
                                                 sites=self.model.SITES, device=self.device,
                                                 capture=self.graph_capture, cache=cache)
        return graph if graph.key == batch_key(batch) else None

    def _accumulated_backward(self, batch: dict, generator, accum: int, sites=None) -> dict:
        """``accum`` sequential microbatches, each gradient weighted by its
        valid-row count (under data parallelism, the count of the global
        microbatch, whose rows the ranks' microbatches hold) and the sum
        divided by the total: for the CE loss exactly the full-batch
        gradient, where the forward does not mix rows (``gather_mode=
        "paper"``; the reference gather rotates routing across the batch, so
        microbatches change it, as in the JAX runner)."""
        mbs = [dict(zip(batch, parts)) for parts in
               zip(*(v.chunk(accum) for v in batch.values()))]
        if sites is not None:
            draws = [(None, site) for site in sites]
        elif generator is not None:
            draws = [(gen, None) for gen in split_generator(generator, accum, self.device)]
        else:
            draws = [(None, None)] * accum
        sums: dict[str, torch.Tensor] = {}
        w_sum = torch.zeros((), device=self.device)
        dp = self._data_parallel
        counts = self._global_counts(mbs) if dp else None
        for i, (mb, (gen, site)) in enumerate(zip(mbs, draws)):
            w = counts[i] if dp else mb["valid"].float().sum()
            losses = self._losses(mb, gen, site, w if dp else None)
            (w * losses["total_loss"]).backward()
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + w * v.detach()
            w_sum = w_sum + w
        denom = w_sum.clamp(min=1.0)
        for _, p in self.trainable():
            if p.grad is not None:
                p.grad.div_(denom)
        return {k: v / denom for k, v in sums.items()}

    @torch.no_grad()
    def eval_step(self, batch: Mapping, nll_sum: bool = False):
        """(ce, correct, total, correct_per_type, total_per_type), on the
        device; with ``nll_sum`` the first is the NLL summed over the valid
        rows (what ranks sum before dividing by the summed total)."""
        batch = self._device_batch(batch)
        extra = {"grid": self.grid} if self._model_axis else {}
        out = self._forward(batch, self._eval_dtype, True, **extra)
        loss = masked_nll_sum if nll_sum else masked_cross_entropy
        ce = loss(out["out"], batch["label"], batch["valid"])
        return (ce, *qtype_counters(out["out"], batch["label"], batch["qtype_label"],
                                    batch["valid"]))

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int, loader, lr: float, writer=None) -> None:
        cfg = self.cfg
        logger = self.logger
        log_interval = cfg.get("log_interval", 100)
        self._select_qst_cache(loader)
        loader.set_epoch(epoch)
        tot_batch = len(loader) - 1
        sums: dict[str, float] = {}
        count = 0
        epoch_time = time.time()
        pending: list = []  # (batch_idx, device losses) awaiting one host read

        def drain() -> dict[str, float]:
            if not pending:
                return {}
            keys = list(pending[0][1])
            host = torch.stack([torch.stack([ld[k].float() for k in keys])
                                for _, ld in pending]).tolist()
            last: dict[str, float] = {}
            for (bi, _), row in zip(pending, host):
                last = dict(zip(keys, row))
                for k, v in last.items():
                    sums[k] = sums.get(k, 0.0) + v
                    if writer is not None:
                        writer.add_scalar(f"train/loss/{k}", v,
                                          (epoch - 1) * (tot_batch + 1) + bi)
            pending.clear()
            return last

        # profile_dir (config key or QA_TIGER_PROFILE_DIR): a torch.profiler
        # trace of steps 1-3 of epoch 1 (step 0 builds and warms up)
        prof_dir = cfg.get("profile_dir") or os.environ.get("QA_TIGER_PROFILE_DIR")
        tracing = contextlib.ExitStack()  # the open trace, if any
        # steps_per_dispatch: staged batches wait in a window that is stepped
        # at K, at a log boundary and at the epoch tail (train_window); debug
        # and profiling keep one step per batch, so that steps stay visible
        k_steps = 1 if cfg.get("debug") or prof_dir else self.steps_per_dispatch
        window: list = []  # (batch_idx, staged batch) awaiting dispatch

        def flush() -> None:
            if window:
                losses = self.train_window([b for _, b in window], lr)
                pending.extend((bi, ld) for (bi, _), ld in zip(window, losses))
                window.clear()

        waited = [0.0]
        with tracing:
            for batch_idx, host_batch in enumerate(_timed(loader, waited)):
                if prof_dir and epoch == 1 and batch_idx == 1:
                    tracing.callback(logger.info, "Profiler trace written to "
                                     f"{Path(prof_dir) / TRACE_FILE}")
                    tracing.enter_context(trace(prof_dir, TRACE_FILE))
                start_time = time.time()
                if k_steps > 1:
                    window.append((batch_idx, self.stage_batch(host_batch)))
                    if len(window) == k_steps:
                        flush()
                else:
                    pending.append((batch_idx,
                                    self.train_step(host_batch, lr, self._step_generator)))
                count += 1
                if batch_idx == 3:
                    tracing.close()
                if batch_idx % log_interval == 0 or batch_idx == tot_batch:
                    flush()
                    last = drain()
                    batch_t = time.time() - start_time
                    elapsed = time.time() - epoch_time
                    avg_time = elapsed / (batch_idx + 1)
                    est = (tot_batch - batch_idx) * avg_time / 60
                    cur = str(batch_idx).zfill(len(str(max(tot_batch, 1))))
                    ratio = 100.0 * batch_idx / max(tot_batch, 1)
                    loss_str = " ".join(f"{k}-{v:.4f}({sums[k] / count:.4f})"
                                        for k, v in last.items())
                    logger.info(
                        f"[EST: {est:7.2f}m][Process Time: {batch_t:7.2f}s]"
                        f"- Epoch: {epoch} [{cur}/{tot_batch} ({ratio:3.0f}%)]"
                        f"\tLosses: {loss_str}")
                if cfg.get("debug") and batch_idx == 10:
                    break
        flush()
        drain()
        self.epoch_stats = {"epoch": epoch, "steps": count,
                            "wall_s": time.time() - epoch_time, "loader_wait_s": waited[0]}
        logger.info(f"Epoch {epoch}: {count} steps in {self.epoch_stats['wall_s']:.2f}s, "
                    f"{waited[0]:.2f}s of it waiting on the loader")

    def _run_eval(self, loader, debug: bool):
        """(mean of the batches' CE, correct, total, correct and total per
        question type) over ``loader``. Under data parallelism every rank
        reads its shard, and the rows read back are summed over the ranks
        first (under a grid, over its data group: every model rank of a
        data rank holds the same rows): each batch's CE is then the global
        batch's."""
        self._select_qst_cache(loader)
        ce_sum, cor, tot, n_batches = 0.0, 0, 0, 0
        cor9 = np.zeros(9, np.int64)
        tot9 = np.zeros(9, np.int64)
        pending: list = []
        log_interval = self.cfg.get("log_interval", 100)
        grid = self.grid
        dp = grid.data_size > 1 if grid is not None else parallel.distributed()

        def drain() -> None:
            nonlocal ce_sum, cor, tot, cor9, tot9, n_batches
            if not pending:
                return
            rows = torch.stack([torch.cat([ce.double().reshape(1), c.reshape(1).double(),
                                           t.reshape(1).double(), c9.double(), t9.double()])
                                for ce, c, t, c9, t9 in pending])
            if dp:
                rows = (grid.reduce_data([rows]) if grid is not None
                        else parallel.all_reduce_sum([rows]))[0]
                rows[:, 0] /= rows[:, 2].clamp(min=1.0)
            rows = rows.cpu().numpy()
            for row in rows:
                ce_sum += float(row[0])
                cor += int(row[1])
                tot += int(row[2])
                cor9 += row[3:12].astype(np.int64)
                tot9 += row[12:21].astype(np.int64)
                n_batches += 1
            pending.clear()

        for batch_idx, host_batch in enumerate(loader):
            pending.append(self.eval_step(host_batch, nll_sum=dp))
            if batch_idx % log_interval == 0 or batch_idx == len(loader) - 1:
                drain()
                self.logger.info(f"Test progress: {batch_idx:3.0f}/{len(loader) - 1}")
            if debug and batch_idx == 10:
                break
        drain()
        return ce_sum / max(n_batches, 1), cor, tot, cor9, tot9

    def evaluate(self, epoch: int, loader, writer=None) -> tuple[float, float]:
        loss, cor, tot, cor9, tot9 = self._run_eval(loader, bool(self.cfg.get("debug")))
        if writer is not None:
            writer.add_scalar("valid/acc/Total", cor / max(tot, 1) * 100.0, epoch)
        report = accuracy_report(cor, tot, cor9, tot9, self.logger.info, epoch=epoch,
                                 writer=writer)
        return report["Total"], loss

    def test(self, loader) -> float:
        _, cor, tot, cor9, tot9 = self._run_eval(loader, bool(self.cfg.get("debug")))
        report = accuracy_report(cor, tot, cor9, tot9, self.logger.info, prefix="Test")
        return report["Total"]
