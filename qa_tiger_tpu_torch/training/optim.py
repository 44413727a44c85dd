"""Optimizer and learning-rate schedules.

Port of ``qa_tiger_tpu/training/optim.py`` (the reference's
src/trainutils.py:116-182): Adam with the config's betas and optional weight
decay, an optional separate encoder learning rate, and three schedules —
StepLR, timm-style cosine with warmup, and ReduceLROnPlateau.

``torch.optim.Adam`` adds the weight decay to the gradient before the
moment: exactly optax ``add_decayed_weights`` -> ``scale_by_adam``. The
schedules are host-side functions of the epoch, as in the JAX package; the
runner writes ``lr * lr_mult`` into each parameter group before a step
(``set_lr``).

Two forms of the same Adam: the eager train step's (``capturable=False``:
float LRs, step counts on the host, the bias correction on the host) and the
CUDA graph's (``capturable=True``, ``set_capturable``: each group's LR a
device tensor that ``set_lr`` fills, step counts and the bias correction on
the device, so a captured step reads nothing from the host). The two round
the bias correction differently, so their updates agree to rounding, not
bitwise. torch refuses ``capturable=True`` on the CPU, where the runner
keeps the eager form.
"""
from __future__ import annotations

import math
from collections.abc import Callable, Iterable

import torch

ENCODER_NAME_PARTS = ("video_encoder", "quest_encoder", "audio_encoder", "mllm")


def lr_multipliers(names: Iterable[str], encoder_lr: float | None,
                   base_lr: float) -> dict[str, float]:
    """Per-parameter LR multiplier for the two-group split
    (src/trainutils.py:121-137): encoder_lr / base_lr for a name with an
    encoder part in any of its dotted segments, 1.0 elsewhere and everywhere
    when encoder_lr is None."""
    if encoder_lr is None:
        return {name: 1.0 for name in names}
    ratio = encoder_lr / base_lr
    return {name: ratio if any(part in seg for seg in name.split(".")
                               for part in ENCODER_NAME_PARTS) else 1.0
            for name in names}


def make_optimizer(named_params: Iterable[tuple[str, torch.nn.Parameter]],
                   betas: tuple[float, float] = (0.95, 0.999), weight_decay: float = 0.0,
                   eps: float = 1e-8, lr_mults: dict[str, float] | None = None,
                   capturable: bool = False) -> torch.optim.Adam:
    """Adam over the given parameters, one parameter group per LR
    multiplier; each group carries its ``lr_mult``. The group LR is set by
    the caller before each step (lr * lr_mult, ``set_lr``). ``capturable``
    builds the CUDA graph's form (``set_capturable``)."""
    groups: dict[float, list] = {}
    for name, p in named_params:
        groups.setdefault(1.0 if lr_mults is None else lr_mults[name], []).append(p)
    optimizer = torch.optim.Adam(
        [{"params": ps, "lr_mult": mult, "lr": mult} for mult, ps in groups.items()],
        lr=1.0, betas=tuple(betas), eps=eps, weight_decay=weight_decay)
    if capturable:
        set_capturable(optimizer, True)
    return optimizer


def set_capturable(optimizer: torch.optim.Adam, capturable: bool) -> None:
    """Puts ``optimizer`` into the graph's form (``capturable``: each
    group's LR a 0-d tensor on its parameters' device, step counts there as
    fp32) or the eager one (float LRs, step counts on the host), whatever
    form a ``load_state_dict`` gave it. Reads a device LR once; call it
    outside a captured region."""
    for group in optimizer.param_groups:
        device = group["params"][0].device
        lr = float(group["lr"])
        group["capturable"] = capturable
        group["lr"] = torch.tensor(lr, device=device) if capturable else lr
        for p in group["params"]:
            state = optimizer.state.get(p)
            if state and "step" in state:
                state["step"] = state["step"].to(device if capturable else "cpu",
                                                 torch.float32)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Each group's LR to ``lr * lr_mult``: a float written, or a device
    tensor filled in place (the graph's form, whose captured update reads
    that tensor)."""
    for group in optimizer.param_groups:
        value = lr * group["lr_mult"]
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(value)
        else:
            group["lr"] = value


def make_lr_schedule(name: str, base_lr: float, *, epochs: int = 15,
                     step_size: int = 8, gamma: float = 0.1,
                     min_lr: float = 1e-7, warmup_epochs: int = 2) -> Callable[[int], float]:
    """Returns epoch (1-based) -> lr. Plateau is ``PlateauScheduler``."""
    name_l = name.lower()
    if "steplr" in name_l:
        def sched(epoch: int) -> float:
            return base_lr * gamma ** ((epoch - 1) // step_size)
        return sched
    if "cosine" in name_l:
        # timm CosineLRScheduler(t_initial=epochs, lr_min, warmup_t,
        # warmup_lr_init=lr_min, warmup_prefix=False, cycle_limit=1,
        # t_in_epochs=True) stepped at epoch end: the lr of epoch e is
        # timm's _get_lr(e-1), pinned to lr_min past the cycle
        def sched(epoch: int) -> float:
            t = epoch - 1
            if t < warmup_epochs:
                return min_lr + t * (base_lr - min_lr) / max(warmup_epochs, 1)
            if t >= epochs:
                return min_lr
            return min_lr + 0.5 * (base_lr - min_lr) * (1 + math.cos(math.pi * t / epochs))
        return sched
    raise ValueError(f"unknown schedule {name!r} (use PlateauScheduler for "
                     "ReduceLROnPlateau)")


class PlateauScheduler:
    """torch.optim.lr_scheduler.ReduceLROnPlateau's semantics on a host
    float: threshold 1e-4 in 'rel' mode, cooldown 0, min_lr 0, eps 1e-8 by
    default; ``step(metric)`` returns the lr of the next epoch."""

    def __init__(self, base_lr: float, mode: str = "min", factor: float = 0.5,
                 patience: int = 5, threshold: float = 1e-4, threshold_mode: str = "rel",
                 cooldown: int = 0, min_lr: float = 0.0, eps: float = 1e-8):
        self.lr = base_lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.cooldown_counter = 0
        self.min_lr = min_lr
        self.eps = eps
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad = 0

    def _is_better(self, a: float) -> bool:
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return a < self.best * (1.0 - self.threshold)
            return a < self.best - self.threshold
        if self.threshold_mode == "rel":
            return a > self.best * (1.0 + self.threshold)
        return a > self.best + self.threshold

    def step(self, metric: float) -> float:
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if self.lr - new_lr > self.eps:
                self.lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        return self.lr
