"""Training: metrics, optimizer and schedules, checkpoints, and the
AVQARunner.

Port of ``qa_tiger_tpu/training``."""
from qa_tiger_tpu_torch.data.annotations import NUM_QTYPES, idx2qtype
from qa_tiger_tpu_torch.training.checkpoint import (
    load_checkpoint,
    load_train_state,
    save_checkpoint,
    save_train_state,
    save_train_state_async,
    wait_for_async_saves,
)
from qa_tiger_tpu_torch.training.loop import AVQARunner
from qa_tiger_tpu_torch.training.metrics import (
    accuracy_report,
    masked_cross_entropy,
    qtype_counters,
)
from qa_tiger_tpu_torch.training.optim import (
    PlateauScheduler,
    lr_multipliers,
    make_lr_schedule,
    make_optimizer,
)

__all__ = [
    "AVQARunner",
    "NUM_QTYPES",
    "PlateauScheduler",
    "accuracy_report",
    "idx2qtype",
    "load_checkpoint",
    "load_train_state",
    "lr_multipliers",
    "make_lr_schedule",
    "make_optimizer",
    "masked_cross_entropy",
    "qtype_counters",
    "save_checkpoint",
    "save_train_state",
    "save_train_state_async",
    "wait_for_async_saves",
]
