"""The run logger.

This package's own copy of ``get_logger`` from
``qa_tiger_tpu/utils/logging.py``: the "AVQA" logger at INFO on the main
process and WARNING on the others, the rank read from ``torch.distributed``
when a process group is up.
"""
from __future__ import annotations

import logging

import torch.distributed as dist

LOGGER_NAME = "AVQA"


def _is_main_process() -> bool:
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def get_logger() -> logging.Logger:
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(logging.INFO if _is_main_process() else logging.WARNING)
    return logger
