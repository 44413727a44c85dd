"""Deterministic seeding.

Port of ``qa_tiger_tpu/utils/seed.py``: the host-side generators that
shuffle data (``random``, numpy's global one) and torch's global generator
are seeded with ``seed + rank``, so each process of a data-parallel run
draws differently and reproducibly (the reference's per-rank offsets,
src/utils.py:55-60). The model's own randomness does not come from these:
``AVQARunner`` draws its weights and its dropout from generators seeded by
its ``seed`` argument.
"""
from __future__ import annotations

import random

import numpy as np
import torch
import torch.distributed as dist


def seed_everything(seed: int, rank: int | None = None) -> torch.Generator:
    """Seed the global generators with ``seed + rank`` and return a CPU
    ``torch.Generator`` seeded with ``seed``, the counterpart of the JAX
    root key. ``rank`` defaults to this process's rank in the
    ``torch.distributed`` group when one is up, else 0."""
    if rank is None:
        rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    np.random.seed(seed + rank)
    random.seed(seed + rank)
    torch.manual_seed(seed + rank)
    return torch.Generator().manual_seed(seed)
