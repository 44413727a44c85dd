"""Masked loss and 9-way question-type accuracy counters.

Port of ``qa_tiger_tpu/training/metrics.py``. The counters stay on the
device (sums indexed by ``qtype_label``); ``accuracy_report`` formats them
with the same log lines, character for character.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from qa_tiger_tpu_torch.data.annotations import NUM_QTYPES, idx2qtype


def masked_nll_sum(logits: torch.Tensor, labels: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """The CE summed over valid samples (padding rows contribute zero); fp32.
    Data-parallel ranks sum it and divide by the summed valid count."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    return (nll * valid.float()).sum()


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Mean CE over valid samples (== nn.CrossEntropyLoss on the unpadded
    batch; padding rows contribute zero); fp32."""
    return masked_nll_sum(logits, labels, valid) / valid.float().sum().clamp(min=1.0)


def qtype_counters(logits: torch.Tensor, labels: torch.Tensor, qtype_label: torch.Tensor,
                   valid: torch.Tensor):
    """(correct, total, correct_per_type [9], total_per_type [9]), int64 on
    the logits' device."""
    valid = valid.bool()
    ok = (logits.argmax(dim=-1) == labels.long()) & valid
    q = qtype_label.long()
    tot9 = torch.zeros(NUM_QTYPES, dtype=torch.int64, device=logits.device)
    cor9 = torch.zeros_like(tot9)
    tot9.index_add_(0, q, valid.long())
    cor9.index_add_(0, q, ok.long())
    return ok.long().sum(), valid.long().sum(), cor9, tot9


def accuracy_report(correct: int, total: int, cor9, tot9, log_fn, prefix: str = "Test",
                    epoch: int | None = None, writer=None,
                    writer_tag: str = "valid/acc") -> dict[str, float]:
    """Per-type / per-modality / total accuracy logging with the reference's
    format (src/trainutils.py:370-392, 443-461). Returns the accuracy dict."""
    head = f"Epoch {epoch} -" if epoch is not None else prefix
    out: dict[str, float] = {}
    cor9 = [int(x) for x in cor9]
    tot9 = [int(x) for x in tot9]
    by_mod: dict[str, tuple[int, int]] = {}
    for idx, (mod, qt) in enumerate(idx2qtype):
        c, t = cor9[idx], tot9[idx]
        mc, mt = by_mod.get(mod, (0, 0))
        by_mod[mod] = (mc + c, mt + t)
        value = c / t * 100.0 if t else 0.0
        key = f"{mod}/{qt}"
        out[key] = value
        log_fn(f"{head} {key:>24} accuracy: {value:.2f}({c}/{t})")
        if writer is not None and epoch is not None:
            writer.add_scalar(f"{writer_tag}/{key}", value, epoch)
    for mod, (mc, mt) in by_mod.items():
        value = mc / mt * 100.0 if mt else 0.0
        out[mod] = value
        log_fn(f"{head} {mod:>24} accuracy: {value:.2f}({mc}/{mt})")
        if writer is not None and epoch is not None:
            writer.add_scalar(f"{writer_tag}/{mod}", value, epoch)
    acc = correct / total * 100.0 if total else 0.0
    out["Total"] = acc
    key = "Total" if epoch is not None else "Total avg"
    log_fn(f"{head} {key:>24} accuracy: {acc:.2f}({correct}/{total})")
    return out
