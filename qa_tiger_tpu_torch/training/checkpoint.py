"""Checkpoints: portable ``best.npz`` parameter snapshots and full train-state
resume.

Port of ``qa_tiger_tpu/training/checkpoint.py``. ``best.npz`` is the JAX
package's format: the flat dotted state_dict names, ``video_encoder*``
stripped (the reference's src/train.py:72-86), floats as fp32; either
package reads what the other writes. The train state (trainable parameters,
Adam's state, the dropout stream's generator state, host scalars) is a
directory holding ``state.pt`` (``torch.save``) and ``meta.json``; the JAX
package's orbax layout has no counterpart here, and its async save is a
background thread.
"""
from __future__ import annotations

import json
import os
import threading
from collections.abc import Iterable, Mapping
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np
import torch

from qa_tiger_tpu_torch.convert import load_npz, load_torch_checkpoint
from qa_tiger_tpu_torch.convert.clip_import import convert_clip_checkpoint

STATE_FILE, META_FILE = "state.pt", "meta.json"
# the entries of a train state (AVQARunner.train_state) that go to
# STATE_FILE; every other entry is a host scalar for META_FILE
TENSOR_ENTRIES = ("params", "opt_state", "step_rng")


def save_checkpoint(params: Mapping[str, Any], path: str | Path,
                    exclude_prefixes: Iterable[str] = ("video_encoder",)) -> None:
    """Write a state_dict (tensors or arrays) as ``best.npz``: names under
    ``exclude_prefixes`` left out, floats stored as fp32 (the frozen tower
    may be bf16, which numpy cannot hold; the runner casts it back on
    load)."""
    exclude = tuple(exclude_prefixes)
    flat = {}
    for key, value in params.items():
        if exclude and key.startswith(exclude):
            continue
        t = value.detach() if torch.is_tensor(value) else torch.as_tensor(np.asarray(value))
        flat[key] = (t.float() if t.is_floating_point() else t).cpu().numpy()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)


def load_checkpoint(path: str | Path, base_params: Mapping[str, torch.Tensor] | None = None
                    ) -> tuple[dict[str, torch.Tensor], list[str], list[str]]:
    """Read ``best.npz`` (or a torch ``.pt`` state_dict) as a state_dict of
    CPU tensors and lay it over ``base_params``, as
    ``load_state_dict(strict=False)`` would: returns (params, missing,
    unexpected), the key lists the reference logs (src/trainutils.py:98-100).
    A value whose shape differs from the base's is unexpected and skipped."""
    path = Path(path)
    loaded = load_torch_checkpoint(path) if path.suffix == ".pt" else load_npz(path)
    if base_params is None:
        return loaded, [], []
    merged = dict(base_params)
    unexpected = []
    for key, value in loaded.items():
        if key in base_params and tuple(base_params[key].shape) == tuple(value.shape):
            merged[key] = value
        else:
            unexpected.append(key)
    missing = [key for key in base_params if key not in loaded]
    return merged, missing, unexpected


def load_clip_text_state(path: str | Path) -> dict[str, torch.Tensor]:
    """The CLIP text tower's state_dict (names under ``quest_encoder.``
    without that prefix) from a CLIP ``.pt`` (TorchScript archive or
    state_dict, its text keys through ``convert.clip_import``) or an
    ``.npz`` of the text tower (bare names, or under ``quest_encoder.``)."""
    if str(path).endswith(".pt"):
        text, _, _ = convert_clip_checkpoint(path)
        return text
    text, _, _ = load_checkpoint(path)
    prefix = "quest_encoder."
    if any(k.startswith(prefix) for k in text):
        text = {k[len(prefix):]: v for k, v in text.items() if k.startswith(prefix)}
    return text


def save_train_state(state: Mapping[str, Any], path: str | Path) -> None:
    """A full resume checkpoint (``AVQARunner.train_state``) into the
    directory ``path``: ``params``, ``opt_state`` and ``step_rng`` through
    ``torch.save``, the other entries (host scalars) as JSON. Each file is
    written beside its final name and then renamed over it."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tensors = {k: state[k] for k in TENSOR_ENTRIES if k in state}
    meta = {k: v for k, v in state.items() if k not in TENSOR_ENTRIES}
    torch.save(tensors, path / (STATE_FILE + ".tmp"))
    (path / (META_FILE + ".tmp")).write_text(json.dumps(meta))
    for name in (STATE_FILE, META_FILE):
        os.replace(path / (name + ".tmp"), path / name)


def load_train_state(path: str | Path) -> dict[str, Any]:
    """What ``save_train_state`` wrote: tensors on the CPU (the runner's
    ``restore_train_state`` moves them to its device), scalars as saved."""
    path = Path(path)
    if not (path / STATE_FILE).exists():
        raise FileNotFoundError(f"no train state at {path}")
    state = torch.load(path / STATE_FILE, map_location="cpu", weights_only=True)
    state.update(json.loads((path / META_FILE).read_text()))
    return state


def _to_host(obj: Any) -> Any:
    """A copy of ``obj`` with every tensor copied to the CPU (synchronously,
    so the copy holds the values of this moment)."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, Mapping):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


# the background writer of save_train_state_async and its save in flight
_LOCK = threading.Lock()
_SAVER: ThreadPoolExecutor | None = None
_PENDING: Future | None = None


def save_train_state_async(state: Mapping[str, Any], path: str | Path) -> None:
    """``save_train_state`` on a background thread. Every tensor is copied to
    the host before this returns, so later steps cannot change what is
    written. At most one save is in flight: this first waits for the one
    before, and raises its error if it failed. Call ``wait_for_async_saves``
    before the process exits."""
    global _SAVER, _PENDING
    host = _to_host(dict(state))
    with _LOCK:
        pending, _PENDING = _PENDING, None
        if pending is not None:
            pending.result()
        if _SAVER is None:
            _SAVER = ThreadPoolExecutor(max_workers=1, thread_name_prefix="train-state-save")
        _PENDING = _SAVER.submit(save_train_state, host, path)


def wait_for_async_saves() -> None:
    """Blocks until the save in flight, if any, is written; raises its
    error if it failed."""
    global _PENDING
    with _LOCK:
        pending, _PENDING = _PENDING, None
    if pending is not None:
        pending.result()
