"""JAX parameter pytrees, ``best.npz`` dicts and torch ``.pt`` files ->
PyTorch ``state_dict``.

The JAX package's parameter pytrees mirror torch ``state_dict`` names (dots
become nesting levels), so the port's modules load them after a flatten:

    params['at_aggregator']['experts']['0']['0']['weight']
        -> 'at_aggregator.experts.0.0.weight'

``nested_to_flat`` and ``load_torch_checkpoint`` are this package's own
copies of those in ``qa_tiger_tpu/convert/torch_import.py``;
``state_dict_to_flat`` is its ``state_dict_to_pytree`` without the
nesting. ``clip_import`` reads OpenAI CLIP checkpoints.
"""
from __future__ import annotations

from collections.abc import Mapping
from pathlib import Path
from typing import Any

import numpy as np
import torch


def nested_to_flat(nested: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """Flatten a nested dict pytree into dotted keys."""
    flat: dict[str, np.ndarray] = {}
    for key, value in nested.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(nested_to_flat(value, prefix=name + "."))
        else:
            flat[name] = np.asarray(value)
    return flat


def params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A JAX parameter pytree (nested, leaves as numpy arrays) or an already
    flat dict of dotted names (what a ``best.npz`` holds) -> a ``state_dict``
    of CPU tensors, ready for ``load_state_dict(strict=True)``.

    Floating leaves keep their dtype (the caller casts the module); bf16
    leaves, which numpy holds as ``ml_dtypes.bfloat16``, are widened to fp32.
    """
    flat = nested_to_flat(tree)
    out = {}
    for key, arr in flat.items():
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        out[key] = torch.from_numpy(np.array(arr, copy=True))
    return out


def load_npz(path: str | Path) -> dict[str, torch.Tensor]:
    """Read a ``best.npz`` checkpoint (flat dotted names) as a state_dict."""
    with np.load(path) as data:
        return params_from_jax({k: data[k] for k in data.files})


def state_dict_to_flat(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A torch state_dict (tensors or arrays) -> dotted names -> CPU tensors,
    the ``module.`` prefixes of DataParallel stripped and floating values
    cast to fp32 (fp16 checkpoints widened)."""
    out = {}
    for key, value in state_dict.items():
        while key.startswith("module."):
            key = key[len("module."):]
        t = value.detach().cpu() if torch.is_tensor(value) else torch.as_tensor(np.asarray(value))
        out[key] = t.float() if t.is_floating_point() else t
    return out


def load_torch_checkpoint(path: str | Path) -> dict[str, torch.Tensor]:
    """A torch ``.pt`` state_dict (or a dict holding one under
    ``state_dict``), read with ``weights_only=True``, through
    ``state_dict_to_flat``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, Mapping) and "state_dict" in state:
        state = state["state_dict"]
    return state_dict_to_flat(state)
