"""JAX parameter pytrees, ``best.npz`` dicts and torch ``.pt`` files ->
PyTorch ``state_dict``.

The JAX package's parameter pytrees mirror torch ``state_dict`` names (dots
become nesting levels), so the port's modules load them after a flatten:

    params['at_aggregator']['experts']['0']['0']['weight']
        -> 'at_aggregator.experts.0.0.weight'

``nested_to_flat`` and ``load_torch_checkpoint`` are this package's own
copies of those in ``qa_tiger_tpu/convert/torch_import.py``;
``state_dict_to_flat`` is its ``state_dict_to_pytree`` without the
nesting; ``save_torch_checkpoint`` writes the ``.pt`` files the JAX
package's ``load_torch_checkpoint`` reads. ``clip_import`` reads OpenAI
CLIP checkpoints.
"""
from __future__ import annotations

from collections.abc import Iterable, Mapping
from pathlib import Path
from typing import Any

import numpy as np
import torch


def nested_to_flat(nested: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """Flatten a nested dict pytree into dotted keys, leaves as numpy arrays."""
    return {k: np.asarray(v) for k, v in _flatten(nested, prefix).items()}


def _flatten(nested: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    """Flatten a nested dict pytree into dotted keys, leaves as they are."""
    flat: dict[str, Any] = {}
    for key, value in nested.items():
        if isinstance(value, Mapping):
            flat.update(_flatten(value, prefix=f"{prefix}{key}."))
        else:
            flat[f"{prefix}{key}"] = value
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


def save_torch_checkpoint(params: Mapping[str, Any], path: str | Path,
                          exclude_prefixes: Iterable[str] = ()) -> None:
    """Write a state_dict (tensors or arrays, flat or nested) as a torch
    ``.pt`` file of CPU tensors, names under ``exclude_prefixes`` left out:
    the port's counterpart of ``qa_tiger_tpu/convert/torch_import.py``
    ``save_torch_checkpoint``, whose ``load_torch_checkpoint`` reads it back.
    bf16 values (a frozen tower on the card) are widened to fp32, which
    numpy, and so the JAX reader, can hold."""
    exclude = tuple(exclude_prefixes)
    state = {}
    for key, value in _flatten(params).items():
        if exclude and key.startswith(exclude):
            continue
        # np.array, not np.ascontiguousarray (which the JAX writer uses): the
        # latter makes a 0-d value (logit_scale) 1-d
        t = value.detach().cpu() if torch.is_tensor(value) else torch.from_numpy(np.array(value))
        state[key] = (t.float() if t.dtype == torch.bfloat16 else t).contiguous()
    torch.save(state, path)

