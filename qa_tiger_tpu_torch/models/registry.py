"""Model factory: dispatch on the config's ``model_type`` prefix.

Port of ``qa_tiger_tpu/models/registry.py`` for the models this package
has: names starting with 'QA-TIGER' build ``QATiger``. The TSPM baseline is
a later slice of the port (ROADMAP.md, A6).
"""
from __future__ import annotations

import torch

from qa_tiger_tpu_torch.models.qa_tiger import QATiger, qa_tiger_config


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA is
    asked for (or implied) and there is none, never falling back."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path on the CPU")
    return device


def select_device(cfg) -> torch.device:
    """The device a config's ``hyper_params.platform`` names: "cpu", or the
    card for None, "gpu" and "cuda" (raising when there is none)."""
    platform = cfg["hyper_params"].get("platform")
    if platform == "cpu":
        return torch.device("cpu")
    if platform in (None, "gpu", "cuda"):
        return resolve_device(None)
    raise ValueError(f"hyper_params.platform={platform!r}: expected 'cpu', 'gpu' or 'cuda'")


def model_config(model_type: str, model_kwargs: dict, num_labels: int = 42) -> dict:
    """The model hyperparameters of ``model_type`` (what ``AVQARunner``
    takes), dispatched on its prefix like the JAX package's
    ``build_model``."""
    if model_type.startswith("QA-TIGER"):
        return qa_tiger_config(num_labels=num_labels, **dict(model_kwargs))
    if model_type.startswith("TSPM"):
        raise NotImplementedError(
            "TSPM is not ported yet (ROADMAP.md, A6: "
            "models/tspm.py)")
    raise NotImplementedError(
        f"Model type {model_type} is not implemented; known prefixes: "
        f"['QA-TIGER']")


def build_model(model_type: str, model_kwargs: dict, num_labels: int = 42, *,
                device: str | torch.device | None = None, seed: int = 0) -> QATiger:
    """The eval-mode model for ``model_type``, its weights drawn from
    ``seed`` on the CPU and then moved to ``device`` (``cuda`` unless
    given)."""
    device = resolve_device(device)
    model = QATiger(model_config(model_type, model_kwargs, num_labels), seed=seed)
    return model.eval().requires_grad_(False).to(device)
