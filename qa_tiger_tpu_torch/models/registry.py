"""Model factory: dispatch on the config's ``model_type`` prefix.

Port of ``qa_tiger_tpu/models/registry.py``: names starting with
'QA-TIGER' build ``QATiger``, 'TSPM' the baseline ``TSPM``. A model's
hyperparameters (``model_config``) name their class: ``tspm_config`` sets
``arch="TSPM"``, and a config without ``arch`` is QA-TIGER's.
"""
from __future__ import annotations

import torch

from qa_tiger_tpu_torch.models.qa_tiger import QATiger, qa_tiger_config
from qa_tiger_tpu_torch.models.tspm import TSPM, tspm_config
from qa_tiger_tpu_torch.parallel import distributed, local_rank

MODEL_REGISTRY = {"QA-TIGER": qa_tiger_config, "TSPM": tspm_config}


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
    card for None, "gpu" and "cuda" (raising when there is none): under a
    process group the card of this rank, ``cuda:LOCAL_RANK``."""
    platform = cfg["hyper_params"].get("platform")
    if platform == "cpu":
        return torch.device("cpu")
    if platform in (None, "gpu", "cuda"):
        device = resolve_device(None)
        return torch.device("cuda", local_rank()) if distributed() else device
    raise ValueError(f"hyper_params.platform={platform!r}: expected 'cpu', 'gpu' or 'cuda'")


def model_config(model_type: str, model_kwargs: dict, num_labels: int = 42) -> dict:
    """The model hyperparameters of ``model_type`` (what ``AVQARunner``
    takes), dispatched on its prefix like the JAX package's
    ``build_model``."""
    for prefix, config in MODEL_REGISTRY.items():
        if model_type.startswith(prefix):
            return config(num_labels=num_labels, **dict(model_kwargs))
    raise NotImplementedError(
        f"Model type {model_type} is not implemented; known prefixes: "
        f"{sorted(MODEL_REGISTRY)}")


def model_class(model_cfg: dict) -> type[QATiger] | type[TSPM]:
    """The module class ``model_cfg`` (a ``model_config``) builds."""
    return TSPM if model_cfg.get("arch") == "TSPM" else QATiger


def build_model(model_type: str, model_kwargs: dict, num_labels: int = 42, *,
                device: str | torch.device | None = None, seed: int = 0) -> QATiger | TSPM:
    """The eval-mode model for ``model_type``, its weights drawn from
    ``seed`` on the CPU and then moved to ``device`` (``cuda`` unless
    given)."""
    device = resolve_device(device)
    cfg = model_config(model_type, model_kwargs, num_labels)
    model = model_class(cfg)(cfg, seed=seed)
    return model.eval().requires_grad_(False).to(device)
