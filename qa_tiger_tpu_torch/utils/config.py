"""Config system: python-module configs, an attribute-access dict, and the
command line's overrides.

This package's own copy of ``qa_tiger_tpu/utils/config.py`` (the
reference's src/utils.py:31-43 argparse flags and :63-79 config exec, Box
wrap and overrides) without ``python-box``. A config file is a plain Python
module with a module-level ``config = dict(...)``
(``configs/qa-tiger/vitl14.py``). ``Box`` is a dict, so code that indexes
the config (``cfg["hyper_params"]``) reads it unchanged.
"""
from __future__ import annotations

import argparse
import importlib.util
from typing import Any


class Box(dict):
    """Minimal attribute-access dict, recursive, mutation-friendly.

    Drop-in for the subset of ``python-box.Box`` the framework uses:
    ``cfg.data.batch_size`` style reads, ``cfg.mode = 'test'`` style writes,
    and plain-dict behaviour everywhere else (json.dumps works on it).
    """

    def __init__(self, data: dict | None = None, **kwargs: Any):
        super().__init__()
        merged = dict(data or {})
        merged.update(kwargs)
        for key, value in merged.items():
            self[key] = self._wrap(value)

    @classmethod
    def _wrap(cls, value: Any) -> Any:
        if isinstance(value, Box):
            return value
        if isinstance(value, dict):
            return cls(value)
        if isinstance(value, (list, tuple)):
            return type(value)(cls._wrap(v) for v in value)
        return value

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as exc:  # pragma: no cover - mirrors Box semantics
            raise AttributeError(name) from exc

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = self._wrap(value)

    def __setitem__(self, name: str, value: Any) -> None:
        super().__setitem__(name, self._wrap(value))

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as exc:  # pragma: no cover
            raise AttributeError(name) from exc

    def get(self, name: str, default: Any = None) -> Any:
        return super().get(name, default)

    def to_dict(self) -> dict:
        out: dict = {}
        for key, value in self.items():
            if isinstance(value, Box):
                out[key] = value.to_dict()
            elif isinstance(value, (list, tuple)):
                out[key] = type(value)(
                    v.to_dict() if isinstance(v, Box) else v for v in value
                )
            else:
                out[key] = value
        return out


def load_config_module(path: str) -> Box:
    """Exec a python config file and return its ``config`` dict wrapped in Box.

    Reference: src/utils.py:64-68 (importlib.util.spec_from_file_location).
    """
    spec = importlib.util.spec_from_file_location("config", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"cannot load config module from {path!r}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return Box(module.config)


def arg_parse(argv: list[str] | None = None) -> argparse.Namespace:
    """CLI surface parity with the reference (src/utils.py:31-43)."""
    parser = argparse.ArgumentParser(
        description="Audio-Visual Question Answering (PyTorch / CUDA)"
    )
    parser.add_argument("--config", type=str, required=True,
                        help="Path to the config file")
    parser.add_argument("--distributed", action="store_true",
                        help="Data parallelism, one process per card, under torchrun")
    parser.add_argument("--debug", action="store_true", help="Debugging")
    parser.add_argument("--weight", type=str, default="",
                        help="Path to the model weight file (.pt or .npz)")
    parser.add_argument("--mode", type=str, default="train",
                        help="Mode (train or test)")
    parser.add_argument("--topK", type=int, default=-1,
                        help="topK number for selection of experts")
    parser.add_argument("--n_experts", type=int, default=-1,
                        help="Number of experts")
    parser.add_argument("--seed", type=int, default=713, help="Random seed")
    parser.add_argument("--output_path", type=str, default="",
                        help="Path to save the output")
    return parser.parse_args(argv)


def build_config(args: argparse.Namespace) -> Box:
    """Load config and apply CLI overrides.

    Override semantics follow the reference exactly (src/utils.py:69-79):
    seed/mode/debug/output_path always override; ``--weight`` only overrides
    outside test mode (in test mode the weight comes from the CLI and is
    required by the test entry point itself); topK/n_experts override when
    positive.
    """
    cfg = load_config_module(args.config)
    cfg.seed = args.seed
    cfg.mode = args.mode
    cfg.debug = args.debug
    if args.mode != "test":
        cfg.weight = args.weight
    else:
        cfg.weight = args.weight or cfg.get("weight", "")
    cfg.output_path = args.output_path

    if args.topK > 0:
        cfg.hyper_params.model.topK = args.topK
    if args.n_experts > 0:
        cfg.hyper_params.model.num_experts = args.n_experts
    return cfg
