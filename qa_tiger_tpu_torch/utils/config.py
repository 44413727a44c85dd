"""Read the repository's python-module configs (``configs/qa-tiger/*.py``).

A config file is a plain module with a module-level ``config = dict(...)``.
This package's own copy of the loader half of
``qa_tiger_tpu/utils/config.py``; the port indexes the dict directly.
"""
from __future__ import annotations

import importlib.util


def load_config_module(path: str) -> dict:
    """Execute a python config file and return its ``config`` dict."""
    spec = importlib.util.spec_from_file_location("config", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"cannot load config module from {path!r}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.config
