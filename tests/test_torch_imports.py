"""Boundaries of the port: it imports neither JAX, nor the JAX package, nor
``regex`` (the card's machine may lack it), importing it builds no kernel,
and its entry points never fall back from CUDA to the CPU on their own."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "qa_tiger_tpu_torch").rglob("*.py")) + [
    REPO / name for name in ("chip_smoke.py", "chip_ab.py", "sass_diff.py")]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "qa_tiger_tpu", "regex")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_package_builds_nothing():
    code = (
        "import pkgutil, sys, importlib\n"
        "import qa_tiger_tpu_torch\n"
        "for m in pkgutil.walk_packages(qa_tiger_tpu_torch.__path__, 'qa_tiger_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from qa_tiger_tpu_torch.ops import _build\n"
        "assert _build._lib is None and _build.build_seconds is None\n"
        "from qa_tiger_tpu_torch.data import native_loader\n"
        "assert native_loader._lib is None and not native_loader._build_failed\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'qa_tiger_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_predictor_without_a_gpu_raises(monkeypatch):
    from qa_tiger_tpu_torch.models import build_model
    from qa_tiger_tpu_torch.predict import Predictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = REPO / "configs" / "qa-tiger" / "vitl14.py"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model("QA-TIGER_ViTL14@336px", {})
