"""ctypes binding for the native .npy batch loader.

This package's own copy of ``qa_tiger_tpu/data/native_loader.py``.
``native/npy_batch_loader.cpp`` is compiled with ``g++`` at first use (the
flags on the command line, no Makefile) into ``build/native/<hash of the
source and flags>/`` at the repository root when the package sits in a
checkout, else (an installed package) under the user's cache directory
(``$XDG_CACHE_HOME`` or ``~/.cache``), never into the package, and loaded
with ``ctypes``. ``load_npy_batch(paths, item_shape)`` reads n
float32 .npy files concurrently straight into one contiguous
[n, *item_shape] buffer, without per-file ``np.load`` allocations or the
GIL. A file that is not ``<f4`` in C order is read by numpy; so is every
file when the library cannot be built. Importing this module builds
nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from collections.abc import Sequence
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "npy_batch_loader.cpp"


def _build_root() -> Path:
    repo = Path(__file__).resolve().parents[2]
    if (repo / "pyproject.toml").exists():
        return repo / "build" / "native"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "qa_tiger_tpu_torch" / "native"


BUILD_ROOT = _build_root()
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-pthread"]
LIB_NAME = "libnpy_batch_loader.so"

_lib: ctypes.CDLL | None = None
_build_failed = False
# files read by each path since the last reset_counts(): "native" through
# the library, "numpy" through np.load (the fallback); a loader's prefetch
# thread adds to them
counts = {"native": 0, "numpy": 0}
_counts_lock = threading.Lock()


def reset_counts() -> None:
    with _counts_lock:
        counts.update(native=0, numpy=0)


def _count(path: str, n: int) -> None:
    with _counts_lock:
        counts[path] += n


def _build(out_dir: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir.parent, prefix=".tmp-"))
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp / LIB_NAME), str(SOURCE)],
                       check=True, capture_output=True)
        try:
            os.replace(tmp, out_dir)
        except OSError:  # another process finished the same build first
            if not (out_dir / LIB_NAME).exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _ensure_lib() -> ctypes.CDLL | None:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    try:
        digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
        out_dir = BUILD_ROOT / digest.hexdigest()[:16]
        if not (out_dir / LIB_NAME).exists():
            _build(out_dir)
        lib = ctypes.CDLL(str(out_dir / LIB_NAME))
        lib.qa_tiger_load_npy_batch.restype = ctypes.c_int
        lib.qa_tiger_load_npy_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        _lib = lib
    except Exception:  # no compiler, a failed build or load: numpy reads every file
        logging.getLogger(__name__).warning("native .npy loader unavailable", exc_info=True)
        _build_failed = True
    return _lib


def native_available() -> bool:
    """Whether the library is built and loaded (building it now if not)."""
    return _ensure_lib() is not None


def _numpy_item(path, item_shape: tuple) -> np.ndarray:
    _count("numpy", 1)
    arr = np.load(path).astype(np.float32)
    return arr.reshape(-1)[: int(np.prod(item_shape))].reshape(item_shape)


def load_npy_batch(paths: Sequence[str | os.PathLike], item_shape: Sequence[int],
                   out: np.ndarray | None = None, num_threads: int = 4) -> np.ndarray:
    """Read ``len(paths)`` float32 .npy files into one [n, *item_shape] array.

    Files longer than the item (e.g. full 60-frame caches read at a lower
    frame count) are front-truncated like ``np.load(...)[:n]``. A file the
    library refuses, or every file without the library, is read by numpy.
    """
    n = len(paths)
    item_shape = tuple(int(s) for s in item_shape)
    if out is None:
        out = np.empty((n, *item_shape), np.float32)
    if not out.flags["C_CONTIGUOUS"] or out.dtype != np.float32:
        raise ValueError("out must be a C-contiguous float32 array")

    lib = _ensure_lib()
    if lib is not None and n:
        c_paths = (ctypes.c_char_p * n)(*[os.fsencode(str(p)) for p in paths])
        codes = (ctypes.c_int32 * n)()
        rc = lib.qa_tiger_load_npy_batch(
            c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            int(np.prod(item_shape)), codes, num_threads)
        refused = [i for i, code in enumerate(codes) if code != 0] if rc else []
        _count("native", n - len(refused))
        for i in refused:  # reload only the files the library refused
            out[i] = _numpy_item(paths[i], item_shape)
        return out

    for i, p in enumerate(paths):
        out[i] = _numpy_item(p, item_shape)
    return out
