"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` have a plain C interface. At the first launch on
a CUDA tensor they are compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc``
per source, all started together, then one link) into one shared library
under ``build/kernels/<hash>/`` at the repository root, and loaded with
``ctypes``. The hash covers the sources, the headers and the flags, so an
edited kernel is rebuilt and an unchanged one is reused. Importing this
module builds nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libqa_tiger_kernels.so"

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# argument types of every exported C function (csrc/*.cu); each returns the
# launch's cudaError_t as an int
SIGNATURES = {
    # attention_wide and fused_attention: q, k, v, the output, the mask and
    # the dimensions, the scale, then (qt_attention only) where to write the
    # kernel launched, the lane split's score scratch (null for any other
    # kernel), the stream
    "qt_attention": [_I, _P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _L, _L, _P,
                     _P, _I, _I, _I, _I, _I, _F, _P, _P, _P],
    "qt_fused_attention": [_I, _P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _P,
                           _I, _I, _I, _I, _F, _P, _P],
    # not a launcher: the kernel family qt::attention takes (0 fma, 1 mma,
    # 2 mma_short, 3 mma_keep, 4 mma_nokeep, 5 tf32x3, 6 wgmma)
    "qt_attention_route": [_I, _I, _I, _I, _I, _I],
    # not a launcher: the kernel and shared memory of qt::attention_plan
    # (ops/attention.py KERNEL_NAMES), and the device's opt-in limit per block
    "qt_attention_plan": [_I, _I, _I, _I, _I, _I, _P],
    "qt_smem_optin": [],
    # not a launcher: the Hopper attention's measurement switch (0 the plan
    # every call gets, 1 its calls on the mma kernel, 2 every length past
    # 128 keys); returns the mode before
    "qt_attention_sm90_mode": [_I],
    # not a launcher: the kernel and shared memory of qt::attention_bwd_plan
    "qt_attention_bwd_plan": [_I, _I, _I, _I, _I, _P],
    # the keep-masked tensor-core attention, forward and backward, alone
    # (ops/avq.py attention_keep, attention_keep_bwd)
    "qt_attention_keep": [_I] + [_P, _L, _L] * 4 + [_P, _L] + [_I] * 5 + [_F, _I, _P],
    "qt_attention_keep_bwd": [_I] + [_P, _L, _L] * 7 + [_P, _L] + [_I] * 5 + [_F, _I, _I, _P],
    # not a launcher: the GEMM routine of a fused kernel's product (0 fma,
    # 1 wmma, 2 wgmma)
    "qt_gemm_route": [_I, _I, _I, _I],
    # the Hopper GEMM alone (ops/gemm.py), for its checks and timing
    "qt_gemm_sm90": [_I, _P, _L, _P, _L, _P, _L, _P, _P, _L, _I, _I, _I, _I, _P],
    # the train backwards' fp32 tensor-core GEMM alone (ops/gemm.py)
    "qt_gemm_tf32x3": [_P, _L, _I, _P, _L, _I, _P, _L, _I, _I, _I, _I, _P, _L, _P],
    "qt_gaussian_moe": [_I, _I, _I, _P, _P, _P, _P, _L, _P, _P, _P, _L, _P, _P, _P, _L,
                        _I, _I, _I, _I, _I, _I, _I, _P],
    # the attention halves: then the GEMM plan and its rows (none in bf16),
    # the attention rows and their count, the split-K workspace and its
    # floats (ops/gemm.py launch_plan)
    "qt_attn_ln2": [_I] + [_P] * 15 + [_I] * 4 + [_P, _I, _P, _I, _P, _L, _P],
    "qt_attn_half": [_I] + [_P] * 12 + [_I] * 4 + [_P, _I, _P, _I, _P, _L, _P],
    "qt_mlp_half": [_I] + [_P] * 10 + [_I] * 3 + [_P],
    # the eval PatchSelecter and its stages: then the GEMM plan and its rows,
    # the attention rows and their count (none in tp_mlp), the split-K
    # workspace and its floats (ops/gemm.py launch_plan)
    "qt_patch_select": [_I] + [_P] * 30 + [_I] * 4 + [_P, _I, _P, _I, _P, _L, _P],
    # the tensor-parallel stages (parallel/tensor.py): partials and epilogues
    "qt_attn_ln2_partial": [_I] + [_P] * 11 + [_I] * 5 + [_P, _I, _P, _I, _P, _L, _P],
    "qt_reduce_epilogue": [_I, _I] + [_P] * 7 + [_I, _I, _P],
    "qt_patch_select_tp_self": [_I] + [_P] * 7 + [_I] * 5 + [_P, _I, _P, _I, _P, _L, _P],
    "qt_patch_select_tp_cross": [_I] + [_P] * 10 + [_I] * 5 + [_P, _I, _P, _I, _P, _L, _P],
    "qt_patch_select_tp_mlp": [_I] + [_P] * 6 + [_I] * 3 + [_P, _I, _P, _I, _P, _L, _P],
    "qt_patch_select_tp_out": [_I] + [_P] * 8 + [_I] * 2 + [_P],
    # attention_wide's two stages for a head split by lanes
    "qt_attention_tp_scores": [_I, _P, _L, _L, _P, _L, _L, _P, _I, _I, _I, _I, _P],
    "qt_attention_tp_pv": [_I, _P, _P, _L, _L, _P, _P, _L, _L, _I, _I, _I, _I, _F, _P],
    # the train kernels take one table of device pointers (index order: the
    # Buf enum of their source, the BUFFERS lists of ops/avq.py and
    # ops/patch_select.py), then the dimensions, the GEMM plan and its rows,
    # the attention rows (ops/attention.py keep_rows) and their count, the
    # split-K workspace's floats
    "qt_avq_train_fwd": [_I, _P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _L, _P],
    "qt_avq_train_bwd": [_I, _P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _L, _P],
    "qt_patch_select_train_fwd": [_I, _P, _I, _I, _I, _I, _P, _I, _P, _I, _L, _P],
    "qt_patch_select_train_bwd": [_I, _P, _I, _I, _I, _I, _P, _I, _P, _I, _L, _P],
    # the train kernels' tensor-parallel stages: the same pointer tables,
    # then the rank's dimensions and whether it adds the residual gradient
    **{name: [_I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _I, _L, _P] for name in (
        "qt_avq_train_tp_attn", "qt_avq_train_tp_mid", "qt_avq_train_tp_out",
        "qt_avq_train_bwd_tp_ffn", "qt_avq_train_bwd_tp_attn")},
    **{name: [_I, _P, _I, _I, _I, _I, _I, _I, _P, _I, _P, _I, _L, _P] for name in (
        "qt_patch_select_train_tp_self", "qt_patch_select_train_tp_cross",
        "qt_patch_select_train_tp_mlp", "qt_patch_select_train_tp_out",
        "qt_patch_select_train_bwd_tp_mlp", "qt_patch_select_train_bwd_tp_cross",
        "qt_patch_select_train_bwd_tp_self")},
    "qt_avq_num_buffers": [],
    "qt_patch_select_train_num_buffers": [],
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of this process's build
build_log: Path | None = None       # nvcc's output (-Xptxas -v) of the build


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under CUDA_HOME")


def _compile(out_dir: Path) -> None:
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(dir=out_dir.parent, prefix=".tmp-"))
    try:
        procs = []
        for src in sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        log, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n"
                       + out.decode(errors="replace"))
            if proc.returncode:
                failed.append(src.name)
        (tmp / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / LIB_NAME),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        try:
            os.replace(tmp, out_dir)
        except OSError:
            # another process finished the same build first
            if not (out_dir / LIB_NAME).exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    build yet."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    out_dir = BUILD_ROOT / _digest()
    if not (out_dir / LIB_NAME).exists():
        BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        start = time.perf_counter()
        _compile(out_dir)
        build_seconds = time.perf_counter() - start
    build_log = out_dir / "build.log"
    lib = ctypes.CDLL(str(out_dir / LIB_NAME))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.qt_error_string.argtypes = [ctypes.c_int]
    lib.qt_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def launch(name: str, *args) -> None:
    """Call one exported C launcher on PyTorch's current CUDA stream; raise
    if it reports a CUDA error (``cudaGetLastError`` after its launches).

    While ``torch.profiler`` records, the call runs inside a region named
    after the launcher (``qt_attn_ln2``, ...), so that a trace ties each
    device kernel to the launch that made it (``trace_summary``)."""
    import torch

    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    if torch._C._autograd._profiler_enabled():
        from torch.profiler import record_function

        with record_function(name):
            err = getattr(lib, name)(*args, stream)
    else:
        err = getattr(lib, name)(*args, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({lib.qt_error_string(err).decode()})")


def launch_table(name: str, count_fn: str, names: list[str], bufs: dict, *args) -> None:
    """Call a C launcher that takes ``(dtype, pointer table, *args, stream)``.

    ``names`` orders the table as the source's enum does; a name missing from
    ``bufs`` passes a null pointer (a buffer the launcher does not touch).
    ``count_fn`` names the exported function that returns the enum's length,
    checked here against ``len(names)``. The first name is the activation
    input, whose dtype selects the kernel."""
    lib = library()
    n = getattr(lib, count_fn)()
    if n != len(names):
        raise RuntimeError(f"{name}: the kernel takes {n} buffers, the wrapper names "
                           f"{len(names)}")
    table = (ctypes.c_void_p * n)(*[ptr(bufs.get(key)) for key in names])
    launch(name, dtype_code(bufs[names[0]]), ctypes.addressof(table), *args)


def dtype_code(t) -> int:
    """0 for float32, 1 for bfloat16 (of a tensor or a dtype); the kernels
    take no other type."""
    import torch

    dtype = t if isinstance(t, torch.dtype) else t.dtype
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"CUDA kernels take float32 or bfloat16, got {dtype}")


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()
