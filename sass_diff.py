#!/usr/bin/env python3
"""Compare the SASS of every ``gemm_sm90_kernel`` instantiation in two builds.

    python3 sass_diff.py PARENT_DIR CHANGE_DIR

Each directory is a checkout whose kernels have been built
(``build/kernels/<hash>/libqa_tiger_kernels.so``, as the first launch on the
card or ``chip_smoke.py`` leaves them). ``cuobjdump -sass`` (CUDA toolkit)
dumps both libraries; each instantiation's instructions are compared without
their addresses, and names without the per-file hash of the anonymous
namespace they live in. Prints one JSON line: how many instantiations that
both builds hold are the same instruction for instruction, which differ, and
which only one build holds. A change to a header that the GEMM's existing
callers share shows here whether it altered their code.
"""
from __future__ import annotations

import glob
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_")
ADDRESS = re.compile(r"/\*[0-9a-f]{4,}\*/")


def cuobjdump() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    return shutil.which("cuobjdump") or str(Path(CUDA_HOME or "") / "bin" / "cuobjdump")


def functions(root: str) -> dict:
    """Instruction listings by normalised function name (one per object
    file that holds the function)."""
    lib = glob.glob(f"{root}/build/kernels/*/libqa_tiger_kernels.so")[0]
    out = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    found = {}
    for chunk in out.split("Function : ")[1:]:
        name, body = chunk.split("\n", 1)
        code = [ANON.sub("", ADDRESS.sub("", ln)).strip() for ln in body.splitlines()
                if ADDRESS.match(ln.strip())]
        found.setdefault(ANON.sub("", name.strip()), []).append("\n".join(code))
    return found


def main() -> int:
    a, b = functions(sys.argv[1]), functions(sys.argv[2])
    rows = {}
    for name in sorted(set(a) | set(b)):
        if "gemm_sm90_kernel" not in name:
            continue
        if name not in a or name not in b:
            rows[name] = "only in " + ("first" if name in a else "second")
        else:
            rows[name] = "same" if sorted(a[name]) == sorted(b[name]) else "differs"
    print(json.dumps({"same": sum(v == "same" for v in rows.values()),
                      "differs": [k for k, v in rows.items() if v == "differs"],
                      "only": {k: v for k, v in rows.items() if v.startswith("only")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
