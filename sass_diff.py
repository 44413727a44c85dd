#!/usr/bin/env python3
"""Compare the SASS of every ``gemm_sm90_kernel`` instantiation in two builds.

    python3 sass_diff.py PARENT_DIR CHANGE_DIR [--match SUBSTRING]

Each directory is a checkout whose kernels have been built
(``build/kernels/<hash>/libqa_tiger_kernels.so``, as the first launch on the
card or ``chip_smoke.py`` leaves them). ``cuobjdump -sass`` (CUDA toolkit)
dumps both libraries; each instantiation's instructions are compared without
their addresses, and names without the per-file hash of the anonymous
namespace they live in. Prints one JSON line: how many instantiations that
both builds hold are the same instruction for instruction, which differ, and
which only one build holds. A change to a header that the GEMM's existing
callers share shows here whether it altered their code. ``--match`` picks
other functions by a substring of their mangled name (``nv_bfloat16``: every
bf16 kernel); a function whose name only one build holds (a kernel that
gained a parameter) is listed with whether the other build holds a function
of the same instructions (``same_code_elsewhere``).
"""
from __future__ import annotations

import glob
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

# the hashes of an anonymous namespace (``_GLOBAL__N__<hash>_``) and of its
# file (``_<n>_<file>_cu_<hash>``), which change with the file's contents
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_|(?<=_cu_)[0-9a-f]{8}")
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
    args = sys.argv[1:]
    match = "gemm_sm90_kernel"
    if "--match" in args:
        i = args.index("--match")
        match = args[i + 1]
        del args[i:i + 2]
    a, b = functions(args[0]), functions(args[1])
    codes = {"first": {c for bodies in a.values() for c in bodies},
             "second": {c for bodies in b.values() for c in bodies}}
    rows, elsewhere = {}, {}
    for name in sorted(set(a) | set(b)):
        if match not in name:
            continue
        if name not in a or name not in b:
            side, other = ("first", "second") if name in a else ("second", "first")
            rows[name] = "only in " + side
            elsewhere[name] = all(c in codes[other] for c in (a if name in a else b)[name])
        else:
            rows[name] = "same" if sorted(a[name]) == sorted(b[name]) else "differs"
    print(json.dumps({"match": match, "same": sum(v == "same" for v in rows.values()),
                      "differs": [k for k, v in rows.items() if v == "differs"],
                      "only": {k: v for k, v in rows.items() if v.startswith("only")},
                      "same_code_elsewhere": elsewhere}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
