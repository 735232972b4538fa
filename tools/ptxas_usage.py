"""Registers, static shared memory and spills of every kernel in a CUDA
source of the port, from ``nvcc -Xptxas -v`` with the port's own flags.

    python3 tools/ptxas_usage.py [csrc name, default tiled_conv]

Prints one JSON line per kernel (demangled where ``c++filt`` is present).
Needs ``nvcc``: run it on the machine with the card.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from canonicalvoting_tpu_torch.ops.cuda_build import CSRC, NVCC_FLAGS, _nvcc  # noqa: E402


def demangle(names):
    if not shutil.which("c++filt"):
        return names
    out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def main() -> int:
    name = sys.argv[1] if len(sys.argv) > 1 else "tiled_conv"
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                            str(Path(tmp) / "lib.so"), str(CSRC / f"{name}.cu")],
                           capture_output=True, text=True)
    log = (r.stdout + r.stderr).splitlines()
    if r.returncode:
        print("\n".join(log), file=sys.stderr)
        return 1
    rows, cur = [], None
    for line in log:
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            rows.append(cur)
        elif cur is not None:
            for key, pat in (("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"),
                             ("static_smem", r"(\d+) bytes smem")):
                m = re.search(pat, line)
                if m:
                    cur[key] = int(m.group(1))
    for row, full in zip(rows, demangle([r["kernel"] for r in rows])):
        row["kernel"] = full
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
