"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` launchers and compiles
alone, in seconds, into ``build/lib<name>.so`` at the repository root. A
library is built on first use, or again when its source is newer than the
built file; :func:`build_all` compiles every source at once, one ``nvcc``
process each. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("tiled_conv", "hv_splat")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    so = _target(name)
    return (not so.exists()
            or so.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime)


def _start(name: str):
    """Start one nvcc; it writes a temporary file, renamed on success."""
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = BUILD / f"lib{name}.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, proc, tmp


def _finish(name: str, proc: subprocess.Popen, tmp: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, _target(name))


def build_all(names=SOURCES) -> float:
    """Compile every stale source in parallel; returns the wall seconds."""
    t0 = time.perf_counter()
    with _lock:
        started = [_start(n) for n in names if _stale(n)]
        errors = []
        for job in started:
            try:
                _finish(*job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first when missing or stale."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if _stale(name):
        build_all((name,))
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]


def check(rc: int, what: str) -> None:
    """Raise on a launcher's nonzero ``cudaGetLastError`` code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
