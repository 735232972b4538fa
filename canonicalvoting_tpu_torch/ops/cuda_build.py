"""Build the port's native sources and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` launchers and compiles
alone with ``nvcc``, in seconds, into ``build/lib<name>.so`` at the
repository root; ``csrc/coords_native.c``, the host coordinate manager,
compiles the same way with ``cc`` (no ``-march=native``: the library must
run on any x86-64 host that loads it). A library is built on first use, or
again when its source is newer than the built file; :func:`build_all`
compiles every source at once, one compiler process each. A failed build
raises. Nothing here runs at import time.
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
SOURCES = ("tiled_conv", "hv_splat", "coords_native")
#: the sources built for the host with cc; every other one is CUDA
HOST_SOURCES = ("coords_native",)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
CC_FLAGS = ["-O3", "-shared", "-fPIC"]

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


def _cc() -> str:
    found = shutil.which("cc") or shutil.which("gcc")
    if found:
        return found
    raise RuntimeError("cc not found: the native coordinate manager cannot "
                       "be built")


def _source(name: str) -> Path:
    return CSRC / (f"{name}.c" if name in HOST_SOURCES else f"{name}.cu")


def _target(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    so = _target(name)
    return (not so.exists()
            or so.stat().st_mtime < _source(name).stat().st_mtime)


def _start(name: str):
    """Start one compiler; it writes a temporary file, renamed on success."""
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = BUILD / f"lib{name}.{os.getpid()}.so"
    compiler = ([_cc(), *CC_FLAGS] if name in HOST_SOURCES
                else [_nvcc(), *NVCC_FLAGS])
    cmd = [*compiler, "-o", str(tmp), str(_source(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, proc, tmp


def _finish(name: str, proc: subprocess.Popen, tmp: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"build failed for {_source(name).relative_to(CSRC.parent)}:"
                           f"\n{log}")
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


def launcher(lib: str, argtypes: Dict[str, list], name: str):
    """``lib<lib>.so``'s launch function ``name``, its ctypes argument types
    (``argtypes[name]``) bound on first use; it returns a CUDA error code."""
    fn = getattr(library(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes[name]
        fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str) -> None:
    """Raise on a launcher's nonzero ``cudaGetLastError`` code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
