"""Per-phase wall timing and device traces.

Counterpart of ``canonicalvoting_tpu/utils/profiling.py``: :class:`PhaseTimer`
sums wall time by named phase, waiting for the card at the end of a phase
when it is handed a CUDA tensor (the launches are asynchronous, so a host
clock alone times the enqueue), with the JAX package's summary keys and
rounding; :func:`device_trace` records a ``torch.profiler`` trace (the JAX
package's ``jax.profiler`` trace) and writes it into ``logdir`` as a Chrome
trace (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

logger = logging.getLogger(__name__)


def _cuda_devices(value) -> set:
    """The CUDA devices of the tensors in ``value`` (a tensor, or a list,
    tuple or dict of them, nested)."""
    if torch.is_tensor(value):
        return {value.device} if value.is_cuda else set()
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        return set().union(*(_cuda_devices(v) for v in value))
    return set()


class PhaseTimer:
    """Accumulates wall time per named phase; a ``sync_value`` holding CUDA
    tensors makes the phase wait for their devices, so timings are real."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for device in _cuda_devices(sync_value):
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": round(self.totals[k], 4),
                "count": self.counts[k],
                "mean_ms": round(1000 * self.totals[k] / max(self.counts[k], 1), 3),
            }
            for k in sorted(self.totals)
        }

    def log(self):
        for name, row in self.summary().items():
            logger.info("phase %-20s %6.1f ms x %d", name, row["mean_ms"],
                        row["count"])

    def dump_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """A ``torch.profiler`` trace of the host and, where there is one, the
    card, written to ``logdir/trace_<pid>_<ns>.json`` on exit; no-op when
    logdir=None. Yields the profiler (None for no trace)."""
    if logdir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
