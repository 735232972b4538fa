"""Reading the device's time out of a ``torch.profiler`` trace.

The traced run profiles a short steady sub-window, with the benchmark's
own ``record_function`` spans around the calls into each layer and one
``window`` span around the whole. The trace goes to a temporary file, is
read here and deleted. Each kernel is charged to the span the host was in
when it launched it (the launch's correlation id), so a span's device time
is the time of the kernels it launched, wherever they ran; an idle gap is
named by the span the host was in at its middle.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    # per span name: device seconds, kernel launches, and per kernel name
    span_device_s: Dict[str, float] = field(default_factory=dict)
    span_kernels: Dict[str, int] = field(default_factory=dict)
    span_kernel_names: Dict[str, Dict[str, Tuple[int, float]]] = field(
        default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    kernel_s: Dict[str, float] = field(default_factory=dict)

    def seconds_matching(self, patterns, span: Optional[str] = None) -> float:
        """Device seconds of the kernels whose name holds any of
        ``patterns``, within ``span`` or anywhere."""
        if span is None:
            items = self.kernel_s.items()
        else:
            items = ((k, v[1]) for k, v in
                     self.span_kernel_names.get(span, {}).items())
        return sum(s for k, s in items if any(p in k for p in patterns))

    def launches_matching(self, patterns, span: str) -> int:
        return sum(n for k, (n, _) in self.span_kernel_names.get(span, {}).items()
                   if any(p in k for p in patterns))


def short(name: str, n: int = 64) -> str:
    return name.replace("(anonymous namespace)::", "")[:n]


def profile(torch):
    """A profiler of the host and the card."""
    from torch.profiler import ProfilerActivity
    return torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        record_shapes=False, with_stack=False, profile_memory=False)


def read(prof, spans) -> TraceSummary:
    """Summarize a finished profiler: ``spans`` are the benchmark's span
    names; the span named ``window`` bounds the window."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return summarize(events, spans)


def summarize(events: List[dict], spans) -> TraceSummary:
    spans = set(spans)
    windows, host_spans, launches, device = [], [], {}, []
    for e in events:
        cat, ph = e.get("cat"), e.get("ph")
        if ph != "X":
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "user_annotation":
            if e["name"] == "window":
                windows.append((ts, ts + dur))
            elif e["name"] in spans:
                host_spans.append((ts, ts + dur, e["name"]))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur, e.get("name", cat),
                           e.get("args", {}).get("correlation"), cat))
    if not windows:
        raise ValueError("the trace has no window span")
    w0, w1 = min(w[0] for w in windows), max(w[1] for w in windows)
    host_spans.sort()
    starts = [s[0] for s in host_spans]

    def span_at(t: float) -> str:
        # the benchmark's spans follow one another and do not nest
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < host_spans[i][1]:
            return host_spans[i][2]
        return "other"

    span_s: Dict[str, float] = defaultdict(float)
    span_n: Dict[str, int] = defaultdict(int)
    span_names: Dict[str, Dict[str, List]] = defaultdict(dict)
    kernel_s: Dict[str, float] = defaultdict(float)
    intervals = []
    for t0, t1, name, corr, cat in device:
        if t1 <= w0 or t0 >= w1:
            continue
        intervals.append((max(t0, w0), min(t1, w1)))
        sec = (t1 - t0) * 1e-6
        kernel_s[name] += sec
        where = span_at(launches[corr]) if corr in launches else "other"
        span_s[where] += sec
        if cat == "kernel":
            span_n[where] += 1
        n_s = span_names[where].setdefault(name, [0, 0.0])
        n_s[0] += 1
        n_s[1] += sec
    intervals.sort()
    busy, gaps = 0.0, []
    cur0 = cur1 = None
    for a, b in intervals:
        if cur1 is None:
            cur0, cur1 = a, b
            if a > w0:
                gaps.append((w0, a))
        elif a > cur1:
            busy += cur1 - cur0
            gaps.append((cur1, a))
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        busy += cur1 - cur0
        if cur1 < w1:
            gaps.append((cur1, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
        span_device_s=dict(span_s), span_kernels=dict(span_n),
        span_kernel_names={k: {n: tuple(v) for n, v in d.items()}
                           for k, d in span_names.items()},
        device_ops=[(short(k), v) for k, v in ops],
        idle_gaps=[(span_at((a + b) / 2), (b - a) * 1e-6) for a, b in gaps[:10]],
        kernel_s=dict(kernel_s))
