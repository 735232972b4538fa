"""``BENCHMARK.json`` and the files it names, found by name.

A workload names a configuration and a traffic mix; each is a JSON file of
its own (``configs/<file>``, ``traffic/<traffic>.json``). A per-layer metric
is a reader ``metrics/<name>.py``; the limits of a workload's comparison
are ``limits/<workload>.json``. Adding a cell or a metric adds files and
edits none.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parents[1]     # perfbench/
ROOT = HERE.parent                             # the checkout


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]     # the metrics this cell reports untraced
    per_layer: List[dict]      # the metrics this cell reports traced
    limits: Dict[str, float]


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` with its configuration, traffic, metrics and
    limits; a name the manifest lacks raises ``KeyError``."""
    bench = load_benchmark(root)
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(wl)})")
    w = wl[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(root / "perfbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in moved and _reports(m, name)]
    with open(root / "perfbench" / "limits" / f"{name}.json") as f:
        limits = json.load(f)["limits"]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer, limits)


def metric_reader(name: str) -> Callable:
    """``read(record) -> float | None`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(kind: str):
    """The driver module ``drivers/<kind>.py`` a configuration names."""
    return importlib.import_module(f"drivers.{kind}")
