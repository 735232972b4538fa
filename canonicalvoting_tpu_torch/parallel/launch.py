"""Run calls on several ranks of one host.

:func:`run_ranks` spawns one process a rank (``torch.multiprocessing``,
the spawn start method), initializes a gloo group over a file store in a
working directory, runs the same calls in every rank and hands their
results back. torchrun does the same for the CLIs
(``parallel.mesh.init_from_env``); this is the in-process way, used by the
tests (gloo ranks on the CPU) and ``chip_smoke.py`` (gloo ranks sharing one
card). Nothing is caught: a rank that raises makes the call raise, and the
other ranks are stopped.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


# bounds each collective: a rank that dies cannot leave the others waiting
TIMEOUT = datetime.timedelta(seconds=600)


def _rank_main(rank: int, world_size: int, workdir: str,
               calls: Sequence[Callable]) -> None:
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
        rank=rank, world_size=world_size, timeout=TIMEOUT)
    try:
        results = [call() for call in calls]
    finally:
        dist.destroy_process_group()
    torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))


def run_ranks(calls: Sequence[Callable], world_size: int,
              workdir: str) -> List[list]:
    """Run the zero-argument ``calls`` in order on each of ``world_size``
    spawned ranks of a gloo group; returns each rank's list of results, in
    rank order. The calls and results must pickle (module-level functions,
    ``functools.partial`` of them); a call builds its own mesh
    (``parallel.mesh.make_mesh``, on the device it passes) from the default
    group. ``workdir`` holds the group's file store and the results."""
    workdir = os.path.abspath(workdir)  # the store's file:// URL
    os.makedirs(workdir, exist_ok=True)
    paths = [os.path.join(workdir, f) for f in
             ["store"] + [f"rank{r}.pt" for r in range(world_size)]]
    for path in paths:
        if os.path.exists(path):
            os.remove(path)
    mp.spawn(_rank_main, args=(world_size, workdir, list(calls)),
             nprocs=world_size, join=True)
    # these files are this call's own ranks' pickles
    return [torch.load(path, weights_only=False) for path in paths[1:]]
