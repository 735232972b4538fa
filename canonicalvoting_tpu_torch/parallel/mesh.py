"""Process meshes over ``torch.distributed``.

Counterpart of ``canonicalvoting_tpu/parallel/mesh.py``. The JAX package
lays its devices out as a ``jax.sharding.Mesh`` with the axes ``data``
(scene-level data parallelism) and ``model`` (tensor parallelism over conv
output channels). Here each device is driven by one process: a
:class:`Mesh` names the process group, its data x model shape, this rank and
the device the rank computes on.

A group is initialized by the caller, or from torchrun's environment by
:func:`init_from_env` (NCCL on the card, one rank a GPU; gloo on the CPU).
Nothing here picks a backend or a device behind the caller's back: a mesh
computes on this rank's current CUDA device, whatever the group's backend,
unless the caller passes another device (``device="cpu"`` for the CPU).
Two ranks on one card are a gloo group that the caller initializes.

Ranks are laid out as the JAX package lays out its devices,
``reshape(data, model)``: rank ``d * model + m`` holds coordinates ``(d,
m)``. Training (``parallel/data_parallel.py``) reduces over a rank's data
group (the ranks with its ``m``: sync-BN and the gradient average) and its
model group (the ranks with its ``d``: the column-parallel convs), which
:func:`make_mesh` builds with ``dist.new_group`` when they are neither a
single rank nor the whole group.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """``data`` x ``model`` ranks of ``group`` (None: the default group);
    ``rank`` is this process's rank in it, ``device`` where it computes.
    ``data_group`` / ``model_group`` are the process groups of this rank's
    data and model groups; a group of one rank is never reduced over (its
    field may be None, which is not the default group here)."""

    data: int
    model: int
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def coords(self) -> Tuple[int, int]:
        """This rank's (d, m): its data shard and its column slice."""
        return divmod(self.rank, self.model)

    def __deepcopy__(self, memo):
        # a handle on process groups: copies of a model share it
        return self


def make_mesh(data: int = 1, model: int = 1, *,
              group: Optional[dist.ProcessGroup] = None,
              device=None) -> Mesh:
    """A ``data`` x ``model`` mesh over the first data * model ranks of
    ``group`` (the default group when None), which must be initialized.
    Where the mesh's data or model groups are neither single ranks nor the
    whole group, they are built here with ``dist.new_group``, so every rank
    of the default group calls it, in the same order (ranks outside the
    mesh get no groups).
    ``device`` defaults to this rank's current CUDA device on any backend
    (a gloo group too), and raises without one: the CPU only where the
    caller passes it. NCCL takes no CPU device."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group or "
                           "init_from_env)")
    n, have = data * model, dist.get_world_size(group)
    if have < n:
        raise ValueError(f"need {n} devices, have {have}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh computes on the GPU and none is "
                               "available; pass device='cpu' for the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if dist.get_backend(group) == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL group computes on CUDA devices, not {device}")
    rank = dist.get_rank(group)
    d, m = divmod(rank, model)
    data_groups, model_groups = _mesh_groups(group, data, model, have)
    in_mesh = rank < n
    return Mesh(data, model, rank, device, group,
                data_groups[m] if in_mesh else None,
                model_groups[d] if in_mesh else None)


def _mesh_groups(group, data: int, model: int, have: int):
    """(the data group of each m, the model group of each d): None for one
    rank, ``group`` for all of it, else a ``dist.new_group``, which every
    rank of the default group builds, in this order."""
    def make(ranks):
        if len(ranks) == 1:
            return None
        if len(ranks) == have:
            return group
        if group is not None:
            ranks = [dist.get_global_rank(group, r) for r in ranks]
        return dist.new_group(ranks)

    model_groups = [make([d * model + e for e in range(model)])
                    for d in range(data)]
    data_groups = [make([e * model + m for e in range(data)])
                   for m in range(model)]
    return data_groups, model_groups


def init_from_env(device_type: str = "cuda") -> Mesh:
    """Initialize the default group from torchrun's ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` (``env://``): NCCL with this rank on
    ``cuda:LOCAL_RANK`` for ``device_type="cuda"``, gloo on the CPU for
    ``"cpu"``. Returns the data-parallel mesh of every rank."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device_type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method="env://", rank=rank,
                                world_size=world)
    else:
        device = torch.device("cpu")
        dist.init_process_group("gloo", init_method="env://", rank=rank,
                                world_size=world)
    return make_mesh(data=world, device=device)


@contextlib.contextmanager
def fan_out_mesh(device: str, no_mesh: bool = False) -> Iterator[Optional[Mesh]]:
    """The mesh the CLIs fan their scenes out over, or None (one process
    evaluates every scene): None with ``no_mesh`` or a single process; the
    default group when the caller initialized one of more than one rank,
    on ``device`` ("cpu", or "cuda": this rank's current CUDA device); or
    torchrun's group when ``WORLD_SIZE`` > 1 (:func:`init_from_env`),
    destroyed on exit."""
    if no_mesh:
        yield None
    elif dist.is_initialized() and dist.get_world_size() > 1:
        yield make_mesh(data=dist.get_world_size(),
                        device="cpu" if device == "cpu" else None)
    elif dist.is_initialized():
        yield None
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        mesh = init_from_env(device)
        try:
            yield mesh
        finally:
            dist.destroy_process_group()
    else:
        yield None


def factor_mesh(n_devices: int):
    """(data, model) factorization: TP=2 when even, else pure DP."""
    if n_devices % 2 == 0 and n_devices >= 2:
        return n_devices // 2, 2
    return n_devices, 1
