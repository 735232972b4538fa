"""Mesh training: scene-level data parallelism x column-parallel convs.

The port's counterpart of ``canonicalvoting_tpu/parallel/data_parallel.py``.
The JAX package runs one program over a (data, model) device mesh: scenes
collated per shard into identical shapes and sharded over ``data``, the
loss vmapped over that axis with sync-BN (``MaskedBatchNorm`` psums its
statistics), conv kernels column-parallel over ``model`` where the output
channels divide, and the mean over the shards of the per-shard losses
minimized; GSPMD inserts the collectives. The port runs one process a
device (``parallel/mesh.py``: rank ``d * model + m``), and every
collective is explicit:

  * the rank's shard of the global batch (``data/collate.py:
    collate_*_sharded``) is pinned to the shards' largest level capacities
    with one all-reduce (MAX) over the data group (:func:`equalize_shard`);
  * sync-BN: each norm's ``[n, s1, s2]`` summed over the data group in one
    differentiable all-reduce (``models/norm.py:sync_batch_norm``);
  * a conv kernel ``(K, Cin, Cout)`` whose ``Cout`` is a multiple of the
    model ranks (more than one) is split over ``Cout`` (:func:`split_kernels`,
    JAX ``param_shardings``); the rank keeps its column slice and its Adam
    moments' slices (:func:`shard_train_state`), multiplies its gathered
    operand by the slice and all-gathers the columns before the norm; its
    backward takes its columns of the output gradient for its kernel
    gradient, and the whole gradient with the kernel all-gathered for the
    input gradient (``ops/sparse_conv.py:ColumnGatherMatmul``), so the
    input gradient is one rank's; everything else is replicated;
  * each rank backprops ``loss / data``, and ONE all-reduce (sum) over the
    data group of one flat buffer (every gradient, and the losses)
    averages the gradients and the losses (:func:`average_grads`; with
    model ranks, one more over the model group of the replicated
    parameters' gradients); the optimizer is ``train/steps.py``'s Adam /
    AdamW on the rank's own parameters.

Replicated parameters take the same gradients on every model rank (each
model rank computes the whole input gradient of every conv), to the
rounding of the card's atomic sums, which the model-group average
removes; the running statistics, updated from the synced
statistics, are identical across the data ranks, and a checkpoint keeps
them as the JAX package keeps shard 0's. :func:`gather_train_state` puts
the full weights and moments back together (checkpoints, validation).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List

import torch
import torch.distributed as dist

from canonicalvoting_tpu_torch.data.collate import pin_shard, shard_capacities
from canonicalvoting_tpu_torch.models.norm import sync_batch_norm
from canonicalvoting_tpu_torch.models.resnet import SparseConv
from canonicalvoting_tpu_torch.parallel.collectives import (
    all_gather_columns, column_slice)
from canonicalvoting_tpu_torch.parallel.mesh import Mesh, make_mesh
from canonicalvoting_tpu_torch.train.steps import (
    TrainState, accumulate_grads, apply_update, joint_losses_of,
    separate_losses_of)


def split_kernels(model: torch.nn.Module, tp: int) -> List[str]:
    """The conv modules whose kernels are column-parallel over ``tp``
    model ranks: a ``(K, Cin, Cout)`` kernel with ``Cout % tp == 0``, when
    ``tp > 1``; everything else is replicated."""
    if tp <= 1:
        return []
    return [name for name, m in model.named_modules()
            if isinstance(m, SparseConv) and m.kernel.shape[2] % tp == 0]


def shard_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Put ``state`` (full weights and moments, identical on every rank)
    on the mesh, in place: sync-BN over the data group, and the split
    kernels (and their Adam moments) cut to this rank's columns."""
    sync_batch_norm(state.model, mesh)
    for name in split_kernels(state.model, mesh.model):
        conv = state.model.get_submodule(name)
        p = conv.kernel
        p.data = column_slice(p.data, mesh).clone()
        st = state.optimizer.state.get(p)
        for k in ("exp_avg", "exp_avg_sq"):
            if st and k in st:
                st[k] = column_slice(st[k], mesh).clone()
        conv.tp_mesh = mesh
    return state


def gather_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """A full copy of a sharded ``state`` (every rank of a model group
    calls it): the split kernels and their moments all-gathered, no mesh
    on the copy's modules, and an optimizer of the same kind and settings
    over the copy's parameters."""
    split = _split_names(state.model)
    model = copy.deepcopy(state.model)
    sync_batch_norm(model, None)
    for m in model.modules():
        if isinstance(m, SparseConv):
            m.tp_mesh = None
    opt = state.optimizer
    full_opt = type(opt)(model.parameters(), **opt.defaults)
    full_opt.param_groups[0]["lr"] = opt.param_groups[0]["lr"]
    for (name, p), q in zip(state.model.named_parameters(), model.parameters()):
        if name in split:
            q.data = all_gather_columns(p.data, mesh)
        st = opt.state.get(p)
        if st:
            full_opt.state[q] = {k: (all_gather_columns(v, mesh) if name in split
                                     and k != "step" else v.clone())
                                 for k, v in st.items()}
    return TrainState(model, full_opt, state.step, list(state.history))


def equalize_shard(shard: Dict, mesh: Mesh) -> Dict:
    """A waiting shard (``data/collate.py:collate_*_sharded``) collated at
    the element-wise max of the data ranks' level capacities, taken with
    one all-reduce (MAX) over the data group."""
    caps = torch.tensor(shard_capacities(shard), dtype=torch.int64,
                        device=mesh.device)
    if mesh.data > 1:
        dist.all_reduce(caps, op=dist.ReduceOp.MAX, group=mesh.data_group)
    return pin_shard(shard, caps.tolist())


def _split_names(model: torch.nn.Module) -> set:
    """The parameters of ``model`` that are this rank's column slices."""
    return {f"{name}.kernel" for name, m in model.named_modules()
            if isinstance(m, SparseConv) and m.tp_mesh is not None}


def _all_reduce_flat(tensors: List[torch.Tensor], group, scale: float):
    """``tensors`` summed over ``group`` in one all-reduce of one flat
    buffer and multiplied by ``scale``: views of the buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if scale != 1.0:
        flat.mul_(scale)
    out, o = [], 0
    for t in tensors:
        out.append(flat[o:o + t.numel()].view_as(t))
        o += t.numel()
    return out


def average_grads(model: torch.nn.Module, losses: Dict[str, torch.Tensor],
                  mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Sum every gradient (each rank's already divided by ``data``) and
    the losses over the data group in ONE all-reduce of one flat buffer
    (the losses divided by ``data``): the gradients of the mean loss in
    ``.grad``, and the mean losses returned. With model ranks, the
    replicated parameters' gradients are then averaged over the model group
    in one more: each model rank computes them whole, but on the card
    ``index_add_`` sums with atomics in an order that differs from rank to
    rank, and the replicated copies must take one update."""
    named = list(model.named_parameters())
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for _, p in named]
    names = list(losses)
    if mesh.data > 1:
        *grads, mean = _all_reduce_flat(
            grads + [torch.stack([losses[k].float() for k in names])
                     / mesh.data], mesh.data_group, 1.0)
        losses = dict(zip(names, mean))
    if mesh.model > 1:
        split = _split_names(model)
        rep = [i for i, (n, _) in enumerate(named) if n not in split]
        for i, g in zip(rep, _all_reduce_flat([grads[i] for i in rep],
                                              mesh.model_group,
                                              1.0 / mesh.model)):
            grads[i] = g
    for (_, p), g in zip(named, grads):
        p.grad = g
    return losses


def _make_dp_step(losses_of: Callable, mesh: Mesh) -> Callable:
    def step(state: TrainState, batch: Dict, lr, bn_momentum):
        if "collate" in batch:
            batch = equalize_shard(batch, mesh)
        losses = accumulate_grads(state.model, batch, losses_of, bn_momentum,
                                  divisor=mesh.data)
        losses = average_grads(state.model, losses, mesh)
        return apply_update(state, lr), losses

    return step


def make_dp_train_step(model: torch.nn.Module, cfg, mesh: Mesh) -> Callable:
    """``step(state, shard, lr, bn_momentum) -> (state, mean losses)`` of
    a sharded ``state`` (:func:`shard_train_state`) fed this rank's shard
    (``collate_joint_sharded``; a collated batch is taken as it is): the
    joint loss of the gather backbone, sync-BN, the gradients and losses
    averaged over the data group."""
    return _make_dp_step(joint_losses_of(model, cfg), mesh)


def make_dp_train_step_separate(model: torch.nn.Module, cfg, mesh: Mesh,
                                max_objects: int) -> Callable:
    """As :func:`make_dp_train_step`, with the separate losses
    (``collate_separate_sharded`` shards)."""
    return _make_dp_step(separate_losses_of(model, cfg, max_objects), mesh)


def training_mesh(cfg, device) -> Mesh:
    """The ``tpu.mesh_data`` x ``tpu.mesh_model`` mesh of the default
    process group, on this rank's CUDA device (``device`` "cuda") or on
    ``device``. The JAX package drives every device from one process; the
    port runs one process a device, so a process group must be
    initialized first."""
    if not dist.is_initialized():
        raise RuntimeError(
            "mesh training (tpu.mesh_data x tpu.mesh_model > 1) runs one "
            "process a device: start it under torchrun (torchrun "
            "--nproc-per-node N -m canonicalvoting_tpu_torch.train_joint ...) "
            "or in the ranks of parallel/launch.py:run_ranks, which "
            "initialize the process group")
    device = torch.device(device)
    return make_mesh(cfg.tpu.mesh_data, cfg.tpu.mesh_model,
                     device=None if device.type == "cuda" else device)


def share_result(value, mesh: Mesh):
    """Rank 0's ``value`` on every rank of the mesh (the others wait here
    while rank 0 checkpoints and validates)."""
    box = [value]
    dist.broadcast_object_list(
        box, src=dist.get_global_rank(mesh.group, 0) if mesh.group else 0,
        group=mesh.group,
        device=mesh.device if dist.get_backend(mesh.group) == "nccl" else None)
    return box[0]
