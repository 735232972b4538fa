"""The rank side of tests/test_torch_mesh_train.py.

Each gloo rank spawned by ``parallel/launch.py:run_ranks`` runs
:func:`rank_main`; it imports the port only (this module imports nothing
of the JAX package), and returns plain tensors and numpy arrays for the
test process to hold against the JAX package and against one rank.
"""

import os
import sys

import torch
import torch.distributed as dist

from canonicalvoting_tpu_torch.config import load_config
from canonicalvoting_tpu_torch.data.collate import (
    collate_joint_sharded, collate_separate_sharded)
from canonicalvoting_tpu_torch.data.loader import ListDataset
from canonicalvoting_tpu_torch.models.minkunet import MinkUNetBase
from canonicalvoting_tpu_torch.models.norm import MaskedBatchNorm, sync_batch_norm
from canonicalvoting_tpu_torch.models.resnet import SparseConv
from canonicalvoting_tpu_torch.parallel import data_parallel as dp
from canonicalvoting_tpu_torch.parallel.collectives import (
    all_gather_columns, column_slice)
from canonicalvoting_tpu_torch.parallel.mesh import make_mesh
from canonicalvoting_tpu_torch.train import joint_loop, separate_loop, steps
from canonicalvoting_tpu_torch.utils.weights import from_jax_variables

# the JAX test's narrow plan (tests/test_parallel.py:140-144), float32
TINY = dict(block="basic", layers=(1,) * 8, planes=(8, 16, 16, 16, 16, 16, 8, 8),
            init_dim=8, compute_dtype="float32")
JOINT_OUT = 64
LR, MOM, MAX_OBJECTS = 1e-3, 0.3, 16
MESHES = ((2, 2), (2, 1), (1, 2))


def narrow(in_channels, out_channels, compute_dtype="float32", generator=None):
    return MinkUNetBase(in_channels, out_channels, generator=generator,
                        **{**TINY, "compute_dtype": compute_dtype})


def _host(t):
    return t.detach().cpu().numpy().copy()


def dp_step(job, kind, mesh):
    """One step of the port's mesh step on this rank's shard; the gathered
    full state, and this rank's own parameters and statistics."""
    data, model = mesh.data, mesh.model
    out_ch = JOINT_OUT if kind == "joint" else 8
    net = from_jax_variables(narrow(3, out_ch), *job["variables"][kind])
    state = dp.shard_train_state(steps.create_train_state(net, 0.0, "cpu"), mesh)
    cfg = load_config(None, [])
    d = mesh.coords[0]
    if kind == "joint":
        shard = collate_joint_sharded(job["joint"], data, d, cap_multiple=256)
        step = dp.make_dp_train_step(state.model, cfg, mesh)
    else:
        shard = collate_separate_sharded(job["separate"], data, d,
                                         cap_multiple=256,
                                         max_objects=MAX_OBJECTS)
        step = dp.make_dp_train_step_separate(state.model, cfg, mesh,
                                              MAX_OBJECTS)
    state, losses = step(state, shard, LR, MOM)
    full = dp.gather_train_state(state, mesh)
    moments = {n: (_host(full.optimizer.state[p]["exp_avg"]),
                   _host(full.optimizer.state[p]["exp_avg_sq"]))
               for n, p in full.model.named_parameters()}
    return {"coords": mesh.coords, "losses": {k: float(v) for k, v in losses.items()},
            "full": {k: _host(v) for k, v in full.model.state_dict().items()},
            "moments": moments, "step": full.step,
            "own": {k: _host(v) for k, v in state.model.state_dict().items()},
            "split": sorted(dp.split_kernels(full.model, model))}


def sync_bn(job, mesh):
    """Sync-BN on a 2 x 1 mesh: this rank's rows (valid ones, then
    padding) through a train-mode norm, forward and backward."""
    x, nvalid, g = job["bn_rows"][mesh.rank]
    norm = MaskedBatchNorm(x.shape[1])
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(job["bn_scale"]))
    sync_batch_norm(norm, mesh)
    xt = torch.from_numpy(x).requires_grad_()
    y = norm(xt, nvalid, True, 0.3)
    (y * torch.from_numpy(g)).sum().backward()
    return {"y": _host(y), "dx": _host(xt.grad), "dscale": _host(norm.scale.grad),
            "dbias": _host(norm.bias.grad), "mean": _host(norm.mean),
            "var": _host(norm.var)}


def column_conv(job, mesh):
    """A column-parallel conv on a 1 x 2 mesh against the same conv whole:
    output, input gradient and (gathered) kernel gradient."""
    feats, nbr, w, g = (torch.from_numpy(a) for a in job["conv"])
    out = {}
    for split in (False, True):
        conv = SparseConv(w.shape[1], w.shape[2], w.shape[0],
                          compute_dtype="float32")
        with torch.no_grad():
            conv.kernel.copy_(w)
        if split:
            conv.kernel.data = column_slice(conv.kernel.data, mesh).clone()
            conv.tp_mesh = mesh
        x = feats.clone().requires_grad_()
        y = conv(x, nbr)
        (y * g).sum().backward()
        dw = conv.kernel.grad
        out["split" if split else "whole"] = {
            "y": _host(y), "dx": _host(x.grad),
            "dw": _host(all_gather_columns(dw, mesh) if split else dw)}
    return out


def _small_joint(cfg, n_train=8, n_val=2, seed=0, items=None):
    return ListDataset(items[:2]), ListDataset(items[2:3]), lambda _id: []


def loops(job):
    """The joint loop and both CLIs (the separate loop under its CLI) at
    2 x 2, epoch 0 with its validation and checkpoint (narrow models); and
    a CLI whose mesh is not the world."""
    import functools

    from canonicalvoting_tpu_torch import train_joint, train_separate

    root = job["root"]
    joint_loop.MinkUNet34C = narrow
    separate_loop.MinkUNet34C = narrow
    train_joint.build_synthetic = functools.partial(_small_joint,
                                                    items=job["joint"])
    train_separate.build_synthetic_sym = (
        lambda cfg, n_scenes=6, seed=0: (ListDataset(job["separate"][:2]),
                                         lambda _id: []))
    mesh_args = ["tpu.mesh_data=2", "tpu.mesh_model=2", "batch_size=2",
                 "num_workers=0", "tpu.conv_dtype=float32"]
    cfg = load_config(None, mesh_args + ["max_epoch=0", "category=03001627"])
    out = {}
    state, ret = joint_loop.run_joint_training(
        cfg, ListDataset(job["joint"]), ListDataset(job["joint"][:1]),
        workdir=os.path.join(root, "joint"), gt_lookup=lambda _id: [],
        eval_every=1, cap_multiple=256, device="cpu")
    out["joint"] = {"step": state.step, "ret": ret, "history": state.history}
    # a second call resumes from the full checkpoint, each rank taking its
    # slices, and trains epoch 1
    state, ret = joint_loop.run_joint_training(
        load_config(None, mesh_args + ["max_epoch=1"]), ListDataset(job["joint"]),
        ListDataset(job["joint"][:1]), workdir=os.path.join(root, "joint"),
        gt_lookup=lambda _id: [], eval_every=1, cap_multiple=256, device="cpu")
    out["resumed"] = {"step": state.step, "epochs": [h["epoch"] for h in
                                                     state.history]}
    # the separate loop runs under its CLI
    cli = ["--synthetic", "--cpu", "max_epoch=0"] + mesh_args + ["batch_size=1"]
    state, ret = train_joint.main(cli + [f"workdir={root}/cli_joint"])
    out["cli_joint"] = {"step": state.step, "ret": ret}
    res = train_separate.main(cli + ["category=03001627",
                                     f"workdir={root}/cli_separate"])
    out["cli_separate"] = {k: (st.step, r) for k, (st, r) in res.items()}
    try:
        train_joint.main(cli[:3] + ["tpu.mesh_data=2", f"workdir={root}/no"])
    except ValueError as e:
        out["refused"] = str(e)
    out["files"] = {k: sorted(os.listdir(os.path.join(root, k)))
                    for k in ("joint", "cli_joint")}
    return out


def rank_main(job):
    """Every rank-side case of the module, on this rank."""
    torch.set_num_threads(1)
    rank = dist.get_rank()
    out = {"rank": rank, "steps": {}}
    for data, model in MESHES:
        # every rank builds every mesh (new_group); ranks past it idle
        mesh = make_mesh(data, model, device="cpu")
        for kind in ("joint", "separate"):
            if rank < data * model:
                out["steps"][(kind, data, model)] = dp_step(job, kind, mesh)
    mesh_2x1, mesh_1x2 = (make_mesh(*s, device="cpu") for s in ((2, 1), (1, 2)))
    if rank < 2:
        out["sync_bn"] = sync_bn(job, mesh_2x1)
        out["column_conv"] = column_conv(job, mesh_1x2)
    out["loops"] = loops(job)
    out["modules"] = sorted(sys.modules)
    return out
