"""Scene-parallel evaluation over the ranks of a mesh.

Counterpart of ``canonicalvoting_tpu/parallel/scene_parallel.py``.
Evaluation is embarrassingly parallel over scenes (the reference runs them
one by one on one GPU, upstream ``eval_joint.py:163-303``). Scene s goes to
rank ``s % D`` of the mesh's D data ranks, the order in which the JAX
package puts scene j of each D-scene chunk on device j. Each rank runs its
scenes through the port's own pipelines (``eval/pipeline.py``,
``eval/separate.py``) at the run's shared shapes, as the JAX package's
stacked batch has them:

- the row capacity: the largest scene's voxel count rounded up to
  ``cap_multiple``;
- the vote grid: ``round_grid_shape`` of the largest extent on each axis;
- the dense backbone's interior dims: the largest on each axis.

The ranks agree on these with one small all-gather of their own scenes'
extents, so that each rank reads only its own scenes. The tail is the JAX
package's: the 6-channel splat and the peel on the dense rot/scale grids
(``lazy_rot_scale=False``), escalated to 4x the iterations and 2x the boxes
at most ``max_retries`` times while the peel reports a budget exit, then
host NMS per class. The JAX fan-out escalates a whole chunk when one of its
scenes truncates; a peel that ended on its threshold gives the same boxes
under a larger budget, so escalating per scene is the same function. The
detections come back to every rank with one ``all_gather_object`` and
merge in scene order; a rank left without a scene by the ragged tail waits
there.

The JAX package's dense fan-out runs its masked-dense XLA twin
(``dense_xla_twin``) because its Pallas kernels do not ``vmap`` over
scenes; here each rank runs the tiled kernels scene by scene, which
computes the same function.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from canonicalvoting_tpu_torch.data.dense_prep import dense_grid_geometry
from canonicalvoting_tpu_torch.decode.peeling import PeelConfig
from canonicalvoting_tpu_torch.eval.pipeline import (
    DetectionPipeline, prepare_scene_args, scene_extent, vote_and_peel)
from canonicalvoting_tpu_torch.eval.separate import SeparateDetectionPipeline
from canonicalvoting_tpu_torch.ops import hv_splat as _hv
from canonicalvoting_tpu_torch.ops import tiled_conv as _tc
from canonicalvoting_tpu_torch.ops.hough_voting import round_grid_shape
from canonicalvoting_tpu_torch.parallel.mesh import Mesh, make_mesh
from canonicalvoting_tpu_torch.utils.profiling import PhaseTimer

#: the planted-head batch of votepeel_sharded, (S, ...) each
VOTEPEEL_KEYS = ("coords_w", "xyz", "scale", "prob", "class_pred", "valid")


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count in this process: the convs'
    bf16 (``<name>``) and float32 (``<name>_f32``) launches and the
    splats'."""
    counts = {}
    for fn in (_tc.tiled_conv3d, _tc.tiled_conv3d_prefolded, _tc.tiled_down2,
               _tc.tiled_up2, _tc.tiled_up2_into, _tc.tiled_block3d):
        counts[fn.__name__] = fn.launches
        counts[fn.__name__ + "_f32"] = fn.launches_f32
    for fn in (_hv.hv_splat, _hv.hv_splat6, _hv.hv_splat_windowed):
        counts[fn.__name__] = fn.launches
    return counts


def _all_gather(mesh: Mesh, obj) -> list:
    """``obj`` of every rank of the mesh's group, in rank order."""
    parts = [None] * dist.get_world_size(mesh.group)
    dist.all_gather_object(parts, obj, group=mesh.group)
    return parts


def _data_mesh(mesh: Optional[Mesh], device) -> Mesh:
    mesh = mesh or make_mesh(data=dist.get_world_size(), device=device)
    if mesh.model != 1:
        raise ValueError("scenes fan out over the data axis; the mesh's "
                         f"model axis must be 1, got {mesh.model}")
    return mesh


def shared_shapes(mesh: Mesh, coords_list: Sequence[np.ndarray], *,
                  cap_multiple: int, grid_multiple, dense: bool) -> Dict:
    """The run's shared ``cap``, ``grid_shape`` and (``dense``)
    ``dense_dims`` (``scene_parallel.py:244-258`` of the JAX package),
    from every rank's ``coords_list``, its own scenes' voxel coords."""
    mine = None
    if len(coords_list):
        mine = (max(len(c) for c in coords_list),
                np.max([scene_extent(c) for c in coords_list], 0),
                np.max([dense_grid_geometry(c)[1] for c in coords_list], 0)
                if dense else None)
    parts = [p for p in _all_gather(mesh, mine) if p is not None]
    n = max(p[0] for p in parts)
    shapes = {"cap": int(np.ceil(n / cap_multiple) * cap_multiple),
              "grid_shape": round_grid_shape(
                  np.max([p[1] for p in parts], 0), grid_multiple)}
    if dense:
        shapes["dense_dims"] = tuple(
            int(d) for d in np.max([p[2] for p in parts], 0))
    return shapes


def collate_eval_scenes(scenes, cap: int, *, grid_shape, res: float = 0.03,
                        device="cuda") -> List:
    """Quantized scenes [(coords, feats_raw), ...] as the sparse backbone's
    ``SparseSceneArgs``, every pyramid level at the shared capacity ``cap``
    (``scene_parallel.py:36-64``) and the shared vote ``grid_shape``."""
    return [prepare_scene_args(coords, feats, res=res, device=device,
                               backbone="sparse", cap=cap,
                               grid_shape=grid_shape)
            for coords, feats in scenes]


def collate_eval_scenes_dense(scenes, cap: int, grid_dims, *, grid_shape,
                              res: float = 0.03, device="cuda") -> List:
    """Quantized scenes [(coords, feats_raw), ...] as the dense backbone's
    ``SceneArgs``: each scene's cell ids and tile lists in the shared
    interior ``grid_dims`` from its own base, its rows padded to ``cap``
    (``scene_parallel.py:107-132``), and the shared vote ``grid_shape``."""
    return [prepare_scene_args(coords, feats, res=res, device=device,
                               backbone="dense", cap=cap,
                               grid_shape=grid_shape, dense_dims=grid_dims)
            for coords, feats in scenes]


def _fan_out(mesh: Mesh, pipe, scenes, what: str, stats: Optional[list]):
    """Every rank's share of ``scenes`` through ``pipe`` (retry, host NMS),
    gathered to {id_scan: detections} in scene order on every rank; with
    ``stats``, each rank's timer, launches and the device's peak memory
    over the fan-out (its statistics reset at the start)."""
    timer = PhaseTimer()
    before = launch_counts()
    if pipe.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(pipe.device)
    dense = pipe.backbone == "dense"
    mine = []
    for s in range(mesh.rank, len(scenes), mesh.data):
        with timer.phase("read"):
            mine.append((s, *scenes[s][:3]))
    with timer.phase("shapes"):
        shapes = shared_shapes(mesh, [m[2] for m in mine],
                               cap_multiple=pipe.cap_multiple,
                               grid_multiple=pipe.grid_multiple, dense=dense)
    dets = {}
    for s, id_scan, coords, feats in mine:
        with timer.phase("prep"):
            kw = dict(grid_shape=shapes["grid_shape"], res=pipe.res,
                      device=pipe.device)
            (args,) = (collate_eval_scenes_dense(
                [(coords, feats)], shapes["cap"], shapes["dense_dims"], **kw)
                if dense else
                collate_eval_scenes([(coords, feats)], shapes["cap"], **kw))
        done = []
        with timer.phase("scene", done):
            done.append(pipe.run_scene_with_retry(args))
        if bool(done[0]["truncated"].any()):
            warnings.warn(
                f"{what}: peel still budget-exited after {pipe.max_retries} "
                "escalations — detections may be incomplete", RuntimeWarning,
                stacklevel=3)
        with timer.phase("nms"), warnings.catch_warnings():
            # the pipeline's own budget-exit warning: given just above
            warnings.filterwarnings("ignore", "peel_boxes stopped",
                                    RuntimeWarning)
            dets[s] = (id_scan, pipe.postprocess(done[0]))
    after = launch_counts()
    mine_stats = {"rank": mesh.rank, "scenes": [d[0] for d in dets.values()],
                  "timer": timer.summary(),
                  "launches": {k: after[k] - before[k] for k in after},
                  "peak_mem_bytes": (torch.cuda.max_memory_allocated(pipe.device)
                                     if pipe.device.type == "cuda" else None)}
    parts = _all_gather(mesh, (dets, mine_stats))
    merged = {}
    for part, _ in parts:
        merged.update(part)
    if stats is not None:
        stats.extend(st for _, st in parts)
    return {merged[s][0]: merged[s][1] for s in sorted(merged)}


def evaluate_scenes_sharded(model, state_dict, scenes, *,
                            mesh: Optional[Mesh] = None, device=None,
                            res: float = 0.03,
                            num_rots: int = 120, log_scale: bool = True,
                            peel: Optional[PeelConfig] = None,
                            nms_iou: float = 0.3, cap_multiple: int = 4096,
                            grid_multiple=(64, 32, 128),
                            backbone: str = "auto", max_retries: int = 2,
                            lazy_rot_scale: bool = False,
                            stats: Optional[list] = None) -> Dict:
    """Fan the joint evaluation of ``scenes`` over the mesh (default: every
    rank of the default group) and return {id_scan: [(classname, corners
    (8, 3), score)]} on every rank, ``DetectionPipeline.postprocess``'s
    format, in scene order.

    Without ``mesh``, every rank of the default group forms one, on
    ``device``: this rank's current CUDA device unless the caller passes
    another (``"cpu"``), whatever the group's backend
    (:func:`parallel.mesh.make_mesh`).

    ``model`` is a ``DenseMinkUNet`` (or for the sparse backbone a
    ``MinkUNetBase``), with ``state_dict`` loaded into it unless None.
    ``scenes`` is a sequence (``len`` and indexing) whose items begin
    (id_scan, coords, feats_raw); each rank indexes only its own, so a
    dataset reads each scan on one rank. ``backbone``: "dense" (the tiled
    kernels) or "sparse"; "auto" picks dense on the card and sparse on the
    CPU, as the JAX package picks per platform. ``lazy_rot_scale=True``
    runs the pipeline's lazy tail instead of the JAX fan-out's 6-channel
    splat (the CLIs', so that their detections do not depend on the
    fan-out). ``stats``, where given, gets each rank's scene ids,
    ``PhaseTimer`` summary, kernel launches and peak device memory."""
    mesh = _data_mesh(mesh, device)
    if backbone == "auto":
        backbone = "dense" if mesh.device.type == "cuda" else "sparse"
    if state_dict is not None:
        model.load_state_dict(state_dict)
    pipe = DetectionPipeline(
        model=model, res=res, num_rots=num_rots, log_scale=log_scale,
        peel=peel, nms_iou=nms_iou, cap_multiple=cap_multiple,
        grid_multiple=tuple(grid_multiple), backbone=backbone,
        lazy_rot_scale=lazy_rot_scale, max_retries=max_retries,
        device=mesh.device)
    return _fan_out(mesh, pipe, scenes, "sharded eval", stats)


def evaluate_scenes_sharded_separate(
        model, stacked_state_dicts, scenes, categories, *,
        mesh: Optional[Mesh] = None, device=None, res: float = 0.03,
        num_rots: int = 120,
        log_scale: bool = True, peel: Optional[PeelConfig] = None,
        nms_iou: float = 0.3, cap_multiple: int = 4096,
        grid_multiple=(64, 32, 128), max_retries: int = 2,
        lazy_rot_scale: bool = False, stats: Optional[list] = None) -> Dict:
    """The separate evaluator fanned out: each rank runs every category of
    ``categories`` over each of its scenes on the dense backbone
    (``SeparateDetectionPipeline``: ``model`` the ``DenseMinkUNet`` plan,
    ``stacked_state_dicts`` the categories' weights on a leading axis, as
    ``eval.separate.stack_state_dicts`` gives them). Returns {id_scan:
    [(category, corners (8, 3), score)]} on every rank, in scene order,
    with the exclusive elimination by default (upstream
    ``eval_separate.py:209``). ``mesh``, ``device``, ``scenes``,
    ``lazy_rot_scale`` and ``stats`` as :func:`evaluate_scenes_sharded`."""
    mesh = _data_mesh(mesh, device)
    pipe = SeparateDetectionPipeline(
        model=model, categories=list(categories),
        state_dicts=[{k: v[c] for k, v in stacked_state_dicts.items()}
                     for c in range(len(categories))],
        res=res, num_rots=num_rots, log_scale=log_scale,
        peel=peel or PeelConfig(res=res, elimination_inclusive=False),
        nms_iou=nms_iou, cap_multiple=cap_multiple,
        grid_multiple=tuple(grid_multiple), backbone="dense",
        lazy_rot_scale=lazy_rot_scale, max_retries=max_retries,
        device=mesh.device)
    return _fan_out(mesh, pipe, scenes, "sharded separate eval", stats)


def votepeel_sharded(batch, *, mesh: Optional[Mesh] = None, device=None,
                     res: float = 0.03,
                     num_rots: int = 120, peel: Optional[PeelConfig] = None,
                     grid_shape=(128, 64, 128)) -> Dict[str, np.ndarray]:
    """Scene-parallel vote -> peel on PLANTED per-point heads (the run of
    the JAX package's ``make_sharded_votepeel_fn``): ``batch`` holds (S,
    ...) arrays of :data:`VOTEPEEL_KEYS` (the head outputs instead of a
    backbone's, so that the peel's accept branch runs); each rank votes
    (the 6-channel splat) and peels scenes ``s % D``, and every rank
    returns the peel's outputs stacked over the S scenes. ``mesh`` and
    ``device`` as :func:`evaluate_scenes_sharded`."""
    mesh = _data_mesh(mesh, device)
    peel = peel or PeelConfig(res=res)
    n = len(batch["coords_w"])
    mine = {}
    with torch.no_grad():
        for s in range(mesh.rank, n, mesh.data):
            coords_w, xyz, scale, prob, class_pred, valid = (
                torch.as_tensor(np.asarray(batch[k][s])).to(mesh.device)
                for k in VOTEPEEL_KEYS)
            out = vote_and_peel(coords_w, xyz, scale, prob, class_pred, valid,
                                res=res, num_rots=num_rots,
                                grid_shape=tuple(grid_shape), peel=peel,
                                lazy_rot_scale=False)
            mine[s] = {k: v.cpu().numpy() for k, v in out.items()}
    merged = {}
    for part in _all_gather(mesh, mine):
        merged.update(part)
    return {k: np.stack([merged[s][k] for s in range(n)]) for k in merged[0]}
