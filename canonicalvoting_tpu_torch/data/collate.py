"""Batch collation: ragged scenes -> padded host batches for the trainers.

The port's counterpart of ``canonicalvoting_tpu/data/collate.py``, gather
form (upstream collate_fns, train_joint.py:78-90, train_separate.py:78-96):
the batch's coordinate pyramid and neighbor tables are built on the host
(``ops/coords.py``) and the label arrays are padded to the level-0
capacity. Batches stay NumPy (the loader's workers never touch the card);
:func:`upload_batch` moves one to the device in one copy.

``microbatch=k`` splits a batch into gradient-accumulation microbatches of
k scenes with pinned pyramid capacities: every microbatch's level i holds
the largest microbatch's row count at that level. A pyramid is built once
a microbatch and then padded to those capacities, which gives the arrays a
pyramid built at them gives (padding rows are far-away coordinates that
depend on their position only, and table rows of -1).

The dense training route's batches (:func:`collate_joint_dense`,
``collate_separate(dense=True)``) carry each row's flat MARGINED cell id
into a stacked (B, X, Y, Z) grid (``data/dense_prep.py:
dense_flat_ids_batched``) and a valid mask instead of the pyramid, with
the gather form's rows and labels in the same order, so the same losses
apply; their microbatches pin the grid dims and the row cap.

``with_flat_levels=True`` (the gather form) adds each pyramid level's flat
cell ids (``flat_levels``) and ``meta.grid_dims`` / ``meta.n_scenes``, the
scatter-dense engine's plans (``train/steps.py:build_dense_plans``); the
dims are pinned across the microbatches of a batch.

Mesh training collates a global batch into ``n_shards`` shards, shard s
taking ``items[s::n_shards]`` (JAX ``collate_joint_sharded`` /
``collate_separate_sharded``), each level's capacity pinned to the
element-wise max of the shards' natural capacities. A rank collates its own
shard: :func:`collate_joint_sharded` / :func:`collate_separate_sharded`
build its pyramid at its natural capacities (in the loader's workers), the
rank takes the max with the other shards (``parallel/data_parallel.py:
equalize_shard``, one all-reduce) and :func:`pin_shard` pads the pyramid
and collates the labels at those capacities: the JAX shard of the same
index, bit for bit.
"""

from __future__ import annotations

import functools
from dataclasses import replace
from typing import Dict, List, Sequence

import numpy as np
import torch

from canonicalvoting_tpu_torch.data.dense_prep import (
    dense_flat_ids_batched, dense_grid_geometry, pyramid_level_flat_ids)
from canonicalvoting_tpu_torch.data.geometry import NCLASSES
from canonicalvoting_tpu_torch.ops.coords import (
    PyramidArrays, PyramidSpec, _pad_coords, build_pyramid, pad_rows)
from canonicalvoting_tpu_torch.ops.voxelize import batched_coordinates


def _pad(arr: np.ndarray, cap: int, fill) -> np.ndarray:
    out = np.full((cap,) + arr.shape[1:], fill, arr.dtype)
    out[:len(arr)] = arr
    return out


def pin_capacities(pyr: PyramidArrays, caps: Sequence[int]) -> PyramidArrays:
    """``pyr`` padded to the level capacities ``caps`` (each at least its
    own): the arrays ``build_pyramid`` gives at ``capacities=caps``."""
    L = len(pyr.coords)
    coords = [_pad_coords(c[:n], cap)
              for c, n, cap in zip(pyr.coords, pyr.nvalid, caps)]

    def rows(t, lvl):
        return pad_rows(t, caps[lvl], -1)

    return replace(pyr, coords=coords, nbr_stem=rows(pyr.nbr_stem, 0),
                   nbr_conv=[rows(t, lvl) for lvl, t in enumerate(pyr.nbr_conv)],
                   nbr_down=[rows(pyr.nbr_down[i], i + 1) for i in range(L - 1)],
                   nbr_up=[rows(pyr.nbr_up[i], i) for i in range(L - 1)])


def _microbatches(items: Sequence, microbatch: int, cap_multiple: int):
    """The scene groups of ``microbatch`` scenes and their pyramids pinned
    to common capacities."""
    if len(items) % microbatch:
        raise ValueError("batch size must divide by the microbatch size "
                         f"({len(items)} % {microbatch})")
    groups = [list(items[i:i + microbatch])
              for i in range(0, len(items), microbatch)]
    pyrs = [_pyramid(g, cap_multiple) for g in groups]
    caps = [max(p.coords[lvl].shape[0] for p in pyrs)
            for lvl in range(len(pyrs[0].coords))]
    return groups, [pin_capacities(p, caps) for p in pyrs]


def _pyramid(items: Sequence, cap_multiple: int) -> PyramidArrays:
    return build_pyramid(batched_coordinates([it[1] for it in items]),
                         PyramidSpec(cap_multiple=cap_multiple))


def _feats(items: Sequence, cap0: int) -> np.ndarray:
    feats = _pad(np.concatenate([it[2] for it in items], 0), cap0,
                 0.0).astype(np.float32)
    # rgb channels to [-1, 1] (train_joint.py:249)
    feats[:, -3:] = feats[:, -3:] * 2.0 - 1.0
    return feats


def _cat(items: Sequence, i: int, dtype, cap0: int, fill) -> np.ndarray:
    return _pad(np.concatenate([it[i] for it in items], 0).astype(dtype),
                cap0, fill)


def _grid_dims(items: Sequence):
    """The L0 interior dims that hold every scene of ``items``."""
    return tuple(int(max(dense_grid_geometry(it[1])[1][a] for it in items))
                 for a in range(3))


def _with_flat_levels(batch: Dict, items: Sequence, pyr: PyramidArrays,
                      dims0) -> Dict:
    """``batch`` with its pyramid's ``flat_levels`` and the scatter-dense
    engine's ``meta.grid_dims`` / ``meta.n_scenes``."""
    bases = np.stack([dense_grid_geometry(it[1])[0] for it in items])
    dims0 = dims0 or _grid_dims(items)
    batch["flat_levels"] = tuple(pyramid_level_flat_ids(pyr.coords, bases,
                                                        dims0)[0])
    batch["meta"].update(grid_dims=dims0, n_scenes=len(items))
    return batch


def _microbatched(collate, items: Sequence, microbatch: int,
                  cap_multiple: int, with_flat_levels: bool) -> Dict:
    """``{"microbatches": [collate(group, pyr=..., ...)], "meta"}``: the
    groups' pyramids pinned to common capacities and, with flat levels,
    the grid dims pinned to the batch's."""
    groups, pyrs = _microbatches(items, microbatch, cap_multiple)
    meta = {"ids": [it[0] for it in items]}
    kw = {}
    if with_flat_levels:
        kw = dict(with_flat_levels=True, flat_grid_dims=_grid_dims(items))
        meta.update(grid_dims=kw["flat_grid_dims"], n_scenes=microbatch)
    return {"microbatches": [collate(g, pyr=p, **kw)
                             for g, p in zip(groups, pyrs)], "meta": meta}


def collate_joint(items: Sequence, cap_multiple: int = 4096,
                  microbatch: int = 0, pyr: PyramidArrays = None,
                  with_flat_levels: bool = False, flat_grid_dims=None) -> Dict:
    """items: (id_scan, coords, feats, xyz_labels, scale_labels,
    class_labels). A host batch: ``feats`` (rgb rescaled to [-1, 1]),
    ``pyramid`` (a ``PyramidArrays``; ``pyr`` gives it built), the padded
    labels and ``meta``; ``microbatch=k``: ``{"microbatches": [batch, ...],
    "meta"}``; ``with_flat_levels``: the scatter-dense engine's ids (at
    ``flat_grid_dims`` when given)."""
    if microbatch:
        return _microbatched(collate_joint, items, microbatch, cap_multiple,
                             with_flat_levels)
    pyr = pyr if pyr is not None else _pyramid(items, cap_multiple)
    cap0 = pyr.coords[0].shape[0]
    batch = {
        "meta": {"ids": [it[0] for it in items], "coords": pyr.coords[0]},
        "feats": _feats(items, cap0),
        "pyramid": pyr,
        "xyz_labels": _cat(items, 3, np.float32, cap0, 0.0),
        "scale_labels": _cat(items, 4, np.float32, cap0, 1.0),
        "class_labels": _cat(items, 5, np.int32, cap0, NCLASSES),
    }
    if with_flat_levels:
        return _with_flat_levels(batch, items, pyr, flat_grid_dims)
    return batch


def _shard(collate, items, n_shards, shard, cap_multiple, **kw) -> Dict:
    if len(items) < n_shards:
        raise ValueError(f"need >= {n_shards} scenes per global batch, "
                         f"got {len(items)}")
    group = list(items[shard::n_shards])
    return {"pyramid": _pyramid(group, cap_multiple),
            "collate": functools.partial(collate, group, **kw),
            "meta": {"ids": [it[0] for it in group]}}


def collate_joint_sharded(items: Sequence, n_shards: int, shard: int,
                          cap_multiple: int = 4096) -> Dict:
    """This rank's shard of a joint global batch, waiting for its
    capacities: its pyramid at its natural capacities, and the collate
    that :func:`pin_shard` finishes it with."""
    return _shard(collate_joint, items, n_shards, shard, cap_multiple)


def collate_separate_sharded(items: Sequence, n_shards: int, shard: int,
                             cap_multiple: int = 4096,
                             max_objects: int = 64) -> Dict:
    """As :func:`collate_joint_sharded`, for the separate trainer."""
    return _shard(collate_separate, items, n_shards, shard, cap_multiple,
                  max_objects=max_objects)


def shard_capacities(shard: Dict) -> List[int]:
    """A waiting shard's natural level capacities."""
    return [c.shape[0] for c in shard["pyramid"].coords]


def pin_shard(shard: Dict, caps: Sequence[int]) -> Dict:
    """A waiting shard collated at the level capacities ``caps`` (the
    shards' element-wise max)."""
    return shard["collate"](pyr=pin_capacities(shard["pyramid"], caps))


def _dense_groups(items: Sequence, microbatch: int, cap_multiple: int):
    """(groups, dims, cap) of a dense batch's microbatches: the scene
    groups, the grid dims pinned to the batch's largest and the row cap to
    the largest group's."""
    if len(items) % microbatch:
        raise ValueError("batch size must divide by the microbatch size "
                         f"({len(items)} % {microbatch})")
    dims = tuple(int(max(dense_grid_geometry(it[1])[1][a] for it in items))
                 for a in range(3))
    groups = [list(items[i:i + microbatch])
              for i in range(0, len(items), microbatch)]
    cap = max(int(np.ceil(sum(len(it[1]) for it in g) / cap_multiple)
                  * cap_multiple) for g in groups)
    return groups, dims, cap


def _dense_rows(items: Sequence, cap_multiple: int, dims, cap):
    """(fields, row cap) of a dense batch: meta (ids, grid dims, scenes),
    flat ids (-1 padding), valid mask and the row count."""
    flat, dims, _ = dense_flat_ids_batched([it[1] for it in items], dims=dims)
    n = len(flat)
    cap0 = cap if cap is not None else int(np.ceil(n / cap_multiple)
                                           * cap_multiple)
    valid = np.zeros((cap0,), np.float32)
    valid[:n] = (flat >= 0).astype(np.float32)
    return {"meta": {"ids": [it[0] for it in items], "grid_dims": dims,
                     "n_scenes": len(items)},
            "flat_idx": _pad(flat, cap0, -1), "valid": valid,
            "nvalid": np.int32(n)}, cap0


def collate_joint_dense(items: Sequence, cap_multiple: int = 4096,
                        microbatch: int = 0, grid_dims=None,
                        cap: int = None) -> Dict:
    """A joint batch for the dense training route (JAX
    ``collate_joint_dense``): ``flat_idx`` into the stacked grid,
    ``valid``, ``nvalid``, and ``collate_joint``'s features and labels in
    its row order; ``meta.grid_dims`` and ``meta.n_scenes`` are the step's
    grid arguments. ``microbatch=k``: ``{"microbatches": [batch, ...],
    "meta"}`` with the grid dims and row cap pinned."""
    if microbatch:
        groups, dims, cap_nat = _dense_groups(items, microbatch, cap_multiple)
        return {"microbatches": [
                    collate_joint_dense(g, cap_multiple, grid_dims=dims,
                                        cap=cap_nat) for g in groups],
                "meta": {"ids": [it[0] for it in items], "grid_dims": dims,
                         "n_scenes": microbatch}}
    batch, cap0 = _dense_rows(items, cap_multiple, grid_dims, cap)
    return {**batch, "feats": _feats(items, cap0),
            "xyz_labels": _cat(items, 3, np.float32, cap0, 0.0),
            "scale_labels": _cat(items, 4, np.float32, cap0, 1.0),
            "class_labels": _cat(items, 5, np.int32, cap0, NCLASSES)}


def collate_separate(items: Sequence, cap_multiple: int = 4096,
                     max_objects: int = 64, microbatch: int = 0,
                     pyr: PyramidArrays = None, dense: bool = False,
                     grid_dims=None, cap: int = None,
                     with_flat_levels: bool = False,
                     flat_grid_dims=None) -> Dict:
    """items: (id_scan, coords, feats, base_xyz, scale_labels, obj_labels,
    class_labels, obj_id, sym_codes). Object ids are offset per scene into
    one id space for the batch (the segment sums of the symmetry loss);
    objects past ``max_objects`` leave the xyz loss. ``dense=True`` gives
    the dense training route's rows (flat ids, valid mask) in place of the
    pyramid, as :func:`collate_joint_dense` does, with the same labels;
    ``with_flat_levels`` (the gather form) as :func:`collate_joint`."""
    if microbatch and dense:
        groups, dims, cap_nat = _dense_groups(items, microbatch, cap_multiple)
        return {"microbatches": [
                    collate_separate(g, cap_multiple, max_objects, dense=True,
                                     grid_dims=dims, cap=cap_nat)
                    for g in groups],
                "meta": {"ids": [it[0] for it in items], "grid_dims": dims,
                         "n_scenes": microbatch}}
    if microbatch:
        return _microbatched(
            functools.partial(collate_separate, max_objects=max_objects),
            items, microbatch, cap_multiple, with_flat_levels)
    if dense:
        rows, cap0 = _dense_rows(items, cap_multiple, grid_dims, cap)
    else:
        pyr = pyr if pyr is not None else _pyramid(items, cap_multiple)
        cap0 = pyr.coords[0].shape[0]
        rows = {"meta": {"ids": [it[0] for it in items],
                         "coords": pyr.coords[0]}, "pyramid": pyr}

    obj_ids, offset = [], 0
    for it in items:
        oid = it[7].astype(np.int32).copy()
        oid[oid >= 0] += offset
        obj_ids.append(oid)
        offset += len(it[8])
    sym = np.zeros((max_objects,), np.int32)
    codes = np.concatenate([it[8] for it in items]) if items else np.zeros(0)
    n_keep = min(len(codes), max_objects)
    sym[:n_keep] = codes[:n_keep]
    obj_id = _pad(np.concatenate(obj_ids, 0), cap0, -1)
    obj_id[obj_id >= max_objects] = -1
    if with_flat_levels and not dense:
        rows = _with_flat_levels(rows, items, pyr, flat_grid_dims)
    return {
        **rows,
        "feats": _feats(items, cap0),
        "base_xyz": _cat(items, 3, np.float32, cap0, 0.0),
        "scale_labels": _cat(items, 4, np.float32, cap0, 1.0),
        "obj_labels": _cat(items, 5, np.int32, cap0, 0),
        "class_labels": _cat(items, 6, np.int32, cap0, 0),
        "obj_id": obj_id,
        "sym_code": sym,
        "num_objects": np.int32(min(offset, max_objects)),
    }


def upload_batch(batch: Dict, device) -> Dict:
    """A host batch (one microbatch, or a whole batch without them) on
    ``device``: the pyramid's tables (``PyramidArrays.to``), ``feats``,
    every label array and the ``flat_levels`` in one copy (a dense batch:
    its arrays, one copy each); scalars and ``meta`` stay on the host."""
    names = [k for k, v in batch.items()
             if isinstance(v, np.ndarray) and v.ndim > 0]
    out = {k: v for k, v in batch.items() if k not in names}
    if "pyramid" not in batch:
        out.update((k, torch.from_numpy(batch[k]).to(device)) for k in names)
        return out
    flat = list(batch.get("flat_levels", ()))
    tables, arrays = batch["pyramid"].to(device,
                                         [batch[k] for k in names] + flat)
    out.update(zip(names, arrays))
    if flat:
        out["flat_levels"] = tuple(arrays[len(names):])
    out["pyramid"] = tables
    return out


def batch_parts(batch: Dict) -> List[Dict]:
    """The microbatches of a host batch, or the batch itself."""
    return batch["microbatches"] if "microbatches" in batch else [batch]
