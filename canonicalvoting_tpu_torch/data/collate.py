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

The dense-backbone, flat-level and sharded collates of the JAX package are
not ported.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Sequence

import numpy as np

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


def collate_joint(items: Sequence, cap_multiple: int = 4096,
                  microbatch: int = 0, pyr: PyramidArrays = None) -> Dict:
    """items: (id_scan, coords, feats, xyz_labels, scale_labels,
    class_labels). A host batch: ``feats`` (rgb rescaled to [-1, 1]),
    ``pyramid`` (a ``PyramidArrays``; ``pyr`` gives it built), the padded
    labels and ``meta``; ``microbatch=k``: ``{"microbatches": [batch, ...],
    "meta"}``."""
    if microbatch:
        groups, pyrs = _microbatches(items, microbatch, cap_multiple)
        return {"microbatches": [collate_joint(g, pyr=p)
                                 for g, p in zip(groups, pyrs)],
                "meta": {"ids": [it[0] for it in items]}}
    pyr = pyr if pyr is not None else _pyramid(items, cap_multiple)
    cap0 = pyr.coords[0].shape[0]
    return {
        "meta": {"ids": [it[0] for it in items], "coords": pyr.coords[0]},
        "feats": _feats(items, cap0),
        "pyramid": pyr,
        "xyz_labels": _cat(items, 3, np.float32, cap0, 0.0),
        "scale_labels": _cat(items, 4, np.float32, cap0, 1.0),
        "class_labels": _cat(items, 5, np.int32, cap0, NCLASSES),
    }


def collate_separate(items: Sequence, cap_multiple: int = 4096,
                     max_objects: int = 64, microbatch: int = 0,
                     pyr: PyramidArrays = None) -> Dict:
    """items: (id_scan, coords, feats, base_xyz, scale_labels, obj_labels,
    class_labels, obj_id, sym_codes). Object ids are offset per scene into
    one id space for the batch (the segment sums of the symmetry loss);
    objects past ``max_objects`` leave the xyz loss."""
    if microbatch:
        groups, pyrs = _microbatches(items, microbatch, cap_multiple)
        return {"microbatches": [
                    collate_separate(g, max_objects=max_objects, pyr=p)
                    for g, p in zip(groups, pyrs)],
                "meta": {"ids": [it[0] for it in items]}}
    pyr = pyr if pyr is not None else _pyramid(items, cap_multiple)
    cap0 = pyr.coords[0].shape[0]

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
    return {
        "meta": {"ids": [it[0] for it in items], "coords": pyr.coords[0]},
        "pyramid": pyr,
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
    ``device``: the pyramid's tables (``PyramidArrays.to``), ``feats`` and
    every label array in one copy; scalars and ``meta`` stay on the host."""
    names = [k for k, v in batch.items()
             if isinstance(v, np.ndarray) and v.ndim > 0]
    tables, arrays = batch["pyramid"].to(device, [batch[k] for k in names])
    out = {k: v for k, v in batch.items() if k not in names}
    out.update(zip(names, arrays))
    out["pyramid"] = tables
    return out


def batch_parts(batch: Dict) -> List[Dict]:
    """The microbatches of a host batch, or the batch itself."""
    return batch["microbatches"] if "microbatches" in batch else [batch]
