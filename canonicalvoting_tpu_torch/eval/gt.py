"""Ground-truth boxes of a scene (upstream train_joint.py:443-455,
eval_joint.py:284-303): each line of ``results_gt/<scan>.txt`` is
``tx ty tz ry sx sy sz ... category``, split on single spaces.

The port's copy of ``canonicalvoting_tpu/eval/gt.py``.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from canonicalvoting_tpu_torch.data.geometry import (
    NAME2CATNAME,
    rotmat_y,
    unit_box_corners,
)

# SceneNN's names of two Scan2CAD categories (upstream eval_joint.py:293-296)
_SCENENN_RENAMES = {"desk": "table", "television": "display"}


def parse_gt_line(line: str, map_catname: bool = True) -> Tuple[str, np.ndarray]:
    """(category, (8, 3) corners) of one ground-truth line."""
    parts = line.split(" ")
    tx, ty, tz, ry, sx, sy, sz = [float(v) for v in parts[:7]]
    category = parts[-1]
    if map_catname:
        category = NAME2CATNAME.get(category, category)
    box = (rotmat_y(ry) @ np.diag([sx, sy, sz]) @ unit_box_corners().T).T \
        + np.array([tx, ty, tz])
    return category, box


def load_gt_scene(gt_path: str, id_scan: str, map_catname: bool = True,
                  scenenn: bool = False) -> List[Tuple[str, np.ndarray]]:
    """Every box of ``<gt_path>/<id_scan>.txt``: ScanNet wnids mapped to
    category names, or SceneNN's names with its two renames."""
    with open(os.path.join(gt_path, f"{id_scan}.txt")) as f:
        lines = f.read().splitlines()
    out = []
    for line in lines:
        category, box = parse_gt_line(line, map_catname=map_catname and not scenenn)
        if scenenn:
            category = _SCENENN_RENAMES.get(category, category)
        out.append((category, box))
    return out
