"""The bfloat16 train step's gradient against the float32 step's, on the
CPU, for the port and for the JAX package on the same batch and weights.

    JAX_PLATFORMS=cpu python3 tools/train_grad_noise.py [--scenes N] [--no-jax]

A full-width MinkUNet34C(3 -> 64) with the port's seeded weights, a batch of
N synthetic scenes (2 x 1.5 x 2 m, 6,000 background points, 3 boxes x 800
points, ~7.6k voxels each): the gradient of the joint loss at a BN
momentum of 0.5, in bfloat16 and in float32, by the port and (unless
``--no-jax``) by the JAX package. Prints one JSON line a package: each
parameter tensor's relative L2 error of the bfloat16 gradient against the
float32 one (worst and median), all tensors together, their cosine and the
head's (``final.kernel``) error. It measures the rounding noise the bf16
step carries at random initialization, which ``chip_smoke.py``'s train
phase bounds on the card. Several minutes of CPU (JAX compiles the net
twice).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def summary(package, grads):
    """Relative L2 errors of the bf16 gradients against the float32 ones."""
    bf, f32 = grads["bfloat16"], grads["float32"]
    rel = {n: float(np.linalg.norm(bf[n] - f32[n]) / np.linalg.norm(f32[n]))
           for n in f32}
    a = np.concatenate([bf[n].ravel() for n in f32])
    b = np.concatenate([f32[n].ravel() for n in f32])
    worst = max(rel, key=rel.get)
    return {"package": package, "tensors": len(rel),
            "worst": {"tensor": worst, "rel_l2": rel[worst]},
            "median_rel_l2": float(np.median(list(rel.values()))),
            "global_rel_l2": float(np.linalg.norm(a - b) / np.linalg.norm(b)),
            "cosine": float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))),
            "head_rel_l2": rel["final.kernel"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--no-jax", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from canonicalvoting_tpu_torch.config import Config
    from canonicalvoting_tpu_torch.data.collate import collate_joint
    from canonicalvoting_tpu_torch.data.synthetic import make_scene
    from canonicalvoting_tpu_torch.models import MINKUNET34C
    from canonicalvoting_tpu_torch.models.minkunet import MinkUNet34C
    from canonicalvoting_tpu_torch.ops.voxelize import sparse_quantize
    from canonicalvoting_tpu_torch.train import steps
    from canonicalvoting_tpu_torch.utils.weights import flatten, to_jax_variables

    rng = np.random.RandomState(0)
    items = []
    for i in range(args.scenes):
        s = make_scene(rng, extent=(2.0, 1.5, 2.0), n_background=6000,
                       n_boxes=3, pts_per_box=800)
        c, idx = sparse_quantize(s.points, 0.03)
        items.append((f"s{i}", c, s.rgb[idx], s.xyz_labels[idx],
                      s.scale_labels[idx], s.class_labels[idx]))
    batch = collate_joint(items, cap_multiple=4096)

    def model(dtype):
        return MinkUNet34C(3, 64, compute_dtype=dtype,
                           generator=torch.Generator().manual_seed(0))

    grads = {}
    for dtype in ("bfloat16", "float32"):
        state = steps.create_train_state(model(dtype), 0.0, device="cpu")
        steps.make_joint_train_step(state.model, Config())(state, batch, 1e-3, 0.5)
        grads[dtype] = {n: p.grad.numpy() for n, p in state.model.named_parameters()}
    print(json.dumps({**summary("port", grads),
                      "voxels": [len(it[1]) for it in items]}), flush=True)
    if args.no_jax:
        return

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp

    from canonicalvoting_tpu.data.collate import collate_joint as jax_collate
    from canonicalvoting_tpu.models.minkunet import MinkUNetBase
    from canonicalvoting_tpu.train.losses import joint_losses

    jb = jax_collate(items, cap_multiple=4096)
    var = to_jax_variables(model("float32"))
    feats = jnp.asarray(jb["feats"])
    pyr = jax.tree_util.tree_map(jnp.asarray, jb["pyramid"])
    jgrads = {}
    for dtype in ("bfloat16", "float32"):
        m = MinkUNetBase(3, 64, compute_dtype=dtype, block="basic", **MINKUNET34C)

        def loss(params, feats, pyr):
            out, _ = m.apply({"params": params, "batch_stats": var["batch_stats"]},
                             feats, pyr, True, 0.5, mutable=["batch_stats"])
            return joint_losses(out, jb["xyz_labels"], jb["scale_labels"],
                                jb["class_labels"], pyr["nvalid"][0],
                                (1.0, 1.0, 1.0))["loss"]

        g = jax.jit(jax.grad(loss))(var["params"], feats, pyr)
        jgrads[dtype] = {n: np.asarray(v) for n, v in flatten(jax.device_get(g))}
    print(json.dumps(summary("jax", jgrads)), flush=True)


if __name__ == "__main__":
    main()
