"""The joint model's training step under the port's default settings.

Set-up makes a pool of batches of scans (laid out by the traffic,
coloured from the seed) and collates each with the port's
``collate_joint`` as its training loop does (the
configuration's settings read through the port's ``config.py`` keys), makes
the model's weights on the card, builds the train state and the step of
``make_joint_train_step``, and drives that same state through its first
steps, one batch each: steps 1-3 are the ones the reference follows, and
every other pool member gets one more warm-up step. The window then steps
the same state through the pool in a fixed cycle, reading each step's loss
as the loop does; a traced run then profiles one step on each batch.

After the window the program is freed, and the reference (``reference/``)
takes the same weights and the same scans through its own three steps:
each step's loss, the first gradient (the program's from its optimizer's
first moment after one step) and each leaf's change over the three steps
are compared leaf by leaf.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np

from harness import scenes, trace, weights
from harness.work import backbone_work
from reference import minkunet
from reference import train as ref_train

NUMBERS = ("head_rel_err", "loss_gap", "grad_gap", "update_gap")
CHECKED_STEPS = 3


class Inputs:
    """The pool of batches (each scan's voxels and labels) and the recipe
    of the model's weights, for both sides."""

    def __init__(self, torch, cell, seed: int, device, rehearse: bool = False):
        self.torch, self.seed, self.device = torch, seed, device
        cfg, tr = dict(cell.config), dict(cell.traffic)
        if rehearse:
            cfg.update(cfg.get("rehearsal", {}))
            tr.update(tr.get("rehearsal", {}))
        self.cfg, self.tr = cfg, tr
        self.res = float(cfg["res"])
        self.sites = minkunet.conv_sites(cfg["in_channels"], cfg["out_channels"],
                                         cfg["layers"], cfg["planes"],
                                         cfg["init_dim"], cfg["stem_kernel"])
        self.specs = minkunet.param_specs(self.sites)
        bs = int(tr["batch_size"])
        self.batches = []
        for b in range(int(tr["pool"])):
            items = []
            for j in range(bs):
                rows = scenes.member_scan(tr, seed, b * bs + j, self.res)[1]
                items.append((f"scan{b}_{j}",) + rows)
            self.batches.append(items)

    def weights(self):
        return weights.make(self.torch, self.specs, 1, self.seed, self.device)[0]

    def reference_batch(self, b: int) -> Dict[str, "torch.Tensor"]:
        """Batch ``b`` as the reference takes it: the scans' voxels with a
        batch column, in order, and their features and labels."""
        torch, dev = self.torch, self.device
        items = self.batches[b]
        coords = np.concatenate([np.pad(it[1], ((0, 0), (1, 0)),
                                        constant_values=i)
                                 for i, it in enumerate(items)])

        def cat(i):
            return torch.from_numpy(np.concatenate([it[i] for it in items])).to(dev)

        return {"coords": torch.from_numpy(coords).to(dev).long(),
                "feats": cat(2) * 2.0 - 1.0, "xyz": cat(3), "scale": cat(4),
                "cls": cat(5).long()}


class Driver:

    def __init__(self, torch, cell, seed: int, device, traced: bool,
                 fault: str = "", rehearse: bool = False):
        from canonicalvoting_tpu_torch import config as pconfig
        from canonicalvoting_tpu_torch.data import collate
        from canonicalvoting_tpu_torch.models.minkunet import MinkUNetBase
        from canonicalvoting_tpu_torch.train import steps

        self.torch, self.device, self.traced = torch, device, traced
        self.inp = inp = Inputs(torch, cell, seed, device, rehearse)
        cfg = inp.cfg
        pcfg = pconfig.load_config(overrides=list(cfg["program_settings"]))
        self.lr, self.momentum = float(cfg["learning_rate"]), float(cfg["bn_momentum"])
        self.patched = []
        if fault == "unchanged":      # a step that leaves the state as it was
            self._patch(steps, "apply_update", lambda state, lr: state)
        elif fault == "half":         # the loss over half of the batch
            losses = steps.joint_losses

            def half(out, *a, **kw):
                a = list(a)
                a[3] = a[3] // 2
                return losses(out, *a, **kw)
            self._patch(steps, "joint_losses", half)
        backbone = steps.train_backbone(pcfg)
        mb = steps.train_microbatch(pcfg, backbone, device)
        cap = pcfg.tpu.point_buckets[0]
        with torch.device("meta"):
            model = MinkUNetBase(cfg["in_channels"], cfg["out_channels"],
                                 layers=cfg["layers"], planes=cfg["planes"],
                                 init_dim=cfg["init_dim"],
                                 stem_kernel=cfg["stem_kernel"],
                                 compute_dtype=pcfg.tpu.conv_dtype)
        model.load_state_dict(inp.weights(), assign=True)
        if backbone == "dense":
            state = steps.create_train_state_dense(
                model, pcfg.weight_decay, device, remat=pcfg.tpu.train_remat)
            self.batches = [collate.collate_joint_dense(
                items, microbatch=mb, cap_multiple=cap) for items in inp.batches]
        else:
            state = steps.create_train_state(model, pcfg.weight_decay, device,
                                             remat=pcfg.tpu.train_remat)
            self.batches = [collate.collate_joint(
                items, microbatch=mb, cap_multiple=cap,
                with_flat_levels=bool(steps.parse_dense_sites(
                    pcfg.tpu.train_dense_levels))) for items in inp.batches]
        self.step = steps.make_joint_train_step(state.model, pcfg, backbone=backbone)
        self.state = state
        self.batch_scenes = len(inp.batches[0])

        # steps 1-3, the ones the reference follows, through the same call
        params = dict(state.model.named_parameters())
        self.start = {k: p.detach().cpu().clone() for k, p in params.items()}
        self.losses: List[float] = []
        rows = []     # the first step's head rows, as its forward returns them
        hook = state.model.register_forward_hook(
            lambda module, args, out: rows.append(out.detach().clone()))
        for i in range(CHECKED_STEPS):
            self.losses.append(self._step(i))
            if i == 0:
                hook.remove()
                self.first_rows = rows[0][:sum(len(it[1]) for it in inp.batches[0])]
                beta1 = state.optimizer.param_groups[0]["betas"][0]
                self.first_grad = {
                    k: (state.optimizer.state[p]["exp_avg"].cpu() / (1 - beta1)
                        if p in state.optimizer.state else torch.zeros_like(
                            self.start[k])) for k, p in params.items()}
        self.after = {k: p.detach().cpu().clone() for k, p in params.items()}
        for i in range(CHECKED_STEPS, len(self.batches)):   # the rest, warm-up
            self._step(i)
        self.sync()
        gc.collect()
        gc.freeze()              # the collector no longer walks set-up's objects
        self.step_s: List[float] = []
        self.next = len(self.batches)

    def _patch(self, module, name, fn):
        self.patched.append((module, name, getattr(module, name)))
        setattr(module, name, fn)

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def _step(self, i: int) -> float:
        self.state, losses = self.step(self.state, self.batches[i % len(self.batches)],
                                       self.lr, self.momentum)
        return float(losses["loss"])

    def run_window(self, seconds: float) -> float:
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            self._step(self.next)
            self.next += 1
            b = time.perf_counter()
            self.step_s.append(b - a)
            if b - t0 >= seconds:
                return b - t0

    def run_profiled(self):
        """One step on each batch of the pool under the profiler, from the
        first; their trace summary."""
        torch, n = self.torch, len(self.batches)
        self.next += -self.next % n
        self.sync()
        with trace.profile(torch) as prof:
            with torch.profiler.record_function("window"):
                for _ in range(n):
                    with torch.profiler.record_function("step"):
                        self._step(self.next)
                    self.next += 1
                self.sync()
        self.profiled_units = n
        return trace.read(prof, ("step",))

    def attempted(self) -> int:
        return len(self.step_s)

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        from harness.stats import rate
        return {"train_scenes_per_s": rate(len(self.step_s) * self.batch_scenes,
                                           window_s)}

    def info(self) -> Dict[str, object]:
        return {"steps": len(self.step_s), "scenes_per_step": self.batch_scenes,
                "checked_losses": self.losses,
                "voxels": [[len(it[1]) for it in b] for b in self.inp.batches]}

    def layer_record(self, window_s: float) -> Dict[str, object]:
        torch, inp = self.torch, self.inp
        flops = []
        for b in range(len(inp.batches)):
            geo = minkunet.geometry(inp.reference_batch(b)["coords"])
            flops.append(backbone_work(geo, inp.sites).flops)
        n = len(inp.batches)
        start = len(inp.batches)
        return {"units": len(self.step_s), "window_s": window_s,
                "unit_s": self.step_s,
                "unit_flops": [flops[(start + i) % n]
                               for i in range(len(self.step_s))],
                "profiled_units": self.profiled_units}

    def release(self):
        for module, name, fn in self.patched:
            setattr(module, name, fn)
        self.state = self.step = self.batches = None
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def check(self, limits: Dict[str, float]) -> Dict[str, float]:
        ref = reference_steps(self.inp, None)
        got = {"losses": self.losses, "first": self.first_grad,
               "rows": self.first_rows,
               "change": {k: self.after[k] - self.start[k] for k in self.start}}
        nums, self.worst = gaps(got, ref)
        self.failed = 0
        return nums


def reference_steps(inp: Inputs, quant) -> Dict[str, object]:
    """The reference's three steps from the seed's weights over the first
    three batches: losses, first gradients, each leaf's change."""
    params = inp.weights()
    start = {k: v.clone() for k, v in params.items()}
    batches = [inp.reference_batch(b) for b in range(CHECKED_STEPS)]
    losses, first, rows = ref_train.train_steps(
        params, batches, inp.cfg["layers"], float(inp.cfg["learning_rate"]), quant)
    return {"losses": losses, "first": {k: v.cpu() for k, v in first.items()},
            "rows": rows,
            "change": {k: (params[k] - start[k]).cpu() for k in first}}


def gaps(got: Dict[str, object], ref: Dict[str, object]):
    """(numbers, their worst leaves). ``head_rel_err``: the first step's
    head rows (its forward's output), the widest gap over their largest
    value. ``loss_gap``: each step's loss gap over the reference's loss,
    the worst step. By leaf, the gap between the two norms of the first
    gradient and of the change over the steps, over the reference's norm
    of that leaf or of the median leaf, whichever is larger: ``grad_gap``
    and ``update_gap``, the worst leaf's (the median leaf's in the
    details). Leaves whose reference gradient is under a thousandth of the
    median leaf's are left out."""
    import torch
    steps = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
    leaves = list(ref["first"])
    gn = {k: float(torch.linalg.vector_norm(ref["first"][k].double())) for k in leaves}
    med = float(np.median(list(gn.values())))
    counted = [k for k in leaves if gn[k] >= 1e-3 * med]
    detail = {"left_out": [k for k in leaves if k not in counted],
              "loss_gap_by_step": steps}

    def by_leaf(key):
        r = {k: float(torch.linalg.vector_norm(ref[key][k].double())) for k in counted}
        p = {k: float(torch.linalg.vector_norm(got[key][k].double())) for k in counted}
        m = float(np.median(list(r.values())))
        gap = {k: abs(p[k] - r[k]) / max(r[k], m) for k in counted}
        k = max(gap, key=gap.get)
        detail[key] = {"leaf": k, "gap": gap[k], "ref_norm": r[k],
                       "norm": p[k], "median_ref_norm": m,
                       "median_gap": float(np.median(list(gap.values())))}
        return gap

    g, u = by_leaf("first"), by_leaf("change")
    detail["grad_gap_median"] = float(np.median(list(g.values())))
    want = ref["rows"]
    rows = float((got["rows"].float() - want).abs().max() / want.abs().max())
    nums = {"head_rel_err": rows, "loss_gap": max(steps),
            "grad_gap": max(g.values()), "update_gap": max(u.values())}
    return nums, detail


def control(inp: Inputs) -> Dict[str, float]:
    """The control's numbers: the reference with float8 products in the
    program's place, held against the reference; and under
    ``backward_only`` those of the reference whose forward keeps the
    configuration's bfloat16 and whose backward takes float8."""
    ref = reference_steps(inp, None)
    nums, worst = gaps(reference_steps(inp, minkunet.fp8), ref)
    back, back_worst = gaps(reference_steps(inp, minkunet.BACKWARD_FP8), ref)
    return dict(nums, worst=worst, backward_only=dict(back, worst=back_worst))
