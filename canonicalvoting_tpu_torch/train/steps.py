"""Train steps on the gather-form sparse backbone.

The port's counterpart of ``canonicalvoting_tpu/train/steps.py``. The
optimizer is ``torch.optim.Adam`` (or ``AdamW`` with a weight decay), whose
update is optax's ``adam`` / ``adamw``: bias-corrected moments, eps 1e-8
outside the square root, the decay decoupled and scaled by the same
learning rate. The learning rate is set on every parameter group before
each update, as the JAX package injects it (``set_lr``), so the upstream
step-decay schedule (train_joint.py:128-138) drives it from the host; the
BN momentum schedule rides along as a step input (train_joint.py:224-225).

A step runs the model in training mode (the BN statistics over the valid
rows, the running statistics updated with the step's momentum), the
losses, one backward and one optimizer update. A batch with
``microbatches`` (``data/collate.py``, ``microbatch=k``) takes one
backward a microbatch, in order, so the BN running statistics thread
through them; the gradients and losses are averaged over the microbatches
and the optimizer updates once, as the JAX package's gradient accumulation
does.

Only the gather backbone is ported: ``tpu.train_backbone="dense"`` (the
masked dense twin), ``tpu.train_remat`` and mesh training raise
(:func:`check_ported_routes`). ``tpu.train_dense_levels`` is parsed and the
gather form runs at every site: the JAX package's scatter-dense engine
(``ops/scatter_conv.py``) computes the same outputs through another
mechanism.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List

import torch

from canonicalvoting_tpu_torch.data.collate import batch_parts, upload_batch
from canonicalvoting_tpu_torch.train.losses import joint_losses, separate_losses

BACKBONES = ("auto", "gather")


@dataclass
class TrainState:
    """The model, its optimizer and the number of updates taken; the epoch
    loop appends one record an epoch to ``history`` (epoch, mean loss,
    batches, scenes, seconds)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    history: List[Dict] = field(default_factory=list)


def make_optimizer(params: Iterable, weight_decay: float = 0.0,
                   learning_rate: float = 1e-3) -> torch.optim.Optimizer:
    """Adam, or AdamW with decoupled weight decay (upstream
    train_joint.py:219-223); the decay is passed explicitly, since AdamW's
    own default is 1e-2."""
    if weight_decay:
        return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.0)


def create_train_state(model: torch.nn.Module, weight_decay: float = 0.0,
                       device="cuda") -> TrainState:
    """``model`` on ``device`` in training mode, with a fresh optimizer."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training runs on the GPU and none is available; "
                           "pass device='cpu' to train on the CPU")
    model = model.to(device).train()
    return TrainState(model, make_optimizer(model.parameters(), weight_decay))


def set_lr(optimizer: torch.optim.Optimizer, lr) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def parse_dense_sites(spec: str, n_levels: int = 5) -> frozenset:
    """``tpu.train_dense_levels`` -> the conv sites the JAX package routes
    through its scatter-dense engine: "" none; "all"; or a comma list of
    "stem", level ints (block convs) and "downI"/"upI". The port parses the
    key and runs the gather form at every site."""
    if not spec:
        return frozenset()
    if spec == "all":
        return frozenset(
            {"stem"}
            | {("conv", lv) for lv in range(n_levels)}
            | {("down", i) for i in range(n_levels - 1)}
            | {("up", i) for i in range(n_levels - 1)})
    out = set()
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok == "stem":
            out.add("stem")
        elif tok.startswith("down"):
            out.add(("down", int(tok[4:])))
        elif tok.startswith("up"):
            out.add(("up", int(tok[2:])))
        else:
            out.add(("conv", int(tok)))
    return frozenset(out)


def check_ported_routes(cfg) -> None:
    """Raise for the training routes of the config that are not ported:
    the dense backbone, block remat and mesh training."""
    backbone = cfg.tpu.train_backbone
    if backbone == "dense":
        raise NotImplementedError(
            "the dense training backbone (DenseMinkUNet with a backward) is "
            "not ported yet (ROADMAP A9c); train on tpu.train_backbone=gather")
    if backbone not in BACKBONES:
        raise ValueError(f"tpu.train_backbone must be one of {BACKBONES}, "
                         f"got {backbone!r}")
    if cfg.tpu.train_remat:
        raise NotImplementedError(
            "tpu.train_remat (block rematerialization) is not ported yet "
            "(ROADMAP A9c)")
    if cfg.tpu.mesh_data * cfg.tpu.mesh_model > 1:
        raise NotImplementedError(
            "mesh training (tpu.mesh_data x tpu.mesh_model > 1) is not ported "
            "yet (ROADMAP A11); train on one device")


def accumulate_grads(model: torch.nn.Module, batch: Dict,
                     losses_of: Callable, bn_momentum) -> Dict[str, torch.Tensor]:
    """One forward and backward a microbatch (or of the whole batch), in
    order; leaves the gradients averaged over the microbatches in the
    parameters' ``.grad`` and returns the averaged losses (detached).
    Autograd is on inside, whatever the caller's grad mode."""
    model.train()
    for p in model.parameters():
        p.grad = None
    device = next(model.parameters()).device
    parts = batch_parts(batch)
    total = None
    for part in parts:
        with torch.enable_grad():
            losses = losses_of(upload_batch(part, device), float(bn_momentum))
            losses["loss"].backward()
        losses = {k: v.detach() for k, v in losses.items()}
        total = losses if total is None else {k: total[k] + v
                                              for k, v in losses.items()}
    if len(parts) > 1:
        k = float(len(parts))
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(k)
        total = {n: v / k for n, v in total.items()}
    return total


def _make_step(losses_of: Callable) -> Callable:
    def step(state: TrainState, batch: Dict, lr, bn_momentum):
        losses = accumulate_grads(state.model, batch, losses_of, bn_momentum)
        set_lr(state.optimizer, lr)
        state.optimizer.step()
        state.step += 1
        return state, losses

    return step


def make_joint_train_step(model: torch.nn.Module, cfg) -> Callable:
    """``step(state, batch, lr, bn_momentum) -> (state, losses)`` for a
    ``MinkUNetBase`` fed ``collate_joint`` batches."""
    parse_dense_sites(cfg.tpu.train_dense_levels)
    xyz_weights = tuple(cfg.xyz_weights)

    def losses_of(b, mom):
        out = model(b["feats"], b["pyramid"], True, mom)
        return joint_losses(out, b["xyz_labels"], b["scale_labels"],
                            b["class_labels"], b["pyramid"]["nvalid"][0],
                            xyz_weights, cfg.log_scale, cfg.xyz_factor,
                            cfg.scale_factor)

    return _make_step(losses_of)


def make_separate_train_step(model: torch.nn.Module, cfg,
                             max_objects: int) -> Callable:
    """As :func:`make_joint_train_step`, for a per-category model fed
    ``collate_separate`` batches (upstream train_separate.py:184-298)."""
    parse_dense_sites(cfg.tpu.train_dense_levels)
    xyz_weights = tuple(cfg.xyz_weights)

    def losses_of(b, mom):
        out = model(b["feats"], b["pyramid"], True, mom)
        return separate_losses(
            out, b["base_xyz"], b["scale_labels"], b["obj_labels"],
            b["obj_id"], b["sym_code"], int(b["num_objects"]),
            b["pyramid"]["nvalid"][0], xyz_weights, max_objects,
            cfg.log_scale, cfg.xyz_factor, cfg.scale_factor)

    return _make_step(losses_of)
