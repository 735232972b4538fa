"""Train steps on the gather-form sparse backbone and on the dense route.

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

``backbone="gather"`` steps a ``MinkUNetBase`` on ``collate_joint`` /
``collate_separate`` batches; ``backbone="dense"`` (``tpu.train_backbone=
dense``) steps the masked dense twin, ``DenseMinkUNet.train_forward``, on
``collate_joint_dense`` / ``collate_separate(dense=True)`` batches: the
same parameter names, so checkpoints and the validation's dense backbone
interchange with the gather form's. Its float32 convs run on the card with
TF32 off (cuDNN's default rounds float32 conv operands to TF32).
``tpu.train_remat`` is :func:`create_train_state`'s ``remat``.

On the gather backbone, ``tpu.train_dense_levels`` (default "stem") routes
its conv sites through the scatter-dense engine (``ops/scatter_conv.py``)
for batches collated ``with_flat_levels=True`` (the loops do so whenever
a site is listed), as the JAX step does: :func:`build_dense_plans` makes
the sites' plans from the batch's flat ids; the outputs are the gather
form's. Mesh training (``tpu.mesh_data`` x ``tpu.mesh_model`` > 1) steps
through ``parallel/data_parallel.py``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List

import torch

from canonicalvoting_tpu_torch.data.collate import batch_parts, upload_batch
from canonicalvoting_tpu_torch.models.minkunet import dense_twin
from canonicalvoting_tpu_torch.ops.scatter_conv import DensePlan
from canonicalvoting_tpu_torch.train.losses import joint_losses, separate_losses

BACKBONES = ("auto", "gather", "dense")


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
                       device="cuda", remat: bool = False) -> TrainState:
    """``model`` on ``device`` in training mode, with a fresh optimizer;
    ``remat`` (``tpu.train_remat``) recomputes each residual block in the
    backward (``models/norm.py:remat``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training runs on the GPU and none is available; "
                           "pass device='cpu' to train on the CPU")
    model = model.to(device).train()
    model.remat = remat
    return TrainState(model, make_optimizer(model.parameters(), weight_decay))


def create_train_state_dense(model: torch.nn.Module, weight_decay: float = 0.0,
                             device="cuda", remat: bool = False) -> TrainState:
    """:func:`create_train_state` of ``model``'s masked dense twin (a
    ``DenseMinkUNet`` with its weights; ``model`` a ``MinkUNetBase`` or a
    ``DenseMinkUNet``), the dense route's model. The JAX package
    initializes it from a first batch; here the weights come with
    ``model``."""
    return create_train_state(dense_twin(model), weight_decay, device, remat)


def set_lr(optimizer: torch.optim.Optimizer, lr) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def parse_dense_sites(spec: str, n_levels: int = 5) -> frozenset:
    """``tpu.train_dense_levels`` -> the conv sites routed through the
    scatter-dense engine: "" none; "all"; or a comma list of "stem", level
    ints (block convs) and "downI"/"upI"."""
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


def build_dense_plans(flat_levels, grid_dims, n_scenes: int, sites,
                      stem_kernel: int = 5) -> Dict:
    """The ``DensePlan`` of each site of ``sites`` from a batch's level
    flat ids (``collate_* (with_flat_levels=True)``, on the device) and its
    L0 dims (JAX ``build_dense_plans``): the stem folded, the block convs
    "sub", the downs and ups at their input level's grid."""
    nlev = len(flat_levels)
    gs = [(n_scenes,) + tuple(int(d) >> lv for d in grid_dims)
          for lv in range(nlev)]
    plans = {}
    if "stem" in sites:
        plans["stem"] = DensePlan(flat_levels[0], flat_levels[0],
                                  kind="stem_fold", k=stem_kernel,
                                  grid_shape=gs[0])
    for lv in range(nlev):
        if ("conv", lv) in sites:
            plans[("conv", lv)] = DensePlan(flat_levels[lv], flat_levels[lv],
                                            kind="sub", k=3, grid_shape=gs[lv])
    for i in range(nlev - 1):
        if ("down", i) in sites:
            plans[("down", i)] = DensePlan(flat_levels[i], flat_levels[i + 1],
                                           kind="down", k=2, grid_shape=gs[i])
        if ("up", i) in sites:
            plans[("up", i)] = DensePlan(flat_levels[i + 1], flat_levels[i],
                                         kind="up", k=2, grid_shape=gs[i + 1])
    return plans


def train_backbone(cfg) -> str:
    """``tpu.train_backbone`` as a step's ``backbone``: "auto" trains the
    gather form, the JAX package's measured choice."""
    backbone = cfg.tpu.train_backbone
    if backbone not in BACKBONES:
        raise ValueError(f"tpu.train_backbone must be one of {BACKBONES}, "
                         f"got {backbone!r}")
    return "gather" if backbone == "auto" else backbone


def train_microbatch(cfg, backbone: str, device) -> int:
    """The scenes a microbatch: ``tpu.train_microbatch``, and 1 for 0 on
    the dense route on the card, as the JAX loops force it on their
    accelerator (JAX ``train/joint_loop.py:101-103``): a whole-batch dense
    backward at ScanNet scale does not fit its memory."""
    mb = cfg.tpu.train_microbatch
    if mb == 0 and backbone == "dense" and torch.device(device).type == "cuda":
        return 1
    return mb


@contextlib.contextmanager
def exact_float32_convs(on: bool):
    """cuDNN's float32 convs without TF32 inside (when ``on``), the
    caller's setting restored after."""
    old = torch.backends.cudnn.allow_tf32
    if on:
        torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def accumulate_grads(model: torch.nn.Module, batch: Dict,
                     losses_of: Callable, bn_momentum,
                     divisor: int = 1) -> Dict[str, torch.Tensor]:
    """One forward and backward a microbatch (or of the whole batch), in
    order; leaves the gradients averaged over the microbatches in the
    parameters' ``.grad`` and returns the averaged losses (detached).
    Autograd is on inside, whatever the caller's grad mode; a float32
    model's convs take no TF32. ``divisor`` divides the loss each backward
    takes (a mesh's data shards), not the losses returned."""
    model.train()
    for p in model.parameters():
        p.grad = None
    device = next(model.parameters()).device
    parts = batch_parts(batch)
    total = None
    exact = getattr(model, "compute_dtype", "") == "float32"
    for part in parts:
        with torch.enable_grad(), exact_float32_convs(exact):
            losses = losses_of(upload_batch(part, device), float(bn_momentum))
            loss = losses["loss"]
            (loss if divisor == 1 else loss / divisor).backward()
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


def apply_update(state: TrainState, lr) -> TrainState:
    """One optimizer update at learning rate ``lr`` from the gradients in
    the parameters' ``.grad``."""
    set_lr(state.optimizer, lr)
    state.optimizer.step()
    state.step += 1
    return state


def _make_step(losses_of: Callable) -> Callable:
    def step(state: TrainState, batch: Dict, lr, bn_momentum):
        losses = accumulate_grads(state.model, batch, losses_of, bn_momentum)
        return apply_update(state, lr), losses

    return step


def _forward(model: torch.nn.Module, backbone: str, dense_sites=frozenset()):
    """``(batch, momentum) -> (head rows, nvalid)`` of a train-mode forward
    on the backbone's batches; on the gather backbone, the ``dense_sites``
    of a batch with flat levels run through the scatter-dense engine."""
    if backbone not in ("gather", "dense"):
        raise ValueError(f"backbone must be 'gather' or 'dense', got {backbone!r}")

    def run(b, mom):
        meta = b["meta"]
        if backbone == "dense":
            return model.train_forward(
                b["feats"], b["flat_idx"], b["valid"], tuple(meta["grid_dims"]),
                mom, n_scenes=meta["n_scenes"]), b["nvalid"]
        plans = None
        if dense_sites and "flat_levels" in b:
            plans = build_dense_plans(b["flat_levels"], meta["grid_dims"],
                                      meta["n_scenes"], dense_sites,
                                      model.stem_kernel)
        return (model(b["feats"], b["pyramid"], True, mom, dense_plans=plans),
                b["pyramid"]["nvalid"][0])

    return run


def joint_losses_of(model: torch.nn.Module, cfg,
                    backbone: str = "gather") -> Callable:
    """``(device batch, momentum) -> losses`` of the joint step."""
    xyz_weights = tuple(cfg.xyz_weights)
    forward = _forward(model, backbone,
                       parse_dense_sites(cfg.tpu.train_dense_levels))

    def losses_of(b, mom):
        out, nvalid = forward(b, mom)
        return joint_losses(out, b["xyz_labels"], b["scale_labels"],
                            b["class_labels"], nvalid, xyz_weights,
                            cfg.log_scale, cfg.xyz_factor, cfg.scale_factor)

    return losses_of


def make_joint_train_step(model: torch.nn.Module, cfg,
                          backbone: str = "gather") -> Callable:
    """``step(state, batch, lr, bn_momentum) -> (state, losses)`` for a
    ``MinkUNetBase`` fed ``collate_joint`` batches, or (``backbone=
    "dense"``) a ``DenseMinkUNet`` fed ``collate_joint_dense`` batches."""
    return _make_step(joint_losses_of(model, cfg, backbone))


def separate_losses_of(model: torch.nn.Module, cfg, max_objects: int,
                       backbone: str = "gather") -> Callable:
    """``(device batch, momentum) -> losses`` of the separate step."""
    xyz_weights = tuple(cfg.xyz_weights)
    forward = _forward(model, backbone,
                       parse_dense_sites(cfg.tpu.train_dense_levels))

    def losses_of(b, mom):
        out, nvalid = forward(b, mom)
        return separate_losses(
            out, b["base_xyz"], b["scale_labels"], b["obj_labels"],
            b["obj_id"], b["sym_code"], int(b["num_objects"]), nvalid,
            xyz_weights, max_objects, cfg.log_scale, cfg.xyz_factor,
            cfg.scale_factor)

    return losses_of


def make_separate_train_step(model: torch.nn.Module, cfg, max_objects: int,
                             backbone: str = "gather") -> Callable:
    """As :func:`make_joint_train_step`, for a per-category model fed
    ``collate_separate`` batches (``dense=True`` ones on the dense route;
    upstream train_separate.py:184-298)."""
    return _make_step(separate_losses_of(model, cfg, max_objects, backbone))
