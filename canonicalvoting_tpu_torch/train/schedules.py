"""LR and BN-momentum schedules (upstream train_joint.py:93-138, 224-225).

The port's copy of ``canonicalvoting_tpu/train/schedules.py``.
BN_MOMENTUM_INIT = 0.5, BN_MOMENTUM_MAX = 0.001; the momentum decays by
bn_decay_rate every bn_decay_step epochs. The learning rate decays
multiplicatively at the configured epochs.
"""

from __future__ import annotations

BN_MOMENTUM_INIT = 0.5
BN_MOMENTUM_MAX = 0.001


def lr_for_epoch(epoch: int, base_lr: float, decay_steps, decay_rates) -> float:
    lr = base_lr
    for step, rate in zip(decay_steps, decay_rates):
        if epoch >= step:
            lr *= rate
    return lr


def bn_momentum_for_epoch(epoch: int, decay_step: int, decay_rate: float) -> float:
    return max(
        BN_MOMENTUM_INIT * decay_rate ** (epoch // decay_step), BN_MOMENTUM_MAX
    )
