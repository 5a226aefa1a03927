"""The reference's StepLR, as ``sshslie_tpu/utils/schedule.py::step_lr``.

StepLR(step_size=lr_update_period, gamma=lr_update_factor) steps once per
epoch (reference model.py:216-217,334-335); when the decomposition net
unfreezes, the reference recreates the scheduler with the LR then in effect
as its base, which restarts the decay clock (model.py:284-287).
"""

from __future__ import annotations


def step_lr(epoch: int, start_lr: float, gamma: float, period: int,
            unfreeze_epoch: int = 0) -> float:
    """LR for the 0-based ``epoch``; ``unfreeze_epoch > 0`` restarts the clock there."""
    if abs(gamma - 1.0) <= 1e-6:
        return start_lr
    if unfreeze_epoch and epoch >= unfreeze_epoch:
        base = start_lr * gamma ** (unfreeze_epoch // period)
        return base * gamma ** ((epoch - unfreeze_epoch) // period)
    return start_lr * gamma ** (epoch // period)
