"""Learning-rate schedules (ffrnet_tpu/training/schedules.py).

The reference steps MultiStepLR(milestones=[5000, 10000, 15000], gamma=0.5)
once per ITERATION: the update with 0-based index `count` takes
base_lr * gamma ** |{m : m <= count}|, what
torch.optim.lr_scheduler.MultiStepLR gives after `count` scheduler steps.
"""

from __future__ import annotations

from typing import Callable, Sequence


def multistep_lr(base_lr: float, milestones: Sequence[int] = (5000, 10000, 15000),
                 gamma: float = 0.5) -> Callable[[int], float]:
    ms = sorted(milestones)

    def schedule(count: int) -> float:
        return base_lr * gamma ** sum(m <= count for m in ms)

    return schedule


def constant_lr(base_lr: float) -> Callable[[int], float]:
    return lambda count: base_lr
