"""The trainer's update rule (ffrnet_tpu/training/optimizers.py): each
gradient clipped elementwise at `clip_value` (the reference's
clip_grad_value_(1.0)), then adam / rmsprop / sgd / adabound with L2 weight
decay into the (clipped) gradient, at the learning rate the schedule gives
for the update's 0-based index.

  adam      torch.optim.Adam: bias-corrected moments
  rmsprop   torch.optim.RMSprop: v = a v + (1-a) g^2 (a = 0.99),
            buf = mu buf + g / (sqrt(v) + eps) (eps outside the sqrt),
            p -= lr buf, momentum 0.9
  sgd       torch.optim.SGD: buf = mu buf + g (no dampening), nesterov
            reaches it
  adabound  training/adabound.py, final_lr = 100 * base lr

optax and torch.optim order Adam's arithmetic differently: the same
update to rounding.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from ffrnet_torch.training.adabound import AdaBound

OPTIMIZERS = ("adam", "rmsprop", "sgd", "adabound")


class ClippedOptimizer:
    """A torch.optim optimizer behind the elementwise clip, its learning
    rate set from `schedule(count)` before each update."""

    def __init__(self, inner: torch.optim.Optimizer, schedule: Callable[[int], float],
                 clip_value: float | None):
        self.inner = inner
        self.schedule = schedule
        self.clip_value = clip_value

    @property
    def params(self):
        return [p for g in self.inner.param_groups for p in g["params"]]

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

    def step(self, count: int) -> float:
        """Clip, then one update at schedule(count); returns that lr."""
        if self.clip_value is not None:
            torch.nn.utils.clip_grad_value_(self.params, self.clip_value)
        lr = self.schedule(count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        return lr


def make_optimizer(name: str, params: Iterable[torch.Tensor], learning_rate, *,
                   b1: float = 0.9, b2: float = 0.999, momentum: float = 0.9,
                   weight_decay: float = 0.0, nesterov: bool = False,
                   clip_value: float | None = 1.0,
                   base_lr: float | None = None) -> ClippedOptimizer:
    """`learning_rate`: a float or a schedule count -> lr."""
    name = name.lower()
    schedule = learning_rate if callable(learning_rate) else (lambda _: learning_rate)
    lr0 = schedule(0)
    params = list(params)
    if name == "adam":
        inner = torch.optim.Adam(params, lr=lr0, betas=(b1, b2), eps=1e-8,
                                 weight_decay=weight_decay)
    elif name == "rmsprop":
        inner = torch.optim.RMSprop(params, lr=lr0, alpha=0.99, eps=1e-8, momentum=momentum,
                                    weight_decay=weight_decay)
    elif name == "sgd":
        inner = torch.optim.SGD(params, lr=lr0, momentum=momentum, dampening=0.0,
                                weight_decay=weight_decay, nesterov=nesterov)
    elif name == "adabound":
        base = lr0 if base_lr is None else base_lr
        inner = AdaBound(params, lr0, base_lr=base, final_lr=100.0 * base, betas=(b1, b2),
                         weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    return ClippedOptimizer(inner, schedule, clip_value)
