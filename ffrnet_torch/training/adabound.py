"""AdaBound (Luo et al., ICLR 2019) as a torch.optim.Optimizer, the port of
ffrnet_tpu/training/adabound.py.

Adam's moments with bias correction, but the per-element step size
lr * sqrt(1 - b2^t) / (1 - b1^t) / (sqrt(v_t) + eps) is clamped to

    final_lr * (1 - 1/(gamma t + 1))  <=  .  <=  final_lr * (1 + 1/(gamma t))

which closes around final_lr as t grows. final_lr follows the schedule:
it is scaled by lr_t / base_lr (the group's "lr" over its "base_lr").
Weight decay is L2 into the gradient. FFR-Net takes final_lr = 100 * lr.
The JAX version's amsbound variant, which no caller sets, is not ported.
"""

from __future__ import annotations

import torch


class AdaBound(torch.optim.Optimizer):
    def __init__(self, params, lr: float, *, base_lr: float | None = None,
                 final_lr: float = 0.1, betas=(0.9, 0.999), gamma: float = 1e-3,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        defaults = dict(lr=lr, base_lr=lr if base_lr is None else base_lr,
                        final_lr=final_lr, betas=betas, gamma=gamma, eps=eps,
                        weight_decay=weight_decay)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdaBound: closures are not supported")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            wd, eps, gamma = group["weight_decay"], group["eps"], group["gamma"]
            flr = group["final_lr"] * group["lr"] / group["base_lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if wd:
                    g = g + wd * p
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                t = st["step"]
                m, v = st["exp_avg"], st["exp_avg_sq"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                step_size = group["lr"] * (1 - b2 ** t) ** 0.5 / (1 - b1 ** t)
                lower = flr * (1 - 1 / (gamma * t + 1))
                upper = flr * (1 + 1 / (gamma * t))
                eff = torch.clamp(step_size / (v.sqrt() + eps), lower, upper)
                p.sub_(eff * m)
