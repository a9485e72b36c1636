"""Adam exactly as optax.adam computes it (the JAX package's optimizer for
every model without the hash grid, hashnerf_tpu/train/driver.py:161).

This is not torch.optim.Adam, whose bias correction folds into the step
size and rounds differently. optax's order, per parameter:
  m = (1 - b1) * g + b1 * m;  v = (1 - b2) * (g * g) + b2 * v;
  m_hat = m / (1 - b1^t);  v_hat = v / (1 - b2^t)  (t the count after this step);
  p += (m_hat / (sqrt(v_hat) + eps)) * -lr(t - 1).
eps sits outside the root (eps_root 0). As in train/radam.py, the step
count, the learning rate and the bias corrections are float32 tensors on
the parameters' device, so a captured CUDA graph replays the step with the
count of each replay, and the arithmetic is multi-tensor.
"""
from __future__ import annotations

from typing import Callable, Union

import torch

from hashnerf_torch.train.radam import DeviceStepOptimizer


class Adam(DeviceStepOptimizer):
    def __init__(
        self,
        params,
        lr: Union[float, Callable[[torch.Tensor], torch.Tensor]],
        betas=(0.9, 0.999),
        eps: float = 1e-8,
    ):
        super().__init__(params, lr, dict(betas=tuple(betas), eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            if not group["params"]:
                continue
            params, states, grads = self._group_tensors(group, closure)
            b1, b2 = group["betas"]
            m = [st["exp_avg"] for st in states]
            v = [st["exp_avg_sq"] for st in states]
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, torch._foreach_mul(grads, 1 - b1))
            g2 = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(g2, 1 - b2)
            torch._foreach_mul_(v, b2)
            torch._foreach_add_(v, g2)

            # A group's parameters step together: one count holds for all.
            step = states[0]["step"]
            neg_lr = -self.lr_fn(step)  # the schedule at the count before this step
            t = step + 1.0
            bias1 = 1.0 - torch.pow(torch.full_like(t, b1), t)
            bias2 = 1.0 - torch.pow(torch.full_like(t, b2), t)
            denom = torch._foreach_div(v, bias2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            delta = torch._foreach_div(m, bias1)
            torch._foreach_div_(delta, denom)
            torch._foreach_mul_(delta, neg_lr)
            torch._foreach_add_(params, delta)
            torch._foreach_add_([st["step"] for st in states], 1.0)
