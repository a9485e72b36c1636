"""Rectified Adam exactly as hashnerf_tpu/train/radam.py writes it.

This is not torch.optim.RAdam. The semantics carried over:
  * variance-rectification gate N_sma >= 5; with degenerated_to_sgd=False
    (the training default) the first steps apply NO update at all while the
    moments warm up (steps 1-5 at beta2 = 0.99);
  * decoupled weight decay added to the step, p -= lr * (delta + wd * p),
    only on steps that update;
  * the learning rate is the schedule at the step count BEFORE this step;
  * 1 - beta^t through expm1.
The schedule is a constructor argument, not part of the param groups, so
`state_dict()` holds only tensors and numbers.
"""
from __future__ import annotations

import math
from typing import Callable, Union

import torch


class RAdam(torch.optim.Optimizer):
    def __init__(
        self,
        params,
        lr: Union[float, Callable[[int], float]],
        betas=(0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        degenerated_to_sgd: bool = False,
    ):
        defaults = dict(betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                        degenerated_to_sgd=degenerated_to_sgd)
        super().__init__(params, defaults)
        self.lr_fn = lr if callable(lr) else (lambda step, _lr=lr: _lr)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("RAdam.step takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            eps, wd = group["eps"], group["weight_decay"]
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                m, v = st["exp_avg"], st["exp_avg_sq"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)

                lr = float(self.lr_fn(st["step"]))  # pre-increment step
                st["step"] += 1
                t = st["step"]
                one_minus_beta2_t = -math.expm1(t * math.log(b2))
                beta2_t = 1.0 - one_minus_beta2_t
                n_sma_max = 2.0 / (1.0 - b2) - 1.0
                n_sma = n_sma_max - 2.0 * t * beta2_t / one_minus_beta2_t
                bias1 = -math.expm1(t * math.log(b1))
                if n_sma >= 5.0:
                    rect = math.sqrt(
                        one_minus_beta2_t * (n_sma - 4.0) / (n_sma_max - 4.0)
                        * (n_sma - 2.0) / n_sma * n_sma_max / (n_sma_max - 2.0)
                    )
                    delta = (rect / bias1) * m / (v.sqrt() + eps)
                elif group["degenerated_to_sgd"]:
                    delta = (1.0 / bias1) * m
                else:
                    continue  # no update while the variance warms up
                p.add_((delta + wd * p) * (-lr))
