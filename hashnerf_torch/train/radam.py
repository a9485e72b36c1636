"""Rectified Adam exactly as hashnerf_tpu/train/radam.py writes it.

This is not torch.optim.RAdam. The semantics carried over:
  * variance-rectification gate N_sma >= 5; with degenerated_to_sgd=False
    (the training default) the first steps apply NO update at all while the
    moments warm up (steps 1-5 at beta2 = 0.99);
  * decoupled weight decay added to the step, p -= lr * (delta + wd * p),
    only on steps that update;
  * the learning rate is the schedule at the step count BEFORE this step;
  * 1 - beta^t through expm1.

Every step-dependent number (the step count, the learning rate, the
rectification term, the gate) is a float32 tensor on the parameters'
device, computed there as the JAX version computes it, so a step never
reads the device from the host and a captured CUDA graph replays it with
the step count of each replay. The per-parameter arithmetic is multi-tensor
(`torch._foreach_*`). The schedule is a constructor argument, not part of
the param groups, so `state_dict()` holds only tensors and numbers; a
checkpoint whose step counts are ints still loads.
"""
from __future__ import annotations

import math
from typing import Callable, Union

import torch


class DeviceStepOptimizer(torch.optim.Optimizer):
    """The state both optimizers keep on the parameters' device: per
    parameter a float32 step count and the two moments; the schedule
    lr(step) a callable or a number."""

    def __init__(self, params, lr: Union[float, Callable[[torch.Tensor], torch.Tensor]],
                 defaults: dict):
        super().__init__(params, defaults)
        self.lr_fn = lr if callable(lr) else (lambda step, _lr=lr: torch.full_like(step, _lr))

    def _state(self, p: torch.Tensor) -> dict:
        st = self.state[p]
        if not st:
            st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
            st["exp_avg"] = torch.zeros_like(p)
            st["exp_avg_sq"] = torch.zeros_like(p)
        return st

    def init_state(self) -> None:
        """Create every parameter's state now (as the first step would)."""
        for group in self.param_groups:
            for p in group["params"]:
                self._state(p)

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        for p, st in self.state.items():
            st["step"] = torch.as_tensor(st["step"], dtype=torch.float32).to(p.device)

    def _group_tensors(self, group: dict, closure):
        """(params, states, grads) of a group; a missing grad is zeros."""
        if closure is not None:
            raise ValueError(f"{type(self).__name__}.step takes no closure")
        params = group["params"]
        states = [self._state(p) for p in params]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        return params, states, grads


class RAdam(DeviceStepOptimizer):
    def __init__(
        self,
        params,
        lr: Union[float, Callable[[torch.Tensor], torch.Tensor]],
        betas=(0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        degenerated_to_sgd: bool = False,
    ):
        super().__init__(params, lr, dict(betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                                          degenerated_to_sgd=degenerated_to_sgd))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            if not group["params"]:
                continue
            params, states, grads = self._group_tensors(group, closure)
            b1, b2 = group["betas"]
            eps, wd = group["eps"], group["weight_decay"]
            m = [st["exp_avg"] for st in states]
            v = [st["exp_avg_sq"] for st in states]
            # b1 * m + (1 - b1) * g and b2 * v + (1 - b2) * g * g, JAX's order
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, torch._foreach_mul(grads, 1 - b1))
            g2 = torch._foreach_mul(grads, 1 - b2)
            torch._foreach_mul_(g2, grads)
            torch._foreach_mul_(v, b2)
            torch._foreach_add_(v, g2)

            # A group's parameters step together: one count holds for all.
            step = states[0]["step"]
            lr = self.lr_fn(step)  # pre-increment step
            t = step + 1.0
            one_minus_beta2_t = -torch.expm1(t * math.log(b2))
            beta2_t = 1.0 - one_minus_beta2_t
            n_sma_max = 2.0 / (1.0 - b2) - 1.0
            n_sma = n_sma_max - 2.0 * t * beta2_t / one_minus_beta2_t
            rect = torch.sqrt(
                one_minus_beta2_t * (n_sma - 4.0) / (n_sma_max - 4.0)
                * (n_sma - 2.0) / n_sma * n_sma_max / (n_sma_max - 2.0)
            )
            bias1 = -torch.expm1(t * math.log(b1))
            use_adaptive = n_sma >= 5.0
            zero = torch.zeros_like(t)
            # rect is NaN while N_sma < 4; where() takes 0 there
            adaptive_step = torch.where(use_adaptive, rect / bias1, zero)
            denom = torch._foreach_sqrt(v)
            torch._foreach_add_(denom, eps)
            delta = torch._foreach_mul(m, adaptive_step)
            torch._foreach_div_(delta, denom)
            if group["degenerated_to_sgd"]:
                sgd_step = 1.0 / bias1
                delta = [torch.where(use_adaptive, d, sgd_step * mi) for d, mi in zip(delta, m)]
                any_update = torch.ones_like(use_adaptive)
            else:
                any_update = use_adaptive
            if wd != 0.0:
                wd_step = torch.where(any_update, torch.full_like(t, wd), zero)
                torch._foreach_add_(delta, torch._foreach_mul(params, wd_step))
            torch._foreach_mul_(delta, -lr)
            torch._foreach_add_(params, delta)
            torch._foreach_add_([st["step"] for st in states], 1.0)
