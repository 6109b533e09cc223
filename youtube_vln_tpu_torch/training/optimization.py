"""Optimizer and LR schedules of the port (counterpart of
``youtube_vln_tpu/training/optimization.py``; reference
``vilbert/optimization.py`` and ``vilbert/vilbert_init.py``).

* ``AdamWRef``: BERT-style AdamW with the reference's update order -- the
  Adam step first, then weight decay of the ALREADY UPDATED parameter
  (``p.add_(-lr * wd, p)`` after ``p.addcdiv_``), eps 1e-6, bias
  correction; the learning rate is the schedule at the count of completed
  steps (torch LambdaLR semantics).  The step scalars are computed in f32,
  as the JAX package computes them.
* Schedules: the five reference families, multipliers of the base rate,
  and ``make_schedule`` (optimizer steps, warmup proportion, cooldown
  stretch of the total).
* No decay for parameter names holding ``bias``, ``LayerNorm.weight`` or
  ``LayerNorm.bias`` (``vilbert_init.py:8-18``).  On the port's reference
  key names this is exactly the JAX package's ``no_decay_mask`` (``ln``
  nodes, linear ``b``, ``decoder_bias``): both decay the connection layers'
  ``biOutput.LayerNorm1.weight`` / ``LayerNorm2.weight`` (JAX ``ln1`` /
  ``ln2``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List

import numpy as np
import torch

NO_DECAY = ("bias", "LayerNorm.weight", "LayerNorm.bias")


# --------------------------------------------------------------------------- #
# schedules (step -> learning rate)
# --------------------------------------------------------------------------- #
def constant_schedule(base_lr: float) -> Callable[[int], float]:
    return lambda step: base_lr


def warmup_linear_schedule(base_lr: float, warmup_steps: float,
                           t_total: float) -> Callable[[int], float]:
    """Reference WarmupLinearSchedule (optimization.py:48-61); ``step``
    counts completed optimizer steps."""

    def fn(step):
        if step < warmup_steps:
            return base_lr * step / max(1.0, warmup_steps)
        return base_lr * max(0.0, (t_total - step)
                             / max(1.0, t_total - warmup_steps))
    return fn


def warmup_constant_schedule(base_lr: float,
                             warmup_steps: float) -> Callable[[int], float]:
    """Reference WarmupConstantSchedule (optimization.py:33-46)."""

    def fn(step):
        if step < warmup_steps:
            return base_lr * step / max(1.0, warmup_steps)
        return base_lr
    return fn


def warmup_cosine_schedule(base_lr: float, warmup_steps: float,
                           t_total: float,
                           cycles: float = 0.5) -> Callable[[int], float]:
    """Reference WarmupCosineSchedule (optimization.py:64-83)."""

    def fn(step):
        if step < warmup_steps:
            return base_lr * step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1.0, t_total - warmup_steps)
        return base_lr * max(0.0, 0.5 * (1.0 + math.cos(
            math.pi * cycles * 2.0 * progress)))
    return fn


def warmup_cosine_hard_restarts_schedule(
        base_lr: float, warmup_steps: float, t_total: float,
        cycles: float = 1.0) -> Callable[[int], float]:
    """Reference WarmupCosineWithHardRestartsSchedule (optimization.py:
    86-103): 0 once progress reaches 1."""

    def fn(step):
        if step < warmup_steps:
            return base_lr * step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1.0, t_total - warmup_steps)
        if progress >= 1.0:
            return 0.0
        phase = math.fmod(cycles * progress, 1.0)
        return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * phase)))
    return fn


SCHEDULES = {
    "constant": lambda lr, warmup, total: constant_schedule(lr),
    "warmup_constant": lambda lr, warmup, total:
        warmup_constant_schedule(lr, warmup),
    "warmup_linear": warmup_linear_schedule,
    "warmup_cosine": warmup_cosine_schedule,
    "warmup_cosine_hard_restarts": warmup_cosine_hard_restarts_schedule,
}


def make_schedule(args, steps_per_epoch: int) -> Callable[[int], float]:
    """Reference get_optimization schedule selection (vilbert_init.py:
    23-40).  ``steps_per_epoch`` counts OPTIMIZER steps (one accumulated
    batch per step), as the JAX package's engine counts them."""
    if args.no_scheduler or args.ConstantLR:
        return constant_schedule(args.learning_rate)
    t_total = steps_per_epoch * args.num_epochs
    warmup_steps = args.warmup_proportion * t_total
    adjusted = warmup_steps + args.cooldown_factor * (t_total - warmup_steps)
    return SCHEDULES[args.lr_schedule](args.learning_rate, warmup_steps,
                                       adjusted)


# --------------------------------------------------------------------------- #
# AdamW (reference update order)
# --------------------------------------------------------------------------- #
def is_no_decay(name: str) -> bool:
    return any(nd in name for nd in NO_DECAY)


def param_groups(model: torch.nn.Module,
                 weight_decay: float) -> List[Dict]:
    """The reference's two groups: decayed weights, and bias / LayerNorm
    without decay.  ``named_parameters`` lists a tied parameter (the MLM
    decoder and the word embedding) once."""
    decay, no_decay = [], []
    for name, p in model.named_parameters():
        if p.requires_grad:
            (no_decay if is_no_decay(name) else decay).append(p)
    return [{"params": decay, "weight_decay": weight_decay},
            {"params": no_decay, "weight_decay": 0.0}]


class AdamWRef(torch.optim.Optimizer):
    """Per parameter (reference optimization.py:130-188):

        m <- b1 m + (1 - b1) g ;  v <- b2 v + (1 - b2) g^2
        step = lr sqrt(1 - b2^t) / (1 - b1^t)
        p <- p - step m / (sqrt(v) + eps)
        p <- p - lr wd p                              (post-update decay)

    with b1 0.9, b2 0.999, eps 1e-6 and lr = schedule(t - 1) at the t-th
    step.  A parameter without a gradient (an unused head, a frozen
    prefix) takes a zero gradient, as every leaf of the JAX package's tree
    update does: its moments decay and the weight decay still applies.
    Updates run in place with the ``torch._foreach_*`` kernels, one set per
    parameter group.  ``state_dict`` carries ``step_count``, the schedule's
    position, beside the moments ``exp_avg`` / ``exp_avg_sq``, so that a
    resumed run continues the schedule."""

    B1, B2, EPS = 0.9, 0.999, 1e-6

    def __init__(self, params: Iterable, schedule: Callable[[int], float],
                 weight_decay: float = 0.0):
        super().__init__(params, dict(weight_decay=weight_decay))
        self.schedule = schedule
        self.step_count = 0

    def _scalars(self):
        f32 = np.float32
        lr = f32(self.schedule(self.step_count))
        self.step_count += 1
        t = f32(self.step_count)
        step_size = (lr * np.sqrt(f32(1.0) - f32(self.B2) ** t)
                     / (f32(1.0) - f32(self.B1) ** t))
        return float(lr), float(step_size)

    def state_dict(self):
        out = super().state_dict()
        out["step_count"] = self.step_count
        return out

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        step_count = int(state_dict.pop("step_count"))
        super().load_state_dict(state_dict)
        self.step_count = step_count

    @torch.no_grad()
    def step(self, closure=None):
        assert closure is None, "AdamWRef takes no closure"
        lr, step_size = self._scalars()
        b1, b2 = self.B1, self.B2
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
            for p in params:
                if not self.state[p]:
                    self.state[p]["exp_avg"] = torch.zeros_like(p)
                    self.state[p]["exp_avg_sq"] = torch.zeros_like(p)
            m = [self.state[p]["exp_avg"] for p in params]
            v = [self.state[p]["exp_avg_sq"] for p in params]
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, grads, alpha=1.0 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
            denom = torch._foreach_sqrt(v)
            torch._foreach_add_(denom, self.EPS)
            torch._foreach_addcdiv_(params, m, denom, value=-step_size)
            wd = group["weight_decay"]
            if wd > 0.0:
                torch._foreach_add_(params, params, alpha=-lr * wd)
        return None
