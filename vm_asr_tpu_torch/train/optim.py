"""Optimizer and LR schedule (port of vm_asr_tpu/train/optim.py, which builds
them with optax; reference utils/optimizer.py:5-81, utils/lr_scheduler.py).

Schedules are plain functions of the update count, written as optax
computes them (``linear_schedule``, ``cosine_decay_schedule``,
``join_schedules``, ``piecewise_constant_schedule``, ``exponential_decay``).
Like optax, an update uses the schedule's value at the count *before* it, so
update 0 of a warm-up runs at MIN_LR.

AdamW and SGD are torch's: ``torch.optim.AdamW`` computes what
``optax.adamw`` computes (eps outside the square root, decay decoupled and
scaled by the learning rate), and ``torch.optim.SGD(nesterov=True)`` what
``optax.chain(add_decayed_weights, sgd(nesterov=True))`` does. The no-decay
mask becomes a parameter group with weight decay 0. ``ACCUMULATION_STEPS``
> 1 averages gradients as ``optax.MultiSteps`` does (a running mean) and
updates every k-th call; the schedule then counts updates, not calls.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    return lambda n: (init - end) * (1 - min(max(n, 0), steps) / steps) + end


def _cosine(init: float, steps: int, alpha: float) -> Schedule:
    def f(n):
        cos = 0.5 * (1 + math.cos(math.pi * min(n, steps) / steps))
        return init * ((1 - alpha) * cos + alpha)
    return f


def _join(schedules: List[Schedule], boundaries: List[int]) -> Schedule:
    def f(n):
        out = schedules[0](n)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if n >= boundary:
                out = sched(n - boundary)
        return out
    return f


def _piecewise(init: float, boundaries_and_scales: Dict[int, float]) -> Schedule:
    def f(n):
        v = init
        for threshold, scale in sorted(boundaries_and_scales.items()):
            if n >= threshold:
                v *= scale
        return v
    return f


def _staircase_decay(init: float, steps: int, rate: float) -> Schedule:
    if steps <= 0 or rate == 0:
        return lambda n: init
    return lambda n: init if n <= 0 else init * rate ** math.floor(n / steps)


def make_schedule(config, steps_per_epoch: int) -> Schedule:
    """The learning rate at each update count, from TRAIN.LR_SCHEDULER."""
    t = config.TRAIN
    total = t.EPOCHS * steps_per_epoch
    warmup = t.WARMUP_EPOCHS * steps_per_epoch
    name = t.LR_SCHEDULER.NAME
    if name == "cosine":
        # warm-up MIN_LR → BASE_LR, then cosine BASE_LR → MIN_LR (timm
        # warmup_prefix=True semantics)
        return _join([_linear(t.MIN_LR, t.BASE_LR, max(warmup, 1)),
                      _cosine(t.BASE_LR, max(total - warmup, 1), t.MIN_LR / t.BASE_LR)],
                     [warmup])
    if name == "linear":
        return _join([_linear(t.MIN_LR, t.BASE_LR, max(warmup, 1)),
                      _linear(t.BASE_LR, t.MIN_LR, max(total - warmup, 1))], [warmup])
    if name == "multistep":
        base = _piecewise(t.BASE_LR, {int(e) * steps_per_epoch: t.LR_SCHEDULER.GAMMA
                                      for e in t.LR_SCHEDULER.MULTISTEPS})
        if warmup:
            return _join([_linear(t.MIN_LR, t.BASE_LR, warmup), base], [warmup])
        return base
    if name == "step":
        return _staircase_decay(t.BASE_LR, t.LR_SCHEDULER.DECAY_EPOCHS * steps_per_epoch,
                                t.LR_SCHEDULER.DECAY_RATE)
    raise ValueError(f"Unknown scheduler: {name}")


def decays(name: str, param: torch.Tensor) -> bool:
    """Whether weight decay applies: not to biases, 1-D parameters, or the
    SSM's A_logs, Ds and dt_projs_bias (the JAX package's no_decay_mask)."""
    parts = name.split(".")
    if any(p in ("A_logs", "Ds", "dt_projs_bias") for p in parts) or parts[-1] == "bias":
        return False
    return param.dim() > 1


class Optimizer:
    """A torch optimizer driven by an optax-style schedule, with optax
    MultiSteps gradient accumulation.

    ``apply(grads)`` takes one gradient per parameter, in ``params`` order;
    ``count`` is the number of updates made (optax's inner count)."""

    def __init__(self, params: List[Tuple[str, torch.nn.Parameter]], tx: torch.optim.Optimizer,
                 schedule: Schedule, every_k: int = 1):
        self.params = [p for _, p in params]
        self.tx = tx
        self.schedule = schedule
        self.every_k = max(int(every_k), 1)
        self.count = 0
        self.mini_step = 0
        self.acc: Optional[List[torch.Tensor]] = None

    def apply(self, grads: Iterable[torch.Tensor]) -> bool:
        """Accumulate ``grads``; update the parameters on every k-th call.
        Returns whether they were updated."""
        grads = list(grads)
        if self.every_k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.params]
            n = self.mini_step
            for a, g in zip(self.acc, grads):  # Welford mean, as optax.MultiSteps
                a.add_((g - a) / (n + 1))
            if n < self.every_k - 1:
                self.mini_step += 1
                return False
            grads, self.acc, self.mini_step = self.acc, None, 0
        lr = self.schedule(self.count)
        for group in self.tx.param_groups:
            group["lr"] = lr
        for p, g in zip(self.params, grads):
            p.grad = g
        self.tx.step()
        self.tx.zero_grad(set_to_none=True)
        self.count += 1
        return True


def make_optimizer(config, steps_per_epoch: int, module: torch.nn.Module) -> Optimizer:
    """AdamW (default) or SGD over ``module``'s parameters, with the no-decay
    group and gradient accumulation from TRAIN.*."""
    t = config.TRAIN
    # Accumulation counts the schedule in effective (accumulated) updates.
    effective_steps = max(1, steps_per_epoch // max(t.ACCUMULATION_STEPS, 1))
    sched = make_schedule(config, effective_steps)
    named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
    wd = t.WEIGHT_DECAY
    groups = [{"params": [p for n, p in named if wd > 0 and decays(n, p)], "weight_decay": wd},
              {"params": [p for n, p in named if not (wd > 0 and decays(n, p))],
               "weight_decay": 0.0}]
    groups = [g for g in groups if g["params"]]
    name = t.OPTIMIZER.NAME.lower()
    lr0 = sched(0)
    if name == "adamw":
        tx = torch.optim.AdamW(groups, lr=lr0, betas=tuple(t.OPTIMIZER.BETAS),
                               eps=t.OPTIMIZER.EPS)
    elif name == "sgd":
        tx = torch.optim.SGD(groups, lr=lr0, momentum=t.OPTIMIZER.MOMENTUM, nesterov=True)
    else:
        raise ValueError(f"Unknown optimizer: {name}")
    return Optimizer(named, tx, sched, t.ACCUMULATION_STEPS)
