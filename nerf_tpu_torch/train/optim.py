"""Optimizer and LR schedules; counterpart of ``nerf_tpu/train/optim.py``.

The update is optax's chain, written out: value-clip at 40, then Adam
(b1 0.9, b2 0.999, eps 1e-8 outside the square root), RAdam or nothing
(SGD), then optional decoupled weight decay, then ``-lr(count)``, where
``count`` is the schedule's own step counter. The arithmetic follows optax's
order in float32 (moments ``(1 - b) * g + b * m``; bias corrections
``1 - b ** count``), so one step agrees with optax to float32 rounding.

A bfloat16 leaf (the hash grid's table) is updated as optax updates it:
its moments are bfloat16 like the leaf, every constant (1 - b, b, the bias
corrections, eps, -lr) is first rounded to bfloat16, as JAX rounds a
Python scalar to the array's dtype, and every operation rounds its result
to bfloat16; optax's ``scale_by_schedule`` casts the learning rate to the
update's dtype, and ``apply_updates`` adds in bfloat16.

The state is kept as the JAX package stores it, so checkpoints carry over:
Adam's count, ``mu``, ``nu`` (one tensor per parameter leaf, in the leaf's
dtype) and the schedule's count.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

Schedule = Callable[[int], np.float32]
CLIP = 40.0


def exponential_epoch_schedule(base_lr: float, gamma: float, decay_epochs: int, ep_iter: int,
                               lr_min: float = 0.0) -> Schedule:
    """lr = base * gamma^(epoch / decay_epochs), epoch = step // ep_iter,
    floored at ``lr_min``; float32 as in the JAX package."""
    def schedule(step: int) -> np.float32:
        epoch = np.float32(step // ep_iter)
        lr = np.float32(base_lr) * np.power(np.float32(gamma), epoch / np.float32(decay_epochs))
        return np.maximum(np.float32(lr), np.float32(lr_min))

    return schedule


def warmup_multi_step_schedule(base_lr: float, milestone_steps: Sequence[int], gamma: float,
                               warmup_factor: float = 1.0 / 3.0, warmup_iters: int = 500,
                               warmup_method: str = "linear") -> Schedule:
    """lr = base * warmup(step) * gamma^(milestones passed); the warmup ramps
    from ``warmup_factor`` to 1 over ``warmup_iters`` ("linear") or stays at
    ``warmup_factor`` ("constant")."""
    ms = sorted(int(m) for m in milestone_steps)

    def schedule(step: int) -> np.float32:
        if warmup_method == "linear":
            alpha = np.clip(np.float32(step) / np.float32(max(warmup_iters, 1)), 0.0, 1.0)
            wf = np.float32(warmup_factor) + np.float32(1.0 - warmup_factor) * np.float32(alpha)
        else:
            wf = np.float32(warmup_factor)
        warm = wf if step < warmup_iters else np.float32(1.0)
        decay = np.power(np.float32(gamma), np.float32(sum(step >= m for m in ms)))
        return np.float32(np.float32(base_lr) * warm * decay)

    return schedule


def multi_step_schedule(base_lr: float, milestone_steps: Sequence[int], gamma: float) -> Schedule:
    """optax's piecewise constant schedule: times gamma from each milestone on."""
    ms = sorted(int(m) for m in milestone_steps)

    def schedule(step: int) -> np.float32:
        v = np.float32(base_lr)
        for m in ms:
            if step >= m:
                v = np.float32(np.float32(gamma) * v)
        return v

    return schedule


def _ipow(base: float, n: int) -> np.float32:
    """base ** n in float32 by square-and-multiply, as optax's ``b ** count``
    (an integer power in XLA) rounds it; torch.pow rounds once, and
    RAdam's 1 - b2 ** count (~0.006 in its first steps) magnifies the
    difference of an ulp to 1e-5 of the update."""
    r, b = np.float32(1.0), np.float32(base)
    while n:
        if n & 1:
            r = np.float32(r * b)
        b = np.float32(b * b)
        n >>= 1
    return r


def _rounded(v: float, dtype: torch.dtype) -> float:
    """v rounded to ``dtype`` (a Python float that ``dtype`` holds exactly)."""
    return float(torch.tensor(v, dtype=torch.float64).to(dtype))


@dataclasses.dataclass
class OptState:
    count: int  # the moments' update count (Adam, RAdam)
    mu: Optional[List[torch.Tensor]]
    nu: Optional[List[torch.Tensor]]
    # the schedule's step counter; None for a constant learning rate, which
    # optax keeps no counter for (``plain_adam``)
    sched_count: Optional[int]

    def leaves(self) -> list:
        """In JAX's flatten order of optax's chain state."""
        head = [] if self.mu is None else [self.count, *self.mu, *self.nu]
        return head + ([] if self.sched_count is None else [self.sched_count])


class Optimizer:
    """clip -> adam | radam | sgd -> + weight_decay * p -> * -lr(count).
    ``bare``: optax's bare transform (``optax.adam(lr)``, ``plain_adam``):
    no clip, and a constant learning rate with no schedule counter in the
    state."""

    def __init__(self, schedule: Schedule, kind: str = "adam", weight_decay: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 bare: bool = False):
        if kind not in ("adam", "radam", "sgd"):
            raise ValueError(f"unknown optimizer {kind}")
        self.schedule, self.kind, self.weight_decay = schedule, kind, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.bare = bare

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        sched = None if self.bare else 0
        if self.kind == "sgd":
            return OptState(0, None, None, sched)
        zeros = lambda: [torch.zeros_like(p, memory_format=torch.contiguous_format)  # noqa: E731
                         for p in params]
        return OptState(0, zeros(), zeros(), sched)

    def lr(self, state: OptState) -> float:
        return float(self.schedule(state.sched_count or 0))

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             state: OptState) -> None:
        """Update ``params`` and ``state`` in place with one optax step."""
        f32 = np.float32
        if self.kind != "sgd":
            count = state.count + 1
            b2t = _ipow(self.b2, count)
            bc1, bc2 = float(f32(1.0) - _ipow(self.b1, count)), float(f32(1.0) - b2t)
            if self.kind == "radam":
                ro_inf = 2.0 / (1.0 - self.b2) - 1.0
                ro = f32(ro_inf) - f32(2 * count) * b2t / (f32(1.0) - b2t)
                r = np.sqrt((ro - f32(4.0)) * (ro - f32(2.0)) * f32(ro_inf)
                            / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
            state.count = count
        neg_lr = -self.schedule(state.sched_count or 0)
        for i, (p, g) in enumerate(zip(params, grads)):
            def c(v):  # a constant as an operand of p's dtype
                return v if p.dtype == torch.float32 else _rounded(v, p.dtype)

            if not self.bare:
                g = g.clamp(-CLIP, CLIP)
            if self.kind == "sgd":
                u = g
            else:
                mu = c(1.0 - self.b1) * g + c(self.b1) * state.mu[i]
                nu = c(1.0 - self.b2) * (g * g) + c(self.b2) * state.nu[i]
                state.mu[i], state.nu[i] = mu, nu
                mu_hat, nu_hat = mu / c(bc1), nu / c(bc2)
                if self.kind == "adam" or ro >= 5.0:
                    u = mu_hat / (torch.sqrt(nu_hat) + c(self.eps))
                    if self.kind == "radam":
                        u = c(float(r)) * u
                else:
                    u = mu_hat
            if self.weight_decay > 0:
                u = u + c(self.weight_decay) * p
            p.add_(u * c(float(neg_lr)))
        if state.sched_count is not None:
            state.sched_count += 1


def plain_adam(lr: float) -> Optimizer:
    """``optax.adam(lr)``: Adam at a constant rate, no clip, no decay; its
    state is (count, mu, nu), as KiloNeRF's distillation saves it."""
    return Optimizer(lambda step: np.float32(lr), kind="adam", bare=True)


def make_optimizer(cfg) -> Optimizer:
    tr = cfg.train
    sc = tr.scheduler
    ep_iter = int(cfg.get("ep_iter", 500))
    kind = sc.get("type", "exponential")
    if kind == "exponential":
        sched = exponential_epoch_schedule(float(tr.lr), float(sc.gamma), int(sc.decay_epochs),
                                           ep_iter, lr_min=float(sc.get("lr_min", 0.0)))
    elif kind == "warmup_multi_step":
        sched = warmup_multi_step_schedule(
            float(tr.lr), [int(m) * ep_iter for m in sc.milestones], float(sc.gamma),
            warmup_factor=float(sc.get("warmup_factor", 1.0 / 3.0)),
            warmup_iters=int(sc.get("warmup_iters", 500)),
            warmup_method=str(sc.get("warmup_method", "linear")))
    else:
        sched = multi_step_schedule(float(tr.lr), [int(m) * ep_iter for m in sc.milestones],
                                    float(sc.gamma))
    return Optimizer(sched, kind=str(tr.get("optim", "adam")),
                     weight_decay=float(tr.get("weight_decay", 0.0)))
