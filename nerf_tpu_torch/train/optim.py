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

Instant-NGP's optimizer (arXiv:2201.05989 section 4) adds two per-leaf
rules (``l2_reg``, ``skip_zero_grads``; the leaves by their tree paths,
``bind``): an L2 term ``l2_reg * p`` added to the clipped gradient of each
MLP weight ("w" outside the hash encoder) before the moments, and no step at
all (p, mu and nu left as they are) for an element of the hash table whose
gradient is exactly 0. β1, β2 and ε come from the config's ``train`` keys
``beta1``, ``beta2`` and ``eps`` (0.9, 0.999 and 1e-8 by default).

The state is kept as the JAX package stores it, so checkpoints carry over:
Adam's count, ``mu``, ``nu`` (one tensor per parameter leaf, in the leaf's
dtype) and the schedule's count.

``Optimizer.step`` updates CUDA leaves through ``csrc/adam.cu``
(``ops/adam.py``): one launch a dtype, with the params and the moments
updated in place, the same roundings in the same order as the loop. The
loop, ``Optimizer.step_plain`` (15 eager ops a leaf), is the plain version:
the CPU's path, and what the tests hold the kernel to, bit for bit. Both
take their constants from ``scalars`` and ``operands``. While the program's
counters are on (``utils/profiling``), ``step`` counts the leaves it is
given (``optim.leaves``) and those the kernel updated
(``optim.fused_leaves``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import adam
from ..utils import profiling

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


class StepScalars(NamedTuple):
    """One step's scalars, before their rounding to a leaf's dtype."""
    count: int  # the moments' update count after the step
    bc1: float  # 1 - b1 ** count
    bc2: float  # 1 - b2 ** count
    r: float  # RAdam's rectification (1 otherwise)
    rect: bool  # Adam, or RAdam with ro >= 5: mu_hat / (sqrt(nu_hat) + eps)
    neg_lr: float


class Operands(NamedTuple):
    """The constants the loop's ops take for leaves of one dtype: Python
    floats that PyTorch rounds to float32 for a float32 leaf; for another
    dtype, values that dtype holds exactly."""
    omb1: float  # 1 - b1
    b1: float
    omb2: float  # 1 - b2
    b2: float
    bc1: float
    bc2: float
    eps: float
    r: float
    wd: float
    neg_lr: float


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
                 bare: bool = False, l2_reg: float = 0.0, skip_zero_grads: bool = False):
        if kind not in adam.KINDS:
            raise ValueError(f"unknown optimizer {kind}")
        self.schedule, self.kind, self.weight_decay = schedule, kind, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.bare = bare
        self.l2_reg, self.skip_zero_grads = l2_reg, skip_zero_grads
        # each leaf's adam.Rule (``bind``); None: no leaf has a rule
        self.rules: Optional[Tuple[adam.Rule, ...]] = None
        self._table = adam.Table()  # the kernel's launch tables, kept across steps

    def bind(self, tree) -> None:
        """Set each leaf's rule from its path in the parameter tree (the
        order of ``tree_leaves``): the L2 term on "w" leaves outside
        ``xyz_encoder``, the zero-gradient skip on the leaves inside it."""
        if self.l2_reg == 0.0 and not self.skip_zero_grads:
            self.rules = None
            return
        rules = []
        for path, leaf in _leaf_paths(tree):
            table = "xyz_encoder" in path
            l2 = self.l2_reg if path[-1] == "w" and not table else 0.0
            if leaf.dtype != torch.float32:
                l2 = _rounded(l2, leaf.dtype)
            rules.append(adam.Rule(l2, self.skip_zero_grads and table))
        self.rules = tuple(rules)

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        sched = None if self.bare else 0
        if self.kind == "sgd":
            return OptState(0, None, None, sched)
        zeros = lambda: [torch.zeros_like(p, memory_format=torch.contiguous_format)  # noqa: E731
                         for p in params]
        return OptState(0, zeros(), zeros(), sched)

    def lr(self, state: OptState) -> float:
        return float(self.schedule(state.sched_count or 0))

    def scalars(self, state: OptState) -> StepScalars:
        """The scalars of the step that ``state`` is about to take."""
        f32 = np.float32
        neg_lr = float(-self.schedule(state.sched_count or 0))
        if self.kind == "sgd":
            return StepScalars(state.count, 1.0, 1.0, 1.0, True, neg_lr)
        count = state.count + 1
        b2t = _ipow(self.b2, count)
        bc1, bc2 = float(f32(1.0) - _ipow(self.b1, count)), float(f32(1.0) - b2t)
        r, rect = 1.0, True
        if self.kind == "radam":
            ro_inf = 2.0 / (1.0 - self.b2) - 1.0
            ro = f32(ro_inf) - f32(2 * count) * b2t / (f32(1.0) - b2t)
            r = float(np.sqrt((ro - f32(4.0)) * (ro - f32(2.0)) * f32(ro_inf)
                              / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)))
            rect = bool(ro >= 5.0)
        return StepScalars(count, bc1, bc2, r, rect, neg_lr)

    def operands(self, s: StepScalars, dtype: torch.dtype) -> Operands:
        """The constants the loop's ops take for leaves of ``dtype``."""
        def c(v):  # a constant as an operand of the leaf's dtype
            return v if dtype == torch.float32 else _rounded(v, dtype)

        return Operands(c(1.0 - self.b1), c(self.b1), c(1.0 - self.b2), c(self.b2), c(s.bc1),
                        c(s.bc2), c(self.eps), c(s.r), c(self.weight_decay), c(s.neg_lr))

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             state: OptState) -> None:
        """Update ``params`` and ``state`` in place with one optax step: CUDA
        leaves through ``ops/adam.py`` (one launch a dtype, the moments
        updated in place), CPU leaves through ``step_plain``."""
        profiling.count("optim.leaves", len(params))
        if not params or params[0].device.type != "cuda":
            self.step_plain(params, grads, state)
            return
        s = self.scalars(state)
        decay = self.weight_decay > 0

        def scalars_for(dtype):
            return adam.scalars(self.operands(s, dtype), self.kind, self.bare, s.rect, decay)

        adam.adam(self._table, params, grads, state.mu, state.nu, scalars_for,
                  self._rules(len(params)))
        profiling.count("optim.fused_leaves", len(params))
        self._advance(state, s)

    @torch.no_grad()
    def step_plain(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                   state: OptState) -> None:
        """``step`` as eager PyTorch ops, leaf by leaf, on any device (new
        moment tensors each step): the CPU's path, and the plain version that
        the kernel equals bit for bit on the card."""
        s = self.scalars(state)
        ops = {}
        rules = self._rules(len(params)) or [adam.Rule()] * len(params)
        for i, (p, g) in enumerate(zip(params, grads)):
            if p.dtype not in ops:
                ops[p.dtype] = self.operands(s, p.dtype)
            o, rule = ops[p.dtype], rules[i]
            keep = g != 0 if rule.skip else None  # the elements that take a step
            if not self.bare:
                g = g.clamp(-CLIP, CLIP)
            if rule.l2 != 0.0:
                g = g + rule.l2 * p
            if self.kind == "sgd":
                u = g
            else:
                mu = o.omb1 * g + o.b1 * state.mu[i]
                nu = o.omb2 * (g * g) + o.b2 * state.nu[i]
                if keep is not None:
                    mu = torch.where(keep, mu, state.mu[i])
                    nu = torch.where(keep, nu, state.nu[i])
                state.mu[i], state.nu[i] = mu, nu
                mu_hat, nu_hat = mu / o.bc1, nu / o.bc2
                if s.rect:
                    u = mu_hat / (torch.sqrt(nu_hat) + o.eps)
                    if self.kind == "radam":
                        u = o.r * u
                else:
                    u = mu_hat
            if self.weight_decay > 0:
                u = u + o.wd * p
            if keep is None:
                p.add_(u * o.neg_lr)
            else:
                p.copy_(torch.where(keep, p + u * o.neg_lr, p))
        self._advance(state, s)

    def _rules(self, n: int) -> Optional[Tuple[adam.Rule, ...]]:
        if self.rules is not None and len(self.rules) != n:
            raise ValueError(f"the optimizer's rules are bound to {len(self.rules)} leaves, "
                             f"given {n}")
        return self.rules

    def _advance(self, state: OptState, s: StepScalars) -> None:
        state.count = s.count
        if state.sched_count is not None:
            state.sched_count += 1


def _leaf_paths(tree, prefix: tuple = ()) -> list:
    """(path, leaf) in ``tree_leaves``' order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaf_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaf_paths(v, prefix + (i,))]
    return [(prefix, tree)]


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
                     weight_decay=float(tr.get("weight_decay", 0.0)),
                     b1=float(tr.get("beta1", 0.9)), b2=float(tr.get("beta2", 0.999)),
                     eps=float(tr.get("eps", 1e-8)), l2_reg=float(tr.get("l2_reg", 0.0)),
                     skip_zero_grads=bool(tr.get("skip_zero_grads", False)))
