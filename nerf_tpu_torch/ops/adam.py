"""Multi-tensor Adam: one launch of ``csrc/adam.cu`` a dtype for a step's CUDA leaves.

No counterpart in ``nerf_tpu``: the JAX package's update is optax's chain,
which XLA fuses by itself. ``train/optim.py``'s ``Optimizer.step`` calls
``adam`` for CUDA leaves; its ``step_plain`` (the plain version, 15 eager
ops a leaf) runs CPU leaves and is the yardstick the kernel is held to, bit
for bit, on the card.

- ``plan(numels, dtypes)``: the launches of a leaf list: the leaves grouped
  by dtype (float32 or bfloat16) in their order, at most ``MAX_LEAVES`` a
  launch, each with the prefix sum of its leaves' tiles of ``TILE``
  elements (leaves without elements take none).
- ``scalars(operands, ...)``: the kernel's scalars from the constants the
  loop's ops take (``Optimizer.operands``): each rounded to float32 as
  PyTorch rounds a Python scalar, and the bias corrections as the float
  reciprocals by which the card multiplies when the loop divides a tensor
  by a Python scalar.
- ``Table``: the ctypes argument blocks of one list of params and moments,
  built when their data pointers change (``init``, a checkpoint's load) and
  kept otherwise, so a step writes only the gradients' pointers and the
  step's scalars. It holds the tensors, so their memory cannot be reused
  under the same pointers while it is kept.
- ``adam(table, params, grads, mu, nu, scalars_for, rules)``: the
  launches; p, mu and nu are updated in place. ``adam.launches`` counts
  them. ``rules``: each leaf's ``Rule`` (an L2 factor on its gradient;
  whether an element whose gradient is exactly 0 takes no step), the
  defaults for every leaf when None.
- While the program's counters are on (``utils/profiling``), the launches
  add the elements that the skip left to a device counter
  (``skipped_count``; one atomic a block of a skip leaf) and ``adam``
  counts the elements of skip leaves it was given (``adam.elements``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import profiling
from . import build

MAX_LEAVES = 64  # csrc/adam.cu's MAX_LEAVES
TILE = 2048  # csrc/adam.cu's TILE: elements a block
KINDS = ("adam", "radam", "sgd")  # csrc/adam.cu's Kind
DTYPES = (torch.float32, torch.bfloat16)
_MAX_TILES = 2**31 - 1  # a launch's grid.x


class Rule(NamedTuple):
    """A leaf's own terms: the L2 factor added to its gradient times the
    param (as an operand of the leaf's dtype), and the zero-gradient skip."""
    l2: float = 0.0
    skip: bool = False


class Launch(NamedTuple):
    dtype: torch.dtype
    leaves: Tuple[int, ...]  # indices into the leaf list
    tile_start: Tuple[int, ...]  # len(leaves) + 1 prefix sums of the leaves' tiles


def plan(numels: Sequence[int], dtypes: Sequence[torch.dtype]) -> List[Launch]:
    """The launches that update leaves of ``numels`` elements and ``dtypes``."""
    groups = {}
    for i, (n, dt) in enumerate(zip(numels, dtypes)):
        if dt not in DTYPES:
            raise ValueError(f"adam: leaf {i} is {dt}; the kernel takes float32 or bfloat16")
        if n:
            groups.setdefault(dt, []).append(i)
    out = []
    for dt, idx in groups.items():
        for k in range(0, len(idx), MAX_LEAVES):
            part = idx[k:k + MAX_LEAVES]
            starts = [0]
            for i in part:
                starts.append(starts[-1] + -(-int(numels[i]) // TILE))
            if starts[-1] > _MAX_TILES:
                raise ValueError(f"adam: {starts[-1]} tiles in one launch")
            out.append(Launch(dt, tuple(part), tuple(starts)))
    return out


class _Scalars(ctypes.Structure):
    _fields_ = [(n, ctypes.c_float) for n in ("omb1", "b1", "omb2", "b2", "inv_bc1", "inv_bc2",
                                              "eps", "r", "wd", "neg_lr")] + \
               [(n, ctypes.c_int) for n in ("kind", "bare", "rect", "decay")]


class _Args(ctypes.Structure):
    _fields_ = [("s", _Scalars), ("n_leaves", ctypes.c_int),
                ("tile_start", ctypes.c_int * (MAX_LEAVES + 1)),
                ("numel", ctypes.c_longlong * MAX_LEAVES),
                ("p", ctypes.c_void_p * MAX_LEAVES), ("g", ctypes.c_void_p * MAX_LEAVES),
                ("m", ctypes.c_void_p * MAX_LEAVES), ("v", ctypes.c_void_p * MAX_LEAVES),
                ("l2", ctypes.c_float * MAX_LEAVES), ("skip", ctypes.c_int * MAX_LEAVES),
                ("skipped", ctypes.c_void_p)]


def layout() -> List[int]:
    """``_Args``' layout as ``csrc/adam.cu``'s ``adam_layout`` reports it."""
    return [ctypes.sizeof(_Args), _Args.n_leaves.offset, _Args.tile_start.offset,
            _Args.numel.offset, _Args.p.offset, _Args.g.offset, _Args.m.offset,
            _Args.v.offset, MAX_LEAVES, TILE, _Args.l2.offset, _Args.skip.offset,
            _Args.skipped.offset]


def scalars(ops, kind: str, bare: bool, rect: bool, decay: bool) -> _Scalars:
    """The kernel's scalars from ``ops`` (``Optimizer.operands``: omb1, b1,
    omb2, b2, bc1, bc2, eps, r, wd, neg_lr as the loop's ops take them)."""
    f = np.float32
    return _Scalars(f(ops.omb1), f(ops.b1), f(ops.omb2), f(ops.b2), f(1.0) / f(ops.bc1),
                    f(1.0) / f(ops.bc2), f(ops.eps), f(ops.r), f(ops.wd), f(ops.neg_lr),
                    KINDS.index(kind), int(bare), int(rect), int(decay))


class _Block(NamedTuple):
    dtype: torch.dtype
    leaves: Tuple[int, ...]
    numels: Tuple[int, ...]
    rules: bool  # some leaf has an L2 factor or the skip: the kernel's rules instantiation
    args: _Args
    g: ctypes.Array  # args.g, kept to write the gradients' pointers
    address: int


class Table:
    """The argument blocks of one list of params and moments."""

    def __init__(self):
        self.key: Optional[list] = None
        self.blocks: List[_Block] = []
        self.tensors: list = []

    def update(self, params, mu, nu, rules=None) -> None:
        """Rebuild the blocks unless every data pointer and rule is the one
        they hold."""
        tensors = [*params, *(mu or ()), *(nu or ())]
        key = [t.data_ptr() for t in tensors] + [rules]
        if key != self.key:
            self.blocks = _blocks(params, mu, nu, rules)
            self.key, self.tensors = key, tensors


def _check_leaf(what: str, t: torch.Tensor, like: torch.Tensor) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``like``'s dtype,
    shape and device."""
    build.check_cuda(f"adam: {what}", t, like.dtype, like.shape, align=like.element_size())
    if t.device != like.device:
        raise ValueError(f"adam: {what} is on {t.device}, its param on {like.device}")


def _blocks(params, mu, nu, rules=None) -> List[_Block]:
    if (mu is None) != (nu is None) or (mu is not None and not len(mu) == len(nu) == len(params)):
        raise ValueError("adam: mu and nu must both be given, one tensor a param, or neither")
    for i, p in enumerate(params):
        _check_leaf(f"param {i}", p, p)
        if p.device != params[0].device:
            raise ValueError(f"adam: param {i} is on {p.device}, param 0 on {params[0].device}")
        if mu is not None:
            _check_leaf(f"mu {i}", mu[i], p)
            _check_leaf(f"nu {i}", nu[i], p)
    if rules is not None and len(rules) != len(params):
        raise ValueError(f"adam: {len(rules)} rules for {len(params)} params")
    out = []
    for lc in plan([p.numel() for p in params], [p.dtype for p in params]):
        a = _Args()
        a.n_leaves = len(lc.leaves)
        a.tile_start[:len(lc.tile_start)] = lc.tile_start
        for j, i in enumerate(lc.leaves):
            rule = rules[i] if rules is not None else Rule()
            a.l2[j], a.skip[j] = np.float32(rule.l2), int(rule.skip)
            a.numel[j] = params[i].numel()
            a.p[j] = params[i].data_ptr()
            if mu is not None:
                a.m[j], a.v[j] = mu[i].data_ptr(), nu[i].data_ptr()
        has_rules = any(a.l2[j] != 0.0 or a.skip[j] for j in range(len(lc.leaves)))
        out.append(_Block(lc.dtype, lc.leaves, tuple(params[i].numel() for i in lc.leaves),
                          has_rules, a, a.g, ctypes.addressof(a)))
    return out


def adam(table: Table, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
         mu: Optional[Sequence[torch.Tensor]], nu: Optional[Sequence[torch.Tensor]],
         scalars_for: Callable[[torch.dtype], _Scalars],
         rules: Optional[Tuple[Rule, ...]] = None) -> None:
    """One step over CUDA ``params`` (contiguous float32 or bfloat16) in
    place, with their moments (None for SGD) and ``grads`` of the same
    dtypes and shapes: one launch a dtype (a ``MAX_LEAVES`` leaves);
    ``scalars_for(dtype)`` gives the step's scalars for a dtype's leaves;
    ``rules`` each leaf's ``Rule`` (L2 factors as operands of the leaf's
    dtype)."""
    if len(grads) != len(params):
        raise ValueError(f"adam: {len(grads)} gradients for {len(params)} params")
    if not params:
        return
    table.update(params, mu, nu, rules)
    index = params[0].get_device()
    lib = _lib()
    stream = torch.cuda.current_stream(params[0].device).cuda_stream
    counting = rules is not None and any(r.skip for r in rules) and profiling.enabled()
    if counting:
        profiling.count("adam.elements", sum(p.numel() for p, r in zip(params, rules) if r.skip))
    skipped = _skipped_buffer(params[0].device).data_ptr() if counting else None
    for b in table.blocks:
        b.args.s = scalars_for(b.dtype)
        b.args.skipped = skipped
        for j, i in enumerate(b.leaves):
            g = grads[i]
            if (g.dtype is not b.dtype or not g.is_cuda or g.get_device() != index
                    or not g.is_contiguous() or g.numel() != b.numels[j]):
                _check_leaf(f"grad {i}", g, params[i])  # raises
            b.g[j] = g.data_ptr()
        rc = lib.launch_adam(b.address, int(b.dtype == torch.bfloat16), int(b.rules), stream)
        if rc != 0:
            raise RuntimeError(f"adam kernel launch failed: CUDA error {rc}")
        adam.launches += 1


adam.launches = 0

_skipped: Dict[torch.device, torch.Tensor] = {}  # int64 [], one a device


def _skipped_buffer(device: torch.device) -> torch.Tensor:
    buf = _skipped.get(device)
    if buf is None:
        buf = _skipped[device] = torch.zeros((), dtype=torch.int64, device=device)
    return buf


def skipped_count() -> Optional[int]:
    """The elements the zero-gradient skip left in the launches made while
    the counters were on, summed over the devices (synchronises); None
    before the first such launch."""
    if not _skipped:
        return None
    return sum(int(buf.item()) for buf in _skipped.values())


def skipped_reset() -> None:
    for buf in _skipped.values():
        buf.zero_()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("adam")
    lib.launch_adam.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.launch_adam.restype = ctypes.c_int
    lib.adam_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.adam_layout.restype = None
    got = (ctypes.c_int * 13)()
    lib.adam_layout(got)
    if list(got) != layout():
        raise RuntimeError(f"csrc/adam.cu's argument block {list(got)} differs from the ctypes "
                           f"mirror's {layout()}")
    return lib
