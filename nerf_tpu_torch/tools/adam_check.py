"""Check and time the multi-tensor Adam kernel (``csrc/adam.cu``) on lego's 48 leaves.

    python -m nerf_tpu_torch.tools.adam_check

From the committed epoch-49 lego state (its params and Adam's moments at
count 12,500, ``configs/nerf/lego.yaml``'s optimizer), on seeded gradients
of the trained model's scale: 3 steps through ``Optimizer.step`` (the
kernel) against 3 through ``step_plain`` (the loop), p, mu and nu bit for
bit; then, warm:

- the kernel's device time by CUDA events: back to back inside a CUDA graph
  (lego's 33.4 MB stay in the 50 MB L2 between launches), and each launch
  after a 128 MB read that evicts them (what a train step, whose other
  kernels pass between two updates, finds), the median of 30;
- its bound: 28 bytes an element (read p, g, mu, nu; write p, mu, nu) at
  3.35 TB/s;
- ``step_plain``'s time on the same leaves, by events around 20 steps;
- the host's time a call of ``Optimizer.step`` and of ``step_plain``
  (enqueue only, by the host clock over 200 calls).

Prints one JSON line. ``chip_smoke.py`` runs ``run`` as a phase.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import sys
import time

import torch

from ..ops import adam

PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (data sheet)
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
LEGO = os.path.join(ROOT, "checkpoints", "nerf", "lego", "nerf")


def lego_state(dev):
    """(optimizer, params, OptState) of the committed lego checkpoint on ``dev``."""
    from ..config import make_cfg
    from ..render.renderer import RenderOptions
    from ..train import loop
    from ..train.checkpoint import load_checkpoint
    from ..train.optim import make_optimizer
    from ..train.state import init_state
    from ..tree import tree_leaves

    cfg = make_cfg(os.path.join(ROOT, "configs", "nerf", "lego.yaml"), [])
    tx = make_optimizer(cfg)
    params = loop.init_nerf_params(torch.Generator().manual_seed(0),
                                   RenderOptions.from_cfg(cfg), dev)
    state = load_checkpoint(LEGO, init_state(params, tx))[0]
    return tx, [p.detach() for p in tree_leaves(state.params)], state.opt_state


def grads_like(params, seed):
    """Seeded gradients of each leaf's scale: N(0, 1) times 1e-3 |p|'s mean."""
    gen = torch.Generator(device=params[0].device).manual_seed(seed)
    return [torch.randn(p.shape, generator=gen, device=p.device, dtype=p.dtype)
            * (1e-3 * float(p.abs().mean()) + 1e-8) for p in params]


def _copy(params, st):
    return ([p.clone() for p in params],
            dataclasses.replace(st, mu=[m.clone() for m in st.mu], nu=[v.clone() for v in st.nu]))


def _bits_equal(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


def check(tx, params, st, steps: int = 3) -> None:
    """``steps`` kernel steps against ``steps`` loop steps from copies of the
    state; raises unless p, mu and nu are equal bit for bit after each."""
    kp, ks = _copy(params, st)
    lp, ls = _copy(params, st)
    for i in range(steps):
        g = grads_like(params, 10 + i)
        tx.step(kp, g, ks)
        tx.step_plain(lp, g, ls)
        torch.cuda.synchronize()
        for name, a, b in (("p", kp, lp), ("mu", ks.mu, ls.mu), ("nu", ks.nu, ls.nu)):
            if not _bits_equal(a, b):
                raise AssertionError(f"adam kernel step {i + 1}: {name} differs from step_plain")


def _events_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_us(fn, reps: int) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def times(tx, params, st) -> dict:
    """The kernel's and the loop's times on ``params`` (see the module's note)."""
    kp, ks = _copy(params, st)
    g = grads_like(params, 1)
    step = lambda: tx.step(kp, g, ks)  # noqa: E731
    for _ in range(3):
        step()
    if len(tx._table.blocks) != 1:
        raise AssertionError(f"lego's leaves took {len(tx._table.blocks)} launches, not one")
    block = tx._table.blocks[0]
    lib = adam._lib()
    reps = 20
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(reps):
            lib.launch_adam(block.address, 0, 0, stream)
    graph.replay()
    l2_ms = _events_ms(graph.replay, 5) / reps
    flush = torch.ones(32 << 20, dtype=torch.float32, device=params[0].device)
    cold = []
    for _ in range(30):
        flush.sum()  # a read: the evicted lines leave clean, nothing to write back
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        lib.launch_adam(block.address, 0, 0, torch.cuda.current_stream().cuda_stream)
        e1.record()
        torch.cuda.synchronize()
        cold.append(e0.elapsed_time(e1))
    lp, ls = _copy(params, st)
    plain = lambda: tx.step_plain(lp, g, ls)  # noqa: E731
    plain()
    plain_ms = _events_ms(plain, 20)
    n = sum(p.numel() for p in params)
    bound_ms = 28 * n / PEAK_BYTES * 1e3
    ms = statistics.median(cold)
    return {"leaves": len(params), "elements": n, "ms": ms, "l2_warm_ms": l2_ms,
            "bound_ms": bound_ms, "share_of_bound": bound_ms / ms, "plain_ms": plain_ms,
            "host_us": _host_us(step, 200), "plain_host_us": _host_us(plain, 200)}


def run(dev) -> dict:
    tx, params, st = lego_state(dev)
    check(tx, params, st)
    return times(tx, params, st)


def main() -> int:
    if not torch.cuda.is_available():
        print("adam_check: no CUDA device", file=sys.stderr)
        return 1
    out = run(torch.device("cuda"))
    print(json.dumps({"device": torch.cuda.get_device_name(0), **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
