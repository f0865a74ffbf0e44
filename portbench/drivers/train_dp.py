"""Data-parallel training cells: ``world`` ranks, one a card (NCCL; gloo on the
CPU), each running the trainer's ``train_steps`` with the data group, as
``python -m nerf_tpu_torch.train ... mesh_devices N`` runs them.

This process is rank 0. It builds the kernels (``kernels["train"]`` of the
configuration), then starts ranks 1 .. world - 1 as
``python -m portbench.drivers.train_dp --rank <r> ...`` on cards 1 .. world - 1,
each reading the cell from a file, all meeting through a fresh ``file://``
store. A rank that does not join within ``join_seconds`` of the traffic mix,
or any rank that exits with an error, ends the run: the process exits
without a result, and the other ranks end with it (each watches its parent).

Every rank makes the same views from the seed, resumes the same checkpoint
and draws the same global batches; rank 0's ESS grid is broadcast. Each
step renders a rank's rows of the global batch (``rays_per_step`` rays,
4,096 a rank at world 4) and one all-reduce averages the gradients. Rank 0
records its first three steps (as ``drivers/train.py`` does), decides after
each chunk whether the window goes on and tells the others (one broadcast a
chunk), and counts the window's global rays: ``train_rays_per_s``.
``--trace 1``: a fixed count of chunks on every rank, timed and then traced
on rank 0.

Once the ranks have left, rank 0 runs the one-card float32 reference of the
global batch, in chunks of ``reference_chunk`` rays whose gradients are
summed (the whole batch's autograd would not fit on one card), and
``train.judge`` compares the same three gaps.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from .. import bench, harness, program, trace as tracing
from ..reference import nerf as ref
from . import train

N_FIRST = train.N_FIRST


def _cell_file(cell: bench.Cell, directory: str) -> str:
    path = os.path.join(directory, "cell.json")
    d = dataclasses.asdict(cell)
    d["root"] = str(cell.root)
    with open(path, "w") as f:
        json.dump(d, f)
    return path


def _read_cell(path: str) -> bench.Cell:
    with open(path) as f:
        d = json.load(f)
    d["root"] = Path(d["root"])
    return bench.Cell(**d)


def _watch(procs: List[subprocess.Popen]) -> None:
    """End this process when a rank exits with an error (rank 0's thread)."""
    while True:
        for r, p in enumerate(procs, start=1):
            code = p.poll()
            if code not in (None, 0):
                harness.log(f"rank {r} exited with code {code}; ending the run")
                for q in procs:
                    if q.poll() is None:
                        q.kill()
                os._exit(3)
        if all(p.poll() == 0 for p in procs):
            return
        time.sleep(0.2)


def _watch_parent(parent: int) -> None:
    """End this rank when rank 0 is gone."""
    while True:
        if os.getppid() != parent:
            os._exit(3)
        time.sleep(0.5)


def _start_ranks(ctx, world: int, method: str, cell_file: str) -> List[subprocess.Popen]:
    root = str(ctx.cell.root)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))
    procs = []
    for r in range(1, world):
        cmd = [sys.executable, "-m", "portbench.drivers.train_dp", "--rank", str(r),
               "--world", str(world), "--init", method, "--cell", cell_file,
               "--seed", str(ctx.seed), "--trace", str(int(ctx.trace)),
               "--device", ctx.device.type]
        procs.append(subprocess.Popen(cmd, cwd=root, env=env, stdin=subprocess.DEVNULL,
                                      stdout=sys.stderr, stderr=sys.stderr))
    return procs


def _init_group(rank: int, world: int, method: str, device, join_s: float):
    import torch.distributed as dist
    from nerf_tpu_torch.parallel.mesh import DataGroup

    backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=join_s), **kw)
    return DataGroup(world=world, rank=rank, device=device, owned=True)


def run(ctx) -> harness.Outcome:
    t = ctx.cell.traffic
    world = int(t["world"])
    ctx.mark("imports")
    if ctx.device.type == "cuda":
        from nerf_tpu_torch.ops import build

        built = build.build(ctx.cell.config["kernels"]["train"])
        if built:
            harness.log("built " + ", ".join(f"{k} ({v:.1f} s)" for k, v in built.items()))
    ctx.mark("kernels")
    rdv = tempfile.mkdtemp(prefix="portbench_dp_")
    try:
        method = "file://" + os.path.join(rdv, "store")
        procs = _start_ranks(ctx, world, method, _cell_file(ctx.cell, rdv))
        threading.Thread(target=_watch, args=(procs,), daemon=True).start()
        answers, attempted, failed, values, profiled, peak, data = rank_loop(
            ctx, 0, world, method)
        for r, p in enumerate(procs, start=1):
            try:
                code = p.wait(timeout=float(t["join_seconds"]))
            except subprocess.TimeoutExpired:
                code = None
            if code != 0:
                harness.log(f"rank {r} did not end cleanly ({code})")
                os._exit(3)
    finally:
        shutil.rmtree(rdv, ignore_errors=True)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    m = ref.Model.from_cfg(ctx.cell.config["cfg"])
    refr = reference(ctx, m, data, "float32")
    checks = train.judge(answers, refr, ctx.cell.limits)
    return harness.Outcome(attempted=attempted, failed=failed, values=values,
                           profiled=profiled, checks=checks, memory_peak_bytes=peak)


def rank_loop(ctx, rank: int, world: int, method: str):
    """One rank's part of the run; rank 0's returns (answers, attempted,
    failed, values, profiled, peak memory, the views)."""
    import torch.distributed as dist
    from nerf_tpu_torch.parallel.multihost import broadcast_from_main
    from nerf_tpu_torch.render.renderer import RenderOptions
    from nerf_tpu_torch.train.optim import make_optimizer
    from nerf_tpu_torch.train.state import train_steps

    dev, cell, t = ctx.device, ctx.cell, ctx.cell.traffic
    group = _init_group(rank, world, method, dev, float(t["join_seconds"]))
    main = rank == 0
    if main:
        ctx.mark(f"{world} ranks joined")
    cfg = program.port_cfg(cell)
    opts, tx = RenderOptions.from_cfg(cfg), make_optimizer(cfg)
    m = ref.Model.from_cfg(cell.config["cfg"])
    n_rays, chunk = int(t["rays_per_step"]), train.chunk_steps(cfg)
    data = train.inputs(ctx, m, dev)
    state, _ = train.program_state(ctx, opts, tx, dev)
    grid = train.program_grid(ctx, state, opts, dev)
    grid = grid._replace(occupied=broadcast_from_main(grid.occupied))
    if main:
        ctx.mark("views, state and grid")
    gen = torch.Generator(device=dev).manual_seed(ctx.seed_for("train"))

    def steps(n: int) -> Dict[str, float]:
        return train_steps(state, data["images"], data["poses"], data["K"], tx, opts, n_rays, n,
                           grid=grid, generator=gen, group=group)

    leaves = program.leaf_paths(state.params)
    p0 = {p: x.detach().clone() for p, x in leaves}
    mu0 = [x.detach().clone() for x in state.opt_state.mu]
    losses: List[float] = []
    g1 = None
    for i in range(N_FIRST):
        losses.append(steps(1)["loss"])
        if i == 0:
            g1 = {p: (mu.float() - train.B1 * m0.float()) / (1.0 - train.B1)
                  for (p, _), mu, m0 in zip(leaves, state.opt_state.mu, mu0)}
    answers = {"loss": losses, "grad": train.norms(g1),
               "change": train.norms({p: x.detach().float() - p0[p].float() for p, x in leaves})}
    del g1, mu0, p0
    if main:
        ctx.mark("first steps")
    steps(chunk)  # warm-up

    values, profiled, attempted, failed = {}, None, 0, 0
    if ctx.trace:
        n_chunks = max(1, -(-int(t["trace_steps"]) // chunk))
        run_block = lambda: [steps(chunk) for _ in range(n_chunks)]  # noqa: E731
        _, timed_s = harness.timed(run_block)
        if main:
            before = program.kernel_counters()
            _, tr = tracing.profile(run_block)
            after = program.kernel_counters()
            units = n_chunks * chunk
            attempted = units
            S, I = m.n_samples, m.n_importance
            local = n_rays // world
            profiled = harness.Profiled(
                trace=tr, units=units, timed_s=timed_s, config=cell.config["cfg"],
                work={"mlp_calls": [local * S, local * (S + I)] * units,
                      "forward_points": units * local * (2 * S + I), "passes": 3,
                      "hash_calls": []},
                extra={"counters": {k: after[k] - before[k] for k in after}})
            harness.log(f"traced {units} steps on rank 0: window {tr.window_s:.4f} s, busy "
                        f"{tr.busy_s:.4f} s, {len(tr.kernels)} kernels; untraced {timed_s:.4f} s")
        else:
            run_block()
    else:
        go = torch.ones((), dtype=torch.int32, device=dev)
        if main:
            ctx.window_starts()
        t0 = time.perf_counter()
        elapsed = 0.0
        while True:
            stats = steps(chunk)
            if main:
                attempted += chunk
                if not all(math.isfinite(v) for k, v in stats.items() if k != "psnr"):
                    failed += chunk
                elapsed = time.perf_counter() - t0
                go.fill_(int(elapsed < ctx.seconds))
            dist.broadcast(go, 0)
            if not int(go):
                break
        if main:
            values["train_rays_per_s"] = attempted * n_rays / elapsed
            harness.log(f"window: {attempted} steps of {n_rays} rays over {world} ranks in "
                        f"{elapsed:.4f} s")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    dist.barrier()
    dist.destroy_process_group()
    return answers, attempted, failed, values, profiled, peak, data


def reference(ctx, m: ref.Model, data: Dict, precision: str,
              fault: Optional[str] = None) -> Dict:
    """The one-card reference's answers for the first steps of the global
    batch, each step's loss and gradients summed over chunks of rays.
    ``fault``: ``half_batch`` (the loss of the batch's first half),
    ``no_exchange`` (the loss of rank 0's rows alone: every rank steps on its
    own shard's gradient, the all-reduce left out) or ``altered`` (every
    64th ray's colour off by 0.05), for the limits."""
    cell, dev = ctx.cell, data["images"].device
    t, c = cell.traffic, cell.config["cfg"]
    chunk = int(t["reference_chunk"])
    with ref.full_float32():
        s = train.reference_start(ctx, m, None, dev)
        params = {p: x.clone().requires_grad_(True) for p, x in s["params"].items()}
        mu, nu, count, step = dict(s["mu"]), dict(s["nu"]), s["count"], s["step"]
        coarse = ref.as_tree({p[1:]: x.detach() for p, x in params.items() if p[0] == "coarse"})
        grid = ref.grid_from_density(m, coarse, precision, dev)
        replay = ref.Replay(ctx.seed_for("train"), dev)
        images, poses, K = data["images"], data["poses"], data["K"]
        n_img, H, W = images.shape[0], images.shape[1], images.shape[2]
        n_rays = int(t["rays_per_step"])
        used = {"half_batch": n_rays // 2,
                "no_exchange": n_rays // int(t["world"])}.get(fault, n_rays)
        p0 = {p: x.detach().clone() for p, x in params.items()}
        losses, g1 = [], None
        for i in range(N_FIRST):
            img, pix, u_c, u_f = replay.train_batch(n_rays, n_img, H * W, m)
            row, col = pix // W, pix % W
            target = images[img, row, col].float() / 255.0
            o, d = ref.pixel_rays(col.float(), row.float(), K, poses[img])
            grads = [torch.zeros_like(x) for x in params.values()]
            loss = 0.0
            for c0 in range(0, used, chunk):
                sl = slice(c0, min(used, c0 + chunk))
                out = ref.render_rays(m, ref.as_tree(params), o[sl], d[sl], grid,
                                      None if u_c is None else u_c[sl], u_f[sl], precision)
                rgb0, rgb = out["rgb0"], out["rgb"]
                if fault == "altered":
                    bump = torch.zeros_like(rgb)
                    bump[(torch.arange(c0, sl.stop, device=dev) % 64) == 0] = 0.05
                    rgb = rgb + bump
                part = (torch.sum((rgb0 - target[sl]) ** 2)
                        + torch.sum((rgb - target[sl]) ** 2)) / (3 * used)
                for acc, g in zip(grads, torch.autograd.grad(part, list(params.values()))):
                    acc += g
                loss += float(part.detach())
            losses.append(loss)
            lr = ref.exponential_lr(float(c["train.lr"]), float(c["train.scheduler.gamma"]),
                                    int(c["train.scheduler.decay_epochs"]), int(c["ep_iter"]),
                                    step)
            if i == 0:
                g1 = {p: g.clamp(-40.0, 40.0) for p, g in zip(params, grads)}
            count += 1
            with torch.no_grad():
                for (p, x), g in zip(params.items(), grads):
                    new, mu[p], nu[p] = ref.adam_step(x, g, mu[p], nu[p], count, lr)
                    x.copy_(new)
            step += 1
        change = {p: x.detach() - p0[p] for p, x in params.items()}
        return {"loss": losses, "grad": train.norms(g1), "change": train.norms(change)}


def control(ctx, variant: str) -> Dict:
    """The numbers of the reference in the program's place, in ``variant``
    (``fp8``) or with that fault planted (``half_batch``, ``no_exchange``,
    ``altered``)."""
    m = ref.Model.from_cfg(ctx.cell.config["cfg"])
    data = train.inputs(ctx, m, ctx.device)
    base = reference(ctx, m, data, "float32")
    other = (reference(ctx, m, data, "fp8") if variant == "fp8"
             else reference(ctx, m, data, "float32", fault=variant))
    return {k: v for k, (v, _) in train.judge(other, base, ctx.cell.limits).items()}


def main(argv=None) -> None:
    """A rank other than 0: join, train in step with rank 0, leave."""
    p = argparse.ArgumentParser(description="a rank of a portbench data-parallel cell")
    for name, kind in (("--rank", int), ("--world", int), ("--init", str), ("--cell", str),
                       ("--seed", int), ("--trace", int), ("--device", str)):
        p.add_argument(name, type=kind, required=True)
    args = p.parse_args(argv)
    threading.Thread(target=_watch_parent, args=(os.getppid(),), daemon=True).start()
    torch.set_num_threads(1)
    if args.device == "cuda":
        torch.cuda.set_device(args.rank)
        device = torch.device("cuda", args.rank)
    else:
        device = torch.device("cpu")
    ctx = harness.Context(cell=_read_cell(args.cell), seed=args.seed, seconds=0.0,
                          trace=bool(args.trace), device=device, t0=time.perf_counter())
    rank_loop(ctx, args.rank, args.world, args.init)


if __name__ == "__main__":
    main()
