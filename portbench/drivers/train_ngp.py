"""Training cells of Instant-NGP's network: the trainer's ``train_steps`` in its
own chunks, as ``drivers/train.py`` runs the NeRF, whose helpers it reuses.

Set-up makes the views and cameras from the seed on the card, the network's
weights from the seed (the table U(+-``table_scale``) of the configuration
file, a scale at which the encoding moves the outputs; the MLP weights
Xavier-uniform), the train state and the seeded ESS grid, and drives the
state through its first three steps, one ``train_steps`` call each: each
step's loss, the first gradient as Adam holds it after one step (the
clipped gradient plus the L2 term; 0 where the skip left a table entry) and
each leaf's change after three are the program's answers. A chunk warms up;
the window runs whole chunks until ``--seconds`` have passed and the last
chunk's stats are on the host: ``train_rays_per_s``. ``--trace 1`` times and
then traces a fixed count of chunks instead.

The reference (``reference/ngp.py``) follows the same three steps in float32
from the same start and the same draws, and ``judge`` compares the three
gaps of ``train.judge``, the gradient's as the norm of the difference of the
two gradients rather than the difference of their norms: a fault in the
hash's indices (a level hashed with another prime) moves a level's table
gradient to other rows, which leaves every norm as it was on noise views,
and on this network the norms' gaps alone do not part bfloat16's rounding
from that fault or from fp8. ``control`` reads the limits: the reference in
fp8 or with a fault planted (``reference.ngp.FAULTS``) in the program's place.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import torch

from .. import harness, program, trace as tracing
from ..reference import nerf as nref, ngp as ref
from . import train

N_FIRST = train.N_FIRST


def seeded_weights(ctx, m: ref.Model, device) -> Dict:
    """{leaf path: float32 tensor} from the seed: the MLP weights
    Xavier-uniform, U(+-sqrt(6 / (fan_in + fan_out))), from one draw; the
    table U(+-table_scale) from a second."""
    scale = float(ctx.cell.config["table_scale"])
    gen = torch.Generator(device=device).manual_seed(ctx.seed_for("weights"))
    paths = ref.leaf_paths(m)
    dense = [(p, s) for p, s in paths if p[-1] == "w"]
    sizes = [math.prod(s) for _, s in dense]
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out = {}
    for (p, s), chunk in zip(dense, u.split(sizes)):
        out[p] = (chunk * math.sqrt(6.0 / (s[0] + s[1]))).reshape(s)
    tp, ts = paths[-1]
    out[tp] = (torch.rand(ts, generator=gen, device=device) * 2.0 - 1.0) * scale
    return out


def optimizer_of(cfg: Dict) -> Dict:
    return {"lr": float(cfg["train.lr"]), "b1": float(cfg["train.beta1"]),
            "b2": float(cfg["train.beta2"]), "eps": float(cfg["train.eps"]),
            "l2": float(cfg["train.l2_reg"]), "skip": bool(cfg["train.skip_zero_grads"]),
            "gamma": float(cfg["train.scheduler.gamma"]),
            "decay_epochs": int(cfg["train.scheduler.decay_epochs"]),
            "ep_iter": int(cfg["ep_iter"])}


def run(ctx) -> harness.Outcome:
    from nerf_tpu_torch.render.renderer import RenderOptions
    from nerf_tpu_torch.train.optim import make_optimizer
    from nerf_tpu_torch.train.state import init_state, train_steps

    dev, cell, t = ctx.device, ctx.cell, ctx.cell.traffic
    ctx.mark("imports")
    # the configuration first: a program without the network fails here, at once
    cfg = program.port_cfg(cell)
    opts, tx = RenderOptions.from_cfg(cfg), make_optimizer(cfg)
    program.build_kernels(cell, dev)
    ctx.mark("kernels")
    m = ref.Model.from_cfg(cell.config["cfg"])
    n_rays, chunk = int(t["rays_per_step"]), train.chunk_steps(cfg)
    data = train.inputs(ctx, m, dev)
    start = seeded_weights(ctx, m, dev)
    state = init_state(nref.as_tree({p: x.clone().requires_grad_(True)
                                     for p, x in start.items()}), tx)
    grid = train.program_grid(ctx, state, opts, dev)
    harness.log(f"ESS grid: {float(grid.occupied.float().mean()) * 100:.2f}% occupied")
    ctx.mark("views, state and grid")
    gen = torch.Generator(device=dev).manual_seed(ctx.seed_for("train"))

    def steps(n: int) -> Dict[str, float]:
        return train_steps(state, data["images"], data["poses"], data["K"], tx, opts, n_rays, n,
                           grid=grid, generator=gen)

    leaves = program.leaf_paths(state.params)
    p0 = {p: x.detach().clone() for p, x in leaves}
    b1 = float(cell.config["cfg"]["train.beta1"])
    losses: List[float] = []
    g1 = None
    for i in range(N_FIRST):
        losses.append(steps(1)["loss"])
        if i == 0:  # the moments start at 0: mu = (1 - b1) g
            g1 = {p: mu.float() / (1.0 - b1) for (p, _), mu in zip(leaves, state.opt_state.mu)}
    answers = {"loss": losses, "grad": g1,
               "change": train.norms({p: x.detach().float() - p0[p].float() for p, x in leaves})}
    ctx.mark("first steps")
    steps(chunk)  # warm-up

    values, profiled, attempted, failed = {}, None, 0, 0
    if ctx.trace:
        n_chunks = max(1, -(-int(t["trace_steps"]) // chunk))
        run_block = lambda: [steps(chunk) for _ in range(n_chunks)]  # noqa: E731
        _, timed_s = harness.timed(run_block)
        before = program.kernel_counters()
        _, tr = tracing.profile(run_block)
        after = program.kernel_counters()
        units = n_chunks * chunk
        attempted = units
        points = n_rays * m.n_samples
        rows = points * 8 * m.levels
        profiled = harness.Profiled(
            trace=tr, units=units, timed_s=timed_s, config=cell.config["cfg"],
            work={"mlp_calls": [points] * units, "forward_points": units * points, "passes": 3,
                  "hash_calls": [rows] * units, "scatter_calls": [rows] * units},
            extra={"counters": {k: after[k] - before[k] for k in after}})
        harness.log(f"traced {units} steps: window {tr.window_s:.4f} s, busy {tr.busy_s:.4f} s, "
                    f"{len(tr.kernels)} kernels; untraced {timed_s:.4f} s; counters "
                    f"{profiled.extra['counters']}")
    else:
        ctx.window_starts()
        t0 = time.perf_counter()
        while True:
            stats = steps(chunk)
            attempted += chunk
            if not all(math.isfinite(v) for k, v in stats.items() if k != "psnr"):
                failed += chunk
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        elapsed = time.perf_counter() - t0
        values["train_rays_per_s"] = attempted * n_rays / elapsed
        harness.log(f"window: {attempted} steps in {elapsed:.4f} s")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del state, grid, leaves, p0, steps
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    refr = reference(ctx, m, data, start, "float32")
    checks = judge(answers, refr, cell.limits)
    return harness.Outcome(attempted=attempted, failed=failed, values=values,
                           profiled=profiled, checks=checks, memory_peak_bytes=peak)


def reference(ctx, m: ref.Model, data: Dict, start: Dict, precision: str,
              fault: Optional[str] = None) -> Dict:
    """The reference's answers for the first steps (see ``train.judge``)."""
    cell, dev = ctx.cell, data["images"].device
    opt = optimizer_of(cell.config["cfg"])
    with nref.full_float32():
        params = {p: x.float().clone().requires_grad_(True) for p, x in start.items()}
        mu = {p: torch.zeros_like(x) for p, x in params.items()}
        nu = {p: torch.zeros_like(x) for p, x in params.items()}
        grid = nref.seed_grid(m.grid_resolution,
                              torch.Generator(device=dev).manual_seed(ctx.seed_for("grid")), dev)
        gen = torch.Generator(device=dev).manual_seed(ctx.seed_for("train"))
        images, poses, K = data["images"], data["poses"], data["K"]
        n_img, H, W = images.shape[0], images.shape[1], images.shape[2]
        n_rays = int(cell.traffic["rays_per_step"])
        p0 = {p: x.detach().clone() for p, x in params.items()}
        losses, g1 = [], None
        for i in range(N_FIRST):
            img, pix, u = ref.train_draws(gen, n_rays, n_img, H * W, m, dev)
            row, col = pix // W, pix % W
            target = images[img, row, col].float() / 255.0
            o, d = nref.pixel_rays(col.float(), row.float(), K, poses[img])
            net = nref.as_tree(params)["coarse"]
            out = ref.render_rays(m, net, o, d, grid, u, precision, fault)
            loss = torch.mean((out["rgb"] - target) ** 2)
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
            lr = nref.exponential_lr(opt["lr"], opt["gamma"], opt["decay_epochs"], opt["ep_iter"], i)
            if i == 0:
                g1 = {p: g.clamp(-40.0, 40.0) + (opt["l2"] * x.detach() if p[-1] == "w" else 0.0)
                      for (p, x), g in zip(params.items(), grads)}
            with torch.no_grad():
                for (p, x), g in zip(params.items(), grads):
                    table = p[-1] == "table"
                    new, mu[p], nu[p] = ref.adam_step(
                        x, g, mu[p], nu[p], i + 1, lr, opt["b1"], opt["b2"], opt["eps"],
                        0.0 if table else opt["l2"], opt["skip"] and table)
                    x.copy_(new)
        change = {p: x.detach() - p0[p] for p, x in params.items()}
        return {"loss": losses, "grad": g1, "change": train.norms(change)}


def judge(prog: Dict, refr: Dict, limits: Dict) -> Dict:
    """``train.judge``'s three gaps, ``grad_gap`` as the worst leaf's
    ||g1 - g1_ref|| / max(||g1_ref||, the median leaf's ||g1_ref||) of the
    gradient tensors Adam holds after the first step; ``loss_gap`` and
    ``change_gap`` (norms) as ``train.judge`` forms them."""
    import statistics

    ref_norms = train.norms(refr["grad"])
    med = statistics.median(ref_norms.values())
    gaps = {p: float(torch.linalg.vector_norm((prog["grad"][p].double()
                                               - refr["grad"][p].double()))) / max(r, med, 1e-30)
            for p, r in ref_norms.items()}
    worst = max(gaps, key=gaps.get)
    harness.log(f"grad: worst leaf {'.'.join(map(str, worst))} {gaps[worst]:.6g} "
                f"(reference norm {ref_norms[worst]:.6g}, median {med:.6g})")
    checks = train.judge({**prog, "grad": train.norms(prog["grad"])},
                         {**refr, "grad": ref_norms}, limits)
    checks["grad_gap"] = harness.check("grad_gap", gaps[worst], limits)[1]
    return checks


def control(ctx, variant: str) -> Dict:
    """The numbers of the reference in the program's place, computed in fp8
    (``variant`` "fp8") or with a fault planted (``reference.ngp.FAULTS``),
    judged against the float32 reference."""
    m = ref.Model.from_cfg(ctx.cell.config["cfg"])
    data = train.inputs(ctx, m, ctx.device)
    start = seeded_weights(ctx, m, ctx.device)
    base = reference(ctx, m, data, start, "float32")
    other = (reference(ctx, m, data, start, "fp8") if variant == "fp8"
             else reference(ctx, m, data, start, "float32", fault=variant))
    return {k: v for k, (v, _) in judge(other, base, ctx.cell.limits).items()}
