"""Training cells: the trainer's ``train_steps`` in its own chunks.

Set-up makes the views and cameras from the seed on the card, builds the
train state (a checkpoint resumed with its optimizer, or weights made from
the seed) and its ESS grid, and drives that same state through its first
three steps, one ``train_steps`` call each on the window's feed: each
step's loss, the first gradient as Adam holds it after one step, and each
leaf's change after three are the program's answers. A chunk warms up, and
then the window runs whole chunks until ``--seconds`` have passed and the
last chunk's stats are on the host: ``train_rays_per_s`` is every ray of
every step over that time. ``--trace 1`` times and then traces a fixed
count of chunks instead.

Once the program's state is freed, the reference follows the same three
steps in float32 from the same start and the same draws, and ``judge``
compares: the worst relative gap of a step's loss, of a leaf's gradient
norm and of a leaf's change norm (against the larger of the leaf's and the
median leaf's norm in the reference; leaves whose reference gradient is
under a thousandth of the median leaf's are left out of the change).
"""
from __future__ import annotations

import math
import os
import time
from typing import Dict, List, Optional

import torch

from .. import harness, program, trace as tracing, workload
from ..reference import nerf as ref

N_FIRST = 3
B1 = 0.9  # Adam's first-moment decay (the configuration's optimizer)


def inputs(ctx, m: ref.Model, device) -> Dict:
    """The views, their cameras and the intrinsics of the traffic mix."""
    t = ctx.cell.traffic
    H, W = t["view_size"]
    gen = torch.Generator(device=device).manual_seed(ctx.seed_for("views"))
    return {"images": workload.synthetic_views(t["views"], H, W, gen, device),
            "poses": workload.hemisphere_poses(t["views"], t["radius"], gen, device),
            "K": workload.intrinsics(H, W, t["focal"], device)}


def seeded_weights(ctx, m: ref.Model, device) -> Dict:
    """{leaf path: tensor} of a model made from the seed: weights and biases
    U(+-1/sqrt(fan_in)) (one draw for all of them), hash tables
    U(+-1e-4) rounded to bfloat16 (one draw), alpha_linear's bias 0.1."""
    shapes = {(name,) + p: s for name in ("coarse", "fine")
              for p, s in ref.mlp_paths(m, m.encoder == "hashgrid")}
    paths = list(shapes)
    gen = torch.Generator(device=device).manual_seed(ctx.seed_for("weights"))
    dense = [p for p in paths if p[-1] != "table"]
    fan_in = {p: (shapes[p[:-1] + ("w",)][0]) for p in dense}
    sizes = [math.prod(shapes[p]) for p in dense]
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out = {}
    for p, chunk in zip(dense, u.split(sizes)):
        out[p] = (chunk / math.sqrt(fan_in[p])).reshape(shapes[p])
    tables = [p for p in paths if p[-1] == "table"]
    if tables:
        t = (torch.rand((len(tables),) + shapes[tables[0]], generator=gen, device=device)
             * 2.0 - 1.0) * 1e-4
        for p, tab in zip(tables, t):
            out[p] = tab.to(torch.bfloat16)
        for name in ("coarse", "fine"):
            out[(name, "alpha_linear", "b")].fill_(0.1)
    return out


def program_state(ctx, opts, tx, device):
    """(state, the start as {path: tensor}): the checkpoint resumed with its
    optimizer, or an optimizer at step 0 on weights made from the seed."""
    from nerf_tpu_torch.train.checkpoint import load_checkpoint
    from nerf_tpu_torch.train.loop import init_nerf_params
    from nerf_tpu_torch.train.state import init_state

    cfg = ctx.cell.config
    m = ref.Model.from_cfg(cfg["cfg"])
    if "checkpoint" in cfg:
        template = init_state(init_nerf_params(torch.Generator().manual_seed(0), opts, device), tx)
        path = program.checkpoint_path(ctx.cell)
        state = load_checkpoint(os.path.dirname(path), template,
                                tag=os.path.basename(path)[:-len(".npz")])[0]
        return state, None
    start = seeded_weights(ctx, m, device)
    tree = ref.as_tree({p: t.clone().requires_grad_(True) for p, t in start.items()})
    return init_state(tree, tx), start


def program_grid(ctx, state, opts, device):
    from nerf_tpu_torch.render import occupancy as occ
    from nerf_tpu_torch.train.loop import make_density_fn

    kind = ctx.cell.config["grid"]
    gen = torch.Generator(device=device).manual_seed(ctx.seed_for("grid"))
    seed = occ.init_grid(int(ctx.cell.config["cfg"]["occupancy_grid_resolution"]),
                         generator=gen, device=device)
    if kind == "seed":
        return seed
    return occ.populate_from_density(seed, make_density_fn(state.params["coarse"], opts))


def chunk_steps(cfg) -> int:
    """The trainer's chunk: ``scan_chunk``, else max(log_interval, 50), at most
    an epoch (``train/loop.py``)."""
    ep_iter = int(cfg.get("ep_iter", 500))
    return min(ep_iter, int(cfg.get("scan_chunk", max(int(cfg.get("log_interval", 10)), 50))))


def norms(d: Dict) -> Dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def run(ctx) -> harness.Outcome:
    from nerf_tpu_torch.render.renderer import RenderOptions
    from nerf_tpu_torch.train.optim import make_optimizer
    from nerf_tpu_torch.train.state import train_steps

    dev, cell, t = ctx.device, ctx.cell, ctx.cell.traffic
    ctx.mark("imports")
    program.build_kernels(cell, dev)
    ctx.mark("kernels")
    cfg = program.port_cfg(cell)
    opts, tx = RenderOptions.from_cfg(cfg), make_optimizer(cfg)
    m = ref.Model.from_cfg(cell.config["cfg"])
    n_rays, chunk = int(t["rays_per_step"]), chunk_steps(cfg)
    data = inputs(ctx, m, dev)
    state, start = program_state(ctx, opts, tx, dev)
    grid = program_grid(ctx, state, opts, dev)
    ctx.mark("views, state and grid")
    gen = torch.Generator(device=dev).manual_seed(ctx.seed_for("train"))

    def steps(n: int) -> Dict[str, float]:
        return train_steps(state, data["images"], data["poses"], data["K"], tx, opts, n_rays, n,
                           grid=grid, generator=gen)

    # the first steps, through the window's own call: the program's answers
    leaves = program.leaf_paths(state.params)
    p0 = {p: x.detach().clone() for p, x in leaves}
    mu0 = [x.detach().clone() for x in state.opt_state.mu]
    losses: List[float] = []
    g1 = None
    for i in range(N_FIRST):
        losses.append(steps(1)["loss"])
        if i == 0:
            g1 = {p: (mu.float() - B1 * m0.float()) / (1.0 - B1)
                  for (p, _), mu, m0 in zip(leaves, state.opt_state.mu, mu0)}
    answers = {"loss": losses, "grad": norms(g1),
               "change": norms({p: x.detach().float() - p0[p].float() for p, x in leaves})}
    del g1, mu0
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
        attempted = 2 * units
        S, I = m.n_samples, m.n_importance
        calls = [n_rays * S, n_rays * (S + I)] * units
        corners = 8 * m.hash_levels if m.encoder == "hashgrid" else 0
        profiled = harness.Profiled(
            trace=tr, units=units, timed_s=timed_s, config=cell.config["cfg"],
            work={"mlp_calls": calls, "forward_points": units * n_rays * (2 * S + I),
                  "passes": 3, "hash_calls": [n * corners for n in calls] if corners else []},
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


def reference_start(ctx, m: ref.Model, start: Optional[Dict], device) -> Dict:
    """The reference's start: the checkpoint read by the reference itself
    (weights, Adam's moments and counts), or the seed's weights at step 0."""
    if start is None:
        return ref.read_checkpoint(m, program.checkpoint_path(ctx.cell), device)
    params = {p: t.float() for p, t in start.items()}
    zeros = {p: torch.zeros_like(t) for p, t in params.items()}
    return {"params": params, "mu": zeros, "nu": dict(zeros), "count": 0, "step": 0}


def reference(ctx, m: ref.Model, data: Dict, start: Optional[Dict], precision: str,
              fault: Optional[str] = None) -> Dict:
    """The reference's answers for the first steps (see ``judge``). ``fault``
    plants a fault in it for the limits' readings: ``half_batch`` (the loss
    of half the rays), ``altered`` (every 64th ray's colour off by 0.05)."""
    cell, dev = ctx.cell, data["images"].device
    t, c = cell.traffic, cell.config["cfg"]
    with ref.full_float32():
        s = reference_start(ctx, m, start, dev)
        params = {p: x.clone().requires_grad_(True) for p, x in s["params"].items()}
        mu, nu, count, step = dict(s["mu"]), dict(s["nu"]), s["count"], s["step"]
        if cell.config["grid"] == "seed":
            grid = ref.seed_grid(m.grid_resolution,
                                 torch.Generator(device=dev).manual_seed(ctx.seed_for("grid")), dev)
        else:
            coarse = ref.as_tree({p[1:]: x.detach() for p, x in params.items() if p[0] == "coarse"})
            grid = ref.grid_from_density(m, coarse, precision, dev)
        replay = ref.Replay(ctx.seed_for("train"), dev)
        images, poses, K = data["images"], data["poses"], data["K"]
        n_img, H, W = images.shape[0], images.shape[1], images.shape[2]
        n_rays = int(t["rays_per_step"])
        p0 = {p: x.detach().clone() for p, x in params.items()}
        losses, g1 = [], None
        for i in range(N_FIRST):
            img, pix, u_c, u_f = replay.train_batch(n_rays, n_img, H * W, m)
            row, col = pix // W, pix % W
            target = images[img, row, col].float() / 255.0
            o, d = ref.pixel_rays(col.float(), row.float(), K, poses[img])
            out = ref.render_rays(m, ref.as_tree(params), o, d, grid, u_c, u_f, precision)
            rgb0, rgb = out["rgb0"], out["rgb"]
            if fault == "altered":
                bump = torch.zeros_like(rgb)
                bump[::64] = 0.05
                rgb = rgb + bump
            if fault == "half_batch":
                h = n_rays // 2
                rgb0, rgb, target = rgb0[:h], rgb[:h], target[:h]
            loss = torch.mean((rgb0 - target) ** 2) + torch.mean((rgb - target) ** 2)
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
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
        return {"loss": losses, "grad": norms(g1), "change": norms(change)}


def judge(prog: Dict, refr: Dict, limits: Dict) -> Dict:
    """The numbers compared: ``loss_gap`` (the worst step's |loss - ref| /
    ref), ``grad_gap`` and ``change_gap`` (the worst leaf's |norm - ref norm|
    / max(ref norm, the median leaf's ref norm))."""
    import statistics

    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], refr["loss"]))

    def worst(key, keep):
        med = statistics.median(refr[key].values())
        gaps = {p: abs(prog[key][p] - r) / max(r, med, 1e-30)
                for p, r in refr[key].items() if keep(p)}
        p = max(gaps, key=gaps.get)
        harness.log(f"{key}: worst leaf {'.'.join(map(str, p))} {gaps[p]:.6g} "
                    f"(program {prog[key][p]:.6g}, reference {refr[key][p]:.6g}, median {med:.6g})")
        return gaps[p]

    med_g = statistics.median(refr["grad"].values())
    checks = dict([harness.check("loss_gap", loss_gap, limits),
                   harness.check("grad_gap", worst("grad", lambda p: True), limits),
                   harness.check("change_gap", worst(
                       "change", lambda p: refr["grad"][p] >= 1e-3 * med_g), limits)])
    return checks


def control(ctx, variant: str) -> Dict:
    """The numbers of the reference in the program's place, computed in
    ``variant`` (``fp8``) or with that fault planted (``half_batch``,
    ``altered``), judged against the float32 reference."""
    m = ref.Model.from_cfg(ctx.cell.config["cfg"])
    data = inputs(ctx, m, ctx.device)
    start = None if "checkpoint" in ctx.cell.config else seeded_weights(ctx, m, ctx.device)
    base = reference(ctx, m, data, start, "float32")
    other = (reference(ctx, m, data, start, variant) if variant == "fp8"
             else reference(ctx, m, data, start, "float32", fault=variant))
    return {k: v for k, (v, _) in judge(other, base, ctx.cell.limits).items()}
