"""Evaluation cells: whole frames through ``render_image``, one after another.

Set-up loads the checkpoint as the evaluator does (``run.load_eval_model``:
kernel weights and the ESS grid rebuilt from the coarse density), draws the
cameras from the seed and renders one frame to warm up. The window renders
frame after frame, each from its own seeded generator and each ended by a
host copy of its maps, until ``--seconds`` have passed: ``render_rays_per_s``
is the rays of every frame completed over the window's time. ``--trace 1``
times and then traces a fixed count of frames instead.

Once the window has closed and the program's state is freed, the reference
renders a sample of the completed frames, drawn from the seed, at a sample
of the pixels of every render tile, from its own reading of the checkpoint,
its own ESS grid and the same jitter. ``rgb_mae`` is the worst sampled
frame's mean absolute colour difference, ``rgb_tile_mae98`` the worst
sampled tile's over the 98% of its pixels that lie closest: a fault
confined to one tile is averaged away over a frame, and a sound tile's
mean is led by the few pixels whose ESS voxel flips between the two grids.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, List

import torch

from .. import harness, program, trace as tracing, workload
from ..reference import nerf as ref

TRIM = 0.02  # the share of a tile's checked pixels, the farthest, left out of its mean



def cameras(ctx, device):
    t = ctx.cell.traffic
    H, W = t["frame_size"]
    gen = torch.Generator(device=device).manual_seed(ctx.seed_for("cameras"))
    return (workload.hemisphere_poses(int(t["cameras"]), float(t["radius"]), gen, device),
            workload.intrinsics(H, W, float(t["focal"]), device))


def run(ctx) -> harness.Outcome:
    from nerf_tpu_torch.render.renderer import render_image
    from nerf_tpu_torch.run import load_eval_model

    dev, cell, t = ctx.device, ctx.cell, ctx.cell.traffic
    ctx.mark("imports")
    program.build_kernels(cell, dev)
    ctx.mark("kernels")
    cfg = program.port_cfg(cell, trained_model_dir=os.path.dirname(program.checkpoint_path(cell)))
    opts, params, grid = load_eval_model(cfg, dev)
    poses, K = cameras(ctx, dev)
    ctx.mark("model and grid")
    H, W = t["frame_size"]
    rgbs: List[torch.Tensor] = []
    failed = 0

    def frame(i: int) -> Dict[str, torch.Tensor]:
        gen = torch.Generator(device=dev).manual_seed(ctx.seed_for(f"frame{i}"))
        out = render_image(params, poses[i % poses.shape[0]], K, H, W, opts, grid=grid,
                           generator=gen)
        return {k: v.cpu() for k, v in out.items()}  # the evaluator's host copy

    def frames(n: int) -> None:
        nonlocal failed
        for _ in range(n):
            maps = frame(len(rgbs))
            rgbs.append(maps["rgb_map"])
            failed += int(not bool(torch.isfinite(maps["rgb_map"]).all()))

    frame(-1)  # warm-up
    values, profiled = {}, None
    if ctx.trace:
        n = int(t["trace_frames"])
        _, timed_s = harness.timed(lambda: frames(n))
        before = program.kernel_counters()
        _, tr = tracing.profile(lambda: frames(n))
        after = program.kernel_counters()
        m = ref.Model.from_cfg(cell.config["cfg"])
        tiles = [min(opts.tile_rays, H * W - t0) for t0 in range(0, H * W, opts.tile_rays)]
        calls = [r * s for r in tiles for s in (m.n_samples, m.n_samples + m.n_importance)] * n
        profiled = harness.Profiled(
            trace=tr, units=n, timed_s=timed_s, config=cell.config["cfg"],
            work={"mlp_calls": calls, "forward_points": sum(calls), "passes": 1},
            extra={"counters": {k: after[k] - before[k] for k in after}})
        harness.log(f"traced {n} frames: window {tr.window_s:.4f} s, busy {tr.busy_s:.4f} s, "
                    f"{len(tr.kernels)} kernels; untraced {timed_s:.4f} s; counters "
                    f"{profiled.extra['counters']}")
    else:
        ctx.window_starts()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            frames(1)
        elapsed = time.perf_counter() - t0
        values["render_rays_per_s"] = len(rgbs) * H * W / elapsed
        harness.log(f"window: {len(rgbs)} frames in {elapsed:.4f} s")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del params, grid
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = dict(harness.check(k, v, cell.limits)
                  for k, v in reference_gaps(ctx, rgbs, "float32").items())
    return harness.Outcome(attempted=len(rgbs), failed=failed, values=values,
                           profiled=profiled, checks=checks, memory_peak_bytes=peak)


def reference_frames(ctx, rgbs: List[torch.Tensor]):
    """The checked frames and pixels: ``check_frames`` of the completed
    frames, and ``check_tile_pixels`` pixels of each render tile of each,
    drawn from the seed."""
    t = ctx.cell.traffic
    H, W = t["frame_size"]
    tile, k = int(ctx.cell.config["cfg"]["render_tile_rays"]), int(t["check_tile_pixels"])
    gen = torch.Generator().manual_seed(ctx.seed_for("check"))
    n = min(int(t["check_frames"]), len(rgbs))
    picked = torch.randperm(len(rgbs), generator=gen)[:n].tolist()

    def pixels():
        return torch.cat([t0 + torch.randperm(min(tile, H * W - t0), generator=gen)[:k]
                          for t0 in range(0, H * W, tile)])

    return [(i, pixels()) for i in picked]


@torch.no_grad()
def reference_render(ctx, checked, precision: str) -> List[torch.Tensor]:
    """The reference's colours at the checked pixels of the checked frames."""
    dev, cell, t = ctx.device, ctx.cell, ctx.cell.traffic
    m = ref.Model.from_cfg(cell.config["cfg"])
    H, W = t["frame_size"]
    tile = int(cell.config["cfg"]["render_tile_rays"])
    with ref.full_float32():
        ck = ref.read_checkpoint(m, program.checkpoint_path(cell), dev)
        models = ref.as_tree(ck["params"])
        grid = ref.grid_from_density(m, models["coarse"], precision, dev) if m.ess else None
        poses, K = cameras(ctx, dev)
        out = []
        for i, sel in checked:
            jitter = ref.Replay(ctx.seed_for(f"frame{i}"), dev).frame_jitter(H * W, tile, m)
            o, d = ref.image_rays(H, W, K, poses[i % poses.shape[0]])
            sel = sel.to(dev)
            o, d = o[sel], d[sel]
            u = jitter[sel] if jitter is not None else None
            rgb = [ref.render_rays(m, models, o[s:s + 4096], d[s:s + 4096], grid,
                                   None if u is None else u[s:s + 4096], None, precision)["rgb"]
                   for s in range(0, o.shape[0], 4096)]
            out.append(torch.cat(rgb).cpu())
    return out


def gaps(ctx, got: List[torch.Tensor], want: List[torch.Tensor], checked) -> Dict[str, float]:
    """``rgb_mae`` (the worst checked frame's mean absolute colour difference)
    and ``rgb_tile_mae98`` (the worst checked render tile's, over all but its
    ``TRIM`` farthest pixels) of colours ``got`` against ``want`` at the
    checked pixels; a value that is not finite reads infinitely far."""
    tile = int(ctx.cell.config["cfg"]["render_tile_rays"])
    worst = {"rgb_mae": 0.0, "rgb_tile_mae98": 0.0}
    for (i, sel), g, r in zip(checked, got, want):
        d = (g.double() - r.double()).abs().mean(dim=-1).nan_to_num(math.inf)
        ids = torch.div(sel, tile, rounding_mode="floor")
        tiles = [d[ids == t].sort().values for t in ids.unique()]
        trimmed = [x[:max(1, x.numel() - math.ceil(TRIM * x.numel()))].mean() for x in tiles]
        frame = {"rgb_mae": float(d.mean()), "rgb_tile_mae98": float(max(trimmed)),
                 "worst_tile": int(torch.stack(trimmed).argmax()),
                 "untrimmed_tile_mae": float(max(x.mean() for x in tiles)),
                 **harness.colour_gaps(g.numpy(), r.numpy())}
        harness.log(f"frame {i}: {sel.numel()} pixels: {json.dumps(frame)}")
        for k in worst:
            worst[k] = max(worst[k], frame[k])
    return worst


def reference_gaps(ctx, rgbs: List[torch.Tensor], precision: str) -> Dict[str, float]:
    """The program's frames against the reference at the checked pixels."""
    checked = reference_frames(ctx, rgbs)
    want = reference_render(ctx, checked, precision)
    return gaps(ctx, [rgbs[i].reshape(-1, 3)[sel] for i, sel in checked], want, checked)


def control(ctx, variant: str) -> Dict:
    """The numbers of the reference computed in ``variant`` (``fp8``) in the
    program's place, on the pixels a run with ``check_frames`` frames checks."""
    checked = reference_frames(ctx, [None] * int(ctx.cell.traffic["check_frames"]))
    base = reference_render(ctx, checked, "float32")
    return gaps(ctx, reference_render(ctx, checked, variant), base, checked)
