"""Serving cells: the orbit viewer's ``/frame`` over HTTP, several viewers.

Set-up starts the port's ``RenderService`` (the checkpoint, its ESS grid)
behind ``make_server`` on 127.0.0.1 at a free port, in a thread of this
process, and sends one request to warm up. The viewers run in a child
process (``serve_clients``): requests arrive at the mix's fixed rate, an
open loop, for ``--seconds``; ``request_ms_p95`` is the 95th percentile of
every request's time from when it was due to its whole answer, a failed
request counting as missing (infinitely late). ``--trace 1`` runs a fixed
count of requests twice, the second time traced, with this process's own
service timed around each render (``http_png_ms.serve``).

Once the server is down and the program's state freed, the reference
renders a sample of the answered requests, drawn from the seed, at their
poses from its own reading of the checkpoint and compares the PNG's
pixels: ``png_share_over_2`` is the worst sampled frame's share of values more
than 2/255 off (one step of an 8-bit value is rounding).
"""
from __future__ import annotations

import base64
import json
import math
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from .. import harness, program, trace as tracing
from ..reference import nerf as ref
from ..reference import png

# the service's camera and jitter (``serve.RenderService``): focal 1.39 x the
# frame's size, each frame's jitter from a generator seeded with 0
FOCAL_PER_PIXEL = 1.39
FRAME_SEED = 0
GAP = "share_over_2"  # the colour gap compared (harness.colour_gaps)

def viewers(ctx, port: int, tag: str = "viewers", **limit):
    """Start the viewers' process (their drags drawn from the seed and
    ``tag``); returns a function that lets them go and returns their JSON."""
    t = ctx.cell.traffic
    spec = dict(port=port, seed=ctx.seed_for(tag), viewers=int(t["viewers"]),
                rate=float(t["rate"]), radius=float(t["radius"]), drag=float(t["drag"]),
                timeout=float(t["timeout"]), workers=int(t["workers"]), **limit)
    env = dict(os.environ, PYTHONPATH=str(ctx.cell.root))
    proc = subprocess.Popen([sys.executable, "-m", "portbench.drivers.serve_clients",
                             json.dumps(spec)], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            cwd=str(ctx.cell.root), env=env, text=True)
    try:
        if proc.stdout.readline().strip() != "ready":
            raise RuntimeError("the viewers' process did not start")

        def go():
            try:
                proc.stdin.write("go\n")
                proc.stdin.flush()
                out = json.loads(proc.stdout.readline())
                proc.wait(timeout=60)
                return out
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()

        return go
    except BaseException:
        proc.kill()
        proc.wait()
        raise


def p95(seconds: List[float]) -> float:
    """The nearest-rank 95th percentile."""
    s = sorted(seconds)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def run(ctx) -> harness.Outcome:
    from nerf_tpu_torch.serve import RenderService, make_server

    dev, cell, t = ctx.device, ctx.cell, ctx.cell.traffic
    ctx.mark("imports")
    program.build_kernels(cell, dev)
    ctx.mark("kernels")
    cfg = program.port_cfg(cell, trained_model_dir=os.path.dirname(program.checkpoint_path(cell)))
    service = RenderService(cfg, size=int(t["size"]), device=dev)
    server = make_server(service, "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    ctx.mark("service")
    render_s: Dict = {}
    try:
        service.render_png(0.5, 0.3, float(t["radius"]))  # warm-up
        values, profiled = {}, None
        if ctx.trace:
            orig = service.render

            def timed_render(theta, phi, radius, opts=None):
                t0 = time.perf_counter()
                out = orig(theta, phi, radius, opts)
                torch.cuda.synchronize()
                render_s[(theta, phi, radius)] = time.perf_counter() - t0
                return out

            service.render = timed_render
            n = int(t["trace_requests"])
            first = viewers(ctx, port, "viewers.timed", requests=n)()
            timed_s = first["seconds"]
            gaps = [r[4] - r[7] - render_s[(r[1], r[2], r[3])] for r in first["requests"]
                    if r[5] == 200 and (r[1], r[2], r[3]) in render_s]
            go = viewers(ctx, port, "viewers.traced", requests=n)
            second, tr = tracing.profile(go)
            runs = first["requests"] + second["requests"]
            profiled = harness.Profiled(
                trace=tr, units=len(second["requests"]), timed_s=timed_s,
                config=cell.config["cfg"], work={},
                extra={"http_png_ms": 1e3 * sum(gaps) / len(gaps) if gaps else None})
            harness.log(f"traced {len(second['requests'])} requests: window {tr.window_s:.4f} s, "
                        f"busy {tr.busy_s:.4f} s, {len(tr.kernels)} kernels")
        else:
            go = viewers(ctx, port, seconds=ctx.seconds)
            ctx.window_starts()
            out = go()
            runs = out["requests"]
            lat = [r[4] if r[5] == 200 else math.inf for r in runs]
            values["request_ms_p95"] = 1e3 * p95(lat)
            harness.log(f"window: {len(runs)} requests in {out['seconds']:.4f} s "
                        f"({len(runs) / out['seconds']:.3f} a second, offered {t['rate']}), "
                        f"median {1e3 * sorted(lat)[len(lat) // 2]:.3f} ms, p95 "
                        f"{values['request_ms_p95']:.3f} ms, sent late by at most "
                        f"{1e3 * max(r[7] for r in runs):.3f} ms")
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    failed = sum(1 for r in runs if r[5] != 200) + service.errors
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del service, server
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = dict([harness.check("png_" + GAP, reference_gap(ctx, runs, "float32"), cell.limits)])
    return harness.Outcome(attempted=len(runs), failed=failed, values=values,
                           profiled=profiled, checks=checks, memory_peak_bytes=peak)


def orbit_pose(theta: float, phi: float, radius: float) -> torch.Tensor:
    """The viewer's camera: on the sphere of ``radius`` at azimuth theta
    (from +y towards +x) and elevation phi, looking at the origin, z up."""
    pos = radius * np.array([np.cos(phi) * np.sin(theta), np.cos(phi) * np.cos(theta),
                             np.sin(phi)])
    z = pos / np.linalg.norm(pos)
    x = np.cross(np.array([0.0, 0.0, 1.0]), z)
    x /= max(np.linalg.norm(x), 1e-8)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, np.cross(z, x), z, pos
    return torch.from_numpy(c2w)


def checked_requests(ctx, runs: List) -> List:
    ok = [r for r in runs if r[5] == 200]
    gen = torch.Generator().manual_seed(ctx.seed_for("check"))
    return [ok[i] for i in torch.randperm(len(ok), generator=gen)[
        :int(ctx.cell.traffic["check_requests"])].tolist()]


@torch.no_grad()
def reference_images(ctx, requests: List, precision: str) -> List[np.ndarray]:
    """The reference's uint8 frames of the requests' poses, quantized as the
    server does (clipped to [0, 1], times 255, truncated)."""
    dev, cell, t = ctx.device, ctx.cell, ctx.cell.traffic
    m = ref.Model.from_cfg(cell.config["cfg"])
    size, tile = int(t["size"]), int(cell.config["cfg"]["render_tile_rays"])
    f = FOCAL_PER_PIXEL * size
    K = torch.tensor([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]], dtype=torch.float32,
                     device=dev)
    out = []
    with ref.full_float32():
        ck = ref.read_checkpoint(m, program.checkpoint_path(cell), dev)
        models = ref.as_tree(ck["params"])
        grid = ref.grid_from_density(m, models["coarse"], precision, dev) if m.ess else None
        for r in requests:
            o, d = ref.image_rays(size, size, K, orbit_pose(r[1], r[2], r[3]).to(dev))
            u = ref.Replay(FRAME_SEED, dev).frame_jitter(size * size, tile, m)
            rgb = torch.cat([ref.render_rays(m, models, o[s:s + 4096], d[s:s + 4096], grid,
                                             None if u is None else u[s:s + 4096], None,
                                             precision)["rgb"]
                             for s in range(0, size * size, 4096)])
            img = (np.clip(rgb.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
            out.append(img.reshape(size, size, 3))
    return out


def reference_gap(ctx, runs: List, precision: str) -> float:
    """The worst checked request's RMS pixel difference (in [0, 1] units)."""
    picked = checked_requests(ctx, runs)
    if not picked:
        return math.inf
    want = reference_images(ctx, picked, precision)
    worst = 0.0
    for r, w in zip(picked, want):
        got = png.decode(base64.b64decode(r[6]))[..., :3]
        g = harness.colour_gaps(got / 255.0, w / 255.0)
        harness.log(f"request {r[1]!r} {r[2]!r}: {json.dumps(g)}")
        worst = max(worst, g[GAP])
    return worst


def control(ctx, variant: str) -> Dict:
    """``png_share_over_2`` of the reference computed in ``variant`` (``fp8``) in the
    program's place, at ``check_requests`` poses a viewer could send."""
    rng = np.random.default_rng(ctx.seed_for("control"))
    n = int(ctx.cell.traffic["check_requests"])
    reqs = [[0, rng.uniform(0, 2 * np.pi), rng.uniform(0.1, 1.2),
             float(ctx.cell.traffic["radius"])] for _ in range(n)]
    base = reference_images(ctx, reqs, "float32")
    other = reference_images(ctx, reqs, variant)
    gaps = [harness.colour_gaps(a / 255.0, b / 255.0) for a, b in zip(other, base)]
    for g in gaps:
        harness.log(f"{variant}: {json.dumps(g)}")
    return {"png_" + GAP: max(g[GAP] for g in gaps)}
