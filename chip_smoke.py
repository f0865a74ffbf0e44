#!/usr/bin/env python3
"""Smoke run of nerf_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel under nerf_tpu_torch/csrc with plain nvcc, all at once;
  3. each kernel against its plain PyTorch version on random inputs (the
     fused MLP on 65,536 points; integrate with and without ERT, relu and
     softplus, S = 64 and 192);
  4. serve: a RenderService for configs/nerf/lego.yaml with the committed
     checkpoint (ESS grid rebuilt through the fused kernel), an HTTP server
     on 127.0.0.1, one warm-up GET /frame at 200x200 (the startup figure),
     then a timed window of 32 requests at distinct poses; the launch
     counters are zeroed before the service is built and read after the
     window, and every kernel must have been launched;
  5. each kernel against its plain version at the serving path's own
     shapes and inputs (the first and the last render tile of the warm-up
     pose, coarse and fine, and one ESS lattice slab), and each kernel's
     time on the first tile's fine pass, with its bound from those inputs;
  6. the warm-up pose rendered through the plain versions; PSNR >= 40 dB;
  7. shutdown.
The line before the last is {"kernels": [...]}, the last
{"ok": true, "device": {...}}. Any failure exits non-zero before either.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.request

T0 = time.perf_counter()

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): bf16 tensor
# cores, float32 without tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Tolerances:
# - fused MLP (bf16), err = |k - p| / (1 + |p|) per output, k the kernel and
#   p the plain version: both round every activation to bf16 and sum in
#   float32 in another order, so a sum next to a bf16 rounding boundary
#   rounds differently and the flip grows through the later layers. On each
#   input the 99th percentile of err <= 1e-3 (set before the first run) and
#   the 99.9th <= 1e-2. The largest err has no fixed bound: on the path's
#   inputs the plain version differs from itself summed in float64 by up to
#   0.21 (python -m nerf_tpu_torch.tools.fused_accuracy, H100), so the
#   largest err over every input checked must stay within twice the largest
#   err of that float64 plain version over the same inputs. (A fixed 5e-2,
#   set from 65,536 random points, held there but not on the path's tiles.)
# - integrate (float32): atol 2e-5 on rgb/depth/acc/weights, as
#   tests/test_integrate_kernel.py (sums of up to 192 terms in another order).
# - whole frame, kernels against plain versions: PSNR >= 40 dB.
FUSED_P99_REL, FUSED_P999_REL, FUSED_MAX_OVER_PLAIN64 = 1e-3, 1e-2, 2.0
INTEGRATE_ATOL = 2e-5
PSNR_MIN_DB = 40.0

MACS_PER_POINT = 593_408  # the lego MLP's multiply-adds per point (63+27 inputs)
FUSED_IO_BYTES = 40  # pts, dirs in (24 B), raw out (16 B)
SIZE = 200
THETA0, PHI, RADIUS = 0.5, 0.3, 4.0  # the warm-up pose, rendered again in phase 6
N_TIMED = 32  # requests in the timed serving window, at thetas spread over the orbit


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.2f} s] {msg}", flush=True)


class Failure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Failure(what)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Device time per call, by CUDA events around ``reps`` calls. Timed
    through ``launch_*`` itself, a kernel's time leaves out its wrapper's
    checks, allocations and finishing ops, which the wrapper time shows."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fused_errors(label, kp, pts, dirs):
    """Hold fused_nerf_eval against fused_nerf_eval_plain on one input, beside
    the plain version summed in float64. Returns (max abs err, max rel err,
    max rel err of the float64 plain version)."""
    import torch
    from nerf_tpu_torch.ops import fused_mlp

    got = fused_mlp.fused_nerf_eval(kp, pts, dirs)
    want = fused_mlp.fused_nerf_eval_plain(kp, pts, dirs)
    want64 = fused_mlp.fused_nerf_eval_plain(kp, pts, dirs, torch.float64)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"fused_nerf_eval on {label}: non-finite output")
    err = (got - want).abs()
    rel = (err / (1.0 + want.abs())).flatten()
    rel64 = ((want64 - want).abs() / (1.0 + want.abs())).flatten()
    q = torch.quantile(rel, torch.tensor([0.99, 0.999], device=rel.device))
    p99, p999 = float(q[0]), float(q[1])
    max_rel, max_rel64 = float(rel.max()), float(rel64.max())
    log(f"fused_nerf_eval {label}, {pts.shape[0]} pts bf16: max abs err {float(err.max()):.6g}, "
        f"rel: p99 {p99:.3g} (tol {FUSED_P99_REL}), p99.9 {p999:.3g} (tol {FUSED_P999_REL}), "
        f"max {max_rel:.4g} (plain summed in float64: {max_rel64:.4g})")
    check(p99 <= FUSED_P99_REL and p999 <= FUSED_P999_REL,
          f"fused_nerf_eval disagrees with fused_nerf_eval_plain on {label}")
    return float(err.max()), max_rel, max_rel64


def check_fused_max(errs):
    """The largest rel err over every input against twice that of the float64 plain version."""
    max_rel, max_rel64 = max(e[1] for e in errs), max(e[2] for e in errs)
    log(f"fused_nerf_eval over {len(errs)} inputs: max rel err {max_rel:.4g}, plain summed in "
        f"float64 {max_rel64:.4g} (tol {FUSED_MAX_OVER_PLAIN64} x)")
    check(max_rel <= FUSED_MAX_OVER_PLAIN64 * max_rel64,
          "fused_nerf_eval's largest error exceeds the plain version's own spread")
    return max(e[0] for e in errs)


def integrate_errors(label, raw, z, d, ert, act):
    """Hold integrate against integrate_plain on one input; returns max abs err."""
    import torch
    from nerf_tpu_torch.ops import integrate as tint

    got = tint.integrate(raw, z, d, ert, True, act)
    want = tint.integrate_plain(raw, z, d, ert, True, act)
    torch.cuda.synchronize()
    err = max(float((got[k] - want[k]).abs().max())
              for k in ("rgb_map", "depth_map", "acc_map", "weights"))
    log(f"integrate {label} N={z.shape[0]} S={z.shape[1]} ert={ert} {act}: "
        f"max abs err {err:.3g} (tol {INTEGRATE_ATOL})")
    check(err <= INTEGRATE_ATOL, f"integrate disagrees with integrate_plain on {label}")
    return err


def random_phase(kp, dev):
    """Both kernels against their plain versions on random inputs, covering
    the options the serving path does not take (ERT off, softplus)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    pts = torch.rand((65_536, 3), generator=gen, device=dev) * 3.0 - 1.5
    d = torch.randn((65_536, 3), generator=gen, device=dev)
    fused_errs = [fused_errors("random", kp, pts, d / torch.linalg.norm(d, dim=-1, keepdim=True))]

    integrate_err = 0.0
    for s in (64, 192):
        raw = torch.randn((8192, s, 4), generator=gen, device=dev)
        raw[..., 3] *= 20.0
        z = torch.sort(torch.rand((8192, s), generator=gen, device=dev) * 4.0 + 2.0, -1).values
        d = torch.randn((8192, 3), generator=gen, device=dev)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        for ert in (0.0, 0.01):
            for act in ("relu", "softplus"):
                integrate_err = max(integrate_err,
                                    integrate_errors("random", raw, z, d, ert, act))
    return fused_errs, integrate_err


def serve_phase(dev, root):
    """Drive the serving path through its entry points: build the service,
    one warm-up request, then a timed window of N_TIMED requests."""
    import numpy as np
    import torch
    from nerf_tpu_torch.config import make_cfg
    from nerf_tpu_torch.ops import fused_mlp, integrate as tint
    from nerf_tpu_torch.serve import RenderService, decode_png, make_server

    cfg = make_cfg(os.path.join(root, "configs/nerf/lego.yaml"),
                   ["trained_model_dir", os.path.join(root, "checkpoints/nerf/lego/nerf")])
    fused_mlp.fused_nerf_eval.launches = 0
    tint.integrate.launches = 0
    t = time.perf_counter()
    service = RenderService(cfg, size=SIZE, device=dev)
    torch.cuda.synchronize()
    populate_s = time.perf_counter() - t
    populate_launches = fused_mlp.fused_nerf_eval.launches
    log(f"RenderService on {dev}: {populate_s:.3f} s including the ESS rebuild at "
        f"R={service.grid.resolution} ({populate_launches} fused launches), occupied "
        f"{float(service.grid.occupied.float().mean()):.4f}")

    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    thetas = [THETA0] + [THETA0 + 2.0 * math.pi * i / N_TIMED for i in range(N_TIMED)]
    bodies, times = [], []
    try:
        port = server.server_address[1]
        window_start = None
        for i, theta in enumerate(thetas):
            if i == 1:
                window_start = time.perf_counter()
            url = f"http://127.0.0.1:{port}/frame?theta={theta}&phi={PHI}&radius={RADIUS}"
            t = time.perf_counter()
            with urllib.request.urlopen(url, timeout=120) as resp:
                status, ctype, body = resp.status, resp.headers["Content-Type"], resp.read()
            times.append(time.perf_counter() - t)
            check(status == 200 and ctype == "image/png", f"GET {url}: {status} {ctype}")
            bodies.append(body)
        window_s = time.perf_counter() - window_start
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "server thread did not stop")
    check(service.errors == 0, f"{service.errors} /frame errors")
    launches = {"fused_nerf_eval": fused_mlp.fused_nerf_eval.launches,
                "integrate": tint.integrate.launches}
    log(f"launches on the serving path: {launches} (fused: {populate_launches} in the "
        f"ESS rebuild, {launches['fused_nerf_eval'] - populate_launches} in "
        f"{len(thetas)} requests)")
    check(all(v > 0 for v in launches.values()), "a kernel was not launched by the path")

    frames = []
    for theta, body in zip(thetas, bodies):
        img = decode_png(body)
        check(img.shape == (SIZE, SIZE, 3), f"frame shape {img.shape}")
        mean = float(img.mean()) / 255.0
        check(mean < 0.98, f"frame at theta={theta:.4f} is blank (mean {mean:.4f})")
        frames.append(img)
    means = [float(f.mean()) / 255.0 for f in frames]
    log(f"all {len(frames)} frames: 200, PNG [{SIZE}, {SIZE}, 3], mean "
        f"{min(means):.4f}..{max(means):.4f}")
    w = np.array(times[1:]) * 1e3
    log(f"serving {SIZE}x{SIZE}: startup {populate_s * 1e3:.1f} ms (service) + "
        f"{times[0] * 1e3:.1f} ms (first request); window of {N_TIMED} requests "
        f"{window_s:.4f} s, {window_s * 1e3 / N_TIMED:.2f} ms per request, "
        f"{N_TIMED * SIZE * SIZE / window_s:.0f} rays/s; per request min {w.min():.2f}, "
        f"median {np.median(w):.2f}, p90 {np.percentile(w, 90):.2f}, max {w.max():.2f}, "
        f"std {w.std():.2f} ms")
    return service, frames[0], launches


def path_phase(service, random_errs):
    """Both kernels against their plain versions on the serving path's own
    inputs and shapes, and their times on the first tile's fine pass."""
    import torch
    from nerf_tpu_torch.ops import fused_mlp, integrate as tint
    from nerf_tpu_torch.render.composite import composite
    from nerf_tpu_torch.tools.fused_accuracy import path_inputs

    dev, opts, kp = service.device, service.opts, service.params
    fused_errs, integrate_err = random_errs
    ert, act = opts.ert_threshold if opts.enable_ert else 0.0, opts.sigma_activation
    timed = None
    for label, model, pts, dirs, z, d in path_inputs(service, THETA0, PHI, RADIUS):
        fused_errs.append(fused_errors(label, kp[model], pts, dirs))
        if z is None:
            continue
        raw = fused_mlp.fused_nerf_eval(kp[model], pts, dirs).reshape(*z.shape, 4)
        integrate_err = max(integrate_err, integrate_errors(label, raw, z, d, ert, act))
        if timed is None and model == "fine":
            timed = (pts, dirs, raw, z, d)
    fused_err = check_fused_max(fused_errs)

    pts, dirs, raw, z, d = timed
    n = pts.shape[0]
    wk = kp["fine"]
    out = torch.empty((n, 4), device=dev)
    lib, stream = fused_mlp._lib(), torch.cuda.current_stream().cuda_stream
    args = [t.data_ptr() for t in (pts, dirs, wk["wbuf"], wk["bbuf"], out)]
    check(lib.launch_fused_nerf(*args, n, stream) == 0, "launch_fused_nerf failed")
    ms = time_ms(lambda: lib.launch_fused_nerf(*args, n, stream), reps=10)
    wrapper_ms = time_ms(lambda: fused_mlp.fused_nerf_eval(wk, pts, dirs), reps=10)
    plain_ms = time_ms(lambda: fused_mlp.fused_nerf_eval_plain(wk, pts, dirs), reps=3)
    flops = 2.0 * MACS_PER_POINT * n
    nbytes = FUSED_IO_BYTES * n + wk["wbuf"].numel() * 2 + wk["bbuf"].numel() * 4
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    log(f"fused_nerf_eval first tile fine, {n} pts: kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s), wrapper {wrapper_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms")
    kernels = [{"name": "fused_nerf_eval", "route": "cuda",
                "source": "nerf_tpu_torch/csrc/fused_mlp.cu",
                "replaces": "nerf_tpu/ops/fused_mlp.py:129",
                "max_abs_err": fused_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES
                else "bytes", "library_ms": None}]

    nr, s = z.shape
    outs = [torch.empty(shape, device=dev) for shape in ((nr, 3), (nr,), (nr,), (nr, s))]
    lib = tint._lib()
    args = [t.data_ptr() for t in (raw, z, d, *outs)]
    act_id = int(act == "softplus")
    check(lib.launch_integrate(*args, nr, s, ert, act_id, stream) == 0, "launch_integrate failed")
    ms = time_ms(lambda: lib.launch_integrate(*args, nr, s, ert, act_id, stream), reps=200)
    wrapper_ms = time_ms(lambda: tint.integrate(raw, z, d, ert, True, act), reps=50)
    plain_ms = time_ms(lambda: tint.integrate_plain(raw, z, d, ert, True, act), reps=20)
    # what these inputs need: samples up to ERT's cut are read (raw 16 B,
    # z 4 B), every weight and the per-ray values are written
    trans = composite(raw, z, d, white_bkgd=False, sigma_activation=act)["transmittance"]
    read = int((trans >= ert).sum())
    nbytes = read * 20 + nr * s * 4 + nr * (12 + 12 + 4 + 4)
    flops = 40.0 * read
    bound = max(nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS) * 1e3
    log(f"integrate first tile fine, N={nr} S={s} ert={ert}: kernel {ms:.4f} ms, wrapper "
        f"{wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
        f"({read / (nr * s):.3f} of the samples before the cut)")
    kernels.append({"name": "integrate", "route": "cuda",
                    "source": "nerf_tpu_torch/csrc/integrate.cu",
                    "replaces": "nerf_tpu/ops/integrate.py:24",
                    "max_abs_err": integrate_err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound,
                    "bound_by": "bytes" if nbytes / PEAK_BYTES >= flops / PEAK_F32_FLOPS
                    else "operations", "library_ms": None})
    return kernels


def plain_phase(service):
    """The warm-up pose again, through the kernels and through the plain versions."""
    import numpy as np
    import torch

    rgb_k = service.render(THETA0, PHI, RADIUS)
    plain = dataclasses.replace(service.opts, use_fused_mlp=False, use_integrate_kernel=False)
    t = time.perf_counter()
    rgb_p = service.render(THETA0, PHI, RADIUS, opts=plain)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    check(tuple(rgb_k.shape) == (SIZE, SIZE, 3) and bool(torch.isfinite(rgb_k).all()),
          "kernel frame is not finite [200, 200, 3]")
    check(bool(torch.isfinite(rgb_p).all()), "plain frame is not finite")
    mse = float(torch.mean((rgb_k - rgb_p) ** 2))
    psnr = -10.0 * math.log10(max(mse, 1e-20))
    log(f"kernel vs plain frame: PSNR {psnr:.2f} dB (min {PSNR_MIN_DB}), max abs "
        f"{float((rgb_k - rgb_p).abs().max()):.4g}; plain render {plain_s:.3f} s")
    check(psnr >= PSNR_MIN_DB, "kernel path disagrees with the plain path")
    return (np.clip(rgb_k.cpu().numpy(), 0, 1) * 255).astype(np.uint8)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr, flush=True)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from nerf_tpu_torch.ops import build, fused_mlp
    from nerf_tpu_torch.train.checkpoint import load_params

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"phase 1: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    log("phase 2: build kernels")
    secs = build.build()
    for name in build.sources():
        lines = [l.strip() for l in build.build_log(name).splitlines()
                 if "registers" in l or "spill" in l or "smem" in l]
        log(f"built {name} in {secs.get(name, 0.0):.1f} s: " + " | ".join(lines))

    log("phase 3: kernels against their plain versions on random inputs "
        "(torch.backends.cuda.matmul.allow_tf32 = False for the plain side)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = load_params(os.path.join(root, "checkpoints/nerf/lego/nerf"))
    kp = {k: v.to(dev) for k, v in fused_mlp.repack_params(params["coarse"]).items()}
    random_errs = random_phase(kp, dev)

    log("phase 4: serve")
    service, first_png, launches = serve_phase(dev, root)

    log("phase 5: kernels against their plain versions on the serving path's inputs")
    kernels = path_phase(service, random_errs)
    for k in kernels:
        k["launches"] = launches[k["name"]]

    log("phase 6: the kernel path against the plain path")
    rgb_k = plain_phase(service)
    # renders are deterministic: the served PNG is the same frame
    check(bool((rgb_k == first_png).all()), "served frame differs from a re-render")

    log("phase 7: done")
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(smi, flush=True)
    print(json.dumps({"kernels": [{k: kern[k] for k in order} for kern in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Failure as e:
        log(f"FAILED: {e}")
        code = 1
    sys.exit(code)
