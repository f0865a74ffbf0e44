"""Checks and times of the float32 fused-MLP kernels (B1-f32, B2-f32) on the card.

    python -m nerf_tpu_torch.tools.f32_check

Both kernels compute true float32 (fmaf on the CUDA cores), so they are held
to their plain versions with float32 weights, as ``chip_smoke.py`` does:
- forward: |k - p| / (1 + |p|), the largest over every input checked,
  within 2x that of the plain version summed in float32 against float64
  (``forward_errors``);
- backward: per gradient leaf within 2e-4 max|want| + 1e-6 (and dpts,
  ddirs within 1e-3 of their largest |value|), after zeroing on both sides
  the cotangent of the points with a ReLU unit within float32 rounding of
  zero, decided from float64 margins (``fused_mlp_bwd.knife_edge_points``):
  two correct float32 forwards may decide such a unit either way, and one
  flip moves a whole leaf (``backward_errors``);
- a whole train step, kernels against plain versions with the same fine
  samples and the same masking (``step_pair``).
The tool prints those checks on random inputs at the lego model's width,
where B1-f32's distance comes from (``layer_errors``), then B1-f32 on a
lego fine tile (1,572,864 points) and B2-f32 and its four
launches on a train step's fine batch (196,608 points), each beside its
bound, its plain version and a chain of float32 ``torch.matmul`` calls
(``allow_tf32`` off: full float32) as a yardstick.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import torch

from ..ops import fused_mlp, fused_mlp_bwd as fb

PEAK_F32 = 67e12  # H100 SXM, float32 on the CUDA cores (data sheet)
PEAK_TF32 = 495e12  # its tensor cores in TF32, dense (data sheet)
PEAK_BYTES = 3.35e12
MACS_PER_POINT = 593_408
FWD_OVER_PLAIN64 = 2.0
BWD_LEAF_REL, BWD_LEAF_ABS, BWD_INPUT_REL = 2e-4, 1e-6, 1e-3
# the backward's multiply-adds a point with input gradients: the forward
# again, every weight gradient, and every layer's input gradient
BWD_MACS_PER_POINT = 3 * MACS_PER_POINT


def forward_errors(kp, pts, dirs):
    """(max rel err of B1-f32 against the plain version, max rel err of the
    plain version summed in float32 against float64, max abs err)."""
    got = fused_mlp.fused_nerf_eval(kp, pts, dirs)
    want = fused_mlp.fused_nerf_eval_plain(kp, pts, dirs)
    want64 = fused_mlp.fused_nerf_eval_plain(kp, pts, dirs, torch.float64)
    if not bool(torch.isfinite(got).all()):
        raise FloatingPointError("B1-f32: non-finite output")
    rel = float(((got - want).abs() / (1.0 + want.abs())).max())
    rel64 = float(((want - want64).abs() / (1.0 + want64.abs())).max())
    return rel, rel64, float((got - want).abs().max())


def backward_errors(kp, pts, dirs, g, input_grads=True):
    """B2-f32 against the plain backward on the same inputs, the knife-edge
    points' cotangents zeroed on both sides. Returns {worst: the largest
    err / tol over the leaves (and dpts, ddirs), leaf, masked: points
    zeroed, abs: the largest |err|}."""
    g = g.clone()
    edge = fb.knife_edge_points(kp, pts, dirs)
    g[edge] = 0
    got = fb.fused_nerf_bwd(kp, pts, dirs, g, input_grads)
    want = fb.fused_nerf_bwd_plain(kp, pts, dirs, g, input_grads=input_grads)
    worst, leaf, big = 0.0, None, 0.0
    pairs = [(k, got[0][k], want[0][k], BWD_LEAF_REL) for k in fb._GRAD_KEYS]
    if input_grads:
        pairs += [("dpts", got[1], want[1], BWD_INPUT_REL), ("ddirs", got[2], want[2],
                                                              BWD_INPUT_REL)]
    for name, a, b, rel in pairs:
        if not bool(torch.isfinite(a).all()):
            raise FloatingPointError(f"B2-f32: non-finite {name}")
        err = float((a - b).abs().max())
        tol = rel * float(b.abs().max()) + BWD_LEAF_ABS
        big = max(big, err)
        if err / tol >= worst:
            worst, leaf = err / tol, name
    return {"worst": worst, "leaf": leaf, "masked": int(edge.sum()), "abs": big}


def float64_distances(kp, pts, dirs, g, runs):
    """How far each backward in ``runs`` ({name: fn(kp, pts, dirs, g) ->
    kgrads}) and the plain version in float32 lie from the plain version in
    float64, the knife-edge points' cotangents zeroed for all: {name: (the
    largest max|k - p64| / max|p64| over the gradient leaves, that leaf)},
    "plain float32" among them."""
    g = g.clone()
    g[fb.knife_edge_points(kp, pts, dirs)] = 0
    want = fb.fused_nerf_bwd_plain(kp, pts.double(), dirs.double(), g.double(), torch.float64,
                                   input_grads=False)[0]
    runs = {**runs, "plain float32": lambda *a: fb.fused_nerf_bwd_plain(*a, input_grads=False)[0]}
    out = {}
    for name, fn in runs.items():
        got = fn(kp, pts, dirs, g)
        out[name] = max((float((got[k].double() - want[k]).abs().max())
                         / max(float(want[k].abs().max()), 1e-30), k) for k in fb._GRAD_KEYS)
    return out


@contextlib.contextmanager
def masked_backwards():
    """Inside the block, every MLP backward of a train step (the kernel's
    and the plain version's) first zeroes the cotangent of the knife-edge
    points of its own inputs (float64 margins)."""
    real = {n: getattr(fb, n) for n in ("fused_nerf_bwd", "fused_nerf_bwd_plain")}

    def wrap(fn):
        def masked(kp, pts, dirs, g, *args, **kwargs):
            g = g.clone()
            g[fb.knife_edge_points(kp, pts, dirs)] = 0
            return fn(kp, pts, dirs, g, *args, **kwargs)
        masked.launches = 0
        return masked

    for n, fn in real.items():
        setattr(fb, n, wrap(fn))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(fb, n, fn)


@contextlib.contextmanager
def replayed_fine_samples(record):
    """Inside the block, the renderer's sample_pdf returns the fine samples
    in ``record`` in order when it holds any, else records what it draws."""
    from ..render import renderer

    real, i = renderer.sample_pdf, [0]

    def replay(*args, **kwargs):
        if i[0] < len(record):
            z = record[i[0]]
        else:
            z = real(*args, **kwargs)
            record.append(z)
        i[0] += 1
        return z

    renderer.sample_pdf = replay
    try:
        yield
    finally:
        renderer.sample_pdf = real


def step_pair(params, ro, rd, tgt, opts, grid, generator, plain_opts):
    """One train step's loss and gradients through ``opts`` and through
    ``plain_opts`` on the same batch, from the same generator state, with
    the fine samples the first drew and the knife-edge points masked in
    both backwards. Returns ((loss, grads), (loss, grads))."""
    from ..train.state import loss_and_grads

    state, record, out = generator.get_state(), [], []
    with masked_backwards():
        for o in (opts, plain_opts):
            generator.set_state(state)
            with replayed_fine_samples(record):
                loss, _, grads = loss_and_grads(params, ro, rd, tgt, o, grid, generator)
            out.append((loss, grads))
    return out[0], out[1]


# the columns of B2-f32's float32 stash (csrc/fused_mlp_f32.cuh: s_h(i),
# S_FEAT, S_V): the activations of the recomputed forward
STASH_COLS = {**{f"h{i}": 64 + 256 * (i - 1) for i in range(1, 9)}, "feat": 2112, "v": 2400}


def layer_errors(kp, pts, dirs):
    """Where B1-f32's distance from the plain version comes from: for every
    activation of the forward (read from B2-f32's stash, the same kernel
    code) and every output column, the largest |x - r| / (1 + |r|) of the
    kernel against the plain version summed in float64, of the plain
    version in float32 against float64, and of the kernel against the plain
    version in float32. At most ``fb.F32_CHUNK`` points (one chunk's stash)."""
    n = pts.shape[0]
    out = fb.launch_f32(kp, pts, dirs, torch.zeros((n, 4), device=pts.device),
                        input_grads=False)
    slabs = out["stash_slabs"]
    st = slabs.transpose(1, 2).reshape(-1, slabs.shape[1])[:n].double()
    a32, a64 = fb.plain_activations(kp, pts, dirs), fb.plain_activations(kp, pts, dirs,
                                                                           torch.float64)
    raw = (out["raw"].double(), fused_mlp.fused_nerf_eval_plain(kp, pts, dirs).double(),
           fused_mlp.fused_nerf_eval_plain(kp, pts, dirs, torch.float64).double())

    def rel(x, r):
        return float(((x - r).abs() / (1.0 + r.abs())).max())

    rows = []
    for name, col in STASH_COLS.items():
        k, p, r = st[:, col: col + a64[name].shape[1]], a32[name].double(), a64[name].double()
        rows.append((name, rel(k, r), rel(p, r), rel(k, p)))
    for c, name in enumerate(("r", "g", "b", "sigma")):
        k, p, r = (t[:, c] for t in raw)
        rows.append((f"raw {name}", rel(k, r), rel(p, r), rel(k, p)))
    return rows


def matmul_chain_f32(kp, pts, dirs):
    """The forward as a chain of float32 torch.matmul calls (cuBLAS SGEMM,
    full float32 with allow_tf32 off) with bias and ReLU between them: the
    yardstick of unfused library products."""
    mats, off = [], 0
    for k, nn in fused_mlp.STREAM_LAYERS:
        mats.append(kp["wbuf"][off: off + k * nn].view(k, nn))
        off += k * nn
    wa = kp["wbuf"][off: off + 256].view(256, 1)
    wr = kp["wbuf"][off + 256: off + 640].view(128, 3)
    b = kp["bbuf"]

    def enc(v, s, width):
        a = fused_mlp._phases(v, s)
        e = torch.cat([v, torch.sin(a), torch.cos(a)], -1)
        return torch.nn.functional.pad(e, (0, width - e.shape[1]))

    ex, ed = enc(pts, kp["sx"], 64), enc(dirs, kp["sd"], 32)
    h = ex
    for l in range(9):
        x = ex if l == 0 else torch.cat([ex, h], -1) if l == 5 else h
        y = x @ mats[l] + b[l * 256: (l + 1) * 256]
        if l == 7:
            sigma = y.clamp_min(0) @ wa + b[2432]
        h = y.clamp_min(0) if l < 8 else y
    v = (torch.cat([h, ed], -1) @ mats[9] + b[2304:2432]).clamp_min(0)
    return torch.cat([v @ wr + b[2433:2436], sigma], -1)


def matmul_chain_f32_bwd(kp, pts, dirs, g):
    """The yardstick of B2-f32: ``matmul_chain_f32`` and its autograd
    backward to every weight and bias (float32 SGEMMs throughout)."""
    leaves = {k: kp[k].detach().clone().requires_grad_(True) for k in ("wbuf", "bbuf")}
    out = matmul_chain_f32({**kp, **leaves}, pts, dirs)
    return torch.autograd.grad(out, list(leaves.values()), g)


def time_ms(fn, reps, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def fwd_bound_ms(n_points):
    return max(n_points * 2 * MACS_PER_POINT / PEAK_F32, n_points * 40 / PEAK_BYTES) * 1e3


def bwd_bound_ms(n_points, input_grads=False, tf32_dw=False):
    """The backward's least time: its multiply-adds at the float32 peak (the
    train step asks for no input gradients: 64x256, 64x256, 32x128 fewer a
    point), or its inputs and outputs at the memory rate. ``tf32_dw``: the
    weight gradients' share as 3xTF32 products at the TF32 peak
    (``dw_bound_ms``), the rest at the float32 peak, as the kernel runs."""
    macs = BWD_MACS_PER_POINT - (0 if input_grads else 64 * 256 * 2 + 32 * 128)
    ops = n_points * 2 * macs / PEAK_F32
    if tf32_dw:
        ops += dw_bound_ms(n_points) / 1e3 - n_points * 2 * MACS_PER_POINT / PEAK_F32
    return max(ops, (n_points * (12 + 12 + 16) + 4 * (fused_mlp.WBUF_SIZE + fused_mlp.BBUF_SIZE))
               / PEAK_BYTES) * 1e3


def dw_bound_ms(n_points):
    """The weight gradients' least time on the tensor cores: a multiply-add
    a weight and a point, three TF32 products each (3xTF32), at the TF32
    peak."""
    return n_points * 2 * MACS_PER_POINT * 3 / PEAK_TF32 * 1e3


def dw_byte_floor_ms(n_points, splits):
    """The weight-gradient launch's bytes: every stash and gbuf column of
    every point read once (all 2,528 + 2,436 are some product's operand) and
    its partial rows written once."""
    pst = fused_mlp.WBUF_SIZE + fused_mlp.BBUF_SIZE
    return (n_points * 4 * (2528 + 2436) + 4 * splits * pst) / PEAK_BYTES * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("f32_check: no CUDA device", file=sys.stderr)
        return 1
    from ..ops import build
    from ..train.checkpoint import load_params

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    build.build(["fused_mlp_f32", "fused_mlp_bwd_f32"])
    params = load_params(os.path.join(root, "checkpoints/nerf/lego/nerf"))
    kp = {k: v.to(dev) for k, v in
          fused_mlp.repack_params(params["fine"], weight_dtype=torch.float32).items()}
    gen = torch.Generator(device=dev).manual_seed(0)

    def points(n):
        p = torch.rand((n, 3), generator=gen, device=dev) * 3.0 - 1.5
        d = torch.randn((n, 3), generator=gen, device=dev)
        return p, d / d.norm(dim=-1, keepdim=True)

    errs = []
    for n in (1, 63, 64, 127, 128, 129, 65_553, 196_608):
        p, d = points(n)
        errs.append(forward_errors(kp, p, d))
        g = torch.randn((n, 4), generator=gen, device=dev)
        b = backward_errors(kp, p, d, g)
        print(f"n={n}: B1-f32 rel err {errs[-1][0]:.3g} (plain f32 vs f64 {errs[-1][1]:.3g}); "
              f"B2-f32 worst leaf {b['leaf']} at {b['worst']:.3g} of its tolerance, "
              f"{b['masked']} knife-edge points", flush=True)
    rel, rel64 = max(e[0] for e in errs), max(e[1] for e in errs)
    print(f"B1-f32 over every input: {rel:.4g} against {FWD_OVER_PLAIN64} x {rel64:.4g}",
          flush=True)
    p, d = points(65_536)
    for name, k64, p64, kp32 in layer_errors(kp, p, d):
        print(f"  {name}: kernel vs float64 {k64:.3g}, plain float32 vs float64 {p64:.3g}, "
              f"kernel vs plain float32 {kp32:.3g}", flush=True)
    p, d = points(1_572_864)
    out = torch.empty((p.shape[0], 4), device=dev)
    lib = fused_mlp._lib_f32()
    stream = torch.cuda.current_stream().cuda_stream
    res = {"b1_ms": time_ms(lambda: lib.launch_fused_nerf_f32(
        p.data_ptr(), d.data_ptr(), kp["wbuf"].data_ptr(), kp["bbuf"].data_ptr(),
        out.data_ptr(), p.shape[0], stream), 3)}
    res["b1_bound_ms"] = fwd_bound_ms(p.shape[0])
    res["b1_plain_ms"] = time_ms(lambda: fused_mlp.fused_nerf_eval_plain(kp, p, d), 2)
    res["b1_matmul_chain_ms"] = time_ms(lambda: matmul_chain_f32(kp, p, d), 2)
    p, d = points(196_608)
    g = torch.randn((p.shape[0], 4), generator=gen, device=dev)
    full = fb.launch_f32(kp, p, d, g, input_grads=False)
    blib = fb._lib_f32()[0]
    for name, phases in (("b2_ms", fb.F32_PHASES_ALL), ("b2_forward_ms", 1), ("b2_chain_ms", 2),
                         ("b2_dw_ms", 4), ("b2_reduce_ms", 8)):
        args = list(full["args"])
        args[-2] = phases
        res[name] = time_ms(lambda: blib.launch_fused_nerf_bwd_f32(*args), 3)
    res["b2_bound_ms"] = bwd_bound_ms(p.shape[0])
    res["b2_plain_ms"] = time_ms(lambda: fb.fused_nerf_bwd_plain(kp, p, d, g,
                                                                 input_grads=False), 2)
    res["b2_matmul_chain_ms"] = time_ms(lambda: matmul_chain_f32_bwd(kp, p, d, g), 2)
    print(json.dumps({k: round(v, 4) for k, v in res.items()}), flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    code = main()
    print(f"f32_check: {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(code)
