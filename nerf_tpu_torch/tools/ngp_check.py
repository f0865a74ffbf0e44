"""Check the kernels of an Instant-NGP train step (``configs/lego_ngp.yaml``) on the card.

    python -m nerf_tpu_torch.tools.ngp_check

From a seeded state of the yaml's network on the card (its table drawn
U(+-1), a scale at which the encoding moves the outputs), at the yaml's own
geometry:

- B4 (``gather_rows``) on the float32 table [16 x 2^19, 2], 8-byte rows, at
  2^18 points x 128 corner rows (33,554,432 rows) indexed as the encoder
  indexes random points of its box: exact against ``gather_rows_plain``;
- B4' (``scatter_add_rows``, float32: no rounding pass) of seeded cotangents
  at those rows into the table's 8,388,608 rows: within
  ``scatter_add_tolerance`` of ``scatter_add_rows_plain``;
- the hash encoder's kernels (``ops/hash_encode.py``) on the float32 table
  at 2^18 points, the first of them on its cells' faces, at the clamp's
  edge and outside the box (``encoder_points``): ``hash_index`` equal to
  ``hashgrid_index`` (the PyTorch path's float32 steps on the card, which
  ``hash_index_plain`` is); ``hash_interp`` equal to its plain version and within
  ``interp_tolerance`` of ``encode_torch``; ``hash_interp_bwd`` equal to its
  plain version; one forward and backward of ``encode_fused`` under
  ``torch.cuda.set_sync_debug_mode("error")``, its launches (``hash_index``,
  B4, ``hash_interp``; ``hash_interp_bwd``, B4') and its table gradient
  within ``scatter_add_tolerance``; then each kernel's time by CUDA events
  beside its byte bound and its plain version's, and the encoder's forward and backward on either path
  (``check_encoder``, ``encoder_times``);
- one train step of 4,096 rays x 64 samples (``train_step``, on seeded
  800x800 noise views and the trainer's seed ESS grid) after a warm-up step,
  with the launch counters zeroed just before it: one launch each of B4,
  B4', B3, the Adam kernel and the encoder's three kernels;
- the Adam kernel with the yaml's rules (the L2 on the MLP weights, the
  zero-gradient skip on the table) on one batch's gradients, 2 steps against
  2 through ``step_plain`` from a copy of the state: p, mu and nu equal bit
  for bit after each, and its device count of skipped elements equal to the
  table gradient's zeros.

Prints one JSON line. ``chip_smoke.py`` runs ``run`` as a phase.
"""
from __future__ import annotations

import json
import os
import sys

import torch

from ..ops import adam, hash_encode, hash_gather, integrate
from .adam_check import PEAK_BYTES, _bits_equal, _copy, _events_ms, _host_us

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
YAML = os.path.join(ROOT, "nerf_tpu_torch", "configs", "lego_ngp.yaml")
N_POINTS = 1 << 18  # instant-ngp's target batch of samples
N_RAYS, N_VIEWS, SIZE, FOCAL, RADIUS = 4096, 8, 800, 1111.11, 4.0311


def ngp_state(dev, seed: int = 0):
    """(cfg, opts, optimizer, state) of the yaml's network on ``dev``, the
    table redrawn U(+-1) from ``seed``."""
    from ..config import make_cfg
    from ..render.renderer import RenderOptions
    from ..train import loop
    from ..train.optim import make_optimizer
    from ..train.state import init_state

    cfg = make_cfg(YAML, [])
    opts = RenderOptions.from_cfg(cfg)
    tx = make_optimizer(cfg)
    params = loop.init_nerf_params(torch.Generator().manual_seed(seed), opts, dev)
    table = params["coarse"]["xyz_encoder"]["table"]
    with torch.no_grad():
        table.uniform_(-1.0, 1.0, generator=torch.Generator(device=dev).manual_seed(seed + 1))
    return cfg, opts, tx, init_state(params, tx)


def geometry(opts):
    """(table shape, resolutions, ``hash_encode.Levels``) of the yaml's encoder."""
    from ..models.hashgrid import level_resolutions, table_shape

    shape = table_shape(opts.hash_levels, opts.hash_features, opts.hash_log2_size,
                        opts.hash_layout)
    res = level_resolutions(opts.hash_levels, opts.hash_base_res, opts.hash_scale)
    b = opts.hash_bound
    return shape, res, hash_encode.levels(res, shape[1], -b, b)


def rows(opts, dev, seed: int = 2):
    """The encoder's corner rows of N_POINTS random points of its box."""
    from ..models.hashgrid import hashgrid_index

    gen = torch.Generator(device=dev).manual_seed(seed)
    b = opts.hash_bound
    pts = torch.rand((N_POINTS, 3), generator=gen, device=dev) * (2 * b) - b
    shape, res, _ = geometry(opts)
    idx, _ = hashgrid_index(shape, pts, res, bbox_min=-b, bbox_max=b, layout=opts.hash_layout)
    return idx.contiguous()


def edge_values(lv: "hash_encode.Levels") -> torch.Tensor:
    """float32 coordinates where the encoder's float32 steps come closest to
    another choice: each level's cell faces lo + size k / res (k = 0, 1,
    res / 2, res - 1, res) and the floats on either side, the clamp's top and
    the box's far face with theirs, and points outside the box."""
    lo, hi = lv.bbox_min, lv.bbox_max
    vals = [lo + (hi - lo) * k / r for r in lv.res for k in (0, 1, r // 2, r - 1, r)]
    vals += [lo + (hi - lo) * hash_encode.TOP, lo - 1e-3, hi + 1e-3, 5 * lo, 5 * hi, 0.0, -0.0]
    v = torch.tensor(vals, dtype=torch.float32)
    return torch.cat([v, torch.nextafter(v, v - 1), torch.nextafter(v, v + 1)])


def encoder_points(lv: "hash_encode.Levels", dev, n: int, seed: int = 6) -> torch.Tensor:
    """n points [n, 3]: an eighth of them each coordinate drawn from
    ``edge_values``, the rest uniform over the box widened by a tenth."""
    gen = torch.Generator().manual_seed(seed)
    vals = edge_values(lv)
    n_edge = n // 8
    edge = vals[torch.randint(0, vals.numel(), (n_edge, 3), generator=gen)]
    lo, hi = lv.bbox_min, lv.bbox_max
    pad = 0.1 * (hi - lo)
    rest = torch.rand((n - n_edge, 3), generator=gen) * (hi - lo + 2 * pad) + (lo - pad)
    return torch.cat([edge, rest]).to(dev)


def check_hash(table: torch.Tensor, idx: torch.Tensor, seed: int = 3) -> dict:
    """B4 and B4' on ``table`` [rows, F] float32 at ``idx`` against their
    plain versions; raises on a difference."""
    got = hash_gather.gather_rows(table, idx)
    want = hash_gather.gather_rows_plain(table, idx)
    if not torch.equal(got, want):
        raise AssertionError("gather_rows differs from gather_rows_plain on the float32 table")
    del got, want
    gen = torch.Generator(device=table.device).manual_seed(seed)
    cot = torch.randn((idx.shape[0], table.shape[1]), generator=gen, device=table.device)
    got = hash_gather.scatter_add_rows(idx, cot, table.shape[0])
    ref = hash_gather.scatter_add_rows_plain(idx, cot, table.shape[0])
    tol = hash_gather.scatter_add_tolerance(idx, cot, ref)
    err = (got.double() - ref.double()).abs()
    worst = float((err / tol.clamp_min(1e-30)).max())
    if got.dtype != torch.float32 or worst > 1.0:
        raise AssertionError(f"scatter_add_rows: worst err / tolerance {worst:.3g}")
    return {"gather_rows": int(idx.shape[0]), "table_rows": int(table.shape[0]),
            "scatter_max_abs_err": float(err.max()), "scatter_worst_over_tol": worst}


def views(dev, seed: int = 4):
    """N_VIEWS seeded uint8 noise views on a horizontal orbit, their poses, K."""
    from ..data.synthetic import _orbit_pose

    gen = torch.Generator(device=dev).manual_seed(seed)
    images = torch.randint(0, 256, (N_VIEWS, SIZE, SIZE, 3), generator=gen, device=dev,
                           dtype=torch.uint8)
    poses = torch.stack([torch.from_numpy(_orbit_pose(6.2832 * i / N_VIEWS, RADIUS))
                         for i in range(N_VIEWS)]).to(dev)
    K = torch.tensor([[FOCAL, 0.0, SIZE / 2], [0.0, FOCAL, SIZE / 2], [0.0, 0.0, 1.0]],
                     device=dev)
    return images, poses, K


STEP_KERNELS = (hash_gather.gather_rows, hash_gather.scatter_add_rows, integrate.integrate,
                adam.adam, hash_encode.hash_index, hash_encode.hash_interp,
                hash_encode.hash_interp_bwd)


def _zero_launches():
    for fn in STEP_KERNELS:
        fn.launches = 0


def _launches(fns) -> dict:
    return {fn.__name__: fn.launches for fn in fns}


def check_encoder(table: torch.Tensor, pts: torch.Tensor, opts, seed: int = 7) -> dict:
    """The hash encoder's kernels against the PyTorch path and their plain
    versions on ``table`` [L, T, F] (see the module's note); raises on a
    difference."""
    from ..models import hashgrid

    shape, res, lv = geometry(opts)
    L, T, F = shape
    b = opts.hash_bound
    idx = hash_encode.hash_index(pts, lv)
    want, _ = hashgrid.hashgrid_index(shape, pts, res, -b, b, "corner")
    if not torch.equal(idx, want):
        bad = int((idx != want).sum())
        raise AssertionError(f"hash_index differs from the PyTorch path at {bad} rows")
    rows_ = hash_gather.gather_rows(table.reshape(L * T, F), idx)
    feats = hash_encode.hash_interp(rows_, pts, lv)
    if not torch.equal(feats, hash_encode.hash_interp_plain(rows_, pts, lv)):
        raise AssertionError("hash_interp differs from hash_interp_plain")
    with torch.no_grad():
        torch_feats = hashgrid.encode_torch(table, pts, res, -b, b, "corner", False)
    tol = hash_encode.interp_tolerance(rows_, pts, lv)
    err = (feats - torch_feats).abs()
    interp_worst = float((err / tol.clamp_min(1e-30)).max())
    if interp_worst > 1.0:
        raise AssertionError(f"hash_interp: worst err / interp_tolerance {interp_worst:.3g}")
    del rows_, torch_feats, tol
    g = torch.randn(feats.shape, generator=torch.Generator(device=pts.device).manual_seed(seed),
                    device=pts.device)
    cot = hash_encode.hash_interp_bwd(g, pts, lv, table.dtype)
    if not torch.equal(cot, hash_encode.hash_interp_bwd_plain(g, pts, lv, table.dtype)):
        raise AssertionError("hash_interp_bwd differs from hash_interp_bwd_plain")
    leaf = table.clone().requires_grad_(True)
    fns = STEP_KERNELS[:2] + STEP_KERNELS[4:]
    _zero_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = hashgrid.encode_fused(leaf, pts, lv)
        forward = _launches(fns)
        (grad,) = torch.autograd.grad(out, leaf, g)
        backward = {k: v - forward[k] for k, v in _launches(fns).items()}
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if forward != {"gather_rows": 1, "scatter_add_rows": 0, "hash_index": 1, "hash_interp": 1,
                   "hash_interp_bwd": 0} or backward != {
                       "gather_rows": 0, "scatter_add_rows": 1, "hash_index": 0,
                       "hash_interp": 0, "hash_interp_bwd": 1}:
        raise AssertionError(f"encode_fused launched {forward} forward, {backward} backward")
    if not torch.equal(out, feats):
        raise AssertionError("encode_fused's features differ from its kernels'")
    ref = hash_gather.scatter_add_rows_plain(idx, cot, L * T)
    gtol = hash_gather.scatter_add_tolerance(idx, cot, ref)
    gworst = float(((grad.reshape(ref.shape).double() - ref.double()).abs()
                    / gtol.clamp_min(1e-30)).max())
    if gworst > 1.0:
        raise AssertionError(f"encode_fused's table gradient: worst err / tolerance {gworst:.3g}")
    return {"points": int(pts.shape[0]), "rows": int(idx.shape[0]),
            "interp_max_abs_err": float(err.max()), "interp_worst_over_tol": interp_worst,
            "grad_worst_over_tol": gworst, "forward": forward, "backward": backward}


def encoder_times(table: torch.Tensor, pts: torch.Tensor, opts, reps: int = 20) -> dict:
    """Each kernel's ms a launch by CUDA events, its byte bound's ms
    (``hash_encode.encoder_bytes`` at 3.35 TB/s) and its plain version's ms
    (``hash_index_plain`` is the PyTorch path's ``hashgrid_index``; the
    interpolation's and its backward's share of ``encode_torch`` is timed
    whole, below); then
    the encoder's forward, and forward and backward, through
    ``encode_fused`` and ``encode_torch`` (B4 and B4' on both), in turns
    (fused, torch, torch, fused), with the host's us a call of each."""
    from ..models import hashgrid

    shape, res, lv = geometry(opts)
    L, T, F = shape
    b = opts.hash_bound
    idx = hash_encode.hash_index(pts, lv)
    rows_ = hash_gather.gather_rows(table.reshape(L * T, F), idx)
    g = torch.randn((pts.shape[0], L * F), device=pts.device)
    nbytes = hash_encode.encoder_bytes(pts.shape[0], lv, F, table.element_size())
    calls = {
        "hash_index": (lambda: hash_encode.hash_index(pts, lv),
                       lambda: hash_encode.hash_index_plain(pts, lv)),
        "hash_interp": (lambda: hash_encode.hash_interp(rows_, pts, lv),
                        lambda: hash_encode.hash_interp_plain(rows_, pts, lv)),
        "hash_interp_bwd": (lambda: hash_encode.hash_interp_bwd(g, pts, lv, table.dtype),
                            lambda: hash_encode.hash_interp_bwd_plain(g, pts, lv, table.dtype))}
    out = {}
    for name, (kernel, plain) in calls.items():
        kernel()
        ms = _events_ms(kernel, reps)
        bound = nbytes[name] / PEAK_BYTES * 1e3
        out[name] = {"ms": ms, "bound_ms": bound, "share_of_bound": bound / ms,
                     "plain_ms": _events_ms(plain, 3), "bytes": nbytes[name]}
    del rows_
    leaf = table.clone().requires_grad_(True)
    paths = {"fused": lambda: hashgrid.encode_fused(leaf, pts, lv),
             "torch": lambda: hashgrid.encode_torch(leaf, pts, res, -b, b, "corner", False)}

    def fwd_bwd(path):
        return lambda: torch.autograd.grad(paths[path](), leaf, g)

    enc = {}
    for path in ("fused", "torch", "torch", "fused"):
        with torch.no_grad():
            fwd = _events_ms(paths[path], reps)
        row = enc.setdefault(path, {"fwd_ms": [], "fwd_bwd_ms": [], "host_us": []})
        row["fwd_ms"].append(fwd)
        row["fwd_bwd_ms"].append(_events_ms(fwd_bwd(path), reps))
        row["host_us"].append(_host_us(fwd_bwd(path), reps))
    out["encoder"] = {p: {k: sum(v) / len(v) for k, v in row.items()} for p, row in enc.items()}
    return out




def step_launches(opts, tx, state, data, grid, gen) -> dict:
    """The kernels one train step launches, counters zeroed just before it."""
    from ..train.state import train_step

    train_step(state, *data, tx, opts, N_RAYS, grid=grid, generator=gen)  # warm-up
    torch.cuda.synchronize()
    _zero_launches()
    train_step(state, *data, tx, opts, N_RAYS, grid=grid, generator=gen)
    torch.cuda.synchronize()
    got = _launches(STEP_KERNELS)
    if any(v != 1 for v in got.values()):
        raise AssertionError(f"an Instant-NGP train step launched {got}, not one of each")
    return got


def check_adam(opts, tx, state, data, grid, gen, steps: int = 2) -> dict:
    """The Adam kernel with the rules against ``step_plain`` on one batch's
    gradients (see the module's note)."""
    from ..train.state import loss_and_grads, sample_ray_batch
    from ..tree import tree_leaves
    from ..utils import profiling

    ro, rd, tgt = sample_ray_batch(gen, *data, N_RAYS)
    _, _, grads = loss_and_grads(state.params, ro, rd, tgt, opts, grid, gen)
    params = [p.detach() for p in tree_leaves(state.params)]
    zeros = int((grads[-1] == 0).sum())
    kp, ks = _copy(params, state.opt_state)
    lp, ls = _copy(params, state.opt_state)
    skipped = []
    for i in range(steps):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            profiling.reset()
            tx.step(kp, grads, ks)
            torch.cuda.synchronize()
            counts = profiling.counters()
        tx.step_plain(lp, grads, ls)
        torch.cuda.synchronize()
        for name, a, b in (("p", kp, lp), ("mu", ks.mu, ls.mu), ("nu", ks.nu, ls.nu)):
            if not _bits_equal(a, b):
                raise AssertionError(f"adam kernel with the rules, step {i + 1}: {name} "
                                     f"differs from step_plain")
        if counts.get("adam.skipped") != zeros:
            raise AssertionError(f"adam.skipped {counts.get('adam.skipped')}, the table "
                                 f"gradient has {zeros} zeros")
        skipped.append(counts["adam.skipped"])
    return {"leaves": len(params), "elements": sum(p.numel() for p in params),
            "table_zero_grads": zeros, "skipped": skipped}


def encoder(dev) -> dict:
    """``check_encoder`` and ``encoder_times`` on the seeded state's table at
    N_POINTS ``encoder_points``."""
    _, opts, _, state = ngp_state(dev)
    table = state.params["coarse"]["xyz_encoder"]["table"].detach()
    pts = encoder_points(geometry(opts)[2], dev, N_POINTS)
    return {"check": check_encoder(table, pts, opts), "times": encoder_times(table, pts, opts)}


def run(dev) -> dict:
    cfg, opts, tx, state = ngp_state(dev)
    table = state.params["coarse"]["xyz_encoder"]["table"].detach()
    out = {"hash": check_hash(table.reshape(-1, table.shape[-1]), rows(opts, dev))}
    from ..render import occupancy as occ

    gen = torch.Generator(device=dev).manual_seed(5)
    grid = occ.init_grid(int(cfg.get("occupancy_grid_resolution", 128)),
                         generator=torch.Generator(device=dev).manual_seed(6), device=dev)
    data = views(dev)
    out["launches"] = step_launches(opts, tx, state, data, grid, gen)
    out["adam"] = check_adam(opts, tx, state, data, grid, gen)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("ngp_check: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(json.dumps({"encoder": encoder(dev)}), flush=True)
    print(json.dumps(run(dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
