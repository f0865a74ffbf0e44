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
- one train step of 4,096 rays x 64 samples (``train_step``, on seeded
  800x800 noise views and the trainer's seed ESS grid) after a warm-up step,
  with the launch counters zeroed just before it: one launch each of B4,
  B4', B3 and the Adam kernel;
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

from ..ops import adam, hash_gather, integrate
from .adam_check import _bits_equal, _copy

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


def rows(opts, dev, seed: int = 2):
    """The encoder's corner rows of N_POINTS random points of its box."""
    from ..models.hashgrid import hashgrid_index, level_resolutions, table_shape

    gen = torch.Generator(device=dev).manual_seed(seed)
    b = opts.hash_bound
    pts = torch.rand((N_POINTS, 3), generator=gen, device=dev) * (2 * b) - b
    shape = table_shape(opts.hash_levels, opts.hash_features, opts.hash_log2_size,
                        opts.hash_layout)
    res = level_resolutions(opts.hash_levels, opts.hash_base_res, opts.hash_scale)
    idx, _ = hashgrid_index(shape, pts, res, bbox_min=-b, bbox_max=b, layout=opts.hash_layout)
    return idx.contiguous()


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


def _zero_launches():
    for fn in (hash_gather.gather_rows, hash_gather.scatter_add_rows, integrate.integrate,
               adam.adam):
        fn.launches = 0


def step_launches(opts, tx, state, data, grid, gen) -> dict:
    """The kernels one train step launches, counters zeroed just before it."""
    from ..train.state import train_step

    train_step(state, *data, tx, opts, N_RAYS, grid=grid, generator=gen)  # warm-up
    torch.cuda.synchronize()
    _zero_launches()
    train_step(state, *data, tx, opts, N_RAYS, grid=grid, generator=gen)
    torch.cuda.synchronize()
    got = {"gather_rows": hash_gather.gather_rows.launches,
           "scatter_add_rows": hash_gather.scatter_add_rows.launches,
           "integrate": integrate.integrate.launches, "adam": adam.adam.launches}
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
    print(json.dumps(run(torch.device("cuda"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
