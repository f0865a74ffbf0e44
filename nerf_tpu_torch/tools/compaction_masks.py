"""What compaction keeps and costs on the lego model: the fine pass's mask
three ways, and the marched renderer's blocks, at 800x800 on the GPU.

    python -m nerf_tpu_torch.tools.compaction_masks

For two poses on the orbit (r = 4, phi = 0.45, lego's camera_angle_x; the
committed epoch-49 checkpoint, its ESS grid rebuilt at R = 128) it renders
the dense hierarchical frame, then the compacted one with each fine-pass
mask and prints the mask's kept rate on the middle 4,096 rays, the
compacted frame's PSNR against the dense one, its pixels more than 0.05
off, and both frame times:
  coarse T after   the JAX package's mask (renderer.py:335-357): occupied,
                   and 1 - the coarse weights summed up to and including
                   the coarse sample before the fine one >= ert_threshold;
  coarse T before  the same summed up to the sample before that one;
  occupancy        the port's ``fine_pass_mask``: occupied.
The fraction is 1.25 x the kept rate, at most 0.99. Then the kept rate
per render tile (occupancy) and, for the marched renderer with and without
refocus, per 16,384-ray block, and its compacted frames at fractions 0.3,
0.5 and 1 against its dense frame. Times by the host clock around a
synchronized frame; the card's name and power limit head the output.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import subprocess
import time

import numpy as np
import torch

from ..config import make_cfg
from ..ops import build
from ..render import marched
from ..render import occupancy as occ
from ..render import renderer as rend
from ..render.rays import image_rays
from ..run import load_eval_model
from ..serve import look_at_pose

SIZE = 800
CAMERA_ANGLE_X = 0.6911112070083618


def _coarse_t_mask(before: int):
    """The JAX package's mask (before=1), or T read one coarse sample
    earlier (before=2)."""
    def mask_fn(grid, pts_f, z_vals, z_all, coarse_weights, opts):
        mask = occ.query(grid, pts_f.reshape(-1, 3)).reshape(z_all.shape)
        cum_w = torch.cumsum(coarse_weights, dim=-1)
        idx = torch.searchsorted(z_vals.contiguous(), z_all.contiguous(), side="left")
        t_est = 1.0 - torch.gather(cum_w, -1, (idx - before).clamp_min(0))
        t_est = torch.where(idx >= before, t_est, torch.ones_like(t_est))
        return mask & (t_est >= opts.ert_threshold)

    return mask_fn


def _occupancy(grid, pts_f, z_vals, z_all, coarse_weights, opts):
    """``rend.fine_pass_mask``, the port's (which the hook below replaces)."""
    return occ.query(grid, pts_f.reshape(-1, 3)).reshape(z_all.shape)


MASKS = {"coarse T after": _coarse_t_mask(1), "coarse T before": _coarse_t_mask(2),
         "occupancy": _occupancy}


def _timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _psnr(a, b):
    return -10.0 * math.log10(max(float(((a - b) ** 2).mean()), 1e-20))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("compaction_masks: needs a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    build.build()
    dev = torch.device("cuda")
    opts, params, grid = load_eval_model(
        make_cfg("configs/nerf/lego.yaml", ["trained_model_dir", "checkpoints/nerf/lego/nerf"]),
        dev)
    f = 0.5 * SIZE / math.tan(0.5 * CAMERA_ANGLE_X)
    K = torch.tensor([[f, 0, SIZE / 2], [0, f, SIZE / 2], [0, 0, 1.0]], device=dev)

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    for theta in (0.15, 1.7):
        pose = torch.as_tensor(look_at_pose(theta, 0.45, 4.0), device=dev)

        def frame(o):
            return rend.render_image(params, pose, K, SIZE, SIZE, o, grid=grid,
                                     generator=gen())["rgb_map"]

        frame(opts)
        dense, dense_ms = _timed(lambda: frame(opts))
        print(f"theta {theta}: dense frame {dense_ms:.1f} ms", flush=True)
        ro, rd = image_rays(SIZE, SIZE, K, pose)
        mid = SIZE * SIZE // 2
        po, pd = ro[mid - 2048:mid + 2048].contiguous(), rd[mid - 2048:mid + 2048].contiguous()
        out = rend.render_rays(params, po, pd, opts, grid=grid, generator=gen())
        pts = po[:, None] + pd[:, None] * out["fine_z_vals"][..., None]
        n_tile = opts.tile_rays * out["fine_z_vals"].shape[1]
        for name, fn in MASKS.items():
            kept = float(fn(grid, pts, out["coarse_z_vals"], out["fine_z_vals"],
                            out["coarse_weights"], opts).float().mean())
            frac = min(0.99, rend.compaction_capacity(n_tile, 1.25 * kept) / n_tile)
            co = dataclasses.replace(opts, ess_compaction=frac)
            with _fine_mask(fn, opts, pose[:3, 3]):
                frame(co)
                comp, comp_ms = _timed(lambda: frame(co))
            bad = int(((comp - dense).abs().amax(-1) > 0.05).sum())
            print(f"  {name:>15}: kept {kept:.4f}, fraction {frac:.4f}: PSNR "
                  f"{_psnr(comp, dense):.2f} dB from dense, {bad} px > 0.05 off, frame "
                  f"{comp_ms:.1f} ms", flush=True)

    pose = torch.as_tensor(look_at_pose(0.15, 0.45, 4.0), device=dev)
    ro, rd = image_rays(SIZE, SIZE, K, pose)
    tiles = []
    for t0 in range(0, SIZE * SIZE, opts.tile_rays):
        o, d = ro[t0:t0 + opts.tile_rays].contiguous(), rd[t0:t0 + opts.tile_rays].contiguous()
        out = rend.render_rays(params, o, d, opts, grid=grid, generator=gen())
        pts = o[:, None] + d[:, None] * out["fine_z_vals"][..., None]
        tiles.append(float(rend.fine_pass_mask(grid, pts).float().mean()))
    print(f"hierarchical, occupancy kept per tile: max {max(tiles):.4f}, mean "
          f"{np.mean(tiles):.4f}", flush=True)
    real_query = marched.query_masked_compacted
    for refocus in (True, False):
        def mframe(o):
            return marched.render_image_marched(params, pose, K, SIZE, SIZE, o, grid=grid,
                                                refocus=refocus)["rgb_map"]

        kept = []

        def spy(p, pts_, vd, o, mask, cap):
            kept.append(float(mask.float().mean()))
            return real_query(p, pts_, vd, o, mask, cap)

        marched.query_masked_compacted = spy
        try:
            mframe(dataclasses.replace(opts, ess_compaction=1.0))
        finally:
            marched.query_masked_compacted = real_query
        mframe(opts)
        dense, dense_ms = _timed(lambda: mframe(opts))
        print(f"marched, refocus {refocus}: kept per block max {max(kept):.4f}, mean "
              f"{np.mean(kept):.4f} ({len(kept)} blocks); dense frame {dense_ms:.1f} ms",
              flush=True)
        for frac in (0.3, 0.5, 1.0):
            co = dataclasses.replace(opts, ess_compaction=frac)
            comp, comp_ms = _timed(lambda: mframe(co))
            print(f"  fraction {frac}: PSNR {_psnr(comp, dense):.2f} dB from dense, frame "
                  f"{comp_ms:.1f} ms", flush=True)


@contextlib.contextmanager
def _fine_mask(fn, opts, cam):
    """The renderer's fine-pass mask replaced by ``fn``: each tile's coarse
    z values and weights are caught from its coarse composite, and the fine
    z values are the samples' distances from the camera (unit directions)."""
    real_mask, real_composite = rend.fine_pass_mask, rend._composite
    coarse = {}

    def composite(raw, z_vals, rays_d, o, generator):
        res = real_composite(raw, z_vals, rays_d, o, generator)
        if z_vals.shape[1] == opts.n_samples:
            coarse.update(z=z_vals, w=res["weights"])
        return res

    def mask(grid, pts_f):
        return fn(grid, pts_f, coarse["z"], (pts_f - cam).norm(dim=-1), coarse["w"], opts)

    rend.fine_pass_mask, rend._composite = mask, composite
    try:
        yield
    finally:
        rend.fine_pass_mask, rend._composite = real_mask, real_composite


if __name__ == "__main__":
    main()
