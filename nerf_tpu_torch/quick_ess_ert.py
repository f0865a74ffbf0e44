"""Quick ESS/ERT smoke test; counterpart of the top-level ``quick_test_ess_ert.py``.

    python -m nerf_tpu_torch.quick_ess_ert [--device cpu]

No checkpoint and no dataset: lego-shaped float32 weights from
``init_nerf_params`` (seed 0, so the card runs the float32 fused kernel),
the seed ESS grid (``init_grid``, seed 1), a pose at z = 4. Renders at 100x100
and then 50x50 (finite, of the right shape), then a mini comparison at
100x100: the baseline (no ESS, no ERT) and ESS + ERT, each timed on its
second render. Raises on a failed check.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from .device import resolve_device
from .render import occupancy as occ
from .render.renderer import RenderOptions, kernel_params, render_image
from .train.loop import init_nerf_params
from .tree import tree_map

SIZES = (100, 50)  # the renders checked; the comparison is at the first
OPTS = RenderOptions(compute_dtype="float32", tile_rays=4096)  # lego's shape, float32


def _K(size: int, dev) -> torch.Tensor:
    f = 1.4 * size
    return torch.tensor([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]], dtype=torch.float32,
                        device=dev)


def run_checks(device=None) -> dict:
    """The checks and the mini comparison; returns {"ranges": {size: rgb
    range}, "seconds": {"baseline", "ess+ert"}}."""
    dev = resolve_device(device)
    sizes, opts = SIZES, OPTS
    tree = tree_map(lambda t: t.detach().cpu().numpy(),
                    init_nerf_params(torch.Generator().manual_seed(0), opts))
    params = kernel_params(tree, opts, dev)
    grid = occ.init_grid(generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    pose = torch.eye(4, device=dev)
    pose[2, 3] = 4.0

    def render(o, size, g, seed):
        out = render_image(params, pose, _K(size, dev), size, size, o, grid=g,
                           generator=torch.Generator(device=dev).manual_seed(seed))
        return out["rgb_map"].cpu()  # a host copy: the frame is done

    ranges = {}
    for size in sizes:
        rgb = render(opts, size, grid, 0)
        ok = bool(torch.isfinite(rgb).all()) and tuple(rgb.shape) == (size, size, 3)
        print(f"{'✓' if ok else '✗'} {size}x{size} render: shape {tuple(rgb.shape)}, "
              f"range [{float(rgb.min()):.3f}, {float(rgb.max()):.3f}]", flush=True)
        if not ok:
            raise RuntimeError(f"{size}x{size} render is not finite [{size}, {size}, 3]")
        ranges[size] = (float(rgb.min()), float(rgb.max()))

    times = {}
    for name, ess, ert in (("baseline", False, False), ("ess+ert", True, True)):
        o = dataclasses.replace(opts, enable_ess=ess, enable_ert=ert)
        g = grid if ess else None
        render(o, sizes[0], g, 0)
        t0 = time.perf_counter()
        render(o, sizes[0], g, 1)
        times[name] = time.perf_counter() - t0
        print(f"✓ {name}: {times[name]:.3f}s", flush=True)
    print("✓ all quick ESS/ERT checks passed", flush=True)
    return {"ranges": ranges, "seconds": times}


def main(argv=None):
    parser = argparse.ArgumentParser(description="nerf_tpu_torch quick ESS/ERT check")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return run_checks(parser.parse_args(argv).device)


if __name__ == "__main__":
    main(sys.argv[1:])
