"""Mesh extraction CLI; counterpart of ``scripts/extract_mesh.py``.

    python -m nerf_tpu_torch.extract_mesh --cfg_file configs/nerf/lego.yaml \\
        [--device cpu] [mesh.level 5.0] [mesh.resolution 128] [mesh.out lego.ply]

Reads the checkpoint in ``trained_model_dir`` (``run.load_eval_model``),
evaluates the fine model's density (``renderer.make_density_fn``, the
function ``train.loop.make_density_fn`` builds; on the card the fused
forward kernel) on a resolution^3 lattice over [-2, 2]^3 in chunks of
``CHUNK`` points, and writes the iso-surface at ``level``
(``utils/mesh.py``, marching tetrahedra on the host) as PLY, or OBJ where
``mesh.out`` ends in ``.obj``. ``level`` and ``resolution`` may also be
given at the top level, as in the JAX package.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .config import make_cfg
from .device import resolve_device
from .render.renderer import make_density_fn
from .run import load_eval_model
from .utils.mesh import extract_mesh, save_obj, save_ply

# lattice points per density call: 2048 of the fused kernel's 128-point tiles
CHUNK = 262144
BBOX = ((-2.0, -2.0, -2.0), (2.0, 2.0, 2.0))


def mesh_settings(cfg):
    """(level, resolution, output path), as ``scripts/extract_mesh.py`` reads them."""
    node = cfg.get("mesh", {}) or {}
    level = float(node.get("level", cfg.get("level", 5.0)))
    res = int(node.get("resolution", cfg.get("resolution", 128)))
    out = str(node.get("out", os.path.join(cfg.result_dir, "mesh.ply")))
    return level, res, out


def density_query(cfg, device: torch.device):
    """numpy [M, 3] -> numpy [M] density of the checkpoint's fine model."""
    cfg = cfg.clone()
    cfg["enable_ess"] = False  # the lattice needs no ESS grid
    opts, params, _ = load_eval_model(cfg, device)
    density = make_density_fn(params["fine"], opts)

    def query(pts: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return density(torch.from_numpy(pts).to(device)).float().cpu().numpy()

    return query


def main(argv=None):
    parser = argparse.ArgumentParser(description="nerf_tpu_torch mesh extraction")
    parser.add_argument("--cfg_file", default=None)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)
    cfg = make_cfg(args.cfg_file, args.opts)
    dev = resolve_device(args.device)
    level, res, out = mesh_settings(cfg)
    query = density_query(cfg, dev)
    t0 = time.perf_counter()
    verts, faces = extract_mesh(query, level=level, bbox=BBOX, resolution=res, chunk=CHUNK)
    seconds = time.perf_counter() - t0
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    (save_obj if out.endswith(".obj") else save_ply)(out, verts, faces)
    print(f"mesh: {len(verts)} verts, {len(faces)} faces -> {out} "
          f"(resolution {res}, level {level}, {seconds:.2f} s on {dev.type})", flush=True)
    return verts, faces


if __name__ == "__main__":
    main(sys.argv[1:])
