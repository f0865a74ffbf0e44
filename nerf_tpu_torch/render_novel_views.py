"""Novel-view CLI; counterpart of the top-level ``render_novel_views.py``.

    python -m nerf_tpu_torch.render_novel_views --cfg_file configs/nerf/lego.yaml \\
        [--device cpu] [render_type spiral|original] [render_num 120] [fps 24]

Renders the spiral round the test cameras (``render/spiral.py``) or the test
cameras themselves, then writes the frames and the rgb and disparity videos
under ``result_dir`` (``eval/video.py``).
"""
from __future__ import annotations

import argparse
import sys

import torch

from .config import make_cfg
from .data import make_dataset
from .device import resolve_device
from .eval.video import render_novel_view_sequence
from .render.spiral import generate_spiral_poses
from .run import frame_renderer, load_eval_model


def main(argv=None):
    parser = argparse.ArgumentParser(description="nerf_tpu_torch novel views")
    parser.add_argument("--cfg_file", default=None)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)
    cfg = make_cfg(args.cfg_file, args.opts)
    dev = resolve_device(args.device)
    opts, params, grid = load_eval_model(cfg, dev)
    ds = make_dataset(cfg, "test")
    n_frames = int(cfg.get("render_num", 120))
    if cfg.get("render_type", "spiral") == "spiral":
        poses, tag = generate_spiral_poses(ds.poses, n_frames), "spiral"
    else:
        poses, tag = ds.poses[:n_frames], "original"
    render_fn = frame_renderer(params, torch.as_tensor(ds.K, device=dev), ds.H, ds.W, opts,
                               grid, dev)
    paths = render_novel_view_sequence(render_fn, poses, cfg.result_dir,
                                       fps=int(cfg.get("fps", 24)), tag=tag)
    print(f"done: {paths}")
    return paths


if __name__ == "__main__":
    main(sys.argv[1:])
