"""COLMAP sparse model -> NeRF ``transforms.json``; counterpart of ``scripts/colmap2nerf.py``.

    python -m nerf_tpu_torch.colmap2nerf --model_dir sparse/0 --images images \\
        --out transforms.json [--aabb_scale 4] [--keep_colmap_coords]

Reads a COLMAP model (``utils/colmap.py``, .bin or .txt), flips its camera
axes to NeRF's (+X right, +Y up, +Z back), recentres the cameras on their
mean position and scales their mean distance from it to 4, and writes
``transforms.json`` with camera_angle_x/y, the intrinsics and one
transform_matrix a frame, frames sorted by image name. ``file_path`` is
``<images>/<name without extension>``, as the Blender loader reads it
(``<data_root>/<scene>/<file_path>.png``). Host only.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from .utils.colmap import image_c2w, read_model

# one focal length, then cx, cy; every other model starts fx, fy, cx, cy
_SINGLE_FOCAL = ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL", "SIMPLE_RADIAL_FISHEYE",
                 "RADIAL_FISHEYE")


def transforms_from_model(model_dir: str, images: str = "images", aabb_scale: int = 4,
                          keep_colmap_coords: bool = False) -> dict:
    """The ``transforms.json`` content of the model in ``model_dir``."""
    cams, imgs, _ = read_model(model_dir)
    cam = next(iter(cams.values()))
    if cam.model in _SINGLE_FOCAL:
        fx = fy = cam.params[0]
        cx, cy = cam.params[1], cam.params[2]
    else:
        fx, fy, cx, cy = cam.params[:4]
    frames, c2ws = [], []
    for im in sorted(imgs.values(), key=lambda im: im.name):
        c2w = image_c2w(im)
        if not keep_colmap_coords:
            # COLMAP: +Z forward, +Y down -> NeRF/OpenGL: -Z forward, +Y up
            c2w[0:3, 1] *= -1
            c2w[0:3, 2] *= -1
        c2ws.append(c2w)
        frames.append({"file_path": os.path.join(images, os.path.splitext(im.name)[0]),
                       "transform_matrix": c2w})
    if not keep_colmap_coords and c2ws:
        centers = np.stack([m[:3, 3] for m in c2ws])
        center = centers.mean(axis=0)
        scale = 4.0 / max(np.linalg.norm(centers - center, axis=1).mean(), 1e-8)
        for fr in frames:
            m = fr["transform_matrix"]
            m[:3, 3] = (m[:3, 3] - center) * scale
    return {
        "camera_angle_x": float(2 * np.arctan(cam.width / (2 * fx))),
        "camera_angle_y": float(2 * np.arctan(cam.height / (2 * fy))),
        "fl_x": float(fx), "fl_y": float(fy), "cx": float(cx), "cy": float(cy),
        "w": int(cam.width), "h": int(cam.height), "aabb_scale": aabb_scale,
        "frames": [{"file_path": fr["file_path"],
                    "transform_matrix": fr["transform_matrix"].tolist()} for fr in frames],
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="COLMAP model -> transforms.json")
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--images", default="images")
    parser.add_argument("--out", default="transforms.json")
    parser.add_argument("--aabb_scale", type=int, default=4)
    parser.add_argument("--keep_colmap_coords", action="store_true")
    args = parser.parse_args(argv)
    out = transforms_from_model(args.model_dir, args.images, args.aabb_scale,
                                args.keep_colmap_coords)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.out}: {len(out['frames'])} frames, "
          f"camera_angle_x={out['camera_angle_x']:.4f}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
