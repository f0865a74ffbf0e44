"""Images -> video CLI; counterpart of the top-level ``create_video_from_images.py``.

    python -m nerf_tpu_torch.create_video_from_images --image_dir <dir> \\
        [--mode pred|gt|comparison] [--output out.mp4] [--fps 24] [--pattern "view*_pred.png"]

Builds a video from the evaluator's images (``view{NNN}_{pred,gt}.png``):
the predictions, the ground truth, or both side by side, read with the
port's PNG decoder and written by ``eval/video.write_video``.
"""
from __future__ import annotations

import argparse
import glob
import os
import re
import sys

import numpy as np

from .eval.video import create_comparison_video, write_video
from .utils.png import read_png


def load_frames(image_dir: str, pattern: str) -> np.ndarray:
    """[N, H, W, 3] uint8 of the files matching ``pattern``, in natural order."""
    files = sorted(glob.glob(os.path.join(image_dir, pattern)),
                   key=lambda p: [int(t) if t.isdigit() else t
                                  for t in re.split(r"(\d+)", os.path.basename(p))])
    if not files:
        raise FileNotFoundError(f"no images matching {pattern} in {image_dir}")
    return np.stack([read_png(f)[..., :3] for f in files])


def main(argv=None):
    parser = argparse.ArgumentParser(description="nerf_tpu_torch images to video")
    parser.add_argument("--image_dir", required=True)
    parser.add_argument("--mode", default="pred", choices=["pred", "gt", "comparison"])
    parser.add_argument("--output", default=None)
    parser.add_argument("--fps", type=int, default=24)
    parser.add_argument("--pattern", default=None)
    args = parser.parse_args(argv)
    out = args.output or os.path.join(args.image_dir, f"{args.mode}.mp4")
    if args.mode == "comparison":
        pred = load_frames(args.image_dir, args.pattern or "view*_pred.png")
        gt = load_frames(args.image_dir, "view*_gt.png")
        n = min(len(pred), len(gt))
        written = create_comparison_video(pred[:n], gt[:n], out, fps=args.fps)
    else:
        frames = load_frames(args.image_dir, args.pattern or f"view*_{args.mode}.png")
        n = len(frames)
        written = write_video(frames, out, fps=args.fps)
    print(f"wrote {written} ({n} frames @ {args.fps} fps)")
    return written


if __name__ == "__main__":
    main(sys.argv[1:])
