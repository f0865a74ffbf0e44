"""Novel-view sequences and video files; counterpart of ``nerf_tpu/eval/video.py``.

``write_video`` tries imageio (mp4 through ffmpeg, quality 8, macro block 16),
then OpenCV's mp4v writer, as the JAX package does. Where neither can write
(the card's machine has neither package), it writes the same frames as an
uncompressed AVI (RIFF, 24-bit bottom-up DIB frames, an idx1 index) beside
the requested name with the suffix ``.avi``, and says which file it wrote.

``render_novel_view_sequence`` writes ``frames/view%04d_rgb.png`` (the port's
PNG encoder) and an rgb and a disparity video. A frame that fails to render
raises: the JAX package's black-frame fallback is not kept, because on the
card a caught CUDA fault leaves the context broken and would hide a kernel's
failure behind black frames.
"""
from __future__ import annotations

import os
import struct
from typing import Callable, Dict

import numpy as np

from ..utils.png import write_png


def _avi(frames: np.ndarray, fps: int) -> bytes:
    """[N, H, W, 3] uint8 RGB -> an uncompressed AVI file's bytes."""
    n, h, w, _ = frames.shape
    stride = (3 * w + 3) & ~3
    size = stride * h

    def chunk(tag: bytes, data: bytes) -> bytes:
        return tag + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)

    def riff_list(kind: bytes, tag: bytes, data: bytes) -> bytes:
        return kind + struct.pack("<I", len(data) + 4) + tag + data

    avih = struct.pack("<14I", round(1e6 / fps), size * fps, 0, 0x10, n, 0, 1, size, w, h,
                       0, 0, 0, 0)
    strh = (b"vidsDIB " + struct.pack("<IHHIIIIIIiI", 0, 0, 0, 0, 1, fps, 0, n, size, -1, 0)
            + struct.pack("<4h", 0, 0, w, h))
    strf = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, size, 0, 0, 0, 0)
    hdrl = riff_list(b"LIST", b"hdrl", chunk(b"avih", avih) + riff_list(
        b"LIST", b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi, index, offset = [], [], 4  # offsets from the "movi" tag
    for f in frames:
        dib = np.zeros((h, stride), np.uint8)
        dib[:, :3 * w] = f[::-1, :, ::-1].reshape(h, 3 * w)  # bottom-up rows, BGR
        movi.append(chunk(b"00db", dib.tobytes()))
        index.append(b"00db" + struct.pack("<III", 0x10, offset, size))
        offset += 8 + size
    body = hdrl + riff_list(b"LIST", b"movi", b"".join(movi)) + chunk(b"idx1", b"".join(index))
    return riff_list(b"RIFF", b"AVI ", body)


def write_video(frames: np.ndarray, path: str, fps: int = 24) -> str:
    """frames: [N, H, W, 3] float in [0, 1] or uint8. Returns the path written."""
    if len(frames) == 0:
        raise ValueError(f"no frames for {path}")
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(path, frames, fps=fps, quality=8, macro_block_size=16)
        return path
    except (ImportError, ValueError, RuntimeError, OSError):  # no imageio, or no ffmpeg
        pass
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        h, w = frames.shape[1:3]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if vw.isOpened():
            for frame in frames:
                vw.write(np.ascontiguousarray(frame[..., ::-1]))  # RGB -> BGR
            vw.release()
            return path
    avi = os.path.splitext(path)[0] + ".avi"
    with open(avi, "wb") as f:
        f.write(_avi(frames, fps))
    print(f"wrote {avi}: uncompressed AVI, {len(frames)} frames (no imageio or cv2 "
          f"writer for {path})", flush=True)
    return avi


def colorize_disparity(disp: np.ndarray) -> np.ndarray:
    """A disparity map normalised to [0, 1], as gray RGB."""
    d = np.asarray(disp, np.float32)
    dmax = d.max() if d.max() > 0 else 1.0
    d = np.clip(d / dmax, 0, 1)
    return np.stack([d, d, d], axis=-1)


def render_novel_view_sequence(render_fn: Callable[[np.ndarray], Dict], poses: np.ndarray,
                               result_dir: str, fps: int = 24, save_frames: bool = True,
                               tag: str = "spiral") -> Dict[str, str]:
    """Render each pose with ``render_fn(pose) -> {rgb_map, disp_map}`` (host
    arrays or tensors), write the frames and the rgb and disparity videos.
    Returns the paths written."""
    frame_dir = os.path.join(result_dir, "frames")
    video_dir = os.path.join(result_dir, "videos")
    os.makedirs(video_dir, exist_ok=True)
    if save_frames:
        os.makedirs(frame_dir, exist_ok=True)
    rgbs, disps = [], []
    for i, pose in enumerate(poses):
        out = render_fn(np.asarray(pose))
        rgb = np.clip(np.asarray(out["rgb_map"]), 0, 1)
        rgbs.append(rgb)
        disps.append(np.asarray(out["disp_map"]))
        if save_frames:
            write_png(os.path.join(frame_dir, f"view{i:04d}_rgb.png"),
                      (rgb * 255).astype(np.uint8))
    paths = {"rgb": write_video(np.stack(rgbs), os.path.join(video_dir, f"{tag}_rgb.mp4"),
                                fps=fps),
             "disp": write_video(np.stack([colorize_disparity(d) for d in disps]),
                                 os.path.join(video_dir, f"{tag}_disp.mp4"), fps=fps)}
    print(f"Videos written: {paths['rgb']}, {paths['disp']}")
    return paths


def create_comparison_video(pred_frames: np.ndarray, gt_frames: np.ndarray, path: str,
                            fps: int = 24) -> str:
    """Side-by-side pred | gt video."""
    return write_video(np.concatenate([pred_frames, gt_frames], axis=2), path, fps=fps)
