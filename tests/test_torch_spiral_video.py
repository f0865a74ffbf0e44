"""nerf_tpu_torch's spiral path and video writers against nerf_tpu on the CPU.

Tolerances: spiral poses at 1e-6 (the same float64 numpy arithmetic, cast
to float32); the AVI's frames exact (an uncompressed RGB container);
frames written as PNG exact.
"""
import os
import struct
import sys

import numpy as np
import pytest

from nerf_tpu.render.spiral import generate_spiral_poses as jax_spiral

from nerf_tpu_torch import create_video_from_images
from nerf_tpu_torch.eval import video
from nerf_tpu_torch.render.spiral import generate_spiral_poses
from nerf_tpu_torch.serve import look_at_pose
from nerf_tpu_torch.utils.png import read_png, write_png


@pytest.mark.parametrize("n_frames,n_rots,zrate", [(120, 2, 0.5), (7, 1, 0.0), (30, 3, 1.5)])
def test_spiral_matches_jax(n_frames, n_rots, zrate):
    rng = np.random.default_rng(n_frames)
    poses = np.stack([look_at_pose(t, p, 4.0) for t, p in
                      zip(rng.uniform(0, 6.28, 12), rng.uniform(-0.5, 1.0, 12))])
    got = generate_spiral_poses(poses, n_frames, n_rots, zrate)
    want = jax_spiral(poses, n_frames, n_rots, zrate)
    assert got.shape == (n_frames, 4, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6)


def _read_avi(path):
    """(fps, [N, H, W, 3] uint8 RGB) of an uncompressed 24-bit AVI, read
    through its RIFF chunks."""
    data = open(path, "rb").read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert struct.unpack("<I", data[4:8])[0] == len(data) - 8
    avih = data.index(b"avih")
    us, = struct.unpack("<I", data[avih + 8:avih + 12])
    n, = struct.unpack("<I", data[avih + 24:avih + 28])
    w, h = struct.unpack("<II", data[avih + 40:avih + 48])
    stride = (3 * w + 3) & ~3
    movi = data.index(b"movi")
    idx1 = data.index(b"idx1")
    frames = []
    for e in range(n):
        tag, flags, off, size = struct.unpack("<4sIII", data[idx1 + 8 + 16 * e:idx1 + 24 + 16 * e])
        assert tag == b"00db" and flags == 0x10 and size == stride * h
        body = data[movi + off + 8: movi + off + 8 + size]
        assert data[movi + off: movi + off + 4] == b"00db"
        dib = np.frombuffer(body, np.uint8).reshape(h, stride)[:, :3 * w].reshape(h, w, 3)
        frames.append(dib[::-1, :, ::-1])
    return round(1e6 / us), np.stack(frames)


@pytest.fixture
def no_video_packages(monkeypatch):
    """imageio and cv2 as on a machine without them: their import fails."""
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    monkeypatch.setitem(sys.modules, "cv2", None)


@pytest.mark.parametrize("w", [16, 13])  # rows padded to 4 bytes at odd widths
def test_avi_last_link_reads_back_frame_by_frame(tmp_path, no_video_packages, w, capsys):
    rng = np.random.default_rng(w)
    frames = rng.integers(0, 256, (5, 10, w, 3), dtype=np.uint8)
    path = video.write_video(frames, str(tmp_path / "v" / "clip.mp4"), fps=12)
    assert path == str(tmp_path / "v" / "clip.avi") and os.path.exists(path)
    assert not os.path.exists(tmp_path / "v" / "clip.mp4")
    assert f"wrote {path}" in capsys.readouterr().out
    fps, back = _read_avi(path)
    assert fps == 12
    np.testing.assert_array_equal(back, frames)


def test_write_video_prefers_the_packages(tmp_path):
    """Here cv2 writes the mp4 (imageio has no ffmpeg backend), as the JAX
    package's chain does."""
    frames = np.zeros((3, 16, 16, 3), np.uint8)
    path = video.write_video(frames, str(tmp_path / "a.mp4"))
    assert path == str(tmp_path / "a.mp4") and os.path.getsize(path) > 0
    with pytest.raises(ValueError, match="no frames"):
        video.write_video(frames[:0], str(tmp_path / "b.mp4"))


def test_novel_view_sequence_writes_frames_and_videos(tmp_path, no_video_packages):
    rng = np.random.default_rng(1)
    rgbs = rng.uniform(0, 1, (3, 8, 10, 3)).astype(np.float32)
    calls = []

    def render_fn(pose):
        calls.append(pose)
        i = len(calls) - 1
        return {"rgb_map": rgbs[i], "disp_map": np.full((8, 10), i + 1.0, np.float32)}

    poses = np.stack([np.eye(4)] * 3)
    paths = video.render_novel_view_sequence(render_fn, poses, str(tmp_path), fps=5, tag="t")
    assert len(calls) == 3
    _, back = _read_avi(paths["rgb"])
    np.testing.assert_array_equal(back, (rgbs * 255).astype(np.uint8))
    _, disp = _read_avi(paths["disp"])
    assert (disp == 255).all()  # each frame normalised by its own max
    for i in range(3):
        np.testing.assert_array_equal(read_png(str(tmp_path / "frames" / f"view{i:04d}_rgb.png")),
                                      (rgbs[i] * 255).astype(np.uint8))


def test_a_render_error_propagates(tmp_path):
    def render_fn(pose):
        raise RuntimeError("kernel launch failed")

    with pytest.raises(RuntimeError, match="kernel launch failed"):
        video.render_novel_view_sequence(render_fn, np.stack([np.eye(4)]), str(tmp_path))
    assert not os.listdir(tmp_path / "videos")


@pytest.mark.parametrize("mode", ["pred", "gt", "comparison"])
def test_create_video_from_images_cli(tmp_path, no_video_packages, mode):
    rng = np.random.default_rng(2)
    imgs = {k: rng.integers(0, 256, (11, 6, 8, 3), dtype=np.uint8) for k in ("pred", "gt")}
    for k, frames in imgs.items():
        for i, f in enumerate(frames):  # view2 before view10 in natural order
            write_png(str(tmp_path / f"view{i:03d}_{k}.png"), f)
    out = create_video_from_images.main(["--image_dir", str(tmp_path), "--mode", mode,
                                         "--fps", "6"])
    fps, back = _read_avi(out)
    want = (np.concatenate([imgs["pred"], imgs["gt"]], axis=2) if mode == "comparison"
            else imgs[mode])
    assert fps == 6
    np.testing.assert_array_equal(back, want)
