"""nerf_tpu_torch's Blender loader against nerf_tpu.data.blender on a scene the
test writes (RGBA and RGB frames, a frame whose file is missing).

Tolerances: images at 1e-6 against the JAX package's imageio + cv2 path and
its native loader at input_ratio 1 (the same float32 products, in the
native loader's own order), at 1e-5 at input_ratio 0.5 (a
bilinear 2x2 mean: cv2's and F.interpolate's float32 sums in other orders);
poses, K and focal exact (the same float64 and float32 arithmetic on the
same JSON).
"""
import json
import os

import imageio.v2 as imageio
import numpy as np
import pytest

from nerf_tpu import native
from nerf_tpu.data.blender import BlenderDataset as JaxBlender
from nerf_tpu.data.blender import make_dataset as jax_make_dataset
from nerf_tpu.config import make_cfg as jax_make_cfg

from nerf_tpu_torch.config import make_cfg
from nerf_tpu_torch.data import make_dataset
from nerf_tpu_torch.data.blender import BlenderDataset, write_blender_scene
from nerf_tpu_torch.serve import look_at_pose

ROOT = os.path.join(os.path.dirname(__file__), "..")
LEGO_CFG = os.path.join(ROOT, "configs", "nerf", "lego.yaml")
ANGLE = 0.6911112070083618  # lego's camera_angle_x
N_FRAMES, SIZE = 6, 24


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """data_root with scene "lego": frames 0, 2, 4 RGBA, 1 and 5 RGB, 3
    listed but missing; val and test splits of two RGBA frames each."""
    root = tmp_path_factory.mktemp("blender")
    rng = np.random.default_rng(0)
    path = root / "lego"
    for split, n in (("train", N_FRAMES), ("val", 2), ("test", 2)):
        (path / split).mkdir(parents=True)
        frames = []
        for i in range(n):
            c = 4 if split != "train" or i % 2 == 0 else 3
            img = rng.integers(0, 256, (SIZE, SIZE, c), dtype=np.uint8)
            if c == 4:
                img[:6, :, 3] = 0  # transparent and opaque patches
                img[6:10, :, 3] = 255
            if not (split == "train" and i == 3):
                imageio.imwrite(str(path / split / f"r_{i}.png"), img)
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": look_at_pose(0.4 * i, 0.3, 4.0).tolist()})
        with open(path / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": ANGLE, "frames": frames}, f)
    return str(root)


# the native loader resizes before it composites RGBA on white (the imageio +
# cv2 path composites first), so it is held to the port at input_ratio 1 only
CASES = [(1.0, None, "python"), (1.0, (1, 5, 2), "python"), (1.0, (0, -1, 2), "python"),
         (0.5, None, "python"), (0.5, (2, -1, 1), "python"),
         (1.0, None, "native"), (1.0, (0, -1, 2), "native")]


@pytest.mark.parametrize("ratio,cams,loader", CASES)
@pytest.mark.parametrize("white", [True, False])
def test_blender_matches_jax(scene, monkeypatch, loader, ratio, cams, white):
    if loader == "native" and native.get_lib() is None:
        pytest.skip("the JAX package's native loader does not build here")
    monkeypatch.setenv("NERF_TPU_NATIVE_LOADER", "1" if loader == "native" else "0")
    kw = dict(data_root=scene, split="train", scene="lego", input_ratio=ratio, cams=cams,
              H=SIZE, W=SIZE, white_bkgd=white)
    want, got = JaxBlender(**kw), BlenderDataset(**kw)
    assert (got.H, got.W) == (want.H, want.W) == (int(SIZE * ratio),) * 2
    assert got.images.dtype == np.float32 and got.images.shape == want.images.shape
    np.testing.assert_allclose(got.images, want.images, atol=1e-6 if ratio == 1.0 else 1e-5)
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_array_equal(got.K, want.K)
    assert got.focal == want.focal
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[len(got) - 1]["image"], got.images[-1])


def test_missing_frame_is_skipped(scene):
    ds = BlenderDataset(data_root=scene, split="train", H=SIZE, W=SIZE)
    assert len(ds) == N_FRAMES - 1
    item = ds[3]  # frame 4: frame 3's file is missing
    assert (item["index"], item["H"], item["W"]) == (3, SIZE, SIZE)
    np.testing.assert_array_equal(item["pose"], look_at_pose(0.4 * 4, 0.3, 4.0))


@pytest.mark.parametrize("split", ["train", "test"])
def test_make_dataset_matches_jax(scene, monkeypatch, split):
    monkeypatch.setenv("NERF_TPU_NATIVE_LOADER", "0")
    opts = [f"{split}_dataset.data_root", scene, f"{split}_dataset.H", str(SIZE),
            f"{split}_dataset.W", str(SIZE)]
    got = make_dataset(make_cfg(LEGO_CFG, opts), split)
    want = jax_make_dataset(jax_make_cfg(LEGO_CFG, opts), split)
    np.testing.assert_allclose(got.images, want.images, atol=1e-6)
    np.testing.assert_array_equal(got.poses, want.poses)


def test_a_missing_split_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        BlenderDataset(data_root=str(tmp_path), split="val")


def test_gray_frames_become_rgb(tmp_path):
    rng = np.random.default_rng(3)
    gray = rng.integers(0, 256, (2, 8, 8), dtype=np.uint8)
    ga = rng.integers(0, 256, (2, 8, 8, 2), dtype=np.uint8)
    poses = np.stack([np.eye(4)] * 2)
    write_blender_scene(str(tmp_path / "lego"), {"train": (gray, poses), "test": (ga, poses)},
                        ANGLE)
    ds = BlenderDataset(data_root=str(tmp_path), split="train", H=8, W=8)
    np.testing.assert_array_equal(ds.images, np.repeat(gray[..., None] / np.float32(255), 3, -1))
    ds = BlenderDataset(data_root=str(tmp_path), split="test", H=8, W=8)
    f = ga.astype(np.float32) / 255
    want = f[..., :1] * f[..., 1:] + (1 - f[..., 1:])
    np.testing.assert_allclose(ds.images, np.repeat(want, 3, -1), atol=1e-7)


def test_written_scene_reads_back_in_jax(tmp_path, monkeypatch):
    """write_blender_scene's files load in nerf_tpu as its own do: RGBA frames
    whose alpha is 255 give their colours back exactly."""
    monkeypatch.setenv("NERF_TPU_NATIVE_LOADER", "0")
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (3, 10, 12, 4), dtype=np.uint8)
    imgs[..., 3] = 255
    poses = np.stack([look_at_pose(t, 0.2, 4.0) for t in (0.0, 1.0, 2.0)])
    write_blender_scene(str(tmp_path / "lego"), {"val": (imgs, poses)}, ANGLE,
                        filters=np.arange(10) % 5)
    want = JaxBlender(data_root=str(tmp_path), split="val", H=10, W=12)
    got = BlenderDataset(data_root=str(tmp_path), split="val", H=10, W=12)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.images, imgs[..., :3] / np.float32(255))
    np.testing.assert_array_equal(got.poses, poses)

