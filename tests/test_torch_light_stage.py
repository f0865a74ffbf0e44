"""nerf_tpu_torch's light-stage, latent and bound helpers against nerf_tpu's on the CPU.

A rig of 4 cameras x 2 frames with non-zero distortion (k1, k2, p1, p2, k3),
made with numpy from a seed (``light_stage.write_synthetic_rig``), is loaded
by both packages; the JAX loader undistorts and resizes with cv2, the port
with its own ``utils/remap.py``. Tolerances:
- masks, foreground boxes, K, extrinsics, world bound, sampled pixels:
  equal; rays: equal (the same numpy float64 arithmetic on the same pixels);
- images and rgb rows: 1e-5 absolute. On this rig the undistorted images
  are equal bit for bit at ratio 1.0 (the map is cv2's to the last bit, the
  float32 sums in cv2's order); at 0.5 the port's bilinear resize and cv2's
  INTER_AREA average each 2x2 block in other orders (measured: 5.96e-8 at
  1,739 of 27,360 values of the 8 test images).
"""
import os
import sys

import numpy as np
import pytest

from nerf_tpu.data.latent import LatentDataset as JaxLatent
from nerf_tpu.data.light_stage import LightStageDataset as JaxLightStage
from nerf_tpu.utils import vis_utils as jvis

from nerf_tpu_torch.data import light_stage
from nerf_tpu_torch.data.latent import LatentDataset
from nerf_tpu_torch.data.light_stage import LightStageDataset
from nerf_tpu_torch.utils import remap, vis_utils
from nerf_tpu_torch.utils.png import read_png


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rig"))
    light_stage.write_synthetic_rig(root, n_cams=4, n_frames=2, H=60, W=76, seed=3)
    return root


def _same_items(a, b):
    assert len(a) == len(b)
    for ia, ib in zip(a.items, b.items):
        assert ia == ib


@pytest.mark.parametrize("ratio", [1.0, 0.5])
def test_train_batches_match_jax(rig, ratio):
    kw = dict(split="train", n_rays=256, input_ratio=ratio, seed=4)
    got, want = LightStageDataset(rig, **kw), JaxLightStage(rig, **kw)
    _same_items(got, want)
    np.testing.assert_array_equal(got.wbbox, want.wbbox)
    for i in [0, 5, 3, 7, 0]:  # the draws continue from item to item
        g, w = got[i], want[i]
        np.testing.assert_array_equal(g["rays"], w["rays"])
        np.testing.assert_allclose(g["rgb"], w["rgb"], rtol=0, atol=1e-5)
        assert g["rgb"].shape == (g["rays"].shape[0], 3) and g["rays"].shape[1] == 7
        assert 0.75 * 256 < g["rays"].shape[0] <= 256
        np.testing.assert_allclose(np.linalg.norm(g["rays"][:, 3:6], axis=-1), 1.0, atol=1e-6)
        np.testing.assert_array_equal(g["wbounds"], w["wbounds"])
        assert g["meta"] == w["meta"]
        ga, wa = got._read(i), want._read(i)
        np.testing.assert_array_equal(ga[1], wa[1])  # the mask
        for k in (2, 3, 4):  # K, extrinsics, foreground box
            np.testing.assert_array_equal(ga[k], wa[k])
        np.testing.assert_allclose(ga[0], wa[0], rtol=0, atol=1e-5)
        if ratio == 1.0:
            np.testing.assert_array_equal(ga[0], wa[0])


@pytest.mark.parametrize("ratio", [1.0, 0.5])
def test_test_images_match_jax(rig, ratio):
    kw = dict(split="test", cameras=(1, -1, 2), frames=(0, 2, 1), train_frames=(1, 2, 1),
              input_ratio=ratio)
    got, want = LightStageDataset(rig, **kw), JaxLightStage(rig, **kw)
    _same_items(got, want)
    assert len(got) == 4 and got.items[2]["latent_index"] == 0
    for i in range(len(got)):
        g, w = got[i], want[i]
        H, W = g["meta"]["H"], g["meta"]["W"]
        assert (H, W) == (int(round(60 * ratio)), int(round(76 * ratio)))
        np.testing.assert_array_equal(g["rays"], w["rays"])
        np.testing.assert_allclose(g["rgb"], w["rgb"], rtol=0, atol=1e-5)
        assert g["rays"].shape == (H * W, 7)
        fg = (g["rgb"].sum(-1) > 0).mean()
        assert 0.1 < fg < 0.6


def test_distortion_moves_the_pixels(rig):
    """The rig's distortion is not a no-op: undistorting moves the mask."""
    ds = LightStageDataset(rig, split="test")
    D = np.asarray(ds.cams["D"][0])
    assert np.abs(D).max() > 0.1
    raw = (read_png(ds._mask_path(ds.items[0]["img_path"])) != 0).astype(np.uint8)
    moved = int((ds._read(0)[1] != raw).sum())
    print(f"undistortion changes {moved} of {raw.size} mask pixels")
    assert moved > 20


def test_the_loader_needs_no_cv2_imageio_or_pil(rig, monkeypatch):
    for name in ("cv2", "imageio", "imageio.v2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)
    ds = LightStageDataset(rig, split="train", n_rays=64, input_ratio=0.5)
    assert np.isfinite(ds[2]["rays"]).all()


def test_undistort_matches_cv2_at_other_shapes():
    """The map and both arithmetics against cv2 itself, 4, 5 and 8
    coefficients: equal bit for bit."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    for D in ([0.1, -0.05, 1e-3, 2e-3], [-0.3, 0.1, 2e-3, -3e-3, -0.02],
              [-0.3, 0.12, 2e-3, -3e-3, -0.02, 0.01, 3e-3, 1e-3]):
        H, W = rng.integers(30, 90, 2)
        K = np.array([[rng.uniform(40, 120), 0, W / 2 + 2.3], [0, rng.uniform(40, 120),
                                                               H / 2 - 1.1], [0, 0, 1]])
        D = np.asarray(D)
        img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        msk = (rng.uniform(size=(H, W)) > 0.5).astype(np.uint8)
        np.testing.assert_array_equal(remap.undistort(img, K, D), cv2.undistort(img, K, D))
        np.testing.assert_array_equal(remap.undistort(msk, K, D), cv2.undistort(msk, K, D))
        for r in (0.5, 0.75):
            np.testing.assert_array_equal(
                remap.resize_nearest(msk, r),
                cv2.resize(msk, None, fx=r, fy=r, interpolation=cv2.INTER_NEAREST))
    with pytest.raises(ValueError, match="4, 5 or 8"):
        remap.undistort(img, K, np.zeros(6))


def test_vis_utils_match_jax():
    rng = np.random.default_rng(8)
    bounds = np.array([[-0.4, -0.5, -0.3], [0.5, 0.4, 0.6]])
    K = np.array([[90.0, 0, 40], [0, 90, 30], [0, 0, 1]])
    RT = np.concatenate([np.eye(3), [[0.1], [-0.2], [2.5]]], 1)
    np.testing.assert_array_equal(vis_utils.get_bound_corners(bounds),
                                  jvis.get_bound_corners(bounds))
    xyz = rng.uniform(-1, 1, (20, 3))
    np.testing.assert_array_equal(vis_utils.project(xyz, K, RT), jvis.project(xyz, K, RT))
    np.testing.assert_array_equal(vis_utils.get_bbox_2d(bounds, K, RT),
                                  jvis.get_bbox_2d(bounds, K, RT))
    np.testing.assert_array_equal(vis_utils.get_bound_2d_mask(bounds, K, RT, 60, 80),
                                  jvis.get_bound_2d_mask(bounds, K, RT, 60, 80))
    np.testing.assert_array_equal(vis_utils.mean_rgb, jvis.mean_rgb)
    np.testing.assert_array_equal(vis_utils.std_rgb, jvis.std_rgb)


def test_latent_split_matches_jax(tmp_path):
    data = np.random.default_rng(9).uniform(size=(20, 200)).astype(np.float32)
    np.save(os.path.join(str(tmp_path), "lego.npy"), data)
    got, want = LatentDataset(str(tmp_path), "lego"), JaxLatent(str(tmp_path), "lego")
    assert len(got) == len(want) == 20
    for a, b in zip(got.split(), want.split()):
        np.testing.assert_array_equal(a, b)
    assert [a.shape for a in got.split()] == [(20, 1), (20, 31), (20, 128), (20, 40)]
    for k, v in got[3].items():
        np.testing.assert_array_equal(v, want[3][k])
    np.save(os.path.join(str(tmp_path), "bad.npy"), np.zeros((4, 10), np.float32))
    with pytest.raises(ValueError, match="latent data must be"):
        LatentDataset(str(tmp_path), "bad")
