"""The port's helper modules against the JAX package's: ``utils/data_utils``,
``utils/img_utils``, ``utils/mask_utils``, ``utils/ray_utils`` and
``data/samplers.make_dataset_catalog``. Inputs are made from numpy seeds and
given to both sides; JAX's own test cases (``tests/test_data_utils.py``,
``tests/test_samplers_utils.py``) are run through both.

Tolerances:
- host numpy functions copied from ``nerf_tpu``: equal (the same arithmetic);
- ``resize_image``: masks equal; float images within 1e-5 of cv2's (the
  port's bilinear resize and cv2's INTER_LINEAR compute the same weights in
  float32 in another order); uint8 images within one level (cv2 sums 11-bit
  fixed-point weights, the port rounds a float32 result); shapes and
  intrinsics equal, axis swap included;
- ``draw_poly``: equal to ``cv2.fillPoly`` pixel for pixel on seeded
  convex, concave, self-crossing and border-crossing polygons;
- ``colorize_depth``: within 1e-6 of matplotlib's ``jet``;
- ``heatmap_nms``, ``topk``, ``gather_feat`` (torch): equal, on values
  without ties;
- ``get_near_far`` (torch): float64 rays within 1e-12 of JAX's; float32
  rays and box within 2e-6 relative (JAX's numpy takes 1 / d in float64, the
  port in float32: a few float32 roundings of t), the same hits.
"""
import os
import random

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from nerf_tpu.utils import data_utils as jdu  # noqa: E402
from nerf_tpu.utils import img_utils as jimg  # noqa: E402
from nerf_tpu.utils import mask_utils as jmask  # noqa: E402
from nerf_tpu.utils import ray_utils as jray  # noqa: E402
from nerf_tpu_torch.utils import data_utils as du  # noqa: E402
from nerf_tpu_torch.utils import img_utils as img  # noqa: E402
from nerf_tpu_torch.utils import mask_utils as mask  # noqa: E402
from nerf_tpu_torch.utils import ray_utils as ray  # noqa: E402


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# ray_utils


def test_get_near_far_jax_case():
    rays_o = np.array([[0.0, 0.0, 5.0], [10.0, 0.0, 5.0]])
    rays_d = np.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    near, far, hit = ray.get_near_far(torch.from_numpy(rays_o), torch.from_numpy(rays_d),
                                      [-2, -2, -2], [2, 2, 2])
    assert hit.tolist() == [True, False]
    assert abs(float(near[0]) - 3.0) < 1e-6 and abs(float(far[0]) - 7.0) < 1e-6
    assert float(near[1]) == 0.0 and float(far[1]) == 0.0


def _rays(seed, n, dtype):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-4, 4, (n, 3))
    d = rng.uniform(-2.5, 2.5, (n, 3)) - o  # aimed near the box
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[: n // 8, 0] = 0.0  # axis-parallel rays: the 1e-10 guard
    d[n // 8: n // 4, 1] = -0.0
    d[n // 4: n // 4 + 8, 2] = 1e-12
    o[: n // 16] *= 0.1  # origins inside the box: near is min_near
    return o.astype(dtype), d.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed", [0, 1])
def test_get_near_far_matches_jax(seed, dtype):
    o, d = _rays(seed, 4096, dtype)
    # the box in the rays' dtype on both sides: float32 bounds rounded apart
    # would move t by up to ulp(bound) / |d| on near-parallel rays
    lo, hi = np.array([-1.5, -1.2, -1.0], dtype), np.array([1.5, 1.3, 1.1], dtype)
    wn, wf, wh = jray.get_near_far(o, d, lo, hi)
    gn, gf, gh = ray.get_near_far(torch.from_numpy(o), torch.from_numpy(d), lo, hi)
    assert gn.dtype == torch.from_numpy(o).dtype and gh.dtype == torch.bool
    _eq(gh.numpy(), wh)
    assert 0.2 < wh.mean() < 0.95 and (wn[wh] == 0.05).any()
    tol = dict(rtol=0, atol=1e-12) if dtype == np.float64 else dict(rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(gn.numpy(), wn, **tol)
    np.testing.assert_allclose(gf.numpy(), wf, **tol)
    np.testing.assert_allclose(ray.get_near_far(o, d, lo, hi, min_near=0.5)[0].numpy(),
                               jray.get_near_far(o, d, lo, hi, min_near=0.5)[0], **tol)


def test_perf_timer_pickle_and_load_object(tmp_path):
    logs = []
    with ray.perf_timer("blk", log=logs.append):
        pass
    assert len(logs) == 1 and logs[0].startswith("blk: ") and logs[0].endswith("s")
    data = {"a": [1, 2, 3], "b": np.arange(4)}
    ray.save_pickle(data, str(tmp_path / "p" / "x.pkl"))
    jray.save_pickle(data, str(tmp_path / "q" / "x.pkl"))
    for side in (ray, jray):
        for sub in ("p", "q"):
            got = side.read_pickle(str(tmp_path / sub / "x.pkl"))
            assert got["a"] == [1, 2, 3] and (got["b"] == np.arange(4)).all()
    assert type(ray.load_object("collections.OrderedDict", {})).__name__ == "OrderedDict"
    for side in (ray, jray):
        frac = side.load_object("fractions.Fraction", {"numerator": 3}, denominator=4)
        assert float(frac) == 0.75


# ---------------------------------------------------------------------------
# data_utils: file readers


def _cam_file(path):
    ext = np.arange(16, dtype=np.float32).reshape(4, 4)
    ixt = np.arange(9, dtype=np.float32).reshape(3, 3) + 1
    lines = ["extrinsic"] + [" ".join(str(v) for v in row) for row in ext]
    lines += ["", "intrinsic"] + [" ".join(str(v) for v in row) for row in ixt]
    lines += ["", "425.0 2.5"]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_cam_files_and_matrices(tmp_path):
    p = _cam_file(tmp_path / "cam.txt")
    for a, b in zip(du.read_cam_file(p), jdu.read_cam_file(p)):
        _eq(a, b)
    for a, b in zip(du.read_pmn_cam_file(p), jdu.read_pmn_cam_file(p)):
        _eq(a, b)
    files = {"m.txt": "1 0 0\n0 2 0\n0 0 1\n", "i.txt": "100.0 50.0 40.0 0\n",
             "f.txt": " ".join(str(float(v)) for v in range(16)),
             "h.txt": "3 4\n1 2 3 4\n5 6 7 8\n9 10 11 12\n13 14 15 16\n0 1\n"}
    for name, text in files.items():
        (tmp_path / name).write_text(text)
        q = str(tmp_path / name)
        if name != "i.txt":
            _eq(du.load_matrix(q), jdu.load_matrix(q))
        for inv in (False, True):
            _eq(du.load_nsvf_intrinsics(q, inv), jdu.load_nsvf_intrinsics(q, inv))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_load_K_Rt_from_P(seed, tmp_path):
    rng = np.random.RandomState(seed)
    K = np.array([[rng.uniform(300, 900), rng.uniform(-1, 1), rng.uniform(100, 400)],
                  [0, rng.uniform(300, 900), rng.uniform(100, 400)], [0, 0, 1.0]])
    R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    R *= np.sign(np.linalg.det(R))
    C = rng.normal(size=3)
    P = K @ np.concatenate([R, (-R @ C)[:, None]], axis=1)
    for a, b in zip(du.load_K_Rt_from_P(P=P), jdu.load_K_Rt_from_P(P=P)):
        _eq(a, b)
    f = tmp_path / "P.txt"
    f.write_text("\n".join(" ".join(repr(float(v)) for v in row) for row in P) + "\n")
    for a, b in zip(du.load_K_Rt_from_P(str(f)), jdu.load_K_Rt_from_P(str(f))):
        _eq(a, b)
    intr, pose = du.load_K_Rt_from_P(P=P)
    np.testing.assert_allclose(intr[:3, :3], K, atol=1e-6)
    np.testing.assert_allclose(pose[:3, 3], C, atol=1e-5)


def test_load_ply_binary_and_ascii(tmp_path):
    from nerf_tpu_torch.utils.mesh import save_ply

    verts = np.random.RandomState(3).normal(size=(17, 3)).astype(np.float32)
    p = tmp_path / "v.ply"
    save_ply(str(p), verts, np.zeros((0, 3), np.int32))
    _eq(du.load_ply(str(p)), jdu.load_ply(str(p)))
    _eq(du.load_ply(str(p)), verts)
    q = tmp_path / "a.ply"
    body = "\n".join(f"{x} {y} {z} 0.5" for x, y, z in verts)
    q.write_text("ply\nformat ascii 1.0\nelement vertex 17\nproperty float x\n"
                 "property float y\nproperty float z\nproperty float conf\nend_header\n"
                 + body + "\n")
    _eq(du.load_ply(str(q)), jdu.load_ply(str(q)))


def test_imagenet_tensor_roundtrip():
    rgb = (np.random.RandomState(0).rand(8, 6, 3) * 255).astype(np.uint8)
    _eq(du.to_tensor(rgb), jdu.to_tensor(rgb))
    _eq(du.to_img(du.to_tensor(rgb)), jdu.to_img(jdu.to_tensor(rgb)))


# ---------------------------------------------------------------------------
# data_utils: resizes (cv2 on JAX's side)

RESIZE_CASES = [((40, 60), (20, 30)), ((40, 40), (20, 20)), ((40, 60), (30, 20)),
                ((37, 53), (80, 50)), ((13, 7), (33, 17)), ((64, 48), (32, 24))]


@pytest.mark.parametrize("kind", ["float32", "float64", "uint8", "gray", "one_channel"])
@pytest.mark.parametrize("shape,size", RESIZE_CASES)
def test_resize_image_matches_cv2(shape, size, kind):
    rng = np.random.RandomState(sum(shape) + sum(size))
    h, w = shape
    image = {"float32": lambda: rng.rand(h, w, 3).astype(np.float32),
             "float64": lambda: rng.rand(h, w, 3),
             "uint8": lambda: (rng.rand(h, w, 3) * 255).astype(np.uint8),
             "gray": lambda: rng.rand(h, w).astype(np.float32),
             "one_channel": lambda: rng.rand(h, w, 1).astype(np.float32)}[kind]()
    m = rng.rand(h, w) > 0.5
    ixt = np.array([[100.0, 0, w / 2], [0, 90, h / 2], [0, 0, 1]])
    gi, gm, gk = du.resize_image(image, m, ixt, size)
    wi, wm, wk = jdu.resize_image(image, m, ixt, size)
    assert gi.shape == wi.shape == (size[1], size[0]) + wi.shape[2:] and gi.dtype == wi.dtype
    tol = 1 if kind == "uint8" else 1e-5
    assert np.abs(gi.astype(np.float64) - wi.astype(np.float64)).max() <= tol
    _eq(gm, wm)
    _eq(gk, wk)


def test_resize_image_swaps_the_axes_as_jax():
    """input_size (20, 30) on a 40x60 image: a 30x20 image, fx scaled by
    20/40 and fy by 30/60 (the intrinsics do not describe the image)."""
    image = np.random.RandomState(0).rand(40, 60, 3).astype(np.float32)
    ixt = np.array([[100.0, 0, 30], [0, 100, 20], [0, 0, 1]])
    gi, gm, gk = du.resize_image(image, image[..., 0] > 0.5, ixt, (20, 30))
    assert gi.shape == (30, 20, 3) and gm.shape == (30, 20)
    assert gk[0, 0] == 50 and gk[1, 1] == 50 and gk[0, 2] == 15 and gk[1, 2] == 10


def test_resize_images_matches_jax():
    rng = np.random.RandomState(4)
    imgs = [rng.rand(40, 40, 3).astype(np.float32), rng.rand(30, 50, 3).astype(np.float32)]
    masks = [rng.rand(*i.shape[:2]) > 0.5 for i in imgs]
    ixt = np.array([[100.0, 0, 20], [0, 100, 20], [0, 0, 1]])
    gi, gm, gk = du.resize_images(imgs, masks, ixt, (20, 16))
    wi, wm, wk = jdu.resize_images(imgs, masks, ixt, (20, 16))
    for a, b in zip(gi, wi):
        assert a.shape == b.shape and np.abs(a - b).max() <= 1e-5
    for a, b in zip(gm, wm):
        _eq(a, b)
    _eq(gk, wk)
    _eq(du.resize_images([], [], ixt, (20, 16))[2], jdu.resize_images([], [], ixt, (20, 16))[2])


# ---------------------------------------------------------------------------
# data_utils: heatmaps, warps, augmentation


def test_gaussian_heatmaps_match_jax():
    for size, ov in (((10, 10), 0.7), ((37, 12), 0.5), ((3, 90), 0.9)):
        assert du.gaussian_radius(size, ov) == jdu.gaussian_radius(size, ov)
    for shape, sigma, rho in (((7, 7), 1.0, 0.0), ((9, 5), (1.5, 0.7), 0.5), ((3, 3), 2, -0.3)):
        _eq(du.gaussian2D(shape, sigma, rho), jdu.gaussian2D(shape, sigma, rho))
    hm_g, hm_w = np.zeros((20, 24), np.float32), np.zeros((20, 24), np.float32)
    for side, hm in ((du, hm_g), (jdu, hm_w)):
        side.draw_umich_gaussian(hm, (10, 10), 3)
        side.draw_umich_gaussian(hm, (0, 0), 3)
        side.draw_umich_gaussian(hm, (23, 19), 4, k=0.5)
        side.draw_distribution(hm, (15, 5), 2.0, 1.0, 0.3, 3)
        side.draw_heatmap_np(hm, (4, 16), (2, 2))
    _eq(hm_g, hm_w)
    d = np.random.RandomState(1).rand(50) * 10
    _eq(du.compute_gaussian_1d(d, 2), jdu.compute_gaussian_1d(d, 2))


def test_affine_and_homography_match_jax():
    rng = np.random.RandomState(5)
    for _ in range(5):
        center = rng.uniform(0, 100, 2).astype(np.float32)
        scale, rot = float(rng.uniform(20, 80)), float(rng.uniform(-45, 45))
        shift = rng.uniform(-0.1, 0.1, 2).astype(np.float32)
        for inv in (0, 1):
            t = du.get_affine_transform(center, scale, rot, (64, 48), shift, inv)
            _eq(t, jdu.get_affine_transform(center, scale, rot, (64, 48), shift, inv))
            pts = rng.uniform(0, 100, (7, 2))
            _eq(du.affine_transform(pts, t), jdu.affine_transform(pts, t))
    _eq(du.get_3rd_point(np.float32([1, 2]), np.float32([3, 5])),
        jdu.get_3rd_point(np.float32([1, 2]), np.float32([3, 5])))
    assert du.get_dir([0, -25.0], 0.3) == jdu.get_dir([0, -25.0], 0.3)
    H = rng.normal(size=(3, 3)) + 3 * np.eye(3)
    pts = rng.uniform(-1, 1, (9, 2))
    _eq(du.homography_transform(pts, H), jdu.homography_transform(pts, H))
    for border, size in ((128, np.array([100, 100])), (64, np.array([300, 40])),
                         (7, np.array([5, 90]))):
        assert du.get_border(border, size) == jdu.get_border(border, size)
    boxes = rng.uniform(-50, 250, (6, 4))
    _eq(du.clip_to_image(boxes.copy(), 100, 150), jdu.clip_to_image(boxes.copy(), 100, 150))


EIG_VAL = np.array([0.2141788, 0.01817699, 0.00341571], np.float32)
EIG_VEC = np.array([[-0.58752847, -0.69563484, 0.41340352],
                    [-0.5832747, 0.00994535, -0.81221408],
                    [-0.56089297, 0.71832671, 0.41158938]], np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_color_aug_same_seed_same_image(seed):
    base = np.random.RandomState(10 + seed).rand(16, 12, 3).astype(np.float32)
    outs = []
    for side in (du, jdu):
        im = base.copy()
        random.seed(seed)  # the jitters' order
        side.color_aug(np.random.RandomState(seed), im, EIG_VAL, EIG_VEC)
        outs.append(im)
    _eq(*outs)
    assert not np.allclose(outs[0], base)
    _eq(du.grayscale(base), jdu.grayscale(base))


def test_blur_and_truncated_normal_match_jax():
    rng = np.random.RandomState(6)
    for im in (rng.rand(16, 16, 3).astype(np.float32), rng.rand(9, 13).astype(np.float32)):
        _eq(du.gaussian_blur(im.copy(), 1.5), jdu.gaussian_blur(im.copy(), 1.5))
    for seed in range(4):
        assert (du.truncated_normal(0.0, 1.0, -0.3, 0.4, np.random.RandomState(seed))
                == jdu.truncated_normal(0.0, 1.0, -0.3, 0.4, np.random.RandomState(seed)))


# ---------------------------------------------------------------------------
# data_utils: detection post-processing (torch on the port's side)


def _heat(seed, negative):
    """[2, 3, 16, 20] float32 without ties: in [0, 1), or in [-1.5, 0.5)."""
    heat = (np.random.RandomState(seed).permutation(1920).reshape(2, 3, 16, 20)
            .astype(np.float32) + 0.5) / 1920
    return heat * 2 - 1.5 if negative else heat


@pytest.mark.parametrize("kernel", [3, 5, 4])
@pytest.mark.parametrize("negative", [False, True], ids=["unit", "negative"])
def test_heatmap_nms_matches_jax(negative, kernel):
    heat = _heat(kernel, negative)
    got = du.heatmap_nms(torch.from_numpy(heat), kernel)
    _eq(got.numpy(), jdu.heatmap_nms(heat, kernel))


def test_heatmap_nms_pads_with_zeros():
    """On a negative heatmap, F.max_pool2d's own -inf padding keeps border
    peaks that JAX's zero padding drops; the port keeps none on the border."""
    import torch.nn.functional as F

    heat = torch.from_numpy(_heat(0, True)) - 0.6  # all negative
    border = torch.ones(16, 20, dtype=torch.bool)
    border[1:-1, 1:-1] = False
    inf_pad = heat * (F.max_pool2d(heat, 3, stride=1, padding=1) == heat)
    assert (inf_pad[..., border] != 0).sum() > 0
    got = du.heatmap_nms(heat)
    assert (got[..., border] == 0).all() and (got[..., ~border] != 0).any()


@pytest.mark.parametrize("K", [1, 5, 40])
@pytest.mark.parametrize("negative", [False, True], ids=["unit", "negative"])
def test_topk_and_gather_match_jax(K, negative):
    heat = _heat(K, negative)
    assert len(np.unique(heat)) == heat.size  # no ties
    got = du.topk(torch.from_numpy(heat), K)
    want = jdu.topk(heat, K)
    for g, w in zip(got, want):
        _eq(g.numpy(), w)
    feat = np.random.RandomState(K).rand(2, 320, 4).astype(np.float32)
    ind = np.random.RandomState(K + 1).randint(0, 320, (2, K))
    _eq(du.gather_feat(torch.from_numpy(feat), torch.from_numpy(ind)).numpy(),
        jdu.gather_feat(feat, ind))


def test_topk_jax_case():
    heat = np.random.RandomState(0).rand(2, 3, 16, 16).astype(np.float32)
    score, inds, clses, ys, xs = du.topk(torch.from_numpy(heat), K=5)
    for b in range(2):
        assert float(score[b, 0]) == heat[b].max()
        c, y, x = int(clses[b, 0]), int(ys[b, 0]), int(xs[b, 0])
        assert heat[b, c, y, x] == heat[b].max() and int(inds[b, 0]) == y * 16 + x
    assert (score[:, 1:] <= score[:, :-1]).all()


# ---------------------------------------------------------------------------
# data_utils: polygons and masks (cv2.fillPoly on JAX's side)


def _polygons(seed, n, kind, H, W):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        if kind == "convex":
            c = rng.uniform([5, 5], [W - 5, H - 5])
            ang = np.sort(rng.uniform(0, 2 * np.pi, rng.randint(3, 9)))
            r = rng.uniform(2, min(H, W) / 2 - 1)
            pts = c + r * np.stack([np.cos(ang), np.sin(ang)], -1)
        elif kind == "concave":  # a star: radii alternate
            c = rng.uniform([8, 8], [W - 8, H - 8])
            k = rng.randint(4, 8)
            ang = np.linspace(0, 2 * np.pi, 2 * k, endpoint=False) + rng.uniform(0, 1)
            r = np.where(np.arange(2 * k) % 2, rng.uniform(1, 4), rng.uniform(5, 8))
            pts = c + r[:, None] * np.stack([np.cos(ang), np.sin(ang)], -1)
        elif kind == "border":  # vertices up to 15 pixels outside the image
            m = rng.randint(3, 8)
            pts = np.stack([rng.randint(-15, W + 15, m), rng.randint(-15, H + 15, m)], -1)
        else:  # self-crossing: random vertex order
            m = rng.randint(4, 9)
            pts = np.stack([rng.randint(0, W, m), rng.randint(0, H, m)], -1)
        yield np.asarray(pts).astype(np.int32)


@pytest.mark.parametrize("kind", ["convex", "concave", "border", "crossing"])
def test_draw_poly_equals_cv2(kind):
    H, W = 40, 48
    differ = 0
    for poly in _polygons(len(kind), 100, kind, H, W):
        base = np.zeros((H, W), np.uint8)
        base[::7, ::5] = 3
        got = du.draw_poly(base.copy(), poly)
        want = jdu.draw_poly(base.copy(), poly)
        differ += int((got != want).any())
    assert differ == 0


def test_draw_poly_multichannel_and_far_vertices():
    rng = np.random.RandomState(8)
    for _ in range(50):
        poly = rng.randint(-100000, 100000, (rng.randint(1, 12), 2)).astype(np.int32)
        base = rng.randint(0, 3, (23, 31, 3)).astype(np.uint8)
        want = base.copy()
        cv2.fillPoly(want, [poly], 255)
        _eq(du.draw_poly(base.copy(), poly), want)


def test_line_pixels_equal_cv2_line():
    rng = np.random.RandomState(9)
    for _ in range(300):
        p1, p2 = (tuple(int(v) for v in rng.randint(-20, 60, 2)) for _ in range(2))
        want = np.zeros((30, 40), np.uint8)
        cv2.line(want, p1, p2, 255, 1, cv2.LINE_8)
        got = np.zeros((30, 40), np.uint8)
        ys, xs = du.line_pixels(p1, p2, 30, 40)
        got[ys, xs] = 255
        _eq(got, want)


def test_mask_helpers_match_jax():
    gt = np.zeros((10, 10, 1), np.uint8)
    gt[2:5, 2:5] = 1
    poly = np.array([[2, 2], [2, 4], [4, 4], [4, 2]])
    assert du.inter_from_poly(poly, gt, 10, 10) == jdu.inter_from_poly(poly, gt, 10, 10) > 0
    rng = np.random.RandomState(2)
    for _ in range(5):
        pred, g = rng.rand(12, 9) > 0.5, rng.rand(12, 9) > 0.3
        assert du.inter_from_mask(pred, g) == jdu.inter_from_mask(pred, g)
        poly = rng.randint(-3, 14, (5, 2))
        assert (du.inter_from_poly(poly, g[..., None].astype(np.uint8), 9, 12)
                == jdu.inter_from_poly(poly, g[..., None].astype(np.uint8), 9, 12))
    m = np.zeros((10, 10), np.uint8)
    m[3:7, 3:7] = 1
    _eq(du.get_edge(m), jdu.get_edge(m))
    assert du.get_edge(m).sum() == 12
    m = (rng.rand(20, 20) > 0.4).astype(np.uint8)
    _eq(du.get_edge(m), jdu.get_edge(m))


# ---------------------------------------------------------------------------
# img_utils, mask_utils, samplers


def test_image_concat_and_to8b_match_jax():
    rng = np.random.RandomState(0)
    ims = [rng.rand(4, 6, 3), rng.rand(8, 2, 3), rng.rand(5, 3)]
    for pad in (0, 2):
        _eq(img.horizon_concat(ims, pad, 0.5), jimg.horizon_concat(ims, pad, 0.5))
        _eq(img.vertical_concat(ims[:2], pad), jimg.vertical_concat(ims[:2], pad))
    x = rng.uniform(-0.5, 1.5, (7, 5))
    _eq(img.to8b(x), jimg.to8b(x))
    assert img.to8b(np.array([0.0, 0.5, 2.0])).tolist() == [0, 127, 255]


def test_jet_table_equals_matplotlib():
    matplotlib = pytest.importorskip("matplotlib")
    want = matplotlib.colormaps["jet"]
    assert want.N == img.LUT_SIZE
    np.testing.assert_allclose(img.colormap_table("jet"), want(np.arange(256))[:, :3],
                               rtol=0, atol=1e-12)
    t = np.concatenate([np.linspace(0, 1, 4097), np.arange(257) / 256.0,
                        np.random.RandomState(0).rand(1000)])
    for dtype in (np.float32, np.float64):
        got = img.apply_colormap(t.astype(dtype))
        np.testing.assert_allclose(got, want(t.astype(dtype))[:, :3], rtol=0, atol=1e-6)
    nan = img.apply_colormap(np.array([np.nan, 0.5]))
    assert (nan[0] == 0).all() and (nan[1] > 0).any()


@pytest.mark.parametrize("near_far", [None, (0.5, 2.0)])
def test_colorize_depth_matches_jax(near_far):
    matplotlib = pytest.importorskip("matplotlib")
    rng = np.random.RandomState(1)
    depth = rng.uniform(0.2, 3.0, (24, 18)).astype(np.float32)
    depth[0, :3] = np.inf
    kw = {} if near_far is None else {"near": near_far[0], "far": near_far[1]}
    got = img.colorize_depth(depth, **kw)
    assert got.shape == (24, 18, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, jimg.colorize_depth(depth, **kw), rtol=0, atol=1e-6)
    lo = np.percentile(depth[np.isfinite(depth)], 1) if near_far is None else near_far[0]
    hi = np.percentile(depth[np.isfinite(depth)], 99) if near_far is None else near_far[1]
    t = np.clip((depth - lo) / max(hi - lo, 1e-8), 0, 1)
    np.testing.assert_allclose(got, matplotlib.colormaps["jet"](t)[..., :3], rtol=0, atol=1e-6)


def test_colorize_depth_refuses_unknown_maps():
    with pytest.raises(ValueError, match="viridis"):
        img.colorize_depth(np.ones((2, 2)), cmap="viridis")


def test_pfm_files_cross_read(tmp_path):
    rng = np.random.RandomState(2)
    for name, arr in (("c", rng.rand(6, 9, 3).astype(np.float32)),
                      ("g", rng.rand(5, 4).astype(np.float32)),
                      ("g1", rng.rand(3, 7, 1).astype(np.float32))):
        paths = {}
        for side in (img, jimg):
            paths[side] = str(tmp_path / f"{name}_{side.__name__}.pfm")
            side.write_pfm(paths[side], arr, scale=2.0)
        assert open(paths[img], "rb").read() == open(paths[jimg], "rb").read()
        for writer in (img, jimg):
            for reader in (img, jimg):
                got, scale = reader.read_pfm(paths[writer])
                assert scale == 2.0
                _eq(got, arr.reshape(got.shape))
    (tmp_path / "bad.pfm").write_bytes(b"P6\n1 1\n1\n")
    with pytest.raises(ValueError):
        img.read_pfm(str(tmp_path / "bad.pfm"))


def test_mask_catalogs_equal_jax():
    for name in ("ADE20K_LABELS", "HUMAN_LABELS", "id_label_mapping_ade20k",
                 "label_id_mapping_ade20k", "id_label_mapping_human", "label_id_mapping_human"):
        assert getattr(mask, name) == getattr(jmask, name), name
    assert mask.label_id_mapping_ade20k["bed "] == 7 and len(mask.ADE20K_LABELS) == 150
    for human in (False, True):
        assert mask.get_label_id_mapping(human) == jmask.get_label_id_mapping(human)
    assert mask.get_label_id_mapping() is mask.label_id_mapping_ade20k
    assert (mask.get_class_ids_from_labels(["wall", "flag", "bed "])
            == jmask.get_class_ids_from_labels(["wall", "flag", "bed "]) == [0, 149, 7])
    assert mask.get_class_ids_from_labels(["person"], use_human_mask=True) == [1]


def test_dataset_catalog_equals_jax():
    from nerf_tpu.data.samplers import make_dataset_catalog as want
    from nerf_tpu_torch.data.samplers import make_dataset_catalog as got

    assert got() == want() and got()["nerf_synthetic"] == os.path.join("data", "nerf_synthetic")
