"""nerf_tpu_torch's metrics, background conversion and evaluator against
nerf_tpu.eval on the CPU.

Tolerances: SSIM at 1e-12 (both float64 with the same scipy filter: the
same operations in the same order); the evaluator's JSON values at 1e-12,
its text and printed lines equal, its PNGs equal pixel for pixel; the
background masks exact (cv2's 4-connected flood fill against scipy's cross
labelling, cv2's reflect-101 box filter against scipy's "mirror").
"""
import io
import json
import os
from contextlib import redirect_stdout

import imageio.v2 as imageio
import numpy as np
import pytest

from nerf_tpu.eval import background as jbg
from nerf_tpu.eval import metrics as jm
from nerf_tpu.eval.evaluator import Evaluator as JaxEvaluator

from nerf_tpu_torch.eval import background as tbg
from nerf_tpu_torch.eval import metrics as tm
from nerf_tpu_torch.eval.evaluator import Evaluator
from nerf_tpu_torch.utils.png import read_png

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "lego_like_32x32.npy")


def _pair(seed, shape=(33, 40, 3), noise=0.05):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape)
    return a, np.clip(a + rng.normal(0, noise, shape), 0, 1)


@pytest.mark.parametrize("seed,shape,win", [(0, (33, 40, 3), 7), (1, (20, 20), 7),
                                            (2, (16, 9, 3), 5), (3, (64, 48, 3), 7)])
def test_ssim_matches_jax(seed, shape, win):
    a, b = _pair(seed, shape)
    assert abs(tm.ssim(a, b, win) - jm.ssim(a, b, win)) <= 1e-12
    assert tm.ssim(a, a, win) == pytest.approx(1.0, abs=1e-12)


def test_ssim_matches_jax_on_the_golden_image():
    img = np.load(GOLDEN).astype(np.float64)
    other = np.clip(img + np.random.default_rng(4).normal(0, 0.02, img.shape), 0, 1)
    got, want = tm.ssim(img, other), jm.ssim(img, other)
    assert abs(got - want) <= 1e-12 and 0.0 < got < 1.0
    assert tm.psnr(img, other) == jm.psnr(img, other)
    assert tm.mse(img, other) == jm.mse(img, other)


def _dark_scene(seed):
    """A black background with an object whose dark parts are inside it, a
    flat dark patch touching the border, and noise."""
    rng = np.random.default_rng(seed)
    img = np.zeros((48, 56, 3), np.float32)
    img[10:40, 12:44] = rng.uniform(0.3, 1.0, (30, 32, 3))
    img[20:28, 20:30] = 0.02  # dark, inside the object
    img[:, 50:] += rng.uniform(0, 0.15, (48, 6, 3)).astype(np.float32)  # dark noise on the edge
    img[0:5, 0:5] = [0.05, 0.02, 0.03]
    return img


@pytest.mark.parametrize("strategy", ["conservative", "smart", "none"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_background_conversion_matches_jax(strategy, seed):
    img = _dark_scene(seed)
    got, want = tbg.convert_background(img, strategy), jbg.convert_background(img, strategy)
    np.testing.assert_array_equal(got == 1.0, want == 1.0)
    np.testing.assert_array_equal(got, want)
    if strategy != "none":
        assert (got[20:28, 20:30] == 0.02).all() and (got[45:, :10] == 1.0).all()


def _run(cls, result_dir, preds, gts, strategy="none"):
    ev = cls(str(result_dir), background_strategy=strategy)
    buf = io.StringIO()
    with redirect_stdout(buf):
        for i, (p, g) in enumerate(zip(preds, gts)):
            ev.evaluate(p, g, i)
        summary = ev.summarize()
    return summary, buf.getvalue()


@pytest.mark.parametrize("strategy", ["none", "conservative"])
def test_evaluator_matches_jax(tmp_path, strategy):
    rng = np.random.default_rng(5)
    gts = [_dark_scene(s) for s in range(3)]
    preds = [np.clip(g + rng.normal(0, 0.03, g.shape), -0.05, 1.05).astype(np.float32)
             for g in gts]
    preds[2] = preds[2] * 255.0  # a [0, 255] prediction is rescaled
    got, got_out = _run(Evaluator, tmp_path / "port", preds, gts, strategy)
    want, want_out = _run(JaxEvaluator, tmp_path / "jax", preds, gts, strategy)
    assert got_out == want_out
    assert got.keys() == want.keys()
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-12, k
    gj = json.load(open(tmp_path / "port" / "metrics" / "evaluation_results.json"))
    wj = json.load(open(tmp_path / "jax" / "metrics" / "evaluation_results.json"))
    assert gj["summary"]["num_images"] == wj["summary"]["num_images"] == 3
    for k, v in wj["summary"].items():
        assert abs(gj["summary"][k] - v) <= 1e-12, k
    for g, w in zip(gj["per_image"], wj["per_image"]):
        assert g["id"] == w["id"] and all(abs(g[k] - w[k]) <= 1e-12 for k in ("mse", "psnr",
                                                                              "ssim"))
    txt = "metrics/evaluation_summary.txt"
    assert (tmp_path / "port" / txt).read_text() == (tmp_path / "jax" / txt).read_text()
    for i in range(3):
        for kind in ("pred", "gt"):
            name = f"images/view{i:03d}_{kind}.png"
            got_img = read_png(str(tmp_path / "port" / name))
            np.testing.assert_array_equal(got_img, imageio.imread(str(tmp_path / "jax" / name)))
            np.testing.assert_array_equal(got_img,
                                          imageio.imread(str(tmp_path / "port" / name)))


def test_evaluator_without_images(tmp_path):
    ev = Evaluator(str(tmp_path), save_images=False)
    with redirect_stdout(io.StringIO()):
        assert ev.summarize() is None
        a, b = _pair(6)
        ev.evaluate(a, b, 0)
    assert not (tmp_path / "images").exists()
