"""nerf_tpu_torch's CLIs on the CPU (``--device cpu``) on a 16x16
Blender-layout scene the test writes, with the committed lego checkpoint
(the JAX package's own file, read by both sides; float32 weights, perturb 0,
16 + 16 samples, an ESS grid at R = 8).

``run --type evaluate`` and ``train --test`` are held against the JAX
package's ``run_evaluate`` on the same scene and weights: each view's PSNR
within 1e-3 dB and SSIM within 1e-5 (float32 renders that agree to 1e-4,
as tests/test_torch_render.py holds them, scored in float64).
"""
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

import run as jax_run
from nerf_tpu.config import make_cfg as jax_make_cfg

from nerf_tpu_torch import create_video_from_images, render_novel_views
from nerf_tpu_torch import run
from nerf_tpu_torch.data.blender import write_blender_scene
from nerf_tpu_torch.serve import look_at_pose
from nerf_tpu_torch.train.__main__ import main as train_main
from nerf_tpu_torch.utils.png import read_png

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
LEGO_CFG = os.path.join(ROOT, "configs", "nerf", "lego.yaml")
LEGO = os.path.join(ROOT, "checkpoints", "nerf", "lego", "nerf")
SIZE = 16


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    rng = np.random.default_rng(0)
    splits = {}
    for split, n, t0 in (("train", 4, 0.0), ("val", 2, 0.3), ("test", 3, 0.6)):
        imgs = rng.integers(0, 256, (n, SIZE, SIZE, 4), dtype=np.uint8)
        imgs[..., 3] = np.where(rng.uniform(size=(n, SIZE, SIZE)) < 0.5, 255, 0)
        poses = np.stack([look_at_pose(t0 + 2.1 * i, 0.3, 4.0) for i in range(n)])
        splits[split] = (imgs, poses)
    write_blender_scene(str(root / "lego"), splits, 0.6911112070083618)
    return str(root)


def _opts(scene, out, extra=()):
    opts = ["trained_model_dir", LEGO, "network.dtype", "float32", "task_arg.perturb", "0",
            "task_arg.N_samples", "16", "task_arg.N_importance", "16",
            "occupancy_grid_resolution", "8", "render_num", "3",
            "workspace", str(out / "ws"), "result_dir", str(out / "result")]
    for split in ("train", "test"):
        opts += [f"{split}_dataset.data_root", scene, f"{split}_dataset.H", str(SIZE),
                 f"{split}_dataset.W", str(SIZE)]
    return opts + list(extra)


def _quiet(fn, *args, **kw):
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


@pytest.fixture(scope="module")
def jax_eval(scene, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax")
    _quiet(jax_run.run_evaluate, jax_make_cfg(LEGO_CFG, _opts(scene, out)))
    return json.load(open(out / "result" / "metrics" / "evaluation_results.json"))


def _check_against_jax(result_dir, want):
    got = json.load(open(os.path.join(result_dir, "metrics", "evaluation_results.json")))
    assert len(got["per_image"]) == len(want["per_image"]) == 3
    for g, w in zip(got["per_image"], want["per_image"]):
        assert g["id"] == w["id"]
        assert abs(g["psnr"] - w["psnr"]) <= 1e-3, (g, w)
        assert abs(g["ssim"] - w["ssim"]) <= 1e-5, (g, w)


def test_run_evaluate_matches_jax(scene, jax_eval, tmp_path):
    summary, text = _quiet(run.main, ["--type", "evaluate", "--device", "cpu",
                                      "--cfg_file", LEGO_CFG, *_opts(scene, tmp_path)])
    _check_against_jax(tmp_path / "result", jax_eval)
    assert summary["avg_psnr"] == pytest.approx(jax_eval["summary"]["avg_psnr"], abs=1e-3)
    assert "mean net_time" in text and "Image 2: PSNR=" in text
    frames = sorted(os.listdir(tmp_path / "result" / "frames"))
    assert frames == [f"view{i:04d}_rgb.png" for i in range(3)]
    assert read_png(str(tmp_path / "result" / "frames" / frames[0])).shape == (SIZE, SIZE, 3)
    videos = os.listdir(tmp_path / "result" / "videos")
    assert {os.path.splitext(v)[0] for v in videos} == {"spiral_rgb", "spiral_disp"}


def test_train_test_matches_jax(scene, jax_eval, tmp_path):
    _quiet(train_main, ["--test", "--device", "cpu", "--cfg_file", LEGO_CFG,
                        *_opts(scene, tmp_path, ["write_video", "False"])])
    _check_against_jax(tmp_path / "result", jax_eval)
    assert not (tmp_path / "result" / "videos").exists()


def test_run_dataset_network_marched(scene, tmp_path):
    ds, text = _quiet(run.main, ["--type", "dataset", "--device", "cpu", "--cfg_file", LEGO_CFG,
                                 *_opts(scene, tmp_path)])
    assert len(ds) == 4 and ds.images.shape == (4, SIZE, SIZE, 3) and "dataset ok: 4" in text
    s, text = _quiet(run.main, ["--type", "network", "--device", "cpu", "--cfg_file", LEGO_CFG,
                                *_opts(scene, tmp_path)])
    assert s["frames"] == 2 and s["rays_per_s"] > 0 and text.count("frame ") == 3
    res, text = _quiet(run.main, ["--type", "marched", "--device", "cpu", "--cfg_file",
                                  LEGO_CFG, *_opts(scene, tmp_path, ["march_blocks", "4",
                                                                    "march_block_samples",
                                                                    "8"])])
    assert set(res) == {"hierarchical", "marched"}
    assert all(np.isfinite(r["psnr"]) and r["seconds"] > 0 for r in res.values())
    with pytest.raises(SystemExit):
        _quiet(run.main, ["--type", "bench", "--cfg_file", LEGO_CFG])


def test_run_refuses_a_missing_checkpoint(scene, tmp_path):
    with pytest.raises(FileNotFoundError):
        run.main(["--type", "network", "--device", "cpu", "--cfg_file", LEGO_CFG,
                  *_opts(scene, tmp_path, ["trained_model_dir", str(tmp_path / "none")])])


def test_evaluate_with_auto_compaction(scene, tmp_path):
    summary, text = _quiet(run.main, ["--type", "evaluate", "--device", "cpu", "--cfg_file",
                                      LEGO_CFG, *_opts(scene, tmp_path, ["ess_compaction", "auto",
                                                                        "write_video", "False"])])
    assert "# ess_compaction auto ->" in text and np.isfinite(summary["avg_psnr"])


def test_novel_views_and_video_clis(scene, tmp_path):
    paths, _ = _quiet(render_novel_views.main, ["--device", "cpu", "--cfg_file", LEGO_CFG,
                                                *_opts(scene, tmp_path,
                                                       ["render_type", "original"])])
    assert set(paths) == {"rgb", "disp"} and all(os.path.exists(p) for p in paths.values())
    assert "original_rgb" in paths["rgb"]
    _quiet(run.main, ["--type", "evaluate", "--device", "cpu", "--cfg_file", LEGO_CFG,
                      *_opts(scene, tmp_path, ["write_video", "False"])])
    out, text = _quiet(create_video_from_images.main,
                       ["--image_dir", str(tmp_path / "result" / "images"),
                        "--mode", "comparison"])
    assert os.path.exists(out) and "(3 frames @ 24 fps)" in text


def test_train_from_blender_validates(scene, tmp_path):
    """Two steps on the written scene's train split, then validation on its
    val split (eval_ep 1): the "val psnr" line and no skip warning."""
    argv = ["--device", "cpu", "--cfg_file", LEGO_CFG,
            *_opts(scene, tmp_path, ["trained_model_dir", str(tmp_path / "model"),
                                     "task_arg.N_rays", "16", "ep_iter", "2", "train.epoch",
                                     "1", "eval_ep", "1", "log_interval", "1",
                                     "network.dtype", "bfloat16"])]
    (state, _), text = _quiet(train_main, argv)
    assert state.step == 2
    assert "train data: 4 images 16x16" in text
    assert "val psnr:" in text and "skipping validation" not in text
