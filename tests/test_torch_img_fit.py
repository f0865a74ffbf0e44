"""nerf_tpu_torch's img_fit task against nerf_tpu's on the CPU.

A tiny Blender-layout view (RGBA, made with numpy from a seed) goes through
both packages. Tolerances:
- the dataset, at input ratios 1.0 and 0.5 (JAX resizes with cv2's
  INTER_LINEAR, the port with its bilinear resize): 1e-6 absolute on the
  image and the rgb rows, the uv grid equal.
- one step from JAX's initial parameters, carried over by
  ``encoders.params_from_jax``, on the pixels JAX's step draws (fed to the
  port): loss and psnr 1e-6 relative; params after the optax update, Adam's
  moments 1e-6 absolute (float32 products in other orders).
- checkpoints: JAX's file resumes in the port and the port's in JAX, every
  leaf exact.
- the CLIs (``python -m nerf_tpu_torch.train`` then ``python -m
  nerf_tpu_torch.run --type evaluate``, ``--device cpu``): the PSNR of the
  checkpoint they wrote equals JAX's ``eval_img_fit`` on it within 1e-4 dB.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.config import make_cfg as jax_make_cfg
from nerf_tpu.data.img_fit import ImgFitDataset as JaxImgFit
from nerf_tpu.models.img_fit import init_img_fit_mlp as jax_init
from nerf_tpu.train import checkpoint as jckpt
from nerf_tpu.train import img_fit_loop as jloop
from nerf_tpu.train import state as jstate
from nerf_tpu.train.optim import make_optimizer as jax_make_optimizer

from nerf_tpu_torch import run
from nerf_tpu_torch.config import make_cfg
from nerf_tpu_torch.data.blender import write_blender_scene
from nerf_tpu_torch.data.img_fit import ImgFitDataset
from nerf_tpu_torch.models.encoders import params_from_jax
from nerf_tpu_torch.train import __main__ as train_main
from nerf_tpu_torch.train import checkpoint, img_fit_loop
from nerf_tpu_torch.train.optim import make_optimizer
from nerf_tpu_torch.train.state import init_state
from nerf_tpu_torch.tree import tree_leaves
from nerf_tpu_torch.utils.png import read_png

CFG = os.path.join(os.path.dirname(__file__), "..", "configs", "img_fit", "lego_view0.yaml")


@pytest.fixture
def view(tmp_path):
    """data root of a scene whose train split holds 2 RGBA 40x48 views: a
    smooth ramp with noise, and alpha from 0 to 255."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:40, 0:48].astype(np.float32)
    imgs = []
    for k in range(2):
        rgb = np.stack([xx / 47, yy / 39, 0.5 * (xx / 47 + yy / 39) * (k + 1) / 2], -1)
        rgb = np.clip(rgb + rng.normal(0, 0.05, rgb.shape), 0, 1)
        alpha = rng.uniform(0, 1, (40, 48, 1))
        alpha[:, :12] = 1.0
        alpha[:, -6:] = 0.0
        imgs.append((np.concatenate([rgb, alpha], -1) * 255).round().astype(np.uint8))
    write_blender_scene(str(tmp_path / "data" / "lego"),
                        {"train": (np.stack(imgs), np.stack([np.eye(4)] * 2))}, 0.7, filters=4)
    return str(tmp_path / "data")


def _opts(view, tmp_path, *more):
    return ["train_dataset.data_root", view, "test_dataset.data_root", view,
            "train_dataset.N_pixels", "256", "train_dataset.input_ratio", "0.5",
            "network.mlp.D", "2", "network.mlp.W", "32", "ep_iter", "20", "train.epoch", "3",
            "save_latest_ep", "1", "workspace", str(tmp_path / "ws"), *more]


@pytest.mark.parametrize("ratio", [1.0, 0.5])
@pytest.mark.parametrize("index", [0, 1])
def test_dataset_matches_jax(view, ratio, index):
    want = JaxImgFit(data_root=view, view=index, input_ratio=ratio, n_pixels=64)
    got = ImgFitDataset(data_root=view, view=index, input_ratio=ratio, n_pixels=64)
    assert (got.H, got.W) == (want.H, want.W) == (int(40 * ratio), int(48 * ratio))
    assert got.image.dtype == np.float32 and got.image.shape == want.image.shape
    np.testing.assert_allclose(got.image, want.image, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.rgb, want.rgb, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.uv, want.uv)
    a = got.sample_batch(np.random.RandomState(3))
    b = want.sample_batch(np.random.RandomState(3))
    np.testing.assert_array_equal(a["uv"], b["uv"])
    np.testing.assert_allclose(a["rgb"], b["rgb"], rtol=0, atol=1e-6)


def _states(cfg_opts):
    """JAX's initial TrainState for the config, and the port's from its params."""
    jcfg = jax_make_cfg(CFG, cfg_opts)
    cfg = make_cfg(CFG, cfg_opts)
    tx = jax_make_optimizer(jcfg)
    jparams = jax_init(jax.random.PRNGKey(0), D=2, W=32, num_freqs=10)
    jst = jstate.init_state(jparams, tx)
    params = params_from_jax("img_fit", jax.device_get(jparams))
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    return jcfg, cfg, tx, jst, init_state(params, make_optimizer(cfg))


def test_one_step_matches_jax(view, tmp_path):
    jcfg, cfg, tx, jst, st = _states(_opts(view, tmp_path))
    ds = ImgFitDataset(data_root=view, input_ratio=0.5, n_pixels=256)
    uv, rgb = jnp.asarray(ds.uv), jnp.asarray(ds.rgb)
    key = jax.random.PRNGKey(0)
    for step in range(3):
        idx = jax.random.randint(jax.random.fold_in(key, step), (256,), 0, uv.shape[0])
        jst, jstats = jloop.img_fit_step(jst, uv, rgb, key, tx, 10, 256)
        stats = img_fit_loop.img_fit_step(st, torch.from_numpy(ds.uv), torch.from_numpy(ds.rgb),
                                          make_optimizer(cfg), 10, 256,
                                          idx=torch.from_numpy(np.array(idx)).long())
        for k in ("loss", "psnr"):
            np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-6)
    assert st.step == int(jst.step) == 3
    for got, want in zip(tree_leaves(st.params), jax.tree_util.tree_leaves(jst.params)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    adam = jst.opt_state[1]
    for got, want in zip(st.opt_state.mu + st.opt_state.nu,
                         jax.tree_util.tree_leaves(adam.mu) + jax.tree_util.tree_leaves(adam.nu)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert st.opt_state.count == int(adam.count) and st.opt_state.sched_count == 3


def test_checkpoints_both_ways(view, tmp_path):
    jcfg, cfg, tx, jst, st = _states(_opts(view, tmp_path))
    jst = jstate.TrainState(jst.params, jst.opt_state, jnp.asarray(5, jnp.int32))
    jckpt.save_checkpoint(str(tmp_path / "jax"), jst, 4)
    got, epoch, _ = checkpoint.load_checkpoint(str(tmp_path / "jax"), st)
    assert epoch == 4 and got.step == 5
    want = jax.tree_util.tree_leaves(jst)
    mine = checkpoint._state_leaves(got)
    assert len(mine) == len(want)
    for a, b in zip(mine, want):
        np.testing.assert_array_equal(np.asarray(a.detach() if torch.is_tensor(a) else a),
                                      np.asarray(b))
    # and back: the port's file in JAX's loader
    img_fit_loop.img_fit_step(got, torch.rand(50, 2), torch.rand(50, 3), make_optimizer(cfg), 10,
                              16, torch.Generator().manual_seed(0))
    checkpoint.save_checkpoint(str(tmp_path / "port"), got, 6)
    back, jepoch, _ = jckpt.load_checkpoint(str(tmp_path / "port"), jst)
    assert jepoch == 6 and int(back.step) == 6
    for a, b in zip(jax.tree_util.tree_leaves(back), checkpoint._state_leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b.detach() if torch.is_tensor(b)
                                                                 else b))


def test_train_and_evaluate_clis_match_jax_psnr(view, tmp_path, capsys):
    opts = _opts(view, tmp_path)
    train_main.main(["--cfg_file", CFG, "--device", "cpu"] + opts)
    out = capsys.readouterr().out
    losses = [float(l.split("loss:")[1].split()[0]) for l in out.splitlines() if "loss:" in l]
    assert len(losses) == 3 and losses[-1] < losses[0] and np.isfinite(losses).all()
    cfg = make_cfg(CFG, opts)
    assert cfg.trained_model_dir == os.path.join(str(tmp_path / "ws"), "trained_model",
                                                 "img_fit", "lego", "img_fit")
    assert cfg.trained_model_dir == jax_make_cfg(CFG, opts).trained_model_dir
    assert cfg.result_dir == jax_make_cfg(CFG, opts).result_dir
    assert sorted(os.listdir(cfg.trained_model_dir)) == [
        "0.json", "0.npz", "1.json", "1.npz", "2.json", "2.npz", "latest.json", "latest.npz"]

    p = run.main(["--type", "evaluate", "--cfg_file", CFG, "--device", "cpu"] + opts)
    assert json.load(open(os.path.join(cfg.result_dir, "metrics.json")))["psnr"] == p
    png = read_png(os.path.join(cfg.result_dir, "gt_pred.png"))
    assert png.shape == (20, 48, 3)
    assert train_main.main(["--cfg_file", CFG, "--device", "cpu", "--test"] + opts) == p

    jopts = opts + ["result_dir", str(tmp_path / "jax_result")]
    want = jloop.eval_img_fit(jax_make_cfg(CFG, jopts))
    assert abs(p - float(want)) <= 1e-4, (p, want)

    # resume: one more epoch continues from the checkpoint's step
    train_main.main(["--cfg_file", CFG, "--device", "cpu"] + opts + ["train.epoch", "4"])
    st, epoch, _ = checkpoint.load_checkpoint(cfg.trained_model_dir,
                                              img_fit_loop.template_state(cfg, torch.device("cpu")))
    assert epoch == 3 and st.step == 4 * 20


def test_evaluate_without_a_checkpoint_raises(view, tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        run.main(["--type", "evaluate", "--cfg_file", CFG, "--device", "cpu"]
                 + _opts(view, tmp_path))
