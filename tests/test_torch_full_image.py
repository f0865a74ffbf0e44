"""The port's whole-image train step (``train_full_image``) against nerf_tpu on the CPU.

``nerf_tpu.train.state.train_step_full_image`` renders every ray of one
image with gradients, sums the gradients over tiles and takes one step; the
port's ``train_step_full_image`` does the same in eager tiles. Both sides
get the committed lego state (epoch 49: params, Adam's moments and counts),
one 8x8 image (so both pick image 0), perturb 0, float32 weights and the
same fine samples (a fixed grid fed to both sample_pdf by monkeypatching).
The JAX side pads the image's 64 rays to whole tiles of 24 (8 padded rays
masked out); the port's last tile holds the 16 rays left.

Tolerances, as tests/test_torch_train.py: losses 1e-5 relative; each
gradient leaf 2e-4 of its largest |value| + 1e-9 (float32 sums over the
image's samples and tiles in other orders). Tile accumulation against one
tile: params 1e-6 absolute and the loss 1e-6, as
tests/test_full_image_step.py.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_tpu.config import make_cfg as jax_make_cfg
from nerf_tpu.render import renderer as jrend
from nerf_tpu.train import checkpoint as jckpt
from nerf_tpu.train import optim as joptim
from nerf_tpu.train import state as jstate
from nerf_tpu.train.loop import init_nerf_params as jax_init_params

from nerf_tpu_torch.config import default_cfg, make_cfg
from nerf_tpu_torch.render import renderer
from nerf_tpu_torch.serve import look_at_pose
from nerf_tpu_torch.train import checkpoint, loop, optim
from nerf_tpu_torch.train import state as tstate
from nerf_tpu_torch.tree import tree_leaves

ROOT = os.path.join(os.path.dirname(__file__), "..")
LEGO_CFG = os.path.join(ROOT, "configs", "nerf", "lego.yaml")
LEGO = os.path.join(ROOT, "checkpoints", "nerf", "lego", "nerf")
OVERRIDES = ["network.dtype", "float32", "task_arg.perturb", "0", "task_arg.N_samples", "16",
             "task_arg.N_importance", "8", "enable_ess", "False"]
H = W = 8
GRAD_SCALE = 1e6
Z_FINE = np.linspace(2.5, 5.5, 8, dtype=np.float32)


def _scene():
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (1, H, W, 3), dtype=np.uint8)
    poses = look_at_pose(0.4, 0.35, 4.0)[None]
    K = np.array([[6.0, 0, 4], [0, 6.0, 4], [0, 0, 1]], np.float32)
    return images, poses, K


def _fixed_fine(monkeypatch):
    monkeypatch.setattr(jrend, "sample_pdf", lambda key, bins, w, n, **k: jnp.broadcast_to(
        jnp.asarray(Z_FINE), (bins.shape[0], n)))
    monkeypatch.setattr(renderer, "sample_pdf", lambda bins, w, n, *a, **k: torch.from_numpy(
        Z_FINE).expand(bins.shape[0], n).contiguous())


class _Spy:
    """An optimizer that keeps the gradients it is handed, then steps."""

    def __init__(self, tx):
        self.tx, self.grads = tx, None

    def step(self, leaves, grads, opt_state):
        self.grads = [g.clone() for g in grads]
        self.tx.step(leaves, grads, opt_state)


def test_full_image_step_matches_jax(monkeypatch):
    """Loss, loss_coarse, loss_fine, psnr and every gradient of one
    whole-image step. JAX's step applies ``optax.scale(GRAD_SCALE)``, so its
    update is its gradient times GRAD_SCALE (float32 keeps the gradient to
    2^-24 of that, far inside the gradient bound)."""
    _fixed_fine(monkeypatch)
    cfg, jcfg = make_cfg(LEGO_CFG, OVERRIDES), jax_make_cfg(LEGO_CFG, OVERRIDES)
    opts, jopts = renderer.RenderOptions.from_cfg(cfg), jrend.RenderOptions.from_cfg(jcfg)
    tx, jtx = optim.make_optimizer(cfg), joptim.make_optimizer(jcfg)
    template = tstate.init_state(loop.init_nerf_params(torch.Generator().manual_seed(0), opts),
                                 tx)
    pst = checkpoint.load_checkpoint(LEGO, template)[0]
    jtemplate = jstate.init_state(jax_init_params(jax.random.PRNGKey(0), jopts), jtx)
    jst = jckpt.load_checkpoint(LEGO, jtemplate)[0]
    before = [np.array(a) for a in jax.tree_util.tree_leaves(jst.params)]
    scale = optax.scale(GRAD_SCALE)
    jst = jstate.TrainState(jst.params, scale.init(jst.params), jst.step)
    images, poses, K = _scene()
    jnew, jstats = jstate.train_step_full_image(
        jst, jnp.asarray(images), jnp.asarray(poses), jnp.asarray(K), jax.random.PRNGKey(0),
        scale, jopts, H, W, tile=24)
    spy = _Spy(tx)
    stats = tstate.train_step_full_image(pst, torch.from_numpy(images), torch.from_numpy(poses),
                                         torch.from_numpy(K), spy, opts, H, W, tile=24)
    assert pst.step == int(jnew.step) == 12501
    assert set(stats) == set(jstats)
    for k in ("loss", "loss_coarse", "loss_fine", "psnr"):
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-5, err_msg=k)
    after = jax.tree_util.tree_leaves(jnew.params)
    assert len(spy.grads) == len(after) == 48
    for i, (g, a, b) in enumerate(zip(spy.grads, after, before)):
        jg = (np.asarray(a, np.float64) - b) / GRAD_SCALE
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=2e-4 * np.abs(jg).max() + 1e-9,
                                   err_msg=f"grad leaf {i}")


@pytest.mark.parametrize("tile", [16, 24])
def test_tile_accumulation_matches_single_tile(tile):
    """The port's counterpart of tests/test_full_image_step.py's test: tiles
    of 16 or 24 rays (the last one short) against one tile of the whole
    image, from the same random state (no fine pass, perturb 0: no random
    numbers are drawn but the image's index)."""
    opts = renderer.RenderOptions(n_samples=4, n_importance=0, compute_dtype="float32",
                                  enable_ess=False, enable_ert=False, perturb=0.0)
    tx = optim.make_optimizer(default_cfg())
    images, poses, K = (torch.from_numpy(a) for a in _scene())
    outs = {}
    for t in (tile, H * W):
        state = tstate.init_state(loop.init_nerf_params(torch.Generator().manual_seed(1), opts),
                                  tx)
        stats = tstate.train_step_full_image(state, images, poses, K, tx, opts, H, W, tile=t)
        outs[t] = ([p.detach().clone() for p in tree_leaves(state.params)], float(stats["loss"]))
        assert float(stats["loss_fine"]) == 0.0 and float(stats["psnr"]) == pytest.approx(
            -10 * np.log10(float(stats["loss_coarse"])), rel=1e-6)
    for a, b in zip(outs[tile][0], outs[H * W][0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    assert abs(outs[tile][1] - outs[H * W][1]) < 1e-6


@pytest.mark.parametrize("log_interval", [1, 2])
def test_train_full_image_mode(tmp_path, capsys, log_interval):
    """cfg.train_full_image routes train() through whole-image steps: ep_iter
    of them an epoch, logged every log_interval steps, the rays/s line
    counting H x W rays a step (the counterpart of
    tests/test_train_loop.py::test_train_full_image_mode)."""
    ep_iter = 2
    cfg = make_cfg(LEGO_CFG, [
        "train_dataset_module", "synthetic", "test_dataset_module", "synthetic",
        "train_dataset.H", str(H), "train_dataset.W", str(W), "train_dataset.n_images", "2",
        "task_arg.N_rays", "5", "task_arg.N_samples", "8", "task_arg.N_importance", "8",
        "network.nerf.D", "2", "network.nerf.W", "32", "network.nerf.skips", "[0]",
        "train_full_image", "True", "ep_iter", str(ep_iter), "train.epoch", "1",
        "log_interval", str(log_interval), "eval_ep", "100", "grid_rebuild_ep", "100",
        "occupancy_grid_resolution", "8", "render_tile_rays", "24",
        "workspace", str(tmp_path / "ws")])
    state, _ = loop.train(cfg, device="cpu")
    assert state.step == ep_iter
    text = capsys.readouterr().out
    iters = re.findall(r"epoch 0 iter (\d+)/2 ", text)
    assert iters == [str(i) for i in range(log_interval, ep_iter + 1, log_interval)]
    m = re.search(r"epoch 0 done in (\S+)s  \((\S+) train rays/s\)", text)
    secs, rate = float(m.group(1)), float(m.group(2).replace(",", ""))
    # the line's seconds are rounded to 0.01: the rate it implies for H x W
    # rays a step, not for N_rays
    lo, hi = ep_iter * H * W / (secs + 0.005), ep_iter * H * W / max(secs - 0.005, 1e-9)
    assert lo - 1 <= rate <= hi + 1, (rate, lo, hi)
