"""Training KiloNeRF from images (``network_module: kilonerf``): nerf_tpu_torch against nerf_tpu.

One train step from JAX's initial parameters (``init_nerf_params``: one
draw of ``init_kilonerf`` for both passes), on a fed batch: the same rays,
targets, perturb 0 and fine samples (fed to both renderers' sample_pdf),
64 networks of hidden width 16 with 4 and 2 frequency bands (as
tests/test_torch_kilonerf_render.py), 4 dispatch rounds at capacity
factor 3. Tolerances:
- loss within 1e-5 relative; each gradient leaf within 1e-4 of the leaf's
  largest |value| (float32 sums in other orders; JAX packs 4 networks a
  product). With lego's 10 bands, the 2^9 band turns last-bit differences
  of the sample positions into 5e-5 of a feature: 2 of 64,512 elements of
  the coarse l1 gradient then came out 1.2x past this bound;
- params after the optimizer step (clip 40, Adam, the lego schedule): the
  port's step on its gradients against JAX's optimizer on the same
  gradients, within 1e-6 absolute. (Against JAX's step on JAX's gradients,
  Adam's first update g / (|g| + 1e-8) magnifies the gradients' float32
  differences where |g| is near 1e-8: one of 27,648 elements came out
  1.36e-6 apart; the gradients themselves are held above);
- coarse and fine: equal before the step, apart after it, on both sides;
- checkpoints, both directions: exact.
"""
import os

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

from nerf_tpu_torch.config import make_cfg
from nerf_tpu_torch.render import renderer
from nerf_tpu_torch.render.rays import rays_for_pixels
from nerf_tpu_torch.serve import look_at_pose
from nerf_tpu_torch.train import checkpoint, loop, optim, state as tstate
from nerf_tpu_torch.tree import tree_leaves

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
KILO_CFG = os.path.join(ROOT, "configs", "nerf", "lego_kilonerf.yaml")
SMALL = ["kilo.grid_size", "4", "kilo.hidden", "16", "network.xyz_encoder.freq", "4",
         "network.dir_encoder.freq", "2", "task_arg.N_samples", "8",
         "task_arg.N_importance", "8", "task_arg.perturb", "0", "enable_ess", "False"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    poses = np.stack([look_at_pose(t, 0.3, 3.0) for t in (0.5, 2.5)])
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)
    idx, px, py = rng.integers(0, 2, n), rng.integers(0, 32, n), rng.integers(0, 32, n)
    o, d = rays_for_pixels(torch.from_numpy(px.astype(np.float32)),
                           torch.from_numpy(py.astype(np.float32)), torch.from_numpy(K),
                           torch.from_numpy(poses[idx]))
    return o.numpy(), d.numpy(), rng.uniform(0, 1, (n, 3)).astype(np.float32)


def _port_params(opts, jparams):
    """init_nerf_params' tree holding JAX's initial values."""
    params = loop.init_nerf_params(torch.Generator().manual_seed(0), opts)
    with torch.no_grad():
        for t, j in zip(tree_leaves(params), jax.tree_util.tree_leaves(jparams)):
            t.copy_(torch.from_numpy(np.array(j)))
    return params


def test_kilonerf_init_trains_coarse_and_fine_apart():
    opts = renderer.RenderOptions.from_cfg(make_cfg(KILO_CFG, SMALL))
    p = loop.init_nerf_params(torch.Generator().manual_seed(0), opts)
    for c, f in zip(tree_leaves(p["coarse"]), tree_leaves(p["fine"])):
        assert c is not f and c.data_ptr() != f.data_ptr() and torch.equal(c, f)
        assert c.requires_grad and f.requires_grad and c.is_leaf and f.is_leaf
    assert len(tree_leaves(p)) == 20


def test_one_kilonerf_train_step_matches_jax(monkeypatch):
    n = 48
    cfg, jcfg = make_cfg(KILO_CFG, SMALL), jax_make_cfg(KILO_CFG, SMALL)
    jopts = jrend.RenderOptions.from_cfg(jcfg)
    opts = renderer.RenderOptions.from_cfg(cfg)
    assert opts.kilonerf and jopts.network_type == "kilonerf" and opts.kilo_dispatch_rounds == 4
    jparams = jax_init_params(jax.random.PRNGKey(0), jopts)
    params = _port_params(opts, jparams)
    o, d, tgt = _rays(n, 1)
    z_fine = np.sort(np.random.default_rng(2).uniform(2.0, 6.0, (n, 8)), -1).astype(np.float32)
    monkeypatch.setattr(jrend, "sample_pdf", lambda *a, **k: jnp.asarray(z_fine))
    monkeypatch.setattr(renderer, "sample_pdf", lambda *a, **k: torch.from_numpy(z_fine))

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(jstate.nerf_loss, has_aux=True),
                                      static_argnums=(5,))(
        jparams, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tgt), jax.random.PRNGKey(0),
        jopts, None)
    loss, stats, grads = tstate.loss_and_grads(params, torch.from_numpy(o), torch.from_numpy(d),
                                               torch.from_numpy(tgt), opts, None)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in ("loss_coarse", "loss_fine", "psnr"):
        np.testing.assert_allclose(float(stats[k].detach()), float(jstats[k]), rtol=1e-5,
                                   err_msg=k)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jleaves) == 20
    for i, (g, jg) in enumerate(zip(grads, jleaves)):
        jg = np.asarray(jg)
        assert np.abs(jg).max() > 0, f"leaf {i} has no gradient"
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-4 * np.abs(jg).max(),
                                   err_msg=f"grad leaf {i}")

    tx = joptim.make_optimizer(jcfg)
    jst = jstate.init_state(jparams, tx)
    port_grads = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jgrads),
                                              [jnp.asarray(g.numpy()) for g in grads])
    updates, _ = tx.update(port_grads, jst.opt_state, jst.params)
    jnew = optax.apply_updates(jst.params, updates)
    tx_port = optim.make_optimizer(cfg)
    st = tstate.init_state(params, tx_port)
    tx_port.step(tree_leaves(st.params), grads, st.opt_state)
    for i, (p, jp) in enumerate(zip(tree_leaves(st.params), jax.tree_util.tree_leaves(jnew))):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6,
                                   err_msg=f"param leaf {i}")
    for name in ("l1", "l3", "l5"):
        assert not torch.equal(st.params["coarse"][name]["w"], st.params["fine"][name]["w"])
        assert not np.array_equal(np.asarray(jnew["coarse"][name]["w"]),
                                  np.asarray(jnew["fine"][name]["w"]))


def test_train_kilonerf_from_images_and_checkpoints_load_in_jax(tmp_path):
    """train() on the synthetic scene (4 images of 16x16), 2 epochs of 3
    steps with a grid rebuild and validation; the checkpoint loads in the
    JAX package's load_checkpoint with the leaves it saved."""
    over = SMALL + ["train_dataset_module", "synthetic", "test_dataset_module", "synthetic",
                    "train_dataset.H", "16", "train_dataset.W", "16",
                    "train_dataset.n_images", "4", "test_dataset.H", "8", "test_dataset.W", "8",
                    "task_arg.N_rays", "32", "ep_iter", "3", "train.epoch", "2", "eval_ep", "1",
                    "enable_ess", "True", "occupancy_grid_resolution", "8", "grid_rebuild_ep",
                    "1", "trained_model_dir", str(tmp_path / "model"),
                    "record_dir", str(tmp_path / "record")]
    cfg = make_cfg(KILO_CFG, over)
    state, grid = loop.train(cfg, device="cpu")
    assert state.step == 6 and grid is not None
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(state.params))
    assert not torch.equal(state.params["coarse"]["l1"]["w"], state.params["fine"]["l1"]["w"])
    with np.load(tmp_path / "model" / "latest.npz") as data:
        assert len(data.files) == 63  # 20 params, count, 20 mu, 20 nu, schedule count, step
    jcfg = jax_make_cfg(KILO_CFG, over)
    jopts = jrend.RenderOptions.from_cfg(jcfg)
    template = jstate.init_state(jax_init_params(jax.random.PRNGKey(0), jopts),
                                 joptim.make_optimizer(jcfg))
    jst, epoch, _ = jckpt.load_checkpoint(str(tmp_path / "model"), template)
    assert epoch == 1 and int(jst.step) == 6
    for a, b in zip(tree_leaves(state.params), jax.tree_util.tree_leaves(jst.params)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    for a, b in zip(state.opt_state.leaves(), jax.tree_util.tree_leaves(jst.opt_state)):
        np.testing.assert_array_equal(a.numpy() if isinstance(a, torch.Tensor) else a,
                                      np.asarray(b))


def test_jax_kilonerf_checkpoint_resumes_in_the_port(tmp_path):
    cfg, jcfg = make_cfg(KILO_CFG, SMALL), jax_make_cfg(KILO_CFG, SMALL)
    jopts = jrend.RenderOptions.from_cfg(jcfg)
    tx = joptim.make_optimizer(jcfg)
    jparams = jax_init_params(jax.random.PRNGKey(4), jopts)
    jparams = {"coarse": jparams["coarse"],
               "fine": jax.tree_util.tree_map(lambda x: x * 0.5, jparams["fine"])}
    jckpt.save_checkpoint(str(tmp_path), jstate.init_state(jparams, tx), 7)
    opts = renderer.RenderOptions.from_cfg(cfg)
    template = tstate.init_state(loop.init_nerf_params(torch.Generator().manual_seed(0), opts),
                                 optim.make_optimizer(cfg))
    st, epoch, _ = checkpoint.load_checkpoint(str(tmp_path), template)
    assert epoch == 7 and st.step == 0
    for a, b in zip(tree_leaves(st.params), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    assert torch.equal(st.params["fine"]["l2"]["b"] * 2, st.params["coarse"]["l2"]["b"])
