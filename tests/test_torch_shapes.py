"""Frequency NeRFs of other shapes than the fused kernel's, against nerf_tpu on the CPU.

JAX runs any NeRF that its fused kernel does not cover (``supports``)
through XLA (``query_network_xla``); the port runs it through ``query_mlp``
(``freq_encode`` + ``apply_nerf_mlp``) in plain PyTorch. The models here are
random, D=4, W=64, skips [2], 6/2 frequency bands, with and without view
directions, their weights made by nerf_tpu's ``init_nerf_params`` and handed
to both sides as numpy arrays.

Tolerances:
- float32 query and MLP: atol 1e-5 + rtol 1e-5 (float32 sums of at most
  64 + 39 terms in another order, outputs of order 1).
- bfloat16: both sides round every operand to bf16 and sum in float32 in
  another order; a sum next to a bf16 rounding boundary rounds differently
  and the one-ulp (0.4%) step propagates, so 5% of (1 + |want|) per element
  and 99% of the elements within 1e-4 of (1 + |want|), as
  tests/test_torch_fused_mlp.py.
- one train step (perturb 0, raw_noise_std 0, the same fine samples fed to
  both sample_pdf): loss 1e-5 relative; each gradient leaf 2e-4 of its
  largest |value| + 1e-9 (float32 sums over the batch's samples in other
  orders, as tests/test_torch_train.py); the params after one Adam step on
  the same gradients 1e-6 absolute.
- checkpoints: exact.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_tpu.config import default_cfg as jax_default_cfg
from nerf_tpu.models.nerf_mlp import apply_nerf_mlp as jax_apply
from nerf_tpu.render import renderer as jrend
from nerf_tpu.train import checkpoint as jckpt
from nerf_tpu.train import optim as joptim
from nerf_tpu.train import state as jstate
from nerf_tpu.train.loop import init_nerf_params as jax_init_params

from nerf_tpu_torch.config import default_cfg
from nerf_tpu_torch.models.encoders import freq_encode
from nerf_tpu_torch.models.nerf_mlp import NeRFMLP, apply_nerf_mlp
from nerf_tpu_torch.ops import fused_mlp
from nerf_tpu_torch.render import renderer
from nerf_tpu_torch.render.rays import image_rays
from nerf_tpu_torch.serve import look_at_pose
from nerf_tpu_torch.train import checkpoint, optim
from nerf_tpu_torch.train import state as tstate
from nerf_tpu_torch.train.loop import init_nerf_params
from nerf_tpu_torch.tree import tree_flatten, tree_leaves, tree_map

SHAPE = dict(mlp_depth=4, mlp_width=64, skips=(2,), xyz_freqs=6, dir_freqs=2)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _opts(use_viewdirs, dtype="float32", **kw):
    common = dict(SHAPE, use_viewdirs=use_viewdirs, compute_dtype=dtype, perturb=0.0,
                  raw_noise_std=0.0, enable_ess=False, n_samples=8, n_importance=8, **kw)
    return (renderer.RenderOptions(**common),
            jrend.RenderOptions(**common, use_pallas=False, use_pallas_integrate=False))


def _jax_params(jopts, seed):
    return jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.PRNGKey(seed), jopts))


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def _points(n, s, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (n, s, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return pts, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _assert_close(got, want, dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        return
    rel = np.abs(got - want) / (1.0 + np.abs(want))
    assert rel.max() <= 5e-2, rel.max()
    assert np.percentile(rel, 99) <= 1e-4, np.percentile(rel, 99)


def test_the_fused_kernel_does_not_cover_these_shapes():
    for vd in (True, False):
        opts, _ = _opts(vd)
        assert not fused_mlp.supports(opts)
    assert fused_mlp.supports(renderer.RenderOptions())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("use_viewdirs", [True, False])
def test_query_matches_query_network_xla(use_viewdirs, dtype):
    opts, jopts = _opts(use_viewdirs, dtype)
    tree = _jax_params(jopts, 3)
    pts, d = _points(32, 8, 4)
    want = jrend.query_network_xla(tree["fine"], jnp.asarray(pts), jnp.asarray(d), jopts)
    kp = renderer.kernel_params(tree, opts)
    assert isinstance(kp["fine"]["pts_linears"][0]["w"], torch.Tensor)
    got = renderer.query(kp["fine"], torch.from_numpy(pts), torch.from_numpy(d), opts)
    assert got.shape == (32, 8, 4) and got.dtype == torch.float32
    _assert_close(got.numpy(), want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("use_viewdirs", [True, False])
def test_apply_nerf_mlp_matches_jax(use_viewdirs, dtype):
    opts, jopts = _opts(use_viewdirs, dtype)
    tree = _jax_params(jopts, 5)["coarse"]
    pts, d = _points(64, 1, 6)
    x = torch.cat([freq_encode(torch.from_numpy(pts[:, 0]), 6), freq_encode(torch.from_numpy(d), 2)],
                  -1)
    want = jax_apply(tree, jnp.asarray(x.numpy()), input_ch=opts.input_ch, skips=(2,),
                     use_viewdirs=use_viewdirs, compute_dtype=jnp.dtype(dtype))
    got = apply_nerf_mlp(_torch(tree), x, opts.input_ch, (2,), DTYPES[dtype], use_viewdirs)
    _assert_close(got.numpy(), want, dtype)
    mlp = NeRFMLP.from_tree(tree, skips=(2,))
    assert mlp.use_viewdirs == use_viewdirs
    np.testing.assert_allclose(mlp(x, DTYPES[dtype]).detach().numpy(), got.numpy(), rtol=0,
                               atol=0)


@pytest.mark.parametrize("use_viewdirs", [True, False])
def test_init_has_jax_shapes(use_viewdirs):
    opts, jopts = _opts(use_viewdirs)
    want = _jax_params(jopts, 0)
    got = init_nerf_params(torch.Generator().manual_seed(0), opts)
    jl = jax.tree_util.tree_leaves(want)
    gl, _ = tree_flatten(got)
    assert [tuple(a.shape) for a in gl] == [a.shape for a in jl]
    assert ("output_linear" in got["fine"]) == (not use_viewdirs)
    assert ("views_linears" in got["fine"]) == use_viewdirs


@pytest.mark.parametrize("use_viewdirs", [True, False])
def test_density_fn_matches_the_query(use_viewdirs):
    opts, jopts = _opts(use_viewdirs)
    kp = renderer.kernel_params(_jax_params(jopts, 7), opts)["coarse"]
    pts, d = _points(100, 1, 8)
    sigma = renderer.make_density_fn(kp, opts)(torch.from_numpy(pts[:, 0]))
    raw = renderer.query(kp, torch.from_numpy(pts), torch.zeros((100, 3)), opts)
    np.testing.assert_allclose(sigma.numpy(), np.maximum(raw[:, 0, 3].numpy(), 0), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("use_viewdirs", [True, False])
def test_one_train_step_matches_jax(monkeypatch, use_viewdirs):
    """Loss, every gradient and the params after one Adam step of a random
    D=4 W=64 model, on 48 rays of an orbit camera with random targets."""
    opts, jopts = _opts(use_viewdirs)
    tree = _jax_params(jopts, 11)
    n = 48
    K = torch.tensor([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]])
    o, d = image_rays(16, 16, K, torch.from_numpy(look_at_pose(0.7, 0.3, 4.0)))
    o, d = o[::5][:n].contiguous(), d[::5][:n].contiguous()
    tgt = np.random.default_rng(12).uniform(0, 1, (n, 3)).astype(np.float32)
    z_fine = np.sort(np.random.default_rng(13).uniform(2.0, 6.0, (n, 8)), -1).astype(np.float32)
    monkeypatch.setattr(jrend, "sample_pdf", lambda *a, **k: jnp.asarray(z_fine))
    monkeypatch.setattr(renderer, "sample_pdf", lambda *a, **k: torch.from_numpy(z_fine))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    (jloss, jstats), jgrads = jax.value_and_grad(jstate.nerf_loss, has_aux=True)(
        jparams, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jnp.asarray(tgt),
        jax.random.PRNGKey(0), jopts, None)
    params = tree_map(lambda t: t.requires_grad_(True), _torch(tree))
    loss, stats, grads = tstate.loss_and_grads(params, o, d, torch.from_numpy(tgt), opts, None)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in ("loss_coarse", "loss_fine", "psnr"):
        np.testing.assert_allclose(float(stats[k].detach()), float(jstats[k]), rtol=1e-5,
                                   err_msg=k)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jleaves)
    for i, (g, jg) in enumerate(zip(grads, jleaves)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=2e-4 * np.abs(jg).max() + 1e-9,
                                   err_msg=f"grad leaf {i}")
    jcfg = jax_default_cfg()
    tx = joptim.make_optimizer(jcfg)
    updates, _ = tx.update(jgrads, tx.init(jparams), jparams)
    jnew = optax.apply_updates(jparams, updates)
    # Adam's first step from zero moments moves each weight by lr g / (|g| +
    # eps): where g is within its float32 rounding of 0 that is +-lr either
    # way, so the update is held on the same (JAX's) gradients; the two
    # gradients are held above
    ptx = optim.make_optimizer(default_cfg())
    leaves = tree_leaves(params)
    ptx.step(leaves, [torch.from_numpy(np.asarray(g)) for g in jleaves], ptx.init(leaves))
    for i, (p, jp) in enumerate(zip(leaves, jax.tree_util.tree_leaves(jnew))):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6,
                                   err_msg=f"param leaf {i}")


def test_checkpoint_round_trip_without_views_linears(tmp_path):
    """A model without view directions: the port's checkpoint (output_linear
    before pts_linears) loads back through the port and through nerf_tpu,
    and ``load_params`` reads it by its shape, exactly."""
    opts, jopts = _opts(False)
    cfg = default_cfg()
    tx = optim.make_optimizer(cfg)
    state = tstate.init_state(init_nerf_params(torch.Generator().manual_seed(1), opts), tx)
    checkpoint.save_checkpoint(str(tmp_path), state, 3)
    template = tstate.init_state(init_nerf_params(torch.Generator().manual_seed(2), opts), tx)
    back, epoch, _ = checkpoint.load_checkpoint(str(tmp_path), template)
    assert epoch == 3
    for a, b in zip(tree_leaves(state.params), tree_leaves(back.params)):
        assert torch.equal(a.detach(), b.detach())
    loaded = checkpoint.load_params(str(tmp_path), **opts.model_shape())
    assert "views_linears" not in loaded["coarse"] and loaded["fine"]["output_linear"]["w"].shape == (64, 4)
    for a, b in zip(tree_leaves(state.params), tree_leaves(loaded)):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    jtx = joptim.make_optimizer(jax_default_cfg())
    jtemplate = jstate.init_state(jax_init_params(jax.random.PRNGKey(0), jopts), jtx)
    jback, jepoch, _ = jckpt.load_checkpoint(str(tmp_path), jtemplate)
    assert jepoch == 3
    for a, b in zip(tree_leaves(state.params), jax.tree_util.tree_leaves(jback.params)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="leaf_0"):  # read as a view-direction model
        checkpoint.load_params(str(tmp_path), **dataclasses.replace(
            opts, use_viewdirs=True).model_shape())


@pytest.mark.parametrize("use_viewdirs", [True, False])
def test_train_and_serve_entry_points_take_other_shapes(tmp_path, use_viewdirs):
    """train() on a tiny synthetic scene, then the render service on its
    checkpoint, for a D=4 W=64 model, on the CPU."""
    from nerf_tpu_torch.config import make_cfg
    from nerf_tpu_torch.serve import RenderService
    from nerf_tpu_torch.train.loop import train

    overrides = ["train_dataset_module", "synthetic", "test_dataset_module", "synthetic",
                 "train_dataset.H", "16", "train_dataset.W", "16", "task_arg.N_rays", "32",
                 "task_arg.N_samples", "8", "task_arg.N_importance", "8",
                 "task_arg.use_viewdirs", str(use_viewdirs), "network.nerf.D", "4",
                 "network.nerf.W", "64", "network.nerf.skips", "[2]",
                 "network.xyz_encoder.freq", "6", "network.dir_encoder.freq", "2",
                 "ep_iter", "2", "train.epoch", "1", "grid_rebuild_ep", "1", "eval_ep", "100",
                 "occupancy_grid_resolution", "8", "render_tile_rays", "64",
                 "workspace", str(tmp_path / "ws")]
    cfg = make_cfg(os.path.join(os.path.dirname(__file__), "..", "configs", "nerf", "lego.yaml"),
                   overrides)
    state, grid = train(cfg, device="cpu")
    assert state.step == 2
    service = RenderService(cfg, size=8, device="cpu")
    rgb = service.render(0.5, 0.3, 4.0)
    assert rgb.shape == (8, 8, 3) and bool(torch.isfinite(torch.as_tensor(rgb)).all())
