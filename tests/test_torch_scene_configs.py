"""Every shipped NeRF yaml through the port, as ``tests/test_all_scene_configs.py``
drives them through the JAX package.

- The 8 ``nerf_synthetic`` scene yamls each train 2 steps and write a
  checkpoint through the port's trainer CLI (``nerf_tpu_torch.train``'s
  ``main``, ``--device cpu``) on a 2-frame scene written under the scene's
  own name by ``write_blender_scene``, at JAX's micro sizes.
- The 4 lego variants each build the port's trainer: options, params,
  optimizer, train state and kernel params.
- ``lego_400_coarse`` (``N_importance 0``): the committed lego weights in
  float32, perturb 0, no ESS grid, the same 160 rays through both
  renderers: colours and opacity within 1e-4, depth within 1e-3
  (``tests/test_torch_render.py``'s bounds: float32 sums of 64 samples in
  other orders; measured 1.1e-5); no fine map on either side. One train
  step: loss 1e-5 relative, each coarse gradient leaf within 2e-4 of its
  largest |value|
  (``tests/test_torch_train.py``'s bounds), every fine gradient zero on
  both sides.
- ``lego_hashgrid`` (the corner layout) at small widths (4 levels of 2^10
  rows, a 2x32 MLP): JAX's init, its bf16 tables redrawn from N(0, 10^2) so
  that the density varies in space (JAX's U(-1e-4, 1e-4) tables give a
  constant one), carried into the port through JAX's checkpoint
  writer and the port's reader (bit for bit). Render: colours and
  opacities within 1e-4, depths within 2e-2 (``tests/test_torch_hashgrid.py``'s
  float32 bounds). One step (the same fine samples on both sides): loss
  1e-5 relative, MLP gradients 2e-4 of their largest, each table gradient
  element within the bf16-accumulation bound of ``test_torch_hashgrid.py``
  (JAX adds the bf16 cotangent rows in bf16, the port in float32).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.config import make_cfg as jax_make_cfg
from nerf_tpu.render import renderer as jrend
from nerf_tpu.train import checkpoint as jckpt
from nerf_tpu.train import optim as joptim
from nerf_tpu.train import state as jstate
from nerf_tpu.train.loop import init_nerf_params as jax_init_params

from nerf_tpu_torch.config import make_cfg
from nerf_tpu_torch.data.blender import write_blender_scene
from nerf_tpu_torch.ops import hash_gather
from nerf_tpu_torch.render import renderer
from nerf_tpu_torch.render.rays import rays_for_pixels
from nerf_tpu_torch.serve import look_at_pose
from nerf_tpu_torch.train import checkpoint, loop, optim, state as tstate
from nerf_tpu_torch.train.__main__ import main as train_main

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = os.path.join(ROOT, "configs", "nerf")
LEGO = os.path.join(ROOT, "checkpoints", "nerf", "lego", "nerf")
SCENES = ["chair", "drums", "ficus", "hotdog", "lego", "materials", "mic", "ship"]
VARIANTS = ["lego_400_coarse", "lego_hashgrid", "lego_hashgrid_cellpack", "lego_kilonerf"]
F32 = ["network.dtype", "float32", "task_arg.perturb", "0"]
U = 2.0 ** -24


def _cfg_file(name):
    return os.path.join(CONFIGS, f"{name}.yaml")


def _micro_scene(root, scene, size=24):
    """Two RGBA frames (alpha 255) for train and val, the camera 4 from the
    origin, under ``<root>/<scene>``."""
    rng = np.random.default_rng(sum(map(ord, scene)))
    pose = np.eye(4)
    pose[2, 3] = 4.0
    splits = {}
    for split in ("train", "val"):
        imgs = rng.integers(0, 255, (2, size, size, 4), dtype=np.uint8)
        imgs[..., 3] = 255
        splits[split] = (imgs, np.stack([pose, pose]))
    write_blender_scene(os.path.join(root, scene), splits, 0.7)
    return root


def _micro_overrides(data_root, tmp_path):
    """tests/test_all_scene_configs.py's micro sizes."""
    return ["train_dataset.data_root", data_root, "test_dataset.data_root", data_root,
            "train_dataset.H", "24", "train_dataset.W", "24",
            "test_dataset.H", "24", "test_dataset.W", "24",
            "task_arg.N_rays", "32", "task_arg.N_samples", "4", "task_arg.N_importance", "4",
            "network.nerf.W", "32", "network.nerf.D", "2", "network.nerf.skips", "[0]",
            "network.dtype", "float32",
            "ep_iter", "2", "train.epoch", "1", "log_interval", "1",
            "save_latest_ep", "1", "eval_ep", "1", "grid_rebuild_ep", "1",
            "occupancy_grid_resolution", "16", "render_tile_rays", "64",
            "mesh_devices", "1", "workspace", str(tmp_path / "ws")]


@pytest.mark.parametrize("scene", SCENES)
def test_scene_config_trains(scene, tmp_path, capsys):
    """configs/nerf/<scene>.yaml drives a micro train, validation and
    checkpoint through the port's trainer CLI."""
    data_root = _micro_scene(str(tmp_path / "data"), scene)
    argv = ["--device", "cpu", "--cfg_file", _cfg_file(scene)] + _micro_overrides(data_root,
                                                                                 tmp_path)
    cfg = make_cfg(_cfg_file(scene), argv[4:])
    assert cfg.scene == scene and f"/{scene}/" in cfg.trained_model_dir + "/"
    state, _ = train_main(argv)
    assert state.step == 2
    assert os.path.exists(os.path.join(cfg.trained_model_dir, "latest.npz"))
    text = capsys.readouterr().out
    assert "val psnr:" in text and text.strip().splitlines()[-1].startswith("kernel launches:")


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_config_builds(variant, tmp_path):
    """The lego variant yamls give coherent options, params, an optimizer,
    a train state and kernel params, as JAX's do."""
    over = ["task_arg.N_samples", "4", "task_arg.N_importance", "4",
            "network.nerf.W", "32", "network.nerf.D", "2", "network.nerf.skips", "[0]",
            "workspace", str(tmp_path / "ws")]
    cfg, jcfg = make_cfg(_cfg_file(variant), over), jax_make_cfg(_cfg_file(variant), over)
    opts, jopts = renderer.RenderOptions.from_cfg(cfg), jrend.RenderOptions.from_cfg(jcfg)
    assert opts.xyz_encoder_type == jopts.xyz_encoder_type
    assert opts.network_type == jopts.network_type
    if "hashgrid" in variant:
        assert opts.hashgrid
        assert opts.hash_layout == jopts.hash_layout == (
            "cellpack" if variant.endswith("cellpack") else "corner")
    if "kilonerf" in variant:
        assert opts.network_type == "kilonerf"
    params = loop.init_nerf_params(torch.Generator().manual_seed(0), opts)
    jparams = jax_init_params(jax.random.PRNGKey(0), jopts)
    shapes = [tuple(x.shape) for x in tstate.tree_leaves(params)]
    assert shapes == [tuple(x.shape) for x in jax.tree_util.tree_leaves(jparams)]
    state = tstate.init_state(params, optim.make_optimizer(cfg))
    assert all(torch.isfinite(x.detach().float()).all() for x in tstate.tree_leaves(state.params))
    renderer.kernel_params(state.params, opts)
    assert cfg.exp_name == jcfg.exp_name and cfg.trained_model_dir == jcfg.trained_model_dir


def _rays(n, seed, lo=0, hi=32):
    rng = np.random.default_rng(seed)
    poses = np.stack([look_at_pose(t, 0.3, 4.0) for t in (0.5, 2.5)])
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)
    idx, px, py = rng.integers(0, 2, n), rng.integers(lo, hi, n), rng.integers(lo, hi, n)
    o, d = rays_for_pixels(torch.from_numpy(px.astype(np.float32)),
                           torch.from_numpy(py.astype(np.float32)), torch.from_numpy(K),
                           torch.from_numpy(poses[idx]))
    return o.numpy(), d.numpy(), rng.uniform(0, 1, (n, 3)).astype(np.float32)


def _states(cfg, jcfg, ckpt_dir):
    """(port state, its options), (JAX state, optimizer, options) from one
    checkpoint directory."""
    opts, jopts = renderer.RenderOptions.from_cfg(cfg), jrend.RenderOptions.from_cfg(jcfg)
    template = tstate.init_state(loop.init_nerf_params(torch.Generator().manual_seed(0), opts),
                                 optim.make_optimizer(cfg))
    pst = checkpoint.load_checkpoint(ckpt_dir, template)[0]
    tx = joptim.make_optimizer(jcfg)
    jst = jckpt.load_checkpoint(ckpt_dir, jstate.init_state(
        jax_init_params(jax.random.PRNGKey(0), jopts), tx))[0]
    return (pst, opts), (jax.tree_util.tree_map(jnp.asarray, jst), tx, jopts)


def _grads_match(grads, jgrads, skip=()):
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jleaves)
    for i, (g, jg) in enumerate(zip(grads, jleaves)):
        if i in skip:
            continue
        jg = np.asarray(jg, np.float32)
        np.testing.assert_allclose(g.float().numpy(), jg, rtol=0,
                                   atol=2e-4 * np.abs(jg).max() + 1e-9, err_msg=f"grad leaf {i}")
    return jleaves


def test_lego_400_coarse_renders_and_steps_as_jax():
    cfg_file = _cfg_file("lego_400_coarse")
    cfg, jcfg = make_cfg(cfg_file, F32), jax_make_cfg(cfg_file, F32)
    (pst, opts), (jst, _, jopts) = _states(cfg, jcfg, LEGO)
    assert opts.n_importance == jopts.n_importance == 0 and opts.n_samples == 64
    assert (cfg.train_dataset.input_ratio, cfg.test_dataset.input_ratio) == (0.5, 0.5)
    o, d, tgt = _rays(160, 21)
    want = jrend.render_rays(jst.params, jnp.asarray(o), jnp.asarray(d), jax.random.PRNGKey(0),
                             jopts, None)
    got = renderer.render_rays(renderer.kernel_params(pst.params, opts), torch.from_numpy(o),
                               torch.from_numpy(d), opts)
    assert "rgb_map" not in got and "rgb_map" not in want
    assert float(np.asarray(want["acc_map_0"]).mean()) > 0.1
    for k, tol in (("rgb_map_0", 1e-4), ("acc_map_0", 1e-4), ("depth_map_0", 1e-3)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=tol,
                                   err_msg=k)

    (jloss, jstats), jgrads = jax.value_and_grad(jstate.nerf_loss, has_aux=True)(
        jst.params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tgt), jax.random.PRNGKey(0),
        jopts, None)
    loss, stats, grads = tstate.loss_and_grads(pst.params, torch.from_numpy(o),
                                               torch.from_numpy(d), torch.from_numpy(tgt),
                                               opts, None)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert "loss_fine" not in stats and "loss_fine" not in jstats
    np.testing.assert_allclose(float(stats["psnr"].detach()), float(jstats["psnr"]), rtol=1e-5)
    jleaves = _grads_match(grads, jgrads)
    n_coarse = len(tstate.tree_leaves(pst.params["coarse"]))
    for g, jg in zip(grads[n_coarse:], jleaves[n_coarse:]):  # the fine MLP is not read
        assert not g.any() and not np.asarray(jg).any()
    assert all(g.abs().max() > 0 for g in grads[:n_coarse])


@pytest.mark.parametrize("n_importance", [0, 8])
def test_a_leaf_the_loss_does_not_reach_raises(n_importance):
    """Only the fine MLP without a fine pass gets zero gradients; any other
    leaf cut off from the loss (here one beside the MLPs) makes autograd
    raise, with or without a fine pass."""
    opts = renderer.RenderOptions(n_samples=4, n_importance=n_importance,
                                  compute_dtype="float32", enable_ess=False, enable_ert=False,
                                  perturb=0.0)
    params = loop.init_nerf_params(torch.Generator().manual_seed(3), opts)
    o, d, tgt = (torch.from_numpy(a) for a in _rays(8, 22))
    _, _, grads = tstate.loss_and_grads(params, o, d, tgt, opts, None)
    n_coarse = len(tstate.tree_leaves(params["coarse"]))
    assert all(bool(g.any()) != (n_importance == 0 and i >= n_coarse)
               for i, g in enumerate(grads))
    params["stray"] = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="not have been used"):
        tstate.loss_and_grads(params, o, d, tgt, opts, None)




HASH_SMALL = ["network.xyz_encoder.n_levels", "4", "network.xyz_encoder.log2_hashmap_size", "10",
              "network.nerf.W", "32", "network.nerf.D", "2"] + F32


@pytest.fixture(scope="module")
def corner_ckpt(tmp_path_factory):
    """A JAX checkpoint of the small corner hash-grid NeRF, its tables drawn
    from N(0, 10^2) (a density of 0.3-1.6 that varies in space)."""
    jcfg = jax_make_cfg(_cfg_file("lego_hashgrid"), HASH_SMALL)
    jopts = jrend.RenderOptions.from_cfg(jcfg)
    params = jax_init_params(jax.random.PRNGKey(3), jopts)
    rng = np.random.default_rng(4)
    for net in ("coarse", "fine"):
        t = params[net]["xyz_encoder"]["table"]
        params[net]["xyz_encoder"]["table"] = jnp.asarray(
            rng.normal(0, 10, t.shape).astype(np.float32), t.dtype)
    tx = joptim.make_optimizer(jcfg)
    path = str(tmp_path_factory.mktemp("corner"))
    jckpt.save_checkpoint(path, jstate.init_state(params, tx), 0, {})
    return path


def _accum_bound(idx, cot, n_rows, jax_grad):
    """Per element: |jax - f64| + 2^-8 |f64| + 2 n 2^-24 S
    (``tests/test_torch_hashgrid.py``)."""
    i = idx.long()
    c64 = cot.double()
    f64 = torch.zeros((n_rows, cot.shape[1]), dtype=torch.float64).index_add_(0, i, c64)
    mag = torch.zeros_like(f64).index_add_(0, i, c64.abs())
    cnt = torch.zeros((n_rows, 1), dtype=torch.float64).index_add_(
        0, i, torch.ones((i.shape[0], 1), dtype=torch.float64))
    dist = (torch.from_numpy(np.asarray(jax_grad, np.float64)) - f64).abs()
    return dist + 2.0 ** -8 * f64.abs() + 2.0 * cnt * U * mag


def test_lego_hashgrid_corner_renders_and_steps_as_jax(corner_ckpt, monkeypatch):
    cfg_file = _cfg_file("lego_hashgrid")
    cfg, jcfg = make_cfg(cfg_file, HASH_SMALL), jax_make_cfg(cfg_file, HASH_SMALL)
    (pst, opts), (jst, _, jopts) = _states(cfg, jcfg, corner_ckpt)
    assert opts.hash_layout == jopts.hash_layout == "corner" and opts.hashgrid
    table = pst.params["coarse"]["xyz_encoder"]["table"]
    jtable = np.asarray(jst.params["coarse"]["xyz_encoder"]["table"])
    assert table.dtype == torch.bfloat16 and table.shape == (4, 1024, 2)
    np.testing.assert_array_equal(table.view(torch.int16).numpy(), jtable.view(np.int16))

    o, d, tgt = _rays(160, 22, 8, 24)
    want = jrend.render_rays(jst.params, jnp.asarray(o), jnp.asarray(d), jax.random.PRNGKey(0),
                             jopts, None)
    got = renderer.render_rays(renderer.kernel_params(pst.params, opts), torch.from_numpy(o),
                               torch.from_numpy(d), opts)
    # softplus never gives 0 and the last sample's interval is 1e10, so every
    # ray is opaque: the depth's spread shows that the tables' features vary
    assert float(np.asarray(want["depth_map"]).std()) > 0.05
    for k in ("rgb_map_0", "rgb_map", "acc_map_0", "acc_map"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-4,
                                   err_msg=k)
    for k in ("depth_map_0", "depth_map"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=2e-2,
                                   err_msg=k)

    n = 48
    o, d, tgt = o[:n], d[:n], tgt[:n]
    z_fine = np.sort(np.random.default_rng(23).uniform(2.0, 6.0, (n, 128)), -1).astype(np.float32)
    monkeypatch.setattr(jrend, "sample_pdf", lambda *a, **k: jnp.asarray(z_fine))
    monkeypatch.setattr(renderer, "sample_pdf", lambda *a, **k: torch.from_numpy(z_fine))
    seen = []
    real = hash_gather.scatter_add_rows_plain

    def spy(idx, cot, n_rows):
        seen.append((idx, cot, n_rows))
        return real(idx, cot, n_rows)

    monkeypatch.setattr(hash_gather, "scatter_add_rows_plain", spy)
    (jloss, _), jgrads = jax.value_and_grad(jstate.nerf_loss, has_aux=True)(
        jst.params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tgt), jax.random.PRNGKey(0),
        jopts, None)
    loss, _, grads = tstate.loss_and_grads(pst.params, torch.from_numpy(o), torch.from_numpy(d),
                                           torch.from_numpy(tgt), opts, None)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    leaves = tstate.tree_leaves(pst.params)
    tables = [i for i, p in enumerate(leaves) if p.dtype == torch.bfloat16]
    assert len(tables) == 2 and len(seen) == 2
    jleaves = _grads_match(grads, jgrads, skip=tables)
    coarse, fine = sorted(seen, key=lambda c: c[1].shape[0])  # 64 and 192 samples a ray
    for i, (idx, cot, n_rows) in zip(tables, (coarse, fine)):
        want = np.asarray(jleaves[i].astype(jnp.float32)).reshape(n_rows, -1)
        bound = _accum_bound(idx, cot, n_rows, want)
        err = (grads[i].float().reshape(n_rows, -1).double()
               - torch.from_numpy(want.copy()).double()).abs()
        assert grads[i].dtype == torch.bfloat16 and bool((err <= bound).all()), i
        assert np.abs(want).max() > 0
