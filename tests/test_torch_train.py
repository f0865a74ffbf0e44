"""nerf_tpu_torch's training path against nerf_tpu on the CPU.

Both sides get the same inputs, made with numpy: the committed lego state
(checkpoints/nerf/lego/nerf, epoch 49: params, Adam's moments and counts),
the same rays and targets, perturb 0 and the same fine samples (fed to both
renderers' sample_pdf by monkeypatching), float32 weights so that the MLP
is the same function on both sides. Tolerances:
- one train step: loss 1e-5 relative; each gradient leaf 2e-4 of its
  largest |value| + 1e-9 (float32 sums over 12,288 samples in other orders,
  as tests/test_fused_bwd.py); params after Adam 1e-6 absolute (Adam moves
  each weight by ~lr = 4.5e-4 and the update's direction m / sqrt(v) carries
  the gradients' 2e-4 relative error: ~1e-7); mu and nu 1e-4 relative.
- compositing gradients (vjp of the same composite math): 1e-5 of the
  largest |value| + 1e-7.
- LR schedules: 1e-6 relative (float32 pow in two libraries).
- optimizer steps on random gradients against optax: 1e-6 relative + 1e-9.
- occupancy updates, checkpoints, datasets and metrics: exact.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_tpu.config import make_cfg as jax_make_cfg
from nerf_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from nerf_tpu.eval import metrics as jmetrics
from nerf_tpu.render import composite as jcomp
from nerf_tpu.render import occupancy as jocc
from nerf_tpu.render import renderer as jrend
from nerf_tpu.render.rays import rays_for_pixels as jax_rays_for_pixels
from nerf_tpu.train import checkpoint as jckpt
from nerf_tpu.train import optim as joptim
from nerf_tpu.train import state as jstate
from nerf_tpu.models.nerf_mlp import init_nerf_mlp as jax_init_mlp
from nerf_tpu.train import recorder as jrecorder
from nerf_tpu.train.loop import init_nerf_params as jax_init_params

from nerf_tpu_torch.config import make_cfg
from nerf_tpu_torch.data import make_dataset
from nerf_tpu_torch.eval import metrics
from nerf_tpu_torch.models.nerf_mlp import init_nerf_mlp
from nerf_tpu_torch.ops import integrate as tint
from nerf_tpu_torch.render import occupancy as occ
from nerf_tpu_torch.render import renderer
from nerf_tpu_torch.render.rays import rays_for_pixels
from nerf_tpu_torch.serve import look_at_pose
from nerf_tpu_torch.train import checkpoint, loop, optim, recorder, state as tstate
from nerf_tpu_torch.train.__main__ import main as train_main
from nerf_tpu_torch.tree import tree_leaves

ROOT = os.path.join(os.path.dirname(__file__), "..")
LEGO_CFG = os.path.join(ROOT, "configs", "nerf", "lego.yaml")
LEGO = os.path.join(ROOT, "checkpoints", "nerf", "lego", "nerf")
F32 = ["network.dtype", "float32", "task_arg.perturb", "0"]


def _port_state(cfg):
    opts = renderer.RenderOptions.from_cfg(cfg)
    template = tstate.init_state(loop.init_nerf_params(torch.Generator().manual_seed(0), opts),
                                 optim.make_optimizer(cfg))
    return checkpoint.load_checkpoint(LEGO, template)


def _jax_state(jcfg, ckpt_dir=LEGO):
    jopts = jrend.RenderOptions.from_cfg(jcfg)
    tx = joptim.make_optimizer(jcfg)
    template = jstate.init_state(jax_init_params(jax.random.PRNGKey(0), jopts), tx)
    return jckpt.load_checkpoint(ckpt_dir, template), tx, jopts


def _rays(n, seed):
    """n rays of two orbit cameras (32x32, focal 40) and random targets."""
    rng = np.random.default_rng(seed)
    poses = np.stack([look_at_pose(t, 0.3, 4.0) for t in (0.5, 2.5)])
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)
    idx, px, py = rng.integers(0, 2, n), rng.integers(0, 32, n), rng.integers(0, 32, n)
    o, d = rays_for_pixels(torch.from_numpy(px.astype(np.float32)),
                           torch.from_numpy(py.astype(np.float32)), torch.from_numpy(K),
                           torch.from_numpy(poses[idx]))
    tgt = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return o.numpy(), d.numpy(), tgt, (poses, K, idx, px, py)


def test_batched_rays_match_jax():
    o, d, _, (poses, K, idx, px, py) = _rays(16, 0)
    for i in range(16):
        jo, jd = jax_rays_for_pixels(jnp.float32(px[i]), jnp.float32(py[i]), jnp.asarray(K),
                                     jnp.asarray(poses[idx[i]]))
        np.testing.assert_allclose(o[i], np.asarray(jo), atol=1e-6)
        np.testing.assert_allclose(d[i], np.asarray(jd), atol=1e-6)


def test_one_train_step_matches_jax(monkeypatch):
    """Loss, every gradient and the params and Adam state after one update."""
    n = 64
    cfg = make_cfg(LEGO_CFG, F32)
    jcfg = jax_make_cfg(LEGO_CFG, F32)
    (jst, epoch, _), tx, jopts = _jax_state(jcfg)
    pst, pepoch, _ = _port_state(cfg)
    assert epoch == pepoch == 49 and int(jst.step) == pst.step == 12500
    opts = renderer.RenderOptions.from_cfg(cfg)
    o, d, tgt, _ = _rays(n, 1)
    z_fine = np.sort(np.random.default_rng(2).uniform(2.0, 6.0, (n, 128)), -1).astype(np.float32)
    monkeypatch.setattr(jrend, "sample_pdf", lambda *a, **k: jnp.asarray(z_fine))
    monkeypatch.setattr(renderer, "sample_pdf", lambda *a, **k: torch.from_numpy(z_fine))

    (jloss, jstats), jgrads = jax.value_and_grad(jstate.nerf_loss, has_aux=True)(
        jst.params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tgt), jax.random.PRNGKey(0),
        jopts, None)
    loss, stats, grads = tstate.loss_and_grads(pst.params, torch.from_numpy(o),
                                               torch.from_numpy(d), torch.from_numpy(tgt),
                                               opts, None)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in ("loss_coarse", "loss_fine", "psnr"):
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-5, err_msg=k)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jleaves) == 48
    for i, (g, jg) in enumerate(zip(grads, jleaves)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=2e-4 * np.abs(jg).max() + 1e-9,
                                   err_msg=f"grad leaf {i}")

    updates, jopt = tx.update(jgrads, jst.opt_state, jst.params)
    jparams = optax.apply_updates(jst.params, updates)
    tx_port = optim.make_optimizer(cfg)
    tx_port.step(tree_leaves(pst.params), grads, pst.opt_state)
    for i, (p, jp) in enumerate(zip(tree_leaves(pst.params), jax.tree_util.tree_leaves(jparams))):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6,
                                   err_msg=f"param leaf {i}")
    jopt_leaves = jax.tree_util.tree_leaves(jopt)
    port_opt = pst.opt_state.leaves()
    assert len(jopt_leaves) == len(port_opt) == 98
    assert port_opt[0] == int(jopt_leaves[0]) == 12501
    assert port_opt[-1] == int(jopt_leaves[-1]) == 12501
    for i, (a, b) in enumerate(zip(port_opt[1:-1], jopt_leaves[1:-1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(b)).max(), err_msg=f"moment {i}")


@pytest.mark.parametrize("ert", [0.0, 0.01])
@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_composite_function_gradients_match_jax(ert, act):
    rng = np.random.default_rng(5)
    n, s = 24, 40
    raw = rng.normal(size=(n, s, 4)).astype(np.float32)
    raw[..., 3] *= 5.0
    z = np.sort(rng.uniform(2, 6, (n, s)), -1).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    keys = ("rgb_map", "depth_map", "acc_map", "disp_map", "weights")
    cots = {k: rng.normal(size=s_).astype(np.float32)
            for k, s_ in zip(keys, [(n, 3), (n,), (n,), (n,), (n, s)])}

    def jloss(r, zz, dd):
        out = jcomp.composite(r, zz, dd, white_bkgd=True,
                              ert_threshold=None if ert <= 0 else ert, sigma_activation=act)
        return sum(jnp.sum(out[k] * cots[k]) for k in keys)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d))
    tr, tz, td = (torch.tensor(a, requires_grad=True) for a in (raw, z, d))
    out = tint.composite_kernel(tr, tz, td, ert_threshold=ert, sigma_activation=act)
    sum((out[k] * torch.from_numpy(cots[k])).sum() for k in keys).backward()
    for got, w, name in ((tr.grad, want[0], "raw"), (tz.grad, want[1], "z"), (td.grad, want[2], "d")):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max() + 1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["exponential", "exponential_floor", "warmup_linear",
                                  "warmup_constant", "multi_step"])
def test_lr_schedules_match_jax(kind):
    if kind.startswith("exponential"):
        floor = 1e-4 if kind.endswith("floor") else 0.0
        args = (5e-4, 0.1, 500, 500)
        got = optim.exponential_epoch_schedule(*args, lr_min=floor)
        want = joptim.exponential_epoch_schedule(*args, lr_min=floor)
    elif kind.startswith("warmup"):
        method = kind.split("_")[1]
        got = optim.warmup_multi_step_schedule(5e-4, [2000, 6000], 0.5, warmup_iters=700,
                                               warmup_method=method)
        want = joptim.warmup_multi_step_schedule(5e-4, [2000, 6000], 0.5, warmup_iters=700,
                                                 warmup_method=method)
    else:
        got = optim.multi_step_schedule(5e-4, [1000, 4000], 0.3)
        want = optax.piecewise_constant_schedule(5e-4, {1000: 0.3, 4000: 0.3})
    for step in [0, 1, 499, 500, 699, 700, 999, 1000, 1001, 3999, 4000, 12500, 250_000, 1_000_000]:
        np.testing.assert_allclose(float(got(step)), float(want(jnp.int32(step))), rtol=1e-6,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("kind,wd", [("adam", 0.0), ("adam", 0.01), ("radam", 0.0),
                                     ("radam", 0.01), ("sgd", 0.0), ("sgd", 0.01)])
def test_optimizer_matches_optax(kind, wd):
    over = ["train.optim", kind, "train.weight_decay", str(wd)]
    jtx, tx = joptim.make_optimizer(jax_make_cfg(LEGO_CFG, over)), optim.make_optimizer(
        make_cfg(LEGO_CFG, over))
    rng = np.random.default_rng(9)
    shapes = [(7, 5), (5,), (3, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.tensor(p) for p in params]
    jst, st = jtx.init(jp), tx.init(tp)
    for step in range(8):  # RAdam switches to its rectified update after step 5
        g = [(rng.normal(size=s) * (60.0 if step == 2 else 1.0)).astype(np.float32)
             for s in shapes]  # step 2 exceeds the clip at 40
        upd, jst = jtx.update([jnp.asarray(x) for x in g], jst, jp)
        jp = optax.apply_updates(jp, upd)
        tx.step(tp, [torch.tensor(x) for x in g], st)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9,
                                       err_msg=f"{kind} step {step}")
    assert len(st.leaves()) == len(jax.tree_util.tree_leaves(jst))


def test_update_from_samples_and_decay_match_jax():
    rng = np.random.default_rng(4)
    occupied = rng.uniform(size=(16, 16, 16)) < 0.3
    pts = rng.uniform(-2.5, 2.5, (500, 3)).astype(np.float32)
    density = rng.exponential(0.02, 500).astype(np.float32)
    jgrid = jocc.OccupancyGrid(jnp.asarray(occupied), jnp.full((3,), -2.0), jnp.full((3,), 2.0))
    grid = occ.OccupancyGrid(torch.from_numpy(occupied), torch.full((3,), -2.0),
                             torch.full((3,), 2.0))
    want = jocc.update_from_samples(jgrid, jnp.asarray(pts), jnp.asarray(density))
    got = occ.update_from_samples(grid, torch.from_numpy(pts), torch.from_numpy(density))
    np.testing.assert_array_equal(got.occupied.numpy(), np.asarray(want.occupied))
    assert got.occupied.sum() > grid.occupied.sum()
    key = jax.random.PRNGKey(3)
    want = jocc.decay(want, key, keep_prob=0.9)
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, (16, 16, 16))))
    got = occ.decay(got, keep_prob=0.9, u=u)
    np.testing.assert_array_equal(got.occupied.numpy(), np.asarray(want.occupied))
    full = occ.full_grid(8)
    np.testing.assert_array_equal(full.occupied.numpy(), np.asarray(jocc.full_grid(8).occupied))


def test_committed_checkpoint_round_trips_exactly(tmp_path):
    cfg = make_cfg(LEGO_CFG)
    state, epoch, rec = _port_state(cfg)
    checkpoint.save_checkpoint(str(tmp_path), state, epoch, rec)
    with np.load(os.path.join(LEGO, "latest.npz")) as a, \
            np.load(tmp_path / "latest.npz") as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) == 147
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert json.load(open(tmp_path / "latest.json")) == json.load(
        open(os.path.join(LEGO, "latest.json")))
    assert (tmp_path / "49.npz").exists()


def test_checkpoints_load_across_frameworks(tmp_path):
    cfg, jcfg = make_cfg(LEGO_CFG), jax_make_cfg(LEGO_CFG)
    state, _, _ = _port_state(cfg)
    with torch.no_grad():
        for leaf in tree_leaves(state.params):
            leaf.mul_(0.5)
    state.step, state.opt_state.count, state.opt_state.sched_count = 7, 8, 9
    checkpoint.save_checkpoint(str(tmp_path / "port"), state, 3, {"step": 7, "epoch": 3})
    (jst, epoch, rec), _, _ = _jax_state(jcfg, str(tmp_path / "port"))
    assert epoch == 3 and rec == {"step": 7, "epoch": 3} and int(jst.step) == 7
    for a, b in zip(tree_leaves(state.params), jax.tree_util.tree_leaves(jst.params)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    jleaves = jax.tree_util.tree_leaves(jst.opt_state)
    assert int(jleaves[0]) == 8 and int(jleaves[-1]) == 9

    jst = jst._replace(step=jnp.int32(11))
    jckpt.save_checkpoint(str(tmp_path / "jax"), jst, 5, {"step": 11, "epoch": 5})
    back, epoch, rec = checkpoint.load_checkpoint(str(tmp_path / "jax"), state)
    assert epoch == 5 and back.step == 11 and back.opt_state.count == 8
    for a, b in zip(checkpoint._state_leaves(back), jax.tree_util.tree_leaves(jst)):
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
        else:
            assert a == int(b)


def test_checkpoint_keeps_the_newest_five(tmp_path):
    state, _, _ = _port_state(make_cfg(LEGO_CFG))
    for ep in range(7):
        checkpoint.save_checkpoint(str(tmp_path), state, ep, latest=(ep == 6))
    assert sorted(p for p in os.listdir(tmp_path) if p.endswith(".npz")) == [
        "2.npz", "3.npz", "4.npz", "5.npz", "6.npz", "latest.npz"]
    checkpoint.wipe_dir(str(tmp_path))
    assert not tmp_path.exists()
    assert checkpoint.load_checkpoint(str(tmp_path), state) is None


def test_datasets_and_metrics_match_jax():
    cfg = make_cfg(LEGO_CFG, ["train_dataset_module", "synthetic", "train_dataset.n_images",
                              "3", "train_dataset.H", "12", "train_dataset.W", "10", "seed", "4"])
    ds, want = make_dataset(cfg, "train"), JaxSynthetic("train", 3, 12, 10, seed=4)
    for k in ("images", "poses", "K"):
        np.testing.assert_array_equal(getattr(ds, k), getattr(want, k), err_msg=k)
    with pytest.raises(FileNotFoundError, match="transforms_train.json"):
        make_dataset(make_cfg(LEGO_CFG), "train")
    a, b = ds.images[0], ds.images[1]
    assert metrics.mse(a, b) == jmetrics.mse(a, b) and metrics.psnr(a, b) == jmetrics.psnr(a, b)
    assert metrics.psnr(a, a) == float("inf")


def test_sample_ray_batch_targets_and_precrop():
    gen = torch.Generator().manual_seed(0)
    imgs = torch.randint(0, 256, (2, 20, 30, 3), generator=gen, dtype=torch.uint8)
    poses = torch.from_numpy(np.stack([look_at_pose(t, 0.3, 4.0) for t in (0.5, 2.5)]))
    K = torch.tensor([[30.0, 0, 15], [0, 30.0, 10], [0, 0, 1]])
    o, d, tgt = tstate.sample_ray_batch(gen, imgs, poses, K, 4096)
    assert o.shape == d.shape == tgt.shape == (4096, 3)
    torch.testing.assert_close(d.norm(dim=-1), torch.ones(4096))
    assert set(np.unique(np.round(tgt.numpy() * 255))) <= set(np.unique(imgs.numpy()))
    # precrop: the central half only, while step < precrop_iters
    gen = torch.Generator().manual_seed(1)
    marked = imgs.clone()
    marked[:, 5:15, 8:22] = 255  # exactly the crop of H // 2 +- 5, W // 2 +- 7
    _, _, tgt = tstate.sample_ray_batch(gen, marked, poses, K, 512, step=3, precrop_iters=10)
    assert bool((tgt == 1.0).all())


def test_train_runs_writes_a_checkpoint_and_resumes(tmp_path):
    """Two epochs of 2 steps on a 16x16 synthetic scene, then a resume to 4
    (as tests/test_train_loop.py), through the CLI on the CPU."""
    def argv(epochs):
        return ["--device", "cpu", "--cfg_file", LEGO_CFG, "train_dataset_module", "synthetic",
                "test_dataset_module", "synthetic", "train_dataset.H", "16",
                "train_dataset.W", "16", "test_dataset.H", "8", "test_dataset.W", "8",
                "task_arg.N_rays", "16", "task_arg.N_samples", "8",
                "task_arg.N_importance", "8", "ep_iter", "2", "train.epoch", str(epochs),
                "log_interval", "1", "save_latest_ep", "1", "grid_rebuild_ep", "2",
                "eval_ep", "2", "occupancy_grid_resolution", "8", "render_tile_rays", "64",
                "workspace", str(tmp_path / "ws")]

    state, grid = train_main(argv(2))
    assert state.step == 4 and grid.occupied.shape == (8, 8, 8)
    model_dir = tmp_path / "ws" / "trained_model" / "nerf" / "lego" / "nerf"
    assert (model_dir / "latest.npz").exists() and (model_dir / "1.npz").exists()
    state2, _ = train_main(argv(4))
    assert state2.step == 8
    assert json.load(open(model_dir / "latest.json"))["epoch"] == 3


def test_train_cli_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--cfg_file", LEGO_CFG, "train_dataset_module", "synthetic"])


def test_check_finite_stats():
    loop.check_finite_stats({"loss": 0.5, "psnr": float("inf")})
    with pytest.raises(FloatingPointError, match="loss"):
        loop.check_finite_stats({"loss": float("nan")}, epoch=3, iteration=250)


def test_init_nerf_mlp_has_jax_shapes_and_bounds():
    got = init_nerf_mlp(torch.Generator().manual_seed(0))
    want = jax_init_mlp(jax.random.PRNGKey(0))
    got_leaves, want_leaves = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves) == 24
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32 and g.requires_grad
    for layer in got["pts_linears"] + got["views_linears"]:
        bound = 1.0 / layer["w"].shape[0] ** 0.5
        for x in (layer["w"], layer["b"]):
            assert float(x.abs().max()) <= bound and float(x.abs().max()) > 0.9 * bound


def test_recorder_matches_jax():
    got, want = recorder.Recorder(use_tb=False), jrecorder.Recorder(use_tb=False)
    for i, v in enumerate([3.0, 1.0, 2.0, 7.0] * 7):
        got.update({"loss": v, "psnr": 10.0 + i})
        want.update({"loss": v, "psnr": 10.0 + i})
    for k in ("loss", "psnr"):
        for attr in ("median", "avg", "global_avg"):
            assert getattr(got.scalars[k], attr) == getattr(want.scalars[k], attr), (k, attr)
    got.step, got.epoch = 12, 3
    back = recorder.Recorder(use_tb=False)
    back.load_state_dict(got.state_dict())
    assert back.state_dict() == {"step": 12, "epoch": 3} == got.state_dict()
    assert got.log_line() == want.log_line().replace("step 0  epoch 0", "step 12  epoch 3")
