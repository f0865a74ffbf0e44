"""KiloNeRF distillation (``nerf_tpu_torch.train.distill``, the distill CLI)
against ``nerf_tpu.ops.kilonerf.distill_step`` on the CPU.

JAX's PRNG and torch's generators differ, so the port is given JAX's own
batch: the test draws it with the JAX package's calls and keys (jitted, as
``distill_step`` draws it), checks that JAX's step on that key gives the same
loss as its loss on the drawn batch (so the batch and the capacity are the
step's), and feeds the batch to the port. Tiny teacher (D=2, W=16, 2/1
bands, float32) and student (grid 4, hidden 8, 4/2 bands).
Tolerances: the loss within 2e-6 (float32 means of 512 x 3 terms), each
gradient leaf within 1e-4 of its largest |value| (float32 sums in another
order), one Adam step on the same gradients within 1e-6, checkpoints exact.
"""
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import run as jax_run
from nerf_tpu.config import make_cfg as jax_make_cfg
from nerf_tpu.ops import kilonerf as jk
from nerf_tpu.render import renderer as jrend
from nerf_tpu.train import checkpoint as jckpt
from nerf_tpu.train.loop import init_nerf_params as jax_init_params
from nerf_tpu.train.state import TrainState as JaxTrainState

from nerf_tpu_torch import distill_kilonerf
from nerf_tpu_torch.config import make_cfg
from nerf_tpu_torch.ops import kilonerf as tk
from nerf_tpu_torch.render import renderer
from nerf_tpu_torch.train import checkpoint, distill
from nerf_tpu_torch.train.loop import init_nerf_params
from nerf_tpu_torch.train.optim import make_optimizer, plain_adam
from nerf_tpu_torch.train.state import init_state
from nerf_tpu_torch.tree import tree_leaves

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
N_PTS, OCC_FRAC, VOXEL = 512, 0.5, 0.25
KCFG = dict(grid_size=4, hidden=8, xyz_freqs=4, dir_freqs=2)
TEACHER = dict(compute_dtype="float32", mlp_depth=2, mlp_width=16, skips=(), xyz_freqs=2,
               dir_freqs=1)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these tests run many small ops, and with several
    test workers on the machine torch's thread pool spins against itself."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _teachers():
    jopts = jrend.RenderOptions(use_pallas=False, use_pallas_integrate=False, **TEACHER)
    topts = renderer.RenderOptions(use_fused_mlp=False, use_integrate_kernel=False, **TEACHER)
    jp = jax_init_params(jax.random.PRNGKey(11), jopts)
    kp = renderer.kernel_params(jax.tree_util.tree_map(np.asarray, jp), topts)

    def jteacher(pts, dirs):
        return jrend.query_network_xla(jp["fine"], pts, dirs, jopts)

    def tteacher(pts, dirs):
        return renderer.query(kp["fine"], pts, dirs, topts)

    return jteacher, tteacher


def _centres():
    """Occupied centres packed in two networks' cells: far more points there
    than the capacity's per-voxel mean allows, so the step drops points."""
    rng = np.random.RandomState(4)
    a = rng.uniform(0.1, 0.9, (14, 3))
    b = rng.uniform(-1.9, -1.1, (6, 3))
    return np.concatenate([a, b]).astype(np.float32)


@partial(jax.jit, static_argnames=("occ",))
def _jax_batch(key, centres, occ):
    """distill_step's draws (nerf_tpu/ops/kilonerf.py:362-381), the same calls."""
    cfg = jk.KiloConfig(**KCFG)
    k1, k2 = jax.random.split(key)
    if occ:
        k1a, k1b, k1c = jax.random.split(k1, 3)
        n_occ = int(N_PTS * OCC_FRAC)
        vid = jax.random.randint(k1a, (n_occ,), 0, centres.shape[0])
        jitter = jax.random.uniform(k1b, (n_occ, 3), jnp.float32, -0.5, 0.5) * VOXEL
        pts_uni = jax.random.uniform(k1c, (N_PTS - n_occ, 3), jnp.float32, cfg.bbox_min,
                                     cfg.bbox_max)
        pts = jnp.clip(jnp.concatenate([centres[vid] + jitter, pts_uni]), cfg.bbox_min,
                       cfg.bbox_max)
    else:
        pts = jax.random.uniform(k1, (N_PTS, 3), jnp.float32, cfg.bbox_min, cfg.bbox_max)
    dirs = jax.random.normal(k2, (N_PTS, 3), jnp.float32)
    return pts, dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)


def _jax_loss_fn(pts, dirs, t_raw, cfg, capacity):
    t_rgb = jax.nn.sigmoid(t_raw[..., :3])
    t_sigma = jnp.log1p(jax.nn.relu(t_raw[..., 3]))

    def loss_fn(p):
        raw = jk.kilonerf_eval(p, pts, dirs, cfg, capacity=capacity)
        rgb = jax.nn.sigmoid(raw[..., :3])
        sigma = jnp.log1p(jax.nn.relu(raw[..., 3]))
        return jnp.mean((rgb - t_rgb) ** 2) + jnp.mean((sigma - t_sigma) ** 2)

    return loss_fn


@pytest.mark.parametrize("occ", [True, False], ids=["occupancy", "uniform"])
def test_loss_gradients_and_capacity_match_jax(occ):
    jcfg, tcfg = jk.KiloConfig(**KCFG), tk.KiloConfig(**KCFG)
    jteacher, tteacher = _teachers()
    jp = jk.init_kilonerf(jax.random.PRNGKey(0), jcfg)
    centres = _centres()
    key = jax.random.PRNGKey(3)
    pts, dirs = _jax_batch(key, jnp.asarray(centres), occ)

    # the port's capacity for this batch; 0 is kilonerf_eval's default, as in JAX
    n_occ = int(N_PTS * OCC_FRAC)
    capacity = distill.distill_capacity(N_PTS, n_occ, len(centres)) if occ else 0
    gen = torch.Generator().manual_seed(0)
    _, _, sampled_cap = distill.sample_batch(gen, tcfg, N_PTS, torch.from_numpy(centres)
                                             if occ else None, VOXEL, OCC_FRAC)
    assert sampled_cap == capacity
    t_raw = jteacher(pts[:, None, :], dirs)[:, 0, :]
    jloss, jgrads = jax.value_and_grad(_jax_loss_fn(pts, dirs, t_raw, jcfg, capacity))(jp)

    # JAX's own step on the same key: the same loss, so the same batch and capacity
    tx = optax.adam(1e-3)
    _, _, step_loss = jk.distill_step(
        jax.tree_util.tree_map(jnp.copy, jp), tx.init(jp), key, jteacher, tx.update, jcfg,
        n_pts=N_PTS, occ_centers=jnp.asarray(centres) if occ else None, voxel_size=VOXEL,
        occ_frac=OCC_FRAC)
    assert float(step_loss) == pytest.approx(float(jloss), abs=1e-7)

    tp = checkpoint.from_jax_kilonerf(jax.tree_util.tree_map(np.asarray, jp), requires_grad=True)
    p, d = torch.from_numpy(np.asarray(pts)), torch.from_numpy(np.asarray(dirs))
    with torch.no_grad():
        t_rgb, t_sigma = distill.teacher_targets(tteacher(p[:, None, :], d)[:, 0, :])
    loss = distill.distill_loss(tp, p, d, t_rgb, t_sigma, tcfg, capacity)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), abs=2e-6)
    served = sum(tk.served_per_round(p, tcfg, capacity))
    assert (served < N_PTS) == occ  # the occupied half overflows its capacity (C2)
    for name in tk.LAYERS:
        for leaf in ("w", "b"):
            want = np.asarray(jgrads[name][leaf])
            np.testing.assert_allclose(tp[name][leaf].grad.numpy(), want, rtol=0,
                                       atol=1e-4 * np.abs(want).max(), err_msg=f"{name}.{leaf}")

    # distill_update on that batch: the same loss, and a step taken
    state = init_state(checkpoint.from_jax_kilonerf(
        jax.tree_util.tree_map(np.asarray, jp), requires_grad=True), plain_adam(1e-3))
    before = state.params["l1"]["w"].detach().clone()
    got = distill.distill_update(state, plain_adam(1e-3), p, d, capacity, tteacher, tcfg)
    assert float(got) == pytest.approx(float(jloss), abs=2e-6)
    assert state.step == 1 and state.opt_state.count == 1
    assert not torch.equal(state.params["l1"]["w"], before)


def test_adam_step_matches_optax():
    """plain_adam(1e-3) against optax.adam(1e-3) on the same gradients,
    two steps: params, moments and count within 1e-6."""
    jcfg = jk.KiloConfig(**KCFG)
    jp = jk.init_kilonerf(jax.random.PRNGKey(1), jcfg)
    rng = np.random.RandomState(2)
    grads = [jax.tree_util.tree_map(lambda x: rng.randn(*x.shape).astype(np.float32) * 1e-2, jp)
             for _ in range(2)]
    tx = optax.adam(1e-3)
    jstate, jparams = tx.init(jp), jp
    ptx = plain_adam(1e-3)
    tp = checkpoint.from_jax_kilonerf(jax.tree_util.tree_map(np.asarray, jp))
    leaves = tree_leaves(tp)
    st = ptx.init(leaves)
    for g in grads:
        upd, jstate = tx.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        ptx.step(leaves, [torch.from_numpy(x) for x in jax.tree_util.tree_leaves(g)], st)
    for a, b in zip(leaves, jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    jmu, jnu = jstate[0].mu, jstate[0].nu
    for a, b in zip(st.mu + st.nu, jax.tree_util.tree_leaves(jmu) + jax.tree_util.tree_leaves(jnu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    assert st.count == int(jstate[0].count) == 2 and st.sched_count is None
    assert len(st.leaves()) == len(jax.tree_util.tree_leaves(jstate)) == 21


def _teacher_overrides(model_dir):
    return ["network.nerf.D", "2", "network.nerf.W", "16", "network.nerf.skips", "[]",
            "network.xyz_encoder.freq", "2", "network.dir_encoder.freq", "1",
            "network.dtype", "float32", "trained_model_dir", str(model_dir),
            "occupancy_grid_resolution", "8", "task_arg.N_samples", "8",
            "task_arg.N_importance", "8"]


KILO_OVERRIDES = ["kilo.grid_size", "4", "kilo.hidden", "8"]


def test_distill_cli_and_checkpoints_cross_both_ways(tmp_path):
    """The CLI on the CPU from a tiny teacher the test writes: 3 steps, then
    JAX's run._load_eval_params reads the port's kilonerf checkpoint and the
    port's run.load_eval_model / load_kilonerf read JAX's, exactly."""
    from nerf_tpu_torch import run

    cfg_file = os.path.join(ROOT, "configs", "nerf", "lego.yaml")
    over = _teacher_overrides(tmp_path / "teacher")
    cfg = make_cfg(cfg_file, over)
    opts = renderer.RenderOptions.from_cfg(cfg)
    state = init_state(init_nerf_params(torch.Generator().manual_seed(1), opts),
                       make_optimizer(cfg))
    checkpoint.save_checkpoint(str(tmp_path / "teacher"), state, 0)
    out = distill_kilonerf.main(["--cfg_file", cfg_file, "--device", "cpu", *over,
                                 *KILO_OVERRIDES, "kilo.steps", "3", "kilo.n_pts", "256",
                                 "kilo.eval_size", "8"])
    assert [s for s, _ in out["losses"]] == [1, 2, 3]
    assert all(np.isfinite(v) for _, v in out["losses"]) and np.isfinite(out["psnr"])
    assert out["n_centres"] > 0 and out["out_dir"] == str(tmp_path / "teacher" / "kilonerf")
    with np.load(os.path.join(out["out_dir"], "latest.npz")) as data:
        assert len(data.files) == 32 and int(data["leaf_31"]) == 3 and int(data["leaf_10"]) == 3

    kilo_file = os.path.join(ROOT, "configs", "nerf", "lego_kilonerf.yaml")
    kover = ["trained_model_dir", str(tmp_path / "teacher"), *KILO_OVERRIDES]
    jcfg = jax_make_cfg(kilo_file, kover)
    jparams = jax_run._load_eval_params(jcfg, jrend.RenderOptions.from_cfg(jcfg))
    kcfg = tk.KiloConfig(**{**KCFG, "xyz_freqs": 10, "dir_freqs": 4})
    mine = checkpoint.load_kilonerf(str(tmp_path / "teacher"), kcfg)
    assert mine["l1"]["w"].shape == (64, 63, 8)
    for a, b in zip(tree_leaves(mine), jax.tree_util.tree_leaves(jparams["fine"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    # JAX's file (a distilled state as distill_kilonerf.py saves it) read by the port
    jcfg_k = jk.KiloConfig(grid_size=4, hidden=8)
    jp = jk.init_kilonerf(jax.random.PRNGKey(5), jcfg_k)
    tx = optax.adam(1e-3)
    jdir = tmp_path / "jax_model"
    jckpt.save_checkpoint(str(jdir / "kilonerf"), JaxTrainState(
        params=jp, opt_state=tx.init(jp), step=jnp.asarray(7)), epoch=0)
    tcfg = make_cfg(kilo_file, ["trained_model_dir", str(jdir), "occupancy_grid_resolution",
                                "8", *KILO_OVERRIDES])
    topts, tparams, grid = run.load_eval_model(tcfg, torch.device("cpu"))
    assert topts.kilonerf and grid.occupied.shape == (8, 8, 8)
    assert tparams["coarse"] is tparams["fine"]
    for a, b in zip(tree_leaves(tparams["fine"]), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = checkpoint.load_checkpoint(str(jdir / "kilonerf"), checkpoint.kilonerf_template(kcfg))
    assert back[0].step == 7 and back[0].opt_state.count == 0


def test_missing_kilonerf_checkpoint_raises(tmp_path):
    from nerf_tpu_torch import run

    cfg = make_cfg(os.path.join(ROOT, "configs", "nerf", "lego_kilonerf.yaml"),
                   ["trained_model_dir", str(tmp_path), *KILO_OVERRIDES])
    with pytest.raises(FileNotFoundError, match="kilonerf"):
        run.load_eval_model(cfg, torch.device("cpu"))


def test_trainer_refuses_kilonerf(tmp_path):
    from nerf_tpu_torch.train.loop import train

    """The trainer takes KiloNeRF now (it trains from images, as the JAX
    package's does): with lego's config and no Blender data on disk, what
    stops it is the missing images, not the model."""
    cfg = make_cfg(os.path.join(ROOT, "configs", "nerf", "lego_kilonerf.yaml"),
                   ["workspace", str(tmp_path), "train_dataset.data_root", str(tmp_path)])
    with pytest.raises(FileNotFoundError):
        train(cfg, device="cpu")
