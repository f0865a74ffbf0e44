"""nerf_tpu_torch's data parallelism (gloo ranks on the CPU) against nerf_tpu's.

The port's ranks are processes started by ``parallel.mesh.launch``; they
rendezvous through a ``file://`` store of their own (no fixed port), run a
command of ``nerf_tpu_torch.parallel.dryrun`` (which imports no JAX) and
write their results to ``tmp_path``. Tolerances:
- one sharded train step at worlds 1, 2 and 4 against JAX's
  ``make_sharded_train_step`` on 1, 2 and 4 of conftest's virtual devices,
  from the same state (the committed lego epoch-49 checkpoint with its Adam
  moments, float32 weights), the same rays (JAX's draw), targets, perturb 0
  and fine samples (fed to both renderers' sample_pdf, as
  tests/test_torch_train.py does: drawn from the coarse weights, a sample
  on a CDF step can land either side of it, and that ray's fine points then
  move far beyond rounding, which put 91 elements of a leaf 7.8e-5 apart
  on one run): loss and stats within 2e-5 relative, every updated
  parameter within 2e-5 absolute (float32 sums over the ranks in other
  orders; Adam moves each weight by at most ~lr);
- the trainer at world 2 against world 1 (the same global batch): the
  trained params within 2e-5, as tests/test_sharding_equivalence.py;
- multihost without a process group: the identities, exactly; with a
  group of 2: broadcasts, gathers and means exact (small integers);
- ``mesh_world`` against JAX's ``make_train_mesh``: equal.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.config import default_cfg as jax_default_cfg
from nerf_tpu.config import make_cfg as jax_make_cfg
from nerf_tpu.parallel.mesh import make_mesh, replicate as jax_replicate
from nerf_tpu.parallel.train_step import make_sharded_train_step
from nerf_tpu.render import renderer as jrend
from nerf_tpu.render.renderer import RenderOptions as JaxOptions
from nerf_tpu.train import checkpoint as jckpt
from nerf_tpu.train import loop as jloop
from nerf_tpu.train import state as jstate
from nerf_tpu.train.optim import make_optimizer as jax_make_optimizer

from nerf_tpu_torch.config import make_cfg
from nerf_tpu_torch.parallel import dryrun, mesh, multihost
from nerf_tpu_torch.render.renderer import RenderOptions
from nerf_tpu_torch.train import loop
from nerf_tpu_torch.tree import tree_leaves

ROOT = os.path.join(os.path.dirname(__file__), "..")
LEGO_CFG = os.path.join(ROOT, "configs", "nerf", "lego.yaml")
LEGO = os.path.join(ROOT, "checkpoints", "nerf", "lego", "nerf")
F32 = ["network.dtype", "float32"]
N_RAYS, N_SAMPLES, N_IMP, KEY = 64, 8, 8, 7
TOL = 2e-5


def _jax_step(devices, monkeypatch):
    """JAX's sharded step on ``devices`` virtual devices from the committed
    lego state with fixed fine samples, and its inputs: (stats, params
    after, rays_o, rays_d, target, z_fine)."""
    if len(jax.devices()) < devices:
        pytest.skip("not enough devices")
    jcfg = jax_make_cfg(LEGO_CFG, F32)
    jopts = JaxOptions(n_samples=N_SAMPLES, n_importance=N_IMP, compute_dtype="float32",
                       enable_ess=False, enable_ert=False, use_pallas=False, perturb=0.0)
    tx = jax_make_optimizer(jcfg)
    template = jstate.init_state(jloop.init_nerf_params(jax.random.PRNGKey(0), jopts), tx)
    state0 = jckpt.load_checkpoint(LEGO, template)[0]
    rng = np.random.RandomState(0)
    H = W = 32
    images = jnp.asarray(rng.randint(0, 256, (2, H, W, 3), np.uint8))
    poses = jnp.broadcast_to(jnp.eye(4).at[2, 3].set(4.0), (2, 4, 4))
    K = jnp.asarray([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], jnp.float32)
    z_fine = np.sort(np.random.default_rng(2).uniform(2.0, 6.0, (N_RAYS, N_IMP)),
                     -1).astype(np.float32)
    monkeypatch.setattr(jrend, "sample_pdf", lambda *a, **k: jnp.asarray(z_fine))
    m = make_mesh(devices)
    step = make_sharded_train_step(m, tx, jopts, N_RAYS)
    state, stats = step(jax_replicate(m, state0), jax_replicate(m, images),
                        jax_replicate(m, poses), jax_replicate(m, K), jax.random.PRNGKey(KEY),
                        None)
    # the same draw of the batch, outside the step
    k_batch, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(KEY),
                                                     int(state.step) - 1))
    ro, rd, tgt = jstate.sample_ray_batch(k_batch, images, poses, K, N_RAYS)
    after = [np.asarray(x) for x in jax.tree_util.tree_leaves(state.params)]
    return ({k: float(v) for k, v in stats.items()}, after,
            *(np.asarray(a) for a in (ro, rd, tgt)), z_fine)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_step_matches_jax(world, tmp_path, monkeypatch):
    stats, after, ro, rd, tgt, z_fine = _jax_step(world, monkeypatch)
    opts = RenderOptions(n_samples=N_SAMPLES, n_importance=N_IMP, compute_dtype="float32",
                         enable_ess=False, enable_ert=False, use_fused_mlp=False,
                         use_integrate_kernel=False, perturb=0.0)
    inp, out = str(tmp_path / "in.npz"), str(tmp_path / "out.npz")
    np.savez(inp, opts=dryrun.opts_json(opts), cfg_file=LEGO_CFG, overrides=np.array(F32),
             ckpt=LEGO, rays_o=ro, rays_d=rd, target=tgt, z_fine=z_fine)
    mesh.launch("nerf_tpu_torch.parallel.dryrun", ["step", inp, out, "--device", "cpu"], world,
                "cpu")
    with np.load(out) as res:
        for k in ("loss", "loss_coarse", "loss_fine", "psnr"):
            np.testing.assert_allclose(float(res[k]), stats[k], rtol=TOL, err_msg=k)
        assert len(after) == 48
        for i, want in enumerate(after):
            np.testing.assert_allclose(res[f"leaf_{i}"], want, rtol=0, atol=TOL,
                                       err_msg=f"leaf {i}")


def test_trainer_world_2_matches_world_1(tmp_path):
    """``python -m nerf_tpu_torch.train`` at mesh_devices 2 starts two gloo
    ranks; their trained params equal one process's on the same batches."""
    runs = {}
    for world in (2, 1):
        over = dryrun.tiny_overrides(world, str(tmp_path / f"ws{world}"))
        over[over.index("task_arg.N_rays") + 1] = "64"
        runs[world] = dryrun.trained_params(over, "cpu")
    assert runs[1][1] == runs[2][1] == 4
    for a, b in zip(tree_leaves(runs[2][0]), tree_leaves(runs[1][0])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=TOL)


def test_only_rank_0_checkpoints_validates_and_logs(tmp_path):
    over = dryrun.tiny_overrides(2, str(tmp_path / "ws"))
    over[over.index("save_latest_ep") + 1] = "1"
    mesh.launch("nerf_tpu_torch.train", ["--device", "cpu", *over, "distributed", "True"], 2,
                "cpu", log_dir=str(tmp_path))
    with open(tmp_path / "ws" / "trained_model" / "latest.json") as f:
        assert json.load(f)["epoch"] == 1
    logs = [open(tmp_path / f"rank{r}.log").read() for r in (0, 1)]
    assert logs[0].count("saved checkpoint") == 3  # epochs 0, 1 and the final one
    assert logs[0].count("val psnr") == 2 and "data-parallel: 2 ranks, gloo" in logs[0]
    assert "saved checkpoint" not in logs[1] and "val psnr" not in logs[1]
    assert "epoch" not in logs[1]
    files = sorted(os.listdir(tmp_path / "ws" / "trained_model"))
    assert files == ["0.json", "0.npz", "1.json", "1.npz", "latest.json", "latest.npz"]


def test_multihost_is_the_identity_without_a_group():
    assert not multihost.initialized()
    assert multihost.process_index() == 0 and multihost.process_count() == 1
    assert multihost.is_main_process()
    multihost.barrier()
    tree = {"a": torch.ones(2), "b": [np.zeros(3)]}
    assert multihost.broadcast_from_main(tree) is tree
    t = torch.arange(4.0)
    assert torch.equal(multihost.gather_to_main(t), t[None])
    np.testing.assert_array_equal(multihost.gather_to_main(np.arange(3)), np.arange(3)[None])
    assert mesh.replicate(None, tree) is tree and mesh.shard_batch(None, tree) is tree
    got = mesh.all_reduce_mean([t])
    assert got[0] is t
    assert mesh.data_group("cpu") is None


def test_multihost_collectives_at_world_2(tmp_path):
    out = str(tmp_path / "coll")
    mesh.launch("nerf_tpu_torch.parallel.dryrun", ["collectives", out, "--device", "cpu"], 2, "cpu")
    for r in (0, 1):
        with np.load(f"{out}.{r}.npz") as res:
            assert int(res["world"]) == 2
            np.testing.assert_array_equal(res["f"], np.zeros(3, np.float32))
            np.testing.assert_array_equal(res["i"], np.zeros((2, 2), np.int64))
            np.testing.assert_array_equal(res["b"], [True, False])
            assert str(res["b_dtype"]) == "torch.bool"
            np.testing.assert_array_equal(res["gathered"], [[0, 0], [1, 2]])
            assert float(res["mean0"]) == 0.5 and float(res["mean1"][0]) == 1.0
            assert str(res["mean1_dtype"]) == "torch.bfloat16"
            np.testing.assert_array_equal(res["replicated"], [1.0, 1.0])


def test_data_group_rows():
    g = mesh.DataGroup(world=4, rank=2, device=torch.device("cpu"))
    assert g.rows(64) == slice(32, 48)
    x = {"a": torch.arange(8), "b": torch.arange(16).view(8, 2)}
    got = mesh.shard_batch(g, x)
    assert torch.equal(got["a"], torch.tensor([4, 5])) and got["b"].shape == (2, 2)
    with pytest.raises(ValueError):
        g.rows(10)


@pytest.mark.parametrize("n_rays,mesh_devices", [(64, "all"), (64, 3), (1024, 8), (12, "all"),
                                                  (12, 5), (7, "all"), (8, 1), (30, 4)])
def test_mesh_world_is_jax_rule(n_rays, mesh_devices):
    n_dev = len(jax.devices())
    cfg = jax_default_cfg()
    if mesh_devices != "all":
        cfg["mesh_devices"] = mesh_devices
    want = len(jloop.make_train_mesh(cfg, n_rays).devices.flat)
    assert mesh.mesh_world(n_rays, n_dev, mesh_devices) == want


def test_make_train_mesh_without_ranks():
    """World 1: no group; a larger world with no ranks started raises."""
    cfg = make_cfg(None, ["task_arg.N_rays", "64"])
    assert loop.make_train_mesh(cfg, 64, "cpu") is None
    cfg["mesh_devices"] = 2
    with pytest.raises(RuntimeError, match="needs its ranks"):
        loop.make_train_mesh(cfg, 64, "cpu")
    assert mesh.mesh_world(64, mesh.device_count(torch.device("cpu"), 2), 2) == 2
    assert mesh.device_count(torch.device("cpu")) == 1


def test_full_image_training_is_one_rank(monkeypatch):
    """Whole-image steps are not split over ranks: train_full_image gives
    world 1 and no group, whatever mesh_devices asks for, and refuses to run
    as one of several ranks."""
    cfg = make_cfg(None, ["task_arg.N_rays", "64", "mesh_devices", "2",
                          "train_full_image", "True"])
    assert loop.trainer_world(cfg, torch.device("cpu")) == 1
    assert loop.make_train_mesh(cfg, 64, "cpu") is None
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="one rank"):
        loop.make_train_mesh(cfg, 64, "cpu")


class _Fed:
    """A draw source handing out one given array."""

    def __init__(self, arr):
        self.arr = arr

    def draw(self, kind, shape, dtype, device):
        assert tuple(shape) == self.arr.shape
        return torch.as_tensor(self.arr, dtype=dtype, device=device)


def test_row_shard_draws_are_the_batch_rows():
    """A rank's RowShard draws are its rows of the whole batch's draws."""
    from nerf_tpu_torch.render.sampling import RowShard, draw

    u = np.random.default_rng(0).uniform(size=(8, 3)).astype(np.float32)
    got = draw("uniform", (2, 3), RowShard(_Fed(u), 4, 8))
    np.testing.assert_array_equal(got.numpy(), u[4:6])
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    full = torch.randn((8, 5), generator=g1)
    part = draw("normal", (4, 5), RowShard(g2, 2, 8))
    assert torch.equal(part, full[2:6])
    assert json.loads(dryrun.opts_json(RenderOptions()))["n_samples"] == 64


def test_bench_scaling_writes_only_its_record(tmp_path, monkeypatch):
    """``python -m nerf_tpu_torch.bench_scaling`` on the CPU at worlds 1 and
    2 (gloo): JAX's record, written to --out alone."""
    from nerf_tpu_torch import bench_scaling

    monkeypatch.chdir(tmp_path)
    report = bench_scaling.main(["--device", "cpu", "--devices", "2", "--rays-per-device", "32",
                                 "--steps", "1", "--out", "record.json"])
    assert os.listdir(tmp_path) == ["record.json"]
    with open(tmp_path / "record.json") as f:
        assert json.load(f) == report
    assert sorted(report["results"]) == ["1", "2"] and report["backend"] == "gloo"
    assert all(v > 0 for v in report["results"].values())
    assert report["efficiency"]["1"] == 1.0 and report["device"] is None
