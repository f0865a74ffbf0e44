"""KiloNeRF through nerf_tpu_torch's renderer, density function and CLIs on the CPU.

Renders are held against ``nerf_tpu.render.renderer.render_image`` with
``network_module: kilonerf`` (ESS off, float32, perturb 0, the JAX
package's weights carried across by ``from_jax_kilonerf``) at 1e-4 on the
colours, as tests/test_torch_render.py holds the NeRF. The grid-rebuild
density is held against the naive per-point evaluation (float64, atol
2e-5), not against JAX's, which drops points (ROADMAP C2): shown below on
one lattice plane.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.config import make_cfg as jax_make_cfg
from nerf_tpu.ops import kilonerf as jk
from nerf_tpu.render import renderer as jrend
from nerf_tpu.train.loop import make_density_fn as jax_density_fn

from nerf_tpu_torch import run
from nerf_tpu_torch.config import make_cfg
from nerf_tpu_torch.data.blender import write_blender_scene
from nerf_tpu_torch.ops import kilonerf as tk
from nerf_tpu_torch.render import occupancy as occ
from nerf_tpu_torch.render import renderer
from nerf_tpu_torch.serve import RenderService, look_at_pose
from nerf_tpu_torch.train import checkpoint
from nerf_tpu_torch.train.loop import init_nerf_params, make_density_fn

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
KILO_CFG = os.path.join(ROOT, "configs", "nerf", "lego_kilonerf.yaml")
SMALL = dict(network_type="kilonerf", kilo_grid_size=4, kilo_hidden=16, xyz_freqs=4,
             dir_freqs=2, compute_dtype="float32", perturb=0.0, raw_noise_std=0.0,
             n_samples=16, n_importance=16, enable_ess=False)
SMALL_OVERRIDES = ["kilo.grid_size", "4", "kilo.hidden", "16", "network.xyz_encoder.freq", "4",
                   "network.dir_encoder.freq", "2"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these tests run many small ops, and with several
    test workers on the machine torch's thread pool spins against itself."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_from_cfg_matches_jax():
    overrides = ["kilo.capacity_factor", "2.5"]
    jopts = jrend.RenderOptions.from_cfg(jax_make_cfg(KILO_CFG, overrides))
    opts = renderer.RenderOptions.from_cfg(make_cfg(KILO_CFG, overrides))
    for f in ("network_type", "kilo_grid_size", "kilo_hidden", "kilo_capacity_factor",
              "kilo_dispatch_rounds", "n_samples", "n_importance", "near", "far", "perturb",
              "white_bkgd", "enable_ert", "ert_threshold", "enable_ess", "xyz_freqs",
              "dir_freqs", "sigma_activation", "compute_dtype", "tile_rays"):
        assert getattr(opts, f) == getattr(jopts, f), f
    assert (opts.network_type, opts.kilo_grid_size, opts.kilo_dispatch_rounds) == ("kilonerf",
                                                                                  16, 4)
    assert opts.kilo_capacity_factor == 2.5 and opts.kilonerf
    want = jrend.kilo_config_from_opts(jopts)
    got = renderer.kilo_config_from_opts(opts)
    assert tuple(got) == tuple(want)


def _model(seed, rounds=1):
    jopts = jrend.RenderOptions(**{**SMALL, "kilo_dispatch_rounds": rounds}, use_pallas=False,
                                use_pallas_integrate=False)
    opts = renderer.RenderOptions(**{**SMALL, "kilo_dispatch_rounds": rounds})
    jp = jk.init_kilonerf(jax.random.PRNGKey(seed), jrend.kilo_config_from_opts(jopts))
    tp = checkpoint.from_jax_kilonerf(jax.tree_util.tree_map(np.asarray, jp))
    return jopts, opts, {"coarse": jp, "fine": jp}, renderer.kernel_params(
        {"coarse": tp, "fine": tp}, opts)


@pytest.mark.parametrize("rounds", [1, 4])
def test_render_matches_jax(rounds):
    """An 8x8 frame (64 rays, one tile), capacity 2x the mean load, one and
    four dispatch rounds."""
    jopts, opts, jparams, kp = _model(1, rounds)
    pose = look_at_pose(0.4, 0.3, 3.0)
    K = np.array([[9.0, 0, 4], [0, 9.0, 4], [0, 0, 1]], np.float32)
    want = jrend.render_image(jparams, jnp.asarray(pose), jnp.asarray(K), jax.random.PRNGKey(0),
                              8, 8, jopts)
    got = renderer.render_image(kp, torch.from_numpy(pose), torch.from_numpy(K), 8, 8, opts)
    for k in ("rgb_map", "acc_map", "rgb_map_0", "acc_map_0"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, err_msg=k)
    assert kp["coarse"] is kp["fine"]
    assert float(got["acc_map"].max()) > 0.05  # the frame is not empty


def _lattice_plane(res=16):
    """One x-plane of populate_from_density's (3 res)^3 lattice: one column of networks."""
    ax = torch.arange(res, dtype=torch.float32).repeat_interleave(3) * (4.0 / res) - 2.0
    ax = ax + torch.tensor([0.0, 0.5, 1.0]).repeat(res) * (4.0 / res)
    y, z = torch.meshgrid(ax, ax, indexing="ij")
    return torch.stack([torch.full_like(y, float(ax[7])), y, z], -1).reshape(-1, 3)


def test_density_drops_no_point_and_matches_the_naive_evaluation():
    jopts, opts, jparams, kp = _model(2)
    pts = _lattice_plane()
    got = renderer.make_density_fn(kp["coarse"], opts)(pts)
    kcfg = renderer.kilo_config_from_opts(opts)
    naive = torch.relu(tk.kilonerf_naive(kp["coarse"], pts, torch.zeros_like(pts), kcfg)[:, 3])
    np.testing.assert_allclose(got.numpy(), naive.numpy(), atol=2e-5, rtol=0)
    cap = tk.no_drop_capacity(pts, kcfg)
    counts = torch.bincount(tk.assign_networks(pts, kcfg), minlength=64)
    assert cap == int(counts.max()) and tk.served_per_round(pts, kcfg, cap) == [pts.shape[0]]
    # the plane lies in one column of networks: 16 of 64 hold all of it, so
    # the default capacity (2x the mean over 64) drops points, which JAX's
    # density reads as 0 (ROADMAP C2)
    assert int((counts > 0).sum()) == 16
    served = tk.served_per_round(pts, kcfg)[0]
    assert served < pts.shape[0]
    jd = np.asarray(jax_density_fn(jparams["coarse"], jopts)(jnp.asarray(pts.numpy())))
    dropped = (jd == 0) & (naive.numpy() > 0)
    assert dropped.sum() > 0


def test_grid_rebuild_from_the_kilonerf_density():
    """populate_from_density through the port's density equals it through
    the naive evaluation: no lattice point is lost."""
    _, opts, _, kp = _model(3)
    kcfg = renderer.kilo_config_from_opts(opts)
    seed = occ.init_grid(12, generator=torch.Generator().manual_seed(1))
    got = occ.populate_from_density(seed, make_density_fn(kp["coarse"], opts), chunk=4000)
    want = occ.populate_from_density(
        seed, lambda p: torch.relu(tk.kilonerf_naive(kp["coarse"], p, torch.zeros_like(p),
                                                     kcfg)[:, 3]).float(), chunk=4000)
    assert torch.equal(got.occupied, want.occupied)
    assert 0.0 < float(got.occupied.float().mean()) < 1.0


def test_init_nerf_params_shares_one_model():
    """One draw of the model for both passes, as JAX's {"coarse": p, "fine":
    p}; the fine pass holds a copy of it, so that training moves the two
    apart as JAX's two leaves move."""
    opts = renderer.RenderOptions(**SMALL)
    p = init_nerf_params(torch.Generator().manual_seed(0), opts)
    assert p["coarse"]["l3"]["w"].shape == (64, 16, 17)
    for k in tk.LAYERS:
        for n in ("w", "b"):
            c, f = p["coarse"][k][n], p["fine"][k][n]
            assert torch.equal(c, f) and c.data_ptr() != f.data_ptr()


@pytest.fixture(scope="module")
def kilo_dir(tmp_path_factory):
    """A trained_model_dir holding a small KiloNeRF checkpoint and an 8x8 scene."""
    root = tmp_path_factory.mktemp("kilo")
    kcfg = tk.KiloConfig(grid_size=4, hidden=16, xyz_freqs=4, dir_freqs=2)
    state = checkpoint.kilonerf_template(kcfg)
    with torch.no_grad():
        for name, layer in tk.init_kilonerf(torch.Generator().manual_seed(4), kcfg).items():
            for k, v in layer.items():
                state.params[name][k].copy_(v)
    state.step = 5
    checkpoint.save_checkpoint(str(root / "model" / "kilonerf"), state, 0)
    rng = np.random.default_rng(0)
    splits = {s: (rng.integers(0, 256, (n, 8, 8, 4), dtype=np.uint8),
                  np.stack([look_at_pose(0.5 + i, 0.3, 4.0) for i in range(n)]))
              for s, n in (("train", 2), ("test", 3))}
    write_blender_scene(str(root / "scene" / "lego"), splits, 0.69)
    return root


def _overrides(root):
    return ["trained_model_dir", str(root / "model"), *SMALL_OVERRIDES,
            "occupancy_grid_resolution", "8", "task_arg.N_samples", "8",
            "task_arg.N_importance", "8", "test_dataset.data_root", str(root / "scene"),
            "test_dataset.H", "8", "test_dataset.W", "8"]


def test_run_network_and_serve_on_the_cpu(kilo_dir):
    s = run.main(["--type", "network", "--cfg_file", KILO_CFG, "--device", "cpu",
                  *_overrides(kilo_dir)])
    assert s["frames"] == 2 and s["rays_per_s"] > 0
    service = RenderService(make_cfg(KILO_CFG, _overrides(kilo_dir)), size=8, device="cpu")
    assert service.opts.kilonerf and service.grid.resolution == 8
    rgb = service.render(0.5, 0.3, 4.0)
    assert rgb.shape == (8, 8, 3) and bool(torch.isfinite(rgb).all())
    png = service.render_png(0.9, 0.3, 4.0)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    plain = dataclasses.replace(service.opts, use_integrate_kernel=False)
    assert torch.allclose(service.render(0.5, 0.3, 4.0, opts=plain), rgb, atol=1e-6)
