"""nerf_tpu_torch rays, sampling, ESS grid and renderer against nerf_tpu on the CPU.

Parity runs use perturb=0, no noise and float32, as tests/test_golden_render.py
does, so both sides draw no random numbers; inputs come from
numpy.random.default_rng. Tolerances: 1e-5 for sampling and rays (a few
float32 ulp of values up to 6); exact for the occupancy grids; 1e-4 for
rendered colors and the golden image (the settings of test_golden_render.py).

The inverse CDF divides by the CDF step of the bin a sample lands in, so the
float32 rounding of the CDF (JAX and torch's CPU cumsum sum in other orders;
torch accumulates in float64) is amplified by bin_width / step there. Steps
below 1e-5 are replaced by 1, so away from that cut the worst case is
6e-7 * 0.07 / 1e-5 = 4e-3: samples are held to 1e-5 where the step is
>= 1e-2 and to 5e-3 everywhere. At the cut itself the rule is discontinuous:
an empty bin of an opaque ray has a step of 1e-5 / (sum w + 6.2e-4), which
lands next to 1e-5, and where rounding puts it on the other side the sample
moves by up to half a bin. So in a render, 99% of the fine samples are held
to 1e-4, the fine depth to 1e-3 and the colors to 1e-4.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.config import make_cfg as jax_make_cfg
from nerf_tpu.render import occupancy as jocc
from nerf_tpu.render import renderer as jrend
from nerf_tpu.render.rays import image_rays as jax_image_rays
from nerf_tpu.render.sampling import sample_coarse as jax_sample_coarse
from nerf_tpu.render.sampling import sample_pdf as jax_sample_pdf
from nerf_tpu.train.loop import init_nerf_params, make_density_fn as jax_density_fn

from nerf_tpu_torch.config import make_cfg
from nerf_tpu_torch.render import occupancy as occ
from nerf_tpu_torch.render.rays import image_rays
from nerf_tpu_torch.render.renderer import (RenderOptions, kernel_params, make_density_fn,
                                            render_image, render_rays)
from nerf_tpu_torch.render.sampling import sample_coarse, sample_pdf, stratify
from nerf_tpu_torch.serve import look_at_pose
from nerf_tpu_torch.train.checkpoint import load_params

ROOT = os.path.join(os.path.dirname(__file__), "..")
LEGO = os.path.join(ROOT, "checkpoints", "nerf", "lego", "nerf")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "lego_like_32x32.npy")
PARITY = dict(perturb=0.0, raw_noise_std=0.0, compute_dtype="float32")


@pytest.fixture(scope="module")
def lego():
    return load_params(LEGO)


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _grid_pair(res=16):
    jgrid = jocc.init_grid(jax.random.PRNGKey(1), res)
    tgrid = occ.OccupancyGrid(*(torch.tensor(np.asarray(a)) for a in jgrid))
    return jgrid, tgrid


def _rays(n, seed):
    pose = look_at_pose(0.7, 0.4, 4.0)
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)
    o, d = jax_image_rays(32, 32, jnp.asarray(K), jnp.asarray(pose))
    idx = np.random.default_rng(seed).choice(32 * 32, n, replace=False)
    return np.asarray(o)[idx], np.asarray(d)[idx]


def test_image_rays_match_jax():
    pose = look_at_pose(1.1, 0.2, 3.5)
    K = np.array([[30.0, 0, 12], [0, 30.0, 8], [0, 0, 1]], np.float32)
    jo, jd = jax_image_rays(16, 24, jnp.asarray(K), jnp.asarray(pose))
    o, d = image_rays(16, 24, torch.from_numpy(K), torch.from_numpy(pose))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)


@pytest.mark.parametrize("lindisp", [False, True])
def test_sample_coarse_matches_jax(lindisp):
    want = jax_sample_coarse(None, 5, 64, 2.0, 6.0, perturb=0.0, lindisp=lindisp)
    got = sample_coarse(5, 64, 2.0, 6.0, perturb=0.0, lindisp=lindisp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_stratify_stays_in_bins():
    z = sample_coarse(4, 32, 2.0, 6.0, perturb=0.0)
    s = stratify(z, torch.Generator().manual_seed(0))
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    assert bool((s[:, 1:] >= mids).all() and (s[:, :-1] <= mids).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_pdf_deterministic_matches_jax(seed):
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(2, 6, (32, 63)).astype(np.float32), -1)
    w = rng.uniform(0, 1, (32, 62)).astype(np.float32) ** 4
    want = np.asarray(jax_sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 128,
                                     deterministic=True))
    got = sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), 128, deterministic=True)
    _check_inverse_cdf(got.numpy(), want, w, np.linspace(0, 1, 128))


def _check_inverse_cdf(got, want, w, u):
    """The two-level tolerance of the module docstring."""
    pdf = (w + 1e-5).astype(np.float64)
    cdf = np.concatenate([np.zeros_like(pdf[:, :1]), np.cumsum(pdf / pdf.sum(-1, keepdims=True), -1)], -1)
    u = np.broadcast_to(u, got.shape)
    idx = np.array([np.searchsorted(c, uu, side="right") for c, uu in zip(cdf, u)])
    last = cdf.shape[1] - 1
    step = (np.take_along_axis(cdf, np.clip(idx, 0, last), -1)
            - np.take_along_axis(cdf, np.clip(idx - 1, 0, last), -1))
    well = step >= 1e-2
    assert well.mean() > 0.5
    np.testing.assert_allclose(got[well], want[well], atol=1e-5)
    np.testing.assert_allclose(got, want, atol=5e-3)


def test_sample_pdf_u_override_matches_jax():
    rng = np.random.default_rng(2)
    bins = np.sort(rng.uniform(2, 6, (16, 33)).astype(np.float32), -1)
    w = rng.uniform(0, 1, (16, 32)).astype(np.float32)
    u = rng.uniform(-0.1, 1.1, (16, 40)).astype(np.float32)  # clamps at both ends
    want = jax_sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 40, False, u=jnp.asarray(u))
    got = sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), 40, False, u=torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_sample_coarse_with_ess_matches_jax():
    jgrid, tgrid = _grid_pair()
    o, d = _rays(128, seed=3)
    want = jocc.sample_coarse_with_ess(None, jgrid, jnp.asarray(o), jnp.asarray(d), 64,
                                       2.0, 6.0, perturb=0.0)
    got = occ.sample_coarse_with_ess(tgrid, torch.from_numpy(o), torch.from_numpy(d), 64,
                                     2.0, 6.0, perturb=0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    pts = np.random.default_rng(4).uniform(-2.5, 2.5, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(occ.query(tgrid, torch.from_numpy(pts)).numpy(),
                                  np.asarray(jocc.query(jgrid, jnp.asarray(pts))))


def test_populate_from_density_matches_jax(lego):
    """R=16 (a 48^3 lattice) with the lego coarse model, float32."""
    jopts = jrend.RenderOptions(compute_dtype="float32")
    jgrid = jocc.populate_from_density(jocc.init_grid(jax.random.PRNGKey(1), 16),
                                       jax_density_fn(_jax_tree(lego["coarse"]), jopts))
    opts = RenderOptions(compute_dtype="float32")
    kp = kernel_params(lego, opts)
    grid = occ.populate_from_density(occ.init_grid(16, generator=torch.Generator().manual_seed(0)),
                                     make_density_fn(kp["coarse"], opts), chunk=20_000)
    np.testing.assert_array_equal(grid.occupied.numpy(), np.asarray(jgrid.occupied))
    assert 0 < grid.occupied.float().mean() < 1


@pytest.mark.parametrize("ess", [False, True])
def test_render_rays_matches_jax(lego, ess):
    """64 rays, the lego weights, ERT on, with and without an ESS grid."""
    jgrid, tgrid = _grid_pair()
    o, d = _rays(64, seed=5)
    jopts = jrend.RenderOptions(**PARITY, enable_ess=ess, use_pallas=False,
                                use_pallas_integrate=False)
    want = jrend.render_rays(_jax_tree(lego), jnp.asarray(o), jnp.asarray(d),
                             jax.random.PRNGKey(0), jopts, grid=jgrid if ess else None)
    opts = RenderOptions(**PARITY, enable_ess=ess)
    got = render_rays(kernel_params(lego, opts), torch.from_numpy(o),
                      torch.from_numpy(d), opts, grid=tgrid if ess else None)
    for k in ("rgb_map", "acc_map", "rgb_map_0", "acc_map_0", "depth_map_0", "coarse_z_vals"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["depth_map"].numpy(), np.asarray(want["depth_map"]), atol=1e-3)
    dz = np.abs(got["fine_z_vals"].numpy() - np.asarray(want["fine_z_vals"]))
    assert np.mean(dz <= 1e-4) >= 0.99, np.mean(dz <= 1e-4)


def test_golden_image_through_bridged_jax_init():
    """tests/golden/lego_like_32x32.npy from init_nerf_params(PRNGKey(0))."""
    opts = RenderOptions(n_samples=16, n_importance=16, enable_ess=False, enable_ert=False,
                         tile_rays=256, **PARITY)
    params = init_nerf_params(jax.random.PRNGKey(0), jrend.RenderOptions(**PARITY))
    tree = jax.tree_util.tree_map(np.asarray, params)
    K = torch.tensor([[35.0, 0, 16], [0, 35.0, 16], [0, 0, 1]])
    pose = torch.eye(4)
    pose[2, 3] = 4.0
    out = render_image(kernel_params(tree, opts), pose, K, 32, 32, opts)
    np.testing.assert_allclose(out["rgb_map"].numpy(), np.load(GOLDEN), rtol=1e-4, atol=1e-4)


def test_kernel_params_refuse_float32_weights_for_the_cuda_kernel(lego):
    """The CUDA kernel takes bfloat16 weights; float32 ones raise before any
    copy to the card, unless the plain version is asked for."""
    with pytest.raises(NotImplementedError, match="bfloat16"):
        kernel_params(lego, RenderOptions(compute_dtype="float32"), "cuda")
    kp = kernel_params(lego, RenderOptions(compute_dtype="float32", use_fused_mlp=False))
    assert kp["fine"]["wbuf"].dtype == torch.float32


def test_render_options_from_cfg_match_jax():
    overrides = ["task_arg.N_samples", "32", "ert_threshold", "0.02"]
    cfg = make_cfg(os.path.join(ROOT, "configs/nerf/lego.yaml"), overrides)
    jopts = jrend.RenderOptions.from_cfg(
        jax_make_cfg(os.path.join(ROOT, "configs/nerf/lego.yaml"), overrides))
    opts = RenderOptions.from_cfg(cfg)
    for f in ("n_samples", "n_importance", "near", "far", "perturb", "raw_noise_std",
              "white_bkgd", "use_viewdirs", "lindisp", "enable_ert", "ert_threshold",
              "enable_ess", "xyz_freqs", "dir_freqs", "sigma_activation", "mlp_depth",
              "mlp_width", "skips", "compute_dtype", "tile_rays"):
        assert getattr(opts, f) == getattr(jopts, f), f
    assert (opts.use_fused_mlp, opts.use_integrate_kernel) == (jopts.use_pallas,
                                                                jopts.use_pallas_integrate)
    assert cfg.trained_model_dir == os.path.join("workspace", "trained_model", "nerf", "lego", "nerf")


@pytest.mark.parametrize("override", [["network_module", "kilonerf"],
                                      ["network.xyz_encoder.type", "spherical_harmonics"],
                                      ["ess_compaction", "0.3"]])
def test_render_options_refuse_what_is_not_ported(override):
    cfg = make_cfg(os.path.join(ROOT, "configs/nerf/lego.yaml"), override)
    with pytest.raises(NotImplementedError):
        RenderOptions.from_cfg(cfg)
