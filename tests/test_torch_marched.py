"""nerf_tpu_torch's marched renderer against nerf_tpu.render.marched on the CPU.

The lego weights in float32, an ESS grid populated from their density at
R = 16, 48 rays of a camera on the orbit, 4 blocks of 8 samples.
Tolerances: ray_aabb at 1e-6 (the same float32 divisions); rgb, acc and
the transmittance at 1e-4 (the float32 MLP in two libraries and float32
sums of 32 samples, as tests/test_torch_render.py holds rendered colours);
depth, a sum of weight x z with z up to 6, within 1e-4 + 1e-4 |depth|
(the weights' 1e-4 scaled by z: without refocus a step is 0.125 long, so a
raw density differing by 2e-6 of its ~500 moves a weight by ~1e-5, and
depth moved by 1.1e-4 at 3.5 on this test's first run).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.render import marched as jmarch
from nerf_tpu.render import occupancy as jocc
from nerf_tpu.render import renderer as jrend
from nerf_tpu.train.loop import make_density_fn as jax_density_fn

from nerf_tpu_torch.render import marched
from nerf_tpu_torch.render import occupancy as occ
from nerf_tpu_torch.render import renderer as rend
from nerf_tpu_torch.render.rays import image_rays
from nerf_tpu_torch.serve import look_at_pose
from nerf_tpu_torch.train.checkpoint import load_params

ROOT = os.path.join(os.path.dirname(__file__), "..")
LEGO = os.path.join(ROOT, "checkpoints", "nerf", "lego", "nerf")
PARITY = dict(perturb=0.0, raw_noise_std=0.0, compute_dtype="float32")


@pytest.fixture(scope="module")
def lego():
    tree = load_params(LEGO)
    jgrid = jocc.populate_from_density(
        jocc.init_grid(jax.random.PRNGKey(1), 16),
        jax_density_fn(jax.tree_util.tree_map(jnp.asarray, tree["coarse"]),
                       jrend.RenderOptions(compute_dtype="float32")))
    tgrid = occ.OccupancyGrid(*(torch.tensor(np.asarray(a)) for a in jgrid))
    return tree, jgrid, tgrid


def _rays(n=48, seed=0, size=32):
    K = torch.tensor([[1.1 * size, 0, size / 2], [0, 1.1 * size, size / 2], [0, 0, 1]])
    o, d = image_rays(size, size, K, torch.from_numpy(look_at_pose(0.7, 0.4, 4.0)))
    idx = np.random.default_rng(seed).choice(size * size, n, replace=False)
    return o[idx].numpy(), d[idx].numpy()


def test_ray_aabb_matches_jax():
    rng = np.random.default_rng(0)
    o = rng.uniform(-5, 5, (200, 3)).astype(np.float32)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    d[:20, 0] = 0.0  # parallel to a slab
    d[20:30, 1] = -1e-12
    bmin, bmax = np.full(3, -2.0, np.float32), np.full(3, 2.0, np.float32)
    got = marched.ray_aabb(*(torch.from_numpy(a) for a in (o, d, bmin, bmax)), 2.0, 6.0)
    want = jmarch.ray_aabb(*(jnp.asarray(a) for a in (o, d, bmin, bmax)), 2.0, 6.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    assert 0 < got[2].sum() < 200


CASES = [dict(refocus=False, ess=False, ert=False, compaction=0.0),
         dict(refocus=False, ess=True, ert=True, compaction=0.0),
         dict(refocus=True, ess=True, ert=True, compaction=0.0),
         dict(refocus=True, ess=True, ert=False, compaction=0.0),
         dict(refocus=True, ess=True, ert=True, compaction=0.5),
         dict(refocus=False, ess=True, ert=True, compaction=0.2)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_render_rays_marched_matches_jax(lego, case):
    tree, jgrid, tgrid = lego
    o, d = _rays()
    kw = dict(enable_ess=case["ess"], enable_ert=case["ert"], ess_compaction=case["compaction"])
    jopts = jrend.RenderOptions(**PARITY, **kw, use_pallas=False, use_pallas_integrate=False)
    opts = rend.RenderOptions(**PARITY, **kw)
    want = jmarch.render_rays_marched(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(o), jnp.asarray(d),
        jax.random.PRNGKey(0), jopts, grid=jgrid, n_blocks=4, block_samples=8,
        refocus=case["refocus"])
    got = marched.render_rays_marched(rend.kernel_params(tree, opts), torch.from_numpy(o),
                                      torch.from_numpy(d), opts, grid=tgrid, n_blocks=4,
                                      block_samples=8, refocus=case["refocus"])
    for k in ("rgb_map", "acc_map", "transmittance"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["depth_map"].numpy(), np.asarray(want["depth_map"]),
                               rtol=1e-4, atol=1e-4)
    assert 0.05 < float(got["acc_map"].mean()) < 0.95


def test_render_image_marched_tiles(lego):
    """Tiles of 100 rays (the last one ragged) give the rays' own results."""
    tree, _, tgrid = lego
    opts = rend.RenderOptions(**PARITY)
    kp = rend.kernel_params(tree, opts)
    K = torch.tensor([[20.0, 0, 8], [0, 20.0, 6], [0, 0, 1]])
    pose = torch.from_numpy(look_at_pose(1.0, 0.3, 4.0))
    img = marched.render_image_marched(kp, pose, K, 12, 16, opts, grid=tgrid, n_blocks=2,
                                       block_samples=8, tile=100)
    o, d = image_rays(12, 16, K, pose)
    ref = marched.render_rays_marched(kp, o, d, opts, grid=tgrid, n_blocks=2, block_samples=8)
    assert img["rgb_map"].shape == (12, 16, 3) and img["depth_map"].shape == (12, 16)
    assert set(img) == {"rgb_map", "depth_map", "acc_map", "disp_map"}
    np.testing.assert_allclose(img["rgb_map"].reshape(-1, 3).numpy(), ref["rgb_map"].numpy(),
                               atol=1e-6)
