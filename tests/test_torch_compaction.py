"""nerf_tpu_torch's fine-pass compaction against nerf_tpu's on the CPU.

Float32 parity options as tests/test_torch_render.py (perturb 0, no noise,
float32 weights: neither side draws random numbers), the lego weights and
an ESS grid populated from their density at R = 16. The masks are compared
without ERT: with it the JAX package's fine-pass mask also reads the coarse
transmittance, a fault of the reference that the port does not copy
(``fine_pass_mask``; a test below shows it). Tolerances: the raw
outputs of kept points within 1e-4 + 1e-5 |x| of JAX's (the float32 MLP in
two libraries; raw values reach ~500, where float32 sums of 256 terms in
other orders differ by ~1e-6 relative) and within 1e-6 + 1e-6 |x| of the
port's own dense query on the same points (one float32 MLP on other batch
shapes); dropped
points exactly EMPTY_SIGMA_RAW with zero colour; masks exact (the same
voxel lookups); rendered colours at 1e-4 (as
tests/test_torch_render.py), acc at 1e-3 (without ERT it sums all 192
weights of a ray: 1.05e-4 apart on one of 64 rays on this test's first
run); the calibrated fraction exact (a kept count
rounded up to whole blocks of 256 points).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.render import occupancy as jocc
from nerf_tpu.render import renderer as jrend
from nerf_tpu.render.composite import EMPTY_SIGMA_RAW
from nerf_tpu.config import make_cfg as jax_make_cfg
from nerf_tpu.train.loop import make_density_fn as jax_density_fn

from nerf_tpu_torch.config import make_cfg
from nerf_tpu_torch.render import occupancy as occ
from nerf_tpu_torch.render import renderer as rend
from nerf_tpu_torch.serve import look_at_pose
from nerf_tpu_torch.train.checkpoint import load_params
from nerf_tpu_torch.tree import tree_map

ROOT = os.path.join(os.path.dirname(__file__), "..")
LEGO = os.path.join(ROOT, "checkpoints", "nerf", "lego", "nerf")
LEGO_CFG = os.path.join(ROOT, "configs", "nerf", "lego.yaml")
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


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _rays(n, seed, size=40):
    from nerf_tpu_torch.render.rays import image_rays

    K = torch.tensor([[1.1 * size, 0, size / 2], [0, 1.1 * size, size / 2], [0, 0, 1]])
    o, d = image_rays(size, size, K, torch.from_numpy(look_at_pose(0.7, 0.4, 4.0)))
    idx = np.random.default_rng(seed).choice(size * size, n, replace=False)
    return o[idx].numpy(), d[idx].numpy()


@pytest.mark.parametrize("cap", [256, 512, 1024])
def test_query_masked_compacted(lego, cap):
    """640 points, about 60% kept: capacity 256 and 512 drop the kept points
    past it, 1024 keeps them all."""
    tree = lego[0]
    opts = rend.RenderOptions(**PARITY)
    jopts = jrend.RenderOptions(**PARITY, use_pallas=False)
    rng = np.random.default_rng(cap)
    pts = rng.uniform(-1.2, 1.2, (32, 20, 3)).astype(np.float32)
    d = rng.normal(size=(32, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mask = rng.uniform(size=(32, 20)) < 0.6
    kp = rend.kernel_params(tree, opts)["fine"]
    got = rend.query_masked_compacted(kp, torch.from_numpy(pts), torch.from_numpy(d), opts,
                                      torch.from_numpy(mask), cap).numpy()
    want = np.asarray(jrend.query_masked_compacted(
        jrend.query_network_xla, _jtree(tree["fine"]), jnp.asarray(pts), jnp.asarray(d),
        jopts, jnp.asarray(mask), cap))
    slot = np.cumsum(mask.reshape(-1)) - 1
    kept = (mask.reshape(-1) & (slot < cap)).reshape(mask.shape)
    if cap >= mask.size:  # capacity for every point: all are queried, as in JAX
        kept[:] = True
    assert kept.sum() == (mask.size if cap >= mask.size else min(cap, mask.sum()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    dense = rend.query(kp, torch.from_numpy(pts), torch.from_numpy(d), opts).numpy()
    np.testing.assert_allclose(got[kept], dense[kept], rtol=1e-6, atol=1e-6)
    assert (got[~kept][:, :3] == 0).all() and (got[~kept][:, 3] == EMPTY_SIGMA_RAW).all()


def test_query_masked_compacted_sends_a_cap_batch_of_single_points(lego, monkeypatch):
    """The MLP sees [cap, 1, 3] points with one view direction each."""
    opts = rend.RenderOptions(**PARITY)
    kp = rend.kernel_params(lego[0], opts)["fine"]
    seen = []
    real = rend.query_network

    def spy(params, pts, viewdirs, **kw):
        seen.append((tuple(pts.shape), tuple(viewdirs.shape)))
        return real(params, pts, viewdirs, **kw)

    monkeypatch.setattr(rend, "query_network", spy)
    pts = torch.rand(40, 30, 3)
    d = torch.nn.functional.normalize(torch.randn(40, 3), dim=-1)
    rend.query_masked_compacted(kp, pts, d, opts, torch.rand(40, 30) < 0.2, 512)
    assert seen == [((512, 1, 3), (512, 3))]
    assert rend.compaction_capacity(1200, 0.3) == 512 and rend.compaction_capacity(10, 0.1) == 256


def _fine_inputs(n=48, seed=7):
    rng = np.random.default_rng(seed)
    o, d = _rays(n, seed)
    z = np.sort(rng.uniform(2, 6, (n, 64)), -1).astype(np.float32)
    z_all = np.sort(np.concatenate([z, rng.uniform(2, 6, (n, 128))], -1), -1).astype(np.float32)
    w = (rng.uniform(0, 1, (n, 64)) ** 6 * rng.uniform(0, 0.15, (n, 1))).astype(np.float32)
    pts_f = (o[:, None] + d[:, None] * z_all[..., None]).astype(np.float32)
    return pts_f, z, z_all, w


def test_fine_pass_mask_matches_jax_without_ert(lego):
    _, jgrid, tgrid = lego
    pts_f, z, z_all, w = _fine_inputs()
    got = rend.fine_pass_mask(tgrid, torch.from_numpy(pts_f))
    want = jrend.fine_pass_mask(jgrid, *(jnp.asarray(a) for a in (pts_f, z, z_all, w)),
                                jrend.RenderOptions(**PARITY, enable_ert=False))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.05 < got.float().mean() < 0.95


def test_jax_fine_pass_mask_drops_what_the_composite_weighs(lego):
    """With ERT the JAX package's mask also drops samples past the coarse
    transmittance read after the preceding coarse sample (a fault of the
    reference, fine_pass_mask's docstring): its compacted render leaves the
    dense one, the port's (occupancy alone) does not, on the same rays."""
    tree, jgrid, tgrid = lego
    pts_f, z, z_all, w = _fine_inputs()
    jmask = np.asarray(jrend.fine_pass_mask(jgrid, *(jnp.asarray(a) for a in (pts_f, z, z_all, w)),
                                            jrend.RenderOptions(**PARITY)))
    mask = rend.fine_pass_mask(tgrid, torch.from_numpy(pts_f)).numpy()
    assert not (jmask & ~mask).any() and (mask & ~jmask).sum() > 100
    o, d = _rays(64, 5)
    jopts = jrend.RenderOptions(**PARITY, use_pallas=False, use_pallas_integrate=False)
    args = (_jtree(tree), jnp.asarray(o), jnp.asarray(d), jax.random.PRNGKey(0))
    jdense = np.asarray(jrend.render_rays(*args, jopts, grid=jgrid)["rgb_map"])
    jcomp = np.asarray(jrend.render_rays(*args, dataclasses.replace(jopts, ess_compaction=0.9),
                                         grid=jgrid)["rgb_map"])
    opts = rend.RenderOptions(**PARITY)
    kp = rend.kernel_params(tree, opts)
    targs = (kp, torch.from_numpy(o), torch.from_numpy(d))
    dense = rend.render_rays(*targs, opts, grid=tgrid)["rgb_map"].numpy()
    comp = rend.render_rays(*targs, dataclasses.replace(opts, ess_compaction=0.9),
                            grid=tgrid)["rgb_map"].numpy()
    assert np.abs(jcomp - jdense).max() > 0.3
    np.testing.assert_allclose(dense, jdense, atol=1e-4)
    # occupancy alone: what differs from dense is density in voxels the R = 16 grid calls empty
    assert -10 * np.log10(max(np.mean((comp - dense) ** 2), 1e-20)) >= 40.0


@pytest.mark.parametrize("frac", [0.9, 0.35])
def test_render_rays_with_compaction_matches_jax(lego, frac):
    """Without ERT (where the two packages' masks agree): frac 0.9 keeps
    every masked fine sample; 0.35 drops the kept samples past its
    capacity, in the same order in both."""
    tree, jgrid, tgrid = lego
    o, d = _rays(64, 5)
    jopts = jrend.RenderOptions(**PARITY, ess_compaction=frac, enable_ert=False,
                                use_pallas=False, use_pallas_integrate=False)
    want = jrend.render_rays(_jtree(tree), jnp.asarray(o), jnp.asarray(d),
                             jax.random.PRNGKey(0), jopts, grid=jgrid)
    opts = rend.RenderOptions(**PARITY, ess_compaction=frac, enable_ert=False)
    kp = rend.kernel_params(tree, opts)
    got = rend.render_rays(kp, torch.from_numpy(o), torch.from_numpy(d), opts, grid=tgrid)
    for k in ("rgb_map", "rgb_map_0"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["acc_map"].numpy(), np.asarray(want["acc_map"]), atol=1e-3)


def test_calibrate_compaction_matches_jax(lego):
    tree, jgrid, tgrid = lego
    o, d = _rays(256, 9)
    jopts = jrend.RenderOptions(**PARITY, enable_ert=False, use_pallas=False,
                                use_pallas_integrate=False)
    want = jrend.calibrate_compaction(_jtree(tree), jnp.asarray(o), jnp.asarray(d),
                                      jax.random.PRNGKey(0), jopts, jgrid, disable_above=1.01)
    opts = rend.RenderOptions(**PARITY, enable_ert=False)
    kp = rend.kernel_params(tree, opts)
    got = rend.calibrate_compaction(kp, torch.from_numpy(o), torch.from_numpy(d), opts, tgrid,
                                    disable_above=1.01)
    assert got == want and 0.0 < got < 1.0
    # the default cut turns it off where the dense pass is faster
    base = rend.calibrate_compaction(kp, torch.from_numpy(o), torch.from_numpy(d), opts, tgrid)
    assert base == (got if got < 0.30 else 0.0)
    auto = rend.resolve_compaction(dataclasses.replace(opts, ess_compaction=-1.0), kp, tgrid,
                                   torch.from_numpy(o), torch.from_numpy(d))
    assert auto.ess_compaction == base
    assert rend.resolve_compaction(dataclasses.replace(opts, ess_compaction=-1.0), kp, None,
                                   torch.from_numpy(o), torch.from_numpy(d)).ess_compaction == 0.0


@pytest.mark.parametrize("value,want", [("auto", -1.0), ("0.3", 0.3), ("0", 0.0)])
def test_ess_compaction_is_read_as_jax_reads_it(value, want):
    opts = rend.RenderOptions.from_cfg(make_cfg(LEGO_CFG, ["ess_compaction", value]))
    jopts = jrend.RenderOptions.from_cfg(jax_make_cfg(LEGO_CFG, ["ess_compaction", value]))
    assert opts.ess_compaction == jopts.ess_compaction == want


def test_compaction_is_off_in_training(lego, monkeypatch):
    """A train step with ess_compaction set queries every fine sample densely."""
    tree, _, tgrid = lego
    opts = rend.RenderOptions(**PARITY, n_samples=8, n_importance=8, ess_compaction=0.3)
    monkeypatch.setattr(rend, "query_masked_compacted",
                        lambda *a, **k: pytest.fail("compaction in training"))
    params = {name: tree_map(lambda x: torch.tensor(x).requires_grad_(True), sub)
              for name, sub in tree.items()}
    o, d = _rays(32, 3)
    out = rend.render_rays(params, torch.from_numpy(o), torch.from_numpy(d), opts, grid=tgrid,
                           generator=torch.Generator().manual_seed(0), train=True)
    loss = ((out["rgb_map"] - 0.5) ** 2).mean()
    loss.backward()
    assert params["fine"]["pts_linears"][0]["w"].grad is not None
