"""nerf_tpu_torch's expert-parallel KiloNeRF (gloo ranks) against nerf_tpu's on virtual devices.

Both sides get the same networks (JAX's ``init_kilonerf``, 64 networks of
hidden width 16), points, directions and cotangents, made with numpy. The
port's ranks run ``nerf_tpu_torch.parallel.dryrun ep`` (one launch a world,
all cases). Tolerances, as tests/test_kilonerf_ep.py:
- capacities that suffice: outputs within 2e-5 (absolute and relative);
- a tight send capacity: the same rows exactly zero as JAX's, the others
  within 2e-5;
- gradients of sum(raw * cot) with respect to every leaf: within 1e-4
  (absolute and relative), and equal to the dense evaluation's at the same
  bound.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from nerf_tpu.ops import kilonerf as jk
from nerf_tpu.parallel.kilonerf_ep import kilonerf_eval_ep

from nerf_tpu_torch.parallel import mesh

LAYERS = ("l1", "l2", "l3", "l4", "l5")
CFG = dict(grid_size=4, hidden=16)
PTS_PER_RANK = 96
TIGHT = 8
CASES = [("suffice", "P", "P", False), ("tight", TIGHT, "P", False), ("grads", "P", "P", True)]


def _inputs(world):
    cfg = jk.KiloConfig(**CFG)
    params = jk.init_kilonerf(jax.random.PRNGKey(world), cfg)
    rng = np.random.RandomState(world)
    P = PTS_PER_RANK * world
    pts = rng.uniform(cfg.bbox_min, cfg.bbox_max, (P, 3)).astype(np.float32)
    d = rng.randn(P, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cot = rng.randn(P, 4).astype(np.float32)
    return cfg, params, pts, d, cot


@pytest.fixture(scope="module", params=[2, 4])
def run(request, tmp_path_factory):
    """(world, JAX's results per case, the port's results) at 2 and 4 ranks."""
    world = request.param
    if len(jax.devices()) < world:
        pytest.skip("not enough devices")
    cfg, params, pts, dirs, cot = _inputs(world)
    P = pts.shape[0]
    caps = [(P if s == "P" else s, P if e == "P" else e) for _, s, e, _ in CASES]
    m = Mesh(np.array(jax.devices()[:world]), ("data",))
    want = {}
    for (name, *_, grads), (send, expert) in zip(CASES, caps):
        def loss(p):
            raw = kilonerf_eval_ep(p, jnp.asarray(pts), jnp.asarray(dirs), cfg, m,
                                   send_capacity=send, expert_capacity=expert)
            return jnp.sum(raw * cot), raw

        (_, raw), g = jax.value_and_grad(loss, has_aux=True)(params)
        want[name] = (np.asarray(raw), {f"{k}_{n}": np.asarray(g[k][n]) for k in LAYERS
                                        for n in ("w", "b")} if grads else None)
    dense_g = jax.grad(lambda p: jnp.sum(jk.kilonerf_eval(
        p, jnp.asarray(pts), jnp.asarray(dirs), cfg, capacity=P) * cot))(params)
    want["dense_grads"] = {f"{k}_{n}": np.asarray(dense_g[k][n]) for k in LAYERS
                           for n in ("w", "b")}
    tmp = tmp_path_factory.mktemp(f"ep{world}")
    inp, out = str(tmp / "in.npz"), str(tmp / "out.npz")
    np.savez(inp, cfg=json.dumps(cfg._asdict()), pts=pts, dirs=dirs, cot=cot,
             capacities=np.array(caps), grads=np.array([g for *_, g in CASES]),
             **{f"{k}_{n}": np.asarray(params[k][n]) for k in LAYERS for n in ("w", "b")})
    mesh.launch("nerf_tpu_torch.parallel.dryrun", ["ep", inp, out, "--device", "cpu"], world, "cpu")
    with np.load(out) as res:
        got = {k: res[k] for k in res.files}
    return world, want, got


def test_ep_matches_jax_where_capacities_suffice(run):
    _, want, got = run
    np.testing.assert_allclose(got["raw_0"], want["suffice"][0], rtol=2e-5, atol=2e-5)
    assert np.abs(want["suffice"][0]).min(axis=-1).max() > 0  # no row dropped


def test_ep_tight_send_capacity_drops_the_rows_jax_drops(run):
    world, want, got = run
    jraw, raw = want["tight"][0], got["raw_1"]
    j_zero, zero = np.all(jraw == 0, axis=-1), np.all(raw == 0, axis=-1)
    np.testing.assert_array_equal(zero, j_zero)
    assert 0 < zero.sum() < zero.size  # 8 slots a destination drop some of 96 / rank
    np.testing.assert_allclose(raw[~zero], jraw[~zero], rtol=2e-5, atol=2e-5)


def test_ep_gradients_match_jax(run):
    _, want, got = run
    for key, jg in want["grads"][1].items():
        np.testing.assert_allclose(got[f"grad_2_{key}"], jg, rtol=1e-4, atol=1e-4, err_msg=key)
        np.testing.assert_allclose(got[f"grad_2_{key}"], want["dense_grads"][key], rtol=1e-4,
                                   atol=1e-4, err_msg=f"{key} (dense)")
    assert max(np.abs(g).max() for g in want["grads"][1].values()) > 1e-3
