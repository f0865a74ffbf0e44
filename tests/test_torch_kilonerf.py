"""nerf_tpu_torch.ops.kilonerf against nerf_tpu.ops.kilonerf on the CPU.

Small model (grid 4, hidden 16, 4/2 bands, as tests/test_kilonerf.py); the
JAX package's weights are carried across by ``from_jax_kilonerf``; the
inputs come from numpy seeds. Routing (ids, local coordinates, ranks,
dispatch) must be exact; outputs agree within atol 2e-5 (float32 sums of up
to 63 terms in another order), dropped points are exactly 0 on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.ops import kilonerf as jk
from nerf_tpu_torch.ops import kilonerf as tk
from nerf_tpu_torch.train.checkpoint import from_jax_kilonerf

ATOL = 2e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these tests run many small ops, and with several
    test workers on the machine torch's thread pool spins against itself."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(**kw):
    return (jk.KiloConfig(grid_size=4, hidden=16, xyz_freqs=4, dir_freqs=2, **kw),
            tk.KiloConfig(grid_size=4, hidden=16, xyz_freqs=4, dir_freqs=2, **kw))


def models(seed, jcfg):
    jp = jk.init_kilonerf(jax.random.PRNGKey(seed), jcfg)
    return jp, from_jax_kilonerf(jax.tree_util.tree_map(np.asarray, jp))


def clustered(n, seed, spread=0.6):
    """Points around three centres (loads far from even) and some outside the box."""
    rng = np.random.RandomState(seed)
    centres = np.array([[0.3, -0.4, 0.2], [-1.1, 0.9, 1.5], [1.7, 1.7, -1.8]], np.float32)
    pts = centres[rng.randint(0, 3, n)] + rng.randn(n, 3).astype(np.float32) * spread
    dirs = rng.randn(n, 3).astype(np.float32)
    return pts.astype(np.float32), (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True))


def test_assign_and_local_are_exact():
    jcfg, tcfg = small()
    pts, _ = clustered(4000, 0, spread=1.5)  # some points outside [-2, 2]^3: clamped ids
    ids_j = np.asarray(jk.assign_networks(jnp.asarray(pts), jcfg))
    ids_t = tk.assign_networks(torch.from_numpy(pts), tcfg)
    np.testing.assert_array_equal(ids_t.numpy(), ids_j)
    loc_j = np.asarray(jk.global_to_local(jnp.asarray(pts), jnp.asarray(ids_j), jcfg))
    loc_t = tk.global_to_local(torch.from_numpy(pts), ids_t, tcfg).numpy()
    np.testing.assert_array_equal(loc_t, loc_j)
    assert tk.n_networks(tcfg) == 64 and int(ids_t.min()) >= 0 and int(ids_t.max()) <= 63


@pytest.mark.parametrize("P", [96, 2048, 5000])
def test_rank_is_the_stable_rank_of_both_jax_paths(P):
    """Below and above 2,048 points: JAX's sort path and its bucketed path."""
    jcfg, tcfg = small()
    pts, _ = clustered(P, P)
    ids = jk.assign_networks(jnp.asarray(pts), jcfg)
    G = jk.n_networks(jcfg)
    got = tk.rank_in_network(torch.from_numpy(np.asarray(ids, np.int64)), G).numpy()
    np.testing.assert_array_equal(got, np.asarray(jk._rank_sort(ids, G)))
    np.testing.assert_array_equal(got, np.asarray(jk._rank_bucketed(ids, G)))
    ids_np = np.asarray(ids)
    want = np.array([(ids_np[:i] == ids_np[i]).sum() for i in range(P)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("round_offset", [0, 1, 2, 3])
def test_dispatch_is_exact(round_offset):
    """The windows kilonerf_eval serves (round_window) are JAX's _dispatch:
    each served point sits in its JAX slot of its network, JAX's gather
    reads it from there, and JAX serves no other point."""
    jcfg, tcfg = small()
    pts, _ = clustered(3000, 7)
    ids = jk.assign_networks(jnp.asarray(pts), jcfg)
    G, C = jk.n_networks(jcfg), 40
    sj, gj, vj = (np.asarray(a) for a in jk._dispatch(ids, G, C, round_offset=round_offset))
    ids_t = torch.from_numpy(np.asarray(ids, np.int64))
    counts = torch.bincount(ids_t, minlength=G)
    active, sel, flat, cr = tk.round_window(ids_t, tk.rank_in_network(ids_t, G), counts,
                                            int(counts.max()), round_offset * C, C)
    sel, net, slot = sel.numpy(), active[flat // cr].numpy(), (flat % cr).numpy()
    np.testing.assert_array_equal(np.flatnonzero(sj >= 0), sel)
    np.testing.assert_array_equal(net, np.asarray(ids)[sel])
    np.testing.assert_array_equal(slot, sj[sel])
    np.testing.assert_array_equal(gj[net, slot], sel)
    assert int(vj.sum()) == sel.shape[0] and bool(vj[net, slot].all())
    np.testing.assert_array_equal(active.numpy(), np.flatnonzero(vj.any(1)))
    assert cr == int(vj.sum(1).max()) and 0 < sel.shape[0] < 3000


def _eval_both(jp, tp, jcfg, tcfg, pts, dirs, capacity):
    want = np.asarray(jk.kilonerf_eval(jp, jnp.asarray(pts), jnp.asarray(dirs), jcfg,
                                       capacity=capacity))
    got = tk.kilonerf_eval(tp, torch.from_numpy(pts), torch.from_numpy(dirs), tcfg,
                           capacity=capacity).numpy()
    return got, want


@pytest.mark.parametrize("case", ["no_drops", "drops", "drops_4_rounds", "default_capacity"])
def test_kilonerf_eval_matches_jax(case):
    rounds = 4 if case == "drops_4_rounds" else 1
    jcfg, tcfg = small(dispatch_rounds=rounds)
    jp, tp = models(0, jcfg)
    if case == "no_drops":
        pts, dirs = clustered(96, 1, spread=1.0)
        capacity = 96
    else:
        pts, dirs = clustered(3000, 2)
        capacity = {"drops": 30, "drops_4_rounds": 30, "default_capacity": 0}[case]
    got, want = _eval_both(jp, tp, jcfg, tcfg, pts, dirs, capacity)
    zero_j, zero_t = (want == 0).all(-1), (got == 0).all(-1)
    np.testing.assert_array_equal(zero_t, zero_j)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    served = tk.served_per_round(torch.from_numpy(pts), tcfg, capacity)
    assert sum(served) == int((~zero_t).sum())
    if case == "no_drops":
        assert not zero_t.any()
    else:
        assert zero_t.any() and not zero_t.all()


def test_more_rounds_serve_what_one_round_drops():
    jcfg1, tcfg1 = small(dispatch_rounds=1)
    jcfg4, tcfg4 = small(dispatch_rounds=4)
    _, tp = models(3, jcfg1)
    pts, dirs = clustered(3000, 4)
    p, d = torch.from_numpy(pts), torch.from_numpy(dirs)
    one = tk.kilonerf_eval(tp, p, d, tcfg1, capacity=30)
    four = tk.kilonerf_eval(tp, p, d, tcfg4, capacity=30)
    kept = ~(one == 0).all(-1)
    assert torch.equal(four[kept], one[kept])  # round 0 is the same window
    assert int((~(four == 0).all(-1)).sum()) > int(kept.sum())


@pytest.mark.parametrize("pack", [4, 1])
def test_mlp_grouped_matches_jax(pack):
    jcfg, tcfg = small()
    jp, tp = models(5, jcfg)
    rng = np.random.RandomState(pack)
    G = jk.n_networks(jcfg)
    xg = rng.uniform(-1, 1, (G, 12, 3)).astype(np.float32)
    dg = rng.randn(G, 12, 3).astype(np.float32)
    want = np.asarray(jk.mlp_grouped(jp, jnp.asarray(xg), jnp.asarray(dg), jcfg, pack=pack))
    got = tk.mlp_grouped(tp, torch.from_numpy(xg), torch.from_numpy(dg), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_gradients_match_jax():
    """d/dparams of sum(raw * c) with drops; per leaf within 1e-4 of its
    largest |value| (float32 sums over up to 3,000 points in another order)."""
    jcfg, tcfg = small(dispatch_rounds=2)
    jp, _ = models(6, jcfg)
    pts, dirs = clustered(3000, 8)
    cot = np.random.RandomState(9).randn(3000, 4).astype(np.float32)

    def jloss(p):
        return jnp.sum(jk.kilonerf_eval(p, jnp.asarray(pts), jnp.asarray(dirs), jcfg,
                                        capacity=40) * cot)

    jg = jax.grad(jloss)(jp)
    tp = from_jax_kilonerf(jax.tree_util.tree_map(np.asarray, jp), requires_grad=True)
    (tk.kilonerf_eval(tp, torch.from_numpy(pts), torch.from_numpy(dirs), tcfg, capacity=40)
     * torch.from_numpy(cot)).sum().backward()
    for name in tk.LAYERS:
        for leaf in ("w", "b"):
            want = np.asarray(jg[name][leaf])
            got = tp[name][leaf].grad.numpy()
            scale = np.abs(want).max()
            assert scale > 0, (name, leaf)
            np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=0,
                                       err_msg=f"{name}.{leaf}")


def test_matches_the_naive_per_point_evaluation():
    """No capacity limit: every point through its own network in float64."""
    _, tcfg = small(dispatch_rounds=1)
    _, tp = models(10, small()[0])
    pts, dirs = clustered(2500, 11, spread=1.2)
    p, d = torch.from_numpy(pts), torch.from_numpy(dirs)
    got = tk.kilonerf_eval(tp, p, d, tcfg, capacity=tk.no_drop_capacity(p, tcfg))
    want = tk.kilonerf_naive(tp, p, d, tcfg)
    assert want.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    assert tk.served_per_round(p, tcfg, tk.no_drop_capacity(p, tcfg)) == [2500]


def test_init_and_query_shapes():
    _, tcfg = small()
    p = tk.init_kilonerf(torch.Generator().manual_seed(0), tcfg)
    assert {k: tuple(v["w"].shape) for k, v in p.items()} == {
        "l1": (64, 27, 16), "l2": (64, 16, 16), "l3": (64, 16, 17), "l4": (64, 31, 16),
        "l5": (64, 16, 3)}
    assert all(v["w"].abs().max() <= 1.0 / v["w"].shape[1] ** 0.5 for v in p.values())
    pts = torch.rand(5, 7, 3) * 4 - 2
    raw = tk.query_network_kilonerf(p, pts, torch.randn(5, 3), tcfg)
    assert raw.shape == (5, 7, 4) and bool(torch.isfinite(raw).all())
    assert tk.default_capacity(4096, tk.KiloConfig(capacity_factor=3.0)) == 8
    assert tk.default_capacity(1_572_864, tk.KiloConfig(capacity_factor=3.0)) == 1152
