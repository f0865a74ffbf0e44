"""nerf_tpu_torch's encoder factory against nerf_tpu's on the CPU.

Every type ``nerf_tpu.models.encoders.get_encoder`` accepts is built at small
sizes (4 levels, 2^10 table rows, base 4, scale 2, 10 frames, MLP widths
8-32) by both factories; JAX's parameter tree goes through the port's one
carry function, ``encoders.params_from_jax``, and the same inputs, made with
numpy from a seed, go through both. Tolerances:
- SH, degrees 1-4: 1e-6 absolute (unit directions, the same products).
- Outputs: 1e-5 absolute. The hash tables are redrawn U(-1/4, 1/4) in bf16
  and the tri-planes N(0, 1), so the features are O(0.1-1); the deformation
  heads (zero at init) are redrawn too, so the deformation moves the points.
  A deformed point carries the MLP's float32 rounding (~1e-7) into the
  finest level's slope, up to 2 x 32 x the tables' half-range: with tables
  U(-1, 1) motion2d's outputs differ by up to 1.03e-5 (1 of 9,600).
- Gradients of sum(out * g): each float32 leaf (MLPs, latent codes,
  tri-planes) within 1e-5 of max(1, its largest |value|); each bf16 table
  per element within bf16's own distance, as ``tests/test_torch_hashgrid.py``
  bounds it: |port - jax| <= |jax - f64| + 2^-8 |f64| + 2 n 2^-24 S, f64
  the port's own cotangent rows summed in float64, n the rows added into the
  element and S the sum of their magnitudes (JAX scatter-adds in bf16, the
  port sums in float32 and rounds once).
- The hash grid's corner rows at D = 2 and 4: equal to JAX's
  ``_corner_index`` (level 0 dense, the finest hashed).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.models import encoders as jenc
from nerf_tpu.models import hashgrid as jhash

from nerf_tpu_torch.models import encoders, hashgrid
from nerf_tpu_torch.ops import hash_gather
from nerf_tpu_torch.tree import tree_flatten, tree_leaves

U = 2.0 ** -24
SMALL = {"n_levels": 4, "log2_hashmap_size": 10, "base_resolution": 4, "per_level_scale": 2.0,
         "num_frames": 10}
# every type JAX's factory accepts, at small sizes, and how its fn is called
CASES = {
    "frequency": ({"input_dim": 3, "freq": 6}, "x"),
    "sphere_harmonics": ({"degree": 4}, "dir"),
    "hashgrid": (SMALL, "x"),
    "grid_hash": (SMALL, "x"),
    "cuda_hashgrid": ({**SMALL, "layout": "cellpack"}, "x"),
    "triplane": ({"resolution": 16, "n_features": 4}, "x"),
    "cuda_triplane": ({"resolution": 8, "n_features": 2}, "x"),
    "cuda_hashgrid_4d": (SMALL, "xyzt"),
    "cuda_hashgrid_latent": ({**SMALL, "latent_dim": 8}, "xyzt"),
    "cuda_hashgrid_coef": ({**SMALL, "basis_num": 3, "coef_hidden": 16}, "xyzt"),
    "cuda_motion2d": ({**SMALL, "deform_width": 32, "deform_depth": 3}, "xyzt"),
    "dnerf": ({"freq": 4, "deform_width": 16, "deform_depth": 2}, "pts_t"),
    "dnerf_ngp_mlp": ({**SMALL, "deform_width": 16, "deform_depth": 2}, "pts_t"),
    "dnerf_ngp_tensorf": ({**SMALL, "deform_width": 8, "deform_depth": 3, "freq": 6}, "pts_t"),
    "cuda_dnerf_ngp_tensorf": ({**SMALL, "deform_width": 32, "deform_depth": 2}, "pts_t"),
    "dnerf_mlp_tensorf": ({"resolution": 16, "n_features": 4, "deform_width": 16,
                           "deform_depth": 2}, "pts_t"),
}
LEARNED = [t for t in CASES if t not in ("frequency", "sphere_harmonics")]


def _inputs(kind, n, seed):
    """numpy inputs for a fn: x [n, 3]; unit dirs; xyzt with integer and
    fractional frames in [0, 9] (some at 0); or (pts, t in [0, 1], some 0)."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-2.2, 2.2, (n, 3)).astype(np.float32)
    if kind == "x":
        return (xyz,)
    if kind == "dir":
        d = rng.normal(size=(n, 3))
        return ((d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32),)
    if kind == "xyzt":
        t = rng.integers(0, 10, (n, 1)).astype(np.float32)
        t[::3] += rng.uniform(0, 0.9, t[::3].shape).astype(np.float32)
        return (np.concatenate([xyz, t], -1),)
    t = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    t[::4] = 0.0
    return xyz, t


def _redraw(tree, rng):
    """JAX's tree with U(-1/4, 1/4) tables and latents, N(0, 1) planes and a
    random deformation head (the MLP weights stay JAX's init)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        a = np.asarray(node)
        if "table" in path or "latent_t" in path:
            v = rng.uniform(-0.25, 0.25, a.shape).astype(np.float32)
            return np.asarray(jnp.asarray(v, a.dtype))
        if path[-1] == "planes":
            return rng.normal(size=a.shape).astype(np.float32)
        if path[:2] == ("deform", "head"):
            return rng.uniform(-0.3, 0.3, a.shape).astype(np.float32)
        return a
    return walk(tree, ())


def _jax_call(fn, params, args):
    return fn(params, *[jnp.asarray(a) for a in args])


def _spy_tables(monkeypatch):
    """Record, for each table gather of the port's forward, its table's
    storage, and for each scatter-add of the backward its (idx, cot, n_rows)."""
    tables, scatters = {}, []
    real_gather, real_scatter = hashgrid.gather_rows_diff, hash_gather.scatter_add_rows_plain

    def gather(table, idx, plain=False):
        tables[idx.data_ptr()] = table.data_ptr()
        return real_gather(table, idx, plain)

    def scatter(idx, cot, n_rows):
        scatters.append((idx, cot, n_rows))
        return real_scatter(idx, cot, n_rows)

    monkeypatch.setattr(hashgrid, "gather_rows_diff", gather)
    monkeypatch.setattr(hash_gather, "scatter_add_rows_plain", scatter)
    return tables, scatters


def _table_bound(idx, cot, n_rows, jax_grad):
    """Per element: |jax - f64| + 2^-8 |f64| + 2 n 2^-24 S (module docstring)."""
    i = idx.long()
    c64 = cot.double()
    f64 = torch.zeros((n_rows, cot.shape[1]), dtype=torch.float64).index_add_(0, i, c64)
    mag = torch.zeros_like(f64).index_add_(0, i, c64.abs())
    cnt = torch.zeros((n_rows, 1), dtype=torch.float64).index_add_(
        0, i, torch.ones((i.shape[0], 1), dtype=torch.float64))
    dist = (torch.from_numpy(np.asarray(jax_grad, np.float64)) - f64).abs()
    return dist + 2.0 ** -8 * f64.abs() + 2.0 * cnt * U * mag


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_matches_jax(degree):
    (d,) = _inputs("dir", 500, degree)
    want = np.asarray(jenc.sh_encode(jnp.asarray(d), degree))
    got = encoders.sh_encode(torch.from_numpy(d), degree)
    assert got.shape == (500, degree ** 2) == want.shape
    assert encoders.sh_out_dim(degree) == jenc.sh_out_dim(degree)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("etype", ["frequency", "sphere_harmonics"])
def test_parameter_free_types_match_jax(etype):
    cfg, kind = CASES[etype]
    jfn, jdim = jenc.get_encoder({"type": etype, **cfg})
    fn, dim = encoders.get_encoder({"type": etype, **cfg})
    (x,) = _inputs(kind, 300, 0)
    assert dim == jdim
    np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), np.asarray(jfn(jnp.asarray(x))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("etype", LEARNED)
def test_learned_type_trees_and_carry(etype):
    """The port's own init has JAX's tree: the same leaves in JAX's flatten
    order, shapes and dtypes; JAX's initial tree carries over exactly."""
    cfg = {"type": etype, **CASES[etype][0]}
    jparams, _, jdim = jenc.get_encoder(cfg, jax.random.PRNGKey(3))
    params, _, dim = encoders.get_encoder(cfg, torch.Generator().manual_seed(3))
    assert dim == jdim
    jleaves = jax.tree_util.tree_leaves(jparams)
    leaves = tree_leaves(params)
    assert [tuple(t.shape) for t in leaves] == [tuple(a.shape) for a in jleaves]
    assert [str(t.dtype).split(".")[-1] for t in leaves] == [str(a.dtype) for a in jleaves]
    carried = tree_leaves(encoders.params_from_jax(etype, jax.device_get(jparams)))
    for t, a in zip(carried, jleaves):
        a = np.asarray(a)
        assert str(t.dtype).split(".")[-1] == str(a.dtype)
        np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


@pytest.mark.parametrize("etype", LEARNED)
def test_learned_type_forward_and_gradients_match_jax(etype, monkeypatch):
    cfg, kind = CASES[etype]
    cfg = {"type": etype, **cfg}
    rng = np.random.default_rng(sorted(CASES).index(etype))
    jparams, jfn, dim = jenc.get_encoder(cfg, jax.random.PRNGKey(1))
    jtree = _redraw(jax.device_get(jparams), rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, jtree)
    _, fn, _ = encoders.get_encoder(cfg)
    params = encoders.params_from_jax(etype, jtree)
    args = _inputs(kind, 400, 7)
    g = rng.normal(size=(400, dim)).astype(np.float32)

    want = np.asarray(_jax_call(jfn, jparams, args))
    jgrads = jax.grad(lambda p: jnp.sum(_jax_call(jfn, p, args) * jnp.asarray(g)))(jparams)
    tables, scatters = _spy_tables(monkeypatch)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    out = fn(params, *[torch.from_numpy(a) for a in args])
    assert out.dtype == torch.float32 and out.shape == (400, dim)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=1e-5)
    assert np.abs(want).max() > 0.05
    (out * torch.from_numpy(g)).sum().backward()

    by_table = {}
    for idx, cot, n_rows in scatters:
        by_table[tables[idx.data_ptr()]] = (idx, cot, n_rows)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    leaves, _ = tree_flatten(params)
    assert len(leaves) == len(jleaves)
    n_tables = 0
    for t, jg in zip(leaves, jleaves):
        jg = np.asarray(jg.astype(jnp.float32))
        if t.dtype == torch.bfloat16:
            n_tables += 1
            idx, cot, n_rows = by_table[t.data_ptr()]
            want_g = jg.reshape(n_rows, -1)
            got = t.grad.float().reshape(n_rows, -1).double()
            err = (got - torch.from_numpy(want_g.copy()).double()).abs()
            assert bool((err <= _table_bound(idx, cot, n_rows, want_g)).all()), etype
            assert np.abs(want_g).max() > 0
        else:
            np.testing.assert_allclose(t.grad.numpy(), jg, rtol=0,
                                       atol=1e-5 * max(1.0, float(np.abs(jg).max())))
    assert n_tables == len(scatters)


@pytest.mark.parametrize("etype", ["dnerf", "dnerf_ngp_mlp", "dnerf_mlp_tensorf"])
def test_dnerf_t0_is_the_undeformed_encoding(etype):
    """At t = 0 the deformation is skipped, whatever its weights: the output
    is the spatial encoder's on the points themselves."""
    cfg = {"type": etype, **CASES[etype][0]}
    params, fn, _ = encoders.get_encoder(cfg, torch.Generator().manual_seed(2))
    head = params["deform"]["head"]
    head["w"].uniform_(-1, 1)
    head["b"].uniform_(-1, 1)
    pts = torch.from_numpy(_inputs("x", 64, 3)[0])
    moved = fn(params, pts, torch.full((64, 1), 0.5))
    same = fn(params, pts, torch.zeros(64, 1))
    if etype == "dnerf":
        want = encoders.freq_encode(pts, 4)
    elif etype == "dnerf_ngp_mlp":
        want = hashgrid.hashgrid_encode(params["grid"], pts, base_resolution=4,
                                        per_level_scale=2.0)
    else:
        from nerf_tpu_torch.models.triplane import triplane_encode

        want = triplane_encode(params["planes"], pts)
    assert torch.equal(same, want)
    assert not torch.equal(moved, want)


def test_unknown_type_raises():
    with pytest.raises(ValueError, match="unknown encoder type: nope"):
        encoders.get_encoder({"type": "nope"})
    with pytest.raises(ValueError, match="unknown encoder type"):
        encoders.params_from_jax("nope", {})
    with pytest.raises(ValueError, match="expected the keys"):
        encoders.params_from_jax("cuda_hashgrid_latent", {"grid": {}})


@pytest.mark.parametrize("D", [2, 3, 4])
def test_corner_rows_match_jax_corner_index(D):
    """hashgrid_index's corner rows at input dimension D against JAX's
    ``_corner_index``, level by level, on a 2^10-row table."""
    L, T = 4, 1 << 10
    res = jhash.level_resolutions(L, 4, 2.0)
    dense = (res.astype(np.int64) + 1) ** D <= T
    assert dense[0] and not dense[-1]
    pts = np.random.default_rng(D).uniform(-2.1, 2.1, (200, D)).astype(np.float32)
    idx, frac = hashgrid.hashgrid_index((L, T, 2), torch.from_numpy(pts), res)
    x = np.clip((pts + 2.0) / 4.0, 0.0, np.float32(1.0 - 1e-6))
    offs = np.array(list(itertools.product((0, 1), repeat=D)), np.int32)
    got = idx.numpy().reshape(L, 200, 1 << D)
    for lv in range(L):
        xl = x * np.float32(res[lv])
        c = np.floor(xl).astype(np.int32)[:, None, :] + offs[None]
        want = jhash._corner_index(jnp.asarray(c), jnp.asarray(res[lv]), T,
                                   jnp.asarray(dense[lv]))
        np.testing.assert_array_equal(got[lv], np.asarray(want) + lv * T)
        np.testing.assert_allclose(frac[lv].numpy(), xl - np.floor(xl), rtol=0, atol=0)
