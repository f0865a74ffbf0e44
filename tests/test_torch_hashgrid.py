"""nerf_tpu_torch's hash-grid model against nerf_tpu on the CPU.

The same inputs, made with numpy or read from the committed hash-grid state
(checkpoints/nerf/lego/nerf_hashgrid_cellpack, epoch 79, 105 leaves), go
through both packages. Tolerances:
- hashgrid_encode: 1e-6 absolute, float32 and bfloat16 tables alike (both
  interpolate the same rows in float32; the weights are products of three
  float32 factors and the sum runs over 8 corners, in other orders).
- the table's gradient: JAX scatter-adds the bf16 cotangent rows in bf16
  (the slotpack VJP), the port sums them in float32 and rounds once. Per
  element, |port - jax| <= |jax - f64| + 2^-8 |f64| + 2 n 2^-24 S, where f64
  is the same cotangents summed in float64, n the number of rows added into
  the element and S the sum of their magnitudes: the distance of bf16
  accumulation from float64 plus the port's own float32 sum and its one
  rounding to bf16.
- render_rays on the committed checkpoint, perturb 0, no ESS grid, 160
  rays: with float32 MLP weights 1e-4 on the colors and the accumulated
  opacity (float32 sums in other orders move a coarse weight by ~1e-7, and
  the inverse-CDF fine samples move with it, as in tests/test_torch_render.py);
  with the config's bfloat16 weights 99% of the values within 2e-3 and all
  within 2e-2 (an activation next to a bf16 rounding boundary rounds the
  other way after a sum in another order and moves the output by ~2^-9 of
  its size; on a few rays such a flip in the coarse pass also moves the
  fine samples). Depth 2e-2 for both: on background rays the coarse CDF is
  nearly flat and a 1e-7 change in a weight moves a fine sample by up to
  1e-2 (measured 7.8e-3 on 3 of 160 rays at depth 5.9).
- one train step (float32 MLP weights, same rays, targets and fine
  samples): loss 1e-5 relative, each MLP gradient 2e-4 of its largest
  |value|, MLP params after Adam 1e-6, their moments 1e-4 relative, the
  tables' gradients within the bound above (f64 sums the port's own
  cotangent rows, which come from its own MLP backward). The bf16 tables and their bf16
  moments after Adam are identical wherever the two gradients are identical
  (XLA on the CPU flushes subnormal results to zero, torch keeps them, so
  both are flushed before comparing); elsewhere within 1e-2 in relative
  norm, and a table entry within two Adam steps (2.1 lr).
- one bf16 Adam step on random values against optax: exact.
- checkpoints: exact, bf16 leaves bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_tpu.config import make_cfg as jax_make_cfg
from nerf_tpu.models import hashgrid as jhash
from nerf_tpu.render import renderer as jrend
from nerf_tpu.train import checkpoint as jckpt
from nerf_tpu.train import optim as joptim
from nerf_tpu.train import state as jstate
from nerf_tpu.train.loop import init_nerf_params as jax_init_params
from nerf_tpu.train.loop import make_density_fn as jax_density_fn

from nerf_tpu_torch.config import make_cfg
from nerf_tpu_torch.models import hashgrid
from nerf_tpu_torch.ops import hash_gather
from nerf_tpu_torch.render import occupancy as occ
from nerf_tpu_torch.render import renderer
from nerf_tpu_torch.serve import RenderService, look_at_pose
from nerf_tpu_torch.train import checkpoint, loop, optim, state as tstate
from nerf_tpu_torch.tree import tree_leaves

ROOT = os.path.join(os.path.dirname(__file__), "..")
HASH_CFG = os.path.join(ROOT, "configs", "nerf", "lego_hashgrid_cellpack.yaml")
HASH = os.path.join(ROOT, "checkpoints", "nerf", "lego", "nerf_hashgrid_cellpack")
SMALL = ["network.xyz_encoder.n_levels", "2", "network.xyz_encoder.log2_hashmap_size", "10"]
F32 = ["network.dtype", "float32", "task_arg.perturb", "0"]
U = 2.0 ** -24


def _table(shape, dtype, seed):
    """A random table as (numpy float32 of the dtype's values, torch, jax)."""
    t = np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)
    if dtype == "bfloat16":
        tt = torch.from_numpy(t).to(torch.bfloat16)
        return tt.float().numpy(), tt, jnp.asarray(tt.float().numpy(), jnp.bfloat16)
    return t, torch.from_numpy(t), jnp.asarray(t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["cellpack", "corner"])
def test_encode_matches_jax_small(layout, dtype):
    """4 levels, log2 table 12, resolutions 4..32: the coarse levels index
    directly and the finest take the hash."""
    res = jhash.level_resolutions(4, 4, 2.0)
    shape = hashgrid.table_shape(4, 2, 12, layout)
    assert shape == jhash.init_hashgrid(jax.random.PRNGKey(0), 4, 2, 12, layout=layout,
                                        dtype=jnp.float32)["table"].shape
    T = shape[1]
    dense = [(int(r) + (layout == "corner")) ** 3 <= T for r in res]
    assert any(dense) and not all(dense)
    _, tt, jt = _table(shape, dtype, 0)
    pts = np.random.default_rng(1).uniform(-2.2, 2.2, (300, 3)).astype(np.float32)
    want = np.asarray(jhash.hashgrid_encode({"table": jt}, jnp.asarray(pts), resolutions=res,
                                            layout=layout))
    got = hashgrid.hashgrid_encode({"table": tt}, torch.from_numpy(pts), resolutions=res,
                                   layout=layout)
    assert got.dtype == torch.float32 and got.shape == (300, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_encode_matches_jax_on_the_committed_tables():
    """The default geometry (16 levels, 2^19 table, cellpack) on the trained
    bf16 tables: its finest levels overflow int32 in res**3 and must hash."""
    res = hashgrid.level_resolutions(16, 16, 1.3819)
    np.testing.assert_array_equal(res, jhash.level_resolutions(16, 16, 1.3819))
    assert (res.astype(np.int64) ** 3 > 2**31).any()
    with np.load(os.path.join(HASH, "latest.npz")) as data:
        bits = data["leaf_16"]
    tt = checkpoint.bf16_tensor(bits)
    jt = jnp.asarray(bits.view(np.uint16)).view(jnp.bfloat16)
    pts = np.random.default_rng(2).uniform(-1.5, 1.5, (400, 3)).astype(np.float32)
    want = np.asarray(jhash.hashgrid_encode({"table": jt}, jnp.asarray(pts), layout="cellpack"))
    got = hashgrid.hashgrid_encode({"table": tt}, torch.from_numpy(pts), layout="cellpack")
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("layout", ["cellpack", "corner"])
def test_index_hash_wraps_like_uint32(layout):
    """The rows of the finest levels against a numpy uint32 hash."""
    shape = hashgrid.table_shape(16, 2, 19, layout)
    res = hashgrid.level_resolutions()
    pts = np.random.default_rng(3).uniform(-2, 2, (50, 3)).astype(np.float32)
    idx, _ = hashgrid.hashgrid_index(shape, torch.from_numpy(pts), res, layout=layout)
    T = shape[1]
    per_level = idx.numpy().astype(np.int64).reshape(16, 50, -1)
    x = np.clip((pts + 2.0) / 4.0, 0.0, np.float32(1.0 - 1e-6))
    for lv in (14, 15):
        c = np.floor(x * np.float32(res[lv])).astype(np.uint32)
        if layout == "corner":
            c = c[:, None, :] + np.array([[0, 0, 0], [0, 0, 1]], np.uint32)[None]
        with np.errstate(over="ignore"):
            h = (c[..., 0] * np.uint32(1) ^ c[..., 1] * np.uint32(2654435761)
                 ^ c[..., 2] * np.uint32(805459861)) % np.uint32(T)
        got = per_level[lv][:, :2] if layout == "corner" else per_level[lv][:, 0]
        np.testing.assert_array_equal(got, h.astype(np.int64) + lv * T)


def _accum_bound(idx, cot, n_rows, jax_grad):
    """Per element: |jax - f64| + 2^-8 |f64| + 2 n 2^-24 S (see the docstring)."""
    i = idx.long()
    c64 = cot.double()
    f64 = torch.zeros((n_rows, cot.shape[1]), dtype=torch.float64).index_add_(0, i, c64)
    mag = torch.zeros_like(f64).index_add_(0, i, c64.abs())
    cnt = torch.zeros((n_rows, 1), dtype=torch.float64).index_add_(
        0, i, torch.ones((i.shape[0], 1), dtype=torch.float64))
    dist = (torch.from_numpy(np.asarray(jax_grad, np.float64)) - f64).abs()
    return dist + 2.0 ** -8 * f64.abs() + 2.0 * cnt * U * mag, float(dist.max())


def _spy_scatter(monkeypatch):
    seen = []
    real = hash_gather.scatter_add_rows_plain

    def spy(idx, cot, n_rows):
        seen.append((idx, cot, n_rows))
        return real(idx, cot, n_rows)

    monkeypatch.setattr(hash_gather, "scatter_add_rows_plain", spy)
    return seen


def test_table_gradient_matches_jax_slotpack(monkeypatch):
    """The bf16 cellpack table's gradient (through the slotpack VJP in JAX)
    within the bf16-accumulation bound; 600 points on 4 levels of 512 rows
    put up to hundreds of cotangent rows on one table row."""
    res = jhash.level_resolutions(4, 4, 2.0)
    shape = hashgrid.table_shape(4, 2, 12, "cellpack")
    _, tt, jt = _table(shape, "bfloat16", 4)
    rng = np.random.default_rng(5)
    pts = rng.uniform(-2, 2, (600, 3)).astype(np.float32)
    g = rng.normal(size=(600, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jhash.hashgrid_encode({"table": t}, jnp.asarray(pts),
                                                     resolutions=res, layout="cellpack"), jt)
    (want,) = vjp(jnp.asarray(g))
    assert want.dtype == jnp.bfloat16
    seen = _spy_scatter(monkeypatch)
    table = tt.clone().requires_grad_(True)
    out = hashgrid.hashgrid_encode({"table": table}, torch.from_numpy(pts), resolutions=res,
                                   layout="cellpack")
    (out * torch.from_numpy(g)).sum().backward()
    assert table.grad.dtype == torch.bfloat16 and len(seen) == 1
    idx, cot, n_rows = seen[0]
    assert cot.dtype == torch.bfloat16 and n_rows == 4 * shape[1]
    want = np.asarray(want.astype(jnp.float32)).reshape(n_rows, -1)
    bound, jax_dist = _accum_bound(idx, cot, n_rows, want)
    got = table.grad.float().reshape(n_rows, -1).double()
    err = (got - torch.from_numpy(want.copy()).double()).abs()
    print(f"table gradient: max |port - jax| {float(err.max()):.3g}, max |jax - f64| "
          f"{jax_dist:.3g}")
    assert bool((err <= bound).all())


def _hash_state(cfg, ckpt=HASH):
    opts = renderer.RenderOptions.from_cfg(cfg)
    template = tstate.init_state(loop.init_nerf_params(torch.Generator().manual_seed(0), opts),
                                 optim.make_optimizer(cfg))
    return checkpoint.load_checkpoint(ckpt, template), opts


def _jax_hash_state(jcfg, ckpt=HASH):
    jopts = jrend.RenderOptions.from_cfg(jcfg)
    tx = joptim.make_optimizer(jcfg)
    template = jstate.init_state(jax_init_params(jax.random.PRNGKey(0), jopts), tx)
    st, epoch, rec = jckpt.load_checkpoint(ckpt, template)
    # the leaves load as numpy arrays; the trainer's jit makes them JAX
    # arrays (numpy would promote the bf16 moments to float32 in the update)
    return (jax.tree_util.tree_map(jnp.asarray, st), epoch, rec), tx, jopts


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    poses = np.stack([look_at_pose(t, 0.3, 4.0) for t in (0.5, 2.5)])
    from nerf_tpu_torch.render.rays import rays_for_pixels

    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)
    idx, px, py = rng.integers(0, 2, n), rng.integers(8, 24, n), rng.integers(8, 24, n)
    o, d = rays_for_pixels(torch.from_numpy(px.astype(np.float32)),
                           torch.from_numpy(py.astype(np.float32)), torch.from_numpy(K),
                           torch.from_numpy(poses[idx]))
    return o.numpy(), d.numpy(), rng.uniform(0, 1, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype,tol,q", [("float32", 1e-4, 1.0), ("bfloat16", 2e-3, 0.99)])
def test_render_rays_matches_jax_on_the_committed_model(dtype, tol, q):
    over = ["network.dtype", dtype, "task_arg.perturb", "0"]
    cfg, jcfg = make_cfg(HASH_CFG, over), jax_make_cfg(HASH_CFG, over)
    opts = renderer.RenderOptions.from_cfg(cfg)
    jopts = jrend.RenderOptions.from_cfg(jcfg)
    assert opts.hashgrid and opts.hash_layout == "cellpack" and opts.input_ch == 32
    tree = checkpoint.load_params(HASH, **opts.model_shape())
    jparams = jax.tree_util.tree_map(jnp.asarray, jckpt.load_params(
        HASH, jax_init_params(jax.random.PRNGKey(0), jopts)))
    o, d, _ = _rays(160, 6)
    want = jrend.render_rays(jparams, jnp.asarray(o), jnp.asarray(d), jax.random.PRNGKey(0),
                             jopts, None)
    got = renderer.render_rays(renderer.kernel_params(tree, opts), torch.from_numpy(o),
                               torch.from_numpy(d), opts)
    assert float(np.asarray(want["acc_map"]).mean()) > 0.1
    for k in ("rgb_map_0", "rgb_map", "acc_map_0", "acc_map"):
        err = np.abs(got[k].numpy() - np.asarray(want[k]))
        assert np.quantile(err, q) <= tol and err.max() <= 10 * tol, (k, err.max())
    for k in ("depth_map_0", "depth_map"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=2e-2,
                                   err_msg=k)


def test_load_params_matches_jax_on_the_committed_model():
    opts = renderer.RenderOptions.from_cfg(make_cfg(HASH_CFG))
    jopts = jrend.RenderOptions.from_cfg(jax_make_cfg(HASH_CFG))
    tree = checkpoint.load_params(HASH, **opts.model_shape())
    want = jckpt.load_params(HASH, jax_init_params(jax.random.PRNGKey(0), jopts))
    got_leaves, want_leaves = tree_leaves(tree), jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves) == 34
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    assert tree["coarse"]["xyz_encoder"]["table"].shape == (16, 65536, 16)


def test_density_fn_matches_jax_with_a_zero_direction_embedding():
    over = ["network.dtype", "float32"]
    cfg, jcfg = make_cfg(HASH_CFG, over), jax_make_cfg(HASH_CFG, over)
    opts = renderer.RenderOptions.from_cfg(cfg)
    jopts = jrend.RenderOptions.from_cfg(jcfg)
    tree = checkpoint.load_params(HASH, **opts.model_shape())
    jparams = jckpt.load_params(HASH, jax_init_params(jax.random.PRNGKey(0), jopts))
    pts = np.random.default_rng(7).uniform(-1, 1, (500, 3)).astype(np.float32)
    want = np.asarray(jax_density_fn(jax.tree_util.tree_map(jnp.asarray, jparams["coarse"]),
                                     jopts)(jnp.asarray(pts)))
    got = renderer.make_density_fn(renderer.kernel_params(tree, opts)["coarse"], opts)(
        torch.from_numpy(pts))
    assert want.max() > 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_one_train_step_matches_jax(monkeypatch):
    """Loss, every gradient and the state after one Adam step, from the
    committed epoch-79 state."""
    n = 48
    cfg, jcfg = make_cfg(HASH_CFG, F32), jax_make_cfg(HASH_CFG, F32)
    (jst, epoch, _), tx, jopts = _jax_hash_state(jcfg)
    (pst, pepoch, _), opts = _hash_state(cfg)
    assert epoch == pepoch == 79 and int(jst.step) == pst.step == 40000
    o, d, tgt = _rays(n, 8)
    z_fine = np.sort(np.random.default_rng(9).uniform(2.0, 6.0, (n, 128)), -1).astype(np.float32)
    monkeypatch.setattr(jrend, "sample_pdf", lambda *a, **k: jnp.asarray(z_fine))
    monkeypatch.setattr(renderer, "sample_pdf", lambda *a, **k: torch.from_numpy(z_fine))
    seen = _spy_scatter(monkeypatch)

    (jloss, _), jgrads = jax.value_and_grad(jstate.nerf_loss, has_aux=True)(
        jst.params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tgt), jax.random.PRNGKey(0),
        jopts, None)
    loss, _, grads = tstate.loss_and_grads(pst.params, torch.from_numpy(o), torch.from_numpy(d),
                                           torch.from_numpy(tgt), opts, None)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jleaves) == 34 and len(seen) == 2
    coarse, fine = sorted(seen, key=lambda c: c[1].shape[0])  # 64 and 192 samples a ray
    tables = {16: coarse, 33: fine}
    for i, (g, jg) in enumerate(zip(grads, jleaves)):
        if i in tables:
            idx, cot, n_rows = tables[i]
            want = np.asarray(jg.astype(jnp.float32)).reshape(n_rows, -1)
            bound, _ = _accum_bound(idx, cot, n_rows, want)
            err = g.float().reshape(n_rows, -1).double() - torch.from_numpy(want.copy()).double()
            assert g.dtype == torch.bfloat16 and bool((err.abs() <= bound).all()), i
            continue
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=2e-4 * np.abs(jg).max() + 1e-9,
                                   err_msg=f"grad leaf {i}")

    lr = optim.make_optimizer(cfg).lr(pst.opt_state)
    updates, jopt = tx.update(jgrads, jst.opt_state, jst.params)
    jparams = optax.apply_updates(jst.params, updates)
    optim.make_optimizer(cfg).step(tree_leaves(pst.params), grads, pst.opt_state)
    port_opt, jopt_leaves = pst.opt_state.leaves(), jax.tree_util.tree_leaves(jopt)
    assert len(port_opt) == len(jopt_leaves) == 70 and port_opt[0] == int(jopt_leaves[0])
    n = len(grads)
    port_leaves = tree_leaves(pst.params) + port_opt[1:-1]
    jax_leaves = jax.tree_util.tree_leaves(jparams) + jopt_leaves[1:-1]
    for j, (a, b) in enumerate(zip(port_leaves, jax_leaves)):
        what, i = ("param", j) if j < n else ("moment", j - n)
        a = a.detach()
        if a.dtype == torch.bfloat16:
            same_grad = grads[i % n].float().numpy() == np.asarray(jleaves[i % n].astype(
                jnp.float32))
            _assert_bf16_step(a, b, same_grad, 2.1 * lr if what == "param" else None,
                              f"{what} {i}")
        elif what == "param":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6,
                                       err_msg=f"{what} {i}")
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-4 * np.abs(np.asarray(b)).max(),
                                       err_msg=f"{what} {i}")


def _flush(x: np.ndarray) -> np.ndarray:
    """Subnormal values to zero, as XLA on the CPU flushes them."""
    return np.where(np.abs(x) < np.finfo(np.float32).tiny, np.float32(0), x)


def _assert_bf16_step(a: torch.Tensor, b, same_grad: np.ndarray, max_step, what: str):
    """A bf16 leaf after Adam: identical wherever the two gradients are
    identical (subnormals flushed); elsewhere within 1e-2 in relative norm
    and, for a parameter, within ``max_step`` (two Adam steps of lr)."""
    a, b = (_flush(x) for x in (a.float().numpy(), np.asarray(b.astype(jnp.float32))))
    np.testing.assert_array_equal(a[same_grad], b[same_grad], err_msg=what)
    assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b), what
    if max_step is not None:
        assert np.abs(a - b).max() <= max_step, what


def test_bf16_adam_step_matches_optax():
    """One clipped Adam step on a bf16 leaf (moments in bf16) from a state
    after 4 steps, against optax's chain as the JAX package builds it: exact."""
    over = ["ep_iter", "10"]
    jtx = joptim.make_optimizer(jax_make_cfg(HASH_CFG, over))
    tx = optim.make_optimizer(make_cfg(HASH_CFG, over))
    rng = np.random.default_rng(10)
    p = rng.uniform(-1e-2, 1e-2, (64, 33)).astype(np.float32)
    jp = jnp.asarray(p, jnp.bfloat16)
    tp = [torch.from_numpy(np.asarray(jp.astype(jnp.float32))).to(torch.bfloat16)]
    jst, st = jtx.init(jp), tx.init(tp)
    assert st.mu[0].dtype == torch.bfloat16
    for step in range(5):
        g = (rng.normal(size=p.shape) * (60.0 if step == 3 else 1e-3)).astype(np.float32)
        jg = jnp.asarray(g, jnp.bfloat16)
        upd, jst = jtx.update(jg, jst, jp)
        jp = optax.apply_updates(jp, upd)
        tx.step(tp, [torch.from_numpy(np.asarray(jg.astype(jnp.float32))).to(torch.bfloat16)],
                st)
        assert jp.dtype == jnp.bfloat16 and tp[0].dtype == torch.bfloat16
        np.testing.assert_array_equal(tp[0].float().numpy(), np.asarray(jp.astype(jnp.float32)),
                                      err_msg=f"step {step}")
    jleaves = jax.tree_util.tree_leaves(jst)
    for a, b in zip(st.leaves()[1:-1], jleaves[1:-1]):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b.astype(jnp.float32)))


def test_committed_hash_checkpoint_round_trips_exactly(tmp_path):
    (state, epoch, rec), _ = _hash_state(make_cfg(HASH_CFG))
    table = state.params["coarse"]["xyz_encoder"]["table"]
    assert table.dtype == torch.bfloat16 and state.opt_state.mu[16].dtype == torch.bfloat16
    checkpoint.save_checkpoint(str(tmp_path), state, epoch, rec)
    with np.load(os.path.join(HASH, "latest.npz")) as a, np.load(tmp_path / "latest.npz") as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) == 105
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_hash_checkpoints_load_across_frameworks(tmp_path):
    """A port checkpoint of a small hash-grid state loads in nerf_tpu, and
    nerf_tpu's loads back in the port, bf16 leaves bit for bit."""
    cfg, jcfg = make_cfg(HASH_CFG, SMALL), jax_make_cfg(HASH_CFG, SMALL)
    opts = renderer.RenderOptions.from_cfg(cfg)
    tx = optim.make_optimizer(cfg)
    state = tstate.init_state(loop.init_nerf_params(torch.Generator().manual_seed(3), opts), tx)
    assert state.params["fine"]["xyz_encoder"]["table"].shape == (2, 128, 16)
    np.testing.assert_array_equal(state.params["coarse"]["alpha_linear"]["b"].detach().numpy(),
                                  np.float32([0.1]))
    rng = np.random.default_rng(11)
    with torch.no_grad():
        for m in state.opt_state.mu + state.opt_state.nu:
            m.copy_(torch.from_numpy(rng.normal(size=tuple(m.shape)).astype(np.float32)))
    state.step, state.opt_state.count, state.opt_state.sched_count = 7, 8, 9
    checkpoint.save_checkpoint(str(tmp_path / "port"), state, 3, {"step": 7, "epoch": 3})
    (jst, epoch, _), _, _ = _jax_hash_state(jcfg, str(tmp_path / "port"))
    assert epoch == 3 and int(jst.step) == 7
    port_leaves = checkpoint._state_leaves(state)
    jleaves = jax.tree_util.tree_leaves(jst)
    assert len(port_leaves) == len(jleaves) == 105
    for a, b in zip(port_leaves, jleaves):
        if isinstance(a, torch.Tensor):
            b = np.asarray(b)
            if a.dtype == torch.bfloat16:
                assert b.dtype == jnp.bfloat16
                np.testing.assert_array_equal(a.detach().view(torch.int16).numpy(),
                                              b.view(np.int16))
            else:
                np.testing.assert_array_equal(a.detach().numpy(), b)
        else:
            assert a == int(b)
    jckpt.save_checkpoint(str(tmp_path / "jax"), jst._replace(step=jnp.int32(11)), 5, {})
    back, epoch, _ = checkpoint.load_checkpoint(str(tmp_path / "jax"), state)
    assert epoch == 5 and back.step == 11
    for a, b in zip(checkpoint._state_leaves(back)[:-1], port_leaves[:-1]):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.detach().float().numpy(), b.detach().float().numpy())
        else:
            assert a == b


def test_init_hash_params_shapes_and_bounds():
    opts = renderer.RenderOptions.from_cfg(make_cfg(HASH_CFG))
    params = loop.init_nerf_params(torch.Generator().manual_seed(0), opts)
    jparams = jax_init_params(jax.random.PRNGKey(0), jrend.RenderOptions.from_cfg(
        jax_make_cfg(HASH_CFG)))
    for a, b in zip(tree_leaves(params), jax.tree_util.tree_leaves(jparams)):
        assert tuple(a.shape) == b.shape and a.requires_grad
        assert (a.dtype == torch.bfloat16) == (b.dtype == jnp.bfloat16)
    table = params["coarse"]["xyz_encoder"]["table"].detach().float()
    assert float(table.abs().max()) <= 1e-4 * (1 + 2.0 ** -8) and float(table.std()) > 4e-5
    assert float(params["fine"]["alpha_linear"]["b"].detach()) == pytest.approx(0.1)


def test_serve_and_train_the_hash_model_on_the_cpu(tmp_path):
    """The entry points at a tiny size: two epochs of the trainer on a 16x16
    synthetic scene (with an ESS rebuild through the hash density), then
    RenderService serves the checkpoint it wrote."""
    from nerf_tpu_torch.train.__main__ import main as train_main

    opts = [*SMALL, "train_dataset_module", "synthetic", "train_dataset.H", "16",
            "train_dataset.W", "16", "train_dataset.n_images", "4", "task_arg.N_rays", "32",
            "ep_iter", "3", "train.epoch", "2", "occupancy_grid_resolution", "8",
            "grid_rebuild_ep", "1", "trained_model_dir", str(tmp_path / "model"),
            "record_dir", str(tmp_path / "record")]
    state, grid = train_main(["--cfg_file", HASH_CFG, "--device", "cpu", *opts])
    assert state.step == 6 and grid is not None
    with np.load(tmp_path / "model" / "latest.npz") as data:
        assert len(data.files) == 105 and data["leaf_16"].dtype.kind == "V"
    service = RenderService(make_cfg(HASH_CFG, opts), size=12, device="cpu")
    assert service.opts.hashgrid and service.grid.occupied.shape == (8, 8, 8)
    rgb = service.render(0.5, 0.3, 4.0)
    assert rgb.shape == (12, 12, 3) and bool(torch.isfinite(rgb).all())
    assert isinstance(service.grid, occ.OccupancyGrid)
