"""nerf_tpu_torch's fused-MLP backward (plain version, layout, autograd) against nerf_tpu.

The JAX side runs as tests/test_fused_bwd.py runs it on the CPU: the Pallas
backward in interpret mode, and jax.grad of the XLA reference. Inputs come
from numpy seeds, the weights from nerf_tpu's init_nerf_mlp(PRNGKey(5)), as
in tests/test_fused_bwd.py. 640 points cross the Pallas kernel's 512-point
tile.

Tolerances:
- float32 weights: per gradient leaf 2e-4 * max|want| + 1e-6, and 1e-3 for
  dpts/ddirs, as tests/test_fused_bwd.py (sums of 640 products in another
  order). A ReLU unit whose pre-activation lies within float32 rounding of
  zero can be decided either way by two correct float32 forwards (XLA's
  CPU dot and sin/cos against torch's), and one flipped unit moves a whole
  leaf by far more than 2e-4 of its largest value. So the float32 case
  zeroes the cotangent of every point that has such a unit, on both sides
  alike, decided from float64 margins (``_knife_edge_points``) and never
  from either float32 forward: a point with zero cotangent adds nothing to
  any weight gradient and gets zero dpts/ddirs, so its masks no longer
  matter. Every other point is compared at the tolerance above.
- bfloat16 weights: the port rounds each layer's gradient G to bf16 before
  its two products (the tensor cores take bf16), where the Pallas kernel
  keeps G and the activations in float32. One rounding of G is 2^-9
  relative per element and it compounds over the 10 layers below the
  heads, so the bound is 3e-2 * max|want| + 1e-6 per leaf and 3e-2 of the
  largest |dpts|, |ddirs|.
- kgrads_to_param_grads only permutes and concatenates: exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.models.nerf_mlp import init_nerf_mlp
from nerf_tpu.ops import fused_mlp as jax_fused
from nerf_tpu.ops import fused_mlp_bwd as jax_bwd
from nerf_tpu.render.renderer import RenderOptions as JaxRenderOptions

from nerf_tpu_torch.ops import fused_mlp, fused_mlp_bwd
from nerf_tpu_torch.tree import tree_flatten, tree_map

# Rounding margin of a ReLU pre-activation z = sum_i w_i h_i + b in float32:
# KNIFE_EDGE_C * 2^-24 * (sum_i |w_i h_i| + |b|). A blocked float32 dot
# product of K <= 319 terms (layer 5) errs by about sqrt(K) * 2^-24 of that
# sum (<= 18 units; K * 2^-24 at worst), and the inputs carry in their own
# rounding from up to eight layers below and from sin/cos of the exact
# float32 phases (a few units each, of the same magnitudes). 64 is well
# above the typical total and zeroes 28 of the 640 points of _inputs(640, 7)
# (the worst case, C = K, would zero 98).
KNIFE_EDGE_C = 64.0
MAX_ZEROED_SHARE = 0.10
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": (2e-4, 1e-3), "bfloat16": (3e-2, 3e-2)}
N = 640


@pytest.fixture(scope="module")
def lego():
    """The lego MLP's shapes with tests/test_fused_bwd.py's random weights."""
    params = init_nerf_mlp(jax.random.PRNGKey(5), input_ch=63, input_ch_views=27)
    return jax.tree_util.tree_map(np.asarray, params)


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    g = rng.normal(size=(n, 4)).astype(np.float32)
    return pts, d, g


def _relu_margins(kp, pts, dirs):
    """[(layer, z, s)] for every ReLU layer of the plain forward (pts
    layers 0-7 and the view layer "v"), in float64 from the float32 weights
    ``kp`` and the float32 phases: z the pre-activations [P, units], s the
    sums of |w_i h_i| + |b|."""
    f64 = torch.float64
    w = {k: v.to(f64) for k, v in kp.items()}
    x, dd = (torch.from_numpy(a).to(f64) for a in (pts, dirs))
    a = fused_mlp._phases(torch.from_numpy(pts), kp["sx"]).to(f64)
    b = fused_mlp._phases(torch.from_numpy(dirs), kp["sd"]).to(f64)

    def lin(terms, bias):
        z = sum(h @ w[k] for h, k in terms) + w[bias]
        s = sum(h.abs() @ w[k].abs() for h, k in terms) + w[bias].abs()
        return z, s

    enc = [(x, "w0x"), (a.sin(), "w0s"), (a.cos(), "w0c")]
    out = [(0, *lin(enc, "b0"))]
    for i in (1, 2, 3, 4):
        out.append((i, *lin([(out[-1][1].clamp_min(0), f"w{i}")], f"b{i}")))
    enc5 = [(h, k.replace("0", "5")) for h, k in enc]
    out.append((5, *lin(enc5 + [(out[-1][1].clamp_min(0), "w5h")], "b5")))
    for i in (6, 7):
        out.append((i, *lin([(out[-1][1].clamp_min(0), f"w{i}")], f"b{i}")))
    feat = out[-1][1].clamp_min(0) @ w["wf"] + w["bf"]
    view = [(feat, "wvf"), (dd, "wvx"), (b.sin(), "wvs"), (b.cos(), "wvc")]
    out.append(("v", *lin(view, "bv")))
    return out


def _knife_edge_points(kp, pts, dirs, c=KNIFE_EDGE_C):
    """bool [P]: points with a ReLU unit within c * 2^-24 * s of zero."""
    hit = torch.zeros(pts.shape[0], dtype=torch.bool)
    for _, z, s in _relu_margins(kp, pts, dirs):
        hit |= (z.abs() < c * 2.0 ** -24 * s).any(dim=1)
    return hit.numpy()


def _assert_grads(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale + 1e-6, err_msg=what)


@pytest.fixture(scope="module", params=list(DTYPES))
def pallas_case(request, lego):
    """The Pallas backward (interpret mode) and the port's plain version on one input."""
    dtype = request.param
    tdt, jdt = DTYPES[dtype]
    pts, d, g = _inputs(N, 7)
    if dtype == "float32":
        g[_knife_edge_points(fused_mlp.repack_params(lego, weight_dtype=torch.float32), pts, d)] = 0
    jkp = jax_fused.repack_params(jax.tree_util.tree_map(jnp.asarray, lego), weight_dtype=jdt)
    want = jax_bwd.fused_nerf_bwd(jkp, jnp.asarray(pts), jnp.asarray(d), jnp.asarray(g),
                                  interpret=True)
    kp = fused_mlp.repack_params(lego, weight_dtype=tdt)
    got = fused_mlp_bwd.fused_nerf_bwd_plain(kp, *(torch.from_numpy(a) for a in (pts, d, g)))
    return dtype, got, want


@pytest.mark.parametrize("key", fused_mlp_bwd._GRAD_KEYS)
def test_plain_backward_matches_pallas_interpret(pallas_case, key):
    dtype, got, want = pallas_case
    _assert_grads(got[0][key].numpy(), want[0][key], TOL[dtype][0], f"{dtype} {key}")


def test_plain_input_grads_match_pallas_interpret(pallas_case):
    dtype, got, want = pallas_case
    tol = TOL[dtype][1]
    for i, name in ((1, "dpts"), (2, "ddirs")):
        w = np.asarray(want[i])
        atol = tol if dtype == "float32" else tol * np.abs(w).max()
        np.testing.assert_allclose(got[i].numpy(), w, rtol=0, atol=atol, err_msg=f"{dtype} {name}")


def test_float32_knife_edge_units(lego):
    """The float32 ReLU units of _inputs(640, 7) within rounding of zero.
    Prints every unit within the typical bound sqrt(K) * 2^-24 * s (point,
    layer, unit, pre-activation, bound) and the counts of points at other
    margins; every such unit's point is among those the comparison zeroes,
    and the zeroed points stay under 10% of the 640."""
    kp = fused_mlp.repack_params(lego, weight_dtype=torch.float32)
    pts, d, _ = _inputs(N, 7)
    fan_in = {0: 63, 5: 319, "v": 283}
    typical = set()
    for layer, z, s in _relu_margins(kp, pts, d):
        bound = fan_in.get(layer, 256) ** 0.5 * 2.0 ** -24 * s
        for p, unit in torch.nonzero(z.abs() < bound).tolist():
            typical.add(p)
            print(f"point {p} layer {layer} unit {unit}: pre-activation "
                  f"{float(z[p, unit]):+.3e}, bound {float(bound[p, unit]):.3e}")
    counts = {c: int(_knife_edge_points(kp, pts, d, c).sum()) for c in (16, 32, 64)}
    zeroed = _knife_edge_points(kp, pts, d)
    print(f"points within c * 2^-24 * s: {counts}; zeroed (c = {KNIFE_EDGE_C:g}): "
          f"{int(zeroed.sum())} of {N}")
    assert typical and typical <= set(np.nonzero(zeroed)[0].tolist())
    assert counts[16] <= counts[32] <= counts[64] == int(zeroed.sum())
    assert zeroed.sum() < MAX_ZEROED_SHARE * N


def test_grad_keys_are_the_pallas_kernels():
    assert fused_mlp_bwd._GRAD_KEYS == jax_bwd._GRAD_KEYS


def test_kgrads_to_param_grads_equals_jax_exactly(lego):
    kp = fused_mlp.repack_params(lego, weight_dtype=torch.float32)
    rng = np.random.default_rng(3)
    kgrads = {k: rng.normal(size=tuple(kp[k].shape)).astype(np.float32)
              for k in fused_mlp_bwd._GRAD_KEYS}
    want = jax_bwd.kgrads_to_param_grads({k: jnp.asarray(v) for k, v in kgrads.items()},
                                         jax.tree_util.tree_map(jnp.asarray, lego))
    got = fused_mlp_bwd.kgrads_to_param_grads({k: torch.from_numpy(v) for k, v in kgrads.items()},
                                              tree_map(lambda a: torch.from_numpy(np.array(a)), lego))
    got_leaves, got_spec = tree_flatten(got)
    want_leaves, _ = jax.tree_util.tree_flatten(want)
    assert got_spec == tree_flatten(lego)[1]
    assert len(got_leaves) == len(want_leaves) == 24
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_kernel_gradient_layout_inverts_the_packed_buffers(lego):
    """The CUDA path reads its gradients out of one flat buffer laid out as
    wbuf then bbuf; slicing the packed forward buffers the same way must
    give back every kernel weight (checks the offsets without a GPU)."""
    kp = fused_mlp.repack_params(lego, weight_dtype=torch.float32)
    flat = torch.cat([kp["wbuf"], kp["bbuf"]])
    assert flat.numel() == fused_mlp.WBUF_SIZE + fused_mlp.BBUF_SIZE
    layout = fused_mlp_bwd._grad_layout(kp)
    assert sorted(k for k, *_ in layout) == sorted(fused_mlp_bwd._GRAD_KEYS)
    for k, off, r, c in layout:
        torch.testing.assert_close(flat[off: off + r * c].view(r, c), kp[k], rtol=0, atol=0,
                                   msg=k)


def test_wrapper_takes_the_plain_version_on_the_cpu(lego):
    kp = fused_mlp.repack_params(lego)
    pts, d, g = (torch.from_numpy(a) for a in _inputs(70, 1))
    got = fused_mlp_bwd.fused_nerf_bwd(kp, pts, d, g)
    want = fused_mlp_bwd.fused_nerf_bwd_plain(kp, pts, d, g)
    for k in fused_mlp_bwd._GRAD_KEYS:
        torch.testing.assert_close(got[0][k], want[0][k], rtol=0, atol=0)
    no_inputs = fused_mlp_bwd.fused_nerf_bwd(kp, pts, d, g, input_grads=False)
    assert no_inputs[1] is None and no_inputs[2] is None


def test_plain_float64_sums_stay_near_float32_sums(lego):
    """Two summation orders of the same bf16 backward: the spread the GPU
    check measures on the card, here on 640 points (bound 3e-2 of the max)."""
    kp = fused_mlp.repack_params(lego)
    pts, d, g = (torch.from_numpy(a) for a in _inputs(N, 2))
    a = fused_mlp_bwd.fused_nerf_bwd_plain(kp, pts, d, g)
    b = fused_mlp_bwd.fused_nerf_bwd_plain(kp, pts, d, g, accumulate=torch.float64)
    for k in fused_mlp_bwd._GRAD_KEYS:
        _assert_grads(a[0][k].numpy(), b[0][k].numpy(), 3e-2, k)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_autograd_function_matches_jax_grad(lego, dtype):
    """fused_nerf_eval_diff's gradients against jax.grad of the XLA reference
    (nerf_tpu's own recompute oracle), for the params, pts and dirs."""
    tdt, _ = DTYPES[dtype]
    pts, d, g = _inputs(N, 11)
    opts = JaxRenderOptions(compute_dtype=dtype)

    def loss(p, x, dd):
        return jnp.sum(jax_fused._xla_reference(p, x, dd, opts) * jnp.asarray(g))

    want_p, want_x, want_d = jax.grad(loss, argnums=(0, 1, 2))(
        jax.tree_util.tree_map(jnp.asarray, lego), jnp.asarray(pts), jnp.asarray(d))
    params = tree_map(lambda a: torch.tensor(np.array(a), requires_grad=True), lego)
    tp, td = (torch.tensor(a, requires_grad=True) for a in (pts, d))
    raw = fused_mlp.fused_nerf_eval_diff(params, tp, td, weight_dtype=tdt)
    (raw * torch.from_numpy(g)).sum().backward()
    tol, itol = TOL[dtype]
    got_leaves, _ = tree_flatten(params)
    for (path, w), p in zip(jax.tree_util.tree_flatten_with_path(want_p)[0], got_leaves):
        _assert_grads(p.grad.numpy(), w, tol, f"{dtype} {jax.tree_util.keystr(path)}")
    for got, want, name in ((tp.grad, want_x, "dpts"), (td.grad, want_d, "ddirs")):
        w = np.asarray(want)
        atol = itol if dtype == "float32" else itol * np.abs(w).max()
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=atol, err_msg=name)
