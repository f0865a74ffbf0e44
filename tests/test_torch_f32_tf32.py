"""B2-f32's weight gradients on the tensor cores (3xTF32), on the CPU.

The kernel (csrc/fused_mlp_bwd_f32.cu, dw_tf32_wgmma_kernel) runs on the card
only (tests/test_torch_cuda.py); here its arithmetic and its work units:
- ``tf32_split``: hi is x rounded to TF32 (10 mantissa bits, to nearest, ties
  away from zero: ``cvt.rna.tf32.f32``), lo is x - hi rounded the same way;
  hi + lo lies within 2^-21 |x| of x (x - hi is exact in float32 and at most
  half of hi's last place, 2^-11 |x|; rounding it to 11 significant bits
  errs by at most 2^-11 of that, and 2^-21 leaves 2x), checked against an
  independent float64 rounding: exact;
- the 3xTF32 weight gradients and the bias sums (``fused_nerf_bwd_plain``
  with ``tf32=True``) on the committed lego checkpoint's float32 weights
  against nerf_tpu's float32 ``fused_nerf_bwd`` (Pallas, interpret mode), per
  leaf within B2-f32's unchanged bound 2e-4 max|want| + 1e-6: the products
  drop only hi lo's and lo lo's low parts (about 2^-21 of each term, far
  inside the bound), and the float32 sums of 640 terms in another order move
  a leaf by about sqrt(640) 2^-24 of its terms' magnitudes. The knife-edge
  points' cotangents are zeroed on both sides (``knife_edge_points``; two
  correct float32 forwards may decide such a ReLU unit either way);
- the unit table (``dw_units``) covers every entry of the gradient buffer
  (weights in wbuf order, then the biases) exactly once, with the biases
  folded into the weight units and apart; each unit fits the kernel's stage
  and its layout offsets are the gradient layout's: exact.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.ops import fused_mlp as jax_fused
from nerf_tpu.ops import fused_mlp_bwd as jax_bwd

from nerf_tpu_torch.ops import fused_mlp, fused_mlp_bwd as fb
from nerf_tpu_torch.train.checkpoint import load_params

LEGO = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "nerf", "lego", "nerf")
N = 640
LEAF_REL, LEAF_ABS = 2e-4, 1e-6


def _rna_f64(x: np.ndarray) -> np.ndarray:
    """x (float32) rounded to 11 significant bits, to nearest, ties away from
    zero, computed in float64 from frexp: an independent model of cvt.rna."""
    m, e = np.frexp(x.astype(np.float64))  # x = m 2^e, 0.5 <= |m| < 1
    scaled = np.abs(m) * 2.0 ** 11
    r = np.floor(scaled + 0.5)  # halves go up in magnitude: away from zero
    return (np.sign(m) * r * 2.0 ** (e - 11)).astype(np.float32)


def _samples():
    rng = np.random.default_rng(0)
    x = rng.normal(size=20_000).astype(np.float32) * np.float32(10.0) ** rng.integers(
        -20, 20, 20_000).astype(np.float32)
    # exact ties: 12 significant bits whose last is set
    ties = ((rng.integers(2048, 4096, 2000) * 2 + 1).astype(np.float32) * np.float32(2.0 ** -13))
    return np.concatenate([x, ties, -ties, [0.0, 1.0, -1.0]]).astype(np.float32)


def test_tf32_split_is_exact_to_its_bound():
    x = _samples()
    hi, lo = (t.numpy() for t in fb.tf32_split(torch.from_numpy(x)))
    for part in (hi, lo):
        assert not (part.view(np.uint32) & 0x1FFF).any()  # <= 10 mantissa bits
    np.testing.assert_array_equal(hi, _rna_f64(x))
    np.testing.assert_array_equal(lo, _rna_f64((x - hi).astype(np.float32)))
    x64 = x.astype(np.float64)
    assert (np.abs(hi.astype(np.float64) + lo - x64) <= 2.0 ** -21 * np.abs(x64)).all()
    assert (np.abs(lo.astype(np.float64)) <= 2.0 ** -11 * np.abs(x64)).all()


def test_dw_3xtf32_plain_against_float64():
    """One product of the model against float64: within 2^-20 sum |x g| per
    entry (each term is exact to ~2^-21 of |x g|; float64 sums)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(300, 7)).astype(np.float32)
    g = rng.normal(size=(300, 5)).astype(np.float32)
    got = fb.dw_3xtf32_plain(torch.from_numpy(x), torch.from_numpy(g)).double().numpy()
    want = x.astype(np.float64).T @ g.astype(np.float64)
    bound = 2.0 ** -20 * (np.abs(x).astype(np.float64).T @ np.abs(g).astype(np.float64))
    assert (np.abs(got - want) <= bound).all()


@pytest.fixture(scope="module")
def lego_case():
    """The 3xTF32 plain backward and the Pallas backward (interpret mode) on
    the committed lego fine model's float32 weights and a seeded batch."""
    tree = jax.tree_util.tree_map(np.asarray, load_params(LEGO)["fine"])
    kp = fused_mlp.repack_params(tree, weight_dtype=torch.float32)
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    g = rng.normal(size=(N, 4)).astype(np.float32)
    edge = fb.knife_edge_points(kp, torch.from_numpy(pts), torch.from_numpy(d)).numpy()
    g[edge] = 0
    jkp = jax_fused.repack_params(jax.tree_util.tree_map(jnp.asarray, tree),
                                  weight_dtype=jnp.float32)
    want = jax_bwd.fused_nerf_bwd(jkp, jnp.asarray(pts), jnp.asarray(d), jnp.asarray(g),
                                  interpret=True)[0]
    got = fb.fused_nerf_bwd_plain(kp, *(torch.from_numpy(a) for a in (pts, d, g)),
                                  input_grads=False, tf32=True)[0]
    return got, want, int(edge.sum())


@pytest.mark.parametrize("key", fb._GRAD_KEYS)
def test_3xtf32_backward_matches_jax_float32(lego_case, key):
    got, want, masked = lego_case
    assert masked < N // 10
    w = np.asarray(want[key], np.float64)
    err = np.abs(got[key].double().numpy() - w).max()
    assert err <= LEAF_REL * np.abs(w).max() + LEAF_ABS, (key, err, np.abs(w).max())


@pytest.mark.parametrize("fold_bias", [True, False])
def test_dw_units_cover_every_gradient_once(fold_bias):
    units = fb.dw_units(fold_bias)
    entries = fb.dw_unit_entries(units)
    pst = fused_mlp.WBUF_SIZE + fused_mlp.BBUF_SIZE
    np.testing.assert_array_equal(np.sort(entries), np.arange(pst))
    assert units.shape == (41 if fold_bias else 60, len(fb.DW_UNIT_FIELDS))
    for row in units:
        u = dict(zip(fb.DW_UNIT_FIELDS, (int(v) for v in row)))
        # a stage's lines fit its 384-line slot, in whole TMA boxes; the
        # split lines are the products' B operand; the stash columns exist
        assert u["xlines"] % 32 == 0 and u["glines"] % 32 == 0
        assert u["xlines"] + u["glines"] + u["nsplit"] <= 384
        assert u["xcol"] + u["xlines"] <= 2528
        if u["kind"] in (fb.DW_PRODUCTS, fb.DW_KSPLIT):
            assert u["nsplit"] == 128 and u["nsplit"] <= u["glines"]
            for w in ((0,) if u["kind"] == fb.DW_KSPLIT else (0, 1)):
                if u[f"x{w}"] >= 0:
                    assert u[f"x{w}"] + u["rows"] <= u["xlines"]
                    assert u[f"g{w}"] + 128 <= u["nsplit"]
    # the folded table: the product units, then the two small units on the
    # CUDA cores (the kernel launches the units in table order)
    if fold_bias:
        assert set(units[:39, 0].tolist()) == {fb.DW_PRODUCTS, fb.DW_KSPLIT}
        assert units[39:, 0].tolist() == [fb.DW_VIEW_RGB, fb.DW_HEADS]


def test_dw_unit_offsets_are_the_gradient_layout():
    """The table's output offsets name the same entries as the flat
    gradient's layout (``_grad_layout``), leaf by leaf."""
    kp = fused_mlp.repack_params(load_params(LEGO)["fine"], weight_dtype=torch.float32)
    layout = {k: off for k, off, _, _ in fb._grad_layout(kp)}
    wb = fused_mlp.WBUF_SIZE
    assert (fb._OFF_L5, fb._OFF_LF, fb._OFF_LV, fb._OFF_WA, fb._OFF_WR) == (
        layout["w5x"], layout["wf"], layout["wvf"], layout["wa"], layout["wr"])
    assert [fb._off_layer(i) for i in (1, 2, 3, 4, 6, 7)] == [
        layout[f"w{i}"] for i in (1, 2, 3, 4, 6, 7)]
    assert (wb + fb._OFF_BF, wb + fb._OFF_BV, wb + fb._OFF_BA) == (
        layout["bf"], layout["bv"], layout["ba"])
    assert layout["w5h"] == fb._OFF_L5 + fb._EX * fb._W
    assert layout["wvx"] == fb._OFF_LV + fb._W * fb._VW
    # the stash columns are the float32 stash's (tools/f32_check.py)
    from nerf_tpu_torch.tools.f32_check import STASH_COLS
    assert [fb._s_h(i) for i in range(1, 9)] == [STASH_COLS[f"h{i}"] for i in range(1, 9)]
    assert (fb._S_FEAT, fb._S_V) == (STASH_COLS["feat"], STASH_COLS["v"])
