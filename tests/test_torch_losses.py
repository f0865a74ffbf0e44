"""nerf_tpu_torch's loss library against nerf_tpu's on the CPU.

Each loss gets the same float32 inputs, made with numpy from a seed, in both
packages; the results agree to 1e-6 relative (float32 sums of at most a few
hundred terms, in other orders), plus 1e-7 absolute for results near 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.train import losses as JL

from nerf_tpu_torch.train import losses as L


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.ascontiguousarray(a))
                                              for a in arrays]


def _close(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def _rng(seed):
    return np.random.default_rng(seed)


def test_clamped_sigmoid():
    x = (_rng(0).normal(size=(200,)) * 12).astype(np.float32)
    (jx,), (tx,) = _both(x)
    _close(L.clamped_sigmoid(tx), JL.clamped_sigmoid(jx))


@pytest.mark.parametrize("positives", [True, False])
def test_focal_loss(positives):
    rng = _rng(1)
    pred = np.clip(rng.uniform(size=(2, 3, 8, 8)), 1e-4, 1 - 1e-4).astype(np.float32)
    gt = (rng.uniform(size=pred.shape) ** 3).astype(np.float32)
    if positives:
        gt[rng.uniform(size=gt.shape) > 0.9] = 1.0
    (jp, jg), (tp, tg) = _both(pred, gt)
    _close(L.focal_loss(tp, tg), JL.focal_loss(jp, jg))


@pytest.mark.parametrize("normalize,reduce,sigma", [(True, True, 1.0), (True, False, 1.5),
                                                     (False, True, 0.7), (False, False, 1.0)])
def test_smooth_l1_loss(normalize, reduce, sigma):
    rng = _rng(2)
    pred = (rng.normal(size=(3, 4, 5, 6)) * 2).astype(np.float32)
    target = rng.normal(size=pred.shape).astype(np.float32)
    w = (rng.uniform(size=(3, 1, 5, 6)) > 0.3).astype(np.float32)
    (a, b, c), (x, y, z) = _both(pred, target, w)
    _close(L.smooth_l1_loss(x, y, z, sigma, normalize, reduce),
           JL.smooth_l1_loss(a, b, c, sigma, normalize, reduce))


def test_ae_loss():
    rng = _rng(3)
    ae = rng.normal(size=(2, 1, 6, 7)).astype(np.float32)
    ind = rng.integers(0, 42, (2, 4, 3)).astype(np.int32)
    mask = (rng.uniform(size=(2, 4, 3)) > 0.3).astype(np.float32)
    mask[1, 2] = 0.0  # an object with no part
    (a, b, c), (x, y, z) = _both(ae, ind, mask)
    _close(L.ae_loss(x, y, z), JL.ae_loss(a, b, c))


@pytest.mark.parametrize("loss_type", ["L2", "L1"])
def test_poly_matching_loss(loss_type):
    rng = _rng(4)
    pred = rng.uniform(size=(3, 12, 2)).astype(np.float32)
    gt = np.roll(pred, 5, axis=1) + rng.normal(0, 0.05, pred.shape).astype(np.float32)
    (a, b), (x, y) = _both(pred, gt)
    _close(L.poly_matching_loss(x, y, loss_type), JL.poly_matching_loss(a, b, loss_type))


def test_poly_matching_loss_rejects_an_unknown_type():
    with pytest.raises(ValueError, match="unknown loss_type"):
        L.poly_matching_loss(torch.zeros(1, 3, 2), torch.zeros(1, 3, 2), "L3")


def test_attention_loss():
    rng = _rng(5)
    pred = np.clip(rng.uniform(size=(2, 1, 9, 9)), 1e-3, 1 - 1e-3).astype(np.float32)
    gt = (rng.uniform(size=pred.shape) > 0.7).astype(np.float32)
    (a, b), (x, y) = _both(pred, gt)
    _close(L.attention_loss(x, y, 3.0, 0.7), JL.attention_loss(a, b, 3.0, 0.7))


def test_index_gathered_l1_losses():
    rng = _rng(6)
    out = rng.normal(size=(2, 3, 5, 4)).astype(np.float32)
    ind = rng.integers(0, 20, (2, 3, 2)).astype(np.int32)
    mask = (rng.uniform(size=(2, 3, 2)) > 0.4).astype(np.float32)
    target = rng.normal(size=(2, 3, 2, 3)).astype(np.float32)
    (a, b, c, d), (x, y, z, w) = _both(out, target, ind, mask)
    _close(L.ind2d_reg_l1_loss(x, y, z, w), JL.ind2d_reg_l1_loss(a, b, c, d))
    ind1 = ind.reshape(2, 6)
    weight = rng.uniform(size=(2, 6)).astype(np.float32)
    target1 = target.reshape(2, 6, 3)
    (a, b, c, d), (x, y, z, w) = _both(out, target1, ind1, weight)
    _close(L.ind_l1_loss_1d(x, y, z, w), JL.ind_l1_loss_1d(a, b, c, d))


def test_geo_cross_entropy_loss():
    rng = _rng(7)
    b, kq = 2, 5
    poly = rng.uniform(size=(b, 4 * kq, 2)).astype(np.float32)
    target = rng.integers(0, kq, (b, 4)).astype(np.int32)
    out = rng.normal(size=(b, kq, 4)).astype(np.float32)
    (a, t, p), (x, y, z) = _both(out, target, poly)
    _close(L.geo_cross_entropy_loss(x, y, z), JL.geo_cross_entropy_loss(a, t, p))
