"""nerf_tpu_torch compositing (plain integrate, composite) against nerf_tpu.

The JAX side runs as tests/test_integrate_kernel.py runs it: the Pallas
kernel in interpret mode (tile 32), and the XLA composite. Inputs come from
numpy.random.default_rng.

Tolerance: atol 2e-5 on rgb/depth/acc/weights, as tests/test_integrate_kernel.py
(float32 sums of up to 192 terms in another order); disparity, a quotient
that reaches 1e10 on empty rays, to rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.ops.integrate import integrate_pallas
from nerf_tpu.render.composite import composite as jax_composite

from nerf_tpu_torch.ops import integrate as tint
from nerf_tpu_torch.render.composite import composite, density_activation

KEYS = ("rgb_map", "depth_map", "acc_map", "weights")


def _inputs(n, s, seed, sigma_scale=1.0):
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=(n, s, 4)).astype(np.float32)
    raw[..., 3] *= sigma_scale
    z = np.sort(rng.uniform(2, 6, (n, s)).astype(np.float32), axis=-1)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return raw, z, d


def _check(got, want):
    for k in KEYS:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), atol=2e-5, err_msg=k)
    np.testing.assert_allclose(np.asarray(got["disp_map"]), np.asarray(want["disp_map"]),
                               rtol=1e-5, err_msg="disp_map")


@pytest.mark.parametrize("act", ["relu", "softplus"])
@pytest.mark.parametrize("ert", [0.0, 0.01])
@pytest.mark.parametrize("n,s", [(96, 64), (37, 192)])  # 37: padded by the Pallas tile
def test_integrate_plain_matches_pallas_interpret(act, ert, n, s):
    raw, z, d = _inputs(n, s, seed=n + s, sigma_scale=20.0)
    want = integrate_pallas(jnp.asarray(raw[..., 3]), jnp.asarray(raw[..., :3]),
                            jnp.asarray(z), jnp.asarray(d), ert_threshold=ert,
                            white_bkgd=True, tile=32, interpret=True, sigma_activation=act)
    got = tint.integrate_plain(torch.from_numpy(raw), torch.from_numpy(z),
                               torch.from_numpy(d), ert, True, act)
    _check({k: v.numpy() for k, v in got.items()}, want)


@pytest.mark.parametrize("ert", [None, 0.01])
@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_composite_matches_jax(ert, act):
    raw, z, d = _inputs(96, 64, seed=3)
    want = jax_composite(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d), white_bkgd=True,
                         ert_threshold=ert, sigma_activation=act)
    got = composite(torch.from_numpy(raw), torch.from_numpy(z), torch.from_numpy(d),
                    white_bkgd=True, ert_threshold=ert, sigma_activation=act)
    _check({k: v.numpy() for k, v in got.items()}, want)
    np.testing.assert_allclose(got["transmittance"].numpy(), np.asarray(want["transmittance"]),
                               atol=2e-5)


@pytest.mark.parametrize("ert", [0.0, 0.01])
def test_integrate_plain_matches_its_oracle_composite(ert):
    raw, z, d = (torch.from_numpy(a) for a in _inputs(64, 64, seed=4, sigma_scale=20.0))
    got = tint.integrate_plain(raw, z, d, ert, False)
    want = composite(raw, z, d, white_bkgd=False, ert_threshold=ert if ert > 0 else None)
    _check({k: v.numpy() for k, v in got.items()}, {k: v.numpy() for k, v in want.items()})


def test_composite_noise_is_seeded():
    raw, z, d = (torch.from_numpy(a) for a in _inputs(8, 16, seed=5))
    a = composite(raw, z, d, raw_noise_std=1.0, generator=torch.Generator().manual_seed(0))
    b = composite(raw, z, d, raw_noise_std=1.0, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a["rgb_map"], b["rgb_map"], rtol=0, atol=0)
    assert not torch.equal(a["rgb_map"], composite(raw, z, d)["rgb_map"])


def test_density_activation():
    x = torch.tensor([-1e4, -1.0, 0.0, 2.0])
    assert density_activation(x, "relu").tolist() == [0.0, 0.0, 0.0, 2.0]
    assert density_activation(x, "softplus")[0] == 0.0
    assert torch.equal(density_activation(x, "exp"), torch.exp(x))
    assert density_activation(x, "exp")[0] == 0.0
    with pytest.raises(ValueError):
        density_activation(x, "elu")


def test_wrapper_on_cpu_is_the_plain_version():
    raw, z, d = (torch.from_numpy(a) for a in _inputs(16, 64, seed=6))
    before = tint.integrate.launches
    got = tint.composite_kernel(raw, z, d, ert_threshold=0.01)
    want = tint.integrate_plain(raw, z, d, 0.01)
    for k in KEYS:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert tint.integrate.launches == before


def test_wrapper_is_forward_only():
    raw, z, d = (torch.from_numpy(a) for a in _inputs(4, 8, seed=7))
    with pytest.raises(RuntimeError, match="forward-only"):
        tint.integrate(raw.requires_grad_(), z, d)
