"""nerf_tpu_torch's hash-table row gather (B4) and its scatter-add, plain
versions, against nerf_tpu on the CPU: the Pallas gather in interpret mode
(as tests/test_hash_gather_pallas.py runs it) and XLA's scatter-add
(``jnp.zeros().at[idx].add``). The gathers are exact. The scatter-add in
float32 is within 2 n 2^-24 S of XLA's per element (two float32 sums of the
same n terms in other orders, S their summed magnitudes); in bfloat16 XLA
accumulates in bf16 and the port in float32 with one rounding, so the bound
per element is |xla - f64| + 2^-8 |f64| + 2 n 2^-24 S, f64 the same terms
summed in float64. The wrappers take their plain versions on CPU tensors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.ops.hash_gather import BLOCK_ROWS, gather_rows_pallas

from nerf_tpu_torch.ops import hash_gather

U = 2.0 ** -24


@pytest.mark.parametrize("T,W,repeat", [(4096, 16, False), (64, 8, True)])
def test_plain_gather_matches_pallas_interpret(T, W, repeat):
    rng = np.random.RandomState(0)
    table = rng.randn(T, W).astype(np.float32)
    idx = (np.arange(2 * BLOCK_ROWS) % 3 if repeat
           else rng.randint(0, T, (2 * BLOCK_ROWS,))).astype(np.int32)
    want = np.asarray(gather_rows_pallas(jnp.asarray(table), jnp.asarray(idx), interpret=True))
    got = hash_gather.gather_rows_plain(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_gather_matches_pallas_interpret_bf16():
    rng = np.random.RandomState(1)
    table = torch.from_numpy(rng.randn(1024, 16).astype(np.float32)).to(torch.bfloat16)
    idx = rng.randint(0, 1024, (BLOCK_ROWS,)).astype(np.int32)
    jt = jnp.asarray(table.float().numpy(), jnp.bfloat16)
    want = gather_rows_pallas(jt, jnp.asarray(idx), interpret=True)
    got = hash_gather.gather_rows(table, torch.from_numpy(idx))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def _scatter_inputs(seed, n_rows, n, width):
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, 8, n // 2)  # heavy duplicates, as the coarse levels have
    idx = np.concatenate([hot, rng.integers(0, n_rows, n - n // 2)]).astype(np.int32)
    rng.shuffle(idx)
    return idx, rng.normal(size=(n, width)).astype(np.float32)


def _sums(idx, cot, n_rows):
    i = torch.from_numpy(idx).long()
    c = torch.from_numpy(cot).double()
    f64 = torch.zeros((n_rows, cot.shape[1]), dtype=torch.float64).index_add_(0, i, c)
    mag = torch.zeros_like(f64).index_add_(0, i, c.abs())
    cnt = torch.zeros((n_rows, 1), dtype=torch.float64).index_add_(
        0, i, torch.ones((len(idx), 1), dtype=torch.float64))
    return f64.numpy(), mag.numpy(), cnt.numpy()


def test_plain_scatter_add_matches_xla_float32():
    idx, cot = _scatter_inputs(2, 300, 5000, 16)
    want = np.asarray(jnp.zeros((300, 16), jnp.float32).at[jnp.asarray(idx)].add(
        jnp.asarray(cot)))
    got = hash_gather.scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(cot), 300)
    assert got.dtype == torch.float32
    _, mag, cnt = _sums(idx, cot, 300)
    assert (np.abs(got.numpy() - want) <= 2 * cnt * U * mag).all()


def test_plain_scatter_add_matches_xla_bfloat16_within_the_accumulation_bound():
    idx, cot = _scatter_inputs(3, 300, 5000, 16)
    cot_bf = torch.from_numpy(cot).to(torch.bfloat16)
    want = jnp.zeros((300, 16), jnp.bfloat16).at[jnp.asarray(idx)].add(
        jnp.asarray(cot_bf.float().numpy(), jnp.bfloat16))
    want = np.asarray(want.astype(jnp.float32), np.float64)
    got = hash_gather.scatter_add_rows(torch.from_numpy(idx), cot_bf, 300)
    assert got.dtype == torch.bfloat16
    f64, mag, cnt = _sums(idx, cot_bf.float().numpy(), 300)
    dist = np.abs(want - f64)
    bound = dist + 2.0 ** -8 * np.abs(f64) + 2 * cnt * U * mag
    assert dist.max() > 2.0 ** -8 * np.abs(f64).max()  # bf16 accumulation is the larger error
    assert (np.abs(got.float().numpy() - want) <= bound).all()
    tol = hash_gather.scatter_add_tolerance(torch.from_numpy(idx), cot_bf, got)
    assert bool((tol >= 2.0 ** -7 * got.double().abs()).all())


def test_gather_autograd_scatters_the_cotangent():
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.normal(size=(50, 4)).astype(np.float32)).requires_grad_(True)
    idx = torch.from_numpy(rng.integers(0, 50, 400).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=(400, 4)).astype(np.float32))
    for plain in (False, True):
        table.grad = None
        (hash_gather.gather_rows_diff(table, idx, plain) * g).sum().backward()
        torch.testing.assert_close(table.grad, hash_gather.scatter_add_rows_plain(idx, g, 50),
                                   rtol=0, atol=0)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    before = (hash_gather.gather_rows.launches, hash_gather.scatter_add_rows.launches)
    table = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    idx = torch.tensor([5, 0, 5], dtype=torch.int32)
    assert hash_gather.gather_rows(table, idx).tolist() == [[10, 11], [0, 1], [10, 11]]
    grad = hash_gather.scatter_add_rows(idx, torch.ones((3, 2)), 6)
    assert grad[5].tolist() == [2, 2] and grad[0].tolist() == [1, 1] and float(grad.sum()) == 6
    assert (hash_gather.gather_rows.launches, hash_gather.scatter_add_rows.launches) == before
