"""The orders of operations of two CUDA kernels, repeated in PyTorch, against
nerf_tpu on the CPU; and the variants tools' edits of those kernels' sources.

- The scatter-add (``csrc/hash_gather.cu``): ``hash_gather.warp_runs`` (the
  runs of equal indices among a warp's 32 rows) against the kernel's own bit
  arithmetic (a ballot of head flags, ``__clz`` for a run's first lane),
  written out here over Python integers: exact. ``scatter_add_rows_runs``
  (each run summed by a segmented scan inside the lane groups, plus the
  carry from the group before, then added at its index) against XLA's
  scatter-add (``jnp.zeros().at[idx].add``) in float32 on every index mix of
  ``tools/scatter_variants.py``: within 2 n 2^-24 S per element (two float32
  sums of the same n terms in other orders, S their summed magnitudes).
- Compositing (``csrc/integrate.cu``): the weights from
  ``integrate.lane_transmittance`` (each lane's samples summed serially,
  a 5-step warp scan of the lane sums, a carry between chunks) against the
  Pallas kernel in interpret mode (as tests/test_integrate_kernel.py runs
  it): atol 2e-5, as the kernel is held (float32 sums of up to 300 terms in
  another order); its transmittance on the same side of the ERT threshold
  as the plain version's outside ``integrate.past_the_cut``'s rounding band.
  ``lane_samples`` gives every sample to exactly one lane.
Inputs come from numpy.random.default_rng or a seeded torch.Generator.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.ops.integrate import integrate_pallas

from nerf_tpu_torch.ops import hash_gather
from nerf_tpu_torch.ops import integrate as tint
from nerf_tpu_torch.tools import integrate_variants, scatter_variants, variants

U = 2.0 ** -24


@pytest.mark.parametrize("name", list(scatter_variants.VARIANTS))
def test_scatter_variants_apply_to_the_kernel_source(name):
    """Every variant of tools/scatter_variants.py still finds the lines it
    replaces in csrc/hash_gather.cu (the tool raises when one does not)."""
    src = scatter_variants.MAIN.read_text()
    text = variants.variant_source(scatter_variants.MAIN, scatter_variants.VARIANTS, name)
    assert (text == src) == (name == "kernel")
    assert (len(text) < len(src)) == (name in ("no_memset", "no_round"))


@pytest.mark.parametrize("name", list(integrate_variants.VARIANTS))
def test_integrate_variants_apply_to_the_kernel_source(name):
    src = integrate_variants.MAIN.read_text()
    text = variants.variant_source(integrate_variants.MAIN, integrate_variants.VARIANTS, name)
    assert (text == src) == (name == "kernel")
    assert text.count("constexpr") == src.count("constexpr")


def _kernel_runs(rows):
    """The kernel's runs of one warp of 32 indices, as its bit arithmetic
    forms them: (start lane, ends its run) for each lane."""
    heads = 0
    for lane in range(32):
        prev = rows[lane - 1] if lane > 0 else rows[0]  # __shfl_up_sync keeps lane 0's own
        if lane == 0 or rows[lane] != prev:
            heads |= 1 << lane
    full = 0xFFFFFFFF
    start = [31 - (32 - (heads & (full >> (31 - lane))).bit_length()) for lane in range(32)]
    last = [lane == 31 or bool((heads >> (lane + 1)) & 1) for lane in range(32)]
    return start, last


@pytest.mark.parametrize("mix", scatter_variants.MIXES)
def test_warp_runs_match_the_kernels_bit_arithmetic(mix):
    gen = torch.Generator().manual_seed(3)
    idx = scatter_variants.index_mix(mix, 32 * 40 + 13, 50, gen)
    lane, start, last = hash_gather.warp_runs(idx)
    padded = torch.cat([idx, torch.full((-idx.shape[0] % 32,), -1, dtype=idx.dtype)])
    for w in range(padded.shape[0] // 32):
        want_start, want_last = _kernel_runs(padded[32 * w:32 * (w + 1)].tolist())
        assert lane[32 * w:32 * (w + 1)].tolist() == list(range(32))
        assert start[32 * w:32 * (w + 1)].tolist() == want_start, w
        assert last[32 * w:32 * (w + 1)].tolist() == want_last, w


@pytest.mark.parametrize("width", [16, 8, 2, 3])
@pytest.mark.parametrize("mix", scatter_variants.MIXES)
def test_scatter_runs_model_matches_xla_scatter_add(mix, width):
    n, n_rows = 4 * 1000 + 7, 300
    idx = scatter_variants.index_mix(mix, n, n_rows, torch.Generator().manual_seed(width))
    cot = np.random.default_rng(width).normal(size=(n, width)).astype(np.float32)
    got = hash_gather.scatter_add_rows_runs(idx, torch.from_numpy(cot), n_rows).numpy()
    want = np.asarray(jnp.zeros((n_rows, width), jnp.float32).at[jnp.asarray(idx.numpy())]
                      .add(jnp.asarray(cot)))
    i = idx.long()
    mag = torch.zeros((n_rows, width), dtype=torch.float64).index_add_(
        0, i, torch.from_numpy(cot).double().abs()).numpy()
    cnt = np.bincount(idx.numpy(), minlength=n_rows)[:, None]
    assert np.all(np.abs(got - want) <= 2 * cnt * U * mag)
    assert hash_gather.lanes_per_row(width) == {16: 4, 8: 2}.get(width, 1)


def test_scatter_runs_model_rounds_once_to_bf16():
    gen = torch.Generator().manual_seed(0)
    idx = scatter_variants.index_mix("run33", 2000, 64, gen)
    cot = torch.randn((2000, 16), generator=gen).to(torch.bfloat16)
    got = hash_gather.scatter_add_rows_runs(idx, cot, 64)
    want = hash_gather.scatter_add_rows_plain(idx, cot, 64)
    assert got.dtype == torch.bfloat16
    assert bool(((got.double() - want.double()).abs()
                 <= hash_gather.scatter_add_tolerance(idx, cot, want)).all())


@pytest.mark.parametrize("s", [1, 37, 64, 65, 192, 256, 300])
@pytest.mark.parametrize("up_front", [False, True])
def test_lane_samples_give_each_sample_to_one_lane(s, up_front):
    k, chunk = tint.lane_samples(s, up_front)
    assert chunk == 32 * k
    owners = [(c0, lane) for c0 in range(0, s, chunk) for lane in range(32)
              for j in range(k) if c0 + lane * k + j < s]
    assert len(owners) == s
    assert k == (2 if not up_front or s > 256 else -(-s // 32))


@pytest.mark.parametrize("up_front", [False, True])
@pytest.mark.parametrize("act", ["relu", "softplus"])
@pytest.mark.parametrize("ert", [0.0, 0.01])
@pytest.mark.parametrize("n,s", [(37, 37), (64, 64), (33, 192), (8, 300)])
def test_lane_transmittance_matches_pallas_interpret(n, s, ert, act, up_front):
    rng = np.random.default_rng(n + s)
    raw = rng.normal(size=(n, s, 4)).astype(np.float32)
    raw[..., 3] *= 20.0
    z = np.sort(rng.uniform(2, 6, (n, s)).astype(np.float32), axis=-1)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    want = integrate_pallas(jnp.asarray(raw[..., 3]), jnp.asarray(raw[..., :3]), jnp.asarray(z),
                            jnp.asarray(d), ert_threshold=ert, white_bkgd=True, tile=32,
                            interpret=True, sigma_activation=act)
    raw_t, z_t, d_t = (torch.from_numpy(a) for a in (raw, z, d))
    alpha = tint.sample_terms(raw_t, z_t, d_t, act)[0]
    trans = tint.lane_transmittance(raw_t, z_t, d_t, act, up_front)
    weights = alpha * trans
    if ert > 0:
        weights = weights * (trans >= ert).to(weights.dtype)
    np.testing.assert_allclose(weights.numpy(), np.asarray(want["weights"]), atol=2e-5)
    acc = weights.sum(-1)
    np.testing.assert_allclose(acc.numpy(), np.asarray(want["acc_map"]), atol=2e-5)
    plain = tint.plain_transmittance(raw_t, z_t, d_t, act)
    np.testing.assert_allclose(trans.numpy(), plain.numpy(), atol=2e-5)
    if ert > 0:  # another order of sums puts T on the other side of ert only near it
        _, near = tint.past_the_cut(plain, ert)
        assert bool(((trans >= ert) == (plain >= ert))[~near].all())
