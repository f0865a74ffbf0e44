"""nerf_tpu_torch's samplers against nerf_tpu.data.samplers: the index
sequences are identical (exact) for the same seeds, epochs, ranks and sizes."""
import numpy as np
import pytest

from nerf_tpu.data import samplers as js

from nerf_tpu_torch.data import samplers as ts


@pytest.mark.parametrize("n,epoch,seed,shuffle", [(100, 0, 0, True), (37, 3, 5, True),
                                                  (10, 1, 0, False)])
def test_epoch_shuffled_indices(n, epoch, seed, shuffle):
    np.testing.assert_array_equal(ts.epoch_shuffled_indices(n, epoch, seed, shuffle),
                                  js.epoch_shuffled_indices(n, epoch, seed, shuffle))


@pytest.mark.parametrize("world,pad", [(1, True), (3, True), (4, False)])
def test_shard_indices(world, pad):
    idx = np.random.default_rng(0).permutation(23)
    for rank in range(world):
        np.testing.assert_array_equal(ts.shard_indices(idx, rank, world, pad),
                                      js.shard_indices(idx, rank, world, pad))


@pytest.mark.parametrize("world", [1, 2, 3])
def test_iteration_based_distributed_sampler(world):
    for rank in range(world):
        got_base = ts.DistributedEpochSampler(17, rank, world, seed=4)
        want_base = js.DistributedEpochSampler(17, rank, world, seed=4)
        assert len(got_base) == len(want_base)
        got = list(ts.IterationBasedSampler(got_base, 50, start_iter=3))
        want = list(js.IterationBasedSampler(want_base, 50, start_iter=3))
        assert got == want and len(got) == 47


@pytest.mark.parametrize("drop_last", [False, True])
def test_image_size_batch_sampler(drop_last):
    got = ts.ImageSizeBatchSampler(range(23), 5, drop_last, seed=7)
    want = js.ImageSizeBatchSampler(range(23), 5, drop_last, seed=7)
    assert list(got) == list(want) and len(got) == len(want)
