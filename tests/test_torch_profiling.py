"""The port's profiling hooks (``nerf_tpu_torch.utils.profiling``) against
``nerf_tpu.utils.profiling`` on the CPU: ``sync`` over trees (an empty one
a no-op), ``trace`` writing a Chrome trace into its directory, and
``memory_stats() == {}`` without a GPU, as JAX's on the CPU. On the card,
tests/test_torch_cuda.py and chip_smoke.py phase 43 check that a trace
names B1's and B3's kernels and that memory_stats reports the card's bytes.
"""
import glob
import json
import os
import time

import numpy as np
import pytest
import torch

from nerf_tpu.utils import profiling as jprof
from nerf_tpu_torch.utils import profiling as prof


class _Leaf(torch.Tensor):
    """A tensor that records its copies to the host."""
    copies = []

    def cpu(self, *args, **kwargs):
        _Leaf.copies.append(self.shape)
        return super().cpu(*args, **kwargs)


@pytest.mark.parametrize("tree", [
    {"a": torch.ones(3), "b": [torch.zeros(2)]},
    [torch.ones(1), (torch.ones(2), {"z": torch.ones(3), "a": torch.ones(4)})],
    torch.ones(5),
])
def test_sync_copies_the_last_leaf(tree):
    import jax.numpy as jnp

    leaves = []

    def mark(t):
        leaf = t.as_subclass(_Leaf)
        leaves.append(leaf)
        return leaf

    from nerf_tpu_torch.tree import tree_map

    marked = tree_map(mark, tree)
    _Leaf.copies.clear()
    prof.sync(marked)
    # JAX's order of leaves: dicts by sorted key, lists in order
    from jax.tree_util import tree_leaves as jleaves
    want = jleaves(tree_map(lambda t: jnp.asarray(t.numpy()), tree))[-1].shape
    assert _Leaf.copies == [torch.Size(want)]
    jprof.sync(tree_map(lambda t: jnp.asarray(t.numpy()), tree))


@pytest.mark.parametrize("tree", [[], {}, {"a": [], "b": {}}, {"n": None, "s": "text"}])
def test_sync_of_a_tree_without_tensors_is_a_noop(tree):
    prof.sync(tree)
    jprof.sync(tree)


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with prof.trace(log_dir) as d:
        y = torch.ones(8, 8) @ torch.ones(8, 8)
    assert d == log_dir and float(y.sum()) == 512.0
    (path,) = glob.glob(os.path.join(log_dir, "*.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "aten::mm" in names or "aten::matmul" in names
    with prof.trace(log_dir):
        pass
    assert len(glob.glob(os.path.join(log_dir, "*.json"))) == 2  # one file a trace


def test_trace_writes_its_file_when_the_block_raises(tmp_path):
    with pytest.raises(RuntimeError):
        with prof.trace(str(tmp_path)):
            raise RuntimeError("inside")
    assert len(glob.glob(os.path.join(str(tmp_path), "*.json"))) == 1


def test_trace_default_directory_is_in_tmpdir(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with prof.trace() as d:
        pass
    assert d == os.path.join(str(tmp_path), "nerf_tpu_torch-trace") and os.listdir(d)


def test_memory_stats_without_a_gpu_is_empty():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: tests/test_torch_cuda.py checks the card's bytes")
    assert prof.memory_stats() == {} == jprof.memory_stats()


def test_rays_per_second_unchanged():
    for meter in (prof.RaysPerSecond(drop_first=1), jprof.RaysPerSecond(drop_first=1)):
        assert meter.summary()["frames"] == 0
    meter = prof.RaysPerSecond(drop_first=1)
    for i in range(3):
        with meter.measure(1000) as done:
            time.sleep(0.01 if i == 0 else 0.001)
            done(torch.from_numpy(np.ones(4)))
    s = meter.summary()
    assert s["frames"] == 2 and s["rays_per_s"] > 0 and s["fps"] > 0
    assert s["mean_time_s"] < meter.samples[0][1]
