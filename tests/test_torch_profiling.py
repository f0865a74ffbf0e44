"""The port's profiling hooks (``nerf_tpu_torch.utils.profiling``) against
``nerf_tpu.utils.profiling`` on the CPU: ``sync`` over trees (an empty one
a no-op), ``trace`` writing a Chrome trace into its directory, and
``memory_stats() == {}`` without a GPU, as JAX's on the CPU. On the card,
tests/test_torch_cuda.py and chip_smoke.py phase 43 check that a trace
names B1's and B3's kernels and that memory_stats reports the card's bytes.

The program's spans and counters: off without a profiler; under one, in
memory with their parent and root ids and, in the profiler's own thread,
in its trace; the bound on the records; the two private torch flags they
rest on; a lego train step opening every span the benchmark reads; the
device-idle split by span.
"""
import glob
import json
import os
import threading
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


# --- spans and counters ---------------------------------------------------

from torch.autograd import profiler as autograd_profiler  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

CPU = [ProfilerActivity.CPU]


def _host_events(p):
    return {e.name: e for e in p.events()}


def test_profiler_flags_pinned():
    """The switch rests on two private flags: the process-wide one reads
    True in every thread while a profiler runs, the thread-local one only in
    the profiler's thread."""
    seen = {}

    def look(key):
        seen[key] = (autograd_profiler._is_profiler_enabled,
                     torch._C._autograd._profiler_enabled())

    look("before")
    with profile(activities=CPU):
        look("main")
        t = threading.Thread(target=look, args=("other",))
        t.start()
        t.join()
    look("after")
    assert seen == {"before": (False, False), "main": (True, True), "other": (True, False),
                    "after": (False, False)}
    with prof.trace(None):
        assert prof.enabled()
    assert not prof.enabled()


def test_no_record_and_no_counter_without_a_profiler():
    prof.reset()
    with prof.span("outer"):
        with prof.span("inner"):
            pass
    prof.count("hits", 3)

    @prof.span("deco")
    def f():
        return 1

    assert f() == 1
    assert prof.spans() == [] and "hits" not in prof.counters() and prof.dropped() == 0
    assert prof.span("outer") is prof.span("outer")  # one shared no-op a name


def test_spans_nest_in_memory_and_in_the_trace():
    prof.reset()

    @prof.span("deco")  # decorated while off, on at the call
    def work():
        return torch.ones(4) * 2

    with profile(activities=CPU) as p:
        with prof.span("outer"):
            with prof.span("inner"):
                work()
        with prof.span("second"):
            pass
        prof.count("hits")
        prof.count("hits", 2)
    recs = {r.name: r for r in prof.spans()}
    assert set(recs) == {"outer", "inner", "deco", "second"}
    outer, inner, deco, second = (recs[k] for k in ("outer", "inner", "deco", "second"))
    assert outer.parent is None and outer.root == outer.id
    assert inner.parent == outer.id and inner.root == outer.id
    assert deco.parent == inner.id and deco.root == outer.id
    assert second.parent is None and second.root == second.id
    assert outer.start_ns <= inner.start_ns <= deco.start_ns <= deco.end_ns <= inner.end_ns \
        <= outer.end_ns
    assert len({r.thread for r in recs.values()}) == 1
    assert prof.counters()["hits"] == 3
    ev = _host_events(p)
    for child, parent in (("inner", "outer"), ("deco", "inner")):
        c, q = ev[child].time_range, ev[parent].time_range
        assert q.start <= c.start and c.end <= q.end, (child, parent)
        assert ev[child].thread == ev[parent].thread
    assert "aten::mul" in ev
    prof.reset()
    assert prof.spans() == [] and "hits" not in prof.counters()


def test_a_span_of_another_thread_is_in_memory_not_in_the_trace():
    prof.reset()

    def other():
        with prof.span("handler"):
            with prof.span("handler.child"):
                torch.ones(3) + 1

    with profile(activities=CPU) as p:
        with prof.span("main"):
            t = threading.Thread(target=other)
            t.start()
            t.join()
    recs = {r.name: r for r in prof.spans()}
    assert set(recs) == {"main", "handler", "handler.child"}
    assert recs["handler"].thread != recs["main"].thread
    assert recs["handler"].parent is None and recs["handler.child"].root == recs["handler"].id
    names = set(_host_events(p))
    assert "main" in names and "handler" not in names and "handler.child" not in names


def test_the_bound_and_its_drop_count(monkeypatch):
    prof.reset()
    monkeypatch.setattr(prof, "MAX_SPANS", 5)
    with profile(activities=CPU):
        for _ in range(8):
            with prof.span("s"):
                pass
    assert len(prof.spans()) == 5 and prof.dropped() == 3
    prof.reset()
    assert prof.dropped() == 0


def test_counters_read_the_launch_counters():
    from nerf_tpu_torch.ops import fused_mlp, integrate

    got = prof.counters()
    assert got["launches.fused_nerf_eval"] == fused_mlp.fused_nerf_eval.launches
    assert got["launches.integrate"] == integrate.integrate.launches
    if not torch.cuda.is_available():  # the compositing kernel's count is the card's
        assert "b3.ert_cut" not in got


def test_a_train_step_opens_the_benchmarks_spans():
    """A lego train step (plain kernels on the CPU, tiny batch) under the
    profiler: train.step holds the optimizer, the MLP packing and both
    sampling ranges, each in the trace of the calling thread."""
    from nerf_tpu_torch.config import make_cfg
    from nerf_tpu_torch.render import occupancy as occ
    from nerf_tpu_torch.render.renderer import RenderOptions
    from nerf_tpu_torch.train import loop, optim
    from nerf_tpu_torch.train.state import init_state, train_step

    root = os.path.join(os.path.dirname(__file__), "..")
    cfg = make_cfg(os.path.join(root, "configs/nerf/lego.yaml"),
                   ["task_arg.N_samples", "8", "task_arg.N_importance", "8"])
    opts = RenderOptions.from_cfg(cfg)
    tx = optim.make_optimizer(cfg)
    state = init_state(loop.init_nerf_params(torch.Generator().manual_seed(0), opts), tx)
    gen = torch.Generator().manual_seed(1)
    imgs = torch.randint(0, 256, (2, 8, 8, 3), dtype=torch.uint8, generator=gen)
    poses = torch.eye(4).repeat(2, 1, 1)
    poses[:, 2, 3] = 4.0
    K = torch.tensor([[10.0, 0, 4], [0, 10.0, 4], [0, 0, 1]])
    grid = occ.full_grid(8)
    prof.reset()
    with profile(activities=CPU) as p:
        train_step(state, imgs, poses, K, tx, opts, 8, grid, gen)
    recs = prof.spans()
    names = [r.name for r in recs]
    assert names.count("train.step") == 1 and names.count("train.optimizer") == 1
    assert names.count("rays.sample") == 2
    assert names.count("mlp.pack") == 2 and names.count("mlp.unpack_grads") == 2
    step = next(r for r in recs if r.name == "train.step")
    assert all(r.root == step.id for r in recs)
    assert {r.parent for r in recs if r.name != "train.step"} == {step.id}
    traced = [e.name for e in p.events() if e.name in set(names)]
    assert sorted(traced) == sorted(names)


def test_idle_by_span_splits_exactly():
    # device busy [1, 2] and [4, 5] of [0, 6]; "t" nests in "s" from 1.5 to 3
    dev = [(1.0, 2.0), (4.0, 5.0)]
    spans = [("s", 0.0, 3.0), ("t", 1.5, 4.5)]
    got, idle = prof.idle_by_span(dev, spans, 0.0, 6.0)
    assert idle == pytest.approx(4.0)
    # idle [0, 1] in s; [2, 3]: t started later, so t; [3, 4] t; [5, 6] outside
    assert got == {"s": pytest.approx(1.0), "t": pytest.approx(2.0), "": pytest.approx(1.0)}
    got, idle = prof.idle_by_span(dev, [], 0.0, 6.0)
    assert got == {"": pytest.approx(4.0)} and idle == pytest.approx(4.0)
