"""The readers of the program's spans and counters (``portbench/spans.py``,
``metrics/idle_*``, ``ert_cut_pct``, ``lock_*``, ``png_pct``) on hand-made
traces and records (CPU), and None against a program without them."""
import collections
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import bench, harness, spans, trace  # noqa: E402

TRAIN = ("idle_optimizer_pct.train", "idle_mlp_host_pct.train", "idle_sampling_pct.train",
         "idle_step_self_pct.train")
SERVE = ("lock_wait_pct.serve", "png_pct.serve", "lock_contended_pct.serve")
Rec = collections.namedtuple("Rec", "name start_ns end_ns id parent root thread")


def profiled(device, host, window=10.0):
    return harness.Profiled(trace=trace.Trace(device=device, host=host, window_s=window),
                            units=1, timed_s=window, config={}, work={})


def step_trace():
    """Two steps in [0, 10]: the device busy in [1, 2], [3.5, 4] and [8, 9].
    Step one (0-5) holds rays.sample (0.5-1.5), mlp.pack (1.8-2.6, with an
    aten op inside) and train.optimizer (3-4.5); step two (5-8.5) holds
    mlp.unpack_grads (6-7)."""
    dev = [("k1", 1.0, 2.0), ("k2", 3.5, 4.0), ("k3", 8.0, 9.0)]
    host = [("train.step", 0.0, 5.0), ("rays.sample", 0.5, 1.5), ("mlp.pack", 1.8, 2.6),
            ("aten::cat", 2.0, 2.2), ("train.optimizer", 3.0, 4.5),
            ("train.step", 5.0, 8.5), ("mlp.unpack_grads", 6.0, 7.0)]
    return profiled(dev, host)


def test_split_is_exact_over_nested_spans_and_crossing_gaps():
    # idle: [0, 1], [2, 3.5], [4, 8], [9, 10] (7.5 s)
    by_span, total = spans.idle_split(step_trace())
    assert total == pytest.approx(7.5)
    want = {"train.step": 0.5 + 0.4 + 0.5 + 1.0 + 1.0,  # [0,.5] [2.6,3] [4.5,5] [5,6] [7,8]
            "rays.sample": 0.5,  # [0.5, 1]: the rest of the span is busy
            "mlp.pack": 0.6,  # [2, 2.6]: the aten op inside is no program span
            "train.optimizer": 1.0,  # [3, 3.5] and [4, 4.5]
            "mlp.unpack_grads": 1.0,
            "": 1.0}  # [9, 10], outside every span
    assert set(by_span) == set(want)
    for k, v in want.items():
        assert by_span[k] == pytest.approx(v), k
    assert sum(by_span.values()) == pytest.approx(total)


def test_a_gap_crossing_two_sibling_spans_is_cut_at_their_boundary():
    dev = [("k", 0.0, 1.0), ("k", 5.0, 6.0)]
    host = [("train.step", 0.0, 6.0), ("rays.sample", 1.0, 2.5), ("train.optimizer", 2.5, 4.0)]
    by_span, total = spans.idle_split(profiled(dev, host, window=6.0))
    assert total == pytest.approx(4.0)
    assert by_span == pytest.approx({"rays.sample": 1.5, "train.optimizer": 1.5,
                                     "train.step": 1.0})


def test_the_same_split_as_the_programs_own():
    from nerf_tpu_torch.utils import profiling

    prof = step_trace()
    tr = prof.trace
    got, total = spans.idle_split(prof)
    want, want_total = profiling.idle_by_span(
        [(s, e) for _, s, e in tr.device], [h for h in tr.host if h[0] in spans.SPANS],
        0.0, tr.window_s)
    assert total == pytest.approx(want_total)
    assert got == pytest.approx(want)


def test_train_readers():
    prof = step_trace()
    got = {m: bench.metric_reader(m).read(prof) for m in TRAIN}
    assert got["idle_optimizer_pct.train"] == pytest.approx(100.0 * 1.0 / 7.5)
    assert got["idle_mlp_host_pct.train"] == pytest.approx(100.0 * 1.6 / 7.5)
    assert got["idle_sampling_pct.train"] == pytest.approx(100.0 * 0.5 / 7.5)
    assert got["idle_step_self_pct.train"] == pytest.approx(100.0 * 3.4 / 7.5)
    assert sum(got.values()) == pytest.approx(100.0 * 6.5 / 7.5)
    assert bench.metric_reader("idle_sampling_pct.render").read(prof) == pytest.approx(
        got["idle_sampling_pct.train"])


def test_none_without_program_spans():
    prof = profiled([("k", 1.0, 2.0)], [("aten::mul", 0.0, 5.0)])
    for m in TRAIN + ("idle_sampling_pct.render",):
        assert bench.metric_reader(m).read(prof) is None


def test_serve_readers_from_records(monkeypatch):
    ms = 1_000_000
    recs = [Rec("serve.request", 0, 100 * ms, 1, None, 1, 7),
            Rec("serve.lock_wait", 1 * ms, 31 * ms, 2, 1, 1, 7),
            Rec("serve.png", 80 * ms, 90 * ms, 3, 1, 1, 7),
            Rec("serve.request", 50 * ms, 150 * ms, 4, None, 4, 8),
            Rec("serve.lock_wait", 51 * ms, 51 * ms, 5, 4, 4, 8),
            Rec("serve.png", 130 * ms, 140 * ms, 6, 4, 4, 8),
            Rec("serve.png", 0, 500 * ms, 9, None, 9, 9)]  # not a request's: left out
    monkeypatch.setattr(spans, "program_spans", lambda: recs)
    monkeypatch.setattr(spans, "program_counters", lambda: {"serve.lock_contended": 1})
    prof = profiled([("k", 0.0, 1.0)], [])
    got = {m: bench.metric_reader(m).read(prof) for m in SERVE}
    assert got == pytest.approx({"lock_wait_pct.serve": 15.0, "png_pct.serve": 10.0,
                                 "lock_contended_pct.serve": 50.0})
    monkeypatch.setattr(spans, "program_counters", lambda: {})
    assert bench.metric_reader("lock_contended_pct.serve").read(prof) == 0.0


def test_serve_and_ert_readers_none_without_the_programs_records(monkeypatch):
    prof = profiled([("k", 0.0, 1.0)], [])
    monkeypatch.setattr(spans, "program_spans", lambda: None)
    monkeypatch.setattr(spans, "program_counters", lambda: None)
    for m in SERVE + ("ert_cut_pct.render",):
        assert bench.metric_reader(m).read(prof) is None
    monkeypatch.setattr(spans, "program_spans", lambda: [])
    monkeypatch.setattr(spans, "program_counters", lambda: {"launches.integrate": 3})
    for m in SERVE + ("ert_cut_pct.render",):
        assert bench.metric_reader(m).read(prof) is None


def test_ert_reader(monkeypatch):
    monkeypatch.setattr(spans, "program_counters",
                        lambda: {"b3.samples": 4000, "b3.ert_cut": 1000})
    prof = profiled([("k", 0.0, 1.0)], [])
    assert bench.metric_reader("ert_cut_pct.render").read(prof) == pytest.approx(25.0)


def test_a_program_without_spans_reads_none(monkeypatch):
    """The parent program's ``profiling`` module has neither ``spans`` nor
    ``counters``."""
    import types

    from nerf_tpu_torch import utils

    bare = types.ModuleType("nerf_tpu_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, "nerf_tpu_torch.utils.profiling", bare)
    monkeypatch.setattr(utils, "profiling", bare, raising=False)
    assert spans.program_spans() is None and spans.program_counters() is None
