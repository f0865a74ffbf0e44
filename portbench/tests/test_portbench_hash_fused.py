"""``hash_fused_pct``'s reader on hand-made counters (CPU), and None against a
program without them."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import bench, harness, spans, trace  # noqa: E402

NAME = "hash_fused_pct.ngp"


def profiled():
    tr = trace.Trace(device=[("k", 0.0, 1.0)], host=[], window_s=2.0)
    return harness.Profiled(trace=tr, units=1, timed_s=2.0, config={}, work={})


@pytest.mark.parametrize("counts,want", [
    ({"hash.points": 4096, "hash.fused_points": 4096}, 100.0),
    ({"hash.points": 4096, "hash.fused_points": 1024}, 25.0),
    ({"hash.points": 4096}, 0.0),
    ({"launches.gather_rows": 3}, None),  # a program without the encoder's counters
    ({"hash.points": 0}, None),
    (None, None)])  # a program without counters
def test_hash_fused_reader(counts, want, monkeypatch):
    monkeypatch.setattr(spans, "program_counters", lambda: counts)
    got = bench.metric_reader(NAME).read(profiled())
    assert got == (None if want is None else pytest.approx(want))


def test_the_programs_encoder_counts_its_points():
    """The port's hash encoder on the CPU under the profiler: every point
    counted, none fused (the kernels take CUDA tensors), so the reader reads 0."""
    import torch

    from nerf_tpu_torch.models import hashgrid
    from nerf_tpu_torch.utils import profiling

    params = hashgrid.init_hashgrid(torch.Generator().manual_seed(0), n_levels=2,
                                    log2_table_size=8)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.reset()
        hashgrid.hashgrid_encode(params, torch.rand(100, 3))
        assert bench.metric_reader(NAME).read(profiled()) == 0.0
