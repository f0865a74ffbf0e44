"""The frozen counts against the originals they were copied from, and the
trace arithmetic on a hand-made trace (CPU)."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (stdlib at import; its phases run only from main)
from portbench import harness, trace  # noqa: E402
from portbench.counts import b1, b2, b3, b4, b4_bwd, hashgrid, nerf_mlp, peaks  # noqa: E402

LEGO = {"network.nerf.D": 8, "network.nerf.W": 256, "network.nerf.skips": [4],
        "network.xyz_encoder.type": "frequency", "network.xyz_encoder.freq": 10,
        "network.dir_encoder.freq": 4}
HASH = {"network.nerf.D": 4, "network.nerf.W": 128, "network.nerf.skips": [],
        "network.xyz_encoder.type": "hashgrid", "network.xyz_encoder.n_levels": 16,
        "network.xyz_encoder.n_features": 2, "network.xyz_encoder.log2_hashmap_size": 19,
        "network.dir_encoder.freq": 4}


def test_lego_macs_equal_the_smoke_tests():
    assert nerf_mlp.macs_per_point(**nerf_mlp.shape_of(LEGO)) == chip_smoke.MACS_PER_POINT
    assert b2.macs_per_point(LEGO) == chip_smoke.BWD_MACS_PER_POINT


def test_peaks_equal_the_smoke_tests():
    assert (peaks.BF16_FLOPS, peaks.F32_FLOPS, peaks.HBM_BYTES) == (
        chip_smoke.PEAK_BF16_FLOPS, chip_smoke.PEAK_F32_FLOPS, chip_smoke.PEAK_BYTES)


@pytest.mark.parametrize("n", [1, 4096 * 64, 4096 * 192, 8192 * 192])
def test_b1_and_b2_bounds(n):
    from nerf_tpu_torch.ops.fused_mlp import BBUF_SIZE, WBUF_SIZE

    flops = 2.0 * chip_smoke.MACS_PER_POINT * n
    nbytes = 40 * n + 2 * chip_smoke.MACS_PER_POINT + 4 * BBUF_SIZE
    assert b1.launch_bound_s(n, LEGO) == max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES)
    # the smoke test's bytes count the kernel's padded weight buffer: never fewer
    assert nbytes <= chip_smoke.FUSED_IO_BYTES * n + 2 * WBUF_SIZE + 4 * BBUF_SIZE
    bflops = 2.0 * chip_smoke.BWD_MACS_PER_POINT * n
    smoke_bytes = 40 * n + WBUF_SIZE * 2 + BBUF_SIZE * 4 + (WBUF_SIZE + BBUF_SIZE) * 4
    ours = b2.launch_bound_s(n, LEGO)
    assert ours <= max(bflops / peaks.BF16_FLOPS, smoke_bytes / peaks.HBM_BYTES)
    assert ours >= bflops / peaks.BF16_FLOPS


@pytest.mark.parametrize("row_bytes", [4, 8, 32])
def test_gather_bytes_equal_the_ports(row_bytes):
    from nerf_tpu_torch.ops.hash_gather import gather_bytes

    g = torch.Generator().manual_seed(row_bytes)
    idx = torch.randint(0, 5000, (20000,), generator=g, dtype=torch.int32)
    assert b4.gather_bytes(idx, row_bytes) == gather_bytes(idx, row_bytes)
    # what a launch must move whatever its indices is below the full bound
    assert b4.launch_bytes(idx.numel(), row_bytes) <= gather_bytes(idx, row_bytes)[0]


def test_scatter_bound_counts_the_dense_gradient():
    n, rb, rows = 1000, 4, 16 << 19
    assert b4_bwd.launch_bytes(n, rb, rows) == 4 * n + n * rb + rows * rb
    assert hashgrid.table_rows(HASH) == rows and hashgrid.row_bytes(HASH) == 4
    assert hashgrid.flops_per_point(HASH) == 16 * 8 * 6


@pytest.mark.parametrize("act,ert", [("relu", 0.01), ("softplus", 0.01), ("relu", 0.0)])
def test_integrate_bound_equals_the_smoke_tests(act, ert):
    g = torch.Generator().manual_seed(3)
    raw = torch.randn(64, 48, 4, generator=g) * 3.0
    z = torch.sort(2.0 + 4.0 * torch.rand(64, 48, generator=g), dim=-1).values
    d = torch.randn(64, 3, generator=g)
    assert b3.integrate_bound(raw, z, d, ert, act) == chip_smoke.integrate_bound(raw, z, d, ert, act)


def hand_made():
    dev = [("kA(int)", 0.0, 1.0), ("kB(int)", 0.5, 2.0), ("Memcpy HtoD", 3.0, 3.5),
           ("kA(int)", 6.0, 7.0), ("Memset (Device)", 6.5, 6.8)]
    host = [("step", 0.0, 9.0), ("aten::add", 2.0, 3.0), ("aten::copy_", 3.5, 5.0)]
    return trace.Trace(device=dev, host=host, window_s=10.0)


def test_union_of_intervals():
    tr = hand_made()
    # [0, 2] + [3, 3.5] + [6, 7]: overlaps count once
    assert tr.busy_s == pytest.approx(3.5)
    assert trace.gaps(tr.device, 0.0, 10.0) == [(2.0, 3.0), (3.5, 6.0), (7.0, 10.0)]
    assert [k[0] for k in tr.kernels] == ["kA(int)", "kB(int)", "kA(int)"]


def test_idle_by_host_labels_the_innermost_op():
    got = dict(trace.idle_by_host(hand_made()))
    assert got == {"aten::add": pytest.approx(1.0), "aten::copy_": pytest.approx(2.5),
                   "step": pytest.approx(3.0)}


def test_idle_and_launch_readers():
    from portbench import bench

    prof = harness.Profiled(trace=hand_made(), units=2, timed_s=10.0, config=LEGO, work={})
    idle = bench.metric_reader("device_idle_pct.train").read(prof)
    assert idle == pytest.approx(65.0)
    assert bench.metric_reader("launches_per_step.train").read(prof) == 1.5


def test_mfu_reader():
    from portbench import bench

    prof = harness.Profiled(trace=hand_made(), units=1, timed_s=0.5, config=LEGO,
                            work={"passes": 3, "forward_points": 1000})
    want = 100.0 * 3 * 1000 * 2 * chip_smoke.MACS_PER_POINT / (0.5 * peaks.BF16_FLOPS)
    assert bench.metric_reader("mfu_pct.train").read(prof) == pytest.approx(want)
