"""The ``ngp.train`` cell (Instant-NGP's network) and the four-rank
``lego.train_dp4`` cell at tiny sizes on the CPU.

``ngp.train``: a sound run is ``correct``; each fault planted underneath the
timed path turns it false (the finest level hashing with another prime,
softplus for exp as the density, spherical harmonics of degree 3, and the
train cells' own: a state left unchanged, half the batch); the reference
in fp8 or with each fault planted in the program's place reads above one of
the cell's own limits. The program runs its float32 path here, so the
tests' own limits can be tight.

``lego.train_dp4``: the driver starts three more ranks of itself over gloo
(world 4, a file store), every rank trains its rows of the global batch,
rank 0's first steps match the one-card reference of the global batch, and
an optimizer that does nothing, or ranks that step on their own shard's
gradient (the all-reduce left out), are caught; the reference in fp8, with
half the batch or with rank 0's rows alone reads above the cell's limits.
"""
import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import bench  # noqa: E402
from portbench.tests import tiny  # noqa: E402
from portbench.tests.test_portbench_faults import half_batch, unchanged_state  # noqa: E402

TIGHT = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2}


def shrink(cell, dtype="float32", limits=None, world=None):
    """A train cell at a tiny size: 32 rays (8 a rank at world 4) of 8
    samples over 3 views of 16 x 16, an 8^3 grid; the hash table at 2^12 rows
    a level, so that most levels hash."""
    cell = copy.deepcopy(cell)
    cfg = cell.config["cfg"]
    cfg.update({"occupancy_grid_resolution": 8, "task_arg.N_samples": 8, "scan_chunk": 2,
                "network.dtype": dtype})
    if "network.xyz_encoder.log2_hashmap_size" in cfg and cfg["network.xyz_encoder.type"] == "hashgrid":
        cfg["network.xyz_encoder.log2_hashmap_size"] = 12
    if cfg.get("task_arg.N_importance"):
        cfg["task_arg.N_importance"] = 16
    cell.traffic.update(rays_per_step=32, views=3, view_size=[16, 16], trace_steps=2,
                        reference_chunk=16)
    if limits is not None:
        cell.limits = dict(limits)
    return cell


def ngp_cell(**kw):
    return shrink(bench.find_cell("ngp.train"), **kw)


def wrong_prime(monkeypatch):
    """The finest level's corners hashed with 2654435769 in place of 2654435761."""
    from nerf_tpu_torch.models import hashgrid

    orig = hashgrid._hash

    def hashed(c, n_rows):
        h = orig(c, n_rows)
        if c.dim() == 4:  # corners [L, N, 8, 3]: the last level
            other = ((c[-1, ..., 0] * 1) & 0xFFFFFFFF) ^ ((c[-1, ..., 1] * 2654435769) & 0xFFFFFFFF)
            other = other ^ ((c[-1, ..., 2] * 805459861) & 0xFFFFFFFF)
            h = torch.cat([h[:-1], (other % n_rows)[None]])
        return h

    monkeypatch.setattr(hashgrid, "_hash", hashed)


def softplus_density(monkeypatch):
    from nerf_tpu_torch.render import renderer

    orig = renderer.composite_kernel
    monkeypatch.setattr(renderer, "composite_kernel",
                        lambda *a, **k: orig(*a, **dict(k, sigma_activation="softplus")))


def sh_degree_3(monkeypatch):
    from nerf_tpu_torch.models import ngp

    orig = ngp.dir_encoding

    def degree3(d):
        sh = orig(d)
        return torch.cat([sh[..., :9], torch.zeros_like(sh[..., 9:])], dim=-1)

    monkeypatch.setattr(ngp, "dir_encoding", degree3)


def test_sound_ngp_run_is_correct():
    line, _ = tiny.run(ngp_cell(limits=TIGHT))
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"train_rays_per_s", "setup_s"}


@pytest.mark.parametrize("fault", [wrong_prime, softplus_density, sh_degree_3, unchanged_state,
                                   half_batch])
def test_ngp_faults_are_caught(fault, monkeypatch):
    fault(monkeypatch)
    line, _ = tiny.run(ngp_cell(limits=TIGHT))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("variant", ["fp8", "prime", "softplus", "sh3"])
def test_the_ngp_controls_fail_the_cells_limits(variant):
    """The reference in fp8, or with a fault planted, in the program's place
    reads above one of the cell's own limits."""
    c = bench.find_cell("ngp.train")
    nums = bench.driver(c.kind).control(tiny.context(shrink(c, dtype="bfloat16")), variant)
    assert any(v > c.limits[k] for k, v in nums.items()), (nums, c.limits)


def _profiled(host):
    from portbench import harness, trace as tracing

    tr = tracing.Trace(device=[("k", 0.0, 1.0), ("k", 3.0, 4.0)], host=host, window_s=5.0)
    return harness.Profiled(trace=tr, units=1, timed_s=5.0, config={}, work={})


@pytest.mark.parametrize("name,span", [("idle_hash_pct.ngp", "hash.encode"),
                                       ("idle_allreduce_pct.train_dp4", "train.all_reduce")])
def test_new_span_readers_split_idle_time(name, span):
    """3 s of the 5 s window are idle; 1 s of them innermost in the new span
    (inside ``train.step``), none where the program has no such span."""
    reader = bench.metric_reader(name)
    got = reader.read(_profiled([("train.step", 0.5, 4.5), (span, 1.5, 2.5)]))
    assert got == pytest.approx(100.0 / 3.0)
    assert reader.read(_profiled([("train.step", 0.5, 4.5)])) is None


def test_ngp_counts_at_published_widths():
    from portbench.counts import ngp

    cfg = bench.find_cell("ngp.train").config["cfg"]
    assert ngp.macs_per_point(cfg) == 9_408
    assert ngp.forward_flops_per_point(cfg) == 2 * 9_408 + 16 * 8 * 6


# planted in the ranks 1-3 through a sitecustomize module on their path, in
# rank 0 (this process) through monkeypatch
RANK_FAULTS = {
    "unchanged_state": ("from nerf_tpu_torch.train import optim\n"
                        "optim.Optimizer.step = lambda self, params, grads, state: None\n"),
    "no_exchange": ("from nerf_tpu_torch.train import state\n"
                    "state._global_stats = lambda grads, stats: (grads, stats)\n"),
}


def no_exchange(monkeypatch):
    """Every rank steps on its own shard's gradient and reports its own loss:
    the all-reduce left out."""
    from nerf_tpu_torch.train import state

    monkeypatch.setattr(state, "_global_stats", lambda grads, stats: (grads, stats))


@pytest.mark.parametrize("fault", [None, "unchanged_state", "no_exchange"])
def test_world4_gloo_run_of_train_dp(fault, tmp_path, monkeypatch):
    """Four gloo ranks of ``lego.train_dp4``'s driver on the CPU: sound, every
    rank's optimizer leaving its state unchanged, or every rank stepping on
    its own shard's gradient (the fault set through the environment, which
    the ranks inherit)."""
    c = shrink(bench.find_cell("lego.train_dp4"), limits={"loss_gap": 1e-4, "grad_gap": 1e-3,
                                                         "change_gap": 1e-2})
    c.traffic["join_seconds"] = 120
    if fault is not None:
        (tmp_path / "sitecustomize.py").write_text(RANK_FAULTS[fault])
        monkeypatch.setenv("PYTHONPATH", str(tmp_path))
        {"unchanged_state": unchanged_state, "no_exchange": no_exchange}[fault](monkeypatch)
    line, out = tiny.run(c, seconds=0.5)
    assert line["correct"] is (fault is None), line["checks"]
    assert out.attempted > 0 and line["device"]["count"] == 4


@pytest.mark.parametrize("variant", ["fp8", "half_batch", "no_exchange"])
def test_the_dp4_controls_fail_the_cells_limits(variant):
    """The one-card reference in fp8, or with half the batch or only rank 0's
    rows, in the program's place reads above one of ``lego.train_dp4``'s
    limits."""
    c = bench.find_cell("lego.train_dp4")
    nums = bench.driver(c.kind).control(tiny.context(shrink(c, dtype="bfloat16")), variant)
    assert any(v > c.limits[k] for k, v in nums.items()), (nums, c.limits)
