"""nerf_tpu_torch.bench on the CPU at tiny sizes.

The timing functions run on small models and return finite positive
rates; the entry point's JSON line has the JAX bench's keys minus its two
``vs_baseline`` keys (read from bench.py's source), plus ``device``; it
finds the checkpoint at the JAX package's path relative to the working
directory and says so on stderr. Rates on the CPU are not the card's.
"""
import ast
import json
import os

import numpy as np
import pytest
import torch

from nerf_tpu_torch import bench
from nerf_tpu_torch.render import occupancy as occ
from nerf_tpu_torch.render.renderer import RenderOptions, kernel_params
from nerf_tpu_torch.train.loop import init_nerf_params
from nerf_tpu_torch.tree import tree_map

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
LEGO = os.path.join(ROOT, "checkpoints", "nerf", "lego", "nerf")
SMALL = RenderOptions(compute_dtype="float32", mlp_depth=2, mlp_width=16, skips=(),
                      n_samples=8, n_importance=8, tile_rays=32)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these tests run many small ops, and with several
    test workers on the machine torch's thread pool spins against itself."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_record_keys():
    """The keys JAX's bench.py puts in its JSON record."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "record":
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript)
                and getattr(node.targets[0].value, "id", "") == "record"):
            keys.add(node.targets[0].slice.value)
    return keys


def test_jax_record_keys_are_read():
    assert _jax_record_keys() == {"metric", "value", "unit", "vs_baseline", "reps",
                                  "rep_spread", "train_rays_per_s", "train_vs_baseline",
                                  "train_reps", "train_rep_spread"}


@pytest.mark.parametrize("ess", [False, True])
def test_bench_forward_returns_finite_rates(ess):
    params = tree_map(lambda t: t.detach().numpy(),
                      init_nerf_params(torch.Generator().manual_seed(0), SMALL))
    kp = kernel_params(params, SMALL)
    pose, K = bench.lego_camera(6, 6, torch.device("cpu"))
    grid = occ.init_grid(8, generator=torch.Generator().manual_seed(1)) if ess else None
    rate, reps = bench.bench_forward(kp, pose, K, 6, 6, SMALL, grid, n_reps=3)
    assert len(reps) == 3 and all(np.isfinite(r) and r > 0 for r in reps)
    assert rate == float(np.median(reps))


def test_bench_train_returns_finite_rates():
    params = init_nerf_params(torch.Generator().manual_seed(0), SMALL)
    imgs, poses = bench.lego_train_images(6, 6, torch.device("cpu"))
    assert imgs.shape == (2, 6, 6, 3) and imgs.dtype == torch.uint8
    _, K = bench.lego_camera(6, 6, torch.device("cpu"))
    before = params["fine"]["pts_linears"][0]["w"].detach().clone()
    rate, reps = bench.bench_train(params, imgs, poses, K, SMALL, None, n_rays=8, n_steps=2,
                                   n_reps=3)
    assert len(reps) == 3 and all(np.isfinite(r) and r > 0 for r in reps)
    assert not torch.equal(params["fine"]["pts_linears"][0]["w"], before)  # 8 steps taken


@pytest.fixture
def small_bench(monkeypatch):
    for name, value in (("SIZE", 4), ("CHUNK_STEPS", 1), ("GRID_RESOLUTION", 8)):
        monkeypatch.setattr(bench, name, value)


def test_entry_point_record_without_a_checkpoint(tmp_path, monkeypatch, capsys, small_bench):
    monkeypatch.chdir(tmp_path)
    record = bench.main(["--device", "cpu", "--reps", "2", "--train-rays", "4", "--tile", "8"])
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == record
    assert set(record) == (_jax_record_keys() - {"vs_baseline", "train_vs_baseline"}
                           | {"device"})
    assert record["metric"] == "lego_800x800_fwd_rays_per_s_per_chip"
    assert record["unit"] == "rays/s" and record["device"] == "cpu"
    for k in ("value", "train_rays_per_s"):
        assert np.isfinite(record[k]) and record[k] > 0
    assert len(record["reps"]) == 2 and len(record["train_reps"]) == 3
    assert "no checkpoint" in err
    assert os.listdir(tmp_path) == []  # it writes nothing


def test_entry_point_reads_the_checkpoint_at_the_jax_path(tmp_path, monkeypatch, capsys,
                                                          small_bench):
    ckpt = tmp_path / "workspace" / "trained_model" / "nerf" / "lego"
    ckpt.mkdir(parents=True)
    os.symlink(LEGO, ckpt / "nerf")
    monkeypatch.chdir(tmp_path)
    record = bench.main(["--device", "cpu", "--reps", "1", "--no-train", "--f32"])
    _, err = capsys.readouterr()
    assert "using trained checkpoint from workspace/trained_model/nerf/lego/nerf" in err
    assert "train_rays_per_s" not in record and record["value"] > 0
