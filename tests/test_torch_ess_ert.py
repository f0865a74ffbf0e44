"""The port's ESS/ERT harnesses (``ess_ert``, ``quick_ess_ert``,
``performance_test``) on the CPU at tiny sizes, each in a temporary working
directory: they run, write their files there and nowhere else, with the
JAX harnesses' keys and lines. The committed ess_ert_results.json at the
repository's root is the JAX package's and stays as it is.
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from nerf_tpu_torch import ess_ert, performance_test, quick_ess_ert
from nerf_tpu_torch.data.blender import write_blender_scene
from nerf_tpu_torch.render.renderer import RenderOptions
from nerf_tpu_torch.serve import look_at_pose

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
LEGO = os.path.join(ROOT, "checkpoints", "nerf", "lego", "nerf")
LEGO_CFG = os.path.join(ROOT, "configs", "nerf", "lego.yaml")
JAX_RESULTS = os.path.join(ROOT, "ess_ert_results.json")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these tests run many small ops, and with several
    test workers on the machine torch's thread pool spins against itself."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    rng = np.random.default_rng(0)
    splits = {s: (rng.integers(0, 256, (n, 8, 8, 4), dtype=np.uint8),
                  np.stack([look_at_pose(0.5 + i, 0.3, 4.0) for i in range(n)]))
              for s, n in (("train", 2), ("test", 3))}
    write_blender_scene(str(root / "lego"), splits, 0.69)
    return str(root)


def _overrides(scene):
    return ["trained_model_dir", LEGO, "task_arg.N_samples", "8", "task_arg.N_importance", "8",
            "occupancy_grid_resolution", "8", "test_dataset.data_root", scene,
            "test_dataset.H", "8", "test_dataset.W", "8"]


def test_ess_ert_writes_its_results_in_the_working_directory(scene, tmp_path, monkeypatch):
    before = _digest(JAX_RESULTS)
    monkeypatch.chdir(tmp_path)
    record = ess_ert.main(["--cfg_file", LEGO_CFG, "--device", "cpu", "n_frames", "2",
                           *_overrides(scene)])
    assert os.listdir(tmp_path) == ["ess_ert_results.json"]
    with open(tmp_path / "ess_ert_results.json") as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(record))
    with open(JAX_RESULTS) as f:
        jax_keys = set(json.load(f))
    assert jax_keys <= set(written) and set(written) - jax_keys == {"rays_per_s", "device"}
    assert set(written["frame_times"]) == {"baseline", "ess_only", "ert_only", "ess_ert"}
    assert set(written["threshold_sweep"]) == {"0.001", "0.01", "0.1"}
    assert all(v > 0 and np.isfinite(v) for v in written["frame_times"].values())
    assert (written["H"], written["W"], written["device"]) == (8, 8, "cpu")
    assert 0.0 < written["occupancy_rate"] < 1.0
    assert _digest(JAX_RESULTS) == before


def test_ess_ert_synthetic_camera_without_a_dataset(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    record = ess_ert.main(["--cfg_file", LEGO_CFG, "--device", "cpu", "n_frames", "1", "H", "6",
                           "W", "6", "trained_model_dir", LEGO, "task_arg.N_samples", "8",
                           "task_arg.N_importance", "8", "occupancy_grid_resolution", "8",
                           "test_dataset.data_root", str(tmp_path / "none")])
    assert "dataset missing; using synthetic camera" in capsys.readouterr().out
    assert (record["H"], record["W"]) == (6, 6)


def test_quick_ess_ert_runs_on_a_small_model(capsys, monkeypatch):
    monkeypatch.setattr(quick_ess_ert, "SIZES", (8, 4))
    monkeypatch.setattr(quick_ess_ert, "OPTS", RenderOptions(
        compute_dtype="float32", mlp_depth=2, mlp_width=16, skips=(), n_samples=8,
        n_importance=8, tile_rays=32))
    out = quick_ess_ert.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "✓ 8x8 render: shape (8, 8, 3)" in text and "✓ 4x4 render" in text
    assert "✓ all quick ESS/ERT checks passed" in text
    assert set(out["seconds"]) == {"baseline", "ess+ert"}
    assert all(0.0 <= lo <= hi <= 1.0 + 1e-6 for lo, hi in out["ranges"].values())


def test_performance_test_runs_the_four_configurations(scene, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the subprocesses' torch, as one_torch_thread
    results = performance_test.main(["--cfg_file", LEGO_CFG, "--device", "cpu", "--timeout",
                                     "300", "--data_root", scene, *_overrides(scene)[:-6],
                                     "test_dataset.H", "8", "test_dataset.W", "8"])
    assert list(results) == ["baseline", "ess_only", "ert_only", "ess_ert"]
    assert all(r["ok"] for r in results.values()), results
    assert all("rays/s" in r["tail"] for r in results.values())
    assert os.listdir(tmp_path) == ["performance_test_results.txt"]
    text = (tmp_path / "performance_test_results.txt").read_text()
    assert text.startswith("config       wall_s  ok\n") and "speedups vs baseline" in text
