"""BENCHMARK.json against the contract's rules of names and files, and a
cell added as data alone runs (CPU, at a tiny size, the plain path)."""
import json
import re
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

from portbench import bench  # noqa: E402
from portbench.tests import tiny  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["portbench"]
    assert len(BENCH["command"]) <= 32


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.fullmatch(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
                    assert "\t" not in entry[key]
            if "unit" in entry:
                assert UNIT.fullmatch(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)
    for w in BENCH["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
    for c in BENCH["configs"]:
        assert all(NAME.fullmatch(k) for k in c["reduced"]) and len(c["reduced"]) <= 16


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_by_name(name):
    cell = bench.find_cell(name)
    assert bench.driver(cell.kind).run
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e, f"{m['name']} moves {m['moves']}, not reported by {name}"
        assert callable(bench.metric_reader(m["name"]).read)
    assert set(cell.limits) and all(isinstance(v, float) for v in cell.limits.values())


def test_kernel_labels_compile():
    for path in (HERE / "kernels").glob("*.json"):
        assert bench.kernel_patterns(path.stem)


def test_a_cell_added_as_files_and_one_entry_runs(tmp_path):
    """A copy of the benchmark gains a cell by new files (a configuration, a
    traffic mix, limits) and one BENCHMARK.json entry, and runs it."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("configs", "checkpoints"):
        (root / name).symlink_to(ROOT / name)
    bench_json = json.loads(json.dumps(BENCH))
    config = json.loads((HERE / "configs" / "lego.json").read_text())
    config["name"] = "lego_small_grid"
    config["cfg"].update({"occupancy_grid_resolution": 8, "task_arg.N_samples": 8,
                          "task_arg.N_importance": 16})
    (root / "portbench" / "configs" / "lego_small_grid.json").write_text(json.dumps(config))
    traffic = {"driver": "train", "rays_per_step": 16, "views": 2, "view_size": [8, 8],
               "radius": 4.0311, "focal": 11.0, "trace_steps": 2}
    (root / "portbench" / "traffic" / "rays16.json").write_text(json.dumps(traffic))
    (root / "portbench" / "limits" / "lego_small_grid.train16.json").write_text(
        json.dumps({"loss_gap": 0.5, "grad_gap": 0.5, "change_gap": 0.5}))
    bench_json["configs"].append({"name": "lego_small_grid", "source": "test",
                                  "file": "portbench/configs/lego_small_grid.json",
                                  "reduced": [], "why": "test"})
    bench_json["workloads"].append({"name": "lego_small_grid.train16", "config": "lego_small_grid",
                                    "traffic": "rays16", "chips": 1, "why": "test"})
    bench_json["end_to_end"][0]["workloads"].append("lego_small_grid.train16")
    (root / "BENCHMARK.json").write_text(json.dumps(bench_json))
    cell = bench.find_cell("lego_small_grid.train16", root=root)
    line, _ = tiny.run(cell, seconds=0.2)
    assert line["correct"], line
    assert set(line["metrics"]) == {"train_rays_per_s", "setup_s"}
    assert list(line)[-1] == "checks"
