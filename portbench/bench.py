"""The registry: a cell of ``BENCHMARK.json`` and the files it is made of.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``, whose ``driver`` names ``drivers/<kind>.py``);
its limits are ``limits/<cell>.json``. Each metric of ``BENCHMARK.json`` that
the cell reports is read by a file of ``metrics/`` (per-layer; see
``metric_reader``) or by the driver (end-to-end); a kernel's trace names
are ``kernels/<label>.json``.
Everything is found by name, so a new cell, mix or metric is new files and
entries, never an edit.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent  # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict  # configs/<config>.json
    traffic: Dict  # traffic/<traffic>.json
    limits: Dict  # limits/<cell>.json: {number: limit}
    end_to_end: List[Dict]  # BENCHMARK.json's metrics that this cell reports
    per_layer: List[Dict]
    root: Path  # the checkout

    @property
    def kind(self) -> str:
        return self.traffic["driver"]


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT, bench: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` (or of ``bench``),
    with its files read from ``root/portbench``."""
    bench = bench if bench is not None else read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    base = root / "portbench"
    config = read_json(root / configs[w["config"]]["file"])
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=read_json(base / "traffic" / f"{w['traffic']}.json"),
                limits=read_json(base / "limits" / f"{name}.json"),
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)], root=root)


def driver(kind: str):
    """``portbench.drivers.<kind>``."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", kind):
        raise ValueError(f"bad driver name {kind!r}")
    return importlib.import_module(f"portbench.drivers.{kind}")


def metric_reader(name: str, root: Path = ROOT):
    """The module that reads metric ``name``: ``metrics/<part>.py`` for the
    longest ``part`` that is ``name`` or ``name`` cut before a dot or an
    underscore (``mfu_pct.train`` -> ``mfu_pct.py``, ``launches_per_step.train``
    -> ``launches.py``), so that one reader serves a quantity in every kind
    of cell and a cell's own file can still take its place."""
    base = root / "portbench" / "metrics"
    parts = [name] + [name[:m.start()] for m in reversed(list(re.finditer(r"[._]", name)))]
    path = next((base / f"{p}.py" for p in parts if (base / f"{p}.py").is_file()), None)
    if path is None:
        raise FileNotFoundError(f"no reader of {name!r} under {base}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{path.stem.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_patterns(label: str, root: Path = ROOT) -> List[re.Pattern]:
    """The compiled name patterns of ``kernels/<label>.json``."""
    spec = read_json(root / "portbench" / "kernels" / f"{label}.json")
    return [re.compile(p) for p in spec["patterns"]]
