"""Shared by the variants tools of the scatter-add and the compositing
kernel: a kernel's source with a few lines replaced, every variant built in
a directory of its own (all ``nvcc`` runs started together), and each timed
in a process of its own under a timeout, so a variant that hangs costs only
its own line."""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

from ..ops import build

ROOT = Path(__file__).resolve().parents[2]
# variant name -> [(text of the kernel's source, its replacement)]
Variants = Dict[str, List[Tuple[str, str]]]


def variant_source(main: Path, variants: Variants, name: str) -> str:
    """The text of ``main`` with the variant's replacements; raises if one
    no longer matches the source exactly once."""
    src = main.read_text()
    for old, new in variants[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: {old.splitlines()[0]!r} is not once in {main.name}")
        src = src.replace(old, new)
    return src


def build_all(main: Path, variants: Variants, out_dir: Path) -> Dict[str, Path]:
    """Build every variant into ``out_dir/<name>/<name>.so``; prints one line
    a variant (its return code and, on failure, the end of nvcc's log)."""
    procs = {}
    for name in variants:
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        (d / main.name).write_text(variant_source(main, variants, name))
        so = d / f"{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so),
               str(d / main.name)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    built = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate(timeout=build.NVCC_TIMEOUT_S)
        print(f"built {name}: rc {proc.returncode}"
              f"{'' if proc.returncode == 0 else chr(10) + log[-600:]}", flush=True)
        if proc.returncode == 0:
            built[name] = so
    return built


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def run_rounds(module: str, built: Dict[str, Path], args: Iterable[str],
               timeout_s: float = 180.0) -> None:
    """Time each built variant in its own process (``python -m module --one
    NAME LIB *args``), two rounds in opposite orders, printing its output."""
    names = list(built)
    for order in (names, names[::-1]):
        for name in order:
            cmd = [sys.executable, "-m", module, "--one", name, str(built[name]), *args]
            try:
                r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s,
                                   cwd=ROOT)
                print(r.stdout.strip() or f"{name}: failed\n{r.stderr[-800:]}", flush=True)
            except subprocess.TimeoutExpired:
                print(f"{name}: timed out (a hang)", flush=True)


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Device ms per call of ``fn`` (a launch on the current stream, taking
    the stream at call time): CUDA events around replays of a CUDA graph of
    ``reps`` calls, so the host's launch time stays out."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)
