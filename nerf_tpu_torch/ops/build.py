"""Builds the port's CUDA kernels with plain ``nvcc`` and loads them with ``ctypes``.

Each ``nerf_tpu_torch/csrc/<name>.cu`` exposes ``extern "C"`` launch
functions that take raw pointers and a stream and return the CUDA error
code. It includes no PyTorch header, so one source compiles in seconds.
The shared library goes to ``build/nerf_tpu_torch/`` at the root of the
checkout, named by a hash of the sources and flags, so a changed source is
rebuilt and an unchanged one is loaded as it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nerf_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
NVCC_TIMEOUT_S = 600
# row counts pass to the kernels as C ints; the launchers round them up to
# whole blocks, so stay well below 2**31
MAX_LAUNCH_ROWS = 1 << 30

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):  # headers count too
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that are not built yet, one
    ``nvcc`` each, all started together. Returns {name: seconds} of those
    compiled. ``nvcc``'s output (with ``-Xptxas -v``: registers, shared
    memory, spills) is kept beside each library as ``<lib>.log``."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    seconds = {}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        remaining = max(1.0, NVCC_TIMEOUT_S - (time.perf_counter() - t0))
        try:
            log, _ = proc.communicate(timeout=remaining)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            errors.append(f"nvcc timed out on {name}.cu after {NVCC_TIMEOUT_S} s\n{log}")
            continue
        out.with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        seconds[name] = time.perf_counter() - t0
    if errors:
        for e in errors:
            print(e, file=sys.stderr, flush=True)
        raise RuntimeError("kernel build failed: " + "; ".join(e.splitlines()[0] for e in errors))
    return seconds


def build_log(name: str) -> str:
    """nvcc's output of the current build of ``name`` ("" if not built here)."""
    path = _lib_path(name).with_suffix(".so.log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _libs:
            path = _lib_path(name)
            if not path.exists():
                build([name])
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None,
               align: int = 4) -> None:
    """Raise unless ``t`` is what a kernel takes: a contiguous CUDA tensor of
    ``dtype`` and ``shape`` whose data is ``align``-byte aligned."""
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} CUDA tensor, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer not {align}-byte aligned")
