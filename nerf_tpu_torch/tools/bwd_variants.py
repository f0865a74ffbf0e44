"""What each part of the fused backward (B2) costs: variants of
csrc/fused_mlp_bwd.cu with one part taken out or changed, built and timed on
the GPU.

    python -m nerf_tpu_torch.tools.bwd_variants [--points 196608] [--reps 10]

Each variant is the backward's sources with a few lines replaced
(``VARIANTS``: file -> [(text, its replacement)]) and, for splits64, another
launch argument:
  kernel       the backward as it is;
  no_stash     the recomputed forward stores no activations to the stash
               (its mask bits stay): the cost of the stash's bulk stores;
  no_gbuf      the chain stores no layer gradients to gbuf: their cost;
  stash_masks  the chain reads its ReLU masks from the bf16 stash in device
               memory (4 KB a point) instead of the forward's bits staged in
               shared memory;
  splits64     the weight gradients over 64 point ranges (21 x 64 blocks,
               ~10 waves of f32 partials) instead of one wave of 6.
The variants that compute the backward's function (kernel, stash_masks,
splits64) are held against the plain version (``fused_nerf_bwd_plain``;
relative norm of the worst gradient leaf). Each variant runs in its own process under
a timeout, so one that hangs costs only its line. Times are CUDA events over
``--reps`` launches on random points (the lego fine model, no input
gradients, as the train step calls it), the whole backward and each of its
five launches alone, two rounds in opposite orders, on one card; the card's
name and power limit head the output. Without a GPU it exits with an error.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple

from ..ops import build

MAIN = build.CSRC / "fused_mlp_bwd.cu"
OUT_DIR = build.BUILD_DIR / "bwd_variants"
PHASES = (("forward", 1), ("chain", 2), ("dW", 4), ("heads", 8), ("reduce", 16))

# name -> {source file name: [(text of that file, its replacement)]}
VARIANTS: Dict[str, Dict[str, List[Tuple[str, str]]]] = {
    "kernel": {},
    "no_stash": {"fused_mlp_wgmma.cuh": [
        ("  bulk_store(sblk + s * SLAB, act + a * SLAB, nslabs * SLAB);\n", "")]},
    "no_gbuf": {"fused_mlp_bwd.cu": [
        ("  bulk_store(gblk + (col / 8) * SLAB, gt, nslabs * SLAB);\n", "")]},
    "stash_masks": {"fused_mlp_bwd.cu": [
        ("        const uint32_t* mw = mask_words(msm, l - 1);",
         "        uint32_t words[4];\n"
         "        mask_from_stash(reinterpret_cast<const unsigned char*>(stash) +\n"
         "                            blk * STASH_BLOCK_BYTES, s_h(l - 1), words);\n"
         "        const uint32_t* mw = words;")]},
    "splits64": {},
}
SPLITS = {"splits64": 64}
SAME_FUNCTION = ("kernel", "stash_masks", "splits64")


def variant_sources(name: str) -> Dict[str, str]:
    """{file name: the variant's text} of every source the variant changes;
    raises if one of its replacements no longer matches its file."""
    out = {}
    for fname, reps in VARIANTS[name].items():
        src = (build.CSRC / fname).read_text()
        for old, new in reps:
            if src.count(old) != 1:
                raise ValueError(f"variant {name}: {old.splitlines()[0]!r} is not once in {fname}")
            src = src.replace(old, new)
        out[fname] = src
    return out


def _build_all(names) -> Dict[str, Path]:
    """Each variant's changed sources beside a copy of fused_mlp_bwd.cu in a
    directory of its own (a quoted include looks there first), built into one
    library."""
    procs = {}
    for name in names:
        d = OUT_DIR / name
        d.mkdir(parents=True, exist_ok=True)
        srcs = {MAIN.name: MAIN.read_text(), **variant_sources(name)}
        for fname, text in srcs.items():
            (d / fname).write_text(text)
        so = d / f"{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so),
               str(d / MAIN.name)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    built = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate(timeout=build.NVCC_TIMEOUT_S)
        spills = sorted({l.split(":")[-1].strip() for l in log.splitlines()
                         if "spill" in l and not l.strip().startswith("0 bytes")})
        print(f"built {name}: rc {proc.returncode}; spills: {spills or 'none'}"
              f"{'' if proc.returncode == 0 else chr(10) + log[-600:]}", flush=True)
        if proc.returncode == 0:
            built[name] = so
    return built


def _time_one(name: str, so: str, n: int, reps: int) -> None:
    """Time one variant library (in this process) and print one line."""
    import torch

    from ..ops import fused_mlp, fused_mlp_bwd as fb
    from ..train.checkpoint import load_params

    bound = fb.bind(ctypes.CDLL(so))
    fb._lib = lambda: bound  # the wrappers launch this variant
    lib = bound[0]
    dev = torch.device("cuda")
    root = Path(__file__).resolve().parents[2]
    tree = load_params(str(root / "checkpoints" / "nerf" / "lego" / "nerf"))["fine"]
    kp = {k: v.to(dev) for k, v in fused_mlp.repack_params(tree).items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    pts = torch.rand((n, 3), generator=gen, device=dev) * 3.0 - 1.5
    dirs = torch.randn((n, 3), generator=gen, device=dev)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    g = torch.randn((n, 4), generator=gen, device=dev) * 1e-3
    splits = SPLITS.get(name)
    out = fb.launch_full(kp, pts, dirs, g, False,
                         splits=(splits, fb.splits_for(n)[1]) if splits else None)
    args = list(out["args"])

    def timed(phases: int) -> float:
        args[-2] = phases
        if lib.launch_fused_nerf_bwd(*args) != 0:
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            lib.launch_fused_nerf_bwd(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    total = timed(fb.PHASES_ALL)
    parts = ", ".join(f"{p} {timed(bit):.4f}" for p, bit in PHASES)
    agree = ""
    if name in SAME_FUNCTION:
        timed(fb.PHASES_ALL)
        want = fb.fused_nerf_bwd_plain(kp, pts, dirs, g, input_grads=False)[0]
        worst = max(float((out["kgrads"][k].double() - want[k].double()).norm()
                          / want[k].double().norm().clamp_min(1e-30)) for k in fb._GRAD_KEYS)
        agree = f"; worst leaf against the plain version {worst:.3g}"
    print(f"{name}: {total:.4f} ms on {n} points ({parts}){agree}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=196_608)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--one", nargs=2, metavar=("NAME", "LIB"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        _time_one(*args.one, args.points, args.reps)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    built = _build_all(VARIANTS)
    names = [n for n in VARIANTS if n in built]
    for order in (names, names[::-1]):
        for name in order:
            cmd = [sys.executable, "-m", "nerf_tpu_torch.tools.bwd_variants", "--one", name,
                   str(built[name]), "--points", str(args.points), "--reps", str(args.reps)]
            try:
                r = subprocess.run(cmd, capture_output=True, text=True, timeout=180,
                                   cwd=Path(__file__).resolve().parents[2])
                print((r.stdout.strip() or f"{name}: failed\n{r.stderr[-800:]}"), flush=True)
            except subprocess.TimeoutExpired:
                print(f"{name}: timed out (a hang)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
