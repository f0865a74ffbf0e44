"""Black-box ESS/ERT ablation; counterpart of the top-level ``performance_test.py``.

    python -m nerf_tpu_torch.performance_test [--cfg_file configs/nerf/lego.yaml]
        [--timeout 600] [--data_root DIR] [--device cpu] [key value ...]

Runs ``python -m nerf_tpu_torch.run --type network`` once for each {ESS, ERT}
configuration, as a subprocess with a timeout, with the configuration's
overrides and any trailing ``key value`` pairs; records each run's wall
clock (start-up, kernel builds and the ESS rebuild included), its exit and
the last three lines of its output; writes ``performance_test_results.txt``
to the working directory. ``--data_root`` sets the test split's data root
(the config's own when not given).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

CONFIGS = [
    ("baseline", ["enable_ess", "False", "enable_ert", "False"]),
    ("ess_only", ["enable_ess", "True", "enable_ert", "False"]),
    ("ert_only", ["enable_ess", "False", "enable_ert", "True"]),
    ("ess_ert", ["enable_ess", "True", "enable_ert", "True"]),
]
RESULTS = "performance_test_results.txt"
# the directory that holds the nerf_tpu_torch package: the subprocesses
# import it from there whatever the working directory
PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="nerf_tpu_torch ESS/ERT ablation (subprocesses)")
    parser.add_argument("--cfg_file", default=os.path.join(PACKAGE_PARENT, "configs", "nerf",
                                                           "lego.yaml"))
    parser.add_argument("--timeout", type=int, default=600)
    parser.add_argument("--data_root", default=None)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args, extra = parser.parse_known_args(argv)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (PACKAGE_PARENT, env.get("PYTHONPATH"))
                                        if p)
    results = {}
    for name, overrides in CONFIGS:
        cmd = [sys.executable, "-u", "-m", "nerf_tpu_torch.run", "--type", "network",
               "--cfg_file", args.cfg_file]
        if args.device:
            cmd += ["--device", args.device]
        if args.data_root:
            cmd += ["test_dataset.data_root", args.data_root]
        cmd += [*overrides, *extra]
        print(f"=== {name}: {' '.join(overrides)} ===", flush=True)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout,
                                  env=env)
            wall = time.perf_counter() - t0
            tail = "\n".join(proc.stdout.strip().splitlines()[-3:])
            if proc.returncode != 0:
                tail += "\n" + "\n".join(proc.stderr.strip().splitlines()[-5:])
            results[name] = {"wall_s": wall, "ok": proc.returncode == 0, "tail": tail}
            print(tail, flush=True)
        except subprocess.TimeoutExpired:
            results[name] = {"wall_s": float(args.timeout), "ok": False, "tail": "TIMEOUT"}
            print("TIMEOUT", flush=True)

    with open(RESULTS, "w") as f:
        f.write("config       wall_s  ok\n")
        for name, r in results.items():
            f.write(f"{name:<12} {r['wall_s']:7.1f}  {r['ok']}\n")
            for line in r["tail"].splitlines():
                f.write(f"    {line}\n")
        base = results["baseline"]["wall_s"]
        f.write("\nspeedups vs baseline (wall-clock, incl. start-up):\n")
        for name, r in results.items():
            f.write(f"  {name}: {base / r['wall_s']:.2f}x\n")
    print(f"written: {RESULTS}", flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
