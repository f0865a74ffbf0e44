"""The readings that a cell's limits are set from, in one process.

    python -m portbench.tools.calibrate --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--variants fp8,half_batch,altered] [--seconds 2]

For each of ``--seeds`` it runs the cell as a run does (a short window of
``--seconds``) and prints the numbers compared; for each of
``--control-seeds`` it prints the numbers of the reference put in the
program's place in each variant (``fp8``: the control; ``half_batch``,
``altered``: faults planted in it). One JSON line per reading, then a
summary: the largest sound reading and the smallest variant reading of each
number. Needs the card.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--variants", default="fp8")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    from portbench import bench, harness, run as runner

    runner.cache_dirs(bench.ROOT)
    import torch

    cell = bench.find_cell(args.workload)
    drv = bench.driver(cell.kind)
    dev = torch.device("cuda", 0)
    sound, variants = {}, {}
    for s in [int(x) for x in args.seeds.split(",") if x]:
        torch.cuda.reset_peak_memory_stats()
        ctx = harness.Context(cell=cell, seed=s, seconds=args.seconds, trace=False, device=dev,
                              t0=time.perf_counter())
        out = drv.run(ctx)
        nums = {k: v for k, (v, _) in out.checks.items()}
        print(json.dumps({"seed": s, "sound": nums, "attempted": out.attempted,
                          "failed": out.failed, "values": out.values}), flush=True)
        for k, v in nums.items():
            sound[k] = max(sound.get(k, 0.0), v)
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        ctx = harness.Context(cell=cell, seed=s, seconds=args.seconds, trace=False, device=dev,
                              t0=time.perf_counter())
        for variant in args.variants.split(","):
            nums = drv.control(ctx, variant)
            print(json.dumps({"seed": s, variant: nums}), flush=True)
            for k, v in nums.items():
                variants.setdefault(variant, {})
                variants[variant][k] = min(variants[variant].get(k, float("inf")), v)
    print(json.dumps({"workload": args.workload, "largest_sound": sound,
                      "smallest_variant": variants, "seconds": time.perf_counter() - T0}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
