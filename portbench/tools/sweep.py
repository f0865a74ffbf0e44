"""The highest rate a serving cell sustains: its driver at each offered rate.

    python -m portbench.tools.sweep --workload lego.serve --rates 16,20,24 \\
        [--seconds 15] [--seed 1]

For each rate, one run of the cell with the mix's rate replaced; prints a
JSON line of the offered and completed rates and the median and 95th
percentile times, from the first and the second half of the arrivals (a
queue that grows shows as a second half slower than the first). Needs the
card.
"""
from __future__ import annotations

import argparse
import copy
import json
import statistics
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    from portbench import bench, harness, run as runner
    from portbench.drivers import serve

    runner.cache_dirs(bench.ROOT)
    import torch

    base = bench.find_cell(args.workload)
    for rate in [float(r) for r in args.rates.split(",")]:
        cell = copy.deepcopy(base)
        cell.traffic["rate"] = rate
        ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=False,
                              device=torch.device("cuda", 0), t0=time.perf_counter())
        got = {}
        orig = serve.p95

        def keep(lat):
            got["lat"] = list(lat)
            return orig(lat)

        serve.p95 = keep
        try:
            out = serve.run(ctx)
        finally:
            serve.p95 = orig
        lat = got["lat"]
        half = len(lat) // 2
        ms = lambda v, q: 1e3 * statistics.quantiles(v, n=100)[q - 1]  # noqa: E731
        print(json.dumps({"offered": rate, "requests": out.attempted, "failed": out.failed,
                          "p95_ms": out.values["request_ms_p95"],
                          "first_half": [ms(lat[:half], 50), ms(lat[:half], 95)],
                          "second_half": [ms(lat[half:], 50), ms(lat[half:], 95)]}), flush=True)


if __name__ == "__main__":
    main()
