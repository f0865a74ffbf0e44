"""The viewers of the orbit page as an open loop, in a process of their own
(no torch).

    python -m portbench.drivers.serve_clients '<json>'

with {"port", "seed", "viewers", "rate", "seconds" or "requests", "radius",
"drag", "timeout", "workers"}. Requests arrive every 1 / ``rate`` seconds,
whatever the server does (viewers that each ask for frames at a fixed
pace, staggered), ``rate`` x ``seconds`` of them (or ``requests``).
Arrival i belongs to viewer i mod ``viewers``; each viewer
starts at an orbit pose drawn from the seed (theta in [0, 2 pi), phi in
[0.1, 1.2]) and moves by a seeded drag (|d theta|, |d phi| <= drag, phi in
[-1.4, 1.4]) before each of its requests. A pool of ``workers`` threads
sends GET /frame at each arrival's due time and waits for the whole PNG.
It waits for a line on stdin, then runs until every request has an answer
or a failure, and prints one JSON line: every request's [viewer, theta,
phi, radius, seconds from its due time to its answer, HTTP status (-1: no
answer), PNG as base64 or null, seconds it was sent late], and the run's
seconds from the first due time to the last answer.
"""
from __future__ import annotations

import base64
import http.client
import json
import math
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def arrivals(spec: dict) -> np.ndarray:
    """Due times (s from the start) of every request."""
    rate = float(spec["rate"])
    n = int(spec["requests"]) if "requests" in spec else max(1, round(rate * float(spec["seconds"])))
    return np.arange(n) / rate


def poses(spec: dict, n: int):
    """(viewer, theta, phi) of each arrival."""
    k = int(spec["viewers"])
    rngs = [np.random.default_rng([int(spec["seed"]), 1 + v]) for v in range(k)]
    state = [[r.uniform(0.0, 2.0 * np.pi), r.uniform(0.1, 1.2)] for r in rngs]
    drag = float(spec["drag"])
    out = []
    for i in range(n):
        v = i % k
        state[v][0] += rngs[v].uniform(-drag, drag)
        state[v][1] = float(np.clip(state[v][1] + rngs[v].uniform(-drag, drag), -1.4, 1.4))
        out.append((v, float(state[v][0]), state[v][1]))
    return out


def request(spec: dict, due: float, start_clock: float, pose) -> list:
    v, theta, phi = pose
    radius = float(spec["radius"])
    sent = time.perf_counter()
    status, body = -1, None
    try:
        conn = http.client.HTTPConnection("127.0.0.1", int(spec["port"]),
                                          timeout=float(spec["timeout"]))
        conn.request("GET", f"/frame?theta={theta!r}&phi={phi!r}&radius={radius!r}")
        resp = conn.getresponse()
        status, body = resp.status, resp.read()
        conn.close()
    except (OSError, http.client.HTTPException):
        status = -1
    done = time.perf_counter()
    return [v, theta, phi, radius, done - (start_clock + due), status,
            body if status == 200 else None, sent - (start_clock + due)]


def main(argv=None) -> None:
    spec = json.loads((argv or sys.argv[1:])[0])
    due = arrivals(spec)
    ps = poses(spec, len(due))
    print("ready", flush=True)
    sys.stdin.readline()
    with ThreadPoolExecutor(max_workers=int(spec["workers"])) as pool:
        t0 = time.perf_counter()
        futures = []
        for d, p in zip(due, ps):
            wait = t0 + d - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            futures.append(pool.submit(request, spec, float(d), t0, p))
        results = [f.result() for f in futures]
    seconds = time.perf_counter() - t0
    for r in results:  # the PNGs as text, once every answer is in
        r[6] = base64.b64encode(r[6]).decode() if r[6] else None
    if any(not math.isfinite(r[4]) for r in results):
        raise RuntimeError("a request has no time")
    print(json.dumps({"requests": results, "seconds": seconds}), flush=True)


if __name__ == "__main__":
    main()
