"""The rate sweep that fixes an open-loop serving cell's rate: one
process, one set-up (the cell's server, weights, calibration and warm-up
as a run makes them), then the cell's Poisson arrivals at each rate in
turn for `--seconds` each.

    python3 h100_bench/tools/sweep.py --workload <cell> --seed 7 \
        --seconds 20 --rates 10 14 18 22 26

Prints one JSON line a rate: requests, frames/s completed, the median
and 95th percentile latency from due time, the requests still out when
the last was due, and the median latency of the last quarter of the
requests over the first quarter's. The backlog grows where that ratio
and the requests still out keep rising with the rate; the knee is the
highest rate at which neither does. One rate a process, at the cell's
own `--seconds`, reads each rate as a fresh run of the cell sees it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, default=7)
    ap.add_argument('--seconds', type=float, default=20.0)
    ap.add_argument('--rates', type=float, nargs='+', required=True)
    ap.add_argument('--device', default='cuda:0')
    args = ap.parse_args()
    import numpy as np
    from harness import cli, serving, spec
    from harness.drivers.serve_open import schedule
    from harness.seeds import rng
    cell = spec.cell(args.workload)
    ctx = cli.Context(cell, args.seed, args.seconds, False, args.device,
                      time.perf_counter())
    server, pool, _ = serving.build(ctx)
    try:
        for k, rate in enumerate(args.rates):
            dues = schedule(rate, args.seconds, args.seed + k)
            order = rng(args.seed + k, 'frames').integers(0, len(pool),
                                                          len(dues))
            rec = serving.Recorder(ctx, server, 0)
            futs = []
            t0 = time.perf_counter()
            for i, d in enumerate(dues):
                now = time.perf_counter()
                if t0 + d > now:
                    time.sleep(t0 + d - now)
                futs.append(rec.submit(i, int(order[i]), pool[order[i]],
                                       t0 + d))
            out_at_end = sum(1 for f in futs if not f.done())
            rec.wait_all(futs, 120.0)
            t1 = max(rec.done.values())
            lat = serving.latencies_ms(rec, list(range(len(dues))),
                                       time.perf_counter())
            q = max(1, len(lat) // 4)
            print(json.dumps(dict(
                rate_fps=rate, requests=len(dues),
                completed_fps=len(rec.done) / (t1 - t0),
                p50_ms=float(np.median(lat)),
                p95_ms=float(np.percentile(lat, 95)),
                out_at_last_due=out_at_end,
                last_over_first=float(np.median(lat[-q:])
                                      / np.median(lat[:q])),
                stats=dict(server.stats))), flush=True)
            time.sleep(1.0)
    finally:
        server.stop()


if __name__ == '__main__':
    main()
