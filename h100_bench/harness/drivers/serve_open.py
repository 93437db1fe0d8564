"""Open-loop serving: single-frame requests to `InferenceServer.submit`
at Poisson arrivals of a fixed rate, each timed from the moment it was
due to its result (NMS included).

Traffic parameters: `rate_fps` (and, for the record, `knee_fps`, the
highest rate the card sustained in the sweep), `arrivals_seed`, `max_batch`,
`max_wait_ms`, `outputs` (the server's graph), `pool` (frames cycled),
`check_sample` (served requests the reference checks).

The arrivals are one Poisson sample, the same for every seed: the gaps
are the `rate * seconds` quantiles of the exponential at the rate, in an
order drawn from `arrivals_seed`. The seed draws the frames, the weights
and the frame each request carries. (With the gaps shuffled by the seed
the 95th percentile moved 566-882 ms between three seeds at 30 s, by the
bursts each order made, which no bound could hold.) Reported:
`serve_p50_ms`, the median over every request of the window (one that
fails or never comes counts its whole wait), end to end; the 95th
percentile over the same requests is a per-layer reading
(`latency_ms`): on a shared host a stall of a tenth of a second or more
moves it by 13-28 % from run to run, more than any bound can hold."""
from __future__ import annotations

import gc
import time

import numpy as np

from .. import serving
from ..kernels import OpCalls
from ..seeds import rng
from ..spans import Patches
from ..trace import Window

GRACE_S = 60.0


def schedule(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's start) of the window's requests, the
    gaps' order drawn from `seed`."""
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    rng(seed, 'arrivals').shuffle(gaps)
    return np.cumsum(gaps) - gaps[0]


def run(ctx) -> dict:
    tr = ctx.traffic
    server, pool, calib = serving.build(ctx)
    dues = schedule(tr['rate_fps'], ctx.seconds, tr['arrivals_seed'])
    order = rng(ctx.seed, 'frames').integers(0, len(pool), len(dues))
    rec = serving.Recorder(ctx, server, tr['check_sample'])
    ops = OpCalls(ctx.spans, keep=tr['max_batch'])
    late = []
    futures = []
    with Patches() as patches:
        if ctx.trace:
            rec.install_spans(patches, ops)
        ctx.sync()
        setup_peak = ctx.peak_bytes()
        ctx.reset_peak()
        ctx.spans.on = ctx.trace
        with Window(ctx.trace, ctx.device) as win:
            ctx.mark_setup_done()
            t0 = win.t0
            for i, d in enumerate(dues):
                now = time.perf_counter()
                if t0 + d > now:
                    time.sleep(t0 + d - now)
                late.append(time.perf_counter() - (t0 + d))
                futures.append(rec.submit(i, int(order[i]),
                                          pool[order[i]], t0 + d))
            while time.perf_counter() - t0 < ctx.seconds:
                time.sleep(0.001)
            rec.wait_all(futures, GRACE_S)
            ctx.sync()
            seconds = win.close()
        ctx.spans.on = False
        waited = time.perf_counter()
        window_peak = ctx.peak_bytes()
        readings = dict(units=len(dues), window_s=seconds,
                        trace=win.summary,
                        device_spans=ctx.spans.device_ms(),
                        server_wait_ms=rec.wait_ms,
                        server_post_ms=rec.post_ms,
                        late_ms_max=max(late) * 1e3)
        if ctx.trace and ctx.cuda:
            readings['lift'] = ops.share(('lift.forward',))
        ops.clear()
        server.stop()
    lat = serving.latencies_ms(rec, list(range(len(dues))), waited)
    failed = len(rec.failed) + sum(1 for i in range(len(dues))
                                   if i not in rec.done)
    stats = dict(server.stats)
    del server, futures
    gc.collect()
    metrics = dict(serve_p50_ms=float(np.percentile(lat, 50)))
    readings['latency_ms'] = lat
    readings['server_stats'] = stats
    diagnostics = dict(p95_ms=float(np.percentile(lat, 95)),
                       late_ms_max=readings['late_ms_max'], **stats)
    return dict(metrics=metrics, attempted=len(dues), failed=failed,
                diagnostics=diagnostics,
                memory_peak_bytes=max(setup_peak, window_peak),
                readings=readings,
                check=lambda: serving.check(ctx, rec, pool, calib))
