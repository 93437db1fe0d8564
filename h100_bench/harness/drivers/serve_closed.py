"""Closed-loop serving: `in_flight` single-frame requests outstanding on
`InferenceServer.submit` at every moment (a result is answered by the
next request), so that every micro-batch is full: offline evaluation and
labelling.

Traffic parameters: `in_flight`, `max_batch`, `max_wait_ms`, `outputs`,
`pool` (frames, in an order drawn from the seed), `check_sample`.

The window submits until `--seconds` have passed and then waits for the
requests still out. Reported: `serve_frames_per_s`, every frame completed
over the window's seconds (the drain included)."""
from __future__ import annotations

import collections
import gc
import time

from .. import serving
from ..kernels import OpCalls
from ..seeds import rng
from ..spans import Patches
from ..trace import Window

GRACE_S = 60.0


def run(ctx) -> dict:
    tr = ctx.traffic
    server, pool, calib = serving.build(ctx)
    rec = serving.Recorder(ctx, server, tr['check_sample'])
    ops = OpCalls(ctx.spans, keep=tr['max_batch'])
    order = rng(ctx.seed, 'frames')
    futures = collections.deque()
    attempted = []
    with Patches() as patches:
        if ctx.trace:
            rec.install_spans(patches, ops)
        ctx.sync()
        setup_peak = ctx.peak_bytes()
        ctx.reset_peak()
        ctx.spans.on = ctx.trace

        def send():
            i = len(attempted)
            k = int(order.integers(0, len(pool)))
            attempted.append(i)
            futures.append(rec.submit(i, k, pool[k], time.perf_counter()))

        with Window(ctx.trace, ctx.device) as win:
            ctx.mark_setup_done()
            for _ in range(tr['in_flight']):
                send()
            while time.perf_counter() - win.t0 < ctx.seconds:
                f = futures.popleft()
                try:
                    f.exception(timeout=GRACE_S)
                except TimeoutError:
                    pass
                send()
            rec.wait_all(list(futures), GRACE_S)
            ctx.sync()
            seconds = win.close()
        ctx.spans.on = False
        waited = time.perf_counter()
        window_peak = ctx.peak_bytes()
        readings = dict(units=len(attempted), window_s=seconds,
                        trace=win.summary,
                        device_spans=ctx.spans.device_ms(),
                        server_wait_ms=rec.wait_ms,
                        server_post_ms=rec.post_ms,
                        least_s_per_unit=ctx.least_seconds(1, False))
        if ctx.trace and ctx.cuda:
            readings['lift'] = ops.share(('lift.forward',))
        ops.clear()
        server.stop()
    failed = len(rec.failed) + sum(1 for i in attempted if i not in rec.done)
    done = len(attempted) - failed
    stats = dict(server.stats)
    del server, futures
    gc.collect()
    readings['latency_ms'] = serving.latencies_ms(rec, attempted, waited)
    readings['server_stats'] = stats
    metrics = dict(serve_frames_per_s=done / seconds)
    return dict(metrics=metrics, attempted=len(attempted), failed=failed,
                memory_peak_bytes=max(setup_peak, window_peak),
                readings=readings,
                check=lambda: serving.check(ctx, rec, pool, calib))
