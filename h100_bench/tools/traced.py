"""One run of a cell with the program's own tracer on over its window
(`vampire_tpu_torch.utils.profiling`), on the card: the readings that
per-layer metrics of the program's spans would take, and the traced
window's device time by owner.

    python3 h100_bench/tools/traced.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> [--program 0|1]

The run is a benchmark run (`cli.run_cell`), whose result line it prints
first. With `--program 1` (the default) the tracer is enabled when the
window opens and disabled when it closes; with `--trace 1` the
profiler's events are also reduced by owner (`harness/owners.py`). The
second line holds the window's own rate (the driver's end-to-end
numbers, which a traced result line leaves out), the program-span
readings (`harness/program_spans.py`), each owner's device ms a unit
(forward, backward), the share of the device's busy time no span owns,
and how many device events found their launch.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def span_readings(readings: dict) -> dict:
    """The program-span readings a run gives (those it has)."""
    from harness import program_spans as P
    out = dict(
        queue_ms_p50=P.median_ms(readings, 'server.queue'),
        busy_share=P.busy_share(readings),
        padded_share=P.padded_share(readings),
        d2h_ms_a_batch=P.median_ms_a_batch(readings, 'server.d2h'),
        nms_ms_a_batch=P.median_ms_a_batch(readings, 'server.nms'),
        h2d_ms_a_step=P.device_ms_a_unit(readings, 'trainer.to_device'),
        forward_ms_a_step=P.device_ms_a_unit(readings, 'trainer.forward'),
        losses_ms_a_step=P.device_ms_a_unit(readings, 'trainer.losses'))
    for name in P.TRAINER + P.MODEL:
        out[f'{name}.owned_ms'] = P.owned_ms_a_unit(readings, name)
    return {k: v for k, v in out.items() if v is not None}


def run(cell: dict, seed: int, seconds: float, traced: bool,
        program: bool, device, t_start: float):
    """(the result line, the second line) of one run of `cell`."""
    from harness import cli, owners, spec, trace
    from harness import program_spans as P
    if spec.ROOT not in sys.path:
        sys.path.append(spec.ROOT)
    from vampire_tpu_torch.utils import profiling
    got = {}
    enter, close, summarize = (trace.Window.__enter__, trace.Window.close,
                               trace.summarize)
    find_driver = spec.driver

    def traced_enter(self):
        out = enter(self)
        if program:
            profiling.enable()
        return out

    def traced_close(self):
        if program:
            profiling.disable()
        return close(self)

    def traced_summarize(prof, window_s, *a, **kw):
        out = summarize(prof, window_s, *a, **kw)
        if program:
            own = owners.Owners(owners.events_of(prof), P.NAMES)
            by, ops, found, n = {}, {}, 0, 0
            for e in own.events:
                if not e.device:
                    continue
                n += 1
                found += own.launcher(e) is not None
                name, kind = own.owner(e)
                s = (e.end - e.start) / 1e9
                by.setdefault(name, [0.0, 0.0])[kind == 'backward'] += s
                key = (e.name, f'{name}.{kind}')
                ops[key] = ops.get(key, 0.0) + s
            out['device_by_span'] = by
            got['launches'] = dict(device_events=n, launcher_found=found)
            got['ops'] = ops
            got['gaps'] = idle_gaps(own)
        return out

    class Driver:
        def __init__(self, mod):
            self.mod = mod

        def run(self, ctx):
            out = self.mod.run(ctx)
            # after the driver stopped the server: the spans open when the
            # window closed (the last batch's) have ended
            if program:
                out['readings']['program_spans'] = profiling.collect()
            got['out'] = out
            return out

    trace.Window.__enter__ = traced_enter
    trace.Window.close = traced_close
    trace.summarize = traced_summarize
    spec.driver = lambda kind: Driver(find_driver(kind))
    try:
        result, _, _ = cli.run_cell(cell, seed, seconds, traced, device,
                                    t_start)
    finally:
        trace.Window.__enter__, trace.Window.close = enter, close
        trace.summarize, spec.driver = summarize, find_driver
        if program:
            profiling.disable()
    readings = got['out']['readings']
    extra = dict(workload=cell['name'], seed=seed, trace=int(traced),
                 program=int(program),
                 window=dict(got['out']['metrics'], units=readings['units'],
                             window_s=readings['window_s']),
                 spans=span_readings(readings))
    if 'program_spans' in readings:
        extra['spans_kept'] = len(readings['program_spans']['spans'])
        extra['spans_dropped'] = readings['program_spans']['dropped']
    summary = readings.get('trace') or {}
    by = summary.get('device_by_span')
    if by:
        units = readings['units']
        extra['owned_ms_a_unit'] = {k: [1e3 * v[0] / units,
                                        1e3 * v[1] / units]
                                    for k, v in sorted(by.items())}
        unowned = sum(by.get(owners.UNOWNED, [0.0]))
        extra['unowned_share_of_busy'] = (unowned / summary['busy_s']
                                          if summary['busy_s'] else None)
        extra['launches'] = got.get('launches')
        extra['top_ops_by_owner'] = top_ops(got['ops'], units)
        extra['idle_gaps_by_span'] = got['gaps']
    return result, extra


def idle_gaps(own, top: int = 8) -> list:
    """The window's longest device idle gaps (as `trace.summarize` finds
    them), each with the host ms under each innermost program span on
    each thread that has one."""
    dev = sorted((e.start, e.end) for e in own.events if e.device)
    gaps, cur = [], None
    for s, e in dev:
        if cur is not None and s > cur:
            gaps.append((cur, s))
        cur = e if cur is None else max(cur, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for g0, g1 in gaps[:top]:
        split = {}
        for t in own.threads():
            for name, ns in own.split(t, g0, g1).items():
                if name:
                    split[name] = split.get(name, 0.0) + ns / 1e6
        out.append([(g1 - g0) / 1e6, sorted(
            ([k, v] for k, v in split.items()), key=lambda kv: -kv[1])[:4]])
    return out


def top_ops(ops: dict, units: int, top: int = 12, owners_each: int = 5
            ) -> list:
    """The device ops of most time, each with its ms a unit and the
    owners (span.forward / span.backward) that launched most of it."""
    total, split = {}, {}
    for (op, owner), s in ops.items():
        total[op] = total.get(op, 0.0) + s
        split.setdefault(op, []).append((s, owner))
    out = []
    for op in sorted(total, key=total.get, reverse=True)[:top]:
        parts = sorted(split[op], reverse=True)[:owners_each]
        out.append([op[:160], 1e3 * total[op] / units,
                    [[o, 1e3 * s / units] for s, o in parts]])
    return out


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=1)
    ap.add_argument('--program', type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import torch
    from harness import spec
    if not torch.cuda.is_available():
        raise SystemExit('traced: needs a CUDA card')
    result, extra = run(spec.cell(args.workload), args.seed, args.seconds,
                        bool(args.trace), bool(args.program), 'cuda:0',
                        t_start)
    print(json.dumps(result), flush=True)
    print(json.dumps(extra), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
