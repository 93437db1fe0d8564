"""The readings the limits of `correct` are set from, on the card: for
each seed, one run of the cell (a short window at the cell's own load;
its set-up and its check as in a benchmark run) and the control on the
same inputs and weights, in one process.

    python3 h100_bench/tools/readings.py --workload <cell> --seconds 4 \
        --seeds 11 12 13 ...

Prints one JSON line a seed: the run's numbers (the program against the
fp32 reference) and the control's (the reference one precision step
below against it). The lower reading of a number is the largest over
sound runs; the upper, the smallest the control gives.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seconds', type=float, default=4.0)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--no-control', action='store_true')
    ap.add_argument('--leaves', action='store_true',
                    help='a training cell: print each leaf\'s norms too')
    ap.add_argument('--fault', default=None,
                    help='plant a fault of harness/faults.py: the run '
                    'then reads that fault, not a sound program')
    args = ap.parse_args()
    import torch
    from harness import cli, compare, control, faults, spec
    if not torch.cuda.is_available():
        raise SystemExit('readings: needs a CUDA card')
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        keep = {}
        fault = None
        if args.fault:
            plant = dict(faults.TRAIN, **faults.SERVE)[args.fault]

            def fault(ctx, *a):
                out = plant(ctx, *a)
                keep.update(ctx.keep)
                return out
        try:
            result, compared, ctx = cli.run_cell(cell, seed, args.seconds,
                                                 False, 'cuda:0', t0, fault)
        finally:
            keep.get('undo', lambda: None)()
        rec = dict(workload=args.workload, seed=seed, fault=args.fault,
                   correct=result['correct'],
                   program={k: v['value'] for k, v in compared.items()},
                   metrics={k: v['value'] for k, v in
                            result['metrics'].items()},
                   memory_peak_bytes=result['device']['memory_peak_bytes'])
        if 'density_head' in ctx.keep:
            rec['density_head'] = ctx.keep['density_head']
        diag = (compare.train_diagnostics if 'batches' in ctx.keep
                else compare.serve_diagnostics)
        rec['diagnostics'] = diag(ctx.keep['program'],
                                  ctx.keep['reference'])
        if not args.no_control:
            torch.cuda.empty_cache()
            rec['control'] = control.numbers(ctx)
            rec['control_diagnostics'] = diag(ctx.keep['control'],
                                              ctx.keep['reference'])
        if args.leaves and 'batches' in ctx.keep:
            rec['leaves'] = {
                side: dict(grad=compare.unclipped(v).tolist(),
                           change=v['change'].tolist())
                for side, v in (('program', ctx.keep['program']),
                                ('reference', ctx.keep['reference']),
                                ('control', ctx.keep.get('control')))
                if v is not None}
            rec['leaves']['names'] = ctx.keep['reference']['names']
        rec['seconds'] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
        del ctx, result
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
