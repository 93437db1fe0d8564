"""The control: the reference in the program's place, one precision step
below the configuration's (`reference/precision.py`), on the inputs and
weights of a run that has just been checked, compared with that run's
fp32 reference by the same numbers. It has to come out not correct."""
from __future__ import annotations

from typing import Dict

from . import compare, refrun
from .drivers.train_closed import STEPS_PER_EPOCH


def numbers(ctx) -> Dict[str, float]:
    """The control's numbers for the run of `ctx` (after `run_cell`)."""
    ref = ctx.keep['reference']
    if 'batches' in ctx.keep:
        low = refrun.train(ctx.rcfg, ctx.device, ctx.weights,
                           ctx.keep['batches'], STEPS_PER_EPOCH, lower=True)
        ctx.keep['control'] = low
        return compare.train_numbers(low, ref)
    low = refrun.serve(ctx.rcfg, ctx.device, ctx.weights, ctx.keep['calib'],
                       ctx.keep['frames'], lower=True)
    ctx.keep['control'] = low
    return compare.serve_numbers(low, ref)
