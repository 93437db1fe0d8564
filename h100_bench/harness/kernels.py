"""Calls of the program's lift and ray ops in the traced window: each
call's CUDA-event span, and the arguments of the last calls (the last
step's or batch's), whose byte bounds are counted after the window
(`roofline.py`): the share of the bound that the op reached there."""
from __future__ import annotations

import collections
from typing import Callable, Dict

import torch

from . import roofline


class OpCalls:

    def __init__(self, spans, keep: int):
        self.spans = spans
        self.calls: Dict[str, collections.deque] = {}
        self.keep = keep

    def wrap(self, name: str, fn: Callable, args_of: Callable,
             bytes_of: Callable) -> Callable:
        calls = self.calls.setdefault(name, collections.deque(
            maxlen=self.keep))

        def wrapped(*a, **kw):
            if not (self.spans.on and self.spans.cuda):
                return fn(*a, **kw)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function('bench.' + name):
                e0.record()
                out = fn(*a, **kw)
                e1.record()
            calls.append((e0, e1, args_of(*a), bytes_of))
            return out
        return wrapped

    def share(self, names) -> Dict[str, float]:
        """{'bound_ms', 'ms', 'calls'} summed over the kept calls of
        `names`; empty where none ran."""
        kept = [c for n in names for c in self.calls.get(n, ())]
        if not kept:
            return {}
        torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b, _, _ in kept)
        bound = sum(roofline.bound_ms(f(*args)) for _, _, args, f in kept)
        return dict(bound_ms=bound, ms=ms, calls=len(kept))

    def clear(self) -> None:
        self.calls.clear()


def install(patches, ops: OpCalls, program, backward: bool) -> None:
    """Wrap the program's lift and ray autograd functions (forward, and
    the backward where the cell trains)."""
    lift = program.lift_module
    rays = program.rays_module
    LF, RR = lift.LiftFrame, rays.RenderRays
    patches.set(LF, 'forward', ops.wrap(
        'lift.forward', LF.forward,
        lambda ctx, depth, feat, ids, coords, valid, n_blocks, *r:
            (depth, feat, ids, coords, valid, n_blocks),
        roofline.lift_forward_bytes))
    patches.set(RR, 'forward', ops.wrap(
        'rays.forward', RR.forward,
        lambda ctx, field, beta, coords, valid, deltas, mids, *r:
            (field, coords, valid, deltas, mids),
        roofline.ray_forward_bytes))
    if backward:
        def lift_saved(ctx, g_numer, *r):
            depth, feat, ids, coords, valid = ctx.saved_tensors
            return depth, feat, ids, coords, valid, g_numer.shape[0]

        def ray_saved(ctx, *r):
            field, _, coords, valid, deltas, mids, _ = ctx.saved_tensors
            return field, coords, valid, deltas, mids
        patches.set(LF, 'backward', ops.wrap(
            'lift.backward', LF.backward, lift_saved,
            roofline.lift_backward_bytes))
        patches.set(RR, 'backward', ops.wrap(
            'rays.backward', RR.backward, ray_saved,
            roofline.ray_backward_bytes))
