"""Profiling helpers; the port of `vampire_tpu/utils/profiling.py`
(reference: Lightning profiler='simple' and the cuda-synchronised
`run_time` decorator, src/utils/bricks.py:7-19).

`run_time(name)` times a call on the host clock after waiting for its
outputs (it synchronises every CUDA device that holds a tensor it
returned, where the JAX one blocks on its arrays) and keeps running
averages (`timing_summary`); `trace(logdir)` is a `torch.profiler` window
that writes a Chrome trace JSON into `logdir`; `named_scope` labels a
section in such a trace.
"""
from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Callable, Dict

import torch

named_scope = torch.profiler.record_function

_TIMINGS: Dict[str, list] = defaultdict(lambda: [0.0, 0])


def _cuda_devices(tree, into):
    """The CUDA devices of the tensors in a nest of tuples, lists and
    dicts."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            into.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, into)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, into)
    return into


def run_time(name: str):
    """Decorator: the call's host-clock time once its outputs are ready,
    printed with the running average of `name` (bricks.py:7-19)."""
    def deco(fn: Callable):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            for dev in _cuda_devices(out, set()):
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            acc = _TIMINGS[name]
            acc[0] += dt
            acc[1] += 1
            print(f'{name}: {dt * 1000:.1f}ms '
                  f'(avg {acc[0] / acc[1] * 1000:.1f}ms over {acc[1]})')
            return out
        return wrapped
    return deco


def timing_summary() -> Dict[str, float]:
    return {k: v[0] / max(v[1], 1) for k, v in _TIMINGS.items()}


@contextlib.contextmanager
def trace(logdir: str, device: str = 'cuda'):
    """A `torch.profiler.profile` window over the block, CPU and CUDA
    activities, whose Chrome trace is written on exit to
    `<logdir>/trace_<pid>_<ns>.json` (the path in the yielded profiler's
    `trace_path`). `device='cpu'`, for work on CPU tensors, records the
    CPU activity alone; on 'cuda' without a card it raises rather than
    drop the device activity."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('trace: device cuda but no CUDA device; pass '
                               "device='cpu' to trace CPU work")
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    path = os.path.join(logdir,
                        f'trace_{os.getpid()}_{time.time_ns()}.json')
    prof.export_chrome_trace(path)
    prof.trace_path = path
