"""Spans taken from the benchmark's side, around calls into the program:
CUDA-event pairs for device spans (only on a card) and the host clock for
host spans. A patch is undone when its `Patches` closes. Spans record only
while `on` is set: in the traced run's window."""
from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List

import torch


class Spans:

    def __init__(self, device):
        self.cuda = torch.device(device).type == 'cuda'
        self.on = False
        self._events: Dict[str, List] = collections.defaultdict(list)
        self.host: Dict[str, List[float]] = collections.defaultdict(list)

    def device(self, name: str, fn: Callable) -> Callable:
        """`fn`, with a CUDA-event span `name` around each call."""
        def wrapped(*a, **kw):
            if not (self.on and self.cuda):
                return fn(*a, **kw)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function(name):
                e0.record()
                out = fn(*a, **kw)
                e1.record()
            self._events[name].append((e0, e1))
            return out
        return wrapped

    def hosted(self, name: str, fn: Callable) -> Callable:
        """`fn`, with a host-clock span `name` (ms) around each call."""
        def wrapped(*a, **kw):
            if not self.on:
                return fn(*a, **kw)
            with torch.profiler.record_function(name):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                self.host[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapped

    def device_ms(self) -> Dict[str, List[float]]:
        """Each device span's ms, in call order (synchronises)."""
        if self._events:
            torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v]
                for k, v in self._events.items()}


class Patches:
    """Attribute patches, undone in reverse order on close."""

    def __init__(self):
        self._undo = []

    def set(self, obj, attr: str, value) -> None:
        had = attr in vars(obj)
        old = vars(obj)[attr] if had else None
        self._undo.append((obj, attr, had, old))
        setattr(obj, attr, value)

    def close(self) -> None:
        while self._undo:
            obj, attr, had, old = self._undo.pop()
            if had:
                setattr(obj, attr, old)
            else:
                delattr(obj, attr)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
