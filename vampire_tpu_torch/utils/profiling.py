"""The port's tracing: named spans at the layer boundaries of the server
(`server.*`), the train step (`trainer.*`) and the model (`model.*`), kept
in memory; and the Chrome-trace exporter of a `torch.profiler` window.

    profiling.enable()              # clears what an earlier window kept
    ...                             # serve, train
    profiling.disable()
    rec = profiling.collect()       # {'spans', 'dropped', 'clock_offset_ns'}

Off, the default, a span site costs a module-level flag check: `span`
returns one shared null context and `begin` returns None; no clock is read,
no CUDA event made, no `record_function` entered.

On, each span records its name, start and end on `time.perf_counter_ns`,
its thread (`threading.get_native_id`), its parent (the span open around
it on the same thread) and its attributes. A span made with `device=True`
also records a CUDA-event pair on the current stream (where CUDA is
initialised), resolved to `device_ms` by one synchronise in `collect`.
`span` also enters a `torch.profiler.record_function` range of its name,
so that under a profiler window the span sits on the profiler's host
timeline, the clock its kernels are stamped on: adding `clock_offset_ns`
to a span's `perf_counter_ns` places it there. `begin`/`end` make a span
that starts on one thread and ends on another (a request's time in the
server's queue): it lives only in memory, with no profiler range, and is
no thread's parent.

At most `MAX_SPANS` are kept a window; past that `dropped` counts the
rest.

`trace(logdir)` is a `torch.profiler` window that writes a Chrome trace
JSON into `logdir`; `named_scope` labels a section in such a trace.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import List, Optional

import torch

named_scope = torch.profiler.record_function

MAX_SPANS = 200_000

_ON = False
_lock = threading.Lock()
_kept: List['Span'] = []
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The context every span site gets while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    st = getattr(_local, 'stack', None)
    if st is None:
        st = _local.stack = []
    return st


class Span:
    """One span while tracing is on: the context `span` returns and the
    token `begin` returns. `attrs` may be added to until it ends."""
    __slots__ = ('id', 'name', 'attrs', 'parent', 'thread', 'start_ns',
                 'end_ns', '_device', '_events', '_range')

    def __init__(self, name: str, attrs: dict, device: bool = False):
        self.id = next(_ids)
        self.name = name
        self.attrs = attrs
        self.parent = None
        self.thread = threading.get_native_id()
        self.start_ns = self.end_ns = None
        self._device = device
        self._events = self._range = None

    def _open(self) -> None:
        st = _stack()
        self.parent = st[-1].id if st else None
        self.start_ns = time.perf_counter_ns()

    # The clock is read outside the profiler range, whose own stamps come
    # from inside its enter and exit: the span holds the range.
    def __enter__(self):
        self._open()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        _stack().append(self)
        if self._device and torch.cuda.is_initialized():
            self._events = [torch.cuda.Event(enable_timing=True)]
            self._events[0].record()
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events.append(torch.cuda.Event(enable_timing=True))
            self._events[1].record()
        _stack().pop()
        self._range.__exit__(*exc)
        self._close()
        return False

    def _close(self) -> None:
        self.end_ns = time.perf_counter_ns()
        _keep(self)


def _keep(sp: Span) -> None:
    global _dropped
    with _lock:
        if len(_kept) < MAX_SPANS:
            _kept.append(sp)
        else:
            _dropped += 1


def span(name: str, device: bool = False, **attrs):
    """A context over the block: a `Span` while tracing is on (its value
    under `with ... as`), else the shared null context (value None).
    `device=True` adds the CUDA-event pair."""
    if not _ON:
        return _OFF
    return Span(name, attrs, device)


def begin(name: str, **attrs) -> Optional[Span]:
    """Open a span that `end` closes, on any thread; None while off."""
    if not _ON:
        return None
    sp = Span(name, attrs)
    sp._open()
    return sp


def end(sp: Optional[Span]) -> None:
    """Close what `begin` returned (None: nothing to do)."""
    if sp is not None:
        sp._close()


def enable() -> None:
    """Start keeping spans, dropping those of an earlier window."""
    global _ON, _dropped
    with _lock:
        _kept.clear()
        _dropped = 0
    _ON = True


def disable() -> None:
    """Stop opening spans; those open now still end and are kept."""
    global _ON
    _ON = False


def clock_offset_ns() -> int:
    """Unix-epoch ns (the profiler's host clock) less `perf_counter_ns`,
    read in the narrowest of five brackets."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


def collect() -> dict:
    """The ended spans kept since `enable`, in the order they ended, as
    dicts (`id`, `name`, `parent`, `thread`, `start_ns`, `end_ns`,
    `attrs`, and `device_ms` for a device span), with `dropped` and
    `clock_offset_ns`. Synchronises once if a device span was kept."""
    with _lock:
        kept, dropped = list(_kept), _dropped
    if any(s._events for s in kept):
        torch.cuda.synchronize()
    out = []
    for s in kept:
        d = dict(id=s.id, name=s.name, parent=s.parent, thread=s.thread,
                 start_ns=s.start_ns, end_ns=s.end_ns, attrs=dict(s.attrs))
        if s._events:
            d['device_ms'] = s._events[0].elapsed_time(s._events[1])
        out.append(d)
    return dict(spans=out, dropped=dropped, clock_offset_ns=clock_offset_ns())


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
