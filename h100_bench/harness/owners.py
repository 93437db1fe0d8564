"""Device time by owner: each kernel, copy and memset of a traced window
given to the program span (`server.*`, `trainer.*`, `model.*`, the
`record_function` ranges of `vampire_tpu_torch.utils.profiling`) that
launched it, from the profiler's own events.

- A device event goes, by its correlation id, to the runtime call that
  launched it (`cudaLaunchKernel`, `cudaMemcpyAsync`, ...), and by that
  call's linked correlation id to the innermost operator open at the
  launch. (Where the operator is missing, the runtime call's own thread
  and time stand in for it.)
- Forward: the owner is the innermost program span open around that
  operator on its thread.
- Backward: an operator inside an `autograd::engine::evaluate_function: …`
  range goes to the forward operator of the same `sequence_nr` on the
  range's `fwd_thread_id`, and so to that operator's span.
- Anything else is `unowned`.

`device_by_span` gives {owner: [forward s, backward s]}. Nothing here
needs a card: the events are reduced to plain `Event` tuples first
(`events_of`), which a test can write by hand."""
from __future__ import annotations

import bisect
import collections
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch

from .trace import _annotation

PREFIXES = ('server.', 'trainer.', 'model.')
BACKWARD = 'autograd::engine::evaluate_function: '
UNOWNED = 'unowned'


class Event(NamedTuple):
    name: str
    start: int                  # ns, the profiler's clock
    end: int
    device: bool                # a kernel, copy or memset on the card
    thread: int
    corr: int                   # correlation id
    linked: int                 # linked correlation id
    seq: int = -1               # autograd sequence number
    fwd_thread: int = 0


def events_of(prof) -> List[Event]:
    """A finished `torch.profiler.profile`'s events as `Event`s (the
    device side of a `record_function` range left out)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == torch.autograd.DeviceType.CUDA
        if dev and _annotation(e):
            continue
        s = e.start_ns()
        out.append(Event(e.name(), s, s + e.duration_ns(), dev,
                         e.start_thread_id(), e.correlation_id(),
                         e.linked_correlation_id(), e.sequence_nr(),
                         e.fwd_thread_id()))
    return out


def _runtime(e: Event) -> bool:
    """A CUDA runtime or driver call (the host side of a launch)."""
    return not e.device and e.corr != 0 and e.name.startswith('cu')


class Owners:
    """The owner of any moment on any host thread of the window."""

    def __init__(self, events: Iterable[Event],
                 names: Optional[Iterable[str]] = None):
        names = None if names is None else set(names)

        def program(n):
            return (n in names if names is not None
                    else n.startswith(PREFIXES))
        self.events = list(events)
        ranges = collections.defaultdict(list)
        self.ops: Dict[int, Event] = {}
        self.runtime: Dict[int, Event] = {}
        fwd_ops: Dict[Tuple[int, int], Event] = {}
        for e in self.events:
            if e.device:
                continue
            if _runtime(e):
                self.runtime[e.corr] = e
                continue
            if e.corr:
                self.ops[e.corr] = e
            if e.name.startswith(BACKWARD):
                ranges[e.thread].append((e.start, e.end,
                                         ('bwd', e.fwd_thread, e.seq)))
            elif program(e.name):
                ranges[e.thread].append((e.start, e.end, ('span', e.name)))
            elif e.seq >= 0 and not e.fwd_thread:
                fwd_ops.setdefault((e.thread, e.seq), e)
        # per thread, the innermost range at each moment as a step
        # function: the starts of its pieces and their labels
        self._steps = {t: _flatten(r) for t, r in ranges.items()}
        self._fwd = fwd_ops

    def _label(self, thread: int, t: int):
        steps = self._steps.get(thread)
        if steps is None:
            return None
        i = bisect.bisect_right(steps[0], t) - 1
        return steps[1][i] if i >= 0 else None

    def at(self, thread: int, t: int) -> Optional[Tuple[str, str]]:
        """(span, 'forward' or 'backward') owning the moment `t` on
        `thread`, or None."""
        lab = self._label(thread, t)
        if lab is None:
            return None
        if lab[0] == 'span':
            return lab[1], 'forward'
        op = self._fwd.get((lab[1], lab[2]))
        if op is None:
            return None
        fwd = self._label(op.thread, op.start)
        return (fwd[1], 'backward') if fwd and fwd[0] == 'span' else None

    def threads(self) -> List[int]:
        """The host threads on which a program span or backward range
        ran."""
        return list(self._steps)

    def split(self, thread: int, t0: int, t1: int) -> Dict[str, int]:
        """ns of [t0, t1) on `thread` under each innermost program span
        (a backward range counts as 'backward', no range as '')."""
        starts, labels = self._steps.get(thread, ([], []))
        out: Dict[str, int] = {}

        def add(lab, a, b):
            if b > a:
                name = '' if lab is None else (
                    lab[1] if lab[0] == 'span' else 'backward')
                out[name] = out.get(name, 0) + b - a
        i = bisect.bisect_right(starts, t0) - 1
        if i < 0:
            add(None, t0, min(starts[0], t1) if starts else t1)
            i = 0
        while i < len(starts) and starts[i] < t1:
            end = starts[i + 1] if i + 1 < len(starts) else t1
            add(labels[i], max(starts[i], t0), min(end, t1))
            i += 1
        return out

    def launcher(self, e: Event) -> Optional[Tuple[int, int]]:
        """(thread, time) of the launch of device event `e`: its linked
        operator's start, else its runtime call's."""
        call = self.runtime.get(e.linked) or self.runtime.get(e.corr)
        if call is None:
            return None
        op = self.ops.get(call.linked)
        return (op.thread, op.start) if op else (call.thread, call.start)

    def owner(self, e: Event) -> Tuple[str, str]:
        where = self.launcher(e)
        got = self.at(*where) if where else None
        return got or (UNOWNED, 'forward')

    def by_span(self) -> Dict[str, List[float]]:
        """{owner: [forward s, backward s]} (`device_by_span`)."""
        out: Dict[str, List[float]] = {}
        for e in self.events:
            if e.device:
                name, kind = self.owner(e)
                out.setdefault(name, [0.0, 0.0])[kind == 'backward'] += \
                    (e.end - e.start) / 1e9
        return out


def _flatten(ranges):
    """Nested (start, end, label) ranges of one thread as a step function:
    ([piece starts], [innermost label or None]). A span opened inside a
    backward range stays in the backward range's hands."""
    ranges.sort(key=lambda r: (r[0], -r[1]))
    starts, labels, stack = [], [], []

    def mark(t):
        lab = None
        for _, _, lb in reversed(stack):
            if lb[0] == 'bwd':
                lab = lb
                break
            if lab is None:
                lab = lb
        starts.append(t)
        labels.append(lab)

    for s, e, lab in ranges:
        while stack and stack[-1][1] <= s:
            end = stack.pop()[1]
            mark(end)
        stack.append((s, e, lab))
        mark(s)
    while stack:
        end = stack.pop()[1]
        mark(end)
    return starts, labels


def device_by_span(events: Iterable[Event],
                   names: Optional[Iterable[str]] = None
                   ) -> Dict[str, List[float]]:
    """{owner: [forward s, backward s]} of the device events' summed
    durations; `names`, where given, are the program's span names (other
    ranges with the prefixes, such as a benchmark's own, are then not
    owners)."""
    return Owners(events, names).by_span()
