"""The traced window: a `torch.profiler` window over CPU and CUDA
activity of every thread, reduced in memory to the device's busy time (the union of the
intervals in which a kernel, copy or memset ran), its top operations and
its longest idle gaps, each named by what the host was doing then (the
innermost host event that overlaps the gap most)."""
from __future__ import annotations

import collections
import time
from typing import Optional

import numpy as np
import torch


class Window:
    """Times the measured window on the host clock; with `traced`, records
    it with the profiler and, on close, fills `summary`."""

    def __init__(self, traced: bool, device):
        self.traced = traced
        self.cuda = torch.device(device).type == 'cuda'
        self.summary: Optional[dict] = None
        self._prof = None

    def __enter__(self):
        if self.traced:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts,
                                                **all_threads())
            self._prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def close(self) -> float:
        """End the window (after the caller's synchronise); its seconds."""
        self.t1 = time.perf_counter()
        self.seconds = self.t1 - self.t0
        prof, self._prof = self._prof, None
        if prof is not None:
            prof.__exit__(None, None, None)
            self.summary = summarize(prof, self.seconds)
        return self.seconds

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            self._prof = None


def all_threads() -> dict:
    """The profiler's option to record every thread (a server's work runs
    in its dispatcher thread, not the one that opens the window), where
    this torch has it."""
    try:
        return dict(experimental_config=torch._C._profiler
                    ._ExperimentalConfig(profile_all_threads=True))
    except (AttributeError, TypeError):
        return {}


def _annotation(e) -> bool:
    """Whether a device event is a `record_function` range's shadow on the
    device timeline, by what this torch's events expose."""
    kind = getattr(e, 'activity_type', None)
    if kind is not None:
        return 'annotation' in str(kind()).lower()
    user = getattr(e, 'is_user_annotation', None)
    if user is not None:
        return bool(user())
    return e.name().startswith(ANNOTATIONS) or '#' in e.name()


# the benchmark's own `record_function` ranges (spans.py, kernels.py)
ANNOTATIONS = ('bench.', 'model.', 'trainer.', 'server.')


def summarize(prof, window_s: float, top: int = 10) -> dict:
    events = prof.profiler.kineto_results.events()
    dev, host = [], []
    for e in events:
        rec = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the device side of a `record_function` range is no work
            if not _annotation(e):
                dev.append(rec)
        elif e.duration_ns() > 0:
            host.append(rec)
    by_name = collections.defaultdict(int)
    for s, t, n in dev:
        by_name[n] += t - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # the union of the device intervals, and the gaps between its pieces
    dev.sort()
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, t, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s
    gaps.sort(key=lambda g: g[0] - g[1])
    gaps = gaps[:top]
    named = []
    if host and gaps:
        hs = np.array([h[0] for h in host], np.int64)
        he = np.array([h[1] for h in host], np.int64)
        for gs, ge in gaps:
            ov = np.minimum(he, ge) - np.maximum(hs, gs)
            i = np.flatnonzero(ov > 0)
            if i.size:
                best = ov[i].max()
                cand = i[ov[i] == best]
                j = cand[np.argmin((he - hs)[cand])]
                label = host[j][2]
            else:
                label = 'no host event (Python between calls)'
            named.append([label, (ge - gs) / 1e9])
    return dict(busy_s=busy / 1e9, window_s=window_s,
                device_ops=[[n, v / 1e9] for n, v in ops],
                idle_gaps=named, device_events=len(dev))
