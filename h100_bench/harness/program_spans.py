"""Readings of the program's own spans (`vampire_tpu_torch.utils.profiling`)
in a traced window: what a per-layer metric that reads a span takes.

A run that turns the program's tracer on over its window puts the
tracer's `collect()` under `readings['program_spans']` and, where it also
reduced the profiler's events by owner (`owners.py`), the result under
`readings['trace']['device_by_span']`. Each function returns None where
the run has nothing to read: no program spans, or, for a device time, a
run on the CPU (no CUDA events, no device trace)."""
from __future__ import annotations

import statistics
from typing import List, Optional

# every span the program makes (a benchmark's own wrappers reuse some of
# these names and add others, which are then not owners)
SERVER = ('server.queue', 'server.linger', 'server.batch',
          'server.assemble', 'server.h2d', 'server.forward',
          'server.decode', 'server.d2h', 'server.nms', 'server.deliver')
TRAINER = ('trainer.to_device', 'trainer.forward', 'trainer.losses',
           'trainer.backward', 'trainer.clip', 'trainer.adamw',
           'trainer.ema', 'trainer.metrics')
MODEL = ('model.encoder', 'model.lift', 'model.trunk', 'model.queries',
         'model.rays', 'model.bev', 'model.head')
NAMES = SERVER + TRAINER + MODEL


def spans(readings: dict, name: str) -> List[dict]:
    rec = readings.get('program_spans')
    return [s for s in rec['spans'] if s['name'] == name] if rec else []


def _ms(s: dict) -> float:
    return (s['end_ns'] - s['start_ns']) / 1e6


def median_ms(readings: dict, name: str) -> Optional[float]:
    """Median host ms of the span."""
    v = [_ms(s) for s in spans(readings, name)]
    return statistics.median(v) if v else None


def median_ms_a_batch(readings: dict, name: str) -> Optional[float]:
    """Median over the window's `server.batch` spans of the span's host ms
    inside each (summed where it repeats, as `server.nms` per request)."""
    batches = spans(readings, 'server.batch')
    if not batches:
        return None
    per = {b['id']: 0.0 for b in batches}
    for s in spans(readings, name):
        if s['parent'] in per:
            per[s['parent']] += _ms(s)
    return statistics.median(per.values())


def busy_share(readings: dict) -> Optional[float]:
    """% of the window the dispatcher spent in `server.batch`."""
    b = spans(readings, 'server.batch')
    if not b or not readings.get('window_s'):
        return None
    return 100.0 * sum(_ms(s) for s in b) / 1e3 / readings['window_s']


def padded_share(readings: dict) -> Optional[float]:
    """% of the rows the window's batches computed that were padding."""
    b = spans(readings, 'server.batch')
    rows = sum(s['attrs']['rows'] + s['attrs']['padded'] for s in b)
    if not rows:
        return None
    return 100.0 * sum(s['attrs']['padded'] for s in b) / rows


def device_ms_a_unit(readings: dict, name: str) -> Optional[float]:
    """A device span's CUDA-event ms summed over the window, a unit (step
    or batch)."""
    v = [s['device_ms'] for s in spans(readings, name) if 'device_ms' in s]
    if not v or not readings.get('units'):
        return None
    return sum(v) / readings['units']


def owned_ms_a_unit(readings: dict, owner: str) -> Optional[float]:
    """Device ms a unit of the kernels, copies and memsets the owner
    launched, forward and backward (`owners.py`)."""
    by = (readings.get('trace') or {}).get('device_by_span')
    if not by or owner not in by or not readings.get('units'):
        return None
    return 1e3 * sum(by[owner]) / readings['units']
