"""What the per-layer readers (`metrics/<name>.py`) share. Each takes the
run's readings and returns the metric, or None where the run has nothing
to read (a CPU run has no device spans and no device trace)."""
from __future__ import annotations

import statistics
from typing import Optional


def per_unit_ms(readings: dict, span: str) -> Optional[float]:
    """A device span's ms a step (or a batch): its sum over the window's
    units."""
    v = readings.get('device_spans', {}).get(span)
    if not v or not readings.get('units'):
        return None
    return sum(v) / readings['units']


def median_ms(readings: dict, key: str, device: bool = False
              ) -> Optional[float]:
    v = (readings.get('device_spans', {}).get(key) if device
         else readings.get(key))
    return statistics.median(v) if v else None


def roofline_share(readings: dict, op: str) -> Optional[float]:
    """% of the op's byte bound reached over its kept calls."""
    r = readings.get(op)
    if not r or r['ms'] <= 0:
        return None
    return 100.0 * r['bound_ms'] / r['ms']


def idle_share(readings: dict) -> Optional[float]:
    t = readings.get('trace')
    if not t or t['busy_s'] <= 0:
        return None
    return 100.0 * (1.0 - t['busy_s'] / t['window_s'])


def mfu(readings: dict) -> Optional[float]:
    """% of the card's peak: the units' least time over the window's."""
    t = readings.get('trace')
    least = readings.get('least_s_per_unit')
    if not t or t['busy_s'] <= 0 or not least:
        return None
    return 100.0 * readings['units'] * least / readings['window_s']
