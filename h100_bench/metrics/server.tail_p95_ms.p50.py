"""95th percentile ms over every request of the window, from its due time to its result (host clock); a failed request counts its whole wait."""
import numpy as np


def read(readings):
    v = readings.get('latency_ms')
    return float(np.percentile(v, 95)) if v is not None and len(v) else None
