"""Host-side (numpy) geometric transforms; the port of
`vampire_tpu/data/transforms.py`, so far only `quat_to_rot`, which the
detection evaluator needs. The rest of that module (ida/bda, depth labels,
BEV seg maps and the rasterizers behind them) comes with the data pipeline
(ROADMAP.md, Queue 1 item 3).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def quat_to_rot(q: Sequence[float]) -> np.ndarray:
    """(w, x, y, z) unit quaternion -> 3x3 rotation (pyquaternion semantics)."""
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)],
    ], dtype=np.float64)
