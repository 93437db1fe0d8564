"""LiDAR segmentation submission writer (base_exp.py:823-848); the port's
copy of `vampire_tpu/evaluation/lidarseg.py` (numpy, host side).

Votes per-point logits back onto the reference cloud (the reference uses
`index_add_` with an identity ref_index — see nusc_det_seg_dataset.py:294-310),
takes argmax over classes 1..16, asserts the label range, and writes
`<lidar_token>_lidarseg.bin` files plus the meta submission.json.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np


def lidarseg_labels(pts_logits: np.ndarray,
                    num_points: int,
                    ref_index: Optional[np.ndarray] = None) -> np.ndarray:
    """(P, K) padded logits -> (num_points,) uint8 labels in 1..16."""
    logits = np.asarray(pts_logits, np.float32)[:num_points]
    if ref_index is not None:
        out = np.zeros((num_points, logits.shape[-1]), np.float32)
        np.add.at(out, np.asarray(ref_index)[:num_points], logits)
        logits = out
    labels = logits[:, 1:-1].argmax(axis=1) + 1
    return labels.astype(np.uint8)


def write_submission(results, submit_dir: str, split: str = 'test') -> None:
    """results: iterable of (lidar_token, labels uint8)."""
    os.makedirs(os.path.join(submit_dir, split), exist_ok=True)
    meta = {'meta': {'use_camera': True, 'use_lidar': False, 'use_map': False,
                     'use_radar': False, 'use_external': False}}
    with open(os.path.join(submit_dir, split, 'submission.json'), 'w') as f:
        json.dump(meta, f)
    out_dir = os.path.join(submit_dir, 'lidarseg', split)
    os.makedirs(out_dir, exist_ok=True)
    for token, labels in results:
        assert ((labels > 0) & (labels < 17)).all(), \
            'predictions must be between 1 and 16 (inclusive)'
        labels.tofile(os.path.join(out_dir, f'{token}_lidarseg.bin'))
