"""Confusion-matrix IoU metrics; the port of `vampire_tpu/training/metrics.py`.

`confusion_update` accumulates on the device; `JaccardIndex` and
`format_iou_report` are the host side the trainer's epoch report uses
(numpy, copied because the JAX module imports jax).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def confusion_update(conf: torch.Tensor, preds: torch.Tensor,
                     labels: torch.Tensor,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conf + the (C, C) [true, pred] counts of (preds, labels), weighted
    by `valid`."""
    C = conf.shape[0]
    idx = labels.reshape(-1).to(torch.int64) * C + preds.reshape(-1).to(
        torch.int64)
    w = (valid.reshape(-1).to(torch.float32) if valid is not None
         else torch.ones(idx.shape, dtype=torch.float32, device=idx.device))
    binc = torch.zeros(C * C, dtype=torch.float32, device=idx.device)
    return conf + binc.index_add_(0, idx, w).reshape(C, C)


class JaccardIndex:
    """Host-side accumulator (device part = confusion_update)."""

    def __init__(self, num_classes: int, ignore_index: Optional[int] = None):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.reset()

    def reset(self):
        self.conf = np.zeros((self.num_classes, self.num_classes), np.float64)

    def update_confusion(self, conf: np.ndarray):
        conf = np.asarray(conf, np.float64)
        if self.ignore_index is not None:
            conf = conf.copy()
            conf[self.ignore_index, :] = 0.0
        self.conf += conf

    def compute(self) -> np.ndarray:
        """Per-class IoU; classes with an empty union -> nan."""
        tp = np.diag(self.conf)
        union = self.conf.sum(0) + self.conf.sum(1) - tp
        with np.errstate(divide='ignore', invalid='ignore'):
            return np.where(union > 0, tp / union, np.nan)


def format_iou_report(iou: np.ndarray, names, title: str) -> str:
    lines = [f'{title} per class iou: ']
    for n, v in zip(names, iou):
        lines.append('%s : %.2f%%' % (n, v * 100))
    return '\n'.join(lines)
