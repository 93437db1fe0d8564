"""Circle NMS on the host in plain numpy: a frozen copy of the program's
plain version and of its per-sample post-processing."""
from __future__ import annotations

import numpy as np


def _f32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def circle_nms_reference(dets: np.ndarray, thresh: float,
                         post_max_size: int = 83) -> np.ndarray:
    """Plain numpy version of `circle_nms`."""
    dets = _f32(dets)
    n = dets.shape[0]
    order = np.argsort(-dets[:, 2], kind='stable')
    suppressed = np.zeros(n, bool)
    keep = []
    for oi in range(n):
        i = order[oi]
        if suppressed[i]:
            continue
        keep.append(i)
        if len(keep) >= post_max_size:
            break
        d = dets[order[oi + 1:], :2] - dets[i, :2]
        close = (d ** 2).sum(-1) <= thresh
        suppressed[order[oi + 1:][close]] = True
    return np.asarray(keep[:post_max_size], np.int64)


def apply_circle_nms(decoded_tasks: List[dict], cfg, batch_index: int
                     ) -> tuple:
    """Host-side post-processing of `decode_preds` outputs for one sample:
    per-task NMS + cross-task merge (bev_depth_head.py:426-494). `cfg` is
    the HeadConfig.

    Returns (boxes (M, 9), scores (M,), labels (M,)) numpy arrays.
    """
    all_boxes, all_scores, all_labels = [], [], []
    flag = 0
    for t, task in enumerate(decoded_tasks):
        boxes = np.asarray(task['bboxes'][batch_index])
        scores = np.asarray(task['scores'][batch_index])
        labels = np.asarray(task['labels'][batch_index])
        valid = np.asarray(task['valid'][batch_index])
        boxes, scores, labels = boxes[valid], scores[valid], labels[valid]
        if cfg.nms_type != 'circle':
            raise NotImplementedError(f'nms_type {cfg.nms_type!r}: the '
                                      'reference has circle NMS only')
        dets = np.concatenate([boxes[:, :2], scores[:, None]], axis=1)
        keep = circle_nms_reference(dets, float(cfg.nms_min_radius[t]),
                                    post_max_size=cfg.nms_post_max_size)
        all_boxes.append(boxes[keep])
        all_scores.append(scores[keep])
        all_labels.append(labels[keep] + flag)
        flag += len(cfg.tasks[t])
    return (np.concatenate(all_boxes) if all_boxes else np.zeros((0, 9)),
            np.concatenate(all_scores) if all_scores else np.zeros((0,)),
            np.concatenate(all_labels) if all_labels else np.zeros((0,)))
