"""Host NMS of the decoded boxes, the per-sample post-processing that the
server runs after `decode_preds`, and the input pipeline's rasterizers.

`circle_nms`, `size_aware_circle_nms`, `rotated_nms`, `rasterize_depth`
and `rasterize_bev` call the C++ library `csrc/host.cpp`, built with the
host C++ compiler into build/vampire_tpu_torch/ at first use
(`_build.load_host_library`). A failed build raises: nothing falls back.
The numpy loops beside them (`*_reference`) are the plain versions, which
the tests hold the C++ to; both are copies of the JAX package's
`vampire_tpu/ops/nms.py`.
`apply_circle_nms` is the copy of `vampire_tpu/evaluation/
det_evaluator.py::apply_circle_nms`.
"""
from __future__ import annotations

import ctypes
from typing import List

import numpy as np

from . import _build

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int)


def _lib() -> ctypes.CDLL:
    lib = _build.load_host_library('host')
    lib.circle_nms.restype = ctypes.c_int
    lib.circle_nms.argtypes = [_F32P, ctypes.c_int, ctypes.c_float,
                               ctypes.c_int, _I32P]
    lib.size_aware_circle_nms.restype = ctypes.c_int
    lib.size_aware_circle_nms.argtypes = [_F32P, ctypes.c_int, ctypes.c_float,
                                          ctypes.c_int, _I32P]
    lib.rotated_nms.restype = ctypes.c_int
    lib.rotated_nms.argtypes = [_F32P, _F32P, ctypes.c_int, ctypes.c_float,
                                ctypes.c_int, _I32P]
    lib.rasterize_depth.restype = None
    lib.rasterize_depth.argtypes = [_F32P, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, _F32P, _F32P]
    lib.rasterize_bev.restype = None
    lib.rasterize_bev.argtypes = [_F32P, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, _F32P, _F32P, _F32P]
    return lib


def _f32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def circle_nms(dets: np.ndarray, thresh: float,
               post_max_size: int = 83) -> np.ndarray:
    """dets: (N, 3) [x, y, score]; thresh compares squared distance.
    Returns kept indices (score-descending order)."""
    dets = _f32(dets)
    if dets.shape[0] == 0:
        return np.zeros((0,), np.int64)
    keep = np.zeros((post_max_size,), np.int32)
    cnt = _lib().circle_nms(_ptr(dets, _F32P), dets.shape[0], float(thresh),
                            post_max_size, _ptr(keep, _I32P))
    return keep[:cnt].astype(np.int64)


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


def size_aware_circle_nms(dets: np.ndarray, thresh_scale: float,
                          post_max_size: int = 83) -> np.ndarray:
    """dets: (N, 6) [x, y, dx, dy, yaw, score] (bev_depth_head.py:33-82)."""
    dets = _f32(dets)
    if dets.shape[0] == 0:
        return np.zeros((0,), np.int64)
    keep = np.zeros((post_max_size,), np.int32)
    cnt = _lib().size_aware_circle_nms(
        _ptr(dets, _F32P), dets.shape[0], float(thresh_scale), post_max_size,
        _ptr(keep, _I32P))
    return keep[:cnt].astype(np.int64)


def size_aware_circle_nms_reference(dets: np.ndarray, thresh_scale: float,
                                    post_max_size: int = 83) -> np.ndarray:
    """Plain numpy version of `size_aware_circle_nms`."""
    dets = _f32(dets)
    n = dets.shape[0]
    order = np.argsort(-dets[:, 5], kind='stable')
    suppressed = np.zeros(n, bool)
    keep = []
    x, y, dx, dy, yaw = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3], dets[:, 4]
    for oi in range(n):
        i = order[oi]
        if suppressed[i]:
            continue
        keep.append(i)
        if len(keep) >= post_max_size:
            break
        for oj in range(oi + 1, n):
            j = order[oj]
            if suppressed[j]:
                continue
            dist_x = abs(x[i] - x[j])
            dist_y = abs(y[i] - y[j])
            th_x = (abs(dx[i] * np.cos(yaw[i])) + abs(dx[j] * np.cos(yaw[j]))
                    + abs(dy[i] * np.sin(yaw[i])) + abs(dy[j] * np.sin(yaw[j])))
            th_y = (abs(dx[i] * np.sin(yaw[i])) + abs(dx[j] * np.sin(yaw[j]))
                    + abs(dy[i] * np.cos(yaw[i])) + abs(dy[j] * np.cos(yaw[j])))
            if dist_x <= th_x * thresh_scale / 2 and \
               dist_y <= th_y * thresh_scale / 2:
                suppressed[j] = True
    return np.asarray(keep[:post_max_size], np.int64)


def _rect_corners_np(boxes: np.ndarray) -> np.ndarray:
    """(N, 5) [cx, cy, w, h, yaw] -> (N, 4, 2) CCW corners."""
    c, s = np.cos(boxes[:, 4]), np.sin(boxes[:, 4])
    hw, hh = boxes[:, 2] / 2, boxes[:, 3] / 2
    dx = np.stack([-hw, hw, hw, -hw], 1)
    dy = np.stack([-hh, -hh, hh, hh], 1)
    x = boxes[:, 0:1] + dx * c[:, None] - dy * s[:, None]
    y = boxes[:, 1:2] + dx * s[:, None] + dy * c[:, None]
    return np.stack([x, y], -1)


def _rect_iou_np(b1: np.ndarray, b2: np.ndarray) -> float:
    """Rotated-rectangle IoU by Sutherland-Hodgman clipping, in float64 as
    the C++ computes it."""
    poly = [tuple(p) for p in _rect_corners_np(b1[None].astype(np.float64))[0]]
    clipper = _rect_corners_np(b2[None].astype(np.float64))[0]
    for e in range(4):
        ax, ay = clipper[e]
        bx, by = clipper[(e + 1) % 4]
        out = []
        for i in range(len(poly)):
            cx, cy = poly[i]
            nx, ny = poly[(i + 1) % len(poly)]
            dc = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
            dn = (bx - ax) * (ny - ay) - (by - ay) * (nx - ax)
            if dc >= 0:
                out.append((cx, cy))
            if (dc >= 0) != (dn >= 0):
                t = dc / (dc - dn)
                out.append((cx + t * (nx - cx), cy + t * (ny - cy)))
        poly = out
        if not poly:
            break
    inter = 0.0
    for i in range(len(poly)):
        x0, y0 = poly[i]
        x1, y1 = poly[(i + 1) % len(poly)]
        inter += x0 * y1 - x1 * y0
    inter = abs(inter) / 2
    union = float(b1[2]) * b1[3] + float(b2[2]) * b2[3] - inter
    return inter / union if union > 0 else 0.0


def rotated_nms(boxes: np.ndarray, scores: np.ndarray, thresh: float,
                post_max_size: int = 83) -> np.ndarray:
    """Greedy rotated-BEV-IoU NMS (mmdet3d `nms_gpu` semantics, the
    reference's nms_type='rotate' branch). boxes: (N, 5) [cx, cy, w, h,
    yaw]; scores: (N,). Returns kept indices in score-descending order."""
    boxes = _f32(boxes)
    scores = _f32(scores)
    if boxes.shape[0] == 0:
        return np.zeros((0,), np.int64)
    keep = np.zeros((post_max_size,), np.int32)
    cnt = _lib().rotated_nms(_ptr(boxes, _F32P), _ptr(scores, _F32P),
                             boxes.shape[0], float(thresh), post_max_size,
                             _ptr(keep, _I32P))
    return keep[:cnt].astype(np.int64)


def rotated_nms_reference(boxes: np.ndarray, scores: np.ndarray,
                          thresh: float, post_max_size: int = 83
                          ) -> np.ndarray:
    """Plain numpy version of `rotated_nms`."""
    boxes = _f32(boxes)
    scores = _f32(scores)
    n = boxes.shape[0]
    order = np.argsort(-scores, kind='stable')
    suppressed = np.zeros(n, bool)
    keep = []
    for oi in range(n):
        i = order[oi]
        if suppressed[i]:
            continue
        keep.append(i)
        if len(keep) >= post_max_size:
            break
        for oj in range(oi + 1, n):
            j = order[oj]
            if not suppressed[j] and _rect_iou_np(boxes[i], boxes[j]) > thresh:
                suppressed[j] = True
    return np.asarray(keep[:post_max_size], np.int64)


def _rows4(a: np.ndarray) -> np.ndarray:
    a = _f32(a)
    if a.ndim != 2 or a.shape[1] != 4:
        raise ValueError(f'expected (N, 4) rows, got {a.shape}')
    return a


def rasterize_depth(uvdl: np.ndarray, h: int, w: int):
    """(N, 4) [u, v, depth, label] -> (depth (h, w), label (h, w)) fp32;
    the nearest point wins each pixel (depth_transform,
    nusc_det_seg_dataset.py:178-231)."""
    uvdl = _rows4(uvdl)
    depth = np.zeros((h, w), np.float32)
    label = np.zeros((h, w), np.float32)
    if uvdl.shape[0]:
        _lib().rasterize_depth(_ptr(uvdl, _F32P), uvdl.shape[0], h, w,
                               _ptr(depth, _F32P), _ptr(label, _F32P))
    return depth, label


def rasterize_depth_reference(uvdl: np.ndarray, h: int, w: int):
    """Plain numpy version of `rasterize_depth`: farthest point first (a
    stable sort keeps ties in input order), coordinates truncated toward
    zero."""
    uvdl = _rows4(uvdl)
    depth = np.zeros((h, w), np.float32)
    label = np.zeros((h, w), np.float32)
    for k in np.argsort(-uvdl[:, 2], kind='stable'):
        u, v = int(uvdl[k, 0]), int(uvdl[k, 1])
        if 0 <= u < w and 0 <= v < h:
            depth[v, u] = uvdl[k, 2]
            label[v, u] = uvdl[k, 3]
    return depth, label


def rasterize_bev(xyzl: np.ndarray, gh: int, gw: int):
    """(N, 4) [ix, iy, z, label] -> (seg, height, mask), each (gh, gw)
    fp32; the highest point wins each cell (get_bev_seg_map,
    nusc_det_seg_dataset.py:233-265)."""
    xyzl = _rows4(xyzl)
    seg = np.zeros((gh, gw), np.float32)
    height = np.zeros((gh, gw), np.float32)
    mask = np.zeros((gh, gw), np.float32)
    if xyzl.shape[0]:
        _lib().rasterize_bev(_ptr(xyzl, _F32P), xyzl.shape[0], gh, gw,
                             _ptr(seg, _F32P), _ptr(height, _F32P),
                             _ptr(mask, _F32P))
    return seg, height, mask


def rasterize_bev_reference(xyzl: np.ndarray, gh: int, gw: int):
    """Plain numpy version of `rasterize_bev`: lowest point first (stable),
    coordinates truncated toward zero."""
    xyzl = _rows4(xyzl)
    seg = np.zeros((gh, gw), np.float32)
    height = np.zeros((gh, gw), np.float32)
    mask = np.zeros((gh, gw), np.float32)
    for k in np.argsort(xyzl[:, 2], kind='stable'):
        ix, iy = int(xyzl[k, 0]), int(xyzl[k, 1])
        if 0 <= ix < gw and 0 <= iy < gh:
            seg[iy, ix] = xyzl[k, 3]
            height[iy, ix] = xyzl[k, 2]
            mask[iy, ix] = 1.0
    return seg, height, mask


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
        if cfg.nms_type == 'circle':
            dets = np.concatenate([boxes[:, :2], scores[:, None]], axis=1)
            keep = circle_nms(dets, float(cfg.nms_min_radius[t]),
                              post_max_size=cfg.nms_post_max_size)
        elif cfg.nms_type == 'rotate':
            # the pre_max_size score cap before NMS; score_threshold and
            # post_center_range are applied on the device by decode_preds
            if len(scores) > cfg.nms_pre_max_size:
                top = np.argsort(-scores)[:cfg.nms_pre_max_size]
                boxes, scores, labels = boxes[top], scores[top], labels[top]
            keep = rotated_nms(boxes[:, [0, 1, 3, 4, 6]], scores,
                               float(cfg.nms_thr),
                               post_max_size=cfg.nms_post_max_size)
        else:
            dets = np.concatenate([boxes[:, [0, 1, 3, 4, 6]],
                                   scores[:, None]], axis=1)
            keep = size_aware_circle_nms(dets, float(cfg.nms_thr),
                                         post_max_size=cfg.nms_post_max_size)
        all_boxes.append(boxes[keep])
        all_scores.append(scores[keep])
        all_labels.append(labels[keep] + flag)
        flag += len(cfg.tasks[t])
    return (np.concatenate(all_boxes) if all_boxes else np.zeros((0, 9)),
            np.concatenate(all_scores) if all_scores else np.zeros((0,)),
            np.concatenate(all_labels) if all_labels else np.zeros((0,)))
