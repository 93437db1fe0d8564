"""Host-side CenterPoint target assignment (numpy).

The benchmark's frozen copy of the program's `ops/target_assign.py`, so
that a change to the program cannot change the targets of the synthetic
training batches. It re-derives
the reference's `BEVDepthHead.get_targets_single` (bev_depth_head.py:168-319)
plus the mmdet3d helpers it imports (`gaussian_radius`,
`draw_heatmap_gaussian`). Targets depend only on GT boxes + labels (not
activations), so they are computed in the input pipeline and shipped to the
device as fixed-shape arrays.

Output key layout (per task t, stacked over the batch by the collate):
  heatmap_{t}: (ncls_t, H, W) fp32       (channels-last on device: (H, W, ncls))
  anno_box_{t}: (max_objs, 10) fp32      [dx, dy, z, log(dim)x3, sin, cos, vx, vy]
  ind_{t}: (max_objs,) int32             (y * W + x)
  mask_{t}: (max_objs,) fp32
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np



def gaussian_radius(det_size: Tuple[float, float], min_overlap: float = 0.5
                    ) -> float:
    """mmdet3d.core.gaussian_radius (CornerNet)."""
    height, width = det_size
    a1 = 1
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    sq1 = np.sqrt(b1 ** 2 - 4 * a1 * c1)
    r1 = (b1 + sq1) / 2
    a2 = 4
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    sq2 = np.sqrt(b2 ** 2 - 4 * a2 * c2)
    r2 = (b2 + sq2) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    sq3 = np.sqrt(b3 ** 2 - 4 * a3 * c3)
    r3 = (b3 + sq3) / 2
    return min(r1, r2, r3)


def _gaussian_2d(shape: Tuple[int, int], sigma: float = 1.0) -> np.ndarray:
    m, n = [(s - 1.0) / 2.0 for s in shape]
    y, x = np.ogrid[-m:m + 1, -n:n + 1]
    h = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def draw_heatmap_gaussian(heatmap: np.ndarray, center: Sequence[int],
                          radius: int, k: float = 1.0) -> None:
    """mmdet3d.core.draw_heatmap_gaussian; in-place max-blend."""
    diameter = 2 * radius + 1
    gaussian = _gaussian_2d((diameter, diameter), sigma=diameter / 6.0)
    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape
    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)
    masked_hm = heatmap[y - top:y + bottom, x - left:x + right]
    masked_g = gaussian[radius - top:radius + bottom,
                        radius - left:radius + right]
    if min(masked_g.shape) > 0 and min(masked_hm.shape) > 0:
        np.maximum(masked_hm, masked_g * k, out=masked_hm)


def assign_targets_single(gt_boxes: np.ndarray, gt_labels: np.ndarray,
                          cfg: HeadConfig) -> Dict[str, np.ndarray]:
    """Targets for one sample.

    Args:
      gt_boxes: (M, 9) [x, y, z, w, l, h, rot, vx, vy] in the bda'd ego frame.
      gt_labels: (M,) global class ids (order of configs.DET_CLASSES).
    """
    max_objs = cfg.max_objs
    W, H = cfg.feature_map_size
    vx_sz, vy_sz = cfg.voxel_size[0], cfg.voxel_size[1]
    osf = cfg.out_size_factor
    out: Dict[str, np.ndarray] = {}
    flag = 0
    for t, task in enumerate(cfg.tasks):
        ncls = len(task)
        heatmap = np.zeros((H, W, ncls), np.float32)
        anno_box = np.zeros((max_objs, len(cfg.code_weights)), np.float32)
        ind = np.zeros((max_objs,), np.int64)
        mask = np.zeros((max_objs,), np.float32)
        # boxes whose global label falls in this task, local ids 0..ncls-1
        sel = [i for i in range(len(gt_labels))
               if flag <= gt_labels[i] < flag + ncls]
        num_objs = min(len(sel), max_objs)
        for k in range(num_objs):
            i = sel[k]
            cls_id = int(gt_labels[i]) - flag
            width = gt_boxes[i, 3] / vx_sz / osf
            length = gt_boxes[i, 4] / vy_sz / osf
            if width <= 0 or length <= 0:
                continue
            radius = gaussian_radius((length, width),
                                     min_overlap=cfg.gaussian_overlap)
            radius = max(cfg.min_radius, int(radius))
            x, y, z = gt_boxes[i, 0], gt_boxes[i, 1], gt_boxes[i, 2]
            coor_x = (x - cfg.pc_range[0]) / vx_sz / osf
            coor_y = (y - cfg.pc_range[1]) / vy_sz / osf
            cx_int, cy_int = int(coor_x), int(coor_y)
            if not (0 <= cx_int < W and 0 <= cy_int < H):
                continue
            draw_heatmap_gaussian(heatmap[:, :, cls_id], (cx_int, cy_int),
                                  radius)
            ind[k] = cy_int * W + cx_int
            mask[k] = 1.0
            rot = gt_boxes[i, 6]
            box_dim = gt_boxes[i, 3:6]
            if cfg.norm_bbox:
                box_dim = np.log(box_dim)
            anno_box[k] = np.concatenate([
                np.array([coor_x - cx_int, coor_y - cy_int, z], np.float32),
                box_dim.astype(np.float32),
                np.array([np.sin(rot), np.cos(rot)], np.float32),
                gt_boxes[i, 7:9].astype(np.float32),
            ])
        out[f'heatmap_{t}'] = heatmap
        out[f'anno_box_{t}'] = anno_box
        out[f'ind_{t}'] = ind.astype(np.int32)
        out[f'mask_{t}'] = mask
        flag += ncls
    return out


def assign_targets_batch(gt_boxes: List[np.ndarray],
                         gt_labels: List[np.ndarray],
                         cfg: HeadConfig) -> Dict[str, np.ndarray]:
    """Stack per-sample targets over the batch axis."""
    per = [assign_targets_single(b, l, cfg)
           for b, l in zip(gt_boxes, gt_labels)]
    return {k: np.stack([p[k] for p in per]) for k in per[0]}
