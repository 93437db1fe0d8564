"""Synthetic nuScenes-shaped frames and training batches from a seed.

`camera_rig` and `synthetic_batch` are the benchmark's frozen copies of the
program's `data/synthetic.py` functions (six cameras at nuScenes-like
yaws, fx = fy = 1266 on a 1600 x 900 sensor, the val ida; i.i.d. images,
labels and boxes), so that a change to the program cannot change the
inputs it is measured on. `train_pool` and `frame_pool` draw a cell's
inputs from the run's seed.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .seeds import numpy_seed
from .target_assign import assign_targets_batch

INPUT_KEYS = ('imgs', 'sensor2ego', 'intrin', 'ida', 'bda', 'points')

_CAM_YAWS = np.deg2rad([55.0, 0.0, -55.0, 110.0, 180.0, -110.0])


def camera_rig(batch_size: int, n_cams: int = 6,
               final_dim=(256, 704), raw_hw=(900, 1600),
               seed: int = 0) -> Dict[str, np.ndarray]:
    """Returns sensor2ego / intrin / ida (B, N, 4, 4) and bda (B, 4, 4)."""
    fH, fW = final_dim
    H, W = raw_hw
    # cam optical frame (x right, y down, z fwd) -> ego (x fwd, y left, z up)
    opt2ego = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    s2e = np.tile(np.eye(4, dtype=np.float32), (batch_size, n_cams, 1, 1))
    for n in range(n_cams):
        yaw = _CAM_YAWS[n % 6]
        rz = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                       [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]], np.float32)
        s2e[:, n, :3, :3] = rz @ opt2ego
        s2e[:, n, :3, 3] = rz @ np.array([1.5, 0.0, 1.6], np.float32)
    intr = np.tile(np.eye(4, dtype=np.float32), (batch_size, n_cams, 1, 1))
    # raw-image intrinsics; the ida matrix carries the resize/crop
    intr[..., 0, 0] = 1266.0
    intr[..., 1, 1] = 1266.0
    intr[..., 0, 2] = W / 2.0
    intr[..., 1, 2] = H / 2.0
    # val-mode ida: resize = fW/W, bottom crop
    resize = fW / float(W)
    crop_h = int(H * resize) - fH
    ida = np.tile(np.eye(4, dtype=np.float32), (batch_size, n_cams, 1, 1))
    ida[..., 0, 0] = resize
    ida[..., 1, 1] = resize
    ida[..., 1, 3] = -crop_h
    bda = np.tile(np.eye(4, dtype=np.float32), (batch_size, 1, 1))
    return dict(sensor2ego=s2e, intrin=intr, ida=ida, bda=bda)


def synthetic_batch(cfg, batch_size: int = 1,
                    n_points: Optional[int] = None, n_boxes: int = 12,
                    seed: int = 0, mode: str = 'train') -> Dict[str, np.ndarray]:
    """A full training batch with the layout of training/losses.py; in any
    other `mode` without the detection targets."""
    rng = np.random.RandomState(seed)
    bc, hc, tc = cfg.backbone, cfg.head, cfg.train
    fH, fW = bc.final_dim
    N = cfg.ida_aug.n_cams
    K = bc.num_classes
    P = n_points if n_points is not None else tc.max_points
    gx, gy, gz = bc.occ_grid
    _, Yd, Xd = bc.grid_zyx('det')

    batch = dict(camera_rig(batch_size, N, bc.final_dim, seed=seed))
    batch['imgs'] = rng.randn(batch_size, N, fH, fW, 3).astype(np.float32)
    depth = np.zeros((batch_size, N, fH, fW), np.float32)
    # sparse lidar-projected depth: ~2% of pixels
    npix = int(0.02 * fH * fW)
    for b in range(batch_size):
        for n in range(N):
            ui = rng.randint(0, fW, npix)
            vi = rng.randint(0, fH, npix)
            depth[b, n, vi, ui] = rng.uniform(bc.d_bound[0], bc.d_bound[1], npix)
    batch['depth_labels'] = depth
    batch['seg_labels'] = rng.randint(0, K - 1, (batch_size, N, fH, fW)).astype(np.int32)
    batch['bev_seg'] = rng.randint(0, K - 1, (batch_size, Yd, Xd)).astype(np.int32)
    batch['bev_height'] = rng.uniform(-2, 2, (batch_size, Yd, Xd)).astype(np.float32)
    batch['bev_mask'] = rng.rand(batch_size, Yd, Xd) > 0.5

    x_ext = bc.x_bound_seg[1]
    pts = rng.uniform(-x_ext * 1.1, x_ext * 1.1, (batch_size, P, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(bc.z_bound_seg[0], bc.z_bound_seg[1], (batch_size, P))
    batch['points'] = pts
    batch['point_labels'] = rng.randint(0, 17, (batch_size, P)).astype(np.int32)
    pv = np.ones((batch_size, P), bool)
    pv[:, int(P * 0.9):] = False  # simulate padding tail
    batch['point_valid'] = pv

    sem = rng.randint(0, K, (batch_size, gx, gy, gz)).astype(np.int32)
    batch['occ_semantics'] = sem
    batch['occ_density_labels'] = (sem != K - 1).astype(np.float32)
    batch['mask_camera'] = rng.rand(batch_size, gx, gy, gz) > 0.4
    batch['mask_lidar'] = rng.rand(batch_size, gx, gy, gz) > 0.4

    if mode == 'train':
        gt_boxes, gt_labels = [], []
        for b in range(batch_size):
            m = n_boxes
            boxes = np.zeros((m, 9), np.float32)
            boxes[:, 0:2] = rng.uniform(-x_ext * 0.8, x_ext * 0.8, (m, 2))
            boxes[:, 2] = rng.uniform(-1.5, 0.5, m)
            boxes[:, 3:6] = rng.uniform(0.5, 4.0, (m, 3))
            boxes[:, 6] = rng.uniform(-np.pi, np.pi, m)
            boxes[:, 7:9] = rng.uniform(-2, 2, (m, 2))
            gt_boxes.append(boxes)
            gt_labels.append(rng.randint(0, 10, m).astype(np.int64))
        batch.update(assign_targets_batch(gt_boxes, gt_labels, hc))
    return batch


def train_pool(cfg, rows: int, size: int, seed: int
               ) -> List[Dict[str, np.ndarray]]:
    """`size` training batches of `rows` rows each, every row drawn from
    its own stream of `seed`, so that no two rows of the pool are alike."""
    out = []
    for i in range(size):
        rows_ = [synthetic_batch(cfg, batch_size=1,
                                 n_points=cfg.train.max_points,
                                 seed=numpy_seed(seed, 'train', i, r),
                                 mode='train') for r in range(rows)]
        out.append({k: np.concatenate([b[k] for b in rows_])
                    for k in rows_[0]})
    return out


def frame_pool(cfg, size: int, seed: int, tag: str = 'serve'
               ) -> List[Dict[str, np.ndarray]]:
    """`size` single val-mode frames (the served inputs: images, camera
    matrices, points), each from its own stream of `seed`."""
    out = []
    for i in range(size):
        b = synthetic_batch(cfg, batch_size=1, n_points=cfg.train.max_points,
                            seed=numpy_seed(seed, tag, i), mode='val')
        out.append({k: np.asarray(b[k])[0] for k in INPUT_KEYS})
    return out
