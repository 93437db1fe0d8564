"""Synthetic nuScenes-shaped batches: camera rigs, labels, detection targets.

The port's own copy of `camera_rig`, `synthetic_batch` and `tiny_config` of
the JAX package's `vampire_tpu/data/synthetic.py`: the same numpy draws in
the same order, so both packages make the same arrays from a seed
(tests/test_torch_host.py). Geometry matches the real rig closely enough
that projections land in-frame: six cameras at nuScenes-like yaws, fx=fy=1266
intrinsics on a 1600x900 sensor, and the deterministic val ida transform
(resize to width, bottom crop).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..configs import (BackboneConfig, HeadConfig, IdaAugConfig, TrainConfig,
                       VampireConfig)
from ..ops.target_assign import assign_targets_batch

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


def synthetic_batch(cfg: VampireConfig, batch_size: int = 1,
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


def tiny_config() -> VampireConfig:
    """Small config for CPU tests: same code paths, ~100x less compute."""
    bc = BackboneConfig(
        x_bound_seg=(-4.0, 4.0, 0.5), y_bound_seg=(-4.0, 4.0, 0.5),
        z_bound_seg=(-5.0, 3.0, 1.0),
        x_bound_det=(-4.0, 4.0, 0.5), y_bound_det=(-4.0, 4.0, 0.5),
        z_bound_det=(-1.0, 3.0, 1.0),
        d_bound=(2.0, 18.0, 2.0),
        final_dim=(32, 64),
        mid_channels=8,
        output_channels=16,
        variant='lss_inpaintor',
        img_backbone_depth=10,
        img_backbone_out_indices=(0, 1, 2, 3),
        img_neck_in_channels=(64, 128, 256, 512),
        img_neck_out_channels=(16, 16, 16, 16),
        occ_pc_range=(-3.2, -3.2, -1.0, 3.2, 3.2, 0.6),
        occ_voxel_size=(0.8, 0.8, 0.4),
        occ_grid=(8, 8, 4),
        # the dense ray sampler at tiny shapes
        ray_pass_fracs=(),
        ray_et_fracs=(),
    )
    hc = HeadConfig(
        in_channels=32,
        bev_backbone_in_channels=16,
        bev_backbone_depth=10,
        bev_backbone_base_channels=32,
        bev_neck_in_channels=(16, 32, 64, 128),
        bev_neck_out_channels=(8, 8, 8, 8),
        share_conv_channel=16,
        grid_size=(64, 64, 1),     # /4 -> 16x16 head maps = tiny BEV size
        pc_range=(-4.0, -4.0, -5.0, 4.0, 4.0, 3.0),
        voxel_size=(0.125, 0.125, 8.0),
        post_center_range=(-6.0, -6.0, -10.0, 6.0, 6.0, 10.0),
        max_objs=32,
        max_num=20,
        nms_pre_max_size=40,
        nms_post_max_size=10,
    )
    tc = TrainConfig(batch_size_per_device=1, max_points=128)
    # dataset-side augs consistent with the tiny model
    ida = IdaAugConfig(resize_lim=(0.04, 0.06), final_dim=(32, 64))
    return VampireConfig(backbone=bc, head=hc, train=tc, ida_aug=ida)
