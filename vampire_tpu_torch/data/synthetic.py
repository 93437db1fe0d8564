"""Synthetic nuScenes-shaped batches: camera rigs, labels, detection targets.

The port's own copy of `camera_rig`, `synthetic_batch`, `tiny_config` and
`consistent_batch` of the JAX package's `vampire_tpu/data/synthetic.py`: the
same numpy draws in the same order, so both packages make the same arrays
from a seed (tests/test_torch_host.py, tests/test_torch_data.py). Geometry matches the real rig closely enough
that projections land in-frame: six cameras at nuScenes-like yaws, fx=fy=1266
intrinsics on a 1600x900 sensor, and the deterministic val ida transform
(resize to width, bottom crop).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..configs import (BackboneConfig, HeadConfig, IdaAugConfig, TrainConfig,
                       VampireConfig, IMG_MEAN, IMG_STD)
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


# ---------------------------------------------------------------------------
# Geometrically consistent synthetic scene
#
# synthetic_batch's labels are i.i.d. noise — unlearnable by construction, so
# a convergence study over it cannot detect a broken supervision branch
# (wrong mask, wrong scale, dead gradients). consistent_batch builds a
# procedural 3D scene (ground plane + car boxes) and derives EVERY label
# from it through the same geometry the model uses: images are
# z-buffered class-colored projections, depth/seg labels are projected
# "lidar" points (sparse, 0 = no hit, like the real pipeline's
# depth_transform), BEV maps go through the real make_bev_seg_map raster,
# occ semantics voxelize the scene on make_occ_coords centers, and the
# detection targets are the scene's boxes. Reference supervision semantics:
# base_exp.py:588,596-632 (depth), nusc_det_seg_dataset.py:661-669.
# ---------------------------------------------------------------------------

_CLS_CAR = 4            # 17-class lidarseg id of vehicle.car (and Occ3D id)
_CLS_GROUND = 11        # driveable_surface
# imgs are stored normalized; losses denormalize with these (losses.py)
_IMG_MEAN_01 = np.asarray(IMG_MEAN, np.float32) / 255.0
_IMG_STD_01 = np.asarray(IMG_STD, np.float32) / 255.0
_COLORS = {0: (0.55, 0.70, 0.90),       # sky / no hit
           _CLS_CAR: (0.85, 0.25, 0.20),
           _CLS_GROUND: (0.35, 0.37, 0.35)}


def _scene_boxes(rng, x_ext: float, n_boxes: int) -> np.ndarray:
    """(n, 9) [x, y, z_center, w, l, h, yaw, vx, vy] car boxes on z=0."""
    boxes = np.zeros((n_boxes, 9), np.float32)
    # keep boxes off the rig (|r| > 4) and inside 0.75 * extent
    r = rng.uniform(4.0, max(4.5, 0.75 * x_ext), n_boxes)
    th = rng.uniform(-np.pi, np.pi, n_boxes)
    boxes[:, 0] = r * np.cos(th)
    boxes[:, 1] = r * np.sin(th)
    boxes[:, 3:6] = np.array([1.9, 4.5, 1.6], np.float32) * \
        rng.uniform(0.8, 1.2, (n_boxes, 3)).astype(np.float32)
    boxes[:, 2] = boxes[:, 5] / 2.0
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n_boxes)
    return boxes


def _box_surface_points(rng, box, n: int) -> np.ndarray:
    """n points on the 4 sides + top of one box, ego frame."""
    w, l, h = box[3:6]
    # sample in the unit box surface (sides + top)
    areas = np.array([l * h, l * h, w * h, w * h, w * l])
    face = rng.choice(5, n, p=areas / areas.sum())
    u = rng.uniform(-0.5, 0.5, n)
    v = rng.uniform(-0.5, 0.5, n)
    x = np.where(face == 0, u * w, np.where(face == 1, u * w,
                 np.where(face == 2, 0.5 * w, np.where(face == 3,
                          -0.5 * w, u * w))))
    y = np.where(face == 0, 0.5 * l, np.where(face == 1, -0.5 * l,
                 np.where(face == 2, u * l, np.where(face == 3,
                          u * l, v * l))))
    z = np.where(face == 4, 0.5 * h, v * h)
    p = np.stack([x, y, z + 0.5 * h], axis=1)
    c, s = np.cos(box[6]), np.sin(box[6])
    rot = np.array([[c, -s], [s, c]], np.float32)
    p[:, :2] = p[:, :2] @ rot.T
    p[:, 0] += box[0]
    p[:, 1] += box[1]
    return p.astype(np.float32)


def _points_in_box(pts: np.ndarray, box) -> np.ndarray:
    """Bool mask of ego points inside one (9,) box."""
    d = pts[:, :2] - box[:2]
    c, s = np.cos(-box[6]), np.sin(-box[6])
    local = np.stack([c * d[:, 0] - s * d[:, 1],
                      s * d[:, 0] + c * d[:, 1]], axis=1)
    return ((np.abs(local[:, 0]) <= box[3] / 2)
            & (np.abs(local[:, 1]) <= box[4] / 2)
            & (pts[:, 2] >= 0.0) & (pts[:, 2] <= box[5]))


def _project_np(pts: np.ndarray, s2e: np.ndarray, intr: np.ndarray,
                ida: np.ndarray):
    """numpy twin of core.geometry.get_pixel for one camera:
    ego (P, 3) -> (u, v, depth)."""
    e2s = np.linalg.inv(s2e.astype(np.float64))
    p = pts.astype(np.float64) @ e2s[:3, :3].T + e2s[:3, 3]
    p = p @ intr[:3, :3].astype(np.float64).T
    z = p[:, 2]
    uv1 = np.concatenate([p[:, :2] / np.maximum(z, 1e-6)[:, None],
                          z[:, None], np.ones_like(z)[:, None]], axis=1)
    q = uv1 @ ida.astype(np.float64).T
    return q[:, 0], q[:, 1], z


def consistent_batch(cfg: VampireConfig, batch_size: int = 1,
                     n_points: Optional[int] = None, n_boxes: int = 8,
                     seed: int = 0, mode: str = 'train',
                     sweep_offsets: tuple = ()) -> Dict[str, np.ndarray]:
    """synthetic_batch drop-in with every label derived from one scene.

    sweep_offsets: per-sweep ego displacements in meters BEHIND the key ego
    (the vehicle drove forward between sweep and key). Non-empty emits the
    loader's multi-frame layout — imgs (B, F, N, H, W, 3) with frame 0 = key,
    sensor2ego composed into the KEY ego frame (sweepsensor2keyego,
    data/nuscenes.py:297) — with sweep images rendered from the displaced
    rig, and (train mode) per-sweep-frame depth/seg maps projected from the
    same lidar subset, mirroring nusc_det_seg_dataset.py:661-669. All other
    labels are key-frame, as in the real pipeline.
    """
    from .transforms import make_bev_seg_map
    from ..core.geometry import make_occ_coords

    rng = np.random.RandomState(seed)
    bc, hc, tc = cfg.backbone, cfg.head, cfg.train
    fH, fW = bc.final_dim
    N = cfg.ida_aug.n_cams
    K = bc.num_classes
    P = n_points if n_points is not None else tc.max_points
    x_ext = bc.x_bound_seg[1]
    _, Yd, Xd = bc.grid_zyx('det')

    batch = dict(camera_rig(batch_size, N, bc.final_dim, seed=seed))
    offsets = (0.0,) + tuple(sweep_offsets)
    F = len(offsets)
    imgs = np.zeros((batch_size, F, N, fH, fW, 3), np.float32)
    depth_lab = np.zeros((batch_size, F, N, fH, fW), np.float32)
    seg_lab = np.zeros((batch_size, F, N, fH, fW), np.int32)
    all_pts, all_lab, all_valid = [], [], []
    gt_boxes, gt_labels = [], []
    occ_sems, bev_segs, bev_hts, bev_masks = [], [], [], []

    occ_centers = make_occ_coords(bc.occ_pc_range, bc.occ_voxel_size,
                                  bc.occ_grid)      # (gx, gy, gz, 3)
    occ_flat = occ_centers.reshape(-1, 3)
    vz = bc.occ_voxel_size[2]

    for b in range(batch_size):
        boxes = _scene_boxes(rng, x_ext, n_boxes)

        # dense surface set for image rendering (~90k ground + boxes)
        side = max(48, min(352, int(2 * x_ext / 0.35)))
        gx_, gy_ = np.meshgrid(
            np.linspace(-x_ext, x_ext, side, dtype=np.float32),
            np.linspace(-x_ext, x_ext, side, dtype=np.float32))
        ground = np.stack([gx_.ravel(), gy_.ravel(),
                           np.zeros(side * side, np.float32)], axis=1)
        ground += rng.uniform(-0.1, 0.1, ground.shape).astype(np.float32) \
            * np.array([1, 1, 0], np.float32)
        dense = [ground]
        dense_cls = [np.full(len(ground), _CLS_GROUND, np.int32)]
        for box in boxes:
            bp = _box_surface_points(rng, box, 3000)
            dense.append(bp)
            dense_cls.append(np.full(len(bp), _CLS_CAR, np.int32))
        dense = np.concatenate(dense)
        dense_cls = np.concatenate(dense_cls)

        # "lidar" subset: P points from the same surfaces
        sel = rng.choice(len(dense), size=min(P, len(dense)), replace=False)
        pts = dense[sel]
        lab = dense_cls[sel]
        if len(pts) < P:
            pad = P - len(pts)
            pts = np.concatenate([pts, np.zeros((pad, 3), np.float32)])
            lab = np.concatenate([lab, np.zeros(pad, np.int32)])
        pv = np.zeros(P, bool)
        pv[:len(sel)] = True
        # a pad tail like the real loader's (tests rely on some False rows)
        pv[int(P * 0.95):] = False
        all_pts.append(pts)
        all_lab.append(lab)
        all_valid.append(pv)

        # per-frame, per-camera render: z-buffer the dense set; lidar subset
        # -> labels. Sweep frame f's rig sits offsets[f] m behind the key ego
        # (sweepsensor2keyego = trans(-d) @ s2e, data/nuscenes.py:297)
        for f, off in enumerate(offsets):
            Tf = np.eye(4, dtype=np.float32)
            Tf[0, 3] = -off
            for n in range(N):
                s2e = (Tf @ batch['sensor2ego'][b, n]).astype(np.float32)
                intr = batch['intrin'][b, n]
                ida = batch['ida'][b, n]
                u, v, z = _project_np(dense, s2e, intr, ida)
                ok = (z > 0.5) & (u >= 0) & (u < fW - 0.5) & (v >= 0) \
                    & (v < fH - 0.5)
                ui = np.round(u[ok]).astype(np.int64)
                vi = np.round(v[ok]).astype(np.int64)
                flat = vi * fW + ui
                zbuf = np.full(fH * fW, np.inf, np.float32)
                np.minimum.at(zbuf, flat, z[ok].astype(np.float32))
                win = z[ok].astype(np.float32) <= zbuf[flat] + 1e-4
                cls_img = np.zeros(fH * fW, np.int32)
                cls_img[flat[win]] = dense_cls[ok][win]
                dep_img = np.zeros(fH * fW, np.float32)
                dep_img[flat[win]] = z[ok][win].astype(np.float32)
                cls_map = cls_img.reshape(fH, fW)
                dep_map = dep_img.reshape(fH, fW)
                rgb = np.empty((fH, fW, 3), np.float32)
                for cid, col in _COLORS.items():
                    rgb[cls_map == cid] = col
                # depth shading so images carry a geometry cue
                shade = np.where(dep_map > 0,
                                 1.0 / (1.0 + 0.015 * dep_map), 1.0)
                rgb *= shade[..., None]
                imgs[b, f, n] = (rgb - _IMG_MEAN_01) / _IMG_STD_01

                # sparse depth/seg supervision from the lidar subset only
                # (built per frame, mirroring nusc_det_seg_dataset.py:661-669)
                u2, v2, z2 = _project_np(pts[pv], s2e, intr, ida)
                ok2 = (z2 > bc.d_bound[0]) & (z2 < bc.d_bound[1]) & (u2 >= 0) \
                    & (u2 < fW - 0.5) & (v2 >= 0) & (v2 < fH - 0.5)
                ui2 = np.round(u2[ok2]).astype(np.int64)
                vi2 = np.round(v2[ok2]).astype(np.int64)
                f2 = vi2 * fW + ui2
                # nearest point wins (depth_transform's -depth sort semantics)
                order = np.argsort(-z2[ok2])
                dl = depth_lab[b, f, n].reshape(-1)
                sl = seg_lab[b, f, n].reshape(-1)
                dl[f2[order]] = z2[ok2][order].astype(np.float32)
                sl[f2[order]] = lab[pv][ok2][order]

        # BEV raster through the real path
        seg, height, mask = make_bev_seg_map(
            pts[pv], lab[pv].astype(np.float32),
            x_bound=bc.x_bound_seg[:2], y_bound=bc.y_bound_seg[:2],
            z_bound=bc.z_bound_seg[:2], size=bc.x_bound_seg[2])
        # raster grid == det grid for every shipped config
        assert seg.shape == (Yd, Xd), (seg.shape, (Yd, Xd))
        bev_segs.append(seg)
        bev_hts.append(height)
        bev_masks.append(mask)

        # occupancy: voxelize ground + boxes on the occ grid
        sem = np.full(len(occ_flat), K - 1, np.int32)     # free
        ground_vox = np.abs(occ_flat[:, 2]) <= vz / 2.0
        sem[ground_vox] = _CLS_GROUND
        for box in boxes:
            sem[_points_in_box(occ_flat, box)] = _CLS_CAR
        occ_sems.append(sem.reshape(occ_centers.shape[:3]))

        gt_boxes.append(boxes)
        gt_labels.append(np.zeros(n_boxes, np.int64))     # task-0 'car'

    if sweep_offsets:
        # loader multi-frame layout: imgs (B, F, N, ...), per-frame mats
        batch['imgs'] = imgs
        batch['depth_labels'] = depth_lab
        batch['seg_labels'] = seg_lab
        frame_mats = []
        for off in offsets:
            Tf = np.eye(4, dtype=np.float32)
            Tf[0, 3] = -off
            frame_mats.append(np.einsum('ij,bnjk->bnik', Tf,
                                        batch['sensor2ego']))
        batch['sensor2ego'] = np.stack(frame_mats, axis=1).astype(np.float32)
        batch['intrin'] = np.repeat(batch['intrin'][:, None], F, axis=1)
        batch['ida'] = np.repeat(batch['ida'][:, None], F, axis=1)
    else:
        batch['imgs'] = imgs[:, 0]
        batch['depth_labels'] = depth_lab[:, 0]
        batch['seg_labels'] = seg_lab[:, 0]
    batch['points'] = np.stack(all_pts)
    batch['point_labels'] = np.stack(all_lab)
    batch['point_valid'] = np.stack(all_valid)
    batch['bev_seg'] = np.stack(bev_segs).astype(np.int32)
    batch['bev_height'] = np.stack(bev_hts).astype(np.float32)
    batch['bev_mask'] = np.stack(bev_masks)
    sem = np.stack(occ_sems)
    batch['occ_semantics'] = sem
    batch['occ_density_labels'] = (sem != K - 1).astype(np.float32)
    # camera-visible mask: voxel center projects into SOME camera frustum.
    # This must not be all-True, or the invisible occ density term would be
    # vacuously zero (masked mean over an empty set) and untestable.
    # key-frame mats regardless of the multi-frame layout above
    key_s2e = (batch['sensor2ego'][:, 0] if sweep_offsets
               else batch['sensor2ego'])
    key_intr = batch['intrin'][:, 0] if sweep_offsets else batch['intrin']
    key_ida = batch['ida'][:, 0] if sweep_offsets else batch['ida']
    masks = []
    for b in range(batch_size):
        vis = np.zeros(len(occ_flat), bool)
        for n in range(N):
            u, v, z = _project_np(occ_flat, key_s2e[b, n],
                                  key_intr[b, n], key_ida[b, n])
            # horizontal-FOV membership only: Occ3D's real mask is
            # ray-cast, not projective, so any nontrivial mask works for
            # learnability; the vertical gate is dropped because the tiny
            # config's near-rig occ grid falls entirely below the image
            # bottom (visible set would be empty) and d_bound would
            # likewise empty it
            vis |= (z > 0.1) & (u >= 0) & (u < fW)
        masks.append(vis.reshape(occ_centers.shape[:3]))
    batch['mask_camera'] = np.stack(masks)
    batch['mask_lidar'] = batch['mask_camera'].copy()
    if mode == 'train':
        batch.update(assign_targets_batch(gt_boxes, gt_labels, hc))
        batch['gt_boxes_list'] = gt_boxes
    return batch
