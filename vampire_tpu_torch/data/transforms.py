"""Host-side (numpy) geometric transforms of the input pipeline; the port
of `vampire_tpu/data/transforms.py`.

Re-derives the reference dataset's pure functions without torch:
img_transform (nusc_det_seg_dataset.py:118-146), bev_transform (:149-175),
depth_transform (:178-231) and get_bev_seg_map (:233-265), plus the
quaternion helpers that replace pyquaternion. Every intermediate keeps the
JAX package's dtype (float32 and float64 mixed as there), so that both
packages give the same bytes. The inner rasterization loops run in the
port's host C++ library (`ops/nms.py`); PIL is imported only inside
`apply_img_transform`.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..ops.nms import rasterize_bev, rasterize_depth


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


def quat_yaw(q: Sequence[float]) -> float:
    """Yaw of a quaternion (pyquaternion yaw_pitch_roll[0] convention)."""
    r = quat_to_rot(q)
    return float(np.arctan2(r[1, 0], r[0, 0]))


def pose_matrix(rotation_q, translation) -> np.ndarray:
    """4x4 float64 pose from a (w, x, y, z) rotation and a translation."""
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = quat_to_rot(rotation_q)
    m[:3, 3] = np.asarray(translation, np.float64)
    return m


def _rot2(h: float) -> np.ndarray:
    """get_rot (nusc_det_seg_dataset.py:111-115)."""
    return np.array([[np.cos(h), np.sin(h)], [-np.sin(h), np.cos(h)]],
                    np.float32)


def ida_matrix(resize: float, crop: Tuple[int, int, int, int], flip: bool,
               rotate_deg: float) -> np.ndarray:
    """Image-space augmentation homography (img_transform, :118-146)."""
    ida_rot = np.eye(2, dtype=np.float32) * resize
    ida_tran = -np.asarray(crop[:2], np.float32)
    if flip:
        A = np.array([[-1, 0], [0, 1]], np.float32)
        b = np.array([crop[2] - crop[0], 0], np.float32)
        ida_rot = A @ ida_rot
        ida_tran = A @ ida_tran + b
    A = _rot2(rotate_deg / 180.0 * np.pi)
    b = np.array([crop[2] - crop[0], crop[3] - crop[1]], np.float32) / 2.0
    b = A @ (-b) + b
    ida_rot = A @ ida_rot
    ida_tran = A @ ida_tran + b
    m = np.zeros((4, 4), np.float32)
    m[3, 3] = 1
    m[2, 2] = 1
    m[:2, :2] = ida_rot
    m[:2, 3] = ida_tran
    return m


def apply_img_transform(img, resize_dims, crop, flip, rotate_deg):
    """PIL image pipeline of img_transform (resize->crop->flip->rotate)."""
    from PIL import Image
    img = img.resize(resize_dims)
    img = img.crop(crop)
    if flip:
        img = img.transpose(method=Image.FLIP_LEFT_RIGHT)
    img = img.rotate(rotate_deg)
    return img


def normalize_image(img: np.ndarray, mean, std) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> normalized fp32.

    As in the JAX package, this keeps honest RGB where the reference's
    mmcv.imnormalize(..., to_rgb=True) on a PIL-loaded (already RGB) array
    swaps to BGR before normalizing with RGB stats
    (nusc_det_seg_dataset.py:679-681); the stats are the torchvision
    ImageNet stats either way.
    """
    return ((img.astype(np.float32) - np.asarray(mean, np.float32))
            / np.asarray(std, np.float32))


def bda_transform(gt_boxes: np.ndarray, points: np.ndarray,
                  rotate_deg: float, scale: float, flip_dx: bool,
                  flip_dy: bool) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """BEV augmentation of boxes + points (bev_transform, :149-175).
    Returns (boxes, points, rot_mat 3x3)."""
    ang = rotate_deg / 180.0 * np.pi
    rot = np.array([[np.cos(ang), -np.sin(ang), 0],
                    [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    scale_m = np.diag([scale, scale, scale]).astype(np.float32)
    flip_m = np.eye(3, dtype=np.float32)
    if flip_dx:
        flip_m = flip_m @ np.diag([-1, 1, 1]).astype(np.float32)
    if flip_dy:
        flip_m = flip_m @ np.diag([1, -1, 1]).astype(np.float32)
    m = flip_m @ (scale_m @ rot)
    gt_boxes = np.array(gt_boxes, np.float32, copy=True)
    if gt_boxes.shape[0] > 0:
        gt_boxes[:, :3] = gt_boxes[:, :3] @ m.T
        gt_boxes[:, 3:6] *= scale
        gt_boxes[:, 6] += ang
        if flip_dx:
            gt_boxes[:, 6] = np.pi - gt_boxes[:, 6]
        if flip_dy:
            gt_boxes[:, 6] = -gt_boxes[:, 6]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 7:9] = gt_boxes[:, 7:9] @ m[:2, :2].T
    points = np.asarray(points, np.float32)
    if points.shape[0] > 0:
        points = points @ m.T
    return gt_boxes, points, m


def make_depth_label(cam_depth_uvd: np.ndarray, cam_label: np.ndarray,
                     resize: float, final_dim: Tuple[int, int],
                     crop, flip: bool, rotate_deg: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse depth/label maps after ida (depth_transform, :178-231).

    cam_depth_uvd: (N, 3) raw-image pixel (u, v) + depth.
    Returns (depth (fH, fW), label (fH, fW)).
    """
    H, W = final_dim
    uv = cam_depth_uvd[:, :2] * resize
    uv[:, 0] -= crop[0]
    uv[:, 1] -= crop[1]
    if flip:
        uv[:, 0] = W - uv[:, 0]
    uv[:, 0] -= W / 2.0
    uv[:, 1] -= H / 2.0
    h = rotate_deg / 180.0 * np.pi
    rot = np.array([[np.cos(h), np.sin(h)], [-np.sin(h), np.cos(h)]])
    uv = uv @ rot.T
    uv[:, 0] += W / 2.0
    uv[:, 1] += H / 2.0
    valid = ((uv[:, 1] < H) & (uv[:, 0] < W) & (uv[:, 1] >= 0)
             & (uv[:, 0] >= 0))
    uvdl = np.concatenate([
        uv[valid], cam_depth_uvd[valid, 2:3],
        cam_label[valid].astype(np.float32)[:, None]], axis=1)
    return rasterize_depth(uvdl, H, W)


def make_bev_seg_map(points: np.ndarray, labels: np.ndarray,
                     x_bound=(-51.2, 51.2), y_bound=(-51.2, 51.2),
                     z_bound=(-5.0, 3.0), size: float = 0.4
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """BEV seg/height/mask raster, highest point wins
    (get_bev_seg_map, :233-265). Returns (seg, height, mask) (gh, gw)."""
    gw = int((x_bound[1] - x_bound[0]) / size)
    gh = int((y_bound[1] - y_bound[0]) / size)
    vx = x_bound[0] - size / 2.0
    vy = y_bound[0] - size / 2.0
    ix = (points[:, 0] - vx) / size
    iy = (points[:, 1] - vy) / size
    z = points[:, 2]
    m = ((ix > 1) & (ix < gw - 1) & (iy > 1) & (iy < gh - 1)
         & (z > z_bound[0]) & (z < z_bound[1]))
    xyzl = np.stack([ix[m].astype(np.int16).astype(np.float32),
                     iy[m].astype(np.int16).astype(np.float32),
                     z[m], labels[m].astype(np.float32)], axis=1)
    seg, height, mask = rasterize_bev(xyzl, gh, gw)
    return seg.astype(np.int32), height, mask.astype(bool)
