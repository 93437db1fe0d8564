"""Coordinate grids and camera geometry (numpy builders, fp32 torch transforms).

Port of `vampire_tpu/core/geometry.py`. The grid builders return numpy arrays
bit-equal to the JAX package's; the projective transforms run in fp32 on
whatever device their inputs live on.

Conventions (matching the JAX package):
  * 4x4 homogeneous matrices, applied as `M @ [x, y, z, 1]^T`.
  * voxel grids are indexed (Z, Y, X) with coordinates stored as (x, y, z, 1).
  * the occ grid is indexed (X, Y, Z) with coordinates (x, y, z).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def arange_bound(bound: Sequence[float]) -> np.ndarray:
    """np.arange(*bound) with float32 semantics (torch.arange equivalent)."""
    lo, hi, step = bound
    n = int(math.ceil((hi - lo) / step - 1e-9))
    return (lo + step * np.arange(n)).astype(np.float32)


def centers_of(bound: Sequence[float]) -> np.ndarray:
    """Cell-center linspace: torch.linspace(lo+s/2, hi-s/2, (hi-lo)/s)."""
    lo, hi, step = bound
    n = int(round((hi - lo) / step))
    return np.linspace(lo + step / 2.0, hi - step / 2.0, n, dtype=np.float32)


def make_frustum(final_dim: Tuple[int, int], downsample_factor: int,
                 d_bound: Sequence[float]) -> np.ndarray:
    """(D, fH, fW, 4) pixel-space frustum: (u_pix, v_pix, depth, 1)."""
    ogf_h, ogf_w = final_dim
    f_h, f_w = ogf_h // downsample_factor, ogf_w // downsample_factor
    d = arange_bound(d_bound)
    D = d.shape[0]
    xs = np.linspace(0, ogf_w - 1, f_w, dtype=np.float32)
    ys = np.linspace(0, ogf_h - 1, f_h, dtype=np.float32)
    d_c = np.broadcast_to(d[:, None, None], (D, f_h, f_w))
    x_c = np.broadcast_to(xs[None, None, :], (D, f_h, f_w))
    y_c = np.broadcast_to(ys[None, :, None], (D, f_h, f_w))
    ones = np.ones_like(d_c)
    return np.stack([x_c, y_c, d_c, ones], axis=-1)


def make_camera_mids(d_bound: Sequence[float]) -> np.ndarray:
    """(D-1,) midpoints of adjacent depth planes."""
    t = arange_bound(d_bound)
    return 0.5 * (t[:-1] + t[1:])


def make_bev_mids(z_bound_det: Sequence[float]) -> np.ndarray:
    """z-flipped det-grid cell centers."""
    return centers_of(z_bound_det)[::-1].copy()


def make_voxel_coords(x_bound, y_bound, z_bound) -> np.ndarray:
    """(Z, Y, X, 4) homogeneous cell-center coords."""
    zs, ys, xs = centers_of(z_bound), centers_of(y_bound), centers_of(x_bound)
    zg, yg, xg = np.meshgrid(zs, ys, xs, indexing='ij')
    ones = np.ones_like(xg)
    return np.stack([xg, yg, zg, ones], axis=-1).astype(np.float32)


def make_norm_voxel_coords(x_bound, y_bound, z_bound) -> np.ndarray:
    """(Z, Y, X, 3) coords normalized to [-1, 1] in (x, y, z) order."""
    def norm(b):
        c = centers_of(b)
        return (c - b[0]) / (b[1] - b[0])
    zg, yg, xg = np.meshgrid(norm(z_bound), norm(y_bound), norm(x_bound),
                             indexing='ij')
    return (np.stack([xg, yg, zg], axis=-1) * 2.0 - 1.0).astype(np.float32)


def make_occ_coords(point_cloud_range=(-40.0, -40.0, -1.0, 40.0, 40.0, 5.4),
                    voxel_size=(0.4, 0.4, 0.4),
                    grid=(200, 200, 16)) -> np.ndarray:
    """(X, Y, Z, 3) Occ3D voxel centers, indexed (X, Y, Z)."""
    gx, gy, gz = grid
    ix, iy, iz = np.meshgrid(np.arange(gx), np.arange(gy), np.arange(gz),
                             indexing='ij')
    x = ix * voxel_size[0] + voxel_size[0] / 2 + point_cloud_range[0]
    y = iy * voxel_size[1] + voxel_size[1] / 2 + point_cloud_range[1]
    z = iz * voxel_size[2] + voxel_size[2] / 2 + point_cloud_range[2]
    return np.stack([x, y, z], axis=-1).astype(np.float32)


# ---------------------------------------------------------------------------
# Projective transforms (fp32)
# ---------------------------------------------------------------------------

def get_geometry(frustum: torch.Tensor, sensor2ego: torch.Tensor,
                 intrin: torch.Tensor, ida: torch.Tensor,
                 bda: Optional[torch.Tensor]) -> torch.Tensor:
    """Frustum pixel grid -> ego-frame xyz.

    Args:
      frustum: (D, fH, fW, 4) pixel-space frustum (`make_frustum`).
      sensor2ego, intrin, ida: (B, N, 4, 4) per-camera matrices.
      bda: optional (B, 4, 4) BEV augmentation matrix.

    Returns:
      (B, N, D, fH, fW, 3) fp32 ego xyz.
    """
    f32 = torch.float32
    frustum = frustum.to(f32)
    sensor2ego, intrin, ida = (m.to(f32) for m in (sensor2ego, intrin, ida))
    # undo the image-space augmentation, then pixel * depth
    pts = torch.einsum('bnij,dhwj->bndhwi', torch.linalg.inv(ida), frustum)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:]], dim=-1)
    combine = sensor2ego @ torch.linalg.inv(intrin)
    pts = torch.einsum('bnij,bndhwj->bndhwi', combine, pts)
    if bda is not None:
        pts = torch.einsum('bij,bndhwj->bndhwi', bda.to(f32), pts)
    return pts[..., :3]


def get_pixel(voxel_coords: torch.Tensor, sensor2ego: torch.Tensor,
              intrin: torch.Tensor, ida: torch.Tensor,
              bda: Optional[torch.Tensor], eps: float = 1e-6) -> torch.Tensor:
    """Ego-frame voxel centers -> per-camera (u, v, depth).

    Args:
      voxel_coords: (..., 4) homogeneous ego coords; the leading dims are
        treated opaquely (the lift passes a block-major (G, Q, 1, 4)).
      sensor2ego, intrin, ida: (B, N, 4, 4).
      bda: optional (B, 4, 4).

    Returns:
      (B, N, ..., 3): x/y are final_dim pixel coords after ida, z is the
      camera-frame depth (unclamped).
    """
    f32 = torch.float32
    pts = voxel_coords.to(f32)
    sensor2ego, intrin, ida = (m.to(f32) for m in (sensor2ego, intrin, ida))
    combine = intrin @ torch.linalg.inv(sensor2ego)
    if bda is not None:
        pts = torch.einsum('bij,...j->b...i', torch.linalg.inv(bda.to(f32)),
                           pts)
        pts = torch.einsum('bnij,b...j->bn...i', combine, pts)
    else:
        pts = torch.einsum('bnij,...j->bn...i', combine, pts)
    z = pts[..., 2:3]
    # behind-camera depths are clamped to eps, giving huge pixel coords that
    # the validity mask rejects (z > d_bound[0])
    pts = torch.cat([pts[..., :2] / torch.clamp(z, min=eps), pts[..., 2:]],
                    dim=-1)
    pts = torch.einsum('bnij,bn...j->bn...i', ida, pts)
    return pts[..., :3]


def normalize_coords(xyz: torch.Tensor, x_bound, y_bound,
                     z_bound) -> torch.Tensor:
    """Map ego xyz into the field grid's [-1, 1]^3 (grid_sample convention)."""
    lo = torch.tensor([x_bound[0], y_bound[0], z_bound[0]],
                      dtype=torch.float32, device=xyz.device)
    ext = torch.tensor([x_bound[1] - x_bound[0], y_bound[1] - y_bound[0],
                        z_bound[1] - z_bound[0]],
                       dtype=torch.float32, device=xyz.device)
    return (xyz.to(torch.float32) - lo) / ext * 2.0 - 1.0


def inrange_mask(norm_xyz: torch.Tensor) -> torch.Tensor:
    """Validity mask for normalized coords: all components within [-1, 1]."""
    ok = (norm_xyz >= -1.0) & (norm_xyz <= 1.0)
    return ok[..., 0] & ok[..., 1] & ok[..., 2]
