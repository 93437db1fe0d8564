"""Trilinear field sampling and separable interpolation (plain torch).

Port of the serving-path half of `vampire_tpu/core/sampling.py`:

  * `sample_outer_product`: trilinear sample of the implicit volume
    `depth (x) feat` with zeros padding, fp32 weights and accumulation. It is
    the exact fp32 lift sampler and the plain version of the CUDA lift kernel
    (`ops/lift.py`).
  * `sample_bilinear`: the 2-D bilinear sample of a feature map with zeros
    padding, fp32 weights and sums: the `bilinear` variant's lift sampler
    and the plain version of the lift kernel's depth-less mode.
  * `grid_sample_3d`: `F.grid_sample` on a channels-first volume, returning
    channels-last samples like the JAX sampler.
  * `make_sample_matrix` / `apply_sample_matrices`: static-grid sampling as
    separable matmuls.
  * `resize_linear`: align_corners=True multi-axis linear resize.
  * `corner_rows_weights`: each sample's trilinear footprint as a row of
    the corner-block table (one row per 2x2x2 block of the zero-padded
    volume, the JAX package's TPU gather layout) and its 8 weights;
    `field_corners` / `gather_field_corners` read those corners from a
    channels-last field (the ray sampler of `core/rendering.py` and
    `csrc/rays.cu`).

Conventions follow torch `grid_sample`: coords are (x, y, z) in [-1, 1] with
x indexing the innermost axis; align_corners=True maps -1/1 to the corner
voxel centers, align_corners=False to the outer voxel edges.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _unnormalize(coord: torch.Tensor, size: int,
                 align_corners: bool) -> torch.Tensor:
    coord = coord.to(torch.float32)
    if align_corners:
        return (coord + 1.0) / 2.0 * (size - 1)
    return ((coord + 1.0) * size - 1.0) / 2.0


def _prep_axis(coord, size, align_corners):
    """Zeros padding along one axis: ((i0, i1), (w0, w1), (inb0, inb1))."""
    x = _unnormalize(coord, size, align_corners)
    x0 = torch.floor(x)
    w1 = x - x0
    i0 = x0.to(torch.int64)
    idx, inb = [], []
    for i in (i0, i0 + 1):
        inb.append((i >= 0) & (i <= size - 1))
        idx.append(torch.clamp(i, 0, size - 1))
    return idx, (1.0 - w1, w1), inb


def sample_outer_product(depth_vol: torch.Tensor, feat: torch.Tensor,
                         coords: torch.Tensor,
                         align_corners: bool = False) -> torch.Tensor:
    """Trilinear sample of `depth_vol[..., None] * feat[None]` (zeros padding).

    The trilinear weight sum factorizes as
    sum_{dy,dx} wy*wx*feat[y,x] * (sum_dz wz*depth[z,y,x]), so the (D, H, W, C)
    product is never built.

    Args:
      depth_vol: (D, H, W) depth distribution.
      feat: (H, W, C) per-pixel features.
      coords: (..., 3) normalized (x, y, z); x->W, y->H, z->D.

    Returns:
      (..., C) fp32 lifted features.
    """
    D, H, W = depth_vol.shape
    C = feat.shape[-1]
    lead = coords.shape[:-1]
    c = coords.reshape(-1, 3)
    xi, xw, xm = _prep_axis(c[:, 0], W, align_corners)
    yi, yw, ym = _prep_axis(c[:, 1], H, align_corners)
    zi, zw, zm = _prep_axis(c[:, 2], D, align_corners)

    dflat = depth_vol.reshape(D * H * W)
    fflat = feat.reshape(H * W, C)
    out = torch.zeros((c.shape[0], C), dtype=torch.float32, device=c.device)
    for dy in (0, 1):
        for dx in (0, 1):
            inb2d = ym[dy] & xm[dx]
            w2d = torch.where(inb2d, yw[dy] * xw[dx], 0.0)
            pix = yi[dy] * W + xi[dx]
            # depth interpolated along z at this (y, x) corner
            s = torch.zeros_like(w2d)
            for dz in (0, 1):
                wz = torch.where(zm[dz], zw[dz], 0.0)
                s = s + wz * dflat[zi[dz] * H * W + pix].to(torch.float32)
            fv = fflat[pix].to(torch.float32)
            out = out + fv * (w2d * s)[:, None]
    return out.reshape(*lead, C)


def sample_bilinear(feat: torch.Tensor, coords: torch.Tensor,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear sample of a (H, W, C) feature map at the (x, y) of coords
    (..., 3) (z is not read), zeros padding.

    The JAX package samples a depth-1 volume (1, H, W, C) at z = 0 through
    its corner table: the z0 corner weighs 1 and the z1 corner lies outside,
    so the sample is these four pixel corners. The terms and their order
    are `sample_outer_product`'s with a depth of ones at D = 1 and z = 0.

    Returns (..., C) fp32.
    """
    H, W, C = feat.shape
    lead = coords.shape[:-1]
    c = coords.reshape(-1, coords.shape[-1])
    xi, xw, xm = _prep_axis(c[:, 0], W, align_corners)
    yi, yw, ym = _prep_axis(c[:, 1], H, align_corners)
    fflat = feat.reshape(H * W, C)
    out = torch.zeros((c.shape[0], C), dtype=torch.float32, device=c.device)
    for dy in (0, 1):
        for dx in (0, 1):
            w2d = torch.where(ym[dy] & xm[dx], yw[dy] * xw[dx], 0.0)
            fv = fflat[yi[dy] * W + xi[dx]].to(torch.float32)
            out = out + fv * w2d[:, None]
    return out.reshape(*lead, C)


def grid_sample_3d(vol: torch.Tensor, coords: torch.Tensor,
                   align_corners: bool = True,
                   padding_mode: str = 'zeros') -> torch.Tensor:
    """Batched trilinear sample of a channels-first volume.

    Args:
      vol: (B, C, D, H, W).
      coords: (B, ..., 3) normalized (x, y, z).

    Returns:
      (B, ..., C) samples in vol's dtype (fp32 for an fp32 volume).
    """
    B, C = vol.shape[:2]
    lead = coords.shape[1:-1]
    grid = coords.reshape(B, 1, 1, -1, 3).to(vol.dtype)
    out = F.grid_sample(vol, grid, mode='bilinear', padding_mode=padding_mode,
                        align_corners=align_corners)       # (B, C, 1, 1, P)
    return out.reshape(B, C, -1).transpose(1, 2).reshape(B, *lead, C)


# ---------------------------------------------------------------------------
# Corner-block rows: one row per trilinear footprint, (D+1)(H+1)(W+1) rows,
# row (bz, by, bx) the 2x2x2 block of the zero-padded volume rooted at voxel
# (bz-1, by-1, bx-1), its corners in (dz, dy, dx)-major order.
# ---------------------------------------------------------------------------

def _axis_window_weights(coord, size, align_corners, border):
    """Per-point (table base index along one axis, (a0, a1) weights of the
    table offsets 0 and 1)."""
    x = _unnormalize(coord, size, align_corners)
    if border:
        x = torch.clamp(x, 0.0, float(size - 1))
    x0f = torch.floor(x)
    w1 = x - x0f
    w0 = 1.0 - w1
    x0 = x0f.to(torch.int64)
    b = torch.clamp(x0 + 1, 0, size)        # table base (orig rows b-1, b)

    def a(d):
        r = b - 1 + d                       # orig row of table offset d
        c0 = (r == x0) & (x0 >= 0) & (x0 <= size - 1)
        c1 = (r == x0 + 1) & (x0 + 1 >= 0) & (x0 + 1 <= size - 1)
        return torch.where(c0, w0, 0.0) + torch.where(c1, w1, 0.0)
    return b, torch.stack([a(0), a(1)], dim=-1)


def corner_rows_weights(c: torch.Tensor, vol_shape: Tuple[int, int, int],
                        align_corners: bool, border: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """c (P, 3) normalized (x, y, z) -> (rows (P,) int64 into the
    (D+1)(H+1)(W+1)-row corner table, w8 (P, 8) fp32 corner weights in the
    table's (dz, dy, dx)-major corner order). Zeros padding unless `border`
    clamps the coordinate first."""
    D, H, W = vol_shape
    bx, ax = _axis_window_weights(c[:, 0], W, align_corners, border)
    by, ay = _axis_window_weights(c[:, 1], H, align_corners, border)
    bz, az = _axis_window_weights(c[:, 2], D, align_corners, border)
    rows = (bz * (H + 1) + by) * (W + 1) + bx
    w8 = (az[:, :, None, None] * ay[:, None, :, None]
          * ax[:, None, None, :]).reshape(-1, 8)
    return rows, w8


def field_corners(c: torch.Tensor, vol_shape: Tuple[int, int, int]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The corners of `corner_rows_weights` (align_corners=True, zeros) in a
    (D, H, W) field: c (P, 3) -> (voxels (P, 8) int64, flat indices into
    the D*H*W voxels clamped into the field; inside (P, 8) bool; w8 (P, 8)
    fp32 weights in the table's (dz, dy, dx)-major corner order). Corner k of
    table row (bz, by, bx) is voxel (bz-1+dz, by-1+dy, bx-1+dx); a corner
    outside the field weighs 0, and its table entry is 0."""
    D, H, W = vol_shape
    rows, w8 = corner_rows_weights(c, vol_shape, True, False)
    k = torch.arange(8, device=c.device)
    vox = torch.zeros(w8.shape, dtype=torch.int64, device=c.device)
    inside = torch.ones(w8.shape, dtype=torch.bool, device=c.device)
    for base, off, size in ((rows // ((W + 1) * (H + 1)), k >> 2, D),
                            ((rows // (W + 1)) % (H + 1), (k >> 1) & 1, H),
                            (rows % (W + 1), k & 1, W)):
        r = base[:, None] - 1 + off
        inside &= (r >= 0) & (r < size)
        vox = vox * size + r.clamp(0, size - 1)
    return vox, inside, w8


def gather_field_corners(field: torch.Tensor, c: torch.Tensor
                         ) -> torch.Tensor:
    """Trilinear samples of a channels-last (D, H, W, C) field at c (P, 3)
    -> (P, C) fp32: the 8 corners of `field_corners` (those outside read 0)
    times their weights, summed over the corners."""
    D, H, W, C = field.shape
    vox, inside, w8 = field_corners(c, (D, H, W))
    t = field.reshape(D * H * W, C).index_select(0, vox.reshape(-1))
    t = t.reshape(-1, 8, C)
    t = torch.where(inside[..., None], t, torch.zeros((), dtype=t.dtype))
    return torch.sum(t.to(torch.float32) * w8[:, :, None], dim=1)


@functools.lru_cache(maxsize=64)
def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) align_corners=True linear interpolation matrix."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if out_size == 1 or in_size == 1:
        m[:, 0] = 1.0
        return m
    scale = (in_size - 1) / (out_size - 1)
    for i in range(out_size):
        x = i * scale
        x0 = int(np.floor(x))
        x1 = min(x0 + 1, in_size - 1)
        w = x - x0
        m[i, x0] += 1.0 - w
        m[i, x1] += w
    return m


def make_sample_matrix(coords_norm, size: int, align_corners: bool,
                       padding_mode: str = 'zeros') -> np.ndarray:
    """(out, size) numpy matrix encoding 1D linear grid_sample at static
    normalized coords: each row holds the two corner weights (border: clamp
    the coordinate; zeros: out-of-bounds corners dropped)."""
    coords_norm = np.asarray(coords_norm, np.float64)
    if align_corners:
        x = (coords_norm + 1.0) / 2.0 * (size - 1)
    else:
        x = ((coords_norm + 1.0) * size - 1.0) / 2.0
    if padding_mode == 'border':
        x = np.clip(x, 0.0, float(size - 1))
    m = np.zeros((coords_norm.shape[0], size), np.float32)
    x0 = np.floor(x)
    w1 = x - x0
    for d, w in ((0, 1.0 - w1), (1, w1)):
        idx = x0.astype(np.int64) + d
        inb = (idx >= 0) & (idx <= size - 1)
        np.add.at(m, (np.arange(m.shape[0])[inb], idx[inb]), w[inb])
    return m


def _contract(x: torch.Tensor, m: torch.Tensor, ax: int) -> torch.Tensor:
    """x with axis `ax` replaced by m @ x along it (fp32)."""
    x = torch.movedim(x, ax, -1)
    x = torch.matmul(x, m.t())
    return torch.movedim(x, -1, ax)


def apply_sample_matrices(vol: torch.Tensor, mats: Sequence[torch.Tensor],
                          axes: Sequence[int]) -> torch.Tensor:
    """Contract interpolation matrices along the given axes, in fp32."""
    x = vol.to(torch.float32)
    for m, ax in zip(mats, axes):
        x = _contract(x, m, ax)
    return x


def resize_linear(x: torch.Tensor, out_sizes: Sequence[int],
                  axes: Sequence[int]) -> torch.Tensor:
    """align_corners=True multi-axis linear resize via interpolation matmuls
    (torch `F.interpolate(..., align_corners=True)` semantics), computed in
    fp32 and returned in x's dtype."""
    dt = x.dtype
    for ax, out_size in zip(axes, out_sizes):
        in_size = x.shape[ax]
        if in_size == out_size:
            continue
        m = torch.from_numpy(_interp_matrix(in_size, out_size)).to(x.device)
        x = _contract(x.to(torch.float32), m, ax)
    return x.to(dt)
