"""The byte bounds of the lift and ray ops, counted as the program's
kernel table counts them (PERF.md): each input read once, each output
written once, on what these inputs need (the field voxels the valid
samples read, the d numer rows the valid queries read), at the card's
published 3.35 TB/s. Copied from `chip_smoke.py`'s checks so that the
yardstick lives with the benchmark."""
from __future__ import annotations

import torch

from reference.core.sampling import field_corners

from .flops import HBM_BYTES_PER_S


def _bytes(*tensors_or_bytes) -> int:
    return int(sum(t if isinstance(t, (int, float))
                   else t.numel() * t.element_size()
                   for t in tensors_or_bytes))


def bound_ms(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def lift_forward_bytes(depth, feat, ids, coords, valid, n_blocks) -> int:
    """One frame's lift forward: its inputs read once, the (G, Q, C) fp32
    numer and denom written once (depth None: the depth-less mode)."""
    Q, C = valid.shape[-1], feat.shape[-1]
    return _bytes(*[t for t in (depth, feat) if t is not None], ids, coords,
                  valid, 2 * n_blocks * Q * C * 4)


def lift_backward_bytes(depth, feat, ids, coords, valid, n_blocks) -> int:
    """One frame's lift backward: what the valid queries read (their coords
    and distinct d numer rows), the rest of the frame's inputs, the fp32 d
    depth and d feat written; the depth-less d feat needs neither depth
    nor the features' values."""
    Q, C = valid.shape[-1], feat.shape[-1]
    live = valid > 0
    n_valid = int(live.sum())
    rows = torch.zeros(n_blocks, Q, dtype=torch.bool, device=valid.device)
    keep = (ids >= 0) & (ids < n_blocks)
    sel = live & keep[..., None]
    rows[ids[..., None].expand(-1, -1, Q)[sel],
         torch.arange(Q, device=valid.device).expand_as(valid)[sel]] = True
    n_rows = int(rows.sum())
    if depth is None:
        return _bytes(ids, valid, n_valid * 3 * 4, n_rows * C * 4,
                      feat.numel() * 4)
    return _bytes(depth, feat, ids, valid, n_valid * 3 * 4, n_rows * C * 4,
                  depth.numel() * 4, feat.numel() * 4)


def ray_voxel_bytes(field, coords, valid, chunk: int = 1 << 20) -> int:
    """The distinct field voxels of nonzero weight that the valid samples
    read, C channels each (marked a chunk of samples at a time)."""
    D, H, W, C = field.shape
    c = coords.reshape(-1, 3)[valid.reshape(-1) > 0]
    mark = torch.zeros(D * H * W, dtype=torch.bool, device=coords.device)
    for i in range(0, c.shape[0], chunk):
        vox, _, w8 = field_corners(c[i:i + chunk], (D, H, W))
        mark[vox[w8 != 0]] = True
    return int(mark.sum()) * C * field.element_size()


def ray_forward_bytes(field, coords, valid, deltas, mids) -> int:
    """One frame's march: the voxels read, the ray geometry, the (R, C)
    fp32 output [rgb | seg | depth] (C = the field's channels)."""
    R = valid.shape[0]
    out = R * field.shape[3] * 4
    return (ray_voxel_bytes(field, coords, valid)
            + _bytes(coords, valid, deltas, mids, out))


def ray_backward_bytes(field, coords, valid, deltas, mids) -> int:
    """One frame's march backward: the voxels read, the geometry, the
    output and its cotangent, the whole fp32 d field and d beta."""
    R = valid.shape[0]
    D, H, W, C = field.shape
    out = R * C * 4
    return (ray_voxel_bytes(field, coords, valid)
            + _bytes(coords, valid, deltas, mids, out, out,
                     D * H * W * C * 4, 4))
