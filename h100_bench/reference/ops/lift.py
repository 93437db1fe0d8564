"""The lift in plain torch: a frame's cameras sampled and summed into
block-major masked-mean accumulators, forward and backward.

A frozen copy of the plain versions of the program's lift op: the model of
`reference/models/field.py` calls `lift_frame`, whose forward and backward
are the per-camera loops below (a bilinear or outer-product sample, then
two `index_add_`), never a kernel.
"""
from __future__ import annotations

import torch

from ..core.sampling import _prep_axis, sample_bilinear, sample_outer_product

# the most views a frame's lift sums (the program's limit, kept so that
# the same inputs are refused alike)
MAX_CAMERAS = 32

def lift_accumulate_reference(depth, feat, ids, coords, valid, numer, denom):
    """Plain torch lift of one camera (any device): adds its samples into
    the (G, Q, C) fp32 accumulators numer/denom in place and returns them.
    depth (D, h, w) or None (the depth-less mode), feat (h, w, C), ids (K,)
    distinct, coords (K, Q, 3), valid (K, Q)."""
    K, Q = valid.shape
    C = feat.shape[-1]
    c = coords.reshape(K * Q, 3)
    v = (sample_bilinear(feat, c) if depth is None else
         sample_outer_product(depth, feat, c, align_corners=False))
    v = v.reshape(K, Q, C)
    v = v * valid[..., None]
    numer.index_add_(0, ids, v)
    denom.index_add_(0, ids, (torch.abs(v) > 0).to(torch.float32))
    return numer, denom

def lift_frame_accumulate_reference(depth, feat, ids, coords, valid,
                                    n_blocks):
    """Plain version of `lift_frame_accumulate` (any device): the cameras'
    `lift_accumulate_reference` in order into zeroed accumulators. Ids
    outside [0, n_blocks) are dropped, as the kernel ignores them."""
    Q, C = valid.shape[-1], feat.shape[-1]
    numer = torch.zeros((n_blocks, Q, C), dtype=torch.float32,
                        device=feat.device)
    denom = torch.zeros_like(numer)
    for n in range(feat.shape[0]):
        keep = (ids[n] >= 0) & (ids[n] < n_blocks)
        lift_accumulate_reference(None if depth is None else depth[n],
                                  feat[n], ids[n][keep], coords[n][keep],
                                  valid[n][keep], numer, denom)
    return numer, denom

def lift_backward_reference(depth, feat, ids, coords, valid, g_numer):
    """Plain torch transpose of `lift_accumulate_reference`'s numerator for
    one camera (any device): g_numer (G, Q, C) fp32 -> (d depth (D, h, w),
    d feat (h, w, C)), both fp32. With gv = valid * g_numer[ids] and the
    forward's weights, d feat[pix] += wk * gv and d depth[z, pix] +=
    w2d * wz * (feat[pix] . gv), per (dy, dx) pixel corner. With depth None
    (the depth-less mode) wk = w2d and d depth is None."""
    H, W, C = feat.shape
    K, Q = valid.shape
    gv = (g_numer.index_select(0, ids) * valid[..., None]).reshape(K * Q, C)
    c = coords.reshape(K * Q, 3)
    xi, xw, xm = _prep_axis(c[:, 0], W, False)
    yi, yw, ym = _prep_axis(c[:, 1], H, False)
    d_feat = torch.zeros((H * W, C), dtype=torch.float32, device=feat.device)
    if depth is None:
        for dy in (0, 1):
            for dx in (0, 1):
                w2d = torch.where(ym[dy] & xm[dx], yw[dy] * xw[dx], 0.0)
                d_feat.index_add_(0, yi[dy] * W + xi[dx], gv * w2d[:, None])
        return None, d_feat.reshape(H, W, C)
    D = depth.shape[0]
    zi, zw, zm = _prep_axis(c[:, 2], D, False)
    dflat = depth.reshape(D * H * W).to(torch.float32)
    fflat = feat.reshape(H * W, C).to(torch.float32)
    d_depth = torch.zeros(D * H * W, dtype=torch.float32, device=depth.device)
    for dy in (0, 1):
        for dx in (0, 1):
            w2d = torch.where(ym[dy] & xm[dx], yw[dy] * xw[dx], 0.0)
            pix = yi[dy] * W + xi[dx]
            wz = [torch.where(zm[dz], zw[dz], 0.0) for dz in (0, 1)]
            s = torch.zeros_like(w2d)
            for dz in (0, 1):
                s = s + wz[dz] * dflat[zi[dz] * H * W + pix]
            d_feat.index_add_(0, pix, gv * (w2d * s)[:, None])
            dwk = torch.sum(fflat[pix] * gv, dim=-1)
            for dz in (0, 1):
                d_depth.index_add_(0, zi[dz] * H * W + pix, w2d * wz[dz] * dwk)
    return d_depth.reshape(D, H, W), d_feat.reshape(H, W, C)

def lift_frame_backward_reference(depth, feat, ids, coords, valid, g_numer):
    """Plain version of `lift_frame_backward` (any device): the cameras'
    `lift_backward_reference`, stacked: (N, D, h, w), (N, h, w, C) fp32;
    (None, d feat) with depth None."""
    G = g_numer.shape[0]
    grads = []
    for n in range(feat.shape[0]):
        keep = (ids[n] >= 0) & (ids[n] < G)
        grads.append(lift_backward_reference(
            None if depth is None else depth[n], feat[n], ids[n][keep],
            coords[n][keep], valid[n][keep], g_numer))
    d_feat = torch.stack([g[1] for g in grads])
    if depth is None:
        return None, d_feat
    return torch.stack([g[0] for g in grads]), d_feat

class LiftFrame(torch.autograd.Function):
    """One frame's lift over its N cameras, with its backward. Returns
    (numer, denom), (G, Q, C) fp32; denom takes no gradient."""

    @staticmethod
    def forward(ctx, depth, feat, ids, coords, valid, n_blocks):
        numer, denom = lift_frame_accumulate_reference(
            depth, feat, ids, coords, valid, n_blocks)
        ctx.save_for_backward(depth, feat, ids, coords, valid)
        ctx.mark_non_differentiable(denom)
        return numer, denom

    @staticmethod
    def backward(ctx, g_numer, _g_denom):
        depth, feat, ids, coords, valid = ctx.saved_tensors
        d_depth, d_feat = lift_frame_backward_reference(
            depth, feat, ids, coords, valid, g_numer.contiguous())
        return (None if depth is None else d_depth.to(depth.dtype),
                d_feat.to(feat.dtype), None, None, None, None)


def lift_frame(depth, feat, ids, coords, valid, n_blocks, plain=True):
    """Differentiable lift of one frame's N cameras into fresh block-major
    accumulators (n_blocks, Q, C) fp32: depth (N, D, h, w) or None (the
    depth-less mode), feat (N, h, w, C), ids (N, K), coords (N, K, Q, 3),
    valid (N, K, Q). `plain` is accepted for the field's call and
    ignored: this op has no other version."""
    del plain
    return LiftFrame.apply(depth, feat, ids, coords, valid, n_blocks)
