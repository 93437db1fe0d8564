"""The lift: fused outer-product sample + masked-mean accumulate per camera.

`lift_accumulate_(depth, feat, ids, coords, valid, numer, denom)` adds one
camera's contribution into the block-major accumulators of
`FieldBackbone._lift_compact`:

    v[k,q,:]   = sample_outer_product(depth, feat, coords[k,q]) * valid[k,q]
    numer[ids[k], q, :] += v[k,q,:]
    denom[ids[k], q, :] += (|v[k,q,:]| > 0)

On CUDA tensors it launches the hand-written kernel `csrc/lift.cu`, which
replaces the JAX package's TPU kernels `_lift_table_pallas`
(vampire_tpu/ops/pallas_tables.py:289) and `gather_reduce`
(vampire_tpu/ops/pallas_gather.py:68): it reads the 2x2x2 depth corners and
the 2x2 feature block straight from `depth` and `feat` instead of building a
corner table (the camera's inputs sit in L2; the table would cost ~144 MB of
writes and reads per camera). It is bound by the read-modify-write of the
fp32 accumulators; see the source note in csrc/lift.cu for the design.

`lift_backward(depth, feat, ids, coords, valid, g_numer)` is its transpose
for one camera: given g_numer = d numer (G, Q, C) fp32 it returns
(d depth, d feat) in fp32, the JAX package's `_lift_table_bwd`
(vampire_tpu/ops/pallas_tables.py:374-396) composed with the transpose of
the row gather, computed without a table by the second kernel of
`csrc/lift.cu`; `lift_backward_reference` is its plain version. `denom`
counts nonzero samples and takes no gradient, as in the JAX package.

`lift_frame(depth, feat, ids, coords, valid, n_blocks)` is the
differentiable op the model calls: a `torch.autograd.Function` over one
frame's N cameras whose forward runs `lift_accumulate_` per camera into
fresh accumulators and whose backward runs `lift_backward` per camera and
casts to the inputs' dtype, as `_lift_table_bwd` does.

On CPU tensors the wrappers run their plain versions. A CUDA tensor never
falls back: the kernel launches or the call raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.sampling import _prep_axis, sample_outer_product
from . import _build

# kernel launches made by lift_accumulate_ and by lift_backward
# (incremented at each launch only)
LAUNCHES = 0
BWD_LAUNCHES = 0

_SYMBOLS = {torch.float32: 'lift_accumulate_f32',
            torch.bfloat16: 'lift_accumulate_bf16'}
_BWD_SYMBOLS = {torch.float32: 'lift_backward_f32',
                torch.bfloat16: 'lift_backward_bf16'}


def lift_accumulate_reference(depth, feat, ids, coords, valid, numer, denom):
    """Plain torch version of the kernel (any device). Updates numer/denom in
    place and returns them."""
    K, Q = valid.shape
    C = feat.shape[-1]
    v = sample_outer_product(depth, feat, coords.reshape(K * Q, 3),
                             align_corners=False).reshape(K, Q, C)
    v = v * valid[..., None]
    numer.index_add_(0, ids, v)
    denom.index_add_(0, ids, (torch.abs(v) > 0).to(torch.float32))
    return numer, denom


def _check(depth, feat, ids, coords, valid, numer, denom):
    dev = depth.device
    tensors = dict(depth=depth, feat=feat, ids=ids, coords=coords,
                   valid=valid, numer=numer, denom=denom)
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f'lift: {name} is on {t.device}, depth on {dev}')
        if not t.is_contiguous():
            raise ValueError(f'lift: {name} must be contiguous')
    if depth.dtype not in _SYMBOLS or feat.dtype != depth.dtype:
        raise TypeError(f'lift: depth/feat must both be float32 or bfloat16, '
                        f'got {depth.dtype}/{feat.dtype}')
    if ids.dtype != torch.int64:
        raise TypeError(f'lift: ids must be int64, got {ids.dtype}')
    for name in ('coords', 'valid', 'numer', 'denom'):
        if tensors[name].dtype != torch.float32:
            raise TypeError(f'lift: {name} must be float32')
    D, H, W = depth.shape
    K, Q = valid.shape
    C = feat.shape[-1]
    G = numer.shape[0]
    if (feat.shape != (H, W, C) or ids.shape != (K,)
            or coords.shape != (K, Q, 3) or numer.shape != (G, Q, C)
            or denom.shape != (G, Q, C)):
        raise ValueError(
            f'lift: shapes depth {tuple(depth.shape)} feat '
            f'{tuple(feat.shape)} ids {tuple(ids.shape)} coords '
            f'{tuple(coords.shape)} valid {tuple(valid.shape)} numer '
            f'{tuple(numer.shape)} denom {tuple(denom.shape)} do not agree')
    if K * Q >= 2 ** 31:
        raise ValueError(f'lift: K*Q = {K * Q} queries exceed one launch')
    return D, H, W, C, K, Q, G


def _kernel(symbols, dtype, n_ptr):
    lib = _build.load_library('lift')
    fn = getattr(lib, symbols[dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    return fn


def lift_accumulate_(depth, feat, ids, coords, valid, numer, denom):
    """One camera's lift into (G, Q, C) fp32 accumulators, in place.

    Args:
      depth: (D, h, w) depth distribution, float32 or bfloat16.
      feat: (h, w, C) features, same dtype as depth.
      ids: (K,) int64 distinct block ids in [0, G).
      coords: (K, Q, 3) float32 normalized (x, y, z) sample coords.
      valid: (K, Q) float32 validity.
      numer, denom: (G, Q, C) float32 accumulators, updated in place.

    Returns (numer, denom).
    """
    global LAUNCHES
    if depth.device.type == 'cpu':
        return lift_accumulate_reference(depth, feat, ids, coords, valid,
                                         numer, denom)
    if depth.device.type != 'cuda':
        raise NotImplementedError(f'lift: no kernel for {depth.device}')
    D, H, W, C, K, Q, G = _check(depth, feat, ids, coords, valid, numer,
                                 denom)
    fn = _kernel(_SYMBOLS, depth.dtype, 7)
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream(depth.device).cuda_stream
        err = fn(depth.data_ptr(), feat.data_ptr(), ids.data_ptr(),
                 coords.data_ptr(), valid.data_ptr(), numer.data_ptr(),
                 denom.data_ptr(), D, H, W, C, K, Q, G, stream)
    if err != 0:
        raise RuntimeError(f'lift: kernel launch failed with CUDA error {err}')
    LAUNCHES += 1
    return numer, denom


def lift_backward_reference(depth, feat, ids, coords, valid, g_numer):
    """Plain torch transpose of `lift_accumulate_reference`'s numerator for
    one camera (any device): g_numer (G, Q, C) fp32 -> (d depth (D, h, w),
    d feat (h, w, C)), both fp32. With gv = valid * g_numer[ids] and the
    forward's weights, d feat[pix] += wk * gv and d depth[z, pix] +=
    w2d * wz * (feat[pix] . gv), per (dy, dx) pixel corner."""
    D, H, W = depth.shape
    K, Q = valid.shape
    C = feat.shape[-1]
    gv = (g_numer.index_select(0, ids) * valid[..., None]).reshape(K * Q, C)
    c = coords.reshape(K * Q, 3)
    xi, xw, xm = _prep_axis(c[:, 0], W, False)
    yi, yw, ym = _prep_axis(c[:, 1], H, False)
    zi, zw, zm = _prep_axis(c[:, 2], D, False)
    dflat = depth.reshape(D * H * W).to(torch.float32)
    fflat = feat.reshape(H * W, C).to(torch.float32)
    d_depth = torch.zeros(D * H * W, dtype=torch.float32, device=depth.device)
    d_feat = torch.zeros((H * W, C), dtype=torch.float32, device=depth.device)
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


def lift_backward(depth, feat, ids, coords, valid, g_numer):
    """One camera's lift backward: (d depth (D, h, w), d feat (h, w, C)),
    float32, from g_numer = d numer (G, Q, C) float32 and the forward's
    inputs (see `lift_accumulate_`)."""
    global BWD_LAUNCHES
    if depth.device.type == 'cpu':
        return lift_backward_reference(depth, feat, ids, coords, valid,
                                       g_numer)
    if depth.device.type != 'cuda':
        raise NotImplementedError(f'lift: no kernel for {depth.device}')
    D, H, W, C, K, Q, G = _check(depth, feat, ids, coords, valid, g_numer,
                                 g_numer)
    d_depth = torch.zeros((D, H, W), dtype=torch.float32, device=depth.device)
    d_feat = torch.zeros((H, W, C), dtype=torch.float32, device=depth.device)
    fn = _kernel(_BWD_SYMBOLS, depth.dtype, 8)
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream(depth.device).cuda_stream
        err = fn(depth.data_ptr(), feat.data_ptr(), ids.data_ptr(),
                 coords.data_ptr(), valid.data_ptr(), g_numer.data_ptr(),
                 d_depth.data_ptr(), d_feat.data_ptr(), D, H, W, C, K, Q, G,
                 stream)
    if err != 0:
        raise RuntimeError(f'lift: backward kernel launch failed with CUDA '
                           f'error {err}')
    BWD_LAUNCHES += 1
    return d_depth, d_feat


class LiftFrame(torch.autograd.Function):
    """One frame's lift over its N cameras, with its backward. Returns
    (numer, denom), (G, Q, C) fp32; denom takes no gradient. `plain` runs
    the plain versions of both directions."""

    @staticmethod
    def forward(ctx, depth, feat, ids, coords, valid, n_blocks, plain):
        N = depth.shape[0]
        Q, C = valid.shape[-1], feat.shape[-1]
        numer = torch.zeros((n_blocks, Q, C), dtype=torch.float32,
                            device=feat.device)
        denom = torch.zeros_like(numer)
        fwd = lift_accumulate_reference if plain else lift_accumulate_
        for n in range(N):
            fwd(depth[n], feat[n], ids[n], coords[n], valid[n], numer, denom)
        ctx.save_for_backward(depth, feat, ids, coords, valid)
        ctx.plain = plain
        ctx.mark_non_differentiable(denom)
        return numer, denom

    @staticmethod
    def backward(ctx, g_numer, _g_denom):
        depth, feat, ids, coords, valid = ctx.saved_tensors
        bwd = lift_backward_reference if ctx.plain else lift_backward
        g_numer = g_numer.contiguous()
        grads = [bwd(depth[n], feat[n], ids[n], coords[n], valid[n], g_numer)
                 for n in range(depth.shape[0])]
        d_depth = torch.stack([g[0] for g in grads]).to(depth.dtype)
        d_feat = torch.stack([g[1] for g in grads]).to(feat.dtype)
        return d_depth, d_feat, None, None, None, None, None


def lift_frame(depth, feat, ids, coords, valid, n_blocks, plain=False):
    """Differentiable lift of one frame's N cameras into fresh block-major
    accumulators.

    Args:
      depth: (N, D, h, w), feat: (N, h, w, C), both float32 or bfloat16.
      ids: (N, K) int64, each row distinct block ids in [0, n_blocks).
      coords: (N, K, Q, 3), valid: (N, K, Q) float32, per camera as in
        `lift_accumulate_`.
      plain: run the plain versions of the forward and the backward.

    Returns (numer, denom), each (n_blocks, Q, C) float32.
    """
    return LiftFrame.apply(depth, feat, ids, coords, valid, n_blocks, plain)
