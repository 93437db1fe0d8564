"""The lift: fused outer-product sample + masked-mean accumulate of a frame.

`lift_frame_accumulate(depth, feat, ids, coords, valid, n_blocks)` lifts one
frame's N cameras into fresh block-major accumulators of
`FieldBackbone._lift_compact`:

    v[n,k,q,:] = sample_outer_product(depth[n], feat[n], coords[n,k,q])
                 * valid[n,k,q]
    numer[ids[n,k], q, :] = sum over the cameras n, in order, of v[n,k,q,:]
    denom[ids[n,k], q, :] = the count of those terms with |v| > 0

On CUDA tensors it is one launch of the hand-written kernel `csrc/lift.cu`,
which replaces the JAX package's TPU kernels `_lift_table_pallas`
(vampire_tpu/ops/pallas_tables.py:289) and `gather_reduce`
(vampire_tpu/ops/pallas_gather.py:68): it reads the 2x2x2 depth corners and
the 2x2 feature block straight from `depth` and `feat` instead of building a
corner table, and each output element is summed in registers over the
cameras and written once (see the source note in csrc/lift.cu).

`lift_frame_backward(depth, feat, ids, coords, valid, g_numer)` is its
transpose: given g_numer = d numer (G, Q, C) fp32 it returns (d depth
(N, D, h, w), d feat (N, h, w, C)) in fp32, the JAX package's
`_lift_table_bwd` (vampire_tpu/ops/pallas_tables.py:374-396) composed with
the transpose of the row gather, in one launch of the second kernel of
`csrc/lift.cu`. `denom` counts nonzero samples and takes no gradient, as in
the JAX package.

`depth=None` is the depth-less mode of the `bilinear` field variant: v is
a 2-D bilinear sample of `feat` at the query's (x, y) (`sample_bilinear`;
zeros padding, align_corners=False), with no depth factor, and the
backward returns (None, d feat). On CUDA tensors it runs kernels of its own
in `csrc/lift.cu`, counted apart (`BILINEAR_LAUNCHES`,
`BILINEAR_BWD_LAUNCHES`): the forward first builds the frame's slot map
(`slot_map`: slots[n, g] = the k with ids[n, k] == g, else -1; one
launch, `SLOT_MAP_LAUNCHES`), then each output block reads its N slots;
the backward sorts each CTA's queries into bins by their top-left pixel
corner and sums a bin's terms for each of its 4 corner pixels before one
reduction into d feat, or scatters each term where a block's footprint
exceeds its shared-memory bins (`bilinear_backward_routes_reference` gives
each CTA's route). It replaces, on the bilinear lift, the JAX
package's corner table of each camera's depth-1 feature volume
(`_corner_table_pallas`, vampire_tpu/ops/pallas_tables.py:73) with the row
gather over it, and the table's VJP (`_corner_table_bwd_impl`, :214).

The plain versions are per camera: `lift_accumulate_reference` and
`lift_backward_reference`, looped over a frame's cameras by
`lift_frame_accumulate_reference` and `lift_frame_backward_reference`; all
four take `depth=None`. `bilinear_lift_frame_accumulate_reference` and
`bilinear_lift_frame_backward_reference` are the depth-less frame versions
by name.

`lift_frame(depth, feat, ids, coords, valid, n_blocks)` is the
differentiable op the model calls: a `torch.autograd.Function` whose forward
and backward are the two frame functions, the gradients cast to the inputs'
dtype, as `_lift_table_bwd` does.

On CPU tensors the wrappers run their plain versions. A CUDA tensor never
falls back: the kernel launches or the call raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core.sampling import _prep_axis, sample_bilinear, sample_outer_product
from . import _build

# kernel launches made by lift_frame_accumulate and by lift_frame_backward
# (incremented at each launch only), in the depth mode and in the depth-less
# mode
LAUNCHES = 0
BWD_LAUNCHES = 0
BILINEAR_LAUNCHES = 0
BILINEAR_BWD_LAUNCHES = 0
# kernel launches made by slot_map (the depth-less forward's first launch)
SLOT_MAP_LAUNCHES = 0

# the most cameras a frame may have (the forward's shared slot array)
MAX_CAMERAS = 32
# the depth-less backward: the most bins (a block's valid queries' top-left
# pixel corners, their bounding box) a CTA sorts in shared memory, as
# kMaxBins of csrc/lift.cu; the routes of a CTA, as kRoute* there
MAX_BINS = 1024
ROUTE_NONE, ROUTE_SORTED, ROUTE_DIRECT = 0, 1, 2

_SYMBOLS = {torch.float32: 'lift_frame_f32',
            torch.bfloat16: 'lift_frame_bf16'}
_BWD_SYMBOLS = {torch.float32: 'lift_frame_backward_f32',
                torch.bfloat16: 'lift_frame_backward_bf16'}
_BILINEAR_SYMBOLS = {torch.float32: 'lift_bilinear_f32',
                     torch.bfloat16: 'lift_bilinear_bf16'}


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


def bilinear_lift_frame_accumulate_reference(feat, ids, coords, valid,
                                             n_blocks):
    """The depth-less frame lift in plain torch: the plain version of the
    kernel's depth-less mode, `lift_frame_accumulate_reference(None, ...)`.
    With a depth of ones at D = 1 and z = 0 (the bilinear lift's coords),
    the depth mode's plain version computes the same terms."""
    return lift_frame_accumulate_reference(None, feat, ids, coords, valid,
                                           n_blocks)


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


def slot_map_reference(ids: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """Plain version of `slot_map` (any device): (N, n_blocks) int32,
    slots[n, ids[n, k]] = k, else -1; ids outside [0, n_blocks) are
    ignored."""
    N, K = ids.shape
    slots = torch.full((N, n_blocks), -1, dtype=torch.int32,
                       device=ids.device)
    ks = torch.arange(K, dtype=torch.int32, device=ids.device)
    for n in range(N):
        keep = (ids[n] >= 0) & (ids[n] < n_blocks)
        slots[n, ids[n][keep]] = ks[keep]
    return slots


def slot_map(ids: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """Each camera's slot of each block, (N, n_blocks) int32: the k with
    ids[n, k] == g, else -1 (ids (N, K) int64, distinct within a camera;
    ids outside [0, n_blocks) ignored). On CUDA tensors one launch of the
    hand-written `slot_map_kernel` (csrc/lift.cu: a CTA a camera stages its
    row in shared memory and writes it once); it replaces the scan of the
    frame's N x K ids that every CTA of the depth-less forward made. On CPU
    tensors its plain version. The depth-less forward launches the same
    kernel itself, in the call that launches its own."""
    global SLOT_MAP_LAUNCHES
    if ids.device.type == 'cpu':
        return slot_map_reference(ids, n_blocks)
    if ids.device.type != 'cuda':
        raise NotImplementedError(f'lift: no kernel for {ids.device}')
    if ids.dtype != torch.int64 or ids.dim() != 2 or not ids.is_contiguous():
        raise ValueError(f'lift: ids must be a contiguous (N, K) int64 '
                         f'tensor, got {ids.dtype} {tuple(ids.shape)}')
    N, K = ids.shape
    slots = torch.empty((N, int(n_blocks)), dtype=torch.int32,
                        device=ids.device)
    fn = _build.kernel('lift', 'slot_map', [ctypes.c_void_p] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    err = _build.launch(fn, ids.device, ids.data_ptr(), slots.data_ptr(), N,
                        K, int(n_blocks))
    if err != 0:
        raise RuntimeError(f'lift: slot map launch failed with CUDA error '
                           f'{err}')
    SLOT_MAP_LAUNCHES += 1
    return slots


def bilinear_backward_routes_reference(feat_hw, ids, coords, valid,
                                       n_blocks):
    """The route each CTA (camera n, selected block k) of the depth-less
    backward takes, (N, K) int32, by the kernel's rule: ROUTE_NONE where
    ids[n, k] lies outside [0, n_blocks); else ROUTE_SORTED where the
    bounding box of its valid queries' bins (each query's unclamped
    top-left pixel corner (y0, x0), those with a corner in the (h, w)
    image) holds at most MAX_BINS bins and Q fits the shared arrays;
    ROUTE_DIRECT otherwise."""
    H, W = feat_hw
    N, K, Q = valid.shape
    x = ((coords[..., 0] + 1.0) * W - 1.0) / 2.0
    y = ((coords[..., 1] + 1.0) * H - 1.0) / 2.0
    x0, y0 = torch.floor(x), torch.floor(y)
    live = ((valid != 0) & (x0 >= -1) & (x0 <= W - 1) & (y0 >= -1)
            & (y0 <= H - 1))
    big, small = torch.finfo(torch.float32).max, torch.finfo(
        torch.float32).min
    span = [(torch.where(live, a, small).amax(-1)
             - torch.where(live, a, big).amin(-1) + 1) for a in (y0, x0)]
    bins = torch.where(live.any(-1), span[0] * span[1], 0.0)
    sortable = Q < 65536 and H < 32767 and W < 65535 and (
        Q * 18 + (MAX_BINS + 1) * 4 <= 48 * 1024)
    routes = torch.where((bins <= MAX_BINS) & sortable, ROUTE_SORTED,
                         ROUTE_DIRECT)
    routes = torch.where((ids >= 0) & (ids < n_blocks), routes, ROUTE_NONE)
    return routes.to(torch.int32)


def bilinear_lift_frame_backward_reference(feat, ids, coords, valid,
                                           g_numer):
    """The depth-less frame lift's backward in plain torch: d feat
    (N, h, w, C) fp32, the plain version of the backward kernel's
    depth-less mode."""
    return lift_frame_backward_reference(None, feat, ids, coords, valid,
                                         g_numer)[1]


def _check(depth, feat, ids, coords, valid, n_blocks, g_numer=None):
    """The checks the wrappers make before a launch; returns the sizes
    (N, D, H, W, C, K, Q, G), D = 1 where depth is None."""
    dev = feat.device
    tensors = dict(depth=depth, feat=feat, ids=ids, coords=coords,
                   valid=valid, g_numer=g_numer)
    tensors = {k: t for k, t in tensors.items() if t is not None}
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f'lift: {name} is on {t.device}, feat on {dev}')
        if not t.is_contiguous():
            raise ValueError(f'lift: {name} must be contiguous')
    if feat.dtype not in _SYMBOLS or (depth is not None
                                      and depth.dtype != feat.dtype):
        raise TypeError(f'lift: depth/feat must both be float32 or bfloat16, '
                        f'got {None if depth is None else depth.dtype}/'
                        f'{feat.dtype}')
    if ids.dtype != torch.int64:
        raise TypeError(f'lift: ids must be int64, got {ids.dtype}')
    for name in ('coords', 'valid', 'g_numer'):
        if name in tensors and tensors[name].dtype != torch.float32:
            raise TypeError(f'lift: {name} must be float32')
    if (depth is not None and depth.dim() != 4) or feat.dim() != 4 \
            or valid.dim() != 3:
        raise ValueError(f'lift: depth '
                         f'{None if depth is None else tuple(depth.shape)} '
                         f'must be (N, D, h, w), feat {tuple(feat.shape)} '
                         f'(N, h, w, C) and valid {tuple(valid.shape)} '
                         f'(N, K, Q)')
    N, H, W, C = feat.shape
    D = 1 if depth is None else depth.shape[1]
    _, K, Q = valid.shape
    G = int(n_blocks)
    if (valid.shape[0] != N
            or (depth is not None and depth.shape != (N, D, H, W))
            or ids.shape != (N, K) or coords.shape != (N, K, Q, 3)
            or (g_numer is not None and g_numer.shape != (G, Q, C))):
        raise ValueError(
            f'lift: shapes depth '
            f'{None if depth is None else tuple(depth.shape)} feat '
            f'{tuple(feat.shape)} ids {tuple(ids.shape)} coords '
            f'{tuple(coords.shape)} valid {tuple(valid.shape)}'
            + ('' if g_numer is None else
               f' g_numer {tuple(g_numer.shape)}')
            + f' n_blocks {G} do not agree')
    if N > MAX_CAMERAS or G >= 2 ** 16 or K >= 2 ** 31:
        raise ValueError(f'lift: {N} cameras (at most {MAX_CAMERAS}), '
                         f'{G} blocks (under 65536), {K} selected a camera')
    if C > (128 if C % 4 == 0 else 32):
        raise ValueError(f'lift: {C} channels; the kernels take up to 32, '
                         f'or up to 128 in multiples of 4')
    if D * H * W * max(C, 1) >= 2 ** 31:
        raise ValueError(f'lift: a camera of {D}x{H}x{W}x{C} exceeds the '
                         f'kernels\' 32-bit offsets')
    # where the kernels read 4 channels at a time (the forward at C = 16,
    # its depth-less mode and the backward at C % 4 == 0), feat must start
    # on 4 elements and g_numer on 16 bytes
    if C == 16 or (C % 4 == 0 and (g_numer is not None or depth is None)):
        if feat.data_ptr() % (4 * feat.element_size()):
            raise ValueError(f'lift: feat must start on '
                             f'{4 * feat.element_size()} bytes')
        if g_numer is not None and g_numer.data_ptr() % 16:
            raise ValueError('lift: g_numer must start on 16 bytes')
    return N, D, H, W, C, K, Q, G


def _kernel(symbol, n_ptr):
    """The typed entry point: n_ptr pointers, 8 sizes, the stream."""
    return _build.kernel('lift', symbol, [ctypes.c_void_p] * n_ptr
                         + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def lift_frame_accumulate(depth: torch.Tensor, feat: torch.Tensor,
                          ids: torch.Tensor, coords: torch.Tensor,
                          valid: torch.Tensor, n_blocks: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame's lift into fresh (n_blocks, Q, C) fp32 accumulators.

    Args:
      depth: (N, D, h, w) depth distributions, float32 or bfloat16; None
        for the depth-less mode (the bilinear lift).
      feat: (N, h, w, C) features, same dtype as depth.
      ids: (N, K) int64, each row distinct block ids; ids outside
        [0, n_blocks) are ignored.
      coords: (N, K, Q, 3) float32 normalized (x, y, z) sample coords (z
        unread in the depth-less mode).
      valid: (N, K, Q) float32 validity.

    Returns (numer, denom).
    """
    global LAUNCHES, BILINEAR_LAUNCHES, SLOT_MAP_LAUNCHES
    if feat.device.type == 'cpu':
        return lift_frame_accumulate_reference(depth, feat, ids, coords,
                                               valid, n_blocks)
    if feat.device.type != 'cuda':
        raise NotImplementedError(f'lift: no kernel for {feat.device}')
    N, D, H, W, C, K, Q, G = _check(depth, feat, ids, coords, valid,
                                    n_blocks)
    numer = torch.empty((G, Q, C), dtype=torch.float32, device=feat.device)
    denom = torch.empty_like(numer)
    if depth is None:
        # one call launches the slot map and the forward that reads it
        slots = torch.empty((N, G), dtype=torch.int32, device=feat.device)
        err = _build.launch(
            _build.kernel('lift', _BILINEAR_SYMBOLS[feat.dtype],
                          [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                          + [ctypes.c_void_p]), feat.device,
            feat.data_ptr(), ids.data_ptr(), slots.data_ptr(),
            coords.data_ptr(), valid.data_ptr(), numer.data_ptr(),
            denom.data_ptr(), N, H, W, C, K, Q, G)
    else:
        err = _build.launch(_kernel(_SYMBOLS[feat.dtype], 7), feat.device,
                            depth.data_ptr(), feat.data_ptr(),
                            ids.data_ptr(), coords.data_ptr(),
                            valid.data_ptr(), numer.data_ptr(),
                            denom.data_ptr(), N, D, H, W, C, K, Q, G)
    if err != 0:
        raise RuntimeError(f'lift: kernel launch failed with CUDA error {err}')
    if depth is None:
        SLOT_MAP_LAUNCHES += 1
        BILINEAR_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return numer, denom


def lift_frame_backward(depth: torch.Tensor, feat: torch.Tensor,
                        ids: torch.Tensor, coords: torch.Tensor,
                        valid: torch.Tensor, g_numer: torch.Tensor,
                        routes: torch.Tensor = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame's lift backward: (d depth (N, D, h, w), d feat
    (N, h, w, C)), float32, from g_numer = d numer (G, Q, C) float32 and the
    forward's inputs (see `lift_frame_accumulate`); (None, d feat) with
    depth None. `routes`, a contiguous (N, K) int32 tensor on the card,
    receives the route of each CTA of the depth-less kernel
    (`bilinear_backward_routes_reference`); the plain versions and the
    depth mode do not write it."""
    global BWD_LAUNCHES, BILINEAR_BWD_LAUNCHES
    if feat.device.type == 'cpu':
        return lift_frame_backward_reference(depth, feat, ids, coords, valid,
                                             g_numer)
    if feat.device.type != 'cuda':
        raise NotImplementedError(f'lift: no kernel for {feat.device}')
    N, D, H, W, C, K, Q, G = _check(depth, feat, ids, coords, valid,
                                    g_numer.shape[0], g_numer)
    # one buffer for the whole frame, zeroed once; d feat starts on 16
    # bytes (the kernel adds into it four floats at a time)
    nd = 0 if depth is None else N * D * H * W
    off = -(-nd // 4) * 4
    grads = torch.zeros(off + N * H * W * C, dtype=torch.float32,
                        device=feat.device)
    d_depth = None if depth is None else grads[:nd].view(N, D, H, W)
    d_feat = grads[off:].view(N, H, W, C)
    if depth is None:
        if routes is not None and (
                routes.shape != (N, K) or routes.dtype != torch.int32
                or routes.device != feat.device
                or not routes.is_contiguous()):
            raise ValueError(f'lift: routes must be a contiguous ({N}, {K}) '
                             f'int32 tensor on {feat.device}')
        err = _build.launch(
            _build.kernel('lift', 'lift_bilinear_backward',
                          [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                          + [ctypes.c_void_p]), feat.device,
            ids.data_ptr(), coords.data_ptr(), valid.data_ptr(),
            g_numer.data_ptr(), d_feat.data_ptr(),
            None if routes is None else routes.data_ptr(), N, H, W, C, K, Q,
            G)
    else:
        err = _build.launch(_kernel(_BWD_SYMBOLS[feat.dtype], 8),
                            feat.device, depth.data_ptr(), feat.data_ptr(),
                            ids.data_ptr(), coords.data_ptr(),
                            valid.data_ptr(), g_numer.data_ptr(),
                            d_depth.data_ptr(), d_feat.data_ptr(), N, D, H, W,
                            C, K, Q, G)
    if err != 0:
        raise RuntimeError(f'lift: backward kernel launch failed with CUDA '
                           f'error {err}')
    if depth is None:
        BILINEAR_BWD_LAUNCHES += 1
    else:
        BWD_LAUNCHES += 1
    return d_depth, d_feat


class LiftFrame(torch.autograd.Function):
    """One frame's lift over its N cameras, with its backward. Returns
    (numer, denom), (G, Q, C) fp32; denom takes no gradient. `plain` runs
    the plain versions of both directions."""

    @staticmethod
    def forward(ctx, depth, feat, ids, coords, valid, n_blocks, plain):
        fwd = (lift_frame_accumulate_reference if plain
               else lift_frame_accumulate)
        numer, denom = fwd(depth, feat, ids, coords, valid, n_blocks)
        ctx.save_for_backward(depth, feat, ids, coords, valid)
        ctx.plain = plain
        ctx.mark_non_differentiable(denom)
        return numer, denom

    @staticmethod
    def backward(ctx, g_numer, _g_denom):
        depth, feat, ids, coords, valid = ctx.saved_tensors
        bwd = (lift_frame_backward_reference if ctx.plain
               else lift_frame_backward)
        d_depth, d_feat = bwd(depth, feat, ids, coords, valid,
                              g_numer.contiguous())
        return (None if depth is None else d_depth.to(depth.dtype),
                d_feat.to(feat.dtype), None, None, None, None, None)


def lift_frame(depth, feat, ids, coords, valid, n_blocks, plain=False):
    """Differentiable lift of one frame's N cameras into fresh block-major
    accumulators.

    Args:
      depth: (N, D, h, w), feat: (N, h, w, C), both float32 or bfloat16;
        depth None runs the depth-less mode (the bilinear lift).
      ids: (N, K) int64, each row distinct block ids in [0, n_blocks).
      coords: (N, K, Q, 3), valid: (N, K, Q) float32, as in
        `lift_frame_accumulate`.
      plain: run the plain versions of the forward and the backward.

    Returns (numer, denom), each (n_blocks, Q, C) float32.
    """
    return LiftFrame.apply(depth, feat, ids, coords, valid, n_blocks, plain)
