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

On CPU tensors it runs the plain version `lift_accumulate_reference`. A CUDA
tensor never falls back: the kernel launches or the call raises.

No autograd: this is the serving path. Training needs a
`torch.autograd.Function` mirroring `_lift_table_bwd`
(vampire_tpu/ops/pallas_tables.py:374-396); ROADMAP.md lists it.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.sampling import sample_outer_product
from . import _build

# kernel launches made by lift_accumulate_ (incremented at each launch only)
LAUNCHES = 0

_SYMBOLS = {torch.float32: 'lift_accumulate_f32',
            torch.bfloat16: 'lift_accumulate_bf16'}


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


def _kernel(dtype):
    lib = _build.load_library('lift')
    fn = getattr(lib, _SYMBOLS[dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
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
    fn = _kernel(depth.dtype)
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream(depth.device).cuda_stream
        err = fn(depth.data_ptr(), feat.data_ptr(), ids.data_ptr(),
                 coords.data_ptr(), valid.data_ptr(), numer.data_ptr(),
                 denom.data_ptr(), D, H, W, C, K, Q, G, stream)
    if err != 0:
        raise RuntimeError(f'lift: kernel launch failed with CUDA error {err}')
    LAUNCHES += 1
    return numer, denom
