"""Sample the fused field's corner table along camera rays and composite.

`sample_and_composite_rays(table, vol_shape, coords, valid, deltas, mids,
bg_depth, density_mode, beta, sdf_bias)` returns (R, 3 + K + 1) fp32
[rgb | seg | depth] per ray; `core.rendering.
sample_and_composite_rays_reference` gives the semantics and is its plain
version.

On CUDA tensors it launches the hand-written kernel `csrc/rays.cu`, which
replaces the JAX package's dense ray sampler `sample_and_composite_rays`
(vampire_tpu/core/rendering.py:100), the gather that the TPU corner table
exists for: one launch walks every ray of a frame, so the gathered samples
never reach device memory. On CPU tensors it runs the plain version; a CUDA
tensor never falls back: the kernel launches or the call raises.

No autograd: this is the serving path (the train-mode samplers are not
ported; ROADMAP.md).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core.rendering import sample_and_composite_rays_reference
from . import _build

# kernel launches made by sample_and_composite_rays (incremented at each
# launch only)
LAUNCHES = 0

_SYMBOLS = {torch.float32: 'rays_f32', torch.bfloat16: 'rays_bf16'}
_MODES = {'sdf': 0, 'naive': 1}


def _check(flat, vol_shape, coords, valid, deltas, mids, beta):
    dev = flat.device
    tensors = dict(table=flat, coords=coords, valid=valid, deltas=deltas,
                   mids=mids, beta=beta)
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f'rays: {name} is on {t.device}, table on {dev}')
        if not t.is_contiguous():
            raise ValueError(f'rays: {name} must be contiguous')
    if flat.dtype not in _SYMBOLS:
        raise TypeError(f'rays: the table must be float32 or bfloat16, got '
                        f'{flat.dtype}')
    for name in ('coords', 'valid', 'deltas', 'mids', 'beta'):
        if tensors[name].dtype != torch.float32:
            raise TypeError(f'rays: {name} must be float32')
    D, H, W = vol_shape
    R, S = valid.shape
    C = flat.shape[1] // 8
    if (flat.shape != ((D + 1) * (H + 1) * (W + 1), 8 * C)
            or coords.shape != (R, S, 3) or deltas.shape != (R, S)
            or mids.shape != (S,) or beta.numel() != 1):
        raise ValueError(
            f'rays: shapes table {tuple(flat.shape)} vol {tuple(vol_shape)} '
            f'coords {tuple(coords.shape)} valid {tuple(valid.shape)} deltas '
            f'{tuple(deltas.shape)} mids {tuple(mids.shape)} beta '
            f'{tuple(beta.shape)} do not agree')
    if not 5 <= C <= 32:
        raise ValueError(f'rays: {C} channels; the kernel takes 5 to 32 '
                         f'(one warp lane each)')
    if R >= 2 ** 31:
        raise ValueError(f'rays: {R} rays exceed one launch')
    return R, S, C


def _kernel(dtype):
    fn = getattr(_build.load_library('rays'), _SYMBOLS[dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    return fn


def sample_and_composite_rays(table: torch.Tensor,
                              vol_shape: Tuple[int, int, int],
                              coords: torch.Tensor, valid: torch.Tensor,
                              deltas: torch.Tensor, mids: torch.Tensor,
                              bg_depth: float, density_mode: str,
                              beta: torch.Tensor,
                              sdf_bias: float) -> torch.Tensor:
    """Render R rays of S samples through a corner table.

    Args:
      table: the corner table of the fused (C, D, H, W) field
        (`ops.tables.corner_table` or `build_neighborhood_table`), float32
        or bfloat16; C = 1 + K + 3 channels [sdf | seg | rgb].
      vol_shape: (D, H, W).
      coords: (R, S, 3), valid: (R, S), deltas: (R, S), mids: (S,), all
        float32: normalized sample coords, in-range mask, path lengths,
        depth-bin midpoints.
      bg_depth: depth given to the untouched remainder of each ray.
      density_mode: 'sdf' (Laplace density of `beta`, a float32 tensor of
        one element, and `sdf_bias`) or 'naive' (sigmoid; `beta` and
        `sdf_bias` are not read).

    Returns (R, 3 + K + 1) float32.
    """
    global LAUNCHES
    if table.device.type == 'cpu':
        return sample_and_composite_rays_reference(
            table, vol_shape, coords, valid, deltas, mids, bg_depth,
            density_mode, beta, sdf_bias)
    if table.device.type != 'cuda':
        raise NotImplementedError(f'rays: no kernel for {table.device}')
    if density_mode not in _MODES:
        raise ValueError(f'rays: density_mode {density_mode!r}')
    D, H, W = vol_shape
    flat = table.reshape((D + 1) * (H + 1) * (W + 1), -1)
    beta = beta.detach()
    R, S, C = _check(flat, vol_shape, coords, valid, deltas, mids, beta)
    out = torch.empty((R, C), dtype=torch.float32, device=table.device)
    fn = _kernel(flat.dtype)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(flat.data_ptr(), coords.data_ptr(), valid.data_ptr(),
                 deltas.data_ptr(), mids.data_ptr(), beta.data_ptr(),
                 out.data_ptr(), R, S, C, D, H, W, _MODES[density_mode],
                 float(sdf_bias), float(bg_depth), stream)
    if err != 0:
        raise RuntimeError(f'rays: kernel launch failed with CUDA error {err}')
    LAUNCHES += 1
    return out
