"""Sample the fused field's corner table along camera rays and composite.

`sample_and_composite_rays(table, vol_shape, coords, valid, deltas, mids,
bg_depth, density_mode, beta, sdf_bias)` returns (R, 3 + K + 1) fp32
[rgb | seg | depth] per ray; `core.rendering.
sample_and_composite_rays_reference` gives the semantics and is its plain
version. `sample_and_composite_rays_backward(..., out, g_out)` is its
gradient: d table (fp32) and d beta; `core.rendering.
sample_and_composite_rays_backward_reference` is the plain version.
`render_rays(...)` is the differentiable op the model calls: a
`torch.autograd.Function` whose forward and backward are those two.

On CUDA tensors both launch hand-written kernels of `csrc/rays.cu`. The
forward replaces the JAX package's dense ray sampler
`sample_and_composite_rays` (vampire_tpu/core/rendering.py:100), the gather
that the TPU corner table exists for: one launch walks every ray of a
frame, so the gathered samples never reach device memory. The backward
replaces the gradient XLA derives for that sampler under `jax.checkpoint`
(rendering.py:155-176): one launch walks every ray again and scatters into
the table's gradient. On CPU tensors both run their plain versions; a CUDA
tensor never falls back: the kernel launches or the call raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core.rendering import (sample_and_composite_rays_backward_reference,
                              sample_and_composite_rays_reference)
from . import _build

# kernel launches made by sample_and_composite_rays and by
# sample_and_composite_rays_backward (incremented at each launch only)
LAUNCHES = 0
BWD_LAUNCHES = 0

_SYMBOLS = {torch.float32: 'rays_f32', torch.bfloat16: 'rays_bf16'}
_BWD_SYMBOLS = {torch.float32: 'rays_backward_f32',
                torch.bfloat16: 'rays_backward_bf16'}
_MODES = {'sdf': 0, 'naive': 1}


def _check(flat, vol_shape, coords, valid, deltas, mids, beta, **more):
    dev = flat.device
    tensors = dict(table=flat, coords=coords, valid=valid, deltas=deltas,
                   mids=mids, beta=beta, **more)
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f'rays: {name} is on {t.device}, table on {dev}')
        if not t.is_contiguous():
            raise ValueError(f'rays: {name} must be contiguous')
    if flat.dtype not in _SYMBOLS:
        raise TypeError(f'rays: the table must be float32 or bfloat16, got '
                        f'{flat.dtype}')
    for name, t in tensors.items():
        if name != 'table' and t.dtype != torch.float32:
            raise TypeError(f'rays: {name} must be float32')
    D, H, W = vol_shape
    R, S = valid.shape
    C = flat.shape[1] // 8
    if (flat.shape != ((D + 1) * (H + 1) * (W + 1), 8 * C)
            or coords.shape != (R, S, 3) or deltas.shape != (R, S)
            or mids.shape != (S,) or beta.numel() != 1
            or any(t.shape != (R, C) for t in more.values())):
        raise ValueError(
            f'rays: shapes table {tuple(flat.shape)} vol {tuple(vol_shape)} '
            f'coords {tuple(coords.shape)} valid {tuple(valid.shape)} deltas '
            f'{tuple(deltas.shape)} mids {tuple(mids.shape)} beta '
            f'{tuple(beta.shape)} '
            + ' '.join(f'{k} {tuple(t.shape)}' for k, t in more.items())
            + ' do not agree')
    if not 5 <= C <= 32:
        raise ValueError(f'rays: {C} channels; the kernel takes 5 to 32 '
                         f'(one warp lane each)')
    if R >= 2 ** 31:
        raise ValueError(f'rays: {R} rays exceed one launch')
    return R, S, C


def _kernel(symbols, dtype, n_ptr):
    fn = getattr(_build.load_library('rays'), symbols[dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    return fn


def _flat(table, vol_shape, density_mode):
    if density_mode not in _MODES:
        raise ValueError(f'rays: density_mode {density_mode!r}')
    D, H, W = vol_shape
    return table.reshape((D + 1) * (H + 1) * (W + 1), -1)


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
    flat = _flat(table, vol_shape, density_mode)
    D, H, W = vol_shape
    R, S, C = _check(flat, vol_shape, coords, valid, deltas, mids, beta)
    out = torch.empty((R, C), dtype=torch.float32, device=table.device)
    fn = _kernel(_SYMBOLS, flat.dtype, 7)
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


def sample_and_composite_rays_backward(
        table: torch.Tensor, vol_shape: Tuple[int, int, int],
        coords: torch.Tensor, valid: torch.Tensor, deltas: torch.Tensor,
        mids: torch.Tensor, bg_depth: float, density_mode: str,
        beta: torch.Tensor, sdf_bias: float, out: torch.Tensor,
        g_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of `sample_and_composite_rays` at its saved output
    `out`, given g_out = d out (R, 3 + K + 1) float32. Returns (d table
    float32 in the table's flat ((D+1)(H+1)(W+1), 8C) shape, d beta float32
    0-dim; zero for 'naive'). The plain version ignores `out` and sums the
    ray's tail directly."""
    global BWD_LAUNCHES
    if table.device.type == 'cpu':
        return sample_and_composite_rays_backward_reference(
            table, vol_shape, coords, valid, deltas, mids, bg_depth,
            density_mode, beta, sdf_bias, g_out)
    if table.device.type != 'cuda':
        raise NotImplementedError(f'rays: no kernel for {table.device}')
    flat = _flat(table, vol_shape, density_mode)
    D, H, W = vol_shape
    R, S, C = _check(flat, vol_shape, coords, valid, deltas, mids, beta,
                     out=out, g_out=g_out)
    d_table = torch.zeros(flat.shape, dtype=torch.float32,
                          device=table.device)
    d_beta = torch.zeros((), dtype=torch.float32, device=table.device)
    fn = _kernel(_BWD_SYMBOLS, flat.dtype, 10)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(flat.data_ptr(), coords.data_ptr(), valid.data_ptr(),
                 deltas.data_ptr(), mids.data_ptr(), beta.data_ptr(),
                 out.data_ptr(), g_out.data_ptr(), d_table.data_ptr(),
                 d_beta.data_ptr(), R, S, C, D, H, W, _MODES[density_mode],
                 float(sdf_bias), float(bg_depth), stream)
    if err != 0:
        raise RuntimeError(f'rays: backward kernel launch failed with CUDA '
                           f'error {err}')
    BWD_LAUNCHES += 1
    return d_table, d_beta


class RenderRays(torch.autograd.Function):
    """`sample_and_composite_rays` with its backward: gradients reach the
    table (fp32; autograd casts it to the table's dtype) and `beta`. The
    geometry (coords, valid, deltas, mids) takes none and must not ask for
    one. `plain` runs the plain versions of both directions."""

    @staticmethod
    def forward(ctx, table, beta, coords, valid, deltas, mids, vol_shape,
                bg_depth, density_mode, sdf_bias, plain):
        names = ('coords', 'valid', 'deltas', 'mids')
        for name, needs in zip(names, ctx.needs_input_grad[2:6]):
            if needs:
                raise ValueError(f'rays: {name} comes from the geometry and '
                                 f'takes no gradient')
        fwd = (sample_and_composite_rays_reference if plain
               else sample_and_composite_rays)
        out = fwd(table, vol_shape, coords, valid, deltas, mids, bg_depth,
                  density_mode, beta, sdf_bias)
        ctx.save_for_backward(table, beta, coords, valid, deltas, mids, out)
        ctx.args = (vol_shape, bg_depth, density_mode, sdf_bias, plain)
        return out

    @staticmethod
    def backward(ctx, g_out):
        table, beta, coords, valid, deltas, mids, out = ctx.saved_tensors
        vol_shape, bg_depth, density_mode, sdf_bias, plain = ctx.args
        g_out = g_out.contiguous()
        if plain:
            d_table, d_beta = sample_and_composite_rays_backward_reference(
                table, vol_shape, coords, valid, deltas, mids, bg_depth,
                density_mode, beta, sdf_bias, g_out)
        else:
            d_table, d_beta = sample_and_composite_rays_backward(
                table, vol_shape, coords, valid, deltas, mids, bg_depth,
                density_mode, beta, sdf_bias, out, g_out)
        return ((d_table.reshape(table.shape), d_beta.reshape(beta.shape))
                + (None,) * 9)


def render_rays(table: torch.Tensor, vol_shape: Tuple[int, int, int],
                coords: torch.Tensor, valid: torch.Tensor,
                deltas: torch.Tensor, mids: torch.Tensor, bg_depth: float,
                density_mode: str, beta: torch.Tensor, sdf_bias: float,
                plain: bool = False) -> torch.Tensor:
    """Differentiable `sample_and_composite_rays` (same arguments); `plain`
    selects the plain versions of the forward and the backward."""
    return RenderRays.apply(table, beta, coords, valid, deltas, mids,
                            tuple(vol_shape), float(bg_depth), density_mode,
                            float(sdf_bias), plain)
