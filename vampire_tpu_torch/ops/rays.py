"""Sample the fused field along camera rays and composite.

`sample_and_composite_rays(field, coords, valid, deltas, mids, bg_depth,
density_mode, beta, sdf_bias)` returns (R, 3 + K + 1) fp32 [rgb | seg |
depth] per ray from a channels-last (D, H, W, C) field;
`core.rendering.sample_and_composite_rays_field_reference` gives the
semantics and is its plain version.
`sample_and_composite_rays_backward(..., out, g_out)` is its gradient: d
field (fp32, channels-last) and d beta;
`core.rendering.sample_and_composite_rays_field_backward_reference` is the
plain version. `render_rays(...)` is the differentiable op the model calls:
a `torch.autograd.Function` whose forward and backward are those two.
`channels_last_field(vol)` makes the field from a (C, D, H, W) volume,
differentiably, in the layout the kernels read.

On CUDA tensors both launch hand-written kernels of `csrc/rays.cu`. The
forward replaces the JAX package's dense ray sampler
`sample_and_composite_rays` (vampire_tpu/core/rendering.py:100): one
launch walks every ray of a frame, reading each sample's 8 corners from the
field, so neither the gathered samples nor a corner table reach device
memory. The backward replaces the gradient XLA derives for that sampler
under `jax.checkpoint` (rendering.py:155-176) and the corner table's VJP
after it: one launch walks every ray again and scatters into the field's
gradient. On CPU tensors both run their plain versions; a CUDA tensor never
falls back: the kernel launches or the call raises.

The kernels read each voxel in 16-byte loads, so on a card the field's
voxels must start 16 bytes apart: `channels_last_field` makes it the
channel slice `padded[..., :C]` of a zero-padded channels-last (D, H, W,
CS) copy, CS * itemsize a multiple of 16 (24 for the flagship's 22 bf16
channels). The plain versions take any strides.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core.rendering import (
    sample_and_composite_rays_field_backward_reference,
    sample_and_composite_rays_field_reference)
from . import _build

# kernel launches made by sample_and_composite_rays and by
# sample_and_composite_rays_backward (incremented at each launch only)
LAUNCHES = 0
BWD_LAUNCHES = 0

_SYMBOLS = {torch.float32: 'rays_f32', torch.bfloat16: 'rays_bf16'}
_BWD_SYMBOLS = {torch.float32: 'rays_backward_f32',
                torch.bfloat16: 'rays_backward_bf16'}
_MODES = {'sdf': 0, 'naive': 1}


def channel_stride(field: torch.Tensor) -> int:
    """The voxel stride CS of a (D, H, W, C) field whose channels are
    contiguous and whose voxels follow each other at one stride (a
    channels-last tensor or a channel slice of one); raises otherwise, and
    where the voxels do not start on 16 bytes."""
    if field.dim() != 4:
        raise ValueError(f'rays: the field must be (D, H, W, C), got '
                         f'{tuple(field.shape)}')
    D, H, W, C = field.shape
    CS = field.stride(2) if W > 1 else C
    want = (H * W * CS, W * CS, CS, 1)
    if (CS < C or any(n > 1 and field.stride(d) != s
                      for d, (n, s) in enumerate(zip(field.shape, want)))):
        raise ValueError(f'rays: field strides {field.stride()} are not '
                         f'channels-last for {tuple(field.shape)}')
    if (CS * field.element_size()) % 16 or field.data_ptr() % 16:
        raise ValueError(f'rays: the field\'s voxels must start on 16 bytes '
                         f'(voxel stride {CS}); use channels_last_field')
    return CS


def _check(field, coords, valid, deltas, mids, beta, **more):
    dev = field.device
    tensors = dict(coords=coords, valid=valid, deltas=deltas, mids=mids,
                   beta=beta, **more)
    if field.dtype not in _SYMBOLS:
        raise TypeError(f'rays: the field must be float32 or bfloat16, got '
                        f'{field.dtype}')
    CS = channel_stride(field)
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f'rays: {name} is on {t.device}, field on {dev}')
        if not t.is_contiguous():
            raise ValueError(f'rays: {name} must be contiguous')
        if t.dtype != torch.float32:
            raise TypeError(f'rays: {name} must be float32')
    C = field.shape[3]
    R, S = valid.shape
    if (coords.shape != (R, S, 3) or deltas.shape != (R, S)
            or mids.shape != (S,) or beta.numel() != 1
            or any(t.shape != (R, C) for t in more.values())):
        raise ValueError(
            f'rays: shapes field {tuple(field.shape)} coords '
            f'{tuple(coords.shape)} valid {tuple(valid.shape)} deltas '
            f'{tuple(deltas.shape)} mids {tuple(mids.shape)} beta '
            f'{tuple(beta.shape)} '
            + ' '.join(f'{k} {tuple(t.shape)}' for k, t in more.items())
            + ' do not agree')
    if not 5 <= C <= 32:
        raise ValueError(f'rays: {C} channels; the kernel takes 5 to 32')
    if R >= 2 ** 31 // 32:
        raise ValueError(f'rays: {R} rays exceed one launch')
    if field.shape[0] * field.shape[1] * field.shape[2] * CS >= 2 ** 31:
        raise ValueError(f'rays: a field of {tuple(field.shape)} at stride '
                         f'{CS} exceeds the kernel\'s 32-bit offsets')
    return R, S, C, CS


def _kernel(symbols, dtype, n_ptr):
    """The typed entry point: n_ptr pointers, 8 ints, 2 floats, the
    stream."""
    return _build.kernel('rays', symbols[dtype], [ctypes.c_void_p] * n_ptr
                         + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
                         + [ctypes.c_void_p])


def _launch(fn, field, ptrs, R, S, C, CS, density_mode, sdf_bias, bg_depth):
    """Launch on the current stream of the field's card; returns the CUDA
    error code."""
    if density_mode not in _MODES:
        raise ValueError(f'rays: density_mode {density_mode!r}')
    D, H, W = field.shape[:3]
    return _build.launch(fn, field.device, field.data_ptr(), *ptrs, R, S, C,
                         CS, D, H, W, _MODES[density_mode], float(sdf_bias),
                         float(bg_depth))


def sample_and_composite_rays(field: torch.Tensor, coords: torch.Tensor,
                              valid: torch.Tensor, deltas: torch.Tensor,
                              mids: torch.Tensor, bg_depth: float,
                              density_mode: str, beta: torch.Tensor,
                              sdf_bias: float) -> torch.Tensor:
    """Render R rays of S samples through a channels-last field.

    Args:
      field: the fused field (D, H, W, C), float32 or bfloat16, C = 1 + K +
        3 channels [sdf | seg | rgb]; channels-last (`channel_stride`).
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
    if field.device.type == 'cpu':
        return sample_and_composite_rays_field_reference(
            field, coords, valid, deltas, mids, bg_depth, density_mode, beta,
            sdf_bias)
    if field.device.type != 'cuda':
        raise NotImplementedError(f'rays: no kernel for {field.device}')
    R, S, C, CS = _check(field, coords, valid, deltas, mids, beta)
    out = torch.empty((R, C), dtype=torch.float32, device=field.device)
    err = _launch(_kernel(_SYMBOLS, field.dtype, 7), field,
                  (coords.data_ptr(), valid.data_ptr(), deltas.data_ptr(),
                   mids.data_ptr(), beta.data_ptr(), out.data_ptr()),
                  R, S, C, CS, density_mode, sdf_bias, bg_depth)
    if err != 0:
        raise RuntimeError(f'rays: kernel launch failed with CUDA error {err}')
    LAUNCHES += 1
    return out


def sample_and_composite_rays_backward(
        field: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
        deltas: torch.Tensor, mids: torch.Tensor, bg_depth: float,
        density_mode: str, beta: torch.Tensor, sdf_bias: float,
        out: torch.Tensor, g_out: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of `sample_and_composite_rays` at its saved output
    `out`, given g_out = d out (R, 3 + K + 1) float32. Returns (d field
    float32 of the field's (D, H, W, C) shape, a channel slice of a
    (D, H, W, CS) buffer on the card; d beta float32 0-dim, zero for
    'naive'). The plain version ignores `out` and sums the ray's tail
    directly."""
    global BWD_LAUNCHES
    if field.device.type == 'cpu':
        return sample_and_composite_rays_field_backward_reference(
            field, coords, valid, deltas, mids, bg_depth, density_mode, beta,
            sdf_bias, g_out)
    if field.device.type != 'cuda':
        raise NotImplementedError(f'rays: no kernel for {field.device}')
    R, S, C, CS = _check(field, coords, valid, deltas, mids, beta, out=out,
                         g_out=g_out)
    D, H, W = field.shape[:3]
    d_field = torch.zeros((D, H, W, CS), dtype=torch.float32,
                          device=field.device)
    d_beta = torch.zeros((), dtype=torch.float32, device=field.device)
    err = _launch(_kernel(_BWD_SYMBOLS, field.dtype, 10), field,
                  (coords.data_ptr(), valid.data_ptr(), deltas.data_ptr(),
                   mids.data_ptr(), beta.data_ptr(), out.data_ptr(),
                   g_out.data_ptr(), d_field.data_ptr(), d_beta.data_ptr()),
                  R, S, C, CS, density_mode, sdf_bias, bg_depth)
    if err != 0:
        raise RuntimeError(f'rays: backward kernel launch failed with CUDA '
                           f'error {err}')
    BWD_LAUNCHES += 1
    return d_field[..., :C], d_beta


def plan(dtype: torch.dtype, channels: int, backward: bool = False) -> dict:
    """The launch of the kernel (or of its backward) for a field of
    `channels` channels on the current card: blocks per SM (the occupancy
    API's count), registers a thread, the channels the registers hold
    (CMAX), threads a block."""
    fn = _build.kernel('rays', 'rays_plan',
                       [ctypes.c_int] * 3 + [ctypes.c_void_p])
    info = (ctypes.c_int * 4)()
    err = fn(int(dtype == torch.bfloat16), channels, int(backward),
             ctypes.cast(info, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f'rays: rays_plan failed with CUDA error {err}')
    return dict(blocks_per_sm=info[0], regs=info[1], cmax=info[2],
                threads=info[3])


class ChannelsLastField(torch.autograd.Function):
    """(C, D, H, W) -> the channel slice [..., :C] of a zero-padded
    channels-last (D, H, W, CS) copy, CS the least voxel stride >= C whose
    bytes are a multiple of 16 (the padding is empty where C already is).
    The backward permutes the gradient back to (C, D, H, W), contiguous."""

    @staticmethod
    def forward(ctx, vol):
        C = vol.shape[0]
        per = 16 // vol.element_size()
        pad = -C % per
        field = vol.permute(1, 2, 3, 0)
        if pad == 0:
            return field.contiguous()
        return torch.nn.functional.pad(field, (0, pad))[..., :C]

    @staticmethod
    def backward(ctx, g):
        return g.permute(3, 0, 1, 2).contiguous()


def channels_last_field(vol: torch.Tensor) -> torch.Tensor:
    """The ray sampler's field of a (C, D, H, W) volume, differentiable:
    channels-last, each voxel's C channels starting on 16 bytes
    (`ChannelsLastField`)."""
    return ChannelsLastField.apply(vol)


class RenderRays(torch.autograd.Function):
    """`sample_and_composite_rays` with its backward: gradients reach the
    field (summed in fp32, cast to the field's dtype) and `beta`. The
    geometry (coords, valid, deltas, mids) takes none and must not ask for
    one. `plain` runs the plain versions of both directions."""

    @staticmethod
    def forward(ctx, field, beta, coords, valid, deltas, mids, bg_depth,
                density_mode, sdf_bias, plain):
        names = ('coords', 'valid', 'deltas', 'mids')
        for name, needs in zip(names, ctx.needs_input_grad[2:6]):
            if needs:
                raise ValueError(f'rays: {name} comes from the geometry and '
                                 f'takes no gradient')
        fwd = (sample_and_composite_rays_field_reference if plain
               else sample_and_composite_rays)
        out = fwd(field, coords, valid, deltas, mids, bg_depth, density_mode,
                  beta, sdf_bias)
        ctx.save_for_backward(field, beta, coords, valid, deltas, mids, out)
        ctx.args = (bg_depth, density_mode, sdf_bias, plain)
        return out

    @staticmethod
    def backward(ctx, g_out):
        field, beta, coords, valid, deltas, mids, out = ctx.saved_tensors
        bg_depth, density_mode, sdf_bias, plain = ctx.args
        g_out = g_out.contiguous()
        if plain:
            d_field, d_beta = (
                sample_and_composite_rays_field_backward_reference(
                    field, coords, valid, deltas, mids, bg_depth,
                    density_mode, beta, sdf_bias, g_out))
        else:
            d_field, d_beta = sample_and_composite_rays_backward(
                field, coords, valid, deltas, mids, bg_depth, density_mode,
                beta, sdf_bias, out, g_out)
        # fp32 sums, rounded once to the field's dtype (as autograd would)
        return ((d_field.to(field.dtype), d_beta.reshape(beta.shape))
                + (None,) * 8)


def render_rays(field: torch.Tensor, coords: torch.Tensor,
                valid: torch.Tensor, deltas: torch.Tensor, mids: torch.Tensor,
                bg_depth: float, density_mode: str, beta: torch.Tensor,
                sdf_bias: float, plain: bool = False) -> torch.Tensor:
    """Differentiable `sample_and_composite_rays` (same arguments); `plain`
    selects the plain versions of the forward and the backward."""
    return RenderRays.apply(field, beta, coords, valid, deltas, mids,
                            float(bg_depth), density_mode, float(sdf_bias),
                            plain)
