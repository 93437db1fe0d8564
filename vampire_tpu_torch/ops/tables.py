"""The corner-block table of the fused field, and its backward.

`corner_table(vol)` maps a channels-first volume (C, D, H, W) to its
(D+1, H+1, W+1, 8*C) corner-block table (`core.sampling.
corner_table_reference` gives the semantics). The camera-ray branch builds
it once per frame from the bf16 fused field [sdf | seg | rgb], and the ray
sampler (`ops/rays.py`) reads it. The build is linear; its transpose,
`corner_table_backward(g, vol_shape)`, sums the 8 shifted slices of the
table's cotangent g into a (C, D, H, W) fp32 d vol
(`corner_table_backward_reference` is the plain version).
`build_corner_table(vol)` is the differentiable op the model calls: a
`torch.autograd.Function` whose forward and backward are those two.

On CUDA tensors both launch hand-written kernels of `csrc/corner_table.cu`.
The forward replaces the JAX package's TPU kernel `_corner_table_pallas`
(vampire_tpu/ops/pallas_tables.py:73) and is byte-identical to its plain
version; the backward replaces `_corner_table_bwd_impl`
(pallas_tables.py:214-226), sums in the plain version's order and agrees
with it bit for bit. On CPU tensors both run their plain versions; a CUDA
tensor never falls back: the kernel launches or the call raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core.sampling import corner_table_reference
from . import _build

# kernel launches made by corner_table and by corner_table_backward
# (incremented at each launch only)
LAUNCHES = 0
BWD_LAUNCHES = 0

_SYMBOLS = {torch.float32: 'corner_table_f32',
            torch.bfloat16: 'corner_table_bf16'}
_BWD_SYMBOLS = {torch.float32: 'corner_table_backward_f32',
                torch.bfloat16: 'corner_table_backward_bf16'}


def _check(vol):
    if vol.dtype not in _SYMBOLS:
        raise TypeError(f'corner_table: vol must be float32 or bfloat16, got '
                        f'{vol.dtype}')
    if vol.dim() != 4:
        raise ValueError(f'corner_table: vol must be (C, D, H, W), got '
                         f'{tuple(vol.shape)}')
    if not vol.is_contiguous():
        raise ValueError('corner_table: vol must be contiguous')
    return vol.shape


def _kernel(symbols, dtype):
    """The typed entry point: 2 pointers, 4 sizes, the stream."""
    return _build.kernel('corner_table', symbols[dtype],
                         [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                         + [ctypes.c_void_p])


def corner_table(vol: torch.Tensor) -> torch.Tensor:
    """vol (C, D, H, W) float32 or bfloat16 -> (D+1, H+1, W+1, 8*C) table in
    vol's dtype, on vol's device."""
    global LAUNCHES
    if vol.device.type == 'cpu':
        return corner_table_reference(vol)
    if vol.device.type != 'cuda':
        raise NotImplementedError(f'corner_table: no kernel for {vol.device}')
    C, D, H, W = _check(vol)
    out = torch.empty((D + 1, H + 1, W + 1, 8 * C), dtype=vol.dtype,
                      device=vol.device)
    err = _build.launch(_kernel(_SYMBOLS, vol.dtype), vol.device,
                        vol.data_ptr(), out.data_ptr(), C, D, H, W)
    if err != 0:
        raise RuntimeError(f'corner_table: kernel launch failed with CUDA '
                           f'error {err}')
    LAUNCHES += 1
    return out


def corner_table_backward_reference(g: torch.Tensor,
                                    vol_shape: Tuple[int, int, int, int]
                                    ) -> torch.Tensor:
    """Plain torch transpose of `corner_table_reference`: g (D+1, H+1, W+1,
    8*C) or its ((D+1)(H+1)(W+1), 8*C) rows, any float dtype -> d vol
    (C, D, H, W) float32, the 8 shifted slices summed in corner order."""
    C, D, H, W = vol_shape
    gg = g.reshape(D + 1, H + 1, W + 1, 8, C)
    out = torch.zeros((D, H, W, C), dtype=torch.float32, device=g.device)
    k = 0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                out = out + gg[1 - dz:D + 1 - dz, 1 - dy:H + 1 - dy,
                               1 - dx:W + 1 - dx, k].to(torch.float32)
                k += 1
    return out.permute(3, 0, 1, 2).contiguous()


def corner_table_backward(g: torch.Tensor,
                          vol_shape: Tuple[int, int, int, int]
                          ) -> torch.Tensor:
    """d vol (C, D, H, W) float32 from the table's cotangent g (D+1, H+1,
    W+1, 8*C) float32 or bfloat16, on g's device."""
    global BWD_LAUNCHES
    if g.device.type == 'cpu':
        return corner_table_backward_reference(g, vol_shape)
    if g.device.type != 'cuda':
        raise NotImplementedError(f'corner_table: no kernel for {g.device}')
    C, D, H, W = vol_shape
    if g.dtype not in _BWD_SYMBOLS:
        raise TypeError(f'corner_table: the cotangent must be float32 or '
                        f'bfloat16, got {g.dtype}')
    if g.numel() != (D + 1) * (H + 1) * (W + 1) * 8 * C:
        raise ValueError(f'corner_table: cotangent {tuple(g.shape)} is not '
                         f'the table of a {tuple(vol_shape)} volume')
    if not g.is_contiguous():
        raise ValueError('corner_table: the cotangent must be contiguous')
    out = torch.empty((C, D, H, W), dtype=torch.float32, device=g.device)
    err = _build.launch(_kernel(_BWD_SYMBOLS, g.dtype), g.device,
                        g.data_ptr(), out.data_ptr(), C, D, H, W)
    if err != 0:
        raise RuntimeError(f'corner_table: backward kernel launch failed '
                           f'with CUDA error {err}')
    BWD_LAUNCHES += 1
    return out


class CornerTable(torch.autograd.Function):
    """`corner_table` with its backward. The gradient is summed in fp32 and
    cast to vol's dtype, as `_corner_table_bwd_impl` casts it. `plain` runs
    the plain versions of both directions."""

    @staticmethod
    def forward(ctx, vol, plain):
        ctx.vol = (tuple(vol.shape), vol.dtype, plain)
        return corner_table_reference(vol) if plain else corner_table(vol)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, plain = ctx.vol
        bwd = corner_table_backward_reference if plain \
            else corner_table_backward
        return bwd(g.contiguous(), shape).to(dtype), None


def build_corner_table(vol: torch.Tensor, plain: bool = False
                       ) -> torch.Tensor:
    """Differentiable `corner_table`; `plain` selects the plain versions of
    the forward and the backward."""
    return CornerTable.apply(vol, plain)
