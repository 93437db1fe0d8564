"""The corner-block table of the fused field.

`corner_table(vol)` maps a channels-first volume (C, D, H, W) to its
(D+1, H+1, W+1, 8*C) corner-block table (`core.sampling.
corner_table_reference` gives the semantics). The camera-ray branch builds
it once per frame from the bf16 fused field [sdf | seg | rgb], and the ray
sampler (`ops/rays.py`) reads it.

On CUDA tensors it launches the hand-written kernel `csrc/corner_table.cu`,
which replaces the JAX package's TPU kernel `_corner_table_pallas`
(vampire_tpu/ops/pallas_tables.py:73). It is byte-identical to the plain
version. On CPU tensors it runs the plain version; a CUDA tensor never falls
back: the kernel launches or the call raises.

No autograd: this is the serving path. Training needs a
`torch.autograd.Function` whose backward mirrors `_corner_table_bwd_impl`
(vampire_tpu/ops/pallas_tables.py:214-226); ROADMAP.md lists it.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.sampling import corner_table_reference
from . import _build

# kernel launches made by corner_table (incremented at each launch only)
LAUNCHES = 0

_SYMBOLS = {torch.float32: 'corner_table_f32',
            torch.bfloat16: 'corner_table_bf16'}


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


def _kernel(dtype):
    fn = getattr(_build.load_library('corner_table'), _SYMBOLS[dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    return fn


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
    fn = _kernel(vol.dtype)
    with torch.cuda.device(vol.device):
        stream = torch.cuda.current_stream(vol.device).cuda_stream
        err = fn(vol.data_ptr(), out.data_ptr(), C, D, H, W, stream)
    if err != 0:
        raise RuntimeError(f'corner_table: kernel launch failed with CUDA '
                           f'error {err}')
    LAUNCHES += 1
    return out
