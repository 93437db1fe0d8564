"""The corner-block table of the fused field, and its backward.

`corner_table(vol)` maps a channels-first volume (C, D, H, W) to its
(D+1, H+1, W+1, 8*C) corner-block table (`core.sampling.
corner_table_reference` gives the semantics). The build is linear; its
transpose, `corner_table_backward(g, vol_shape)`, sums the 8 shifted slices
of the table's cotangent g into a (C, D, H, W) fp32 d vol
(`corner_table_backward_reference` is the plain version).
`build_corner_table(vol)` is the differentiable op: a
`torch.autograd.Function` whose forward and backward are those two. The
model's paths no longer build the table (the rays read the channels-last
field); these are the port of the TPU table kernels.

On CUDA tensors both launch hand-written kernels of `csrc/corner_table.cu`.
The forward replaces the JAX package's TPU kernel `_corner_table_pallas`
(vampire_tpu/ops/pallas_tables.py:73) and is byte-identical to its plain
version; `table_plan` plans its launch. The backward replaces
`_corner_table_bwd_impl` (pallas_tables.py:214-226), sums in the plain
version's order and agrees with it bit for bit. On CPU tensors both run
their plain versions; a CUDA tensor never falls back: the kernel launches or
the call raises.

`corner_table_library` and `corner_table_backward_library` compute the same
two functions with PyTorch calls (a pad and one strided copy; a one-hot
`conv_transpose3d`). They are yardsticks for the kernels' times: no path of
the port calls them.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.sampling import corner_table_reference
from . import _build

# kernel launches made by corner_table and by corner_table_backward
# (incremented at each launch only)
LAUNCHES = 0
BWD_LAUNCHES = 0
# the staging route of corner_table's last launch, as the C entry reports it
# (into _ROUTE)
LAST_ROUTE = None
_ROUTE = ctypes.c_int(-1)

_SYMBOLS = {torch.float32: 'corner_table_f32',
            torch.bfloat16: 'corner_table_bf16'}
_BWD_SYMBOLS = {torch.float32: 'corner_table_backward_f32',
                torch.bfloat16: 'corner_table_backward_bf16'}

# the table kernel's staging routes by the code its C entry reports
# (csrc/corner_table.cu kRouteVec16, kRouteScalar)
ROUTES = ('vec16', 'scalar')
# threads a CTA aims at (a multiple of 32 and of the 16-byte chunks a
# position holds) and may have (the kernel's launch bound, kMaxThreads)
TABLE_THREADS = 384
TABLE_MAX_THREADS = 512
# the shared memory a CTA aims at: four CTAs an SM overlap one CTA's
# staging with the others' stores (fp32 flagship on an H100: half rows at
# 48 KB 0.456-0.461 ms, whole rows at 91 KB 0.505-0.512; PERF.md)
TABLE_SMEM_TARGET = 48 * 1024


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
    """The typed backward entry point: 2 pointers, 4 sizes, the stream."""
    return _build.kernel('corner_table', symbols[dtype],
                         [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                         + [ctypes.c_void_p])


def table_smem(C: int, elem: int, seg: int) -> int:
    """Dynamic shared memory of a table launch (csrc/corner_table.cu
    `table_smem`): the 4C staged runs (2 z planes x 2 y planes x C
    channels) of seg + 1 values, rounded up to 16 bytes."""
    return -(-4 * C * (seg + 1) * elem // 16) * 16


def table_plan(C: int, D: int, H: int, W: int, dtype: torch.dtype,
               aligned: bool = True) -> dict:
    """The launch of the table kernel for a (C, D, H, W) volume: one CTA a
    work item, an output row or a row segment.

    `threads` a CTA: a multiple of the 16-byte `chunks_per_position` (C in
    bf16, 2C in fp32) and of 32 where that stays within TABLE_MAX_THREADS,
    about TABLE_THREADS; every thread stores one fixed chunk of
    `positions_per_step` positions a step. `seg` output positions a work
    item: W + 1 (whole rows) where the staged runs fit in
    TABLE_SMEM_TARGET, else the longest that does (or, where not even one
    position does, one position); `segments` a row, `items` = rows x
    segments = `ctas`. `route` 'vec16' where every row of the field starts
    on 16 bytes: the field does (`aligned`) and a row is a multiple of 16
    bytes (the CTA stages with 16-byte loads), else 'scalar'. The C entry
    takes `threads` and `seg`, derives the rest and reports its route."""
    if dtype not in _SYMBOLS:
        raise TypeError(f'corner_table: no kernel for {dtype}')
    if min(C, D, H, W) < 1:
        raise ValueError(f'corner_table: empty volume {(C, D, H, W)}')
    elem = 2 if dtype == torch.bfloat16 else 4
    chunks = C * elem // 2
    if chunks > TABLE_MAX_THREADS:
        raise ValueError(f'corner_table: {C} channels of {elem} bytes are '
                         f'more than {TABLE_MAX_THREADS} chunks of 16 bytes '
                         f'a position')
    lcm = 32 * chunks // math.gcd(32, chunks)
    threads = (lcm * max(1, TABLE_THREADS // lcm)
               if lcm <= TABLE_MAX_THREADS
               else chunks * (TABLE_MAX_THREADS // chunks))
    target = max(TABLE_SMEM_TARGET, table_smem(C, elem, 1))
    if target > _build.SMEM_LIMIT:
        raise ValueError(f'corner_table: {C} channels do not fit in shared '
                         f'memory')
    lo, hi = 1, W + 1              # the longest segment within the target
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if table_smem(C, elem, mid) <= target:
            lo = mid
        else:
            hi = mid - 1
    seg = lo
    smem = table_smem(C, elem, seg)
    segments = -(-(W + 1) // seg)
    items = (D + 1) * (H + 1) * segments
    vec16 = aligned and W * elem % 16 == 0
    return dict(route='vec16' if vec16 else 'scalar',
                threads=threads, chunks_per_position=chunks,
                positions_per_step=threads // chunks, seg=seg,
                segments=segments, items=items, ctas=items,
                smem_bytes=smem)


# (dtype, shape, alignment) -> the launch plan, made once (the corner
# table's host time counts against a 0.25 ms kernel)
_PLANS = {}


def card_plan(vol: torch.Tensor) -> dict:
    """`table_plan` for vol, made once per dtype, shape and whether vol
    starts on 16 bytes."""
    key = (vol.dtype, tuple(vol.shape), vol.data_ptr() % 16 == 0)
    if key not in _PLANS:
        _PLANS[key] = table_plan(*vol.shape, vol.dtype, aligned=key[2])
    return _PLANS[key]


def corner_table(vol: torch.Tensor) -> torch.Tensor:
    """vol (C, D, H, W) float32 or bfloat16 -> (D+1, H+1, W+1, 8*C) table in
    vol's dtype, on vol's device."""
    global LAUNCHES, LAST_ROUTE
    if vol.device.type == 'cpu':
        return corner_table_reference(vol)
    if vol.device.type != 'cuda':
        raise NotImplementedError(f'corner_table: no kernel for {vol.device}')
    C, D, H, W = _check(vol)
    plan = card_plan(vol)
    out = torch.empty((D + 1, H + 1, W + 1, 8 * C), dtype=vol.dtype,
                      device=vol.device)
    fn = _build.kernel('corner_table', _SYMBOLS[vol.dtype],
                       [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * 2)
    err = _build.launch(fn, vol.device, vol.data_ptr(), out.data_ptr(), C, D,
                        H, W, plan['threads'], plan['seg'],
                        ctypes.addressof(_ROUTE))
    if err != 0:
        raise RuntimeError(f'corner_table: kernel launch failed with CUDA '
                           f'error {err}')
    LAUNCHES += 1
    LAST_ROUTE = ROUTES[_ROUTE.value]
    return out


def corner_table_library(vol: torch.Tensor) -> torch.Tensor:
    """Yardstick, called by no path: the table with PyTorch calls, one pad
    and one strided copy (the unfolded windows permuted channels-last).
    Byte-identical to `corner_table_reference`."""
    C, D, H, W = vol.shape
    win = F.pad(vol, (1,) * 6).unfold(1, 2, 1).unfold(2, 2, 1).unfold(3, 2, 1)
    return win.permute(1, 2, 3, 4, 5, 6, 0).reshape(D + 1, H + 1, W + 1,
                                                    8 * C)


def onehot_corner_weight(C: int, dtype: torch.dtype,
                         device=None) -> torch.Tensor:
    """The (8C, C, 2, 2, 2) one-hot weight w[k*C + c, c, dz, dy, dx] = 1,
    k = (dz*2 + dy)*2 + dx: `F.conv3d(vol[None], w, padding=1)[0]` is the
    table channels-first, `F.conv_transpose3d` its transpose."""
    w = torch.zeros(8, C, C, 2, 2, 2, dtype=dtype, device=device)
    c = torch.arange(C, device=device)
    for k in range(8):
        w[k, c, c, k >> 2, (k >> 1) & 1, k & 1] = 1
    return w.reshape(8 * C, C, 2, 2, 2)


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


def corner_table_backward_library(g: torch.Tensor,
                                  vol_shape: Tuple[int, int, int, int],
                                  weight: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Yardstick, called by no path: d vol (C, D, H, W) float32 by one
    `F.conv_transpose3d` of the channels-first cotangent with the one-hot
    weight (`onehot_corner_weight`, in g's dtype; pass it to keep its
    build out of a timing). It sums the 8 terms in cuDNN's order, in g's
    dtype's accumulation, then rounds to g's dtype."""
    C, D, H, W = vol_shape
    if weight is None:
        weight = onehot_corner_weight(C, g.dtype, g.device)
    gg = g.reshape(D + 1, H + 1, W + 1, 8 * C).permute(3, 0, 1, 2)[None]
    return F.conv_transpose3d(gg, weight, padding=1)[0].float()


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
