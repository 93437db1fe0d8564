"""The row-gather and bulk-copy probes: four CUDA kernels and their plain
versions.

These replace the Pallas probe kernels of the JAX package's `scripts/`
(perf_vmem_gather.py, perf_r3_gather_layouts.py, perf_r3_dma_control.py,
perf_r3_dma_gather.py, perf_r3_dma_bisect.py, perf_r3_dma_sweep.py,
perf_r4_dma_scale.py), which measured what a gather of table rows costs, the
access pattern of the ray march. `tools/gather_probe.py` drives them at the
scripts' shapes. Each kernel copies bits, so each matches its plain version
bit for bit:

  row_gather(tab, idx)          out[q] = tab[idx[q]], or per lane
                                out[q, j] = tab[idx[q, j], j], with full
                                warps, loads in flight and streaming stores
  onehot_gather_mma(tab, idx)   sum_j onehot(idx - j*RB) @ tab_j in fp32 by
                                wgmma on table tiles that TMA brings in
                                = f32(bf16(tab))[idx]
  block_copy_tma(tab, rows, perm, smem_bytes)
                                block i of `rows` rows = tab block perm[i]
                                (or i), through shared memory by bulk copies;
                                with one row and S bytes of shared memory it
                                is the capacity probe
  row_gather_tma(tab, idx, depth, unroll)
                                out[q] = tab[idx[q]] by one bulk copy a row
                                into a shared-memory tile that one bulk store
                                writes out, `depth` copies in flight a block

`csrc/gather_probe.cu` holds the kernels and says which TPU kernel each
replaces, what bounds it and how it is built. On CPU tensors each wrapper
checks its arguments and runs the plain version (`*_reference`). On a CUDA
tensor it launches its kernel or raises, never falls back; `LAUNCHES`
counts the launches per wrapper. `prepare` checks a wrapper's arguments
once and returns its launch, for timing loops. Every launch's geometry is
computed here: `row_gather_plan` (the rows mode's persistent grid, the
lanes mode's 2-D grid), `onehot_plan` (CTAs, the ring),
`row_gather_tma_plan` and `block_copy_plan` (tiles, rings, grids); the
persistent kernels launch as many blocks as fit on the card at once.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from . import _build
from ._build import SMEM_LIMIT

# kernel launches per wrapper (incremented at each launch only)
LAUNCHES = dict(row_gather=0, onehot_gather_mma=0, block_copy_tma=0,
                row_gather_tma=0)
# the RB of scripts/perf_vmem_gather.py's one-hot gather: table rows per
# one-hot product
ONEHOT_RB = 2048
# queries one launch of row_gather, onehot_gather_mma or row_gather_tma
# takes: their kernels hold query numbers in int, and the rows walk steps
# up to blocks x threads x loads (2^20 at most) past the last query
MAX_QUERIES = 2 ** 31 - 2 ** 21

_c = ctypes.c_void_p
_ll = ctypes.c_longlong
_i = ctypes.c_int
_ARGTYPES = dict(
    row_gather_rows=[_c, _c, _c, _i, _i, _i, _c],
    row_gather_rows_blocks_per_sm=[],
    row_gather_lanes=[_c, _c, _c, _i, _i, _i, _i, _i, _i, _i, _i, _c],
    onehot_gather_mma=[_c, _c, _c, _i, _i, _i, _i, _i, _c],
    block_copy_tma=[_c, _c, _c, _ll, _ll, _i, _i, _i, _c],
    block_copy_tma_allow_smem=[_i],
    block_copy_tma_blocks_per_sm=[_i],
    row_gather_tma=[_c, _c, _c, _ll, _i, _i, _i, _i, _i, _i, _i, _c],
    row_gather_tma_allow_smem=[_i],
    row_gather_tma_blocks_per_sm=[_i],
)
def _kernel(symbol):
    return _build.kernel('gather_probe', symbol, _ARGTYPES[symbol])


# what onehot_gather_mma returns when it cannot make the table's TMA
# descriptor (csrc/gather_probe.cu kEncodeFailed, kNoEncoder)
ENCODE_FAILED = 10000
NO_ENCODER = 20000


def _run(name, symbol, device, *args):
    """Launch `symbol` on the current stream of `device`; raise on a CUDA
    error of the launch, or on a TMA descriptor that failed to encode;
    count it."""
    err = _build.launch(_kernel(symbol), device, *args)
    if err == NO_ENCODER:
        raise RuntimeError(f'{name}: the driver has no cuTensorMapEncodeTiled')
    if err >= ENCODE_FAILED:
        raise RuntimeError(f'{name}: the TMA descriptor failed to encode '
                           f'(CUresult {err - ENCODE_FAILED})')
    if err != 0:
        raise RuntimeError(f'{name}: kernel launch failed with CUDA error '
                           f'{err}')
    LAUNCHES[name] += 1


# ------------------------------------------------------------ launch plans

# H100: shared memory of one SM, the part of it the card keeps per block,
# resident blocks per SM at most, and SMs
SM_SMEM = 233472
SMEM_RESERVED_PER_BLOCK = 1024
MAX_BLOCKS_PER_SM = 32
H100_SMS = 132
# row_gather_tma: output bytes a tile of consecutive rows aims at. Small
# tiles leave room for more blocks, hence more issuing threads, on an SM:
# 4 KB ran the tool's shapes 1.0-2.3x faster than 16 KB on an H100
# (PERF.md)
TMA_TILE_BYTES = 4 * 1024
# block_copy_tma: chunks in flight per block, and the bytes ahead of them
# that hold their mbarriers (csrc/gather_probe.cu kCopyStages, kBarBytes)
COPY_STAGES = 4
COPY_BAR_BYTES = 128

# row_gather, rows mode (csrc/gather_probe.cu kRgThreads, kRgLoads): threads
# a block, 16-byte loads in flight a thread, and the blocks an SM holds
# (2,048 threads; the card's occupancy API decides on the card)
ROW_GATHER_THREADS = 256
ROW_GATHER_LOADS = 4
ROW_GATHER_BLOCKS_PER_SM = 8
# onehot_gather_mma (kOhConsumers, kOhStages, kOhRows, kOhStageBytes):
# consumer warpgroups of 128 queries, ring stages, table rows a tile, and
# the bytes of one tile, two TMA boxes of 64 rows x 64 bf16 columns
ONEHOT_CONSUMERS = 2
ONEHOT_STAGES = 6
ONEHOT_TILE_ROWS = 64
ONEHOT_STAGE_BYTES = 2 * 64 * 128

# (device index, symbol) -> the most dynamic shared memory allowed so far
_SMEM_ALLOWED = {}
# (device index, symbol, bytes) -> blocks per SM, as the card reports them
_PER_SM = {}


def blocks_per_sm(smem_bytes: int) -> int:
    """One-warp blocks with `smem_bytes` of dynamic shared memory that fit
    on an H100 SM: the SM's 228 KB, less 1 KB per block, bound it."""
    return min(MAX_BLOCKS_PER_SM,
               SM_SMEM // (smem_bytes + SMEM_RESERVED_PER_BLOCK))


def row_gather_plan(Q: int, W: int, elem_bytes: int, lanes: bool = False,
                    aligned: bool = True, sms: int = H100_SMS,
                    per_sm: Optional[int] = None) -> dict:
    """The launch of `row_gather` for Q queries of a width-W table.

    Rows mode: `blocks` blocks of ROW_GATHER_THREADS (no more than fit on
    the card, `per_sm` on each of `sms` SMs, and no more than the work
    needs) walk the Q x `pieces` (query, 16-byte piece) pairs, a warp
    32 x ROW_GATHER_LOADS consecutive pairs at a time.

    Lanes mode: `vec` elements a thread, 16 bytes of them where W is a
    multiple of that and the indices are 16-byte `aligned`, else 1; blocks
    `block` = (bx, by) of consecutive elements by queries, on a `grid` of
    (queries, elements) blocks."""
    if lanes:
        v = 16 // elem_bytes
        vec = v if aligned and W % v == 0 else 1
        nv = W // vec
        bx = min(nv, ROW_GATHER_THREADS)
        by = max(1, ROW_GATHER_THREADS // bx)
        return dict(mode='lanes', vec=vec, block=(bx, by),
                    grid=(-(-Q // by), -(-nv // bx)), threads=bx * by)
    pieces = W * elem_bytes // 16
    per_sm = ROW_GATHER_BLOCKS_PER_SM if per_sm is None else per_sm
    run = ROW_GATHER_THREADS * ROW_GATHER_LOADS
    blocks = max(1, min(-(-Q * pieces // run), per_sm * sms))
    return dict(mode='rows', threads=ROW_GATHER_THREADS,
                loads_in_flight=ROW_GATHER_LOADS, pieces=pieces,
                blocks=blocks, blocks_per_sm=per_sm)


def onehot_plan(Q: int, R: int) -> dict:
    """The launch of `onehot_gather_mma`: `ctas` CTAs of 128 x
    ONEHOT_CONSUMERS queries and `threads` threads (a producer warpgroup and
    the consumers); `table_tiles` tiles of ONEHOT_TILE_ROWS rows by 128
    columns (those past the table's width zero) walked by every CTA through a ring of
    `stages`; dynamic shared memory for 1 KB of alignment, the ring and its
    full and empty mbarriers."""
    per_cta = 128 * ONEHOT_CONSUMERS
    return dict(ctas=-(-Q // per_cta), queries_per_cta=per_cta,
                threads=128 * (1 + ONEHOT_CONSUMERS), stages=ONEHOT_STAGES,
                tile_rows=ONEHOT_TILE_ROWS,
                table_tiles=-(-R // ONEHOT_TILE_ROWS),
                smem_bytes=1024 + ONEHOT_STAGES * (ONEHOT_STAGE_BYTES + 16))


def row_gather_tma_plan(Q: int, row_bytes: int, depth: int,
                        sms: int = H100_SMS,
                        per_sm: Optional[int] = None) -> dict:
    """The launch of `row_gather_tma`: tiles of `tile_rows` consecutive
    queries (TMA_TILE_BYTES of output, at least one row), a ring of
    `ring_tiles` tiles per block (2 + ceil((depth - 1) / tile_rows): the
    `depth` rows in flight and the tile being stored), the block's dynamic
    shared memory (its `depth` mbarriers in 128 B steps, then the ring) and
    as many blocks as fit on the card at once (`per_sm`, by default
    `blocks_per_sm`, on `sms` SMs), no more than there are tiles.
    `copies_in_flight` is blocks x depth."""
    T = max(1, TMA_TILE_BYTES // row_bytes)
    ring = 2 + -(-(depth - 1) // T)
    smem = -(-8 * depth // 128) * 128 + ring * T * row_bytes
    per_sm = blocks_per_sm(smem) if per_sm is None else per_sm
    blocks = min(-(-Q // T), per_sm * sms)
    return dict(tile_rows=T, ring_tiles=ring, smem_bytes=smem,
                blocks_per_sm=per_sm, blocks=blocks,
                copies_in_flight=blocks * depth)


def block_copy_plan(n_blocks: int, block_bytes: int, smem_bytes: int,
                    sms: int = H100_SMS,
                    per_sm: Optional[int] = None) -> dict:
    """The launch of `block_copy_tma`: `smem_bytes` of dynamic shared memory
    hold COPY_STAGES chunks of `chunk_bytes` (a multiple of 16) after the
    mbarriers; each block of the copy is `chunks` chunks, the last one
    short; as many blocks as fit on the card at once walk the
    n_blocks x chunks pairs."""
    chunk = (smem_bytes - COPY_BAR_BYTES) // COPY_STAGES // 16 * 16
    chunks = -(-block_bytes // chunk)
    per_sm = blocks_per_sm(smem_bytes) if per_sm is None else per_sm
    blocks = min(n_blocks * chunks, per_sm * sms)
    return dict(stages=COPY_STAGES, chunk_bytes=chunk, chunks=chunks,
                smem_bytes=smem_bytes, blocks_per_sm=per_sm, blocks=blocks)


def _allow_smem(name, device, symbol, smem_bytes):
    """Let `symbol`'s kernel take `smem_bytes` of dynamic shared memory on
    `device`: set once, when more than allowed so far is asked; a refusal
    raises, and is not remembered."""
    key = (device.index, symbol)
    if _SMEM_ALLOWED.get(key, 0) >= smem_bytes:
        return
    with torch.cuda.device(device):
        err = _kernel(f'{symbol}_allow_smem')(smem_bytes)
    if err != 0:
        raise RuntimeError(f'{name}: {smem_bytes} B of shared memory refused '
                           f'with CUDA error {err}')
    _SMEM_ALLOWED[key] = smem_bytes


def _card_plan(name, device, symbol, smem_bytes, plan, *args):
    """`plan(*args, sms=, per_sm=)` with the card's SMs and its occupancy
    for `smem_bytes`, after allowing that much shared memory."""
    _allow_smem(name, device, symbol, smem_bytes)
    key = (device.index, symbol, smem_bytes)
    if key not in _PER_SM:
        with torch.cuda.device(device):
            n = _kernel(f'{symbol}_blocks_per_sm')(smem_bytes)
        if n <= 0:
            raise RuntimeError(f'{name}: no block of {smem_bytes} B of shared '
                               f'memory fits an SM (CUDA error {-n})')
        _PER_SM[key] = n
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return plan(*args, sms=sms, per_sm=_PER_SM[key])


def _check_index(name: str, idx: torch.Tensor, n: int):
    """Raise unless idx is int32 and every value lies in [0, n). On the
    card this waits for one reduction."""
    if idx.dtype != torch.int32:
        raise TypeError(f'{name}: indices must be int32, got {idx.dtype}')
    if idx.numel() == 0:
        return
    lo, hi = (int(v) for v in torch.aminmax(idx))
    if lo < 0 or hi >= n:
        raise IndexError(f'{name}: indices span [{lo}, {hi}], outside '
                         f'[0, {n})')


def _check_device(name, *tensors):
    dev = tensors[0].device
    if dev.type not in ('cpu', 'cuda'):
        raise NotImplementedError(f'{name}: no kernel for {dev}')
    for t in tensors:
        if t.device != dev:
            raise ValueError(f'{name}: tensors on {t.device} and {dev}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: every tensor must be contiguous')
    return dev


def _check_rows(name, tab):
    """tab must be 2-D with rows of a multiple of 16 bytes, 16-byte aligned
    (the kernels move rows in 16-byte pieces and bulk copies)."""
    if tab.dim() != 2:
        raise ValueError(f'{name}: the table must be (R, W), got '
                         f'{tuple(tab.shape)}')
    row_bytes = tab.shape[1] * tab.element_size()
    if row_bytes % 16 != 0 or row_bytes == 0:
        raise ValueError(f'{name}: rows of {row_bytes} B; the kernel takes '
                         f'rows of a multiple of 16 B')
    if tab.device.type == 'cuda' and tab.data_ptr() % 16 != 0:
        raise ValueError(f'{name}: the table is not 16-byte aligned')
    return row_bytes


# ------------------------------------------------------------ row_gather

def row_gather_reference(tab: torch.Tensor, idx: torch.Tensor
                         ) -> torch.Tensor:
    """Plain version of `row_gather` (and of `row_gather_tma`): tab[idx]
    for (Q,) indices, tab[idx[q, j], j] for (Q, W) ones."""
    if idx.dim() == 1:
        return tab[idx.long()]
    cols = torch.arange(tab.shape[1], device=tab.device)
    return tab[idx.long(), cols]


def row_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of tab (R, W), any dtype, by int32 indices in [0, R).

    idx (Q,): out (Q, W) = tab[idx]; the row must be a multiple of 16 bytes.
    idx (Q, W): per lane, out[q, j] = tab[idx[q, j], j]; 2- or 4-byte
    elements.
    """
    return _row_gather(tab, idx)()


def _row_gather(tab, idx):
    name = 'row_gather'
    dev = _check_device(name, tab, idx)
    if tab.dim() != 2:
        raise ValueError(f'{name}: the table must be (R, W), got '
                         f'{tuple(tab.shape)}')
    R, W = tab.shape
    lanes = idx.dim() == 2
    if lanes:
        if idx.shape[1] != W:
            raise ValueError(f'{name}: per-lane indices {tuple(idx.shape)} '
                             f'for a table of width {W}')
        if tab.element_size() not in (2, 4):
            raise TypeError(f'{name}: per lane the kernel takes 2- and '
                            f'4-byte elements, got {tab.dtype}')
    elif idx.dim() == 1:
        row_bytes = _check_rows(name, tab)
    else:
        raise ValueError(f'{name}: indices must be (Q,) or (Q, W), got '
                         f'{tuple(idx.shape)}')
    _check_index(name, idx, R)
    Q = idx.shape[0]
    if Q > MAX_QUERIES:
        raise ValueError(f'{name}: {Q} queries exceed one launch')
    es = tab.element_size()
    aligned = idx.data_ptr() % 16 == 0
    if dev.type == 'cpu':
        def launch():
            return row_gather_reference(tab, idx)
        launch.plan = row_gather_plan(Q, W, es, lanes, aligned)
        return launch
    if lanes:
        plan = row_gather_plan(Q, W, es, True, aligned)
    else:
        plan = row_gather_plan(Q, W, es, sms=_sms(dev),
                               per_sm=_rows_per_sm(dev))

    def launch():
        out = torch.empty((Q, W), dtype=tab.dtype, device=dev)
        if Q == 0:
            return out
        if lanes:
            _run(name, 'row_gather_lanes', dev, tab.data_ptr(),
                 idx.data_ptr(), out.data_ptr(), Q, W, es, plan['vec'],
                 *plan['block'], *plan['grid'])
        else:
            _run(name, 'row_gather_rows', dev, tab.data_ptr(),
                 idx.data_ptr(), out.data_ptr(), Q, row_bytes,
                 plan['blocks'])
        return out
    launch.plan = plan
    return launch


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _rows_per_sm(device) -> int:
    """Blocks of row_gather's rows mode that fit on an SM of `device`, as
    the card's occupancy API reports them (asked once)."""
    key = (device.index, 'row_gather_rows', 0)
    if key not in _PER_SM:
        with torch.cuda.device(device):
            n = _kernel('row_gather_rows_blocks_per_sm')()
        if n <= 0:
            raise RuntimeError(f'row_gather: no block fits an SM (CUDA error '
                               f'{-n})')
        _PER_SM[key] = n
    return _PER_SM[key]


# ----------------------------------------------------- onehot_gather_mma

def onehot_gather_reference(tab: torch.Tensor, idx: torch.Tensor,
                            rb: int = ONEHOT_RB,
                            q_chunk: int = 1 << 16) -> torch.Tensor:
    """Plain version of `onehot_gather_mma`, written out as
    scripts/perf_vmem_gather.py's `gk_onehot` computes it: per chunk j of
    `rb` table rows, onehot(idx - j*rb) in bf16 times the chunk in bf16,
    summed in fp32 (queries taken `q_chunk` at a time to bound the one-hot
    block's memory). Each output has one nonzero product, so the result is
    f32(bf16(tab))[idx] exactly."""
    R, W = tab.shape
    t16 = tab.to(torch.bfloat16)
    out = torch.empty((idx.shape[0], W), dtype=torch.float32,
                      device=tab.device)
    for q0 in range(0, idx.shape[0], q_chunk):
        ids = idx[q0:q0 + q_chunk].long()[:, None]
        acc = torch.zeros((ids.shape[0], W), dtype=torch.float32,
                          device=tab.device)
        for j in range(0, R, rb):
            n = min(rb, R - j)
            iota = torch.arange(n, device=tab.device)
            oh = (ids - j == iota).to(torch.bfloat16)
            acc += torch.matmul(oh, t16[j:j + n]).float()
        out[q0:q0 + q_chunk] = acc
    return out


def onehot_gather_mma(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """f32(tab)[idx] of a bf16 table (R, W), W a multiple of 8 up to 128,
    computed as the one-hot product on the tensor cores (`wgmma` on table
    tiles that TMA loads, `onehot_plan`): (Q, W) float32."""
    return _onehot_gather_mma(tab, idx)()


def _onehot_gather_mma(tab, idx):
    name = 'onehot_gather_mma'
    dev = _check_device(name, tab, idx)
    if tab.dtype != torch.bfloat16 or tab.dim() != 2:
        raise TypeError(f'{name}: the table must be (R, W) bfloat16, got '
                        f'{tuple(tab.shape)} {tab.dtype}')
    R, W = tab.shape
    if W % 8 != 0 or not 0 < W <= 128:
        raise ValueError(f'{name}: width {W}; the kernel takes multiples of '
                         f'8 up to 128')
    if idx.dim() != 1:
        raise ValueError(f'{name}: indices must be (Q,), got '
                         f'{tuple(idx.shape)}')
    _check_index(name, idx, R)
    Q = idx.shape[0]
    if Q > MAX_QUERIES or R >= 2 ** 31:
        raise ValueError(f'{name}: {Q} queries or {R} rows exceed a launch')
    plan = onehot_plan(Q, R)
    if dev.type == 'cpu':
        def launch():
            return onehot_gather_reference(tab, idx)
        launch.plan = plan
        return launch
    if tab.data_ptr() % 16 != 0:
        raise ValueError(f'{name}: the table is not 16-byte aligned')

    def launch():
        out = torch.empty((Q, W), dtype=torch.float32, device=dev)
        if Q:
            _run(name, name, dev, tab.data_ptr(), idx.data_ptr(),
                 out.data_ptr(), Q, R, W, plan['ctas'], plan['smem_bytes'])
        return out
    launch.plan = plan
    return launch


# -------------------------------------------------------- block_copy_tma

def block_copy_reference(tab: torch.Tensor, block_rows: int,
                         perm: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain version of `block_copy_tma`: tab's blocks of `block_rows` rows,
    in order or permuted (scripts/perf_r3_dma_control.py:77)."""
    blocks = tab.reshape(tab.shape[0] // block_rows, block_rows, -1)
    if perm is not None:
        blocks = blocks[perm.long()]
    return blocks.reshape(tab.shape).clone()


def block_copy_tma(tab: torch.Tensor, block_rows: int,
                   perm: Optional[torch.Tensor] = None,
                   smem_bytes: int = 48 * 1024) -> torch.Tensor:
    """Copy tab (R, W) in blocks of `block_rows` rows (R a multiple of it),
    block i from tab block perm[i] when `perm` (int32, a permutation of the
    R / block_rows blocks) is given. On the card each block of the launch
    asks for `smem_bytes` of dynamic shared memory and stages the copy
    through it in COPY_STAGES chunks (`block_copy_plan`); more than
    `SMEM_LIMIT` is refused by the card and raises."""
    return _block_copy_tma(tab, block_rows, perm, smem_bytes)()


def _block_copy_tma(tab, block_rows, perm=None, smem_bytes=48 * 1024):
    name = 'block_copy_tma'
    tensors = (tab,) if perm is None else (tab, perm)
    dev = _check_device(name, *tensors)
    row_bytes = _check_rows(name, tab)
    R = tab.shape[0]
    if block_rows <= 0 or R % block_rows != 0:
        raise ValueError(f'{name}: {R} rows are not whole blocks of '
                         f'{block_rows}')
    n_blocks = R // block_rows
    if perm is not None:
        if perm.shape != (n_blocks,):
            raise ValueError(f'{name}: perm {tuple(perm.shape)} for '
                             f'{n_blocks} blocks')
        _check_index(name, perm, n_blocks)
    if smem_bytes < COPY_BAR_BYTES + 16 * COPY_STAGES:
        raise ValueError(f'{name}: {smem_bytes} B of shared memory hold no '
                         f'{COPY_STAGES} chunks')
    block_bytes = block_rows * row_bytes
    if dev.type == 'cpu':
        def launch():
            return block_copy_reference(tab, block_rows, perm)
        launch.plan = block_copy_plan(n_blocks, block_bytes, smem_bytes)
        return launch
    plan = _card_plan(name, dev, name, smem_bytes, block_copy_plan, n_blocks,
                      block_bytes, smem_bytes)

    def launch():
        out = torch.empty_like(tab)
        if out.numel():
            _run(name, name, dev, tab.data_ptr(), out.data_ptr(),
                 None if perm is None else perm.data_ptr(), n_blocks,
                 block_bytes, plan['chunk_bytes'], smem_bytes, plan['blocks'])
        return out
    launch.plan = plan
    return launch


# -------------------------------------------------------- row_gather_tma

def row_gather_tma(tab: torch.Tensor, idx: torch.Tensor, depth: int = 8,
                   unroll: int = 1) -> torch.Tensor:
    """out[q] = tab[idx[q]] for a table (R, W) of any dtype whose rows are a
    multiple of 16 bytes and int32 indices (Q,) in [0, R), by one bulk copy
    per row into a shared-memory tile of consecutive rows that one bulk
    store writes out (`row_gather_tma_plan`): each block keeps `depth`
    copies in flight, issued `unroll` at a time (depth a multiple of
    unroll)."""
    return _row_gather_tma(tab, idx, depth, unroll)()


def _row_gather_tma(tab, idx, depth=8, unroll=1):
    name = 'row_gather_tma'
    dev = _check_device(name, tab, idx)
    row_bytes = _check_rows(name, tab)
    if idx.dim() != 1:
        raise ValueError(f'{name}: indices must be (Q,), got '
                         f'{tuple(idx.shape)}')
    if depth < 1 or unroll < 1 or depth % unroll != 0:
        raise ValueError(f'{name}: depth {depth}, unroll {unroll}: depth '
                         f'must be a positive multiple of unroll')
    _check_index(name, idx, tab.shape[0])
    Q = idx.shape[0]
    if Q > MAX_QUERIES:
        raise ValueError(f'{name}: {Q} queries exceed one launch')
    plan = row_gather_tma_plan(Q, row_bytes, depth)
    smem = plan['smem_bytes']
    if smem > SMEM_LIMIT:
        raise ValueError(f'{name}: depth {depth} of {row_bytes} B rows needs '
                         f'{smem} B of shared memory, more than a block has')
    if dev.type == 'cpu':
        def launch():
            return row_gather_reference(tab, idx)
        launch.plan = plan
        return launch
    plan = _card_plan(name, dev, name, smem, row_gather_tma_plan, Q,
                      row_bytes, depth)

    def launch():
        out = torch.empty((Q, tab.shape[1]), dtype=tab.dtype, device=dev)
        if Q:
            _run(name, name, dev, tab.data_ptr(), idx.data_ptr(),
                 out.data_ptr(), Q, row_bytes, depth, unroll,
                 plan['tile_rows'], plan['ring_tiles'], smem, plan['blocks'])
        return out
    launch.plan = plan
    return launch


_PREPARE = dict(row_gather=_row_gather, onehot_gather_mma=_onehot_gather_mma,
                block_copy_tma=_block_copy_tma,
                row_gather_tma=_row_gather_tma)


def prepare(name: str, *args, **kwargs) -> Callable[[], torch.Tensor]:
    """Check the arguments of the wrapper `name` once, as the wrapper does,
    and return a callable that launches its kernel on them (on CPU tensors:
    runs the plain version) each time it is called, without checking again.
    `tools/gather_probe.py` times these calls, so that a time is the
    kernel's and not the index check's, which waits for the card. The
    callable's `plan` is the launch's geometry (on CPU tensors, the one an
    H100 would run)."""
    return _PREPARE[name](*args, **kwargs)
