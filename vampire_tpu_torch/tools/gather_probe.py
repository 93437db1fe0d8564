"""The row-gather and DMA probes of the JAX package's scripts/, on the card.

    python -m vampire_tpu_torch.tools.gather_probe SUBCOMMAND [--device cpu]
        [--one VARIANT STREAM]... [--div D]

The port's counterpart of seven TPU probe scripts, at their shapes, dtypes
and index streams, through the four kernels of `ops/gather_probe.py`:

  vmem     scripts/perf_vmem_gather.py: the shared-memory capacity probe
           (`block_copy_tma` asked for 16 KB .. 227 KB and one byte more,
           which the card must refuse), the row gather of a (16384, 128)
           table in f32 and bf16 by 2^20 random indices (`row_gather`), and
           the one-hot product gather of the bf16 table
           (`onehot_gather_mma`, RB = 2048).
  layouts  scripts/perf_r3_gather_layouts.py: the row gather of the f32
           table by (Q,) indices (its `gk_col` and `gk_loop2`) and per lane
           by the (Q, 128) broadcast indices (`gk_full`).
  dma      scripts/perf_r3_dma_control.py: the static and the permuted block
           copy of a (4096, 128) f32 table in 512-row blocks;
           perf_r3_dma_gather.py: the per-row bulk-copy gather
           (`row_gather_tma`) of 2^18 random and sorted indices, depth 8;
           perf_r3_dma_bisect.py: 2^16 indices at depth 1 and 8.
  sweep    scripts/perf_r3_dma_sweep.py: R = 2^16 rows of f32 W128 (512 B)
           and bf16 W176 (352 B), Q = 2^20 random, sorted and coherent
           indices, depth 8, 16 and 32, BQ = 4096.
  scale    scripts/perf_r4_dma_scale.py, the ray stage's shapes: R =
           21*257*257 = 1,387,029 rows of 256 bf16 (the script's padded
           512 B rows) and of 176 bf16 (the port's 352 B corner-table
           rows), Q = 2^22 random and ray-coherent indices, BQ = 2048.
           Variants `rows` (row_gather), `dma1` .. `dma32` (row_gather_tma
           at that depth), `dmau4` .. `dmau32` (the same, issued 4 at a time,
           as the script's unrolled kernel) and `copy` (block_copy_tma of
           the whole table in 257-row blocks; its streams are `static` and
           `permuted`). `--one VARIANT STREAM`, repeatable, runs only those.
  launch   the host's microseconds per launch (`host_us`: n launches in a
           row on the host clock, ended by a synchronize) of each wrapper at
           the small shapes where the card may wait for the host, beside the
           card's (`device_us`: the same launches queued behind a spinning
           kernel, between CUDA events) and the tool's usual CUDA-event
           time, which is the host's wherever the host is slower.

The scripts' BQ (queries per TPU grid step) stays in each line as
`script_bq`. Every kernel's line carries the geometry that ran, from the
plans of `ops/gather_probe.py`: `row_gather` in rows mode its blocks,
blocks per SM, threads and loads in flight a thread (`row_gather_plan`),
per lane its elements a thread (`vec`), block and grid;
`onehot_gather_mma` its CTAs, queries a CTA, ring stages, tile rows, N and
shared memory (`onehot_plan`); `row_gather_tma` its blocks, blocks per SM,
tile rows, ring tiles and copies in flight (blocks x depth); and
`block_copy_tma` its blocks, blocks per SM, stages and chunk bytes.

Every configuration prints one JSON line: the shapes, whether the kernel's
output equals its plain version bit for bit (a mismatch raises), and on the
card the kernel's time, the plain version's, the time of one PyTorch call
that computes the same function (`library_ms`: `torch.index_select`,
`torch.take_along_dim` or `Tensor.copy_`; null where there is none), the
bound (the larger of the bytes it must move at 3.35 TB/s and its operations
at 989 TFLOP/s bf16; the distinct rows the indices touch are counted, not
R), the largest absolute difference from the plain version and the card's
name and power limit. The one-hot gather's function moves bytes and needs
no arithmetic, so its bound is the bytes'; the 2*Q*R*W multiply-adds of the
one-hot method at the tensor cores' peak are `method_ops_ms` beside it, and
`method_share` is that over the kernel's time. Times are CUDA events
around K = 8
launches (in `scale` on index windows shifted by k, as the script does),
the least of 3 such runs, per launch.

With `--device cpu` every wrapper runs its plain version at the size given
(`--div D` divides every row and query count by D): each line is labelled
`cpu (plain versions)`, compares with the PyTorch call where there is one,
and holds no time. No configuration's failure is swallowed: it raises, and
the tool exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..ops import gather_probe as gp

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
K = 8
REPS = 3
SEED = 0
CPU_LABEL = 'cpu (plain versions)'
SCALE_R = 21 * 257 * 257
SCALE_Q = 1 << 22
SCALE_BQ = 2048
SCALE_WIDTHS = (256, 176)
GATHER_VARIANTS = ('rows', 'dma1', 'dma4', 'dma8', 'dma16', 'dma32',
                   'dmau4', 'dmau8', 'dmau16', 'dmau32')
GATHER_STREAMS = ('random', 'coherent')
COPY_STREAMS = ('static', 'permuted')
CAPACITY_BYTES = (16 * 1024, 48 * 1024, 96 * 1024, 160 * 1024,
                  gp.SMEM_LIMIT, gp.SMEM_LIMIT + 1)
# the launch geometry each kernel's line carries
GEOMETRY = dict(
    row_gather_tma=('blocks', 'blocks_per_sm', 'tile_rows', 'ring_tiles',
                    'copies_in_flight'),
    row_gather=('blocks', 'blocks_per_sm', 'threads', 'loads_in_flight'),
    row_gather_lanes=('vec', 'block', 'grid'),
    onehot_gather_mma=('ctas', 'queries_per_cta', 'stages', 'tile_rows',
                       'smem_bytes'),
    block_copy_tma=('blocks', 'blocks_per_sm', 'stages', 'chunk_bytes'))
LAUNCH_REPS = 200
# clock cycles the card spins per queued call in `device_us`: 100 us at
# 2 GHz, several times the host's cost of a launch
SPIN_CYCLES_PER_CALL = 200_000


def card_label() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, n_ops: float = 0.0):
    """(ms, 'bytes' or 'operations'): the least time the card could take."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / BF16_OPS_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[a.element_size()]
    return torch.equal(a.view(view), b.view(view))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over equal-shaped tensors, in fp32, 2^20 rows at a time
    (the scale outputs are 2 GB)."""
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    return max((float((x.float() - y.float()).abs().max())
                for x, y in zip(a.split(1 << 20), b.split(1 << 20))),
               default=0.0)


def time_ms(calls: Sequence[Callable]) -> float:
    """Per call, the least over REPS runs of all `calls` between two CUDA
    events, after one warm-up run."""
    for c in calls:
        c()
    best = float('inf')
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for c in calls:
            c()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / len(calls))
    return best


class Probe:
    """Device, sizes and output of one run of the tool."""

    def __init__(self, device: str, div: int = 1):
        self.dev = torch.device(device)
        self.cuda = self.dev.type == 'cuda'
        if self.cuda and not torch.cuda.is_available():
            raise SystemExit('gather_probe: no CUDA card; pass --device cpu '
                             'to run the plain versions')
        self.label = card_label() if self.cuda else CPU_LABEL
        self.div = div
        self.records: List[dict] = []

    def n(self, count: int) -> int:
        return max(1, count // self.div)

    def table(self, R: int, W: int, dtype) -> torch.Tensor:
        g = torch.Generator(device=self.dev).manual_seed(SEED)
        return torch.randn((R, W), generator=g, device=self.dev,
                           dtype=torch.float32).to(dtype)

    def rng(self) -> np.random.RandomState:
        return np.random.RandomState(SEED + 1)

    def ints(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.dev)

    def emit(self, rec: dict) -> dict:
        rec['device'] = self.label
        print(json.dumps(rec), flush=True)
        self.records.append(rec)
        return rec

    def measure(self, rec: dict, kernel: Sequence[Callable],
                plain: Sequence[Callable],
                library: Optional[Sequence[Callable]], n_bytes: float,
                rows: int = 0) -> dict:
        """Check kernel[0]() against plain[0]() (and library[0]()) bit for
        bit, then on the card time all three; emit the line."""
        got, want = kernel[0](), plain[0]()
        if not same_bits(got, want):
            raise AssertionError(f'{rec}: the kernel disagrees with its plain '
                                 f'version')
        rec['equal'] = True
        rec['max_abs_err'] = max_abs_err(got, want)
        if library is not None:
            if not same_bits(got, library[0]()):
                raise AssertionError(f'{rec}: the PyTorch call disagrees')
            rec['library_equal'] = True
        del got, want
        if self.cuda:
            b, by = bound_ms(n_bytes)
            rec.update(bound_ms=b, bound_by=by)
            rec['ms'] = time_ms(kernel)
            rec['plain_ms'] = time_ms(plain)
            rec['library_ms'] = (None if library is None
                                 else time_ms(library))
            rec['share_of_bound'] = b / rec['ms']
            if 'method_ops_ms' in rec:
                rec['method_share'] = rec['method_ops_ms'] / rec['ms']
            if rows:
                rec['ns_per_row'] = rec['ms'] * 1e6 / rows
        return self.emit(rec)

    def gather(self, rec: dict, tab: torch.Tensor, windows, name='row_gather',
               **kw) -> dict:
        """A row gather (`row_gather` or `row_gather_tma` with `kw`) of tab
        by each index window; bound: output + distinct rows + indices. The
        line also carries the launch's geometry."""
        row_bytes = tab.shape[1] * tab.element_size()
        Q = windows[0].shape[0]
        distinct = int(torch.unique(windows[0]).numel())
        rec.update(R=tab.shape[0], W=tab.shape[1],
                   dtype=str(tab.dtype).replace('torch.', ''), Q=Q,
                   distinct_rows=distinct, kernel=name, **kw)
        kernel = [gp.prepare(name, tab, i, **kw) for i in windows]
        rec.update(geometry(name, kernel[0]))
        return self.measure(
            rec, kernel,
            [lambda i=i: gp.row_gather_reference(tab, i) for i in windows],
            [lambda i=i: torch.index_select(tab, 0, i) for i in windows],
            (Q + distinct) * row_bytes + Q * 4, rows=Q)

    def block_copy(self, rec: dict, tab: torch.Tensor, block_rows: int,
                   perm: Optional[torch.Tensor],
                   smem_bytes: int = 48 * 1024) -> dict:
        nb = tab.shape[0] // block_rows
        rec.update(R=tab.shape[0], W=tab.shape[1],
                   dtype=str(tab.dtype).replace('torch.', ''),
                   block_rows=block_rows, table_blocks=nb,
                   permuted=perm is not None, kernel='block_copy_tma')
        if perm is None:
            out = torch.empty_like(tab)

            def library():
                return out.copy_(tab)
        else:
            flat = tab.view(nb, -1)

            def library():
                return torch.index_select(flat, 0, perm).view(tab.shape)
        n_bytes = 2 * tab.numel() * tab.element_size() + (
            0 if perm is None else perm.numel() * 4)
        kernel = gp.prepare('block_copy_tma', tab, block_rows, perm,
                            smem_bytes)
        rec.update(geometry('block_copy_tma', kernel))
        return self.measure(
            rec, [kernel] * K,
            [lambda: gp.block_copy_reference(tab, block_rows, perm)] * K,
            [library] * K, n_bytes)


def geometry(name: str, launch) -> dict:
    """The fields of GEOMETRY[name] (per lane: `row_gather_lanes`) from a
    prepared launch's plan."""
    if launch.plan.get('mode') == 'lanes':
        name = 'row_gather_lanes'
    return {k: launch.plan[k] for k in GEOMETRY[name]}


def _streams(p: Probe, R: int, Q: int, names, extra: int = 0):
    """The scripts' index streams, Q + extra long: random (seeded
    RandomState), sorted (the random stream sorted, perf_r3_dma_sweep.py
    and perf_r3_dma_gather.py), coherent (perf_r3_dma_sweep.py:100,
    consecutive queries on consecutive rows) and ray (perf_r4_dma_scale.py:
    113-115, windows of 300 neighbouring rows on a stride-7 walk)."""
    n = Q + extra
    rand = p.rng().randint(0, R, n)
    out = {}
    for name in names:
        if name == 'random':
            out[name] = rand
        elif name == 'sorted':
            out[name] = np.sort(rand)
        elif name == 'coherent':
            out[name] = np.arange(n, dtype=np.int64) * R // n
        elif name == 'ray':
            span = min(300, R // 2)
            i = np.arange(n, dtype=np.int64)
            out[name] = (i * 7) % (R - span) + i % span
    return {k: p.ints(v) for k, v in out.items()}


def run_vmem(p: Probe, one=None):
    x = p.table(8, 128, torch.float32)
    for S in CAPACITY_BYTES:
        rec = dict(probe='vmem', what='capacity', tpu_kernel='probe',
                   script='scripts/perf_vmem_gather.py:64', smem_bytes=S)
        must_refuse = p.cuda and S > gp.SMEM_LIMIT
        try:
            gp.block_copy_tma(x[:1], 1, smem_bytes=S)
        except RuntimeError as e:
            if not must_refuse:
                raise
            p.emit(dict(rec, kernel='block_copy_tma', refused=True,
                        error=str(e)))
            continue
        if must_refuse:
            raise AssertionError(f'block_copy_tma: {S} B of shared memory '
                                 f'were not refused')
        rec['refused'] = False
        p.block_copy(rec, x[:1], 1, None, S)   # out[0] = x[0]

    R, W, Q = p.n(16384), 128, p.n(1 << 20)
    tab = p.table(R, W, torch.float32)
    idx = _streams(p, R, Q, ('random',))['random']
    for t in (tab, tab.to(torch.bfloat16)):
        p.gather(dict(probe='vmem', script='scripts/perf_vmem_gather.py:123',
                      tpu_kernel='gk_tala', stream='random'), t, [idx] * K)
    t16 = tab.to(torch.bfloat16)
    rec = dict(probe='vmem', script='scripts/perf_vmem_gather.py:164',
               tpu_kernel='gk_onehot', kernel='onehot_gather_mma', R=R,
               W=W, dtype='bfloat16', Q=Q, rb=gp.ONEHOT_RB, stream='random',
               library='none: no single call gathers bf16 rows into fp32')
    kernel = gp.prepare('onehot_gather_mma', t16, idx)
    rec.update(geometry('onehot_gather_mma', kernel))
    if p.cuda:
        rec['method_ops_ms'] = bound_ms(0.0, 2.0 * Q * R * W)[0]
    p.measure(rec, [kernel] * K,
              [lambda: gp.onehot_gather_reference(t16, idx)] * K, None,
              R * W * 2 + Q * 4 + Q * W * 4, rows=Q)


def run_layouts(p: Probe, one=None):
    R, W, Q = p.n(16384), 128, p.n(1 << 20)
    tab = p.table(R, W, torch.float32)
    idx = _streams(p, R, Q, ('random',))['random']
    p.gather(dict(probe='layouts', script='scripts/perf_r3_gather_layouts.py'
                  ':74,126', tpu_kernel='gk_col, gk_loop2', stream='random'),
             tab, [idx] * K)
    full = idx[:, None].expand(Q, W).contiguous()
    full64 = full.long()
    cols = torch.arange(W, device=p.dev)
    distinct = int(torch.unique(full64 * W + cols).numel())
    rec = dict(probe='layouts', script='scripts/perf_r3_gather_layouts.py:95',
               tpu_kernel='gk_full', kernel='row_gather', mode='per lane',
               R=R, W=W, dtype='float32', Q=Q, stream='random',
               distinct_elements=distinct)
    kernel = gp.prepare('row_gather', tab, full)
    rec.update(geometry('row_gather', kernel))
    p.measure(rec, [kernel] * K,
              [lambda: gp.row_gather_reference(tab, full)] * K,
              [lambda: torch.take_along_dim(tab, full64, 0)] * K,
              Q * W * 4 * 2 + distinct * 4, rows=Q)


def run_dma(p: Probe, one=None):
    R, W, B = p.n(4096), 128, p.n(512)
    tab = p.table(R, W, torch.float32)
    perm = p.ints(p.rng().permutation(R // B))
    for tk, line, pm in (('k_static', 27, None), ('k_dyn', 56, perm)):
        p.block_copy(dict(probe='dma', script=f'scripts/perf_r3_dma_control'
                          f'.py:{line}', tpu_kernel=tk), tab, B, pm)

    R = p.n(16384)
    tab = p.table(R, W, torch.float32)
    Q = p.n(1 << 18)
    for stream, idx in _streams(p, R, Q, ('random', 'sorted')).items():
        p.gather(dict(probe='dma', script='scripts/perf_r3_dma_gather.py:66',
                      tpu_kernel='dma_kernel', stream=stream, script_bq=2048),
                 tab, [idx] * K, name='row_gather_tma', depth=8, unroll=1)
    Q = p.n(1 << 16)
    idx = _streams(p, R, Q, ('random',))['random']
    for tk, line, depth in (('k_s1', 79, 1), ('k_s2', 96, 8)):
        p.gather(dict(probe='dma', script=f'scripts/perf_r3_dma_bisect.py:'
                      f'{line}', tpu_kernel=tk, stream='random',
                      script_bq=2048), tab, [idx] * K, name='row_gather_tma',
                 depth=depth, unroll=1)


def run_sweep(p: Probe, one=None):
    Q, R = p.n(1 << 20), p.n(1 << 16)
    for W, dtype in ((128, torch.float32), (176, torch.bfloat16)):
        tab = p.table(R, W, dtype)
        streams = _streams(p, R, Q, ('random', 'sorted', 'coherent'))
        for depth in (8, 16, 32):
            for stream, idx in streams.items():
                p.gather(dict(probe='sweep',
                              script='scripts/perf_r3_dma_sweep.py:41',
                              tpu_kernel='make_dma_gather', stream=stream,
                              script_bq=4096),
                         tab, [idx] * K, name='row_gather_tma', depth=depth,
                         unroll=1)


def _largest_divisor(n: int, at_most: int) -> int:
    return next(d for d in range(min(n, at_most), 0, -1) if n % d == 0)


def scale_pairs(one) -> List[tuple]:
    """The (variant, stream) pairs `scale` runs: `one`, checked, or all."""
    if not one:
        return ([(v, s) for v in GATHER_VARIANTS for s in GATHER_STREAMS]
                + [('copy', s) for s in COPY_STREAMS])
    for v, s in one:
        ok = (s in COPY_STREAMS if v == 'copy' else
              v in GATHER_VARIANTS and s in GATHER_STREAMS)
        if not ok:
            raise SystemExit(f'gather_probe scale: no variant {v!r} with '
                             f'stream {s!r}; variants {GATHER_VARIANTS} on '
                             f'{GATHER_STREAMS}, copy on {COPY_STREAMS}')
    return [tuple(x) for x in one]


def run_scale(p: Probe, one=None):
    pairs = scale_pairs(one)
    R, Q = p.n(SCALE_R), p.n(SCALE_Q)
    for W in SCALE_WIDTHS:
        tab = (p.table(R, W, torch.float32) * 0.1).to(torch.bfloat16)
        needed = sorted({s for v, s in pairs if v != 'copy'})
        # the script's coherent stream is 'ray' in _streams
        streams = _streams(p, R, Q, [('ray' if s == 'coherent' else s)
                                     for s in needed], extra=K)
        for v, s in pairs:
            rec = dict(probe='scale', variant=v, stream=s)
            if v == 'copy':
                B = _largest_divisor(R, 512)
                perm = (None if s == 'static' else
                        p.ints(p.rng().permutation(R // B)))
                rec.update(script='scripts/perf_r3_dma_control.py:27,56',
                           tpu_kernel='k_static, k_dyn')
                p.block_copy(rec, tab, B, perm)
                continue
            big = streams['ray' if s == 'coherent' else s]
            windows = [big[k:k + Q] for k in range(K)]
            if v == 'rows':
                rec.update(script='scripts/perf_r4_dma_scale.py:117',
                           tpu_kernel='take')
                p.gather(rec, tab, windows)
                continue
            unroll = 4 if v.startswith('dmau') else 1
            depth = int(v[4:] if unroll > 1 else v[3:])
            rec.update(script='scripts/perf_r4_dma_scale.py:'
                       + ('184' if unroll > 1 else '49'),
                       tpu_kernel=('make_dma_gather_unrolled' if unroll > 1
                                   else 'make_dma_gather'),
                       script_bq=SCALE_BQ)
            p.gather(rec, tab, windows, name='row_gather_tma', depth=depth,
                     unroll=unroll)


def host_us(call: Callable, n: int = LAUNCH_REPS) -> float:
    """Host microseconds per call of `call` over n calls in a row, from the
    first call to the synchronize after the last, after one warm-up call:
    the launch cost that the host pays, or the kernel's time where that is
    longer."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / n


def device_us(call: Callable, n: int = LAUNCH_REPS) -> float:
    """Device microseconds per call of `call`: the n calls wait in the
    stream behind a kernel that keeps the card busy for longer than the host
    takes to issue them (SPIN_CYCLES_PER_CALL each), so that CUDA events
    around them time the card alone, without the host's gaps."""
    call()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES_PER_CALL * n)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        call()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) * 1e3 / n


def run_launch(p: Probe, one=None):
    """The host's and the card's cost per launch of each wrapper's prepared
    launch at the small shapes where the card may wait for the host: the
    capacity probe's one row, the 2 MB control copy, the bisect's gathers
    (depths 1 and 8) and the vmem gathers at 2^16 queries; each output is
    held to its plain version first. Uses only what every version of the
    wrappers takes, so that it also times an older checkout's."""
    x = p.table(4096, 128, torch.float32)
    R = p.n(16384)
    tab = p.table(R, 128, torch.float32)
    idx = _streams(p, R, p.n(1 << 16), ('random',))['random']
    t16 = tab.to(torch.bfloat16)
    cases = (
        ('block_copy_tma', 'one row, 48 KB', (x[:1], 1, None, 48 * 1024),
         lambda: x[:1].clone()),
        ('block_copy_tma', '2 MB, 512-row blocks', (x, 512, None),
         lambda: x.clone()),
        ('row_gather_tma', 'bisect k_s1, depth 1', (tab, idx, 1),
         lambda: gp.row_gather_reference(tab, idx)),
        ('row_gather_tma', 'bisect k_s2, depth 8', (tab, idx),
         lambda: gp.row_gather_reference(tab, idx)),
        ('row_gather', 'f32 W128', (tab, idx),
         lambda: gp.row_gather_reference(tab, idx)),
        ('onehot_gather_mma', 'bf16 W128', (t16, idx),
         lambda: gp.onehot_gather_reference(t16, idx)))
    for name, what, args, plain in cases:
        rec = dict(probe='launch', kernel=name, what=what)
        call = gp.prepare(name, *args)
        got, want = call(), plain()
        if not same_bits(got, want):
            raise AssertionError(f'{rec}: the kernel disagrees with its plain '
                                 f'version')
        rec.update(equal=True, max_abs_err=max_abs_err(got, want))
        if p.cuda:
            rec['host_us'] = host_us(call)
            rec['device_us'] = device_us(call)
            rec['ms'] = time_ms([call] * K)
        p.emit(rec)


SUBCOMMANDS = dict(vmem=run_vmem, layouts=run_layouts, dma=run_dma,
                   sweep=run_sweep, scale=run_scale, launch=run_launch)


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(
        prog='python -m vampire_tpu_torch.tools.gather_probe',
        description='The row-gather and DMA probes of scripts/ on the card.')
    ap.add_argument('sub', choices=sorted(SUBCOMMANDS))
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu' (the plain versions)")
    ap.add_argument('--one', nargs=2, action='append',
                    metavar=('VARIANT', 'STREAM'),
                    help='scale only: run this pair (repeatable)')
    ap.add_argument('--div', type=int, default=1,
                    help='divide every row and query count by this')
    args = ap.parse_args(argv)
    if args.one and args.sub != 'scale':
        ap.error('--one is for scale')
    if args.div < 1:
        ap.error('--div must be at least 1')
    p = Probe(args.device, args.div)
    SUBCOMMANDS[args.sub](p, args.one)
    return p.records


if __name__ == '__main__':
    main(sys.argv[1:])
