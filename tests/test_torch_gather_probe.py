"""The port's row-gather and bulk-copy probes (`ops/gather_probe.py`,
`tools/gather_probe.py`) against the JAX package's probe scripts on the CPU.

The module-level Pallas gathers of scripts/perf_r4_dma_scale.py
(`make_dma_gather`, `make_dma_gather_unrolled`) and
scripts/perf_r3_dma_sweep.py (`make_dma_gather`) run for real, in Pallas's
TPU interpret mode: the script is loaded as a module, its globals Q and BQ
are set small, and `pallas_call` is patched to interpret. The probes built
inside the scripts' `main()` cannot be reached without editing the scripts,
so the port is held to the scripts' own references, computed by JAX on the
CPU. Every function here copies bits (the one-hot product of bf16 values
summed in fp32 is exact), so every comparison is exact equality.

The `gpu` cases hold each kernel to its plain version on the card; the
module imports JAX only inside the CPU tests, so that they are collected on
a machine without it.
"""
import functools
import importlib.util
import io
import json
import os
import sys
from contextlib import nullcontext, redirect_stdout

import numpy as np
import pytest
import torch

from vampire_tpu_torch.ops import gather_probe as gp
from vampire_tpu_torch.tools import gather_probe as tool

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'scripts')


def _load_script(name):
    """The script as a module; sys.path is restored after its body ran,
    which inserts a path of its own."""
    spec = importlib.util.spec_from_file_location(
        f'_probe_{name}', os.path.join(SCRIPTS, f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


@pytest.fixture
def jnp():
    pytest.importorskip('jax')
    import jax.numpy
    return jax.numpy


@pytest.fixture
def interpret(monkeypatch, jnp):
    """pallas_call in Pallas's TPU interpret mode, for this test only."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(pl, 'pallas_call', functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))


def _bits(a):
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _table(jnp, R, W, dtype, seed=0):
    """(R, W) table of `dtype` ('int32', 'float32' or 'bfloat16') from a
    seed, as the jax array and the torch tensor of the same bits."""
    rng = np.random.RandomState(seed)
    if dtype == 'int32':
        a = rng.randint(-2 ** 31, 2 ** 31 - 1, (R, W)).astype(np.int32)
        return jnp.asarray(a), torch.from_numpy(a)
    a = rng.randn(R, W).astype(np.float32)
    if dtype == 'float32':
        return jnp.asarray(a), torch.from_numpy(a)
    t = torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a).astype(jnp.bfloat16), t


def _script_streams(jnp, R, n, seed=1):
    """The scripts' index streams of length n over R rows: random (seeded
    RandomState), sorted, the sweep's coherent (perf_r3_dma_sweep.py:100)
    and the scale script's ray-coherent (perf_r4_dma_scale.py:113-115),
    written as the scripts write them in JAX."""
    rand = np.random.RandomState(seed).randint(0, R, n).astype(np.int32)
    i = jnp.arange(n, dtype=jnp.int32)
    out = dict(random=rand, sorted=np.sort(rand),
               coherent=np.array(i * R // n))
    if R > 300:
        out['ray'] = np.array((i * 7) % (R - 300) + i % 300)
    return out


# --------------------------------------------------------------------------
# the module-level Pallas gathers, run in interpret mode

R4_CASES = [(d, u, s) for d, u in ((1, 1), (4, 1), (8, 1), (4, 2), (8, 2))
            for s in ('random', 'sorted', 'ray')]


@pytest.mark.parametrize('depth,unroll,stream', R4_CASES)
def test_scale_script_dma_gather_interpret(interpret, jnp, depth, unroll,
                                           stream):
    """perf_r4_dma_scale.py's `make_dma_gather` (unroll 1) and
    `make_dma_gather_unrolled` on its int32 row view (W/2 = 128 lanes), in
    interpret mode, against the port's row_gather and row_gather_tma."""
    m = _load_script('perf_r4_dma_scale')
    m.Q, m.BQ = 64, 32
    R, w = 640, 128
    jt, tt = _table(jnp, R, w, 'int32')
    idx = _script_streams(jnp, R, m.Q)[stream]
    if unroll == 1:
        f = m.make_dma_gather(depth, jnp.int32, w)
    else:
        f = m.make_dma_gather_unrolled(depth, jnp.int32, w, unroll=unroll)
    want = np.asarray(f(jnp.asarray(idx), jt))
    np.testing.assert_array_equal(want, np.asarray(jt)[idx])
    ti = torch.from_numpy(idx)
    got = gp.row_gather_tma(tt, ti, depth=depth, unroll=unroll)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(gp.row_gather(tt, ti).numpy(), want)


@pytest.mark.parametrize('dtype,w,unroll', [('float32', 128, 1),
                                            ('float32', 128, 2),
                                            ('bfloat16', 176, 1),
                                            ('bfloat16', 176, 2)])
def test_scale_script_dma_gather_dtypes_interpret(interpret, jnp, dtype, w,
                                                  unroll):
    """The same Pallas gathers on f32 rows and on the port's 352 B bf16
    corner-table rows (W = 176), bit for bit."""
    m = _load_script('perf_r4_dma_scale')
    m.Q, m.BQ = 64, 32
    R = 640
    jt, tt = _table(jnp, R, w, dtype)
    idx = _script_streams(jnp, R, m.Q)['random']
    jdt = jnp.float32 if dtype == 'float32' else jnp.bfloat16
    f = (m.make_dma_gather(8, jdt, w) if unroll == 1 else
         m.make_dma_gather_unrolled(8, jdt, w, unroll=unroll))
    want = _bits(f(jnp.asarray(idx), jt))
    ti = torch.from_numpy(idx)
    for got in (gp.row_gather_tma(tt, ti, depth=8, unroll=unroll),
                gp.row_gather(tt, ti)):
        np.testing.assert_array_equal(_bits(got.view(torch.int16)
                                            if dtype == 'bfloat16'
                                            else got.numpy()), want)


@pytest.mark.parametrize('dtype,w', [('float32', 128), ('bfloat16', 176)])
@pytest.mark.parametrize('stream', ['random', 'sorted', 'coherent'])
def test_sweep_script_dma_gather_interpret(interpret, jnp, dtype, w,
                                           stream):
    """perf_r3_dma_sweep.py's `make_dma_gather(Q, BQ, W, depth, dtype)` at
    depth 8 on its f32 W128 and bf16 W176 rows, in interpret mode."""
    m = _load_script('perf_r3_dma_sweep')
    Q, BQ, R = 64, 32, 256
    jt, tt = _table(jnp, R, w, dtype)
    idx = _script_streams(jnp, R, Q)[stream]
    jdt = jnp.float32 if dtype == 'float32' else jnp.bfloat16
    want = _bits(m.make_dma_gather(Q, BQ, w, 8, jdt)(jnp.asarray(idx), jt))
    got = gp.row_gather_tma(tt, torch.from_numpy(idx), depth=8)
    got = got.view(torch.int16) if dtype == 'bfloat16' else got.numpy()
    np.testing.assert_array_equal(_bits(got), want)


def test_tool_streams_are_the_scripts(jnp):
    """tools/gather_probe.py's index streams are the scripts' formulas."""
    R, Q, K = 640, 96, 8
    p = tool.Probe('cpu')
    got = tool._streams(p, R, Q, ('random', 'sorted', 'coherent', 'ray'),
                        extra=K)
    want = _script_streams(jnp, R, Q + K)
    for name in ('random', 'sorted', 'coherent', 'ray'):
        np.testing.assert_array_equal(got[name].numpy(), want[name],
                                      err_msg=name)


# --------------------------------------------------------------------------
# the probes inside the scripts' main(), against the scripts' references

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_row_gather_matches_take(jnp, dtype):
    """`gk_tala`, `gk_col`, `gk_loop2` (row gathers) against the scripts'
    reference `jnp.take(t, i, axis=0)`."""
    R, W, Q = 300, 128, 1000
    jt, tt = _table(jnp, R, W, dtype)
    idx = _script_streams(jnp, R, Q)['random']
    want = _bits(jnp.take(jt, jnp.asarray(idx), axis=0))
    ti = torch.from_numpy(idx)
    for got in (gp.row_gather(tt, ti), gp.row_gather_tma(tt, ti),
                gp.row_gather_tma(tt, ti, depth=1),
                gp.row_gather_tma(tt, ti, depth=32, unroll=4)):
        got = got.view(torch.int16) if dtype == 'bfloat16' else got.numpy()
        np.testing.assert_array_equal(_bits(got), want)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('broadcast', [True, False])
def test_row_gather_per_lane_matches_take_along_axis(jnp, dtype,
                                                     broadcast):
    """`gk_full` (per-lane gather) against `jnp.take_along_axis`, with the
    script's broadcast (Q, W) indices and with independent ones."""
    R, W, Q = 200, 128, 512
    jt, tt = _table(jnp, R, W, dtype)
    rng = np.random.RandomState(3)
    idx = (np.broadcast_to(rng.randint(0, R, (Q, 1)), (Q, W)) if broadcast
           else rng.randint(0, R, (Q, W)))
    idx = np.ascontiguousarray(idx, np.int32)
    want = _bits(jnp.take_along_axis(jt, jnp.asarray(idx), axis=0))
    got = gp.row_gather(tt, torch.from_numpy(idx))
    got = got.view(torch.int16) if dtype == 'bfloat16' else got.numpy()
    np.testing.assert_array_equal(_bits(got), want)


def test_onehot_gather_matches_chunked_onehot_dot(jnp):
    """`gk_onehot`: sum over RB-row chunks of jnp.dot(onehot_bf16, tab_bf16,
    preferred_element_type=f32), as the script's kernel computes it; also
    f32(bf16(tab))[idx]."""
    R, W, Q, RB = 2 * gp.ONEHOT_RB, 128, 256, gp.ONEHOT_RB
    jt, tt = _table(jnp, R, W, 'bfloat16')
    idx = _script_streams(jnp, R, Q)['random']
    ids = jnp.asarray(idx)[:, None]
    want = jnp.zeros((Q, W), jnp.float32)
    for j in range(R // RB):
        oh = (jnp.arange(RB, dtype=jnp.int32)[None, :]
              == ids - j * RB).astype(jnp.bfloat16)
        want = want + jnp.dot(oh, jt[j * RB:(j + 1) * RB],
                              preferred_element_type=jnp.float32)
    want = np.asarray(want)
    got = gp.onehot_gather_mma(tt, torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        got, np.asarray(jt.astype(jnp.float32))[idx])


def _nonfinite_onehot_case(jnp, R=2 * gp.ONEHOT_RB, W=128, Q=256):
    """A bf16 table with non-finite entries and indices that select some of
    them: column 0 holds one inf, in a selected row; column 1 one NaN, in
    an unselected row; column 2 -inf and inf. As jax and torch arrays, the
    indices as numpy, and the selected row of column 0."""
    a = np.random.RandomState(4).randn(R, W).astype(np.float32)
    idx = np.random.RandomState(5).randint(0, R, Q).astype(np.int32)
    hit = int(idx[7])
    miss = next(r for r in range(R) if r not in set(idx.tolist()))
    a[hit, 0] = np.inf
    a[miss, 1] = np.nan
    a[3, 2], a[R - 2, 2] = -np.inf, np.inf
    return (jnp.asarray(a).astype(jnp.bfloat16),
            torch.from_numpy(a).to(torch.bfloat16), idx, hit)


def test_onehot_gather_nonfinite_matches_chunked_onehot_dot(jnp):
    """The full one-hot product's semantics on a table with inf and NaN:
    the port's plain version against the script's chunked
    jnp.dot(onehot_bf16, tab_bf16, preferred_element_type=f32). NaN masks
    equal, every other value bit-equal; the selected inf survives for the
    query that selects it, 0 * inf poisons the rest of its column."""
    RB = gp.ONEHOT_RB
    jt, tt, idx, hit = _nonfinite_onehot_case(jnp)
    R, Q = tt.shape[0], idx.shape[0]
    ids = jnp.asarray(idx)[:, None]
    want = jnp.zeros((Q, tt.shape[1]), jnp.float32)
    for j in range(R // RB):
        oh = (jnp.arange(RB, dtype=jnp.int32)[None, :]
              == ids - j * RB).astype(jnp.bfloat16)
        want = want + jnp.dot(oh, jt[j * RB:(j + 1) * RB],
                              preferred_element_type=jnp.float32)
    want = np.asarray(want)
    got = gp.onehot_gather_mma(tt, torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_array_equal(_bits(got[fin]), _bits(want[fin]))
    # what the case is built to show
    sel = idx == hit
    assert np.isposinf(got[sel, 0]).all() and np.isnan(got[~sel, 0]).all()
    assert np.isnan(got[:, 1]).all() and np.isnan(got[:, 2]).all()
    assert not np.isnan(got[:, 3:]).any()


@pytest.mark.parametrize('permuted', [False, True])
def test_block_copy_matches_control(jnp, permuted):
    """`k_static` (out = tab) and `k_dyn` (perf_r3_dma_control.py:77:
    tab.reshape(R/B, B, W)[perm]) at the script's B = 512 rows."""
    R, W, B = 4096, 128, 512
    jt, tt = _table(jnp, R, W, 'float32')
    perm = np.random.RandomState(1).permutation(R // B).astype(np.int32)
    want = np.asarray(jt)
    if permuted:
        want = want.reshape(R // B, B, W)[perm].reshape(R, W)
    got = gp.block_copy_tma(tt, B, torch.from_numpy(perm) if permuted
                            else None)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize('smem_bytes', [48 * 1024, gp.SMEM_LIMIT])
def test_capacity_probe_stages_row_zero(smem_bytes):
    """The capacity probe's function: out[0] = x[0]."""
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 128).astype(
        np.float32))
    got = gp.block_copy_tma(x[:1], 1, smem_bytes=smem_bytes)
    np.testing.assert_array_equal(got[0].numpy(), x[0].numpy())


@pytest.mark.parametrize('call,err', [
    (lambda t, i: gp.row_gather(t, i + 300), IndexError),
    (lambda t, i: gp.row_gather(t, i - 1000), IndexError),
    (lambda t, i: gp.row_gather(t, i.long()), TypeError),
    (lambda t, i: gp.row_gather(t[:, :3].contiguous(), i), ValueError),
    (lambda t, i: gp.row_gather_tma(t, i, depth=6, unroll=4), ValueError),
    (lambda t, i: gp.row_gather_tma(t, i[:, None]), ValueError),
    (lambda t, i: gp.row_gather_tma(torch.zeros(300, 2048), i, depth=128),
     ValueError),
    (lambda t, i: gp.block_copy_tma(t, 100, smem_bytes=191), ValueError),
    (lambda t, i: gp.onehot_gather_mma(t, i), TypeError),
    (lambda t, i: gp.block_copy_tma(t, 7), ValueError),
    (lambda t, i: gp.block_copy_tma(t, 100, torch.tensor(
        [0, 1, 3], dtype=torch.int32)), IndexError),
])
def test_wrappers_reject_what_the_kernels_do_not_take(call, err):
    """Every wrapper checks its arguments on the CPU as on the card."""
    tt = torch.zeros(300, 8)
    idx = torch.arange(300, dtype=torch.int32)
    with pytest.raises(err):
        call(tt, idx)


# --------------------------------------------------------------------------
# the launch plans of the two bulk-copy kernels

def _tma_rows_by_block(Q, plan):
    """The queries each block of `row_gather_tma` writes, in the order the
    kernel walks them: tiles b, b + blocks, ... of tile_rows queries."""
    T, nb = plan['tile_rows'], plan['blocks']
    return [[q for t in range(b, -(-Q // T), nb)
             for q in range(t * T, min(Q, (t + 1) * T))] for b in range(nb)]


@pytest.mark.parametrize('row_bytes', [16, 352, 512, 4096])
@pytest.mark.parametrize('Q', [1, 31, 1000, 1 << 16])
def test_row_gather_tma_plan_covers_every_query_once(row_bytes, Q):
    for depth in (1, 8, 32):
        plan = gp.row_gather_tma_plan(Q, row_bytes, depth)
        rows = [q for b in _tma_rows_by_block(Q, plan) for q in b]
        assert sorted(rows) == list(range(Q))
        assert 1 <= plan['blocks'] <= plan['blocks_per_sm'] * gp.H100_SMS
        assert plan['copies_in_flight'] == plan['blocks'] * depth


@pytest.mark.parametrize('row_bytes', [16, 352, 512, 4096])
@pytest.mark.parametrize('depth', [1, 4, 8, 16, 32])
def test_row_gather_tma_plan_fits_shared_memory(row_bytes, depth):
    """The ring holds the rows in flight and the tile being stored; the
    mbarriers and the ring fit the block's shared memory."""
    plan = gp.row_gather_tma_plan(1 << 20, row_bytes, depth)
    T, ring = plan['tile_rows'], plan['ring_tiles']
    assert T * row_bytes <= gp.TMA_TILE_BYTES or T == 1
    assert (ring - 1) * T >= depth - 1 and ring >= 2
    assert -(-8 * depth // 128) * 128 + ring * T * row_bytes \
        == plan['smem_bytes'] <= gp.SMEM_LIMIT
    assert plan['blocks_per_sm'] == min(
        gp.MAX_BLOCKS_PER_SM,
        gp.SM_SMEM // (plan['smem_bytes'] + gp.SMEM_RESERVED_PER_BLOCK))


@pytest.mark.parametrize('row_bytes', [352, 512])
def test_row_gather_tma_plan_fits_three_blocks_an_sm(row_bytes):
    """At the corner table's 352 B rows and the scripts' 512 B rows, every
    depth and unroll the tool runs leaves room for 3 blocks on an SM."""
    for depth in (1, 4, 8, 16, 32):
        plan = gp.row_gather_tma_plan(1 << 22, row_bytes, depth)
        assert plan['blocks_per_sm'] >= 3
        assert plan['blocks'] == 132 * plan['blocks_per_sm']


@pytest.mark.parametrize('smem_bytes', [16 * 1024, 48 * 1024, gp.SMEM_LIMIT])
@pytest.mark.parametrize('n_blocks,block_bytes', [(1, 512), (8, 262144),
                                                   (5397, 131584),
                                                   (7, 12256 * 3 + 16)])
def test_block_copy_plan_covers_every_byte_once(smem_bytes, n_blocks,
                                                block_bytes):
    """The stages fit the shared memory; the chunks of a block cover it
    once, the last one short; each (block, chunk) pair has one block."""
    plan = gp.block_copy_plan(n_blocks, block_bytes, smem_bytes)
    c = plan['chunk_bytes']
    assert c % 16 == 0 and c >= 16
    assert gp.COPY_BAR_BYTES + plan['stages'] * c <= smem_bytes
    assert (plan['chunks'] - 1) * c < block_bytes <= plan['chunks'] * c
    nb = plan['blocks']
    pairs = n_blocks * plan['chunks']
    walked = [p for b in range(nb) for p in range(b, pairs, nb)]
    assert sorted(walked) == list(range(pairs))
    assert nb <= plan['blocks_per_sm'] * gp.H100_SMS
    assert plan['blocks_per_sm'] >= 1


def test_shared_memory_is_allowed_once_and_a_refusal_is_not_kept(
        monkeypatch):
    """`_allow_smem` asks the card only for more than it allowed before; a
    refused size raises each time it is asked for."""
    calls = []

    def allow(n):
        calls.append(n)
        return 1 if n > gp.SMEM_LIMIT else 0
    monkeypatch.setattr(gp, '_kernel', lambda symbol: allow)
    monkeypatch.setattr(gp, '_SMEM_ALLOWED', {})
    monkeypatch.setattr(torch.cuda, 'device', lambda d: nullcontext())
    dev = torch.device('cuda', 0)
    for n in (64 * 1024, 48 * 1024, 64 * 1024, gp.SMEM_LIMIT):
        gp._allow_smem('block_copy_tma', dev, 'block_copy_tma', n)
    assert calls == [64 * 1024, gp.SMEM_LIMIT]
    for _ in range(2):
        with pytest.raises(RuntimeError, match='CUDA error 1'):
            gp._allow_smem('block_copy_tma', dev, 'block_copy_tma',
                           gp.SMEM_LIMIT + 1)
    assert calls[2:] == [gp.SMEM_LIMIT + 1] * 2
    gp._allow_smem('row_gather_tma', dev, 'row_gather_tma', 1024)
    assert calls[-1] == 1024
    assert gp._SMEM_ALLOWED == {(0, 'block_copy_tma'): gp.SMEM_LIMIT,
                                (0, 'row_gather_tma'): 1024}


PLAN_Q = [1, 31, 257, 19993]


def _walk_rows(Q, plan):
    """The (query, piece) pairs row_gather's rows kernel stores, in the
    order its threads visit them: the first pair, 32 pairs and a run of
    every warp divided once, from the plan's `blocks`, then additions, as
    csrc/gather_probe.cu walks them."""
    P, U = plan['pieces'], plan['loads_in_flight']
    t = np.arange(plan['blocks'] * plan['threads'], dtype=np.int64)
    e = (t >> 5) * 32 * U + (t & 31)
    q, c = e // P, e % P
    lane_q, lane_c = divmod(32, P)
    step_q, step_c = divmod(plan['blocks'] * plan['threads'] * U, P)
    seen = []

    def add(q, c, dq, dc):
        q, c = q + dq, c + dc
        wrap = c >= P
        return q + wrap, c - P * wrap
    while (q < Q).any():
        qq, cc = q, c
        for _ in range(U):
            seen.append(qq[qq < Q] * P + cc[qq < Q])
            qq, cc = add(qq, cc, lane_q, lane_c)
        q, c = add(q, c, step_q, step_c)
    return np.concatenate(seen)


@pytest.mark.parametrize('row_bytes', [16, 48, 256, 352, 512, 4096])
@pytest.mark.parametrize('Q', PLAN_Q)
def test_row_gather_plan_covers_every_piece_once(row_bytes, Q):
    """Rows mode: the walk by additions stores every (query, 16-byte piece)
    pair once; a warp's loads are 32 consecutive pairs; the grid fits the
    card and needs no more blocks than the work."""
    plan = gp.row_gather_plan(Q, row_bytes // 4, 4)
    P = plan['pieces']
    assert P == row_bytes // 16
    assert 1 <= plan['blocks'] <= plan['blocks_per_sm'] * gp.H100_SMS
    assert (plan['blocks'] - 1) * plan['threads'] * \
        plan['loads_in_flight'] < Q * P
    walked = _walk_rows(Q, plan)
    np.testing.assert_array_equal(np.sort(walked), np.arange(Q * P))
    assert plan == gp.row_gather_plan(Q, row_bytes // 2, 2)


@pytest.mark.parametrize('row_bytes', [16, 352, 4096])
def test_query_numbers_stay_in_int(row_bytes, monkeypatch):
    """At MAX_QUERIES the kernels' int query numbers cannot overflow: the
    rows walk's last step and the one-hot CTAs' queries stay below 2^31;
    the wrappers refuse more queries before they reach a kernel."""
    # an H100 SM holds 2,048 threads: 8 blocks of the rows mode
    plan = gp.row_gather_plan(gp.MAX_QUERIES, row_bytes // 4, 4, per_sm=8)
    step = plan['blocks'] * plan['threads'] * plan['loads_in_flight']
    assert gp.MAX_QUERIES + step + 32 <= 2 ** 31 - 1
    oh = gp.onehot_plan(gp.MAX_QUERIES, 16384)
    assert oh['ctas'] * oh['queries_per_cta'] <= 2 ** 31 - 1
    monkeypatch.setattr(gp, 'MAX_QUERIES', 4)
    tab = torch.zeros(8, row_bytes // 2, dtype=torch.bfloat16)
    idx = torch.zeros(5, dtype=torch.int32)
    for name in ('row_gather', 'row_gather_tma'):
        with pytest.raises(ValueError, match='5 queries exceed'):
            gp.prepare(name, tab, idx)
    with pytest.raises(ValueError, match='5 queries'):
        gp.prepare('onehot_gather_mma', tab[:, :8].contiguous(), idx)
    assert torch.equal(gp.row_gather(tab, idx[:4]), tab[:4])


@pytest.mark.parametrize('W,elem_bytes', [(5, 4), (12, 4), (128, 4),
                                          (1024, 4), (5, 2), (128, 2),
                                          (176, 2)])
@pytest.mark.parametrize('Q', PLAN_Q)
def test_row_gather_lanes_plan_covers_every_element_once(W, elem_bytes, Q):
    """Lanes mode: every (query, element) is one thread's, once; 16 bytes a
    thread where W allows it and the indices are aligned; the grid and
    blocks fit the card's limits."""
    for aligned in (True, False):
        plan = gp.row_gather_plan(Q, W, elem_bytes, lanes=True,
                                  aligned=aligned)
        vec = plan['vec']
        assert vec == (16 // elem_bytes if aligned and
                       W % (16 // elem_bytes) == 0 else 1)
        (bx, by), (gx, gy) = plan['block'], plan['grid']
        assert bx * by == plan['threads'] <= 1024 and gy <= 65535
        q = (np.arange(gx)[:, None] * by + np.arange(by)[None, :]).ravel()
        jv = (np.arange(gy)[:, None] * bx + np.arange(bx)[None, :]).ravel()
        q, jv = q[q < Q], jv[jv < W // vec]
        el = (q[:, None, None] * W + jv[None, :, None] * vec
              + np.arange(vec)[None, None, :]).ravel()
        np.testing.assert_array_equal(np.sort(el), np.arange(Q * W))


@pytest.mark.parametrize('R', [1, 64, 3000, 65541])
@pytest.mark.parametrize('Q', PLAN_Q)
def test_onehot_plan_covers_every_query_once(R, Q):
    """Each query is the fragment row of one thread of one consumer
    warpgroup (rows g and g + 8 of a warp's 16, two m64 tiles); the ring
    of 128-column tiles and its barriers fit the shared memory; one CTA
    fits an SM."""
    plan = gp.onehot_plan(Q, R)
    assert plan['smem_bytes'] >= 1024 + plan['stages'] * (
        gp.ONEHOT_STAGE_BYTES + 16)
    assert plan['smem_bytes'] <= gp.SMEM_LIMIT
    assert plan['threads'] == 128 * (1 + gp.ONEHOT_CONSUMERS) <= 1024
    assert 0 <= plan['table_tiles'] * plan['tile_rows'] - R < \
        plan['tile_rows']
    cta, wg, mt, warp, g, h = np.meshgrid(
        np.arange(plan['ctas']), np.arange(gp.ONEHOT_CONSUMERS),
        np.arange(2), np.arange(4), np.arange(8), np.arange(2),
        indexing='ij')
    q = ((cta * gp.ONEHOT_CONSUMERS + wg) * 128 + 64 * mt + 16 * warp + g
         + 8 * h).ravel()
    q = q[q < Q]
    np.testing.assert_array_equal(np.sort(q), np.arange(Q))
    assert (plan['ctas'] - 1) * plan['queries_per_cta'] < Q


def test_prepared_launch_carries_its_plan():
    """On CPU tensors the prepared launch runs the plain version and
    carries the geometry an H100 would run."""
    tab = torch.zeros(300, 88, dtype=torch.bfloat16)
    idx = torch.arange(300, dtype=torch.int32)
    call = gp.prepare('row_gather_tma', tab, idx, depth=8, unroll=4)
    assert call.plan == gp.row_gather_tma_plan(300, 176, 8)
    assert torch.equal(call(), tab)
    call = gp.prepare('block_copy_tma', tab, 100, None, 64 * 1024)
    assert call.plan == gp.block_copy_plan(3, 100 * 176, 64 * 1024)
    call = gp.prepare('row_gather', tab, idx)
    assert call.plan == gp.row_gather_plan(300, 88, 2)
    assert torch.equal(call(), tab)
    lanes = idx[:, None].expand(300, 88).contiguous()
    call = gp.prepare('row_gather', tab, lanes)
    assert call.plan == gp.row_gather_plan(300, 88, 2, lanes=True)
    assert call.plan['vec'] == 8
    call = gp.prepare('onehot_gather_mma', tab[:, :72].contiguous(), idx)
    assert call.plan == gp.onehot_plan(300, 300)
    assert call.plan['ctas'] == 2


# --------------------------------------------------------------------------
# the tool, end to end on the CPU

@pytest.mark.parametrize('sub', sorted(tool.SUBCOMMANDS))
def test_tool_runs_on_cpu(sub):
    """`python -m vampire_tpu_torch.tools.gather_probe SUB --device cpu` at
    a tiny size: every line parses, is labelled as the plain versions on
    the CPU, holds no time and reports equality."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        recs = tool.main([sub, '--device', 'cpu', '--div', '2048'])
    lines = buf.getvalue().splitlines()
    assert len(lines) == len(recs) > 0
    for ln in lines:
        rec = json.loads(ln)
        assert rec['device'] == tool.CPU_LABEL
        assert rec['probe'] == sub
        assert not {'ms', 'plain_ms', 'library_ms', 'bound_ms',
                    'method_ops_ms'} & set(rec)
        assert rec.get('equal') is True or rec.get('refused') is False
        assert rec['max_abs_err'] == 0.0


def test_tool_scale_one_selects_pairs():
    buf = io.StringIO()
    with redirect_stdout(buf):
        recs = tool.main(['scale', '--device', 'cpu', '--div', '4096',
                          '--one', 'dmau8', 'coherent', '--one', 'copy',
                          'permuted'])
    got = [(r['variant'], r['stream'], r['W']) for r in recs]
    assert got == [('dmau8', 'coherent', 256), ('copy', 'permuted', 256),
                   ('dmau8', 'coherent', 176), ('copy', 'permuted', 176)]
    assert recs[0]['depth'] == 8 and recs[0]['unroll'] == 4
    with pytest.raises(SystemExit):
        tool.main(['scale', '--device', 'cpu', '--one', 'copy', 'random'])


def test_tool_bound_and_error():
    """The bound is the larger of the bytes' time at 3.35 TB/s and the
    operations' at 989 TFLOP/s; the error is max |a - b| across row chunks."""
    ms, by = tool.bound_ms(3.35e9)
    assert (ms, by) == (pytest.approx(1.0), 'bytes')
    ms, by = tool.bound_ms(3.35e9, 2 * 989e9)
    assert (ms, by) == (pytest.approx(2.0), 'operations')
    a = torch.zeros((3 << 20) // 2, 2, dtype=torch.bfloat16)
    b = a.clone()
    b[-1, 1] = -0.5
    assert tool.max_abs_err(a, b) == 0.5
    assert tool.max_abs_err(a, a) == 0.0


# --------------------------------------------------------------------------
# on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    return torch.device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('dtype,W', [(torch.float32, 128),
                                     (torch.bfloat16, 176),
                                     (torch.float32, 4),
                                     (torch.float32, 12),
                                     (torch.bfloat16, 256),
                                     (torch.float32, 1024)])
def test_row_gathers_match_plain_on_gpu(dtype, W):
    """Both row gathers, bit for bit, on f32 W128 (512 B), bf16 W176 and
    W256 (352 and 512 B) and 16 B, 48 B and 4 KB rows; `row_gather_tma` at
    depths 1, 8 and 32 and unroll 1 and 4, with ragged edges: Q not a
    multiple of the tile, Q < 32 and one row. Per lane, tables of width 5,
    128, 176 and the case's W (block shapes (1, 256) at f32 W4 and (256, 1)
    at W1024), with aligned indices (16 bytes a thread where W allows) and
    with indices one element off alignment."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    tab = torch.randn((5000, W), generator=g, device=dev).to(dtype)
    # no tile of these widths (32, 46, 1024 or 4 rows) divides 19,993
    for Q in (20000, 19993, 31, 1):
        idx = torch.randint(0, 5000, (Q,), generator=g, device=dev,
                            dtype=torch.int32)
        want = gp.row_gather_reference(tab, idx)
        got = gp.row_gather(tab, idx)
        torch.cuda.synchronize()
        assert tool.same_bits(got, want), Q
        for depth, unroll in ((1, 1), (8, 1), (8, 4), (32, 1), (32, 4)):
            got = gp.row_gather_tma(tab, idx, depth=depth, unroll=unroll)
            torch.cuda.synchronize()
            assert tool.same_bits(got, want), (Q, depth, unroll)
    for lw in sorted({5, 128, 176, W}):
        t = torch.randn((5000, lw), generator=g, device=dev).to(dtype)
        for Q in (3000, 257, 1):
            flat = torch.randint(0, 5000, (Q * lw + 1,), generator=g,
                                 device=dev, dtype=torch.int32)
            for lanes in (flat[:-1].view(Q, lw), flat[1:].view(Q, lw)):
                call = gp.prepare('row_gather', t, lanes)
                got = call()
                torch.cuda.synchronize()
                assert tool.same_bits(got, gp.row_gather_reference(t, lanes)), \
                    (lw, Q, call.plan)


@pytest.mark.gpu
def test_bulk_copy_plans_match_the_cards_occupancy():
    """The plans' blocks per SM are what the card reports for the same
    dynamic shared memory (for row_gather's rows mode, for its 256-thread
    blocks), and its SMs are the H100's 132."""
    dev = _cuda()
    assert torch.cuda.get_device_properties(dev).multi_processor_count \
        == gp.H100_SMS
    flat = torch.zeros(4096 * 1024, device=dev)
    idx = torch.zeros(1 << 16, dtype=torch.int32, device=dev)
    for row_bytes, depth in ((512, 1), (512, 8), (352, 32), (4096, 32)):
        t = flat[:4096 * row_bytes // 4].view(4096, row_bytes // 4)
        got = gp.prepare('row_gather_tma', t, idx, depth=depth).plan
        assert got == gp.row_gather_tma_plan(1 << 16, row_bytes, depth)
    for row_bytes in (48, 352, 512):
        t = flat[:4096 * row_bytes // 4].view(4096, row_bytes // 4)
        got = gp.prepare('row_gather', t, idx).plan
        assert got == gp.row_gather_plan(1 << 16, row_bytes // 4, 4)
    tab = flat[:4096 * 128].view(4096, 128)
    for smem in (16 * 1024, 48 * 1024, gp.SMEM_LIMIT):
        got = gp.prepare('block_copy_tma', tab, 512, None, smem).plan
        assert got == gp.block_copy_plan(8, 512 * 512, smem)


def _nan_equal(a, b):
    """NaN at the same places, every other value bit-equal. (The tensor
    cores' NaN and the plain version's bf16 NaN widened to fp32 differ in
    their payload.)"""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and tool.same_bits(a[~na], b[~nb])


@pytest.mark.gpu
def test_onehot_gather_matches_plain_on_gpu():
    """W 8, 72 and 128 (two 64-column boxes, zero-filled past W), R
    3000 and 65,541 (no multiple of the 64-row tile), Q 1, 257 and 1000
    (ragged CTAs), bit for bit; then a table with inf and NaN, whose
    columns the full product poisons as the plain version's does."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    for W in (8, 72, 128):
        for R in (3000, 65541):
            tab = torch.randn((R, W), generator=g, device=dev).to(
                torch.bfloat16)
            for Q in (1, 257, 1000):
                idx = torch.randint(0, R, (Q,), generator=g, device=dev,
                                    dtype=torch.int32)
                got = gp.onehot_gather_mma(tab, idx)
                torch.cuda.synchronize()
                assert tool.same_bits(got, gp.onehot_gather_reference(
                    tab, idx)), (W, R, Q)
                assert tool.same_bits(got, tab.float()[idx.long()])
    tab = torch.randn((3000, 128), generator=g, device=dev).to(torch.bfloat16)
    idx = torch.randint(0, 3000, (1000,), generator=g, device=dev,
                        dtype=torch.int32)
    hit = int(idx[7])
    miss = next(r for r in range(3000) if r not in set(idx.tolist()))
    tab[hit, 0] = float('inf')
    tab[miss, 1] = float('nan')
    tab[3, 2], tab[2998, 2] = float('-inf'), float('inf')
    got = gp.onehot_gather_mma(tab, idx)
    want = gp.onehot_gather_reference(tab, idx)
    torch.cuda.synchronize()
    assert _nan_equal(got, want)
    sel = idx == hit
    assert torch.isposinf(got[sel, 0]).all()
    assert torch.isnan(got[~sel, 0]).all() and torch.isnan(got[:, 1:3]).all()


@pytest.mark.gpu
def test_block_copy_and_capacity_probe_on_gpu():
    """Static and permuted block copies match their plain version, also
    where the chunks do not divide a block; the capacity probe stages a row
    at 48 KB and 227 KB of shared memory, and one byte more is refused: the
    wrapper raises, and a launch after the refusal still works."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(2)
    tab = torch.randn((4096, 128), generator=g, device=dev)
    perm = torch.randperm(8, generator=g, device=dev).to(torch.int32)
    for pm in (None, perm):
        for smem in (64 * 1024, 48 * 1024 + 16 * 7):
            # the 256 KB blocks are not whole chunks
            assert (512 * 512) % gp.block_copy_plan(
                8, 512 * 512, smem)['chunk_bytes']
            got = gp.block_copy_tma(tab, 512, pm, smem_bytes=smem)
            torch.cuda.synchronize()
            assert tool.same_bits(got, gp.block_copy_reference(tab, 512, pm))
    odd = tab[:4095 - 4095 % 13]
    pm13 = torch.randperm(odd.shape[0] // 13, generator=g, device=dev).to(
        torch.int32)
    got = gp.block_copy_tma(odd, 13, pm13, smem_bytes=1024)
    torch.cuda.synchronize()
    assert tool.same_bits(got, gp.block_copy_reference(odd, 13, pm13))
    for smem in (48 * 1024, gp.SMEM_LIMIT):
        got = gp.block_copy_tma(tab[:1], 1, smem_bytes=smem)
        torch.cuda.synchronize()
        assert tool.same_bits(got, tab[:1])
    for _ in range(2):
        with pytest.raises(RuntimeError, match='CUDA error'):
            gp.block_copy_tma(tab[:1], 1, smem_bytes=gp.SMEM_LIMIT + 1)
        # the refusal leaves no error behind for the next launch
        assert tool.same_bits(gp.block_copy_tma(tab[:1], 1), tab[:1])
        assert tool.same_bits(
            gp.block_copy_tma(tab[:1], 1, smem_bytes=gp.SMEM_LIMIT), tab[:1])
