"""The corner table and its row/weight contract against the JAX package.

The JAX `pallas_tables.corner_table` dispatches to `_corner_table_xla` on
the CPU, which `tests/test_tables.py` pins byte-identical to the Pallas
kernel. The port's plain version must equal it exactly; the port takes a
channels-first (C, D, H, W) volume, the JAX package a channels-last one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampire_tpu.core import sampling as JS
from vampire_tpu.ops import pallas_tables as PT
from vampire_tpu_torch.core import sampling as S
from vampire_tpu_torch.ops import _build, tables


def _vol(shape, seed):
    """(C, D, H, W) float32 from numpy, with exact zeros and negative zeros
    among the values."""
    v = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    v.flat[::7] = 0.0
    v.flat[3::11] = -0.0
    return v


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', [(3, 5, 9, 7), (1, 1, 1, 1), (22, 2, 3, 4),
                                   (6, 4, 1, 10)])
def test_corner_table_matches_jax_exactly(shape, dtype):
    v = _vol(shape, seed=sum(shape))
    want = PT.corner_table(jnp.asarray(v.transpose(1, 2, 3, 0)).astype(dtype))
    tv = torch.from_numpy(v).to(getattr(torch, dtype))
    before = tables.LAUNCHES
    got = tables.corner_table(tv)
    assert tables.LAUNCHES == before    # CPU tensors run the plain version
    assert got.dtype == tv.dtype
    C, D, H, W = shape
    assert tuple(got.shape) == (D + 1, H + 1, W + 1, 8 * C)
    # compare the bits: NaN-free, but -0.0 must stay -0.0
    bits = got.view(torch.int16 if dtype == 'bfloat16' else torch.int32)
    want_bits = np.asarray(want).view(np.int16 if dtype == 'bfloat16'
                                      else np.int32)
    np.testing.assert_array_equal(bits.numpy(), want_bits)


def test_build_neighborhood_table_shape_contract():
    """((D+1)(H+1)(W+1), 2, 2, 2, C): row (bz, by, bx), corner (dz, dy, dx)
    holds pad(vol)[:, bz+dz, by+dy, bx+dx]; the same array as the JAX
    build_neighborhood_table of the channels-last volume."""
    C, D, H, W = 4, 3, 5, 6
    v = _vol((C, D, H, W), seed=1)
    t = S.build_neighborhood_table(torch.from_numpy(v))
    assert tuple(t.shape) == ((D + 1) * (H + 1) * (W + 1), 2, 2, 2, C)
    want = np.asarray(JS.build_neighborhood_table(
        jnp.asarray(v.transpose(1, 2, 3, 0))))
    np.testing.assert_array_equal(t.numpy(), want)
    p = np.pad(v, ((0, 0), (1, 1), (1, 1), (1, 1)))
    bz, by, bx = 2, 0, 6
    row = (bz * (H + 1) + by) * (W + 1) + bx
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                np.testing.assert_array_equal(
                    t[row, dz, dy, dx].numpy(),
                    p[:, bz + dz, by + dy, bx + dx])


def _coords(P, seed):
    """Coords inside, on and beyond the [-1, 1] borders on every axis."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(-1.4, 1.4, (P, 3)).astype(np.float32)
    edges = np.array([-1.0, 1.0, -1.25, 1.25, 0.0], np.float32)
    c[:40] = edges[rng.randint(0, len(edges), (40, 3))]
    return c


@pytest.mark.parametrize('border', [False, True])
@pytest.mark.parametrize('align_corners', [True, False])
def test_corner_rows_weights_match_jax(align_corners, border):
    c = _coords(500, seed=2)
    shape = (5, 6, 7)
    jr, jw = JS.corner_rows_weights(jnp.asarray(c), shape, align_corners,
                                    border)
    r, w = S.corner_rows_weights(torch.from_numpy(c), shape, align_corners,
                                 border)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    # every weight set sums to 1 inside the volume (border) or less (zeros)
    assert (w.sum(-1).numpy() <= 1.0 + 1e-6).all()


@pytest.mark.parametrize('padding_mode', ['border', 'zeros'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_grid_sample_3d_fused_matches_jax(padding_mode, dtype):
    """The table sampler against the JAX one on the same table values: fp32
    weights and sums on both sides, in another order: 1e-5."""
    v = _vol((6, 5, 8, 7), seed=3)
    c = _coords(400, seed=4).reshape(4, 100, 3)
    jv = jnp.asarray(v.transpose(1, 2, 3, 0)).astype(dtype)
    want = np.asarray(JS.grid_sample_3d_fused(
        jv, jnp.asarray(c), align_corners=True, padding_mode=padding_mode))
    tv = torch.from_numpy(v).to(getattr(torch, dtype))
    got = S.grid_sample_3d_fused(tv, torch.from_numpy(c), align_corners=True,
                                 padding_mode=padding_mode)
    assert got.shape == want.shape == (4, 100, 6)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # and a prebuilt table gives the same samples
    t = S.build_neighborhood_table(tv)
    again = S.grid_sample_3d_fused(tv, torch.from_numpy(c),
                                   padding_mode=padding_mode, table=t)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_grid_sample_3d_fused_is_grid_sample():
    """Through the table, the port samples what F.grid_sample samples."""
    v = _vol((3, 4, 5, 6), seed=5)
    c = _coords(300, seed=6)
    for mode in ('border', 'zeros'):
        got = S.grid_sample_3d_fused(torch.from_numpy(v),
                                     torch.from_numpy(c), padding_mode=mode)
        want = S.grid_sample_3d(torch.from_numpy(v)[None],
                                torch.from_numpy(c)[None], True, mode)[0]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize('bad,err', [
    (lambda v: v.to(torch.float64), TypeError),
    (lambda v: v[0], ValueError),
    (lambda v: v.transpose(1, 2), ValueError),
])
def test_kernel_argument_checks(bad, err):
    """The checks the wrapper makes before any launch."""
    with pytest.raises(err):
        tables._check(bad(torch.zeros(3, 4, 5, 6)))


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(22, 3, 5, 7), (5, 2, 4, 9), (7, 1, 1, 1),
                                   (22, 2, 3, 16)])
def test_corner_table_library_matches_plain(shape, dtype):
    """The yardstick (a pad and one strided copy) is the plain table bit for
    bit, -0.0 included, at an even and an odd C."""
    tv = torch.from_numpy(_vol(shape, seed=sum(shape))).to(dtype)
    got = tables.corner_table_library(tv)
    want = S.corner_table_reference(tv)
    assert got.shape == want.shape and got.dtype == dtype
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize('shape', [(22, 3, 5, 7), (5, 2, 4, 9)])
def test_onehot_conv3d_is_the_table(shape):
    """`onehot_corner_weight` makes F.conv3d the table channels-first: each
    output is 1 x one value plus zeros, exact in fp32."""
    tv = torch.from_numpy(_vol(shape, seed=3))
    w = tables.onehot_corner_weight(shape[0], torch.float32)
    got = torch.nn.functional.conv3d(tv[None], w, padding=1)[0]
    assert torch.equal(got.permute(1, 2, 3, 0),
                       S.corner_table_reference(tv))


# shapes for the launch plan: the flagship, the gpu test's, D = 1, H = 1,
# W + 1 a multiple of no tile, odd C, rows cut into segments
PLAN_SHAPES = [(22, 20, 256, 256), (8, 5, 8, 8), (22, 2, 4, 256),
               (22, 3, 17, 33),
               (5, 1, 1, 70), (22, 2, 2, 300), (1, 1, 1, 1), (6, 1, 3, 16),
               (33, 2, 2, 8), (3, 4, 1, 1000), (22, 2, 3, 2000),
               (64, 1, 2, 129), (250, 1, 2, 61), (22, 1, 2, 1400)]


def _replay(plan, C, D, H, W):
    """The kernel's walk (csrc/corner_table.cu corner_table_kernel), as
    counts: items handed to CTAs, and for each segment length the 16-byte
    chunks of its positions the threads store."""
    items, ctas = plan['items'], plan['ctas']
    starts = [i * items // ctas for i in range(ctas + 1)]
    item_hits = np.zeros(items, np.int64)
    for i in range(ctas):
        item_hits[starts[i]:starts[i + 1]] += 1
    seg, nt = plan['seg'], plan['threads']
    cp, pps = plan['chunks_per_position'], plan['positions_per_step']
    chunk_hits = {}
    for sg in range(plan['segments']):
        npos = min(seg, W + 1 - sg * seg)
        if npos in chunk_hits:
            continue
        hits = np.zeros(npos * cp, np.int64)
        tid = np.arange(nt)
        for k in range(-(-npos // pps)):
            pos = tid // cp + k * pps
            ok = pos < npos
            np.add.at(hits, (pos * cp + tid % cp)[ok], 1)
        chunk_hits[npos] = hits
    return item_hits, chunk_hits, starts


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', PLAN_SHAPES)
def test_table_plan_covers_every_row_once(shape, dtype):
    """Every work item (row or row segment) goes to exactly one CTA, every
    CTA walks at most rows_per_cta of them, the segments tile each row's
    W + 1 positions, and the threads store every 16-byte chunk of a work
    item's positions exactly once."""
    C, D, H, W = shape
    plan = tables.table_plan(*shape, dtype)
    assert plan['items'] == (D + 1) * (H + 1) * plan['segments']
    assert plan['segments'] == -(-(W + 1) // plan['seg'])
    assert plan['threads'] % plan['chunks_per_position'] == 0
    assert plan['threads'] <= 1024
    item_hits, chunk_hits, starts = _replay(plan, *shape)
    assert (item_hits == 1).all()
    assert max(np.diff(starts)) == 1          # a CTA an item
    assert sum(chunk_hits) == W + 1 or plan['segments'] > 1
    for npos, hits in chunk_hits.items():
        assert (hits == 1).all(), npos
    # the chunks of a position are its 8C values
    elem = 2 if dtype == torch.bfloat16 else 4
    assert plan['chunks_per_position'] * 16 == 8 * C * elem


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', PLAN_SHAPES + [(256, 1, 1, 256),
                                                 (512, 2, 2, 600)])
def test_table_plan_fits_shared_memory(shape, dtype):
    """A launch's shared memory stays within the 232,448 bytes a block may
    take and holds the 4C staged runs of seg + 1 values (2 z planes x 2 y
    planes x C channels); rows are cut into segments only where a whole
    row would exceed the 48 KB a CTA aims at (four CTAs an SM), and then
    into the longest that stay within it."""
    C, D, H, W = shape
    elem = 2 if dtype == torch.bfloat16 else 4
    if C * elem // 2 > 512:
        with pytest.raises(ValueError):
            tables.table_plan(*shape, dtype)
        return
    plan = tables.table_plan(*shape, dtype)
    seg = plan['seg']
    assert plan['smem_bytes'] <= _build.SMEM_LIMIT
    assert plan['smem_bytes'] == tables.table_smem(C, elem, seg)
    assert plan['smem_bytes'] >= 4 * C * (seg + 1) * elem
    assert plan['ctas'] == plan['items']
    target = max(tables.TABLE_SMEM_TARGET, tables.table_smem(C, elem, 1))
    assert plan['smem_bytes'] <= target
    if plan['segments'] > 1:        # a longer segment would not fit
        assert tables.table_smem(C, elem, seg + 1) > target
    else:
        assert seg == W + 1


@pytest.mark.parametrize('shape,dtype,route', [
    ((22, 20, 256, 256), torch.bfloat16, 'vec16'),
    ((22, 20, 256, 256), torch.float32, 'vec16'),
    ((22, 2, 4, 256), torch.bfloat16, 'vec16'),
    ((6, 1, 3, 16), torch.bfloat16, 'vec16'),
    ((22, 2, 2, 300), torch.float32, 'vec16'),
    ((22, 3, 17, 33), torch.bfloat16, 'scalar'),
    ((22, 3, 17, 33), torch.float32, 'scalar'),
    ((22, 2, 2, 300), torch.bfloat16, 'scalar'),
    ((5, 1, 1, 70), torch.bfloat16, 'scalar'),
    ((300, 2, 2, 64), torch.bfloat16, 'vec16'),
])
def test_table_plan_route(shape, dtype, route):
    """The CTA stages with 16-byte loads where every row of the field starts
    on 16 bytes (W x size a multiple of 16), else a value a lane: bf16
    W = 33 and 300 and fp32 W = 33 take the scalar route. The flagship
    shape takes the 16-byte route in both dtypes."""
    assert tables.table_plan(*shape, dtype)['route'] == route


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(22, 20, 256, 256), (8, 5, 8, 8),
                                   (22, 3, 17, 33)])
def test_table_plan_route_of_a_field_off_16_bytes(shape, dtype):
    """A field that does not start on 16 bytes (a contiguous view at an
    offset) is staged a value a lane at every width; `card_plan` keys its
    plans by that alignment, and the rest of the launch stays the same."""
    plan = tables.table_plan(*shape, dtype, aligned=False)
    assert plan['route'] == 'scalar'
    assert dict(plan, route=None) == dict(tables.table_plan(*shape, dtype),
                                          route=None)
    C, D, H, W = shape
    base = torch.zeros(8 + C * D * H * W, dtype=dtype)
    at = next(i for i in range(8) if base[i:].data_ptr() % 16 == 0)
    on = base[at:at + C * D * H * W].view(shape)
    off = base[at + 1:at + 1 + C * D * H * W].view(shape)
    assert tables.card_plan(off)['route'] == 'scalar'
    assert tables.card_plan(on)['route'] == \
        tables.table_plan(*shape, dtype)['route']


def test_corner_table_of_an_offset_view():
    """On the CPU the wrapper takes a contiguous view at any offset (the
    plain version); the card's kernel stages it a value a lane."""
    v = torch.from_numpy(_vol((5, 2, 3, 9), seed=8).ravel())
    for dt in (torch.float32, torch.bfloat16):
        vol = torch.cat([v[:1], v]).to(dt)[1:].view(5, 2, 3, 9)
        assert torch.equal(_bits(tables.corner_table(vol)),
                           _bits(S.corner_table_reference(
                               v.to(dt).view(5, 2, 3, 9))))


def test_table_plan_flagship():
    """At (22, 20, 256, 256): 352 threads (11 warps, 16 positions a step in
    bf16, 8 in fp32). bf16: whole rows, a CTA a row (5,397), 4 x 22 runs
    of 258 values, 45 KB (five CTAs an SM). fp32: whole rows would take
    91 KB (two an SM), so rows go in two segments of 138 positions, 48 KB
    a CTA (four an SM)."""
    bf = tables.table_plan(22, 20, 256, 256, torch.bfloat16)
    f32 = tables.table_plan(22, 20, 256, 256, torch.float32)
    assert (bf['threads'], bf['positions_per_step'], bf['seg'],
            bf['segments'], bf['ctas'], bf['smem_bytes']) == \
        (352, 16, 257, 1, 5397, 45408)
    assert (f32['threads'], f32['positions_per_step'], f32['seg'],
            f32['segments'], f32['ctas'], f32['smem_bytes']) == \
        (352, 8, 138, 2, 10794, 48928)
