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
from vampire_tpu_torch.ops import tables


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
