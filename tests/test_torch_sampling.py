"""Port samplers vs the JAX package on the same numpy inputs (fp32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampire_tpu.core import sampling as JS
from vampire_tpu_torch.core import sampling as S


def _lift_inputs(seed=0, D=9, H=8, W=12, C=5, P=700):
    rng = np.random.RandomState(seed)
    depth = rng.rand(D, H, W).astype(np.float32)
    feat = rng.randn(H, W, C).astype(np.float32)
    # coords beyond [-1, 1] on every axis exercise the zeros padding
    coords = rng.uniform(-1.3, 1.3, (P, 3)).astype(np.float32)
    return depth, feat, coords


@pytest.mark.parametrize('align_corners', [False, True])
def test_sample_outer_product_matches_jax(align_corners):
    """Same weights, same summation order as the JAX sampler: 1e-6."""
    depth, feat, coords = _lift_inputs()
    want = np.asarray(JS.sample_outer_product(
        jnp.asarray(depth), jnp.asarray(feat), jnp.asarray(coords),
        align_corners=align_corners))
    got = S.sample_outer_product(torch.from_numpy(depth),
                                 torch.from_numpy(feat),
                                 torch.from_numpy(coords),
                                 align_corners=align_corners).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_sample_outer_product_matches_fused_table_sampler():
    """The JAX serving lift samples through the fused table
    (`sample_outer_product_fused` -> `lift_table`), the path the CUDA kernel
    replaces; it reassociates the weights (~1e-7), so 1e-5."""
    depth, feat, coords = _lift_inputs(seed=1)
    want = np.asarray(JS.sample_outer_product_fused(
        jnp.asarray(depth), jnp.asarray(feat), jnp.asarray(coords),
        align_corners=False, chunk=256))
    got = S.sample_outer_product(torch.from_numpy(depth),
                                 torch.from_numpy(feat),
                                 torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('padding_mode', ['border', 'zeros'])
@pytest.mark.parametrize('align_corners', [True, False])
def test_grid_sample_3d_matches_jax(padding_mode, align_corners):
    """F.grid_sample vs the JAX gather sampler on a bf16-rounded volume, as
    the point queries run it: same bf16 values, fp32 weights and sums on
    both sides, differing only in summation order: 1e-5."""
    rng = np.random.RandomState(2)
    vol = rng.randn(2, 5, 6, 7, 4).astype(np.float32)       # (B, D, H, W, C)
    coords = rng.uniform(-1.2, 1.2, (2, 300, 3)).astype(np.float32)
    want = np.asarray(JS.batched_grid_sample_3d(
        jnp.asarray(vol).astype(jnp.bfloat16), jnp.asarray(coords),
        align_corners=align_corners, padding_mode=padding_mode))
    tvol = torch.from_numpy(vol).permute(0, 4, 1, 2, 3)
    tvol = tvol.to(torch.bfloat16).to(torch.float32)
    got = S.grid_sample_3d(tvol, torch.from_numpy(coords),
                           align_corners=align_corners,
                           padding_mode=padding_mode).numpy()
    assert got.shape == want.shape == (2, 300, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('padding_mode', ['border', 'zeros'])
def test_sample_matrices_match_jax(padding_mode):
    rng = np.random.RandomState(3)
    c = {ax: rng.uniform(-1.1, 1.1, n).astype(np.float32)
         for ax, n in (('z', 4), ('y', 9), ('x', 7))}
    sizes = dict(z=5, y=8, x=6)
    mats = [S.make_sample_matrix(c[a], sizes[a], True, padding_mode)
            for a in 'zyx']
    for a, m in zip('zyx', mats):
        np.testing.assert_array_equal(
            m, JS.make_sample_matrix(c[a], sizes[a], True, padding_mode))
    vol = rng.randn(2, 5, 8, 6, 3).astype(np.float32)       # (B, Z, Y, X, C)
    want = np.asarray(JS.apply_sample_matrices(jnp.asarray(vol), mats,
                                               (1, 2, 3)))
    got = S.apply_sample_matrices(
        torch.from_numpy(vol).permute(0, 4, 1, 2, 3),
        [torch.from_numpy(m) for m in mats], (2, 3, 4))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('out_sizes', [(7, 11), (3, 4), (5, 5)])
def test_resize_linear_matches_jax(out_sizes):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 6, 3).astype(np.float32)
    want = np.asarray(JS.resize_linear(jnp.asarray(x), out_sizes, (1, 2)))
    got = S.resize_linear(torch.from_numpy(x), out_sizes, (1, 2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(S._interp_matrix(6, out_sizes[1]),
                                  JS._interp_matrix(6, out_sizes[1]))


def test_resize_linear_is_torch_interpolate():
    """align_corners=True trilinear semantics of F.interpolate."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(1, 3, 4, 6, 5).astype(np.float32))
    got = S.resize_linear(x, (7, 12, 9), (2, 3, 4))
    want = torch.nn.functional.interpolate(x, size=(7, 12, 9),
                                           mode='trilinear',
                                           align_corners=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
