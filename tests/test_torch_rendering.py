"""Port BEV rendering vs the JAX package (fp32 on both sides)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampire_tpu.core import rendering as JR
from vampire_tpu_torch.core import rendering as R


@pytest.mark.parametrize('beta', [0.1, -0.3])
def test_laplace_density_matches_jax(beta):
    """Elementwise fp32 with expm1: 1e-6 relative."""
    sdf = np.random.RandomState(0).randn(4, 5, 6).astype(np.float32) * 3
    want = np.asarray(JR.laplace_density(jnp.asarray(sdf), jnp.float32(beta),
                                         -1.0))
    got = R.laplace_density(torch.from_numpy(sdf), torch.tensor(beta), -1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_naive_density_matches_jax():
    x = np.random.RandomState(1).randn(3, 7).astype(np.float32) * 4
    np.testing.assert_allclose(
        R.naive_density(torch.from_numpy(x)).numpy(),
        np.asarray(JR.naive_density(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


def test_transmittance_and_composite_match_jax():
    rng = np.random.RandomState(2)
    dens = rng.uniform(0, 3, (2, 9, 4)).astype(np.float32)
    delta = rng.uniform(0.1, 0.5, (2, 9, 4)).astype(np.float32)
    vals = rng.randn(2, 9, 4).astype(np.float32)
    jw, jacc = JR.transmittance_weights(jnp.asarray(dens),
                                        jnp.asarray(delta), axis=1)
    w, acc = R.transmittance_weights(torch.from_numpy(dens),
                                     torch.from_numpy(delta), axis=1)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        R.composite(w, torch.from_numpy(vals), axis=1).numpy(),
        np.asarray(JR.composite(jw, jnp.asarray(vals), axis=1)),
        rtol=1e-5, atol=1e-6)


def test_render_bev_columns_matches_jax():
    """Cumulative sums along 10 samples in fp32: 1e-5."""
    rng = np.random.RandomState(3)
    B, S, Y, X, K = 2, 10, 6, 5, 4
    dens = rng.uniform(0, 5, (B, S, Y, X)).astype(np.float32)
    seg = rng.randn(B, S, Y, X, K).astype(np.float32)
    rgb = rng.rand(B, S, Y, X, 3).astype(np.float32)
    mids = np.linspace(2.8, -0.8, S).astype(np.float32)
    want = JR.render_bev_columns(jnp.asarray(dens), jnp.asarray(seg),
                                 jnp.asarray(rgb), jnp.asarray(mids), 0.4)
    got = R.render_bev_columns(torch.from_numpy(dens), torch.from_numpy(seg),
                               torch.from_numpy(rgb), torch.from_numpy(mids),
                               0.4)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
