"""`ops.msssim` against the JAX package's `ms_ssim`: values and gradients
with respect to both images, at the smallest sizes that carry 5 scales of
an 11-pixel window (176 pixels a side), on the CPU in fp32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampire_tpu.ops import msssim as jms
from vampire_tpu_torch.ops import msssim as tms

# fp32 blurs and means summed in other orders: values at 1e-5 relative, as
# the losses' tests hold the other terms. The gradients go through the
# variances, differences of blurred squares that cancel most of their
# digits: both packages' fp32 gradients lie 1.8e-5 and 2.5e-5 (L2, relative)
# from the same function evaluated in float64 (192 x 192), so they are held
# at 1e-4 of each gradient's largest magnitude.
RTOL = 1e-5
GRAD_TOL = 1e-4


def _pair(shape, seed, negative_cs=False):
    """Smooth-ish images in [0, 1] and a noisy copy. `negative_cs`: the
    target is the prediction inverted, so that the contrast-structure term
    is negative at some scale and relu clamps it."""
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape).astype(np.float32)
    x = 0.5 * x + 0.5 * np.roll(x, 1, axis=1)
    if negative_cs:
        y = 1.0 - x
    else:
        y = np.clip(x + 0.1 * rng.randn(*shape), 0, 1).astype(np.float32)
    return x, y


def _jax(x, y):
    v, (gx, gy) = jax.value_and_grad(jms.ms_ssim, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    return float(v), np.asarray(gx), np.asarray(gy)


def _port(x, y):
    tx = torch.from_numpy(x).requires_grad_()
    ty = torch.from_numpy(y).requires_grad_()
    v = tms.ms_ssim(tx, ty)
    v.backward()
    return v.item(), tx.grad.numpy(), ty.grad.numpy()


@pytest.mark.parametrize('shape', [(2, 192, 192, 3), (6, 176, 192, 3)],
                         ids=['192x192', '176x192'])
def test_ms_ssim_matches_jax(shape):
    """Values at 1e-5 relative, d pred and d target at GRAD_TOL of each
    gradient's largest magnitude; 176 rows leave the last scale exactly one
    window, and 192 columns pool through an even size each time."""
    x, y = _pair(shape, 0)
    want, wgx, wgy = _jax(x, y)
    got, ggx, ggy = _port(x, y)
    assert 0.0 < want < 1.0
    np.testing.assert_allclose(got, want, rtol=RTOL)
    for g, w in ((ggx, wgx), (ggy, wgy)):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(w).max())


def test_ms_ssim_odd_sizes_match_jax():
    """Odd sizes between scales: the 2x pool drops the trailing row or
    column on both sides (177 x 181)."""
    x, y = _pair((1, 177, 181, 3), 1)
    want, wgx, wgy = _jax(x, y)
    got, ggx, ggy = _port(x, y)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(ggx, wgx, rtol=GRAD_TOL,
                               atol=GRAD_TOL * np.abs(wgx).max())


def test_ms_ssim_clamped_terms_have_zero_gradients():
    """Where relu clamps a negative contrast-structure mean, the product is
    0 and both packages give gradients of exactly 0, not NaN."""
    x, y = _pair((2, 192, 192, 3), 2, negative_cs=True)
    xs = torch.from_numpy(x).permute(0, 3, 1, 2)
    ys = torch.from_numpy(y).permute(0, 3, 1, 2)
    k = torch.from_numpy(tms._gaussian_kernel())
    _, cs = tms._ssim_mcs(xs, ys, k, 1.0, 0.01, 0.03)
    assert (cs < 0).all()              # the first scale's cs is clamped
    want, wgx, wgy = _jax(x, y)
    got, ggx, ggy = _port(x, y)
    assert got == want == 0.0
    for g in (wgx, wgy, ggx, ggy):
        assert not np.isnan(g).any()
        assert (g == 0).all()


def test_ms_ssim_per_image_and_size_check():
    """`ms_ssim` is the mean of `ms_ssim_per_image`, each image's value
    that of the image alone; an image under 176 pixels a side raises
    (the JAX function returns NaN there)."""
    x, y = _pair((3, 176, 180, 3), 3)
    per = tms.ms_ssim_per_image(torch.from_numpy(x), torch.from_numpy(y))
    for b in range(3):
        torch.testing.assert_close(
            per[b], tms.ms_ssim(torch.from_numpy(x[b:b + 1]),
                                torch.from_numpy(y[b:b + 1])),
            rtol=1e-6, atol=0)
    torch.testing.assert_close(tms.ms_ssim(torch.from_numpy(x),
                                           torch.from_numpy(y)), per.mean())
    small = torch.rand(1, 175, 200, 3)
    assert np.isnan(float(jms.ms_ssim(jnp.asarray(small.numpy()),
                                      jnp.asarray(small.numpy()))))
    with pytest.raises(ValueError, match='at least 176 pixels'):
        tms.ms_ssim(small, small)
