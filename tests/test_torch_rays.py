"""The camera-ray sampler: the port's plain version against the JAX
`sample_and_composite_rays` and against the unfused oracle, and (on a card
only) both kernels of the camera-ray branch against their plain versions.

JAX is imported inside the parity tests only, so that the card-only cases
run where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_rays.py
"""
import functools

import numpy as np
import pytest
import torch

from vampire_tpu_torch.core import rendering as R
from vampire_tpu_torch.core import sampling as S
from vampire_tpu_torch.ops import rays, tables

VOL = (5, 8, 8)            # (D, H, W)
K = 4
BETA, BIAS, BG = 0.1, -1.0, 70.4


def _case(seed=0, n_rays=60, n_samp=9):
    """A fused (C, D, H, W) field and rays whose samples fall inside, on and
    beyond the field's borders; the sdf is spread so that the rays end
    anywhere from transparent to opaque."""
    rng = np.random.RandomState(seed)
    C = 1 + K + 3
    vol = rng.randn(C, *VOL).astype(np.float32)
    vol[0] = rng.uniform(-1.2, 0.2, VOL)           # around sdf_bias
    coords = rng.uniform(-1.3, 1.3, (n_rays, n_samp, 3)).astype(np.float32)
    coords[:5, :3] = [-1.0, 1.0, 0.0]
    valid = (np.abs(coords) <= 1.0).all(-1).astype(np.float32)
    deltas = rng.uniform(0.05, 0.6, (n_rays, n_samp)).astype(np.float32)
    mids = np.linspace(2.4, 69.6, n_samp).astype(np.float32)
    return vol, coords, valid, deltas, mids


@pytest.mark.parametrize('table_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('mode', ['sdf', 'naive'])
def test_reference_matches_jax(mode, table_dtype):
    """The plain sampler against the JAX dense sampler on the same table
    values, at the JAX package's own tolerances (tests/test_rendering.py):
    1e-5 for rgb/seg, 1e-4 for depth."""
    jax = pytest.importorskip('jax')
    import jax.numpy as jnp
    from vampire_tpu.core import rendering as JR
    from vampire_tpu.core import sampling as JS
    vol, coords, valid, deltas, mids = _case(seed=1)
    jvol = jnp.asarray(vol.transpose(1, 2, 3, 0)).astype(table_dtype)
    if mode == 'sdf':
        dens = functools.partial(JR.laplace_density, beta=jnp.float32(BETA),
                                 bias=BIAS)
    else:
        dens = JR.naive_density
    jr, js, jd = jax.device_get(JR.sample_and_composite_rays(
        JS.build_neighborhood_table(jvol), VOL, K, jnp.asarray(coords),
        jnp.asarray(valid), jnp.asarray(deltas), jnp.asarray(mids), dens, BG,
        chunk_rays=16))
    before = rays.LAUNCHES
    table = S.build_neighborhood_table(
        torch.from_numpy(vol).to(getattr(torch, table_dtype)))
    got = rays.sample_and_composite_rays(
        table, VOL, torch.from_numpy(coords), torch.from_numpy(valid),
        torch.from_numpy(deltas), torch.from_numpy(mids), BG, mode,
        torch.tensor(BETA), BIAS)
    assert rays.LAUNCHES == before      # CPU tensors run the plain version
    assert got.shape == (len(coords), 3 + K + 1)
    np.testing.assert_allclose(got[:, :3].numpy(), jr, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[:, 3:K + 3].numpy(), js, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[:, K + 3].numpy(), jd, rtol=1e-4,
                               atol=1e-4)


def test_reference_spans_partial_opacity():
    """The case above is not degenerate: some rays stay nearly transparent,
    some saturate, and many end in between."""
    vol, coords, valid, deltas, mids = _case(seed=1)
    t = torch.from_numpy
    sdf = S.grid_sample_3d_fused(t(vol), t(coords))[..., 0] * t(valid)
    sd = R.laplace_density(sdf, torch.tensor(BETA), BIAS) * t(deltas)
    opacity = 1.0 - torch.exp(-sd.sum(-1))
    assert (opacity < 0.05).any() and (opacity > 0.95).any()
    assert ((opacity > 0.05) & (opacity < 0.95)).float().mean() > 0.2


@pytest.mark.parametrize('mode', ['sdf', 'naive'])
def test_reference_matches_unfused_oracle(mode):
    """Sampling whole rays through the table equals `grid_sample_3d_fused`
    times the mask followed by `render_camera_rays` (same table dtype,
    fp32 sums in another order): 1e-5, depth 1e-4."""
    rng = np.random.RandomState(2)
    vol = rng.randn(1 + K + 3, *VOL).astype(np.float32)
    B, N, Sn, h, w = 1, 2, 7, 3, 4
    geom = np.sort(rng.uniform(-3.0, 3.0, (B, N, Sn + 1, h, w, 3))
                   .astype(np.float32), axis=2)
    g = torch.from_numpy(geom)
    norm = g[:, :, :-1] / 2.5
    valid = ((norm >= -1) & (norm <= 1)).all(-1).to(torch.float32)
    delta = torch.linalg.norm(g[:, :, 1:] - g[:, :, :-1], dim=-1)
    mids = torch.linspace(2.0, 70.4, Sn)
    dens_fn = functools.partial(R.density, mode=mode,
                                beta=torch.tensor(BETA), bias=BIAS)
    tv = torch.from_numpy(vol)
    samp = S.grid_sample_3d_fused(tv, norm) * valid[..., None]
    want = R.render_camera_rays(samp[..., 0], samp[..., 1:K + 1],
                                samp[..., K + 1:], g, mids, dens_fn, BG)

    def ray_major(x, tail):
        return torch.movedim(x, 2, 4).reshape((N * h * w, Sn) + tail)
    got = R.sample_and_composite_rays_reference(
        S.build_neighborhood_table(tv), VOL, ray_major(norm, (3,)),
        ray_major(valid, ()), ray_major(delta, ()), mids, BG, mode,
        torch.tensor(BETA), BIAS, chunk_rays=5)
    got = got.reshape(B, N, h, w, -1)
    np.testing.assert_allclose(got[..., :3].numpy(), want[0].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[..., 3:K + 3].numpy(), want[1].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[..., K + 3].numpy(), want[2].numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_sampler_reads_both_table_layouts(dtype):
    """The (D+1, H+1, W+1, 8C) table of `ops.tables.corner_table` (what the
    model passes) and the ((D+1)(H+1)(W+1), 2, 2, 2, C) rows of
    `build_neighborhood_table` hold the same bytes and render the same."""
    vol, coords, valid, deltas, mids = _case(seed=5)
    tv = torch.from_numpy(vol).to(dtype)
    args = [torch.from_numpy(a) for a in (coords, valid, deltas, mids)]
    outs = [rays.sample_and_composite_rays(t, VOL, *args, BG, 'sdf',
                                           torch.tensor(BETA), BIAS)
            for t in (tables.corner_table(tv),
                      S.build_neighborhood_table(tv))]
    assert torch.equal(outs[0], outs[1])


def test_render_camera_rays_matches_jax():
    """The unfused oracle against the JAX one: fp32 cumulative sums over 6
    samples: 1e-5."""
    jax = pytest.importorskip('jax')
    import jax.numpy as jnp
    from vampire_tpu.core import rendering as JR
    rng = np.random.RandomState(3)
    B, N, Sn, h, w = 2, 3, 6, 2, 5
    sdf = rng.randn(B, N, Sn, h, w).astype(np.float32)
    seg = rng.randn(B, N, Sn, h, w, K).astype(np.float32)
    rgb = rng.rand(B, N, Sn, h, w, 3).astype(np.float32)
    geom = np.sort(rng.uniform(-5, 5, (B, N, Sn + 1, h, w, 3))
                   .astype(np.float32), axis=2)
    mids = np.linspace(3.0, 20.0, Sn).astype(np.float32)
    want = jax.device_get(JR.render_camera_rays(
        *(jnp.asarray(a) for a in (sdf, seg, rgb, geom, mids)),
        lambda x: JR.laplace_density(x, jnp.float32(BETA), BIAS), BG))
    got = R.render_camera_rays(
        *(torch.from_numpy(a) for a in (sdf, seg, rgb, geom, mids)),
        lambda x: R.laplace_density(x, torch.tensor(BETA), BIAS), BG)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        np.testing.assert_allclose(g.numpy(), w_, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('field,bad,err', [
    ('coords', lambda t: t[..., :2].contiguous(), ValueError),
    ('valid', lambda t: t.to(torch.float64), TypeError),
    ('deltas', lambda t: t.t(), ValueError),
    ('mids', lambda t: t[:-1], ValueError),
])
def test_kernel_argument_checks(field, bad, err):
    """The checks the wrapper makes before any launch."""
    vol, coords, valid, deltas, mids = _case(n_rays=8, n_samp=8)
    t = dict(coords=torch.from_numpy(coords), valid=torch.from_numpy(valid),
             deltas=torch.from_numpy(deltas), mids=torch.from_numpy(mids),
             beta=torch.tensor(BETA))
    t[field] = bad(t[field])
    flat = S.build_neighborhood_table(torch.from_numpy(vol)).reshape(-1, 64)
    with pytest.raises(err):
        rays._check(flat, VOL, **t)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_gpu(dtype):
    """On the card: the corner-table kernel is byte-identical to its plain
    version, and the ray kernel agrees with its plain version to
    1e-4 * max(1, max |ref|) per output (fp32 sums in another order; the
    plain transmittance is a parallel cumsum). Each launches once."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    for shape in ((8, 5, 8, 8), (22, 3, 17, 33), (5, 1, 1, 70)):
        vol = torch.randn(shape, generator=torch.Generator().manual_seed(0))
        vol = vol.to(dtype).cuda()
        before = tables.LAUNCHES
        got = tables.corner_table(vol)
        assert tables.LAUNCHES == before + 1
        assert torch.equal(got, S.corner_table_reference(vol))
    for mode in ('sdf', 'naive'):
        vol, coords, valid, deltas, mids = _case(seed=4, n_rays=1000,
                                                 n_samp=85)
        tv = torch.from_numpy(vol).to(dtype).cuda()
        table = tables.corner_table(tv)         # the model's table layout
        args = [torch.from_numpy(a).cuda() for a in
                (coords, valid, deltas, mids)]
        beta = torch.tensor(BETA, device='cuda')
        before = rays.LAUNCHES
        got = rays.sample_and_composite_rays(table, VOL, *args, BG, mode,
                                             beta, BIAS)
        assert rays.LAUNCHES == before + 1
        ref = R.sample_and_composite_rays_reference(table, VOL, *args, BG,
                                                    mode, beta, BIAS)
        torch.cuda.synchronize()
        for sl in (slice(0, 3), slice(3, K + 3), slice(K + 3, K + 4)):
            tol = 1e-4 * max(1.0, ref[:, sl].abs().max().item())
            err = (got[:, sl] - ref[:, sl]).abs().max().item()
            assert err <= tol, (mode, sl, err, tol)
