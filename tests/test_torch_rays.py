"""The camera-ray sampler: the port's plain versions (on the corner table,
as the JAX package samples, and on the channels-last field, as the port's
op samples) against the JAX `sample_and_composite_rays`, against each other
and against the unfused oracle, and (on a card only) the ray kernel and the
corner-table kernel against their plain versions.

JAX is imported inside the parity tests only, so that the card-only cases
run where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_rays.py
"""
import functools
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vampire_tpu_torch.core import rendering as R
from vampire_tpu_torch.core import sampling as S
from vampire_tpu_torch.ops import rays, tables

VOL = (5, 8, 8)            # (D, H, W)
K = 4
BETA, BIAS, BG = 0.1, -1.0, 70.4


def _case(seed=0, n_rays=60, n_samp=9, n_classes=K):
    """A fused (C, D, H, W) field of `n_classes` seg channels and rays whose
    samples fall inside, on and beyond the field's borders; the sdf is
    spread so that the rays end anywhere from transparent to opaque."""
    rng = np.random.RandomState(seed)
    C = 1 + n_classes + 3
    vol = rng.randn(C, *VOL).astype(np.float32)
    vol[0] = rng.uniform(-1.2, 0.2, VOL)           # around sdf_bias
    coords = rng.uniform(-1.3, 1.3, (n_rays, n_samp, 3)).astype(np.float32)
    coords[:5, :3] = [-1.0, 1.0, 0.0]
    valid = (np.abs(coords) <= 1.0).all(-1).astype(np.float32)
    deltas = rng.uniform(0.05, 0.6, (n_rays, n_samp)).astype(np.float32)
    mids = np.linspace(2.4, 69.6, n_samp).astype(np.float32)
    return vol, coords, valid, deltas, mids


def _jax_render(vol, coords, valid, deltas, mids, mode, dtype):
    """The JAX dense sampler on `build_neighborhood_table` of the field in
    `dtype`: (rgb, seg, depth) numpy; the field's seg channels are C - 4."""
    jax = pytest.importorskip('jax')
    import jax.numpy as jnp
    from vampire_tpu.core import rendering as JR
    from vampire_tpu.core import sampling as JS
    jvol = jnp.asarray(vol.transpose(1, 2, 3, 0)).astype(dtype)
    if mode == 'sdf':
        dens = functools.partial(JR.laplace_density, beta=jnp.float32(BETA),
                                 bias=BIAS)
    else:
        dens = JR.naive_density
    return jax.device_get(JR.sample_and_composite_rays(
        JS.build_neighborhood_table(jvol), VOL, vol.shape[0] - 4,
        jnp.asarray(coords),
        jnp.asarray(valid), jnp.asarray(deltas), jnp.asarray(mids), dens, BG,
        chunk_rays=16))


def _assert_render_close(got, want):
    """The JAX package's own tolerances (tests/test_rendering.py): 1e-5 for
    rgb/seg, 1e-4 for depth."""
    jr, js, jd = want
    K = js.shape[1]
    assert got.shape == (len(jr), 3 + K + 1)
    np.testing.assert_allclose(got[:, :3].numpy(), jr, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[:, 3:K + 3].numpy(), js, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[:, K + 3].numpy(), jd, rtol=1e-4,
                               atol=1e-4)


def _torch_args(coords, valid, deltas, mids):
    return [torch.from_numpy(a) for a in (coords, valid, deltas, mids)]


def _padded(vol, extra):
    """The channels-last field of a (C, D, H, W) volume as the channel slice
    of a copy with `extra` zero channels a voxel."""
    C = vol.shape[0]
    return F.pad(vol.permute(1, 2, 3, 0).contiguous(), (0, extra))[..., :C]


@pytest.mark.parametrize('table_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('mode', ['sdf', 'naive'])
def test_reference_matches_jax(mode, table_dtype):
    """The port's ray op on a CPU tensor (the field's plain version, on the
    channels-last field in `table_dtype`) against the JAX dense sampler on
    the corner table of the same field."""
    vol, coords, valid, deltas, mids = _case(seed=1)
    want = _jax_render(vol, coords, valid, deltas, mids, mode, table_dtype)
    before = rays.LAUNCHES
    field = rays.channels_last_field(
        torch.from_numpy(vol).to(getattr(torch, table_dtype)))
    got = rays.sample_and_composite_rays(
        field, *_torch_args(coords, valid, deltas, mids), BG, mode,
        torch.tensor(BETA), BIAS)
    assert rays.LAUNCHES == before      # CPU tensors run the plain version
    _assert_render_close(got, want)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('mode', ['sdf', 'naive'])
def test_table_reference_matches_jax(mode, dtype):
    """The table's plain sampler (the JAX package's access pattern) against
    the JAX dense sampler on the same table values."""
    vol, coords, valid, deltas, mids = _case(seed=1)
    want = _jax_render(vol, coords, valid, deltas, mids, mode, dtype)
    table = S.build_neighborhood_table(
        torch.from_numpy(vol).to(getattr(torch, dtype)))
    got = R.sample_and_composite_rays_reference(
        table, VOL, *_torch_args(coords, valid, deltas, mids), BG, mode,
        torch.tensor(BETA), BIAS)
    _assert_render_close(got, want)


@pytest.mark.parametrize('extra', [0, 8])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('mode', ['sdf', 'naive'])
def test_field_reference_matches_table_reference(mode, dtype, extra):
    """The field's plain sampler reads the terms the table's row holds, in
    the table's corner order, and sums them the same way: the same results
    bit for bit, also from a channel slice of a padded field."""
    vol, coords, valid, deltas, mids = _case(seed=7)
    tv = torch.from_numpy(vol).to(dtype)
    args = _torch_args(coords, valid, deltas, mids)
    want = R.sample_and_composite_rays_reference(
        S.corner_table_reference(tv), VOL, *args, BG, mode,
        torch.tensor(BETA), BIAS)
    field = _padded(tv, extra)
    assert rays.channel_stride(field) == vol.shape[0] + extra
    got = R.sample_and_composite_rays_field_reference(
        field, *args, BG, mode, torch.tensor(BETA), BIAS, chunk_rays=7)
    assert torch.equal(got, want)


@pytest.mark.parametrize('dtype,stride', [(torch.float32, 8),
                                          (torch.bfloat16, 8),
                                          (torch.float32, 24)])
def test_channels_last_field_and_its_gradient(dtype, stride):
    """The field copy is the channels-last permutation whose voxels start on
    16 bytes (6 channels padded with zeros to 8; 24 fp32 channels are
    already 96 bytes) and its backward the inverse permutation."""
    rng = np.random.RandomState(8)
    C = 6 if stride == 8 else 24
    vol = torch.from_numpy(rng.randn(C, 3, 4, 5).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.randn(3, 4, 5, C).astype(np.float32)).to(dtype)
    v = vol.clone().requires_grad_()
    f = rays.channels_last_field(v)
    assert f.shape == (3, 4, 5, C) and f.stride() == (
        4 * 5 * stride, 5 * stride, stride, 1)
    assert rays.channel_stride(f) == stride
    assert torch.equal(f, vol.permute(1, 2, 3, 0))
    padded = torch.as_strided(f, (3, 4, 5, stride), f.stride())
    assert not padded[..., C:].any()
    f.backward(g)
    assert torch.equal(v.grad, g.permute(3, 0, 1, 2))


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
    """The (D+1, H+1, W+1, 8C) table of `ops.tables.corner_table` and the
    ((D+1)(H+1)(W+1), 2, 2, 2, C) rows of `build_neighborhood_table` hold
    the same bytes and the table's plain sampler renders them the same."""
    vol, coords, valid, deltas, mids = _case(seed=5)
    tv = torch.from_numpy(vol).to(dtype)
    args = _torch_args(coords, valid, deltas, mids)
    outs = [R.sample_and_composite_rays_reference(
        t, VOL, *args, BG, 'sdf', torch.tensor(BETA), BIAS)
        for t in (tables.corner_table(tv), S.build_neighborhood_table(tv))]
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
    ('field', lambda t: t.permute(1, 0, 2, 3), ValueError),
    ('field', lambda t: t.to(torch.float16), TypeError),
    ('field', lambda t: t[..., :4], ValueError),
    ('field', lambda t: F.pad(t, (0, 1)), ValueError),
])
def test_kernel_argument_checks(field, bad, err):
    """The checks the wrapper makes before any launch: the field must be
    channels-last bf16 or fp32 with 5 to 32 channels, each voxel starting
    on 16 bytes (9 fp32 channels do not)."""
    vol, coords, valid, deltas, mids = _case(n_rays=8, n_samp=8)
    t = dict(coords=torch.from_numpy(coords), valid=torch.from_numpy(valid),
             deltas=torch.from_numpy(deltas), mids=torch.from_numpy(mids),
             beta=torch.tensor(BETA),
             field=rays.channels_last_field(torch.from_numpy(vol)))
    t[field] = bad(t[field])
    with pytest.raises(err):
        rays._check(**t)


def test_kernel_argument_checks_pass_a_padded_field():
    """A channel slice of a padded channels-last field is a field, at its
    padded voxel stride."""
    vol, coords, valid, deltas, mids = _case(n_rays=8, n_samp=8)
    field = _padded(torch.from_numpy(vol), 8)
    got = rays._check(field, *_torch_args(coords, valid, deltas, mids),
                      torch.tensor(BETA))
    assert got == (8, 8, 1 + K + 3, 16)


@pytest.mark.parametrize('most', [rays.MOST, rays.MOST_CARRIED])
@pytest.mark.parametrize('C', [5, 30, 31, 32, 33, 44, 62, 100])
def test_channel_groups_cover_the_field(C, most):
    """Each launch's channels: the whole field where C <= most, else groups
    of the density channel and at most most - 1 others, each of the others
    in exactly one group, in order, and every group wide enough for the
    kernel (5 channels or more)."""
    groups = rays.channel_groups(C, most)
    if C <= most:
        assert groups == [list(range(C))]
        return
    assert all(g[0] == 0 and 5 <= len(g) <= most for g in groups)
    assert sum((g[1:] for g in groups), []) == list(range(1, C))
    assert max(map(len, groups)) - min(map(len, groups)) <= 1


def _plain_geometry(coords, valid, deltas, mids, mode='sdf'):
    return tuple(_torch_args(coords, valid, deltas, mids)) + (
        BG, mode, torch.tensor(BETA), BIAS)


@pytest.mark.parametrize('mode', ['sdf', 'naive'])
@pytest.mark.parametrize('C', [33, 44])
def test_grouped_plain_march_matches_the_whole(C, mode):
    """The channel-group split and merge driven by the plain versions, as
    the op runs the kernel above 32 channels (two groups here, the field's
    channels copied into a field of each), against the whole plain march
    in fp32: the renders within 1e-6 of each output's magnitude (each
    group samples its channels and the density as the whole march does; a
    group's march may chunk its rays otherwise), also in the stop mode with
    the optical depth; the field gradient and d beta from a random d out
    within 1e-5 (the density channel's and d beta are sums over the groups,
    in another order), and each group's launch given its own columns."""
    vol, coords, valid, deltas, mids = _case(seed=9, n_rays=80,
                                             n_classes=C - 4)
    field = rays.channels_last_field(torch.from_numpy(vol))
    geo = _plain_geometry(coords, valid, deltas, mids, mode)
    seen = []

    def fwd(f, _):
        seen.append(f.shape[3])
        assert rays.channel_stride(f) % 4 == 0
        return R.sample_and_composite_rays_field_reference(f, *geo)
    got = rays.march_in_groups(fwd, field, rays.MOST)
    want = R.sample_and_composite_rays_field_reference(field, *geo)
    assert len(seen) == 2 and sum(seen) == C + 1
    assert got.shape == want.shape == (80, C)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * max(1.0, want.abs().max()))
    stop = torch.from_numpy(np.random.RandomState(1).randint(
        0, 10, 80).astype(np.int32))
    got, sd = rays.march_in_groups(
        lambda f, _: R.sample_and_composite_rays_field_reference(
            f, *geo, stop=stop, with_sd=True), field, rays.MOST)
    want, want_sd = R.sample_and_composite_rays_field_reference(
        field, *geo, stop=stop, with_sd=True)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * max(1.0, want.abs().max()))
    torch.testing.assert_close(sd, want_sd, rtol=1e-6, atol=1e-6)

    g = torch.from_numpy(np.random.RandomState(2).randn(80, C).astype(
        np.float32))
    out = R.sample_and_composite_rays_field_reference(field, *geo)

    def bwd(f, o, gg):
        i = len(seen) - 2
        seen.append(f.shape[3])
        own = [rays._column(j, f.shape[3]) for j in range(1, f.shape[3])]
        whole = [rays._column(c, C) for c in rays.channel_groups(
            C, rays.MOST)[i][1:]]
        assert torch.equal(o[:, own], out[:, whole])
        assert torch.equal(gg[:, own], g[:, whole])
        assert torch.equal(gg[:, -1], g[:, -1] if i == 0
                           else torch.zeros(80))
        return R.sample_and_composite_rays_field_backward_reference(
            f, *geo, gg)
    d_field, d_beta = rays.backward_in_groups(bwd, field, rays.MOST, out, g)
    w_field, w_beta = R.sample_and_composite_rays_field_backward_reference(
        field, *geo, g)
    assert len(seen) == 4 and d_field.shape == w_field.shape
    torch.testing.assert_close(d_field, w_field, rtol=0,
                               atol=1e-5 * w_field.abs().max())
    torch.testing.assert_close(d_beta, w_beta, rtol=1e-5,
                               atol=1e-5 * max(1.0, abs(w_beta.item())))


@pytest.mark.parametrize('grouped', [False, True])
def test_render_rays_matches_jax_at_29_classes(grouped):
    """At num_classes 29 (33 channels, above one launch's 32): the port's
    `render_rays` on the CPU (the plain versions, which take any C) and
    the plain march split into channel groups as the op splits it on a
    card, against the JAX dense sampler on the same seeded inputs, at the
    JAX package's tolerances."""
    vol, coords, valid, deltas, mids = _case(seed=1, n_classes=29)
    want = _jax_render(vol, coords, valid, deltas, mids, 'sdf', 'float32')
    field = rays.channels_last_field(torch.from_numpy(vol))
    geo = _plain_geometry(coords, valid, deltas, mids)
    if grouped:
        got = rays.march_in_groups(
            lambda f, _: R.sample_and_composite_rays_field_reference(
                f, *geo), field, rays.MOST)
    else:
        got = rays.render_rays(field, *geo)
    _assert_render_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_gpu(dtype):
    """On the card: the ray kernel agrees with its plain version to 1e-4 *
    max(1, max |ref|) per output (fp32 sums in another order; the plain
    transmittance is a sequential cumsum), in both density modes, on the
    field `channels_last_field` makes and on a padded one (voxel stride
    16). Each launches once; a field whose voxels do not start on 16 bytes
    raises. (The corner table's cases: the next test.)"""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    for mode in ('sdf', 'naive'):
        vol, coords, valid, deltas, mids = _case(seed=4, n_rays=1000,
                                                 n_samp=85)
        tv = torch.from_numpy(vol).to(dtype).cuda()
        args = [a.cuda() for a in _torch_args(coords, valid, deltas, mids)]
        beta = torch.tensor(BETA, device='cuda')
        with pytest.raises(ValueError, match='16 bytes'):
            rays.sample_and_composite_rays(_padded(tv, 1), *args, BG, mode,
                                           beta, BIAS)
        for extra in (0, 8):
            field = (rays.channels_last_field(tv) if extra == 0
                     else _padded(tv, extra))
            before = rays.LAUNCHES
            got = rays.sample_and_composite_rays(field, *args, BG, mode,
                                                 beta, BIAS)
            assert rays.LAUNCHES == before + 1
            ref = R.sample_and_composite_rays_field_reference(
                field, *args, BG, mode, beta, BIAS)
            torch.cuda.synchronize()
            for sl in (slice(0, 3), slice(3, K + 3), slice(K + 3, K + 4)):
                tol = 1e-4 * max(1.0, ref[:, sl].abs().max().item())
                err = (got[:, sl] - ref[:, sl]).abs().max().item()
                assert err <= tol, (mode, extra, sl, err, tol)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_corner_table_kernel_matches_plain_on_gpu(dtype):
    """On the card: the corner-table kernel (off the model's path, still a
    port of `_corner_table_pallas`) is byte-identical to its plain version
    on both staging routes (16-byte loads at W 8, 16, 64 and 256, and in
    fp32 at 300 and 1,400, whose rows are cut into segments; a value a
    lane at W 1, 33, 70, in bf16 at 300, at C = 300 in segments, and on a
    contiguous view that does not start on 16 bytes), at D = 1, H = 1, odd
    C, on a volume holding NaN, inf and -0.0 (copied bit for bit); each
    call launches once, on the route its plan names."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    gen = torch.Generator().manual_seed(0)
    cases = [(8, 5, 8, 8), (22, 2, 4, 256), (22, 3, 17, 33), (5, 1, 1, 70),
             (22, 2, 2, 300), (1, 1, 1, 1), (6, 1, 3, 16), (7, 2, 3, 64)]
    if dtype == torch.float32:
        cases.append((22, 1, 2, 1400))           # rows in segments
    else:
        cases.append((300, 1, 2, 201))           # segments, scalar route
    # (shape, values the view starts after): views one value into a buffer
    cases = [(shape, 0) for shape in cases] + [((22, 3, 17, 33), 1),
                                               ((22, 2, 4, 256), 1)]
    for shape, offset in cases:
        base = torch.randn(offset + math.prod(shape), generator=gen)
        vol = base[offset:].view(shape)
        if shape == (22, 2, 4, 256) and offset == 0:
            vol.view(-1)[::97] = float('nan')
            vol.view(-1)[5::101] = float('inf')
            vol.view(-1)[7::103] = -float('inf')
            vol.view(-1)[9::89] = -0.0
        vol = base.to(dtype).cuda()[offset:].view(shape)
        assert vol.is_contiguous()
        assert (vol.data_ptr() % 16 == 0) == (offset == 0)
        plan = tables.card_plan(vol)
        before = tables.LAUNCHES
        got = tables.corner_table(vol)
        assert tables.LAUNCHES == before + 1
        assert tables.LAST_ROUTE == plan['route'], (shape, offset, plan)
        if offset:
            assert plan['route'] == 'scalar'
        want = S.corner_table_reference(vol)
        view = torch.int16 if dtype == torch.bfloat16 else torch.int32
        assert torch.equal(got.view(view), want.view(view)), (shape, plan)


@pytest.mark.gpu
@pytest.mark.parametrize('n_classes', [27, 28, 29, 40])
def test_wide_ray_kernels_match_plain_on_gpu(n_classes):
    """On the card at num_classes 27, 28, 29 and 40 (C = 31 to 44): the
    differentiable op `render_rays` through the kernels (one launch a
    direction up to 32 channels, two channel groups above) against
    `plain=True`, in fp32 and bf16: the renders within 1e-4 of each
    output's magnitude, the field's gradient and d beta from a random d
    out within 1e-4 (1e-2 in bf16: one rounding to the field's dtype) and
    1e-3 of their magnitude (fp32 sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    vol, coords, valid, deltas, mids = _case(seed=4, n_rays=1000, n_samp=85,
                                             n_classes=n_classes)
    C = n_classes + 4
    args = [a.cuda() for a in _torch_args(coords, valid, deltas, mids)]
    g = torch.from_numpy(np.random.RandomState(6).randn(1000, C).astype(
        np.float32)).cuda()
    groups = len(rays.channel_groups(C, rays.MOST))
    for dtype in (torch.float32, torch.bfloat16):
        outs, grads = [], []
        for plain in (False, True):
            v = torch.from_numpy(vol).cuda().to(dtype).requires_grad_()
            beta = torch.tensor(BETA, device='cuda', requires_grad=True)
            before = (rays.LAUNCHES, rays.BWD_LAUNCHES)
            out = rays.render_rays(rays.channels_last_field(v), *args, BG,
                                   'sdf', beta, BIAS, plain)
            out.backward(g)
            if not plain:
                assert (rays.LAUNCHES, rays.BWD_LAUNCHES) == (
                    before[0] + groups, before[1] + groups)
            outs.append(out.detach())
            grads.append((v.grad.float(), beta.grad))
        for sl in (slice(0, 3), slice(3, C - 1), slice(C - 1, C)):
            ref = outs[1][:, sl]
            tol = 1e-4 * max(1.0, ref.abs().max().item())
            assert (outs[0][:, sl] - ref).abs().max().item() <= tol, sl
        (d_got, b_got), (d_want, b_want) = grads
        rtol = 1e-4 if dtype == torch.float32 else 1e-2   # a bf16 ulp
        assert (d_got - d_want).abs().max() <= rtol * d_want.abs().max()
        assert abs(b_got.item() - b_want.item()) <= 1e-3 * abs(b_want.item())
