"""The backward of the port's three kernel ops against the JAX package.

On the CPU each op's plain backward runs (the version its CUDA kernel is
held to on a card): the lift over one frame's cameras against `jax.vjp` of
the JAX compacted lift step (`sample_outer_product_fused` and the
`.at[ids].add` scatter), the corner-table transpose against
`jax.vjp(corner_table)`, and the ray sampler's d field and d beta against
`jax.vjp` of `sample_and_composite_rays` on `build_neighborhood_table` of
the volume, with respect to the volume, in fp32 (the JAX model's table is
bf16, whose rounding is not the point here); the table's plain ray backward
is held to the JAX d table too. Inputs are numpy arrays from a seed, fp32
on both sides. The `gpu` cases hold each backward kernel to its
plain version on a card; they import no JAX and run with
    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_train_ops.py
"""
import functools

import numpy as np
import pytest
import torch

from vampire_tpu_torch.core import rendering as R
from vampire_tpu_torch.core import sampling as S
from vampire_tpu_torch.ops import lift, rays, tables

VOL = (5, 8, 8)            # (D, H, W) of the ray cases
K_CLS = 4
BETA, BIAS, BG = 0.1, -1.0, 70.4


def _lift_case(seed=0, N=3, D=9, H=8, W=12, C=5, G=6, K=4, Q=50):
    """One frame of N cameras: depth, features, per-camera distinct block
    ids, coords inside and beyond the image, ~70 % valid."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(N, D, H, W)
    depth = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return dict(
        depth=depth.astype(np.float32),
        feat=rng.randn(N, H, W, C).astype(np.float32),
        ids=np.stack([rng.permutation(G)[:K] for _ in range(N)]),
        coords=rng.uniform(-1.3, 1.3, (N, K, Q, 3)).astype(np.float32),
        valid=(rng.rand(N, K, Q) > 0.3).astype(np.float32),
        g=rng.randn(G, Q, C).astype(np.float32), G=G)


def _jax_lift_vjp(c):
    jax = pytest.importorskip('jax')
    import jax.numpy as jnp
    from vampire_tpu.core import sampling as JS
    N, K, Q = c['valid'].shape
    C = c['feat'].shape[-1]

    def frame(depth, feat):
        numer = jnp.zeros((c['G'], Q, C), jnp.float32)
        denom = jnp.zeros_like(numer)
        for n in range(N):
            v = JS.sample_outer_product_fused(
                depth[n], feat[n], jnp.asarray(c['coords'][n]).reshape(-1, 3),
                align_corners=False).reshape(K, Q, C)
            v = v * jnp.asarray(c['valid'][n])[..., None]
            ids = jnp.asarray(c['ids'][n])
            numer = numer.at[ids].add(v)
            denom = denom.at[ids].add((jnp.abs(v) > 0).astype(jnp.float32))
        return numer, denom

    (numer, denom), vjp = jax.vjp(frame, jnp.asarray(c['depth']),
                                  jnp.asarray(c['feat']))
    dd, df = vjp((jnp.asarray(c['g']), jnp.zeros_like(denom)))
    return [np.asarray(a) for a in (numer, denom, dd, df)]


@pytest.mark.parametrize('seed', [0, 1])
def test_lift_frame_matches_jax_vjp(seed):
    """Values (fp32 sums in another order: 1e-5) and d depth / d feat: each
    gradient element sums up to ~K*Q*C/(H*W) products in another order, and
    the JAX table path sums the 8 depth corners and the D+1 feature planes
    separately: 1e-5 relative, 1e-5 of each gradient's magnitude."""
    c = _lift_case(seed)
    want = _jax_lift_vjp(c)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in c.items() if k != 'G'}
    depth = t['depth'].requires_grad_()
    feat = t['feat'].requires_grad_()
    before = (lift.LAUNCHES, lift.BWD_LAUNCHES)
    numer, denom = lift.lift_frame(depth, feat, t['ids'], t['coords'],
                                   t['valid'], c['G'])
    numer.backward(t['g'])
    assert (lift.LAUNCHES, lift.BWD_LAUNCHES) == before   # CPU: plain
    assert not denom.requires_grad
    np.testing.assert_allclose(numer.detach().numpy(), want[0], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(denom.numpy(), want[1])
    for got, ref in ((depth.grad, want[2]), (feat.grad, want[3])):
        assert got.dtype == torch.float32 and np.abs(ref).max() > 0.1
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


def _lift_frame_case(case):
    """The three frames the per-camera kernels never saw: two cameras
    selecting the same blocks in another order, ids that include blocks
    with no valid query, and every block selected (K = G)."""
    if case == 'k_equals_g':
        return _lift_case(5, K=6, G=6)
    c = _lift_case(6)
    if case == 'overlap':
        c['ids'][1] = c['ids'][0][::-1]
    else:                                   # empty_blocks
        c['valid'][0, 1] = 0.0
        c['valid'][2, :2] = 0.0
    return c


@pytest.mark.parametrize('case', ['overlap', 'empty_blocks', 'k_equals_g'])
def test_lift_frame_cases_match_jax_vjp(case):
    """The plain frame forward and backward (what the frame kernels are held
    to on a card) against the JAX compacted lift step and its `jax.vjp`,
    fp32, with the tolerances of `test_lift_frame_matches_jax_vjp`."""
    c = _lift_frame_case(case)
    want = _jax_lift_vjp(c)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in c.items()
         if k != 'G'}
    args = [t[k] for k in ('depth', 'feat', 'ids', 'coords', 'valid')]
    numer, denom = lift.lift_frame_accumulate_reference(*args, c['G'])
    d_depth, d_feat = lift.lift_frame_backward_reference(*args, t['g'])
    np.testing.assert_allclose(numer.numpy(), want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(denom.numpy(), want[1])
    for got, ref in ((d_depth, want[2]), (d_feat, want[3])):
        assert np.abs(ref).max() > 0.1
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


def test_lift_frame_backward_casts_to_input_dtype():
    """bf16 inputs get bf16 gradients, the fp32 sums rounded once, as
    `_lift_table_bwd` casts them."""
    c = _lift_case(2)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in c.items() if k != 'G'}
    grads = []
    for dt in (torch.float32, torch.bfloat16):
        depth = t['depth'].to(dt).clone().requires_grad_()
        feat = t['feat'].to(dt).clone().requires_grad_()
        numer, _ = lift.lift_frame(depth, feat, t['ids'], t['coords'],
                                   t['valid'], c['G'])
        numer.backward(t['g'])
        assert depth.grad.dtype == dt and feat.grad.dtype == dt
        grads.append((depth.grad, feat.grad))
    want = [lift.lift_backward_reference(
        t['depth'][n].to(torch.bfloat16), t['feat'][n].to(torch.bfloat16),
        t['ids'][n], t['coords'][n], t['valid'][n], t['g'])
        for n in range(len(t['ids']))]
    torch.testing.assert_close(
        grads[1][0], torch.stack([w[0] for w in want]).to(torch.bfloat16),
        rtol=0, atol=0)
    torch.testing.assert_close(
        grads[1][1], torch.stack([w[1] for w in want]).to(torch.bfloat16),
        rtol=0, atol=0)


def test_corner_table_backward_matches_jax_vjp():
    """The transpose of the table build: sums of 8 values, in the same order
    as `_corner_table_bwd_impl`: exact up to the channels-first layout."""
    jax = pytest.importorskip('jax')
    import jax.numpy as jnp
    from vampire_tpu.ops.pallas_tables import corner_table as jax_table
    rng = np.random.RandomState(3)
    C, D, H, W = 6, 4, 5, 7
    vol = rng.randn(C, D, H, W).astype(np.float32)
    g = rng.randn(D + 1, H + 1, W + 1, 8 * C).astype(np.float32)
    _, vjp = jax.vjp(jax_table, jnp.asarray(vol.transpose(1, 2, 3, 0)))
    want = np.asarray(vjp(jnp.asarray(g))[0]).transpose(3, 0, 1, 2)
    got = tables.corner_table_backward(torch.from_numpy(g), (C, D, H, W))
    np.testing.assert_array_equal(got.numpy(), want)
    tv = torch.from_numpy(vol).requires_grad_()
    before = (tables.LAUNCHES, tables.BWD_LAUNCHES)
    out = tables.build_corner_table(tv)
    torch.testing.assert_close(out, S.corner_table_reference(tv.detach()),
                               rtol=0, atol=0)
    out.backward(torch.from_numpy(g))
    assert (tables.LAUNCHES, tables.BWD_LAUNCHES) == before
    np.testing.assert_array_equal(tv.grad.numpy(), want)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(22, 3, 5, 7), (5, 2, 4, 9), (7, 1, 1, 1)])
def test_corner_table_backward_library_matches_plain(shape, dtype):
    """The yardstick (one one-hot conv_transpose3d) sums the same 8 values
    in cuDNN's order: in fp32 within 1e-6 of the plain version's corner
    order; from a bf16 cotangent the call's output is rounded to bf16,
    so within one rounding (2^-8 relative) of the plain fp32 sum."""
    C, D, H, W = shape
    rng = np.random.RandomState(sum(shape))
    g = torch.from_numpy(rng.randn(D + 1, H + 1, W + 1, 8 * C)
                         .astype(np.float32)).to(dtype)
    got = tables.corner_table_backward_library(g, shape)
    want = tables.corner_table_backward_reference(g, shape)
    assert got.shape == want.shape == (C, D, H, W)
    assert got.dtype == torch.float32
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    else:
        torch.testing.assert_close(got, want, rtol=2 ** -8, atol=1e-6)
    w = tables.onehot_corner_weight(C, dtype)
    assert torch.equal(tables.corner_table_backward_library(g, shape, w), got)


def _ray_case(seed=0, n_rays=60, n_samp=9):
    """A fused (C, D, H, W) field around the density's knee and rays whose
    samples fall inside, on and beyond the field's borders (as in
    tests/test_torch_rays.py), and a cotangent for every output."""
    rng = np.random.RandomState(seed)
    C = 1 + K_CLS + 3
    vol = rng.randn(C, *VOL).astype(np.float32)
    vol[0] = rng.uniform(-1.2, 0.2, VOL)
    coords = rng.uniform(-1.3, 1.3, (n_rays, n_samp, 3)).astype(np.float32)
    valid = (np.abs(coords) <= 1.0).all(-1).astype(np.float32)
    deltas = rng.uniform(0.05, 0.6, (n_rays, n_samp)).astype(np.float32)
    mids = np.linspace(2.4, 69.6, n_samp).astype(np.float32)
    g = rng.randn(n_rays, C).astype(np.float32)
    g[:, -1] *= 0.05                # depth is ~30x the other outputs
    return vol, coords, valid, deltas, mids, g


def _jax_density(mode):
    from vampire_tpu.core import rendering as JR
    if mode == 'sdf':
        return lambda beta: functools.partial(JR.laplace_density, beta=beta,
                                              bias=BIAS)
    return lambda beta: JR.naive_density


def _port_ray_grads(vol, coords, valid, deltas, mids, g, mode, **kw):
    """The port's ray op on the channels-last field of `vol` (C, D, H, W):
    (out, d vol through the field copy, d beta)."""
    v = torch.from_numpy(vol).requires_grad_()
    beta = torch.tensor(BETA, requires_grad=True)
    out = rays.render_rays(rays.channels_last_field(v),
                           *(torch.from_numpy(a) for a in
                             (coords, valid, deltas, mids)),
                           BG, mode, beta, BIAS, **kw)
    out.backward(torch.from_numpy(g))
    return out.detach(), v.grad, beta.grad


def _jax_ray_vjp(vol, coords, valid, deltas, mids, g, mode, wrt_volume):
    """jax.vjp of the JAX dense sampler on `build_neighborhood_table` of
    the fp32 volume, with respect to the volume (channels-first, as the
    port's) or to the table, and to beta: (outs, d, d beta)."""
    jax = pytest.importorskip('jax')
    import jax.numpy as jnp
    from vampire_tpu.core import rendering as JR
    from vampire_tpu.core import sampling as JS
    dens = _jax_density(mode)
    jvol = jnp.asarray(vol.transpose(1, 2, 3, 0))

    def render(table, beta):
        return JR.sample_and_composite_rays(
            table, VOL, K_CLS, jnp.asarray(coords), jnp.asarray(valid),
            jnp.asarray(deltas), jnp.asarray(mids), dens(beta), BG,
            chunk_rays=16)
    if wrt_volume:
        outs, vjp = jax.vjp(lambda v, b: render(
            JS.build_neighborhood_table(v), b), jvol, jnp.float32(BETA))
    else:
        outs, vjp = jax.vjp(render, JS.build_neighborhood_table(jvol),
                            jnp.float32(BETA))
    jg = (jnp.asarray(g[:, :3]), jnp.asarray(g[:, 3:K_CLS + 3]),
          jnp.asarray(g[:, K_CLS + 3]))
    d, d_beta = (np.asarray(a) for a in vjp(jg))
    if wrt_volume:
        d = d.transpose(3, 0, 1, 2)
    return outs, d, d_beta


def _assert_beta_close(mode, got, want):
    """d beta sums terms of either sign over every sample, each carrying
    d density / d beta ~ 1/beta_eff^2 = 100 times its sample's weight, so it
    cancels: 1e-4 relative."""
    if mode == 'naive':
        assert float(got) == 0.0 and float(want) == 0.0
    else:
        assert abs(float(want)) > 1e-3
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


@pytest.mark.parametrize('mode', ['sdf', 'naive'])
def test_ray_backward_matches_jax_vjp(mode):
    """d volume and d beta of the port's ray op (the field's plain backward
    and the field copy's) against jax.vjp of the JAX dense sampler on the
    corner table of the same fp32 volume, with respect to the volume. The
    plain backward sums each ray's tail as a suffix sum where JAX transposes
    a cumsum, and scatters into the field where JAX sums the table's 8
    slices: 1e-5 of the gradient's magnitude."""
    vol, coords, valid, deltas, mids, g = _ray_case(seed=1)
    outs, d_vol, d_beta = _jax_ray_vjp(vol, coords, valid, deltas, mids, g,
                                       mode, wrt_volume=True)
    before = (rays.LAUNCHES, rays.BWD_LAUNCHES)
    out, v_grad, b_grad = _port_ray_grads(vol, coords, valid, deltas, mids,
                                          g, mode)
    assert (rays.LAUNCHES, rays.BWD_LAUNCHES) == before
    np.testing.assert_allclose(out[:, K_CLS + 3].numpy(), np.asarray(outs[2]),
                               rtol=1e-4, atol=1e-4)
    assert v_grad.dtype == torch.float32 and v_grad.shape == vol.shape
    scale = np.abs(d_vol).max()
    assert scale > 0.1
    np.testing.assert_allclose(v_grad.numpy(), d_vol, rtol=1e-5,
                               atol=1e-5 * scale)
    _assert_beta_close(mode, b_grad, d_beta)


@pytest.mark.parametrize('mode', ['sdf', 'naive'])
def test_table_ray_backward_matches_jax_vjp(mode):
    """The table's plain ray backward (d table, d beta) against jax.vjp of
    the JAX dense sampler with respect to the same fp32 table: 1e-5 of the
    gradient's magnitude."""
    vol, coords, valid, deltas, mids, g = _ray_case(seed=1)
    _, d_table, d_beta = _jax_ray_vjp(vol, coords, valid, deltas, mids, g,
                                      mode, wrt_volume=False)
    got, b_got = R.sample_and_composite_rays_backward_reference(
        S.corner_table_reference(torch.from_numpy(vol)), VOL,
        *(torch.from_numpy(a) for a in (coords, valid, deltas, mids)), BG,
        mode, torch.tensor(BETA), BIAS, torch.from_numpy(g))
    d_table = d_table.reshape(got.shape)
    scale = np.abs(d_table).max()
    np.testing.assert_allclose(got.numpy(), d_table, rtol=1e-5,
                               atol=1e-5 * scale)
    _assert_beta_close(mode, b_got, d_beta)


def _padded(vol, extra):
    """The channels-last field of a (C, D, H, W) volume as the channel slice
    of a copy with `extra` zero channels a voxel."""
    C = vol.shape[0]
    return torch.nn.functional.pad(vol.permute(1, 2, 3, 0).contiguous(),
                                   (0, extra))[..., :C]


@pytest.mark.parametrize('extra', [0, 3])
@pytest.mark.parametrize('mode', ['sdf', 'naive'])
def test_field_backward_matches_table_backward(mode, extra):
    """The field's plain backward is the table's d table passed through the
    table's transpose (`corner_table_backward_reference`), summed in another
    order: 1e-6 of the gradient's magnitude; d beta is the same sum."""
    vol, coords, valid, deltas, mids, g = _ray_case(seed=2)
    tv = torch.from_numpy(vol)
    args = [torch.from_numpy(a) for a in (coords, valid, deltas, mids)]
    d_table, b_table = R.sample_and_composite_rays_backward_reference(
        S.corner_table_reference(tv), VOL, *args, BG, mode,
        torch.tensor(BETA), BIAS, torch.from_numpy(g))
    want = tables.corner_table_backward_reference(
        d_table.reshape(tuple(n + 1 for n in VOL) + (-1,)), tv.shape)
    d_field, b_field = R.sample_and_composite_rays_field_backward_reference(
        _padded(tv, extra), *args, BG, mode,
        torch.tensor(BETA), BIAS, torch.from_numpy(g), chunk_rays=13)
    assert d_field.shape == VOL + (vol.shape[0],)
    got = d_field.permute(3, 0, 1, 2)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-6 * scale
    torch.testing.assert_close(b_field, b_table, rtol=1e-6, atol=0)


def test_dense_sampler_matches_jax_compact_sampler():
    """Training on the dense sampler computes what JAX trains on: the JAX
    train-mode `sample_and_composite_rays_compact` at the flagship S = 85,
    ray_chunk = 8 and ray_pass_fracs, on 1,024 rays whose in-field sample
    prefixes the pass caps cover (prefix-style validity, as the frustum
    leaves the field box). Values and d volume (the port's through its
    field, the JAX compact sampler's through the corner table's VJP) agree
    up to fp reassociation (the compact sampler's fog tail is closed form):
    2e-5, the JAX package's own tolerance for the two
    (tests/test_rendering.py), of each output's and gradient's magnitude.
    The port's train-mode forward now runs the compact sampler itself (the
    march on `core.rendering.compact_valid`'s validity); this case, whose
    caps cover every ray, shows that the dense march equals it there, and
    tests/test_torch_ray_samplers.py holds the port's compact sampler to
    JAX's at caps that drop in-field samples, where the two differ."""
    jax = pytest.importorskip('jax')
    import jax.numpy as jnp
    from vampire_tpu.configs import flagship_config
    from vampire_tpu.core import rendering as JR
    from vampire_tpu.core import sampling as JS
    bc = flagship_config().backbone
    fracs, chunk = bc.ray_pass_fracs, bc.ray_chunk
    n_rays, n_samp = 1024, 85
    rng = np.random.RandomState(5)
    C = 1 + K_CLS + 3
    vol = rng.randn(C, *VOL).astype(np.float32)
    vol[0] = rng.uniform(-1.2, 0.2, VOL)
    # ray i may reach into pass j only if i < cap_j (the caps the compact
    # sampler derives, non-increasing); rays are then shuffled
    caps = [min(n_rays, int(np.ceil(f * n_rays / 256.0) * 256))
            for f in fracs]
    lmax = np.array([min(n_samp, chunk * sum(i < c for c in caps))
                     for i in range(n_rays)])
    lengths = rng.permutation((rng.rand(n_rays) * (lmax + 1)).astype(int))
    coords = rng.uniform(-0.95, 0.95, (n_rays, n_samp, 3)).astype(np.float32)
    coords[np.arange(n_samp)[None, :] >= lengths[:, None]] = 1.9
    valid = (np.abs(coords) <= 1.0).all(-1).astype(np.float32)
    deltas = rng.uniform(0.1, 0.9, (n_rays, n_samp)).astype(np.float32)
    mids = np.linspace(2.4, 69.6, n_samp).astype(np.float32)
    g = rng.randn(n_rays, C).astype(np.float32)
    g[:, -1] *= 0.05
    dens = functools.partial(JR.laplace_density, beta=jnp.float32(BETA),
                             bias=BIAS)

    def f(v):
        return JR.sample_and_composite_rays_compact(
            JS.build_neighborhood_table(v), VOL, K_CLS, jnp.asarray(coords),
            jnp.asarray(valid), jnp.asarray(deltas), jnp.asarray(mids), dens,
            BG, chunk=chunk, pass_fracs=fracs)
    outs, vjp = jax.vjp(f, jnp.asarray(vol.transpose(1, 2, 3, 0)))
    (d_vol,) = vjp((jnp.asarray(g[:, :3]), jnp.asarray(g[:, 3:K_CLS + 3]),
                    jnp.asarray(g[:, K_CLS + 3])))
    want = np.concatenate([np.asarray(outs[0]), np.asarray(outs[1]),
                           np.asarray(outs[2])[:, None]], axis=1)
    out, v_grad, _ = _port_ray_grads(vol, coords, valid, deltas, mids, g,
                                     'sdf')
    assert (lengths > chunk * 8).sum() > 0       # some rays reach far
    for sl in (slice(0, 3), slice(3, K_CLS + 3), slice(K_CLS + 3, C)):
        np.testing.assert_allclose(
            out[:, sl].numpy(), want[:, sl], rtol=2e-5,
            atol=2e-5 * np.abs(want[:, sl]).max())
    d_vol = np.asarray(d_vol).transpose(3, 0, 1, 2)
    np.testing.assert_allclose(v_grad.numpy(), d_vol, rtol=2e-5,
                               atol=2e-5 * np.abs(d_vol).max())


@pytest.mark.parametrize('mode', ['sdf', 'naive'])
def test_density_grads_match_autograd(mode):
    """The written-out density derivatives against torch autograd of
    `density`, away from s = 0 where sign() has no derivative: 1e-5."""
    x = torch.linspace(-3.0, 1.0, 401, dtype=torch.float32)
    x = x[(x - BIAS).abs() > 1e-3].requires_grad_()
    beta = torch.tensor(-0.3, requires_grad=True)   # the sign of beta counts
    d = R.density(x, mode, beta, BIAS)
    dx, db = torch.autograd.grad(d.sum(), (x, beta), allow_unused=True)
    d2, ddx, ddb = R.density_and_grads(x.detach(), mode, beta.detach(), BIAS)
    torch.testing.assert_close(d2, d.detach(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ddx, dx, rtol=1e-5, atol=1e-5)
    want_db = torch.zeros(()) if db is None else db
    torch.testing.assert_close(ddb.sum(), want_db, rtol=1e-5, atol=1e-5)


def test_ray_geometry_takes_no_gradient():
    """coords, valid, deltas and mids come from the geometry: asking for
    their gradient raises instead of returning a wrong zero."""
    vol, coords, valid, deltas, mids, _ = _ray_case(n_rays=4, n_samp=5)
    field = rays.channels_last_field(torch.from_numpy(vol))
    args = [torch.from_numpy(a) for a in (coords, valid, deltas, mids)]
    args[2].requires_grad_()
    with pytest.raises(ValueError, match='deltas'):
        rays.render_rays(field, *args, BG, 'sdf', torch.tensor(BETA), BIAS)


# ---------------------------------------------------------------------------
# On a card: each backward kernel against its plain version
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_lift_backward_kernel_matches_plain_on_gpu(dtype):
    """fp32 reductions in another order than the plain version's index_add:
    1e-5 of each gradient's magnitude. One launch a frame; 16 channels
    (float4 reductions, four lanes a query) and 5 (a scalar reduction a
    lane and channel); cameras 0 and 1 select the same blocks in another
    order, camera 2 a block with no valid query, and an id out of range."""
    _need_card()
    for seed, C in ((4, 16), (7, 5)):
        c = _lift_case(seed, N=6, G=20, K=12, Q=400, C=C)
        c['ids'][1] = c['ids'][0][::-1]
        c['valid'][2, 3] = 0.0
        c['ids'][5, 0] = 20
        t = [torch.from_numpy(np.ascontiguousarray(c[k])).cuda() for k in
             ('depth', 'feat', 'ids', 'coords', 'valid')]
        t[0], t[1] = t[0].to(dtype), t[1].to(dtype)
        g = torch.from_numpy(c['g']).cuda()
        before = lift.BWD_LAUNCHES
        got = lift.lift_frame_backward(*t, g)
        assert lift.BWD_LAUNCHES == before + 1
        want = lift.lift_frame_backward_reference(*t, g)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.shape == b.shape
            tol = 1e-5 * b.abs().max().item()
            assert (a - b).abs().max().item() <= tol, C


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_corner_table_backward_kernel_matches_plain_on_gpu(dtype):
    """No atomics, the plain version's summation order: bit for bit."""
    _need_card()
    gen = torch.Generator().manual_seed(0)
    for shape in ((8, 5, 8, 8), (22, 3, 17, 33), (5, 1, 1, 70)):
        C, D, H, W = shape
        g = torch.randn(D + 1, H + 1, W + 1, 8 * C, generator=gen)
        g = g.to(dtype).cuda()
        before = tables.BWD_LAUNCHES
        got = tables.corner_table_backward(g, shape)
        assert tables.BWD_LAUNCHES == before + 1
        assert torch.equal(got, tables.corner_table_backward_reference(
            g, shape))


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('mode', ['sdf', 'naive'])
def test_ray_backward_kernel_matches_plain_on_gpu(dtype, mode):
    """The kernel takes each ray's total from the saved outputs where the
    plain version sums the tail, and scatters with fp32 atomics in another
    order: 1e-4 of the d field's magnitude, 1e-4 relative on d beta; on the
    field `channels_last_field` makes and on a padded one (voxel stride
    16)."""
    _need_card()
    vol, coords, valid, deltas, mids, g = _ray_case(seed=6, n_rays=1000,
                                                    n_samp=85)
    tv = torch.from_numpy(vol).to(dtype).cuda()
    args = [torch.from_numpy(a).cuda() for a in (coords, valid, deltas,
                                                 mids)]
    beta = torch.tensor(BETA, device='cuda')
    go = torch.from_numpy(g).cuda()
    for extra in (0, 8):
        field = (rays.channels_last_field(tv) if extra == 0
                 else _padded(tv, extra))
        out = rays.sample_and_composite_rays(field, *args, BG, mode, beta,
                                             BIAS)
        before = rays.BWD_LAUNCHES
        got = rays.sample_and_composite_rays_backward(field, *args, BG,
                                                      mode, beta, BIAS, out,
                                                      go)
        assert rays.BWD_LAUNCHES == before + 1
        want = R.sample_and_composite_rays_field_backward_reference(
            field, *args, BG, mode, beta, BIAS, go)
        torch.cuda.synchronize()
        assert got[0].shape == want[0].shape
        tol = 1e-4 * want[0].abs().max().item()
        assert (got[0] - want[0]).abs().max().item() <= tol, extra
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-6)
