"""The backward of the port's three kernel ops against the JAX package.

On the CPU each op's plain backward runs (the version its CUDA kernel is
held to on a card): the lift over one frame's cameras against `jax.vjp` of
the JAX compacted lift step (`sample_outer_product_fused` and the
`.at[ids].add` scatter), the corner-table transpose against
`jax.vjp(corner_table)`, and the ray sampler's d table and d beta against
`jax.vjp(sample_and_composite_rays)` on an fp32 table (the JAX model's table
is bf16, whose rounding is not the point here). Inputs are numpy arrays from
a seed, fp32 on both sides. The `gpu` cases hold each backward kernel to its
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


def _port_ray_grads(table, vol_shape, coords, valid, deltas, mids, g, mode,
                    **kw):
    t = table.clone().requires_grad_()
    beta = torch.tensor(BETA, requires_grad=True)
    out = rays.render_rays(t, vol_shape, *(torch.from_numpy(a) for a in
                                           (coords, valid, deltas, mids)),
                           BG, mode, beta, BIAS, **kw)
    out.backward(torch.from_numpy(g))
    return out.detach(), t.grad, beta.grad


@pytest.mark.parametrize('mode', ['sdf', 'naive'])
def test_ray_backward_matches_jax_vjp(mode):
    """d table and d beta of the plain ray backward against jax.vjp of the
    JAX dense sampler on the same fp32 table. The plain backward sums each
    ray's tail as a suffix sum where JAX transposes a cumsum: 1e-5 of each
    gradient's magnitude. d beta sums terms of either sign over every
    sample, each carrying d density / d beta ~ 1/beta_eff^2 = 100 times
    its sample's weight, so it cancels: 1e-4 relative."""
    jax = pytest.importorskip('jax')
    import jax.numpy as jnp
    from vampire_tpu.core import rendering as JR
    from vampire_tpu.core import sampling as JS
    vol, coords, valid, deltas, mids, g = _ray_case(seed=1)
    dens = _jax_density(mode)
    jtable = JS.build_neighborhood_table(jnp.asarray(vol.transpose(1, 2, 3,
                                                                   0)))

    def f(table, beta):
        return JR.sample_and_composite_rays(
            table, VOL, K_CLS, jnp.asarray(coords), jnp.asarray(valid),
            jnp.asarray(deltas), jnp.asarray(mids), dens(beta), BG,
            chunk_rays=16)
    outs, vjp = jax.vjp(f, jtable, jnp.float32(BETA))
    jg = (jnp.asarray(g[:, :3]), jnp.asarray(g[:, 3:K_CLS + 3]),
          jnp.asarray(g[:, K_CLS + 3]))
    d_table, d_beta = (np.asarray(a) for a in vjp(jg))
    before = (rays.LAUNCHES, rays.BWD_LAUNCHES)
    out, t_grad, b_grad = _port_ray_grads(
        S.corner_table_reference(torch.from_numpy(vol)), VOL, coords, valid,
        deltas, mids, g, mode)
    assert (rays.LAUNCHES, rays.BWD_LAUNCHES) == before
    np.testing.assert_allclose(out[:, K_CLS + 3].numpy(), np.asarray(outs[2]),
                               rtol=1e-4, atol=1e-4)
    assert t_grad.dtype == torch.float32
    d_table = d_table.reshape(t_grad.shape)
    scale = np.abs(d_table).max()
    assert scale > 0.1
    np.testing.assert_allclose(t_grad.numpy(), d_table, rtol=1e-5,
                               atol=1e-5 * scale)
    if mode == 'naive':
        assert float(b_grad) == 0.0 and float(d_beta) == 0.0
    else:
        assert abs(float(d_beta)) > 1e-3
        np.testing.assert_allclose(float(b_grad), float(d_beta), rtol=1e-4)


def test_dense_sampler_matches_jax_compact_sampler():
    """Training on the dense sampler computes what JAX trains on: the JAX
    train-mode `sample_and_composite_rays_compact` at the flagship S = 85,
    ray_chunk = 8 and ray_pass_fracs, on 1,024 rays whose in-field sample
    prefixes the pass caps cover (prefix-style validity, as the frustum
    leaves the field box). Values and d table agree up to fp reassociation
    (the compact sampler's fog tail is closed form): 2e-5, the JAX package's
    own tolerance for the two (tests/test_rendering.py), of each output's
    and gradient's magnitude."""
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

    def f(table):
        return JR.sample_and_composite_rays_compact(
            table, VOL, K_CLS, jnp.asarray(coords), jnp.asarray(valid),
            jnp.asarray(deltas), jnp.asarray(mids), dens, BG, chunk=chunk,
            pass_fracs=fracs)
    jtable = JS.build_neighborhood_table(jnp.asarray(vol.transpose(1, 2, 3,
                                                                   0)))
    outs, vjp = jax.vjp(f, jtable)
    (d_table,) = vjp((jnp.asarray(g[:, :3]), jnp.asarray(g[:, 3:K_CLS + 3]),
                      jnp.asarray(g[:, K_CLS + 3])))
    want = np.concatenate([np.asarray(outs[0]), np.asarray(outs[1]),
                           np.asarray(outs[2])[:, None]], axis=1)
    out, t_grad, _ = _port_ray_grads(
        S.corner_table_reference(torch.from_numpy(vol)), VOL, coords, valid,
        deltas, mids, g, 'sdf')
    assert (lengths > chunk * 8).sum() > 0       # some rays reach far
    for sl in (slice(0, 3), slice(3, K_CLS + 3), slice(K_CLS + 3, C)):
        np.testing.assert_allclose(
            out[:, sl].numpy(), want[:, sl], rtol=2e-5,
            atol=2e-5 * np.abs(want[:, sl]).max())
    d_table = np.asarray(d_table).reshape(t_grad.shape)
    np.testing.assert_allclose(t_grad.numpy(), d_table, rtol=2e-5,
                               atol=2e-5 * np.abs(d_table).max())


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
    table = S.corner_table_reference(torch.from_numpy(vol))
    args = [torch.from_numpy(a) for a in (coords, valid, deltas, mids)]
    args[2].requires_grad_()
    with pytest.raises(ValueError, match='deltas'):
        rays.render_rays(table, VOL, *args, BG, 'sdf', torch.tensor(BETA),
                         BIAS)


# ---------------------------------------------------------------------------
# On a card: each backward kernel against its plain version
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_lift_backward_kernel_matches_plain_on_gpu(dtype):
    """fp32 atomics in another order than the plain version's index_add:
    1e-5 of each gradient's magnitude. One launch per camera."""
    _need_card()
    c = _lift_case(4, N=2, G=20, K=12, Q=400)
    for n in range(2):
        t = [torch.from_numpy(np.asarray(c[k][n])).cuda() for k in
             ('depth', 'feat', 'ids', 'coords', 'valid')]
        t[0], t[1] = t[0].to(dtype), t[1].to(dtype)
        g = torch.from_numpy(c['g']).cuda()
        before = lift.BWD_LAUNCHES
        got = lift.lift_backward(*t, g)
        assert lift.BWD_LAUNCHES == before + 1
        want = lift.lift_backward_reference(*t, g)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            tol = 1e-5 * b.abs().max().item()
            assert (a - b).abs().max().item() <= tol


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
    order: 1e-4 of the d table's magnitude, 1e-4 relative on d beta."""
    _need_card()
    vol, coords, valid, deltas, mids, g = _ray_case(seed=6, n_rays=1000,
                                                    n_samp=85)
    table = tables.corner_table(torch.from_numpy(vol).to(dtype).cuda())
    args = [torch.from_numpy(a).cuda() for a in (coords, valid, deltas,
                                                 mids)]
    beta = torch.tensor(BETA, device='cuda')
    go = torch.from_numpy(g).cuda()
    out = rays.sample_and_composite_rays(table, VOL, *args, BG, mode, beta,
                                         BIAS)
    before = rays.BWD_LAUNCHES
    got = rays.sample_and_composite_rays_backward(table, VOL, *args, BG,
                                                  mode, beta, BIAS, out, go)
    assert rays.BWD_LAUNCHES == before + 1
    want = R.sample_and_composite_rays_backward_reference(
        table, VOL, *args, BG, mode, beta, BIAS, go)
    torch.cuda.synchronize()
    tol = 1e-4 * want[0].abs().max().item()
    assert (got[0] - want[0]).abs().max().item() <= tol
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-6)
