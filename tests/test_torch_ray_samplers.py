"""The JAX package's pass-structured ray samplers in the port: the
train-mode compact sampler (the dense march on `compact_valid`'s
validity) and the early-termination sampler (`render_rays_earlyterm`,
two runs of the march's stop mode), against
`sample_and_composite_rays_compact` and
`sample_and_composite_rays_earlyterm` on the corner table of the same
field, and the model's choice of sampler against the JAX model's; the
plain versions of the stop mode's two resumed launches against the
one-shot march; on a card only, the stop mode of the ray kernel, one-shot
and resumed, against its plain versions.

JAX is imported inside the parity tests only, so that the card-only case
runs where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_ray_samplers.py
"""
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

from vampire_tpu_torch.core import rendering as R
from vampire_tpu_torch.ops import rays

VOL = (5, 8, 8)            # (D, H, W)
K = 4
C = 1 + K + 3
BETA, BIAS, BG = 0.2, -1.0, 70.4
TAU = 7.0


def _field(seed, saturated=False):
    """A fused (C, D, H, W) field whose sdf lies around the density's knee
    (rays end anywhere from transparent to opaque), or far below it (every
    in-field sample has density ~1/beta: rays saturate)."""
    rng = np.random.RandomState(seed)
    vol = rng.randn(C, *VOL).astype(np.float32)
    vol[0] = -3.0 if saturated else rng.uniform(-0.9, -0.2, VOL)
    return vol


def _rays(seed, n_rays, n_samp, lengths):
    """Rays whose in-field samples are the prefix [0, L) (the frustum
    leaving the field box; `lengths` per ray), or, with lengths None,
    samples in and out of the field anywhere."""
    rng = np.random.RandomState(seed)
    coords = rng.uniform(-1.4, 1.4, (n_rays, n_samp, 3)).astype(np.float32)
    if lengths is not None:
        s = np.arange(n_samp)[None, :]
        inside = s < lengths[:, None]
        coords = np.where(inside[..., None], np.clip(coords, -0.95, 0.95),
                          np.float32(1.9))
    valid = (np.abs(coords) <= 1.0).all(-1).astype(np.float32)
    deltas = rng.uniform(0.3, 1.2, (n_rays, n_samp)).astype(np.float32)
    mids = np.linspace(2.0, 70.4, n_samp).astype(np.float32)
    return coords, valid, deltas, mids


def _jax_dens():
    import jax.numpy as jnp
    from vampire_tpu.core import rendering as JR
    return functools.partial(JR.laplace_density, beta=jnp.float32(BETA),
                             bias=BIAS)


def _port_args(vol, coords, valid, deltas, mids, beta=None):
    field = rays.channels_last_field(torch.from_numpy(vol))
    beta = torch.tensor(BETA) if beta is None else beta
    return (field, torch.from_numpy(coords), torch.from_numpy(valid),
            torch.from_numpy(deltas), torch.from_numpy(mids), BG, 'sdf',
            beta, BIAS)


def _cat(outs):
    return np.concatenate([np.asarray(outs[0]), np.asarray(outs[1]),
                           np.asarray(outs[2])[:, None]], axis=1)


def _close(got, want, rtol, what):
    """rtol of each output's magnitude, per output group (rgb, seg,
    depth)."""
    for name, sl in (('rgb', slice(0, 3)), ('seg', slice(3, K + 3)),
                     ('depth', slice(K + 3, C))):
        w = want[:, sl]
        np.testing.assert_allclose(got[:, sl], w, rtol=rtol,
                                   atol=rtol * max(1.0, np.abs(w).max()),
                                   err_msg=f'{what} {name}')


# ---------------------------------------------------------------------------
# the compact sampler
# ---------------------------------------------------------------------------

N_RAYS, N_SAMP, CHUNK = 1024, 16, 4
FRACS = (1.0, 1.0, 0.3, 0.1)       # caps 1024, 1024, 512, 256


def _compact_lengths(seed, covered):
    """In-field lengths, shuffled over the rays. `covered`: at most 512
    rays reach past sample 8 and 256 past 12, so that FRACS' caps cover
    every in-field prefix; else every ray reaches anywhere."""
    rng = np.random.RandomState(seed)
    if covered:
        L = np.concatenate([rng.randint(0, N_SAMP + 1, 256),
                            rng.randint(0, 13, 256),
                            rng.randint(0, 9, N_RAYS - 512)])
    else:
        L = rng.randint(0, N_SAMP + 1, N_RAYS)
    return rng.permutation(L)


@pytest.mark.parametrize('covered', [True, False],
                         ids=['caps-cover', 'caps-drop'])
def test_compact_sampler_matches_jax(covered):
    """Values, d volume (through the field copy) and d beta of the port's
    compact sampler (`render_rays` on `compact_valid`) against `jax.vjp`
    of `sample_and_composite_rays_compact` on the corner table: 2e-5 of
    each output's and gradient's magnitude, the JAX package's own tolerance
    between its samplers. Where the caps do not cover every in-field prefix
    the sampler replaces samples in the field by fog: those cases must
    really drop in-field samples and differ from the dense sampler by 50
    times the tolerance."""
    jax = pytest.importorskip('jax')
    import jax.numpy as jnp
    from vampire_tpu.core import rendering as JR
    from vampire_tpu.core import sampling as JS
    vol = _field(3)
    coords, valid, deltas, mids = _rays(
        4, N_RAYS, N_SAMP, _compact_lengths(5, covered))
    g = np.random.RandomState(6).randn(N_RAYS, C).astype(np.float32)
    g[:, -1] *= 0.05

    def f(v, b):
        return JR.sample_and_composite_rays_compact(
            JS.build_neighborhood_table(v), VOL, K, jnp.asarray(coords),
            jnp.asarray(valid), jnp.asarray(deltas), jnp.asarray(mids),
            functools.partial(JR.laplace_density, beta=b, bias=BIAS), BG,
            chunk=CHUNK, pass_fracs=FRACS)
    outs, vjp = jax.vjp(f, jnp.asarray(vol.transpose(1, 2, 3, 0)),
                        jnp.float32(BETA))
    d_vol, d_beta = vjp((jnp.asarray(g[:, :3]), jnp.asarray(g[:, 3:K + 3]),
                         jnp.asarray(g[:, K + 3])))
    want = _cat(outs)
    d_vol = np.asarray(d_vol).transpose(3, 0, 1, 2)

    v = torch.from_numpy(vol).requires_grad_()
    beta = torch.tensor(BETA, requires_grad=True)
    args = list(_port_args(vol, coords, valid, deltas, mids, beta))
    args[0] = rays.channels_last_field(v)
    capped = R.compact_valid(args[2], CHUNK, FRACS)
    dropped = int(((args[2] > 0) & (capped == 0)).sum())
    assert (dropped == 0) == covered, dropped
    out = rays.render_rays(args[0], args[1], capped, *args[3:])
    out.backward(torch.from_numpy(g))
    _close(out.detach().numpy(), want, 2e-5, 'values')
    np.testing.assert_allclose(v.grad.numpy(), d_vol, rtol=2e-5,
                               atol=2e-5 * np.abs(d_vol).max())
    np.testing.assert_allclose(beta.grad.item(), float(d_beta), rtol=2e-5)
    dense = rays.sample_and_composite_rays(*_port_args(vol, coords, valid,
                                                       deltas, mids))
    gap = np.abs(dense.numpy() - want).max()
    if covered:
        assert gap <= 2e-5 * np.abs(want).max(), gap
    else:
        assert gap > 50 * 2e-5 * np.abs(want).max(), gap


def test_compact_valid_cuts_each_ray_at_its_processed_prefix():
    """`compact_valid` by hand: rays sorted by length (stable, longest
    first), sorted ray p keeps the samples of the passes whose cap exceeds
    p, and nothing else changes."""
    rng = np.random.RandomState(0)
    n_rays, n_samp, chunk = 700, 10, 3            # passes of 3, 3, 3, 1
    L = rng.randint(0, n_samp + 1, n_rays)
    valid = (np.arange(n_samp)[None, :] < L[:, None]).astype(np.float32)
    valid[rng.rand(n_rays, n_samp) < 0.1] = 0.0     # holes change nothing
    fracs = (1.0, 0.9, 0.2, 0.5)                    # caps 700, 700, 512, 512
    assert R.pass_caps(fracs, n_rays) == [700, 700, 512, 512]
    got = R.compact_valid(torch.from_numpy(valid), chunk, fracs).numpy()
    L_true = np.array([max([s + 1 for s in range(n_samp) if valid[r, s]],
                           default=0) for r in range(n_rays)])
    order = sorted(range(n_rays), key=lambda r: (-L_true[r], r))
    want = valid.copy()
    for p, r in enumerate(order):
        keep = sum(min(n_samp, (j + 1) * chunk) - j * chunk
                   for j, cap in enumerate([700, 700, 512, 512]) if p < cap)
        want[r, keep:] = 0.0
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match='4 passes'):
        R.compact_valid(torch.from_numpy(valid), chunk, fracs[:3])


# ---------------------------------------------------------------------------
# the early-termination sampler
# ---------------------------------------------------------------------------

ET_RAYS, ET_CHUNK, ET_PREFIX = 640, 4, 1
ET_TIGHT = (0.6, 0.3, 0.1)                 # caps 512, 256, 256


def _et_case(seed, prefix_masks, saturated=False, exit_share=0.5):
    """`exit_share` of the rays exit early (L <= 4 = prefix * chunk), the
    others reach 8 to 16 samples."""
    rng = np.random.RandomState(seed)
    L = np.where(rng.rand(ET_RAYS) < exit_share, rng.randint(0, 5, ET_RAYS),
                 rng.randint(8, N_SAMP + 1, ET_RAYS))
    vol = _field(seed, saturated)
    return (vol,) + _rays(seed + 1, ET_RAYS, N_SAMP,
                          L if prefix_masks else None) + (L,)


def _jax_et(vol, coords, valid, deltas, mids, fracs):
    import jax.numpy as jnp
    from vampire_tpu.core import rendering as JR
    from vampire_tpu.core import sampling as JS
    outs = JR.sample_and_composite_rays_earlyterm(
        JS.build_neighborhood_table(jnp.asarray(vol.transpose(1, 2, 3, 0))),
        VOL, K, jnp.asarray(coords), jnp.asarray(valid), jnp.asarray(deltas),
        jnp.asarray(mids), _jax_dens(), BG, chunk=ET_CHUNK, prefix=ET_PREFIX,
        caps_fracs=fracs, tau=TAU, return_diag=True)
    return _cat(outs[:3]), int(outs[3])


def _port_et(vol, coords, valid, deltas, mids, fracs):
    out, diag = rays.render_rays_earlyterm(
        *_port_args(vol, coords, valid, deltas, mids), ET_CHUNK, ET_PREFIX,
        fracs, TAU)
    return out.numpy(), int(diag)


def _count_calls(monkeypatch, *names):
    """Wrap these functions of `ops.rays` to count their calls; returns the
    counts by name, updated as they are called."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        def counted(*a, _fn=getattr(rays, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(rays, name, counted)
    return calls


@pytest.mark.parametrize('regime', ['full-caps', 'full-caps-prefix',
                                    'exited-only'])
def test_earlyterm_sampler_exact_regimes_match_jax(regime):
    """The JAX package's exact regimes (tests/test_rendering.py): full caps
    on any masks, and caps that drop only exited rays (every non-exited
    ray covered, +10 %) on prefix masks; 3e-5, a diagnostic of 0 on both
    sides, and the dense sampler's values."""
    pytest.importorskip('jax')
    vol, coords, valid, deltas, mids, L = _et_case(
        13, regime != 'full-caps')
    fracs = ((1.0,) * 3 if regime.startswith('full') else
             (min(1.0, float((L > 4).mean()) + 0.1),) * 3)
    want, jdiag = _jax_et(vol, coords, valid, deltas, mids, fracs)
    got, diag = _port_et(vol, coords, valid, deltas, mids, fracs)
    _close(got, want, 3e-5, regime)
    assert diag == jdiag == 0
    dense = rays.sample_and_composite_rays(*_port_args(vol, coords, valid,
                                                       deltas, mids))
    _close(got, dense.numpy(), 3e-5, f'{regime} vs dense')


def test_earlyterm_sampler_saturated_drops_match_jax():
    """Tight caps on a saturating field where 90 % of the rays stay in it:
    the dropped rays are exited or saturated, so both samplers stay within
    exp(-tau) x the value scale of the dense march and of each other, with
    a diagnostic of 0."""
    pytest.importorskip('jax')
    vol, coords, valid, deltas, mids, L = _et_case(13, True, saturated=True,
                                                   exit_share=0.1)
    fracs = ET_TIGHT
    assert (L > 4).sum() > 512
    want, jdiag = _jax_et(vol, coords, valid, deltas, mids, fracs)
    got, diag = _port_et(vol, coords, valid, deltas, mids, fracs)
    dense = rays.sample_and_composite_rays(*_port_args(
        vol, coords, valid, deltas, mids)).numpy()
    bound = math.exp(-TAU) * (np.abs(vol).max() * 8 + BG)
    assert diag == jdiag == 0
    assert np.abs(got - want).max() <= bound
    assert np.abs(got - dense).max() <= bound
    assert np.abs(want - dense).max() <= bound


def test_earlyterm_sampler_uncovered_drops_match_jax(monkeypatch):
    """Tight caps on a field whose rays stay partly transparent: non-exited
    rays are dropped before they saturate. Their renders stop where their
    last pass ends, with no fog, as in JAX (3e-5 where both sides sort the
    rays alike, which the distinct sort keys here make sure of), and the
    diagnostic, the drops of rays below tau, equals the JAX one (no ray's
    optical depth at its stop lies within 1e-4 of tau). The port's sampler
    goes through the resumed pair of launches, once each."""
    pytest.importorskip('jax')
    vol, coords, valid, deltas, mids, _ = _et_case(21, True, exit_share=0.1)
    fracs = ET_TIGHT
    want, jdiag = _jax_et(vol, coords, valid, deltas, mids, fracs)
    calls = _count_calls(monkeypatch, 'sample_and_composite_rays_prefix',
                         'sample_and_composite_rays_resume')
    got, diag = _port_et(vol, coords, valid, deltas, mids, fracs)
    assert calls == {'sample_and_composite_rays_prefix': 1,
                     'sample_and_composite_rays_resume': 1}
    args = _port_args(vol, coords, valid, deltas, mids)
    first = torch.full((ET_RAYS,), ET_PREFIX * ET_CHUNK, dtype=torch.int32)
    _, sd0 = rays.sample_and_composite_rays(*args, stop=first, with_sd=True)
    stop, exited, misses = R.earlyterm_stops(sd0, args[2], ET_CHUNK,
                                             ET_PREFIX, fracs)
    _, sd = rays.sample_and_composite_rays(*args, stop=stop, with_sd=True)
    assert (np.abs(sd.numpy() - TAU) > 1e-4).all()
    live = ~exited & (stop < N_SAMP)
    assert int(live.sum()) > 20             # rays really dropped in-field
    assert diag == jdiag > 0
    _close(got, want, 3e-5, 'uncovered drops')
    dense = rays.sample_and_composite_rays(*args).numpy()
    assert np.abs(got - dense).max() > 1e-2


def test_earlyterm_stops_by_hand():
    """The stops, the exit flags and the misses of `earlyterm_stops` from
    their definition: key = sd + 1e9 for exited rays in fp32 (exited keys
    with sd < 32 tie at 1e9 and keep their index order), a stable sort,
    stop S for exited rays, else prefix * chunk plus the chunks of the
    passes whose cap exceeds the rank."""
    rng = np.random.RandomState(2)
    n_rays, n_samp, chunk, prefix = 600, 11, 3, 1   # passes 3, 3, 3, 2 after
    L = rng.randint(0, n_samp + 1, n_rays)
    valid = (np.arange(n_samp)[None, :] < L[:, None]).astype(np.float32)
    sd = rng.uniform(0, 10, n_rays).astype(np.float32)
    sd[:40] = sd[40:80]                    # exact ties among the live keys
    fracs = (0.9, 0.5, 0.2)                # caps 768 -> 600, 512, 256
    stop, exited, misses = R.earlyterm_stops(
        torch.from_numpy(sd), torch.from_numpy(valid), chunk, prefix, fracs)
    ex = L <= prefix * chunk
    key = sd + np.where(ex, np.float32(1e9), np.float32(0.0))
    assert key.dtype == np.float32
    order = np.argsort(key, kind='stable')
    rank = np.empty(n_rays, int)
    rank[order] = np.arange(n_rays)
    caps = [600, 512, 256]
    lens = [3, 3, 2]
    want = np.where(ex, n_samp, prefix * chunk + sum(
        np.where(rank < c, n, 0) for c, n in zip(caps, lens)))
    np.testing.assert_array_equal(stop.numpy(), want)
    np.testing.assert_array_equal(exited.numpy(), ex)
    np.testing.assert_array_equal(misses.numpy(),
                                  sum((rank >= c).astype(int) for c in caps))
    assert stop.dtype == torch.int32
    with pytest.raises(ValueError, match='needs 3'):
        R.earlyterm_stops(torch.from_numpy(sd), torch.from_numpy(valid),
                          chunk, prefix, fracs[:2])


def test_earlyterm_sampler_is_forward_only():
    """The JAX package runs it in inference only: the renders carry no
    gradient path the port could honour, so a backward raises instead of
    returning zeros."""
    vol, coords, valid, deltas, mids, _ = _et_case(13, True)
    v = torch.from_numpy(vol).requires_grad_()
    args = list(_port_args(vol, coords, valid, deltas, mids))
    args[0] = rays.channels_last_field(v)
    out, diag = rays.render_rays_earlyterm(*args, ET_CHUNK, ET_PREFIX,
                                           (1.0, 1.0, 1.0), TAU)
    assert out.requires_grad and not diag.requires_grad
    with pytest.raises(RuntimeError, match='forward only'):
        out.sum().backward()


def test_stop_mode_reference_stops_each_ray():
    """The plain march in its stop mode: a ray stopped at s renders as the
    same ray cut to its first s samples, with the optical depth of those
    samples; stop = S is the march without a stop, bit for bit."""
    vol, coords, valid, deltas, mids, _ = _et_case(13, False)
    args = _port_args(vol, coords, valid, deltas, mids)
    full, sd_full = rays.sample_and_composite_rays(
        *args, stop=torch.full((ET_RAYS,), N_SAMP, dtype=torch.int32),
        with_sd=True)
    assert torch.equal(full, rays.sample_and_composite_rays(*args))
    stop = torch.from_numpy(np.random.RandomState(0).randint(
        0, N_SAMP + 1, ET_RAYS).astype(np.int32))
    got, sd = rays.sample_and_composite_rays(*args, stop=stop, with_sd=True)
    for r in (0, 7, 100, 639):
        s = int(stop[r])
        cut = list(_port_args(vol, coords[r:r + 1, :s], valid[r:r + 1, :s],
                              deltas[r:r + 1, :s], mids[:s]))
        if s == 0:
            want = torch.zeros(1, C)
            want[0, -1] = BG
            want_sd = torch.zeros(1)
        else:
            want, want_sd = R.sample_and_composite_rays_field_reference(
                *cut, with_sd=True)
        torch.testing.assert_close(got[r:r + 1], want, rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(sd[r:r + 1], want_sd, rtol=1e-6,
                                   atol=1e-6)


def _resume_stops(case, valid, n):
    """Stops for the resumed pair: every ray at the prefix end `n`, inside
    the passes after it, at S (every ray exited), the mix that
    `earlyterm_stops` gives, or S below n."""
    n_rays, n_samp = valid.shape
    rng = np.random.RandomState(7)
    if case == 'at-prefix':
        stop = np.full(n_rays, n)
    elif case == 'later-passes':
        stop = np.minimum(n_samp, n + ET_CHUNK * rng.randint(1, 4, n_rays))
    elif case in ('exited', 'S-below-prefix'):
        stop = np.full(n_rays, n_samp)
    else:
        return None
    return torch.from_numpy(stop.astype(np.int32))


@pytest.mark.parametrize('case', ['at-prefix', 'later-passes', 'exited',
                                  'earlyterm-stops', 'S-below-prefix'])
def test_resumed_pair_matches_the_one_shot_march(case):
    """The plain versions of the stop mode's two launches (the prefix's
    carried state, then each ray resumed from it to its stop) against the
    one-shot plain march to the same stops, renders and optical depth
    within 1e-6 of each output's magnitude (fp32: the sums split at the
    prefix and added back); the kernel wrappers on the CPU give the same.
    'S-below-prefix' has 3 samples a ray under a prefix of 4."""
    n_samp = 3 if case == 'S-below-prefix' else N_SAMP
    vol, coords, valid, deltas, mids, _ = _et_case(13, True, exit_share=0.1)
    args = _port_args(vol, coords[:, :n_samp], valid[:, :n_samp],
                      deltas[:, :n_samp], mids[:n_samp])
    n = min(n_samp, ET_PREFIX * ET_CHUNK)
    state = R.sample_and_composite_rays_field_prefix_reference(
        *args, ET_PREFIX * ET_CHUNK)
    assert state.shape == (ET_RAYS, C + 2) and state.dtype == torch.float32
    stop = _resume_stops(case, args[2], n)
    if stop is None:
        stop = R.earlyterm_stops(state[:, -1], args[2], ET_CHUNK, ET_PREFIX,
                                 ET_TIGHT)[0]
        assert len(set(stop.tolist())) >= 3    # stops at n, after it, at S
    got, sd = R.sample_and_composite_rays_field_resume_reference(
        *args, state, n, stop)
    want, want_sd = R.sample_and_composite_rays_field_reference(
        *args, stop=stop, with_sd=True)
    _close(got.numpy(), want.numpy(), 1e-6, case)
    np.testing.assert_allclose(sd.numpy(), want_sd.numpy(), rtol=1e-6,
                               atol=1e-6 * max(1.0, want_sd.abs().max()))
    if case == 'at-prefix':               # nothing is marched after n
        assert torch.equal(sd, state[:, -1])
    w_state = rays.sample_and_composite_rays_prefix(*args,
                                                    ET_PREFIX * ET_CHUNK)
    w_out, w_sd = rays.sample_and_composite_rays_resume(*args, w_state, n,
                                                        stop)
    assert torch.equal(w_state, state)
    assert torch.equal(w_out, got) and torch.equal(w_sd, sd)


@pytest.mark.parametrize('n', [1, ET_CHUNK, 11, N_SAMP, N_SAMP + 5])
def test_prefix_key_is_the_one_shot_key_bit_for_bit(n):
    """The prefix launch's optical depth, the sort key of the stops, is the
    one-shot stop mode's `with_sd` at a stop of min(S, n) for every ray,
    bit for bit, and its sums are that march's before compositing."""
    vol, coords, valid, deltas, mids, _ = _et_case(21, False)
    args = _port_args(vol, coords, valid, deltas, mids)
    state = R.sample_and_composite_rays_field_prefix_reference(*args, n)
    stop = torch.full((ET_RAYS,), min(N_SAMP, n), dtype=torch.int32)
    out, sd = R.sample_and_composite_rays_field_reference(
        *args, stop=stop, with_sd=True)
    assert torch.equal(state[:, -1], sd)
    assert torch.equal(state[:, :C - 1], out[:, :C - 1])
    depth = state[:, C] + (1.0 - state[:, C - 1]) * BG
    assert torch.equal(depth, out[:, C - 1])


def _wide_et_args(seed, width):
    """`_et_case`'s rays (prefix masks) through a field of `width` channels
    whose sdf lies around the density's knee; the sampler's arguments."""
    vol, coords, valid, deltas, mids, _ = _et_case(seed, True,
                                                   exit_share=0.1)
    rng = np.random.RandomState(seed)
    wide = rng.randn(width, *VOL).astype(np.float32)
    wide[0] = vol[0]
    return _port_args(wide, coords, valid, deltas, mids)


@pytest.mark.parametrize('width', [31, 33, 44])
def test_grouped_earlyterm_matches_the_whole(width):
    """The early-termination sampler whose two launches each run over
    channel groups (a carried state holds at most 30 channels: two groups
    here), driven by the plain versions, against the whole plain sampler
    in fp32: the same stops (the key, the first group's optical depth, is
    the density's alone), the same diagnostic, the renders within 1e-6 of
    each output's magnitude; the merged state, key included, within 1e-6
    of the whole prefix's (the plain sample of a narrower field may round
    its last bit otherwise)."""
    args = _wide_et_args(5, width)
    n = ET_PREFIX * ET_CHUNK
    calls = []

    def first(*a):
        def launch(f, st):
            assert st is None and f.shape[3] <= rays.MOST_CARRIED
            calls.append('first')
            return R.sample_and_composite_rays_field_prefix_reference(
                f, *a[1:])
        return rays.march_in_groups(launch, a[0], rays.MOST_CARRIED)

    def then(*a):
        state, begin, stop = a[-3:]

        def launch(f, st):
            assert st.shape == (ET_RAYS, f.shape[3] + 2)
            assert torch.equal(st[:, -3:], state[:, -3:])
            calls.append('then')
            return R.sample_and_composite_rays_field_resume_reference(
                f, *a[1:-3], st, begin, stop)
        return rays.march_in_groups(launch, a[0], rays.MOST_CARRIED,
                                    state=state)
    got, diag, stop = rays.earlyterm_march(first, then, args, ET_CHUNK,
                                           ET_PREFIX, ET_TIGHT, TAU)
    want, want_diag, want_stop = rays.earlyterm_march(
        R.sample_and_composite_rays_field_prefix_reference,
        R.sample_and_composite_rays_field_resume_reference, args, ET_CHUNK,
        ET_PREFIX, ET_TIGHT, TAU)
    assert calls == ['first', 'first', 'then', 'then']
    assert torch.equal(stop, want_stop)
    assert len(set(stop.tolist())) >= 3
    assert int(diag) == int(want_diag)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * max(1.0, want.abs().max()))
    state = first(*args, n)
    whole = R.sample_and_composite_rays_field_prefix_reference(*args, n)
    torch.testing.assert_close(state, whole, rtol=0,
                               atol=1e-6 * max(1.0, whole.abs().max()))


# ---------------------------------------------------------------------------
# the model's choice of sampler
# ---------------------------------------------------------------------------

MATS = ('sensor2ego', 'intrin', 'ida', 'bda')


@pytest.fixture(scope='module')
def tiny_models():
    """tiny_config in fp32 with samplers whose caps drop in-field samples
    at its 6 x 8 x 16 = 768 rays of 7 samples: ray_chunk 2 and
    ray_pass_fracs (1, 1, 0.3, 0.1) (caps 768, 768, 256, 256);
    ray_et_chunk 2, ray_et_prefix 1 and ray_et_fracs (0.6, 0.3, 0.1)
    (caps 512, 256, 256). The field's (16, 16) plane spans +-12 m instead of
    +-4 m, the same grid, so that the rays stay in it for 2 to 7 samples
    (at +-4 m every ray leaves it after its first). The JAX weights (BN and
    biases randomised; the density bias zeroed and the density's beta 3.0,
    so that the rays stay partly transparent over their 2 m steps and the
    dropped samples show in the renders) go across with
    `weights.from_flax`."""
    jax = pytest.importorskip('jax')
    import jax.numpy as jnp
    from test_torch_model import _randomize
    from vampire_tpu.data.synthetic import synthetic_batch, tiny_config
    from vampire_tpu.models.vampire import Vampire as JaxVampire
    from vampire_tpu_torch.models.vampire import Vampire
    from vampire_tpu_torch.weights import from_flax
    cfg = tiny_config()
    bc = dataclasses.replace(cfg.backbone, x_bound_seg=(-12.0, 12.0, 1.5),
                             y_bound_seg=(-12.0, 12.0, 1.5), ray_chunk=2,
                             ray_pass_fracs=(1.0, 1.0, 0.3, 0.1),
                             ray_et_chunk=2, ray_et_prefix=1,
                             ray_et_fracs=(0.6, 0.3, 0.1))
    batch = synthetic_batch(cfg, batch_size=1, n_points=64, seed=0,
                            mode='val')
    jb = {k: jnp.asarray(batch[k]) for k in MATS + ('imgs', 'points')}
    jm = JaxVampire(bc, cfg.head, dtype=jnp.float32)
    v = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jb['imgs'],
                                {k: jb[k] for k in MATS},
                                points=jb['points'], train=False))()
    variables = _randomize({k: jax.device_get(v[k])
                            for k in ('params', 'batch_stats')})
    bb = variables['params']['backbone']
    bb['density_conv']['bias'] = np.zeros(1, np.float32)
    bb['density_beta'] = np.full(np.shape(bb['density_beta']), 3.0,
                                 np.float32)
    tm = Vampire(bc, cfg.head, dtype=torch.float32)
    sd = from_flax(variables, tm)
    tb = {k: torch.from_numpy(batch[k]) for k in jb}
    return dict(jax=jax, jm=jm, variables=variables, jb=jb, tm=tm, sd=sd,
                tb=tb, bc=bc)


def _jax_renders(m, train):
    jm, jb = m['jm'], m['jb']

    def fwd(v):
        return jm.apply(v, jb['imgs'], {k: jb[k] for k in MATS},
                        points=jb['points'], train=train,
                        camera_renders=True,
                        mutable=['batch_stats', 'diagnostics'])
    (fo, _), state = m['jax'].device_get(m['jax'].jit(fwd)(m['variables']))
    diag = state.get('diagnostics', {}).get('backbone', {})
    return fo, diag


def _ray_valid(m):
    """The tiny frame's (R, S) ray validity, as the model computes it."""
    from vampire_tpu_torch.core import geometry as G
    from vampire_tpu_torch.models.field import ray_inputs
    bb, tb = m['tm'].backbone, m['tb']
    geom = G.get_geometry(bb.frustum, tb['sensor2ego'], tb['intrin'],
                          tb['ida'], tb['bda'])
    return ray_inputs(geom, m['bc'])[1][0]


@pytest.mark.parametrize('mode', ['train', 'eval'])
def test_model_picks_the_jax_sampler(tiny_models, mode):
    """The camera renders of a train-mode forward (the compact sampler) and
    of an eval-mode forward (the early-termination sampler, its diagnostic
    in `diagnostics`) against the JAX model's at test_torch_model.py's
    tolerances (the rays sample a bf16 copy of the field on both sides:
    2^-8 of the largest output more), with caps that drop in-field samples
    (checked on the port's ray inputs); the renders differ from the dense
    sampler's by more than that tolerance."""
    from test_torch_model import ATOL, RTOL
    m = tiny_models
    tm, tb = m['tm'], m['tb']
    tm.load_state_dict(m['sd'], strict=True)   # train mode moves BN stats
    train = mode == 'train'
    jfo, jdiag = _jax_renders(m, train)
    tm.train(train)
    diags = {}
    with torch.no_grad():
        tfo, _ = tm(tb['imgs'], {k: tb[k] for k in MATS},
                    points=tb['points'], diagnostics=diags)
        dense_bb = dataclasses.replace(m['bc'], ray_pass_fracs=(),
                                       ray_et_fracs=())
        saved, tm.backbone.cfg = tm.backbone.cfg, dense_bb
        try:
            dfo, _ = tm(tb['imgs'], {k: tb[k] for k in MATS},
                        points=tb['points'])
        finally:
            tm.backbone.cfg = saved
    valid = _ray_valid(m)
    bc = m['bc']
    if train:
        capped = R.compact_valid(valid, bc.ray_chunk, bc.ray_pass_fracs)
        assert int(((valid > 0) & (capped == 0)).sum()) > 50
        assert 'ray_et_uncovered_drops' not in diags
    else:
        L = R.ray_lengths(valid)
        live = L > bc.ray_et_prefix * bc.ray_et_chunk
        caps = R.pass_caps(bc.ray_et_fracs, len(L))
        assert int(live.sum()) > caps[-1] + 50      # caps drop live rays
        assert int(diags['ray_et_uncovered_drops']) == int(
            jdiag['ray_et_uncovered_drops'][0])
    for k in ('rgb_preds', 'seg_logits_preds', 'depth_preds'):
        want = np.asarray(jfo[k])
        got = tfo[k].numpy()
        atol = ATOL + 2.0 ** -8 * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol,
                                   err_msg=f'{mode} {k}')
    gap = np.abs(dfo['depth_preds'].numpy() - got).max()
    assert gap > RTOL * np.abs(want).max() + atol, gap


def test_model_raises_on_fracs_of_the_wrong_length():
    """Both of the JAX model's ValueErrors: ray_pass_fracs must have one
    entry a pass of ray_chunk samples, ray_et_fracs one a pass after the
    prefix; either is checked in both modes."""
    from vampire_tpu_torch.configs import tiny_config
    from vampire_tpu_torch.models.field import FieldBackbone
    bc = tiny_config().backbone
    for kw, match in ((dict(ray_pass_fracs=(1.0,) * 3),
                       'ray_pass_fracs has 3 entries but the ray axis makes '
                       '1 passes'),
                      (dict(ray_et_fracs=(1.0,) * 2, ray_et_prefix=1),
                       'ray_et_fracs has 2 entries but needs 0')):
        fb = FieldBackbone(dataclasses.replace(bc, **kw))
        for train in (True, False):
            fb.train(train)
            with pytest.raises(ValueError, match=match):
                fb._render_cameras({}, [])


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_stop_mode_kernel_matches_its_plain_version():
    """The ray kernel's stop mode (and its optical depth) against the plain
    version on a field partly opaque along the rays, with stops anywhere
    in [0, S]; the kernel without a stop is the same launch as before."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the ray kernel has no CPU mode)')
    vol, coords, valid, deltas, mids, _ = _et_case(13, False)
    args = [a.cuda() if isinstance(a, torch.Tensor) else a
            for a in _port_args(vol, coords, valid, deltas, mids)]
    args[0] = rays.channels_last_field(torch.from_numpy(vol).cuda())
    stop = torch.from_numpy(np.random.RandomState(0).randint(
        -1, N_SAMP + 2, ET_RAYS).astype(np.int32)).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        args[0] = rays.channels_last_field(
            torch.from_numpy(vol).cuda().to(dtype))
        before = rays.STOP_LAUNCHES
        got, sd = rays.sample_and_composite_rays(*args, stop=stop,
                                                 with_sd=True)
        assert rays.STOP_LAUNCHES == before + 1
        want, want_sd = R.sample_and_composite_rays_field_reference(
            *args, stop=stop.clamp(0, N_SAMP), with_sd=True)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(sd, want_sd, rtol=1e-5, atol=1e-5)
        plain = rays.sample_and_composite_rays(*args)
        torch.testing.assert_close(
            plain, R.sample_and_composite_rays_field_reference(*args),
            rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_resumed_stop_mode_kernels_match_their_plain_versions():
    """The stop mode's two launches on the card against their plain
    versions, in fp32 and bf16 at the chip check's RAY_RTOL (1e-4 of each
    output's magnitude): the prefix's carried state (its optical depth bit
    for bit the one-shot kernel's `with_sd` at the same stop: the 8 lanes a
    ray sum its 4 samples in the one-shot warp's tree), and the resumed
    launch from the plain state to `earlyterm_stops`' stops; each adds one
    stop-mode launch. Then the refusals of one launch (a state of 31
    channels: C + 2 > 32, which the wrappers split into channel groups),
    and the one-shot stop mode at 31 channels, which carries no state and
    so takes C + 2 > 32."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the ray kernel has no CPU mode)')
    vol, coords, valid, deltas, mids, _ = _et_case(13, True)
    args = [a.cuda() if isinstance(a, torch.Tensor) else a
            for a in _port_args(vol, coords, valid, deltas, mids)]
    n = ET_PREFIX * ET_CHUNK
    for dtype in (torch.float32, torch.bfloat16):
        args[0] = rays.channels_last_field(
            torch.from_numpy(vol).cuda().to(dtype))
        before = rays.STOP_LAUNCHES
        state = rays.sample_and_composite_rays_prefix(*args, n)
        assert rays.STOP_LAUNCHES == before + 1
        want = R.sample_and_composite_rays_field_prefix_reference(*args, n)
        for col in range(C + 2):
            torch.testing.assert_close(
                state[:, col], want[:, col], rtol=1e-4,
                atol=1e-4 * max(1.0, want[:, col].abs().max().item()))
        first = torch.full((ET_RAYS,), n, dtype=torch.int32, device='cuda')
        _, sd1 = rays.sample_and_composite_rays(*args, stop=first,
                                                with_sd=True)
        assert torch.equal(state[:, -1], sd1)
        stop = R.earlyterm_stops(want[:, -1], args[2], ET_CHUNK, ET_PREFIX,
                                 ET_TIGHT)[0]
        got, sd = rays.sample_and_composite_rays_resume(*args, want, n, stop)
        assert rays.STOP_LAUNCHES == before + 3
        w_out, w_sd = R.sample_and_composite_rays_field_resume_reference(
            *args, want, n, stop)
        _close(got.cpu().numpy(), w_out.cpu().numpy(), 1e-4, str(dtype))
        torch.testing.assert_close(sd, w_sd, rtol=1e-4, atol=1e-4)
    wide = rays.channels_last_field(torch.from_numpy(
        np.random.RandomState(3).randn(31, *VOL).astype(np.float32)).cuda())
    wide_args = [wide] + args[1:]            # C + 2 = 33 columns a ray
    with pytest.raises(ValueError, match='at most 32'):
        rays._forward(*wide_args, keep_state=True, end=n)
    with pytest.raises(ValueError, match='at most 32'):
        rays._forward(*wide_args, stop=stop, with_sd=True,
                      state=torch.zeros((ET_RAYS, 33), device='cuda'),
                      begin=n)
    with pytest.raises(ValueError, match='samples'):
        rays.sample_and_composite_rays_resume(*args, want, -1, stop)
    got, sd = rays.sample_and_composite_rays(*wide_args, stop=stop,
                                             with_sd=True)
    w_out, w_sd = R.sample_and_composite_rays_field_reference(
        *wide_args, stop=stop, with_sd=True)
    _close(got.cpu().numpy(), w_out.cpu().numpy(), 1e-4, 'one-shot C 31')
    torch.testing.assert_close(sd, w_sd, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize('n_classes', [27, 28, 29, 40])
def test_wide_earlyterm_kernels_match_their_plain_versions(n_classes):
    """The early-termination sampler on the card at num_classes 27, 28, 29
    and 40 (C + 2 = 33 to 46 state columns: its launches run in two channel
    groups) against the whole plain sampler, in fp32 and bf16: the same
    stops but for rays whose key the kernel's summation order moves across
    a cap (at most 1 %), every other ray within 1e-4 of each output's
    magnitude, two stop-mode launches a group and launch."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the ray kernel has no CPU mode)')
    args = [a.cuda() if isinstance(a, torch.Tensor) else a
            for a in _wide_et_args(7, n_classes + 4)]
    vol = args[0].permute(3, 0, 1, 2)
    for dtype in (torch.float32, torch.bfloat16):
        args[0] = rays.channels_last_field(vol.to(dtype))
        before = rays.STOP_LAUNCHES
        got, diag, stop = rays.earlyterm_march(
            rays.sample_and_composite_rays_prefix,
            rays.sample_and_composite_rays_resume, tuple(args), ET_CHUNK,
            ET_PREFIX, ET_TIGHT, TAU)
        assert rays.STOP_LAUNCHES == before + 4
        want, _, want_stop = rays.earlyterm_march(
            R.sample_and_composite_rays_field_prefix_reference,
            R.sample_and_composite_rays_field_resume_reference, tuple(args),
            ET_CHUNK, ET_PREFIX, ET_TIGHT, TAU)
        same = stop == want_stop
        assert int((~same).sum()) <= 0.01 * ET_RAYS
        g, w = got[same], want[same]
        for col in range(g.shape[1]):
            torch.testing.assert_close(
                g[:, col], w[:, col], rtol=1e-4,
                atol=1e-4 * max(1.0, w[:, col].abs().max().item()))
        assert int(diag) >= 0


@pytest.mark.gpu
@pytest.mark.parametrize('n_classes,sampler', [(29, 'dense'), (40, 'dense'),
                                               (27, 'earlyterm'),
                                               (28, 'earlyterm')])
def test_wide_field_backbone_on_gpu(n_classes, sampler):
    """A tiny FieldBackbone (seeded weights, fp32) on the card at
    num_classes above one ray launch's channels, against the same module
    with plain=True on the same inputs: at 29 and 40 (C = 33, 44: two
    channel groups a launch) an eval-mode full-render forward (the dense
    march) and a train step's gradients (each parameter tensor's |d| / |g|
    within 1e-2, chip_smoke.py's TRAIN_GRAD_RTOL for the same comparison,
    cuDNN's TF32 off: fp32 sums in another order through the lift's and
    the rays' atomics, which vary run to run); at 27 and 28 (C + 2 = 33, 34
    state columns) the
    eval-mode early-termination sampler. Renders within 1e-4 of each
    output's magnitude; the early-term renders at 99 % of the upsampled
    pixels at least (a ray that the key's summation order moves across a
    cap stops elsewhere and moves the pixels around it)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    from vampire_tpu.data.synthetic import tiny_config
    from vampire_tpu_torch.configs import camera_rig
    from vampire_tpu_torch.models.field import FieldBackbone
    bc = dataclasses.replace(
        tiny_config().backbone, num_classes=n_classes,
        x_bound_seg=(-12.0, 12.0, 1.5), y_bound_seg=(-12.0, 12.0, 1.5),
        ray_et_chunk=2, ray_et_prefix=1,
        ray_et_fracs=(0.6, 0.3, 0.1) if sampler == 'earlyterm' else ())
    torch.manual_seed(0)
    fb = FieldBackbone(bc).cuda()
    rng = np.random.RandomState(1)
    imgs = torch.from_numpy(rng.randn(1, 6, *bc.final_dim, 3).astype(
        np.float32)).cuda()
    mats = {k: torch.from_numpy(v).cuda() for k, v in
            camera_rig(1, 6, bc.final_dim, seed=0).items()}
    keys = ('rgb_preds', 'seg_logits_preds', 'depth_preds')
    fb.eval()
    with torch.no_grad():
        got, want = (fb(imgs, mats, plain=plain) for plain in (False, True))
    for k in keys:
        g, w = got[k], want[k]
        if sampler == 'earlyterm':          # per upsampled pixel
            err = (g - w).abs()
            err = err.amax(-1) if err.dim() == 5 else err
            same = err <= 1e-4 * max(1.0, w.abs().max().item())
            assert same.float().mean() >= 0.99, k
            continue
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * max(1.0, w.abs().max().item()))
    if sampler == 'earlyterm':
        return
    fb.train()
    weights = {k: torch.from_numpy(rng.randn(*got[k].shape).astype(
        np.float32)).cuda() for k in keys}
    grads = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for plain in (False, True):
            fb.zero_grad()
            out = fb(imgs, mats, plain=plain)
            sum((out[k] * weights[k]).sum() for k in keys).backward()
            grads.append({n: p.grad.clone()
                          for n, p in fb.named_parameters()
                          if p.grad is not None})
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) > 10
    for n, w in grads[1].items():
        assert (grads[0][n] - w).norm() <= 1e-2 * w.norm(), n
