"""The lift: the port's plain version against the JAX `FieldBackbone._lift`,
the plain frame versions against the per-camera ones, the wrappers' checks,
and (on a card only) the frame kernel against the plain version.

JAX is imported inside the parity test only, so that the card-only cases
run where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_lift.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from vampire_tpu.data.synthetic import camera_rig, tiny_config
from vampire_tpu_torch.models.field import FieldBackbone
from vampire_tpu_torch.ops import lift


def _inputs(bc, seed=0):
    rng = np.random.RandomState(seed)
    h, w = bc.feat_hw
    D, C = bc.depth_channels, bc.mid_channels
    logits = rng.randn(2, 6, h, w, D).astype(np.float32)
    depth = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    feat = rng.randn(2, 6, h, w, C).astype(np.float32)
    return depth.astype(np.float32), feat


def _jax_lift(bc, mats, depth, feat):
    jax = pytest.importorskip('jax')
    import jax.numpy as jnp
    from vampire_tpu.models.field import FieldBackbone as JaxFieldBackbone
    m = JaxFieldBackbone(bc, dtype=jnp.float32)
    args = (jnp.asarray(depth), jnp.asarray(feat),
            {k: jnp.asarray(v) for k, v in mats.items()})
    v = jax.jit(lambda: m.init(jax.random.PRNGKey(0), *args,
                               method='_lift'))()
    return np.asarray(jax.jit(lambda: m.apply(v, *args, method='_lift'))())


def _port_lift(bc, mats, depth, feat):
    fb = FieldBackbone(bc)
    out = fb.lift(torch.from_numpy(depth).permute(0, 1, 4, 2, 3),
                  torch.from_numpy(feat),
                  {k: torch.from_numpy(v) for k, v in mats.items()})
    return out.permute(0, 2, 3, 4, 1).numpy()         # (B, Z, Y, X, C)


@pytest.mark.parametrize('blk,topk', [(8, 264), (4, 16), (4, 10)])
def test_lift_matches_jax(blk, topk):
    """Six cameras, two batch elements, camera_rig(seed=3). (8, 264) is the
    flagship block size with K clamped to all 4 blocks; (4, 10) selects 10
    of 16 blocks, where ties among the selected blocks' counts may be broken
    differently by lax.top_k and torch.topk without changing the output
    (an unselected block holds no valid query, else both would drop it).
    Same sampler arithmetic as the JAX fp32 sampler; the geometry's 4x4
    products are reassociated: 1e-5."""
    bc = dataclasses.replace(tiny_config().backbone, lift_block=blk,
                             lift_block_topk=topk)
    mats = camera_rig(2, 6, bc.final_dim, seed=3)
    depth, feat = _inputs(bc)
    want = _jax_lift(bc, mats, depth, feat)
    before = lift.LAUNCHES
    got = _port_lift(bc, mats, depth, feat)
    assert lift.LAUNCHES == before      # CPU tensors run the plain version
    assert got.shape == want.shape
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _camera_case(device, dtype, seed=0, D=9, H=8, W=12, C=5, G=6, K=4, Q=50):
    g = torch.Generator().manual_seed(seed)
    depth = torch.softmax(torch.randn(D, H, W, generator=g), 0)
    feat = torch.randn(H, W, C, generator=g)
    coords = torch.rand(K, Q, 3, generator=g) * 2.6 - 1.3
    valid = (torch.rand(K, Q, generator=g) > 0.3).float()
    ids = torch.randperm(G, generator=g)[:K]
    # accumulators as after earlier cameras: sums, and whole counts
    numer = torch.randn(G, Q, C, generator=g)
    denom = torch.randint(0, 6, (G, Q, C), generator=g).float()
    t = dict(depth=depth.to(dtype), feat=feat.to(dtype), ids=ids,
             coords=coords, valid=valid, numer=numer, denom=denom)
    return {k: v.to(device) for k, v in t.items()}


def test_reference_accumulates_in_place():
    """numer/denom gain exactly the sampled, masked values at rows ids; the
    denominator counts the nonzero channels."""
    t = _camera_case('cpu', torch.float32)
    n0, d0 = t['numer'].clone(), t['denom'].clone()
    lift.lift_accumulate_reference(**t)
    K, Q = t['valid'].shape
    from vampire_tpu_torch.core.sampling import sample_outer_product
    v = sample_outer_product(t['depth'], t['feat'],
                             t['coords'].reshape(-1, 3)).reshape(K, Q, -1)
    v = v * t['valid'][..., None]
    np.testing.assert_allclose((t['numer'] - n0)[t['ids']].numpy(),
                               v.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal((t['denom'] - d0)[t['ids']].numpy(),
                                  (v.abs() > 0).float().numpy())
    rest = torch.ones(t['numer'].shape[0], dtype=torch.bool)
    rest[t['ids']] = False
    np.testing.assert_array_equal(t['numer'][rest].numpy(),
                                  n0[rest].numpy())


def _frame_case(device, dtype, seed=0, N=3, D=9, H=8, W=12, C=5, G=6, K=4,
                Q=50, spare=0):
    """One frame of N cameras as `lift_frame_accumulate` takes it, with a
    d numer (G, Q, C) for the backward. Cameras 0 and 1 select the same
    blocks in another order; the last camera's first block has no valid
    query; the last `spare` blocks are selected by no camera."""
    g = torch.Generator().manual_seed(seed)
    depth = torch.softmax(torch.randn(N, D, H, W, generator=g), 1)
    feat = torch.randn(N, H, W, C, generator=g)
    coords = torch.rand(N, K, Q, 3, generator=g) * 2.6 - 1.3
    valid = (torch.rand(N, K, Q, generator=g) > 0.3).float()
    ids = torch.stack([torch.randperm(G - spare, generator=g)[:K]
                       for _ in range(N)])
    ids[1] = ids[0].flip(0)
    valid[-1, 0] = 0.0
    t = dict(depth=depth.to(dtype), feat=feat.to(dtype), ids=ids,
             coords=coords, valid=valid,
             g_numer=torch.randn(G, Q, C, generator=g))
    return {k: v.to(device) for k, v in t.items()}, G


@pytest.mark.parametrize('field,bad,err', [
    ('feat', lambda t: t.to(torch.float64), TypeError),
    ('ids', lambda t: t.to(torch.int32), TypeError),
    ('coords', lambda t: t[..., :2].contiguous(), ValueError),
    ('g_numer', lambda t: t.transpose(0, 1), ValueError),
    ('valid', lambda t: t.to(torch.bfloat16), TypeError),
])
def test_kernel_argument_checks(field, bad, err):
    """The checks the wrappers make before any launch."""
    t, G = _frame_case('cpu', torch.float32)
    t[field] = bad(t[field])
    with pytest.raises(err):
        lift._check(n_blocks=G, **t)


@pytest.mark.parametrize('N,C', [(33, 8), (2, 33), (2, 132)])
def test_kernel_limits(N, C):
    """More cameras than the forward's slot array holds, or more channels
    than a warp's lanes cover, raise before any launch."""
    t, G = _frame_case('cpu', torch.float32, N=N, C=C, Q=3)
    with pytest.raises(ValueError):
        lift._check(n_blocks=G, **t)


def _shifted(t, elements):
    """A contiguous copy of t whose data starts `elements` past an aligned
    allocation."""
    buf = torch.empty(t.numel() + elements, dtype=t.dtype, device=t.device)
    out = buf[elements:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize('dtype,C,field,shift,fwd_ok,bwd_ok', [
    (torch.float32, 16, 'feat', 2, False, False),   # float4 reads: 16 B
    (torch.bfloat16, 16, 'feat', 4, True, True),    # 8-byte reads: 8 B
    (torch.bfloat16, 16, 'feat', 2, False, False),
    (torch.float32, 8, 'feat', 1, True, False),     # forward: scalar reads
    (torch.float32, 5, 'feat', 1, True, True),      # scalar reads both ways
    (torch.float32, 8, 'g_numer', 2, True, False),  # float4 reads: 16 B
])
def test_kernel_alignment(dtype, C, field, shift, fwd_ok, bwd_ok):
    """Each direction asks for the alignment its vector reads need, and no
    more."""
    t, G = _frame_case('cpu', dtype, C=C)
    t[field] = _shifted(t[field], shift)
    g_numer = t.pop('g_numer')
    for ok, extra in ((fwd_ok, {}), (bwd_ok, dict(g_numer=g_numer))):
        if ok:
            lift._check(n_blocks=G, **t, **extra)
        else:
            with pytest.raises(ValueError, match='must start on'):
                lift._check(n_blocks=G, **t, **extra)


def test_frame_reference_is_the_camera_loop():
    """The plain frame versions are the per-camera plain versions in camera
    order, from zero (forward) and stacked (backward); ids outside
    [0, n_blocks) are dropped in both directions, as the kernels ignore
    them."""
    t, G = _frame_case('cpu', torch.float32)
    args = [t[k] for k in ('depth', 'feat', 'ids', 'coords', 'valid')]
    N, K, Q = t['valid'].shape
    C = t['feat'].shape[-1]
    numer = torch.zeros(G, Q, C)
    denom = torch.zeros(G, Q, C)
    for n in range(N):
        lift.lift_accumulate_reference(*(a[n] for a in args), numer, denom)
    got = lift.lift_frame_accumulate_reference(*args, G)
    assert torch.equal(got[0], numer) and torch.equal(got[1], denom)
    want = [lift.lift_backward_reference(*(a[n] for a in args), t['g_numer'])
            for n in range(N)]
    dd, df = lift.lift_frame_backward_reference(*args, t['g_numer'])
    assert torch.equal(dd, torch.stack([w[0] for w in want]))
    assert torch.equal(df, torch.stack([w[1] for w in want]))

    # ids out of range: as if those blocks were not selected
    ids = t['ids'].clone()
    ids[0, 1], ids[2, 3] = G, -1
    args[2] = ids
    keep = torch.ones(N, K, dtype=torch.bool)
    keep[0, 1] = keep[2, 3] = False
    numer.zero_()
    denom.zero_()
    grads = []
    for n in range(N):
        cam = args[0][n], args[1][n], *(a[n][keep[n]] for a in args[2:])
        lift.lift_accumulate_reference(*cam, numer, denom)
        grads.append(lift.lift_backward_reference(*cam, t['g_numer']))
    got = lift.lift_frame_accumulate_reference(*args, G)
    assert torch.equal(got[0], numer) and torch.equal(got[1], denom)
    dd, df = lift.lift_frame_backward_reference(*args, t['g_numer'])
    assert torch.equal(dd, torch.stack([g[0] for g in grads]))
    assert torch.equal(df, torch.stack([g[1] for g in grads]))


def test_frame_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors the frame wrappers are their plain versions and count
    no launch."""
    t, G = _frame_case('cpu', torch.float32)
    args = [t[k] for k in ('depth', 'feat', 'ids', 'coords', 'valid')]
    before = (lift.LAUNCHES, lift.BWD_LAUNCHES)
    got = lift.lift_frame_accumulate(*args, G)
    want = lift.lift_frame_accumulate_reference(*args, G)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = lift.lift_frame_backward(*args, t['g_numer'])
    want = lift.lift_frame_backward_reference(*args, t['g_numer'])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (lift.LAUNCHES, lift.BWD_LAUNCHES) == before


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_gpu(dtype):
    """The frame kernel vs the plain frame version on the same card and
    inputs, one launch a frame: 16 channels (four lanes a query sharing
    the corner weights), 8 and 5 (a lane a channel); cameras 0 and 1
    select the same blocks in another order; ids out of range and blocks
    no camera selected (zeros). Both read the same fp32/bf16 values and
    sum in fp32 in the same order; only FMA contraction differs: 1e-5.
    The counts must match exactly."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    for seed, C, G, K, Q, spare in ((0, 16, 20, 12, 1280, 2),
                                    (1, 8, 9, 9, 300, 0),
                                    (2, 5, 30, 7, 77, 3)):
        t, _ = _frame_case('cuda', dtype, seed=seed, N=6, C=C, G=G, K=K, Q=Q,
                           spare=spare)
        t['ids'][3, 0] = G          # ignored, as in the plain version
        t['ids'][4, 2] = -1
        args = [t[k] for k in ('depth', 'feat', 'ids', 'coords', 'valid')]
        before = lift.LAUNCHES
        numer, denom = lift.lift_frame_accumulate(*args, G)
        assert lift.LAUNCHES == before + 1
        want = lift.lift_frame_accumulate_reference(*args, G)
        torch.cuda.synchronize()
        torch.testing.assert_close(numer, want[0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(denom, want[1], rtol=0, atol=0)
        # the spare blocks: zeros written by the kernel itself
        assert not numer[G - spare:].any() and not denom[G - spare:].any()


@pytest.mark.gpu
def test_kernels_read_8_byte_aligned_bf16_feat_on_gpu():
    """bf16 features that start on 8 bytes but not 16 (a model's feat
    slice can) run in both directions, as the kernels read them 8 bytes at
    a time, and agree with the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    t, G = _frame_case('cuda', torch.bfloat16, seed=5, N=6, C=16, G=20,
                       K=12, Q=300)
    t['feat'] = _shifted(t['feat'], 4)
    assert t['feat'].data_ptr() % 16 == 8
    args = [t[k] for k in ('depth', 'feat', 'ids', 'coords', 'valid')]
    numer, denom = lift.lift_frame_accumulate(*args, G)
    want = lift.lift_frame_accumulate_reference(*args, G)
    torch.testing.assert_close(numer, want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(denom, want[1], rtol=0, atol=0)
    got = lift.lift_frame_backward(*args, t['g_numer'])
    want = lift.lift_frame_backward_reference(*args, t['g_numer'])
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


@pytest.mark.parametrize('n_cams', [1, 6])
def test_bilinear_lift_matches_jax(n_cams):
    """The bilinear variant's lift (depth None: the plain version of the
    depth-less mode) against the JAX bilinear `_lift_compact`, which samples
    each camera's depth-1 feature volume through its corner table; one
    camera alone and six, two batch elements, camera_rig(seed=3). The
    raw features' slope across a pixel is O(1) where the depth-weighted
    ones' is ~1/D, so the geometry's reassociated 4x4 products move a
    sample more than in test_lift_matches_jax: 1e-4 absolute (measured
    2.4e-5 for values O(1))."""
    bc = dataclasses.replace(tiny_config().backbone, variant='bilinear')
    mats = {k: v[:, :n_cams] if v.ndim == 4 else v
            for k, v in camera_rig(2, 6, bc.final_dim, seed=3).items()}
    _, feat = _inputs(bc)
    feat = np.ascontiguousarray(feat[:, :n_cams])
    jax = pytest.importorskip('jax')
    import jax.numpy as jnp
    from vampire_tpu.models.field import FieldBackbone as JaxFieldBackbone
    m = JaxFieldBackbone(bc, dtype=jnp.float32)
    args = (None, jnp.asarray(feat),
            {k: jnp.asarray(v) for k, v in mats.items()})
    v = jax.jit(lambda: m.init(jax.random.PRNGKey(0), *args,
                               method='_lift'))()
    want = np.asarray(jax.jit(lambda: m.apply(v, *args, method='_lift'))())
    fb = FieldBackbone(bc)
    before = (lift.LAUNCHES, lift.BILINEAR_LAUNCHES)
    got = fb.lift(None, torch.from_numpy(feat),
                  {k: torch.from_numpy(v) for k, v in mats.items()})
    got = got.permute(0, 2, 3, 4, 1).numpy()
    assert (lift.LAUNCHES, lift.BILINEAR_LAUNCHES) == before
    assert fb.lift_compact and got.shape == want.shape
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _bilinear_case(device, dtype, **kw):
    """`_frame_case` with the bilinear lift's coords: z = 0."""
    t, G = _frame_case(device, dtype, **kw)
    t['coords'][..., 2] = 0.0
    return t, G


def test_bilinear_plain_is_the_lss_plain_with_ones_depth():
    """With z = 0 and a depth of ones at D = 1, the depth mode's plain
    version computes the depth-less one's terms in the same order: equal
    bit for bit, forward (numer and denom) and backward (d feat)."""
    t, G = _bilinear_case('cpu', torch.float32)
    args = [t[k] for k in ('feat', 'ids', 'coords', 'valid')]
    N, _, H, W = t['depth'].shape
    ones = torch.ones(N, 1, H, W)
    got = lift.bilinear_lift_frame_accumulate_reference(*args, G)
    want = lift.lift_frame_accumulate_reference(ones, *args, G)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].abs().max() > 0.1
    d_feat = lift.bilinear_lift_frame_backward_reference(*args, t['g_numer'])
    _, want = lift.lift_frame_backward_reference(ones, *args, t['g_numer'])
    assert torch.equal(d_feat, want) and d_feat.abs().max() > 0.1


def test_bilinear_plain_backward_is_the_forward_transpose():
    """The depth-less plain backward equals autograd through the plain
    forward's numerator (the same sums in fp32: 1e-6), ids out of range
    dropped as in the forward; `lift_frame(None, ...)` returns no depth
    gradient."""
    t, G = _bilinear_case('cpu', torch.float32)
    t['ids'][2, 1] = G
    feat = t['feat'].clone().requires_grad_(True)
    args = [t[k] for k in ('ids', 'coords', 'valid')]
    numer, denom = lift.lift_frame(None, feat, *args, G)
    assert not denom.requires_grad
    (got,) = torch.autograd.grad(numer, feat, t['g_numer'])
    ref = lift.bilinear_lift_frame_accumulate_reference(
        feat, *args, G)[0]
    (auto,) = torch.autograd.grad(ref, feat, t['g_numer'])
    want = lift.bilinear_lift_frame_backward_reference(t['feat'], *args,
                                                      t['g_numer'])
    assert torch.equal(got, want)
    np.testing.assert_allclose(want.numpy(), auto.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_bilinear_wrappers_check_and_run_the_plain_versions_on_the_cpu():
    """depth=None passes the wrappers' checks (D = 1), runs the depth-less
    plain versions on CPU tensors and counts no launch; a feat of another
    dtype still raises."""
    t, G = _bilinear_case('cpu', torch.float32)
    args = [t[k] for k in ('feat', 'ids', 'coords', 'valid')]
    N, H, W, C = t['feat'].shape
    K, Q = t['valid'].shape[1:]
    assert lift._check(None, *args, G) == (N, 1, H, W, C, K, Q, G)
    before = (lift.BILINEAR_LAUNCHES, lift.BILINEAR_BWD_LAUNCHES,
              lift.LAUNCHES, lift.BWD_LAUNCHES)
    got = lift.lift_frame_accumulate(None, *args, G)
    want = lift.bilinear_lift_frame_accumulate_reference(*args, G)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    d_depth, d_feat = lift.lift_frame_backward(None, *args, t['g_numer'])
    assert d_depth is None and torch.equal(
        d_feat, lift.bilinear_lift_frame_backward_reference(*args,
                                                           t['g_numer']))
    assert (lift.BILINEAR_LAUNCHES, lift.BILINEAR_BWD_LAUNCHES,
            lift.LAUNCHES, lift.BWD_LAUNCHES) == before
    with pytest.raises(TypeError):
        lift._check(None, t['feat'].double(), *args[1:], G)


@pytest.mark.parametrize('N,K,G,seed', [(6, 264, 1024, 0), (3, 5, 9, 1),
                                         (1, 7, 7, 2), (2, 4, 5000, 3)])
def test_slot_map_is_its_definition(N, K, G, seed):
    """The slot map's plain version against its definition, element by
    element: slots[n, ids[n, k]] = k, -1 where no k of camera n selects the
    block, ids outside [0, G) ignored (some are -1 or G and above here); on
    CPU tensors the wrapper is the plain version and counts no launch."""
    rng = np.random.RandomState(seed)
    ids = np.stack([rng.permutation(G + 3)[:K] - 1 for _ in range(N)])
    got = lift.slot_map_reference(torch.from_numpy(ids), G)
    want = np.full((N, G), -1, np.int32)
    for n in range(N):
        for k in range(K):
            if 0 <= ids[n, k] < G:
                want[n, ids[n, k]] = k
    assert got.dtype == torch.int32 and got.shape == (N, G)
    np.testing.assert_array_equal(got.numpy(), want)
    before = lift.SLOT_MAP_LAUNCHES
    assert torch.equal(lift.slot_map(torch.from_numpy(ids), G), got)
    assert lift.SLOT_MAP_LAUNCHES == before


def test_bilinear_backward_routes_by_hand():
    """The depth-less backward's route rule on hand-made CTAs of an 8 x 40
    image: an id outside [0, G) takes no route; a CTA whose valid queries'
    bins (their top-left pixel corners, one before the image counted) span
    at most MAX_BINS sorts, a wider one scatters directly; queries of zero
    validity or wholly outside the image do not widen the box."""
    H, W, G, Q = 8, 40, 10, 6
    ids = torch.tensor([[0, 1, 2, 3, G]])

    def norm(px, size):                 # the pixel coordinate's norm coord
        return (2.0 * px + 1.0) / size - 1.0
    coords = torch.zeros(1, 5, Q, 3)
    valid = torch.ones(1, 5, Q)
    coords[0, :, :, 0] = norm(torch.tensor(3.5), W)
    coords[0, :, :, 1] = norm(torch.tensor(2.5), H)
    # CTA 1: x from -1 to 38 and y from -1 to 6: 8 x 40 bins
    coords[0, 1, 0, :2] = torch.tensor([norm(-0.5, W), norm(-0.5, H)])
    coords[0, 1, 1, :2] = torch.tensor([norm(38.5, W), norm(6.5, H)])
    # CTA 2: the same box, but the far query has no validity and another
    # lies wholly outside the image
    coords[0, 2] = coords[0, 1]
    valid[0, 2, 1] = 0.0
    coords[0, 2, 2, :2] = torch.tensor([norm(-3.0, W), norm(2.5, H)])
    # CTA 3: 32 x 1 bins in a row
    coords[0, 3, 0, 0] = norm(-0.5, W)
    coords[0, 3, 1, 0] = norm(30.5, W)
    got = lift.bilinear_backward_routes_reference((H, W), ids, coords, valid,
                                                  G)
    S, D, Nn = lift.ROUTE_SORTED, lift.ROUTE_DIRECT, lift.ROUTE_NONE
    assert lift.MAX_BINS == 1024
    assert got.tolist() == [[S, S, S, S, Nn]]
    # the same coords in a 200 pixels wide image: CTA 1's bins span x from
    # -1 to 194 (196 x 8 = 1,568 bins); CTA 2's from -1 to 19 (the query
    # at -3 pixels there lies at -13); CTA 3's 156 x 1
    got = lift.bilinear_backward_routes_reference((H, 200), ids, coords,
                                                  valid, G)
    assert got.tolist() == [[S, D, S, S, Nn]]


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_bilinear_kernel_matches_plain_on_gpu(dtype):
    """The depth-less mode of both frame kernels (depth None) vs the plain
    versions on the same card and inputs, one launch each, counted apart
    from the depth mode: 16 channels (four lanes a query, V = 4), 8 and 5
    (a lane a channel); cameras 0 and 1 select the same blocks; ids out of
    range; coords up to 0.3 past the image on each side, and one camera's
    first block wholly outside it (its samples read zeros). Forward: the
    same values summed in fp32 in the same order, only FMA contraction
    differs: 1e-5, counts exact. Backward: fp32 atomics in another order:
    1e-5 of the largest d feat."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    for seed, C, G, K, Q, spare in ((0, 16, 20, 12, 1280, 2),
                                    (1, 8, 9, 9, 300, 0),
                                    (2, 5, 30, 7, 77, 3)):
        t, _ = _bilinear_case('cuda', dtype, seed=seed, N=6, C=C, G=G, K=K,
                              Q=Q, spare=spare)
        t['ids'][3, 0] = G
        t['ids'][4, 2] = -1
        t['coords'][5, 0, :, :2] = 1.5          # a block past the image
        t['valid'][5, 0] = 1.0
        args = [t[k] for k in ('feat', 'ids', 'coords', 'valid')]
        before = (lift.BILINEAR_LAUNCHES, lift.BILINEAR_BWD_LAUNCHES,
                  lift.LAUNCHES, lift.BWD_LAUNCHES)
        numer, denom = lift.lift_frame_accumulate(None, *args, G)
        d_depth, d_feat = lift.lift_frame_backward(None, *args, t['g_numer'])
        assert d_depth is None
        assert (lift.BILINEAR_LAUNCHES, lift.BILINEAR_BWD_LAUNCHES,
                lift.LAUNCHES, lift.BWD_LAUNCHES) == (
                    before[0] + 1, before[1] + 1, before[2], before[3])
        want = lift.bilinear_lift_frame_accumulate_reference(*args, G)
        want_d = lift.bilinear_lift_frame_backward_reference(*args,
                                                            t['g_numer'])
        torch.cuda.synchronize()
        torch.testing.assert_close(numer, want[0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(denom, want[1], rtol=0, atol=0)
        assert not numer[G - spare:].any() and not denom[G - spare:].any()
        assert (d_feat - want_d).abs().max().item() <= \
            1e-5 * want_d.abs().max().item()


@pytest.mark.gpu
def test_slot_map_kernel_matches_plain_on_gpu():
    """The slot-map kernel equals its plain version exactly, one launch a
    call: the flagship's 6 x 264 of 1,024 blocks, ids outside [0, G)
    among them, and 5,000 blocks (two of the kernel's 4,096-block tiles)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    rng = np.random.RandomState(0)
    for N, K, G in ((6, 264, 1024), (3, 40, 5000), (1, 1, 1)):
        ids = torch.from_numpy(np.stack(
            [rng.permutation(G + 3)[:K] - 1 for _ in range(N)])).cuda()
        before = lift.SLOT_MAP_LAUNCHES
        got = lift.slot_map(ids, G)
        assert lift.SLOT_MAP_LAUNCHES == before + 1
        assert torch.equal(got, lift.slot_map_reference(ids, G))


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_bilinear_kernels_take_both_backward_routes_on_gpu(dtype):
    """The depth-less kernels on a 64 x 176 image whose blocks' queries
    either cluster (a few pixels: the backward sorts them into shared bins)
    or spread over the whole image (over MAX_BINS bins: it scatters each
    term directly), at C = 16, 32 (V = 4), 8 and 5 (V = 1 forward at 5):
    each CTA's route equals the plain rule's and both routes are taken;
    the forward within 1e-5 and its counts exact, d feat within 1e-5 of
    the largest (fp32 reductions in another order)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    g = torch.Generator().manual_seed(7)
    N, H, W, G, K, Q = 6, 64, 176, 40, 24, 640
    for C in (16, 32, 8, 5):
        feat = torch.randn(N, H, W, C, generator=g).to(dtype)
        centre = torch.rand(N, K, 1, 2, generator=g) * 2.0 - 1.0
        spread = torch.where(torch.rand(N, K, 1, 1, generator=g) < 0.5,
                             0.05, 1.2)
        xy = centre + spread * (torch.rand(N, K, Q, 2, generator=g) * 2 - 1)
        coords = torch.cat([xy, torch.zeros(N, K, Q, 1)], dim=-1)
        valid = (torch.rand(N, K, Q, generator=g) > 0.2).float()
        ids = torch.stack([torch.randperm(G, generator=g)[:K]
                           for _ in range(N)])
        ids[2, 3] = G
        g_numer = torch.randn(G, Q, C, generator=g)
        t = [x.cuda() for x in (feat, ids, coords, valid)]
        numer, denom = lift.lift_frame_accumulate(None, *t, G)
        want = lift.bilinear_lift_frame_accumulate_reference(*t, G)
        torch.testing.assert_close(numer, want[0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(denom, want[1], rtol=0, atol=0)
        routes = torch.full((N, K), -1, dtype=torch.int32, device='cuda')
        _, d_feat = lift.lift_frame_backward(None, *t, g_numer.cuda(),
                                             routes=routes)
        want_d = lift.bilinear_lift_frame_backward_reference(
            *t, g_numer.cuda())
        torch.cuda.synchronize()
        assert torch.equal(routes, lift.bilinear_backward_routes_reference(
            (H, W), *t[1:], G))
        assert {lift.ROUTE_SORTED, lift.ROUTE_DIRECT,
                lift.ROUTE_NONE} <= set(routes.flatten().tolist())
        assert (d_feat - want_d).abs().max().item() <= \
            1e-5 * want_d.abs().max().item()
