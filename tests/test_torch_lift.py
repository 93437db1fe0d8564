"""The lift: the port's plain version against the JAX `FieldBackbone._lift`,
and (on a card only) the CUDA kernel against the plain version.

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


@pytest.mark.parametrize('field,bad,err', [
    ('feat', lambda t: t.to(torch.float64), TypeError),
    ('ids', lambda t: t.to(torch.int32), TypeError),
    ('coords', lambda t: t[:, :, :2].contiguous(), ValueError),
    ('numer', lambda t: t.transpose(0, 1), ValueError),
    ('valid', lambda t: t.to(torch.bfloat16), TypeError),
])
def test_kernel_argument_checks(field, bad, err):
    """The checks the wrapper makes before any launch."""
    t = _camera_case('cpu', torch.float32)
    t[field] = bad(t[field])
    with pytest.raises(err):
        lift._check(**t)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_gpu(dtype):
    """The CUDA kernel vs the plain version on the same card and inputs.
    Both read the same fp32/bf16 values and sum in fp32 in the same order;
    only FMA contraction differs: 1e-5. The count must match exactly."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    for seed in range(3):
        t = _camera_case('cuda', dtype, seed=seed)
        ref = {k: v.clone() for k, v in t.items()}
        before = lift.LAUNCHES
        lift.lift_accumulate_(**t)
        assert lift.LAUNCHES == before + 1
        lift.lift_accumulate_reference(**ref)
        torch.cuda.synchronize()
        torch.testing.assert_close(t['numer'], ref['numer'], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(t['denom'], ref['denom'], rtol=0, atol=0)
