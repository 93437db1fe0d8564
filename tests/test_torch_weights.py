"""`weights.from_flax`: the flax -> torch bridge is complete, and the layouts
it picks are right (SECONDFPN at tiny_config widths pins the spatial flip of
the transposed convolutions)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampire_tpu.data.synthetic import synthetic_batch, tiny_config
from vampire_tpu.models.second_fpn import SECONDFPN as JaxSECONDFPN
from vampire_tpu.models.unet3d import Unet3D as JaxUnet3D
from vampire_tpu.models.vampire import Vampire as JaxVampire
from vampire_tpu_torch.models.second_fpn import SECONDFPN
from vampire_tpu_torch.models.unet3d import Unet3D
from vampire_tpu_torch.models.vampire import Vampire
from vampire_tpu_torch.weights import from_flax


def _random_like(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32), tree)


@pytest.fixture(scope='module')
def tiny_variables():
    """The full tiny model's variable tree (shapes from eval_shape, values
    from numpy: no compile, no run)."""
    cfg = tiny_config()
    b = synthetic_batch(cfg, 1, n_points=16, seed=0, mode='val')
    jm = JaxVampire(cfg.backbone, cfg.head, dtype=jnp.float32)
    mats = {k: jnp.asarray(b[k]) for k in ('sensor2ego', 'intrin', 'ida',
                                           'bda')}
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(b['imgs']), mats,
        points=jnp.asarray(b['points']), train=False))
    v = {k: _random_like(shapes[k], i)
         for i, k in enumerate(('params', 'batch_stats'))}
    return cfg, v


def test_bridge_is_complete(tiny_variables):
    """Every flax leaf lands on exactly one torch entry and every torch
    parameter and buffer is filled."""
    cfg, v = tiny_variables
    tm = Vampire(cfg.backbone, cfg.head)
    sd = from_flax(v, tm)
    n_leaves = len(jax.tree.leaves(v))
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in tm.modules())
    assert len(sd) == n_leaves + n_bn
    tm.load_state_dict(sd, strict=True)
    # values were carried, not left at their init
    np.testing.assert_array_equal(
        tm.backbone.density_beta.detach().numpy(),
        v['params']['backbone']['density_beta'])
    np.testing.assert_array_equal(
        tm.head.task0.heatmap_out.bias.detach().numpy(),
        v['params']['head']['task0']['heatmap_out']['bias'])


def test_bridge_rejects_incomplete_or_extra(tiny_variables):
    cfg, v = tiny_variables
    tm = Vampire(cfg.backbone, cfg.head)
    params = dict(v['params'])
    backbone = dict(params['backbone'])
    del backbone['density_beta']
    with pytest.raises(KeyError, match='density_beta'):
        from_flax(dict(v, params=dict(params, backbone=backbone)), tm)
    extra = dict(params, stray={'kernel': np.zeros((1, 1, 1, 1), np.float32)})
    with pytest.raises(KeyError, match='stray'):
        from_flax(dict(v, params=extra), tm)


def _bn_stats(tree, rng):
    return jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32), tree)


def test_second_fpn_parity_pins_transpose_flip():
    """tiny_config neck: strides (0.5, 1, 2, 4) cover the strided conv, the
    1x1 transposed conv and the 2x2 / 4x4 transposed convs whose kernels
    torch applies flipped. Without the flip the error is O(1); fp32 on both
    sides, so 1e-4 covers the reassociation."""
    bc = tiny_config().backbone
    rng = np.random.RandomState(0)
    chans = bc.img_neck_in_channels
    feats = [rng.randn(2, 16 // 2 ** i, 32 // 2 ** i, c).astype(np.float32)
             for i, c in enumerate(chans)]
    jm = JaxSECONDFPN(chans, bc.img_neck_out_channels,
                      bc.img_neck_upsample_strides)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0),
                               [jnp.asarray(f) for f in feats], False))
    v = dict(v, batch_stats=_bn_stats(v['batch_stats'], rng))
    want = np.asarray(jm.apply(v, [jnp.asarray(f) for f in feats], False))

    tm = SECONDFPN(chans, bc.img_neck_out_channels,
                   bc.img_neck_upsample_strides).eval()
    tm.load_state_dict(from_flax(v, tm), strict=True)
    with torch.no_grad():
        got = tm([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_unet3d_parity():
    """Unet3D: the JAX z-channels (banded 2D conv) execution and the port's
    plain Conv3d share one (3, 3, 3, Cin, Cout) kernel per conv. fp32 on both
    sides, 1e-4 for reassociation over ~14 convs."""
    rng = np.random.RandomState(0)
    x = rng.randn(1, 4, 16, 16, 11).astype(np.float32)    # (B, Z, Y, X, C)
    jm = JaxUnet3D(8)
    v = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = Unet3D(11, 8)
    tm.load_state_dict(from_flax(v, tm), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want,
                               rtol=1e-4, atol=1e-4)
