"""The PyTorch port's forward against the JAX package.

`Vampire(tiny_config(), float32)` is initialised in JAX; its BatchNorm
statistics, BN affine parameters and biases are then randomised from numpy
(fresh statistics are mean 0 / var 1 and would hide a BN mapping bug), the
weights are carried across with `weights.from_flax`, and every output of
`apply(..., camera_renders=False)` (the metrics graph) and of
`apply(..., camera_renders=True)` (the full-render graph, with the camera
rays: through the corner table in JAX, through the channels-last field in
the port) plus the decoded boxes are compared on the same
synthetic batch. Both sides run in fp32 on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampire_tpu.data.synthetic import synthetic_batch, tiny_config
from vampire_tpu.models.centerpoint_head import decode_preds as jax_decode
from vampire_tpu.models.vampire import Vampire as JaxVampire
from vampire_tpu_torch.models.centerpoint_head import decode_preds
from vampire_tpu_torch.models.vampire import Vampire
from vampire_tpu_torch.weights import from_flax

MATS = ('sensor2ego', 'intrin', 'ida', 'bda')
# fp32 on both sides; the two frameworks sum the convolutions, matmuls and
# gathers in different orders, and ~30 layers compound the last-bit
# differences. 1e-4 relative/absolute is ~1000 fp32 ulps of O(1) values and
# far below the error of any layout or mapping mistake (those give O(0.1-1)).
RTOL = ATOL = 1e-4
# the point queries and the camera rays sample a bf16-rounded copy of the
# field on both sides: a last-bit fp32 difference can flip one bf16
# rounding, which moves a sample by up to 2^-8 of the field's magnitude
PTS_KEYS = ('pts_logits', 'pts_sdf')
RENDER_KEYS = ('rgb_preds', 'seg_logits_preds', 'depth_preds')
FIELD_KEYS = ('occ_logits', 'occ_density', 'pts_logits', 'pts_sdf',
              'bev_rgb_preds', 'bev_seg_logits_preds', 'bev_height_preds',
              'bev_density', 'bev_feature')
ALL_KEYS = FIELD_KEYS + RENDER_KEYS


def _randomize(variables, seed=0):
    rng = np.random.RandomState(seed)

    def walk(tree, path=()):
        if hasattr(tree, 'items'):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        a = np.asarray(tree, np.float32)
        name = path[-1]
        if name == 'mean':
            return rng.normal(0.0, 0.2, a.shape).astype(np.float32)
        if name == 'var':
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == 'scale':
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        if name == 'bias':
            return (a + rng.normal(0.0, 0.1, a.shape)).astype(np.float32)
        return a
    return walk(variables)


@pytest.fixture(scope='module')
def both():
    cfg = tiny_config()
    batch = synthetic_batch(cfg, batch_size=1, n_points=128, seed=0,
                            mode='val')
    jm = JaxVampire(cfg.backbone, cfg.head, dtype=jnp.float32)
    jmats = {k: jnp.asarray(batch[k]) for k in MATS}
    jimgs, jpts = jnp.asarray(batch['imgs']), jnp.asarray(batch['points'])
    v = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jimgs, jmats,
                                points=jpts, train=False))()
    variables = _randomize(jax.device_get(v))

    @jax.jit
    def fwd(v):
        fo, preds = jm.apply(v, jimgs, jmats, points=jpts, train=False,
                             camera_renders=False)
        return fo, preds, jax_decode(preds, cfg.head)
    jfo, jpreds, jdec = jax.device_get(fwd(variables))

    tm = Vampire(cfg.backbone, cfg.head, dtype=torch.float32)
    sd = from_flax(variables, tm)
    tm.load_state_dict(sd, strict=True)
    tm.eval()
    with torch.inference_mode():
        tfo, tpreds = tm(torch.from_numpy(batch['imgs']),
                         {k: torch.from_numpy(batch[k]) for k in MATS},
                         points=torch.from_numpy(batch['points']),
                         camera_renders=False)
        tdec = decode_preds(tpreds, cfg.head)
    return cfg, variables, sd, tm, jfo, jpreds, jdec, tfo, tpreds, tdec


@pytest.fixture(scope='module')
def full(both):
    """The full-render graph, camera_renders=True, on the weights of `both`
    and its batch, except the density bias: the JAX init's sdf_bias - 10
    saturates every ray at its first sample, which would hide the
    compositing; a zero bias puts the field's sdf around the density's knee,
    so rays end anywhere from the near to the far plane."""
    cfg, variables, _, _, *_ = both
    variables = jax.tree.map(lambda a: a, variables)
    variables['params']['backbone']['density_conv']['bias'] = np.zeros(
        1, np.float32)
    tm = Vampire(cfg.backbone, cfg.head, dtype=torch.float32)
    tm.load_state_dict(from_flax(variables, tm), strict=True)
    tm.eval()
    batch = synthetic_batch(cfg, batch_size=1, n_points=128, seed=0,
                            mode='val')
    jm = JaxVampire(cfg.backbone, cfg.head, dtype=jnp.float32)
    jfo, jpreds = jax.device_get(jax.jit(lambda v: jm.apply(
        v, jnp.asarray(batch['imgs']),
        {k: jnp.asarray(batch[k]) for k in MATS},
        points=jnp.asarray(batch['points']), train=False,
        camera_renders=True))(variables))
    with torch.inference_mode():
        tfo, tpreds = tm(torch.from_numpy(batch['imgs']),
                         {k: torch.from_numpy(batch[k]) for k in MATS},
                         points=torch.from_numpy(batch['points']),
                         camera_renders=True)
    return jfo, jpreds, tfo, tpreds


def test_bridge_fills_every_parameter(both):
    """from_flax consumes every flax leaf exactly once and fills every torch
    parameter and buffer (load_state_dict(strict=True) passed above)."""
    _, variables, sd, tm, *_ = both
    n_leaves = len(jax.tree.leaves((variables['params'],
                                    variables['batch_stats'])))
    n_bn = sum(k.endswith('num_batches_tracked') for k in sd)
    assert len(sd) == n_leaves + n_bn
    assert set(sd) == set(tm.state_dict())


@pytest.mark.parametrize('key', FIELD_KEYS)
def test_field_output_matches_jax(both, key):
    *_, jfo, _, _, tfo, _, _ = both
    want = np.asarray(jfo[key])
    got = tfo[key].numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    atol = ATOL + (2.0 ** -8 * np.abs(want).max() if key in PTS_KEYS else 0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=key)


@pytest.mark.parametrize('key', ALL_KEYS)
def test_full_render_output_matches_jax(full, key):
    """All 12 outputs of the full-render graph. The points and the three
    camera renders are sampled from a bf16 copy of the field (JAX's corner
    table, the port's channels-last field: the same values), hence the
    2^-8 * max|want| allowance on them, as for PTS_KEYS above."""
    jfo, _, tfo, _ = full
    want = np.asarray(jfo[key])
    got = tfo[key].numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    atol = ATOL
    if key in PTS_KEYS + RENDER_KEYS:
        atol += 2.0 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=key)


def test_full_render_head_preds_match_jax(full):
    _, jpreds, _, tpreds = full
    for jp, tp in zip(jpreds, tpreds):
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


def test_camera_renders_are_none(both):
    *_, jfo, _, _, tfo, _, _ = both
    for k in ('rgb_preds', 'seg_logits_preds', 'depth_preds'):
        assert jfo[k] is None and tfo[k] is None


def test_head_preds_match_jax(both):
    *_, jpreds, _, _, tpreds, _ = both
    assert len(tpreds) == len(jpreds)
    for jp, tp in zip(jpreds, tpreds):
        assert set(jp) == set(tp)
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


def test_lidar_seg_keeps_the_head_in_train_mode(both):
    """`lidar_seg=True` skips the detection head only in eval mode, as the
    JAX module skips it only for `lidar_seg and not train`: in train mode
    the head preds equal the JAX module's `train=True, lidar_seg=True`
    call (BN on batch statistics on both sides), at the tolerance of
    test_head_preds_match_jax; in eval mode the call returns None."""
    cfg, variables, sd, *_ = both
    batch = synthetic_batch(cfg, batch_size=1, n_points=128, seed=0,
                            mode='val')
    jm = JaxVampire(cfg.backbone, cfg.head, dtype=jnp.float32)
    (_, jpreds), _ = jax.device_get(jax.jit(lambda v: jm.apply(
        v, jnp.asarray(batch['imgs']),
        {k: jnp.asarray(batch[k]) for k in MATS},
        points=jnp.asarray(batch['points']), train=True, lidar_seg=True,
        camera_renders=False, mutable=['batch_stats']))(variables))
    tm = Vampire(cfg.backbone, cfg.head, dtype=torch.float32)
    tm.load_state_dict(sd, strict=True)
    args = (torch.from_numpy(batch['imgs']),
            {k: torch.from_numpy(batch[k]) for k in MATS})
    kw = dict(points=torch.from_numpy(batch['points']), lidar_seg=True,
              camera_renders=False)
    with torch.no_grad():
        _, tpreds = tm.train()(*args, **kw)
        assert tm.eval()(*args, **kw)[1] is None
    assert tpreds is not None and len(tpreds) == len(jpreds)
    for jp, tp in zip(jpreds, tpreds):
        assert set(jp) == set(tp)
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


def test_decoded_boxes_match_jax(both):
    """Scores and boxes of the device decode (before host NMS). Scores are
    sigmoid outputs of the head; boxes add exp(dim) and atan2(rot), whose
    values reach ~10, so the same 1e-4 relative tolerance applies."""
    *_, jdec, _, _, tdec = both
    for jd, td in zip(jdec, tdec):
        np.testing.assert_allclose(td['scores'].numpy(),
                                   np.asarray(jd['scores']),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(td['bboxes'].numpy(),
                                   np.asarray(jd['bboxes']),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(td['labels'].numpy(),
                                      np.asarray(jd['labels']))
        np.testing.assert_array_equal(td['valid'].numpy(),
                                      np.asarray(jd['valid']))


def test_decode_preds_same_inputs():
    """decode_preds alone, both implementations on identical head maps:
    exact selection, boxes to fp32 rounding."""
    cfg = tiny_config()
    rng = np.random.RandomState(1)
    preds = []
    for task in cfg.head.tasks:
        d = {k: rng.randn(2, 16, 16, ch).astype(np.float32)
             for k, (ch, _) in cfg.head.common_heads}
        d['heatmap'] = rng.randn(2, 16, 16, len(task)).astype(np.float32)
        preds.append(d)
    want = jax.device_get(jax_decode(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in preds],
        cfg.head))
    got = decode_preds([{k: torch.from_numpy(v) for k, v in p.items()}
                        for p in preds], cfg.head)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g['labels'].numpy(), w['labels'])
        np.testing.assert_array_equal(g['valid'].numpy(), w['valid'])
        np.testing.assert_allclose(g['scores'].numpy(), w['scores'],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(g['bboxes'].numpy(), w['bboxes'],
                                   rtol=1e-5, atol=1e-5)


def _tiny_bc(**kw):
    import dataclasses
    return dataclasses.replace(tiny_config().backbone, **kw)


@pytest.mark.parametrize('kw', [dict(variant='vampire2'),
                                dict(variant='lss'),
                                dict(variant='bilinear'),
                                dict(lift_block=0),
                                dict(lift_block_topk=0)])
def test_unported_configs_raise(kw):
    """The configs that waited for ROADMAP.md Queue 1 item 6 (the other
    variants, the dense lift) are ported now and no longer raise: each
    builds and runs the full-render forward with finite outputs of the
    flagship's shapes (tests/test_torch_variants.py holds them to JAX)."""
    cfg = tiny_config()
    tm = Vampire(_tiny_bc(**kw), cfg.head).eval()
    b = synthetic_batch(cfg, batch_size=1, n_points=8, seed=0, mode='val')
    with torch.inference_mode():
        fo, _ = tm(torch.from_numpy(b['imgs']),
                   {k: torch.from_numpy(b[k]) for k in MATS},
                   points=torch.from_numpy(b['points']))
    assert tm.backbone.lift_compact == ('lift_block' not in kw
                                        and 'lift_block_topk' not in kw)
    gx, gy, gz = cfg.backbone.occ_grid
    assert fo['occ_logits'].shape == (1, gx, gy, gz,
                                      cfg.backbone.num_classes)
    for k in ALL_KEYS:
        assert torch.isfinite(fo[k]).all(), k


@pytest.mark.parametrize('case', ['camera_renders', 'multi_sweep'])
def test_unported_inputs_raise(case):
    """Both inputs that once waited are ported. The camera renders:
    camera_renders=True, the default, returns the three x4-upsampled
    renders. The multi-sweep 6-D input (ROADMAP.md Queue 1 item 6): a
    (B, 2, N, ...) batch runs and renders the key frame's N cameras, with
    the same checks (tests/test_torch_variants.py holds it to JAX)."""
    cfg = tiny_config()
    tm = Vampire(cfg.backbone, cfg.head).eval()
    b = synthetic_batch(cfg, batch_size=1, n_points=8, seed=0, mode='val')
    imgs = torch.from_numpy(b['imgs'])
    mats = {k: torch.from_numpy(b[k]) for k in MATS}
    if case == 'multi_sweep':
        imgs = torch.stack([imgs, imgs.flip(2)], dim=1)
        mats = dict(mats, **{k: torch.stack([mats[k]] * 2, dim=1)
                             for k in ('sensor2ego', 'intrin', 'ida')})
    with torch.inference_mode():
        fo, _ = tm(imgs, mats)
    bc = cfg.backbone
    N, (H, W), K = b['imgs'].shape[1], bc.final_dim, bc.num_classes
    assert fo['rgb_preds'].shape == (1, N, H, W, 3)
    assert fo['seg_logits_preds'].shape == (1, N, H, W, K)
    assert fo['depth_preds'].shape == (1, N, H, W)
    for k in RENDER_KEYS:
        assert torch.isfinite(fo[k]).all()
    depth = fo['depth_preds']
    assert (depth >= bc.d_bound[0]).all() and (depth <= bc.d_bound[1]).all()


def test_early_term_sampler_raises():
    """The opt-in early-term ray sampler is ported (ROADMAP.md Queue 1 item
    7; tests/test_torch_ray_samplers.py holds it to JAX). What still raises
    is what the JAX model raises: a ray_et_fracs tuple whose length is not
    the passes after the prefix, before any geometry is read."""
    from vampire_tpu_torch.models.field import FieldBackbone
    fb = FieldBackbone(_tiny_bc(ray_et_fracs=(1.0,)))
    with pytest.raises(ValueError, match='ray_et_fracs has 1 entries'):
        fb._render_cameras({}, [])
