"""The port's training losses against the JAX package: values and
gradients on the same random field outputs and `synthetic_batch` labels,
fp32 on both sides (the losses are fp32 islands in both packages)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampire_tpu.data.synthetic import synthetic_batch, tiny_config
from vampire_tpu.models import centerpoint_head as jhead
from vampire_tpu.ops import lovasz as jlov
from vampire_tpu.training import losses as jlosses
from vampire_tpu_torch.models import centerpoint_head as thead
from vampire_tpu_torch.ops import lovasz as tlov
from vampire_tpu_torch.training import losses as tlosses

# sums of O(P) fp32 terms in another order, and the Lovász sorts are
# exact: 1e-5 relative on values and gradients, 1e-6 absolute
RTOL, ATOL = 1e-5, 1e-6


def _grad_torch(fn, *arrays):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    v = fn(*ts)
    v.backward()
    return v.item(), [t.grad.numpy() for t in ts]


def _seg_case(seed, P=300, C=7, frac=0.3):
    rng = np.random.RandomState(seed)
    logits = (2.0 * rng.randn(P, C)).astype(np.float32)
    labels = rng.randint(0, C, P).astype(np.int32)
    valid = rng.rand(P) < frac
    return logits, labels, valid


@pytest.mark.parametrize('frac', [0.05, 0.5, 1.0])
def test_ce_lovasz_matches_jax(frac):
    logits, labels, valid = _seg_case(0, frac=frac)
    want, wg = jax.value_and_grad(
        lambda x: jlov.ce_lovasz(x, jnp.asarray(labels),
                                 jnp.asarray(valid)))(jnp.asarray(logits))
    got, (gg,) = _grad_torch(
        lambda x: tlov.ce_lovasz(x, torch.from_numpy(labels),
                                 torch.from_numpy(valid)), logits)
    np.testing.assert_allclose(got, float(want), rtol=RTOL)
    np.testing.assert_allclose(gg, np.asarray(wg), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('frac', [0.0, 0.05, 0.5])
def test_ce_lovasz_compact_matches_jax(frac):
    """The port compacts with boolean indexing and returns exactly
    `ce_lovasz`'s value; JAX compacts to a static cap (here below the
    count for frac 0.5, which takes its dense fallback)."""
    logits, labels, valid = _seg_case(1, frac=frac)
    cap = 64
    want, wg = jax.value_and_grad(
        lambda x: jlov.ce_lovasz_compact(x, jnp.asarray(labels),
                                         jnp.asarray(valid), cap))(
        jnp.asarray(logits))
    got, (gg,) = _grad_torch(
        lambda x: tlov.ce_lovasz_compact(x, torch.from_numpy(labels),
                                         torch.from_numpy(valid)), logits)
    dense = float(tlov.ce_lovasz(torch.from_numpy(logits),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(valid)))
    np.testing.assert_allclose(got, dense, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, float(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gg, np.asarray(wg), rtol=RTOL, atol=ATOL)


def _head_preds(cfg, seed):
    rng = np.random.RandomState(seed)
    H, W = cfg.head.feature_map_size
    preds = []
    for task in cfg.head.tasks:
        d = {k: rng.randn(1, H, W, ch).astype(np.float32)
             for k, (ch, _) in cfg.head.common_heads}
        d['heatmap'] = (rng.randn(1, H, W, len(task)) - 2.0).astype(
            np.float32)
        preds.append(d)
    return preds


@pytest.mark.parametrize('num_devices', [1, 4])
def test_detection_loss_matches_jax(num_devices):
    """Focal + L1 box loss over the tiny head's tasks, with the
    num_devices floors of the normalisers."""
    cfg = tiny_config()
    batch = synthetic_batch(cfg, batch_size=1, n_points=64, seed=2,
                            mode='train')
    preds = _head_preds(cfg, 3)
    keys = [k for k in batch if k.split('_')[0] in ('heatmap', 'anno',
                                                    'ind', 'mask')
            and k != 'mask_camera' and k != 'mask_lidar']
    jt = {k: jnp.asarray(batch[k]) for k in keys}
    tt = {k: torch.from_numpy(np.asarray(batch[k])) for k in keys}
    want, wg = jax.value_and_grad(lambda p: jhead.detection_loss(
        p, jt, cfg.head, num_devices))(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in preds])
    tp = [{k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
          for p in preds]
    got = thead.detection_loss(tp, tt, cfg.head, num_devices)
    got.backward()
    assert any(float(np.asarray(batch[f'mask_{t}']).sum()) > 0
               for t in range(len(preds)))
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    for jp, p in zip(wg, tp):
        for k in p:
            np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(jp[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


def _field_outputs(cfg, seed):
    rng = np.random.RandomState(seed)
    bc = cfg.backbone
    K, N = bc.num_classes, cfg.ida_aug.n_cams
    H, W = bc.final_dim
    _, Y, X = bc.grid_zyx('det')
    gx, gy, gz = bc.occ_grid
    P = 128
    return dict(
        depth_preds=rng.uniform(2.0, 18.0, (1, N, H, W)).astype(np.float32),
        seg_logits_preds=rng.randn(1, N, H, W, K).astype(np.float32),
        bev_height_preds=rng.randn(1, Y, X).astype(np.float32),
        bev_seg_logits_preds=rng.randn(1, Y, X, K).astype(np.float32),
        pts_logits=rng.randn(1, P, K).astype(np.float32),
        pts_sdf=rng.randn(1, P).astype(np.float32),
        occ_logits=rng.randn(1, gx, gy, gz, K).astype(np.float32),
        occ_density=rng.uniform(-1, 1, (1, gx, gy, gz)).astype(np.float32))


@pytest.mark.parametrize('loss_weights', [(1.0, 1.0, 0.0, 0.0, 0.0),
                                          (0.5, 2.0, 0.0, 1.0, 1.0)])
def test_compute_losses_matches_jax(loss_weights):
    """Every log key and the gradient of the total with respect to every
    field output and head map, at the flagship loss weights and at weights
    that switch the sdf and density terms on."""
    import dataclasses
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, loss_weights=loss_weights))
    batch = synthetic_batch(cfg, batch_size=1, n_points=128, seed=4,
                            mode='train')
    fo = _field_outputs(cfg, 5)
    preds = _head_preds(cfg, 6)
    bc = cfg.backbone

    def jloss(fo_, preds_):
        return jlosses.compute_losses(fo_, preds_, {k: jnp.asarray(v)
                                                    for k, v in batch.items()},
                                      cfg.train, cfg.head, bc.sdf_bias,
                                      bc.density_mode)
    (jtotal, jlogs), (jg_fo, jg_pr) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in fo.items()},
        [{k: jnp.asarray(v) for k, v in p.items()} for p in preds])
    tfo = {k: torch.from_numpy(v).requires_grad_() for k, v in fo.items()}
    tpr = [{k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
           for p in preds]
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    total, logs = tlosses.compute_losses(tfo, tpr, tb, cfg.train, cfg.head,
                                         bc.sdf_bias, bc.density_mode)
    total.backward()
    assert set(logs) == set(jlogs)
    for k in logs:
        np.testing.assert_allclose(logs[k].item(), float(jlogs[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    for k, t in tfo.items():
        # an output no active term reads gets no gradient (JAX: zeros)
        got = np.zeros(t.shape, np.float32) if t.grad is None else t.grad
        np.testing.assert_allclose(np.asarray(got), np.asarray(jg_fo[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    for jp, p in zip(jg_pr, tpr):
        for k in p:
            np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(jp[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


def test_rgb_loss_raises():
    """The rgb term is ported (ROADMAP.md Queue 1 item 8); what raises now
    is an image too small for its 5 MS-SSIM scales: at tiny_config's 32 x
    64 renders the JAX term is NaN and the port's raises instead."""
    import dataclasses
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, loss_weights=(1.0, 1.0, 1.0, 0.0, 0.0)))
    batch = synthetic_batch(cfg, batch_size=1, n_points=128, seed=4,
                            mode='train')
    fo = _field_outputs(cfg, 5)
    fo['rgb_preds'] = np.random.RandomState(7).rand(
        *batch['imgs'].shape).astype(np.float32)
    preds = _head_preds(cfg, 6)
    bc = cfg.backbone
    _, jlogs = jlosses.compute_losses(
        {k: jnp.asarray(v) for k, v in fo.items()},
        [{k: jnp.asarray(v) for k, v in p.items()} for p in preds],
        {k: jnp.asarray(v) for k, v in batch.items()}, cfg.train, cfg.head,
        bc.sdf_bias, bc.density_mode)
    assert np.isnan(float(jlogs['rgb_loss']))
    with pytest.raises(ValueError, match='at least 176 pixels'):
        tlosses.compute_losses(
            {k: torch.from_numpy(v) for k, v in fo.items()},
            [{k: torch.from_numpy(v) for k, v in p.items()} for p in preds],
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
            cfg.train, cfg.head, bc.sdf_bias, bc.density_mode)


def test_rgb_loss_matches_jax():
    """The rgb term at renders of 176 x 192 (the least height that carries
    5 MS-SSIM scales), loss weights (1, 1, 1, 0, 0): every log key and the
    total's gradient with respect to every field output, the renders
    included, against the JAX `compute_losses` (values at RTOL; the
    gradients at 1e-4 of each one's largest magnitude, the MS-SSIM
    gradient's fp32 agreement, tests/test_torch_msssim.py)."""
    import dataclasses
    cfg = tiny_config()
    cfg = dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone,
                                          final_dim=(176, 192)),
        train=dataclasses.replace(cfg.train,
                                  loss_weights=(1.0, 1.0, 1.0, 0.0, 0.0)))
    batch = synthetic_batch(cfg, batch_size=1, n_points=128, seed=4,
                            mode='train')
    fo = _field_outputs(cfg, 5)
    # renders near the images, so that MS-SSIM is far from 0 and 1
    rgb = tlosses.denormalize_images(torch.from_numpy(batch['imgs'])).numpy()
    fo['rgb_preds'] = np.clip(rgb + 0.1 * np.random.RandomState(7).randn(
        *rgb.shape), 0, 1).astype(np.float32)
    preds = _head_preds(cfg, 6)
    bc = cfg.backbone

    def jloss(fo_):
        return jlosses.compute_losses(
            fo_, [{k: jnp.asarray(v) for k, v in p.items()} for p in preds],
            {k: jnp.asarray(v) for k, v in batch.items()}, cfg.train,
            cfg.head, bc.sdf_bias, bc.density_mode)
    (_, jlogs), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in fo.items()})
    tfo = {k: torch.from_numpy(v).requires_grad_() for k, v in fo.items()}
    total, logs = tlosses.compute_losses(
        tfo, [{k: torch.from_numpy(v) for k, v in p.items()} for p in preds],
        {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
        cfg.train, cfg.head, bc.sdf_bias, bc.density_mode)
    total.backward()
    assert 0.05 < float(jlogs['rgb_loss']) < 1.0
    assert set(logs) == set(jlogs)
    for k in logs:
        np.testing.assert_allclose(logs[k].item(), float(jlogs[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    for k, t in tfo.items():
        want = np.asarray(jg[k])
        got = np.zeros(t.shape, np.float32) if t.grad is None else t.grad
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)
