"""One training step's gradients of the `lss` and `bilinear` variants against
the JAX package's.

Set up as tests/test_torch_variants.py (tiny_config with the variant,
randomised BN and biases, a zero density bias, a rotated, scaled and
flipped bda, fp32 field samples on both sides). Both sides take the
gradient of the step's total loss on the same `synthetic_batch(mode=
'train')` in train mode with the camera renders: `jax.value_and_grad` of
`compute_losses` over the JAX model's params, and `backward()` through the
port, whose lift runs its plain versions here (the bilinear variant's
through the depth-less mode). Compared: every loss term and every
parameter's gradient, in fp32 on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_variants import (MATS, jax_variables, port_model,
                                 train_batch, variant_cfg)
from vampire_tpu.training.losses import compute_losses as jax_losses
from vampire_tpu_torch.training.losses import compute_losses
from vampire_tpu_torch.weights import from_flax

# the loss terms: as the forwards, 1e-4. Gradients: each is a sum over the
# whole frame, back through ~30 layers and the BN batch statistics, in
# another order on each side; 3e-4 of each tensor's largest gradient, as
# tests/test_torch_train_step.py (a mapping mistake is O(1) of it)
RTOL = ATOL = 1e-4
GRAD_RTOL = 3e-4
# bilinear: its forward already differs ~3x more than the other variants'
# (tests/test_torch_variants.py, SCALED_ATOL: a larger field through the
# Laplace density's knee), and the heads' backward carries that on: 250 of
# 252 tensors within 1e-3 of their largest gradient, density_beta 1.25e-3,
# head.task5.heatmap_conv0 2.6e-3 and 3.8e-3 (measured); 1e-2, against a
# mapping mistake's O(1)
VARIANT_GRAD_RTOL = dict(bilinear=1e-2)


@pytest.fixture(scope='module', params=['lss', 'bilinear'])
def grads(request):
    cfg = variant_cfg(request.param)
    batch = train_batch(cfg)
    jm, variables = jax_variables(cfg, batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    bc = cfg.backbone

    def loss_fn(params):
        (fo, preds), _ = jm.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jb['imgs'], {k: jb[k] for k in MATS}, points=jb['points'],
            train=True, mutable=['batch_stats'])
        return jax_losses(fo, preds, jb, cfg.train, cfg.head, bc.sdf_bias,
                          bc.density_mode)
    (_, jlogs), jg = jax.device_get(jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables['params']))

    tm, _ = port_model(cfg, variables)
    tm.train()
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    fo, preds = tm(tb['imgs'], {k: tb[k] for k in MATS}, points=tb['points'])
    total, tlogs = compute_losses(fo, preds, tb, cfg.train, cfg.head,
                                  bc.sdf_bias, bc.density_mode)
    total.backward()
    jgrads = from_flax({'params': jg,
                        'batch_stats': variables['batch_stats']}, tm)
    return dict(tm=tm, tlogs=tlogs, jlogs=jlogs, jgrads=jgrads,
                rtol=VARIANT_GRAD_RTOL.get(request.param, GRAD_RTOL))


def test_variant_losses_match_jax(grads):
    tlogs, jlogs = grads['tlogs'], grads['jlogs']
    assert set(tlogs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(tlogs[k].item(), float(jlogs[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_variant_gradients_match_jax(grads):
    """Every trainable parameter's gradient within GRAD_RTOL (bilinear:
    VARIANT_GRAD_RTOL) of its largest element; the frozen stem gets none on
    either side; the lift's input convs get a nonzero one (through the
    lift's backward)."""
    n, rtol = 0, grads['rtol']
    for name, p in grads['tm'].named_parameters():
        want = grads['jgrads'][name].numpy()
        if '.stem.' in name and 'img_backbone' in name:
            assert p.grad is None and not p.requires_grad
            assert not want.any(), name
            continue
        got = (p.grad if p.grad is not None
               else torch.zeros_like(p)).numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=rtol * scale + 1e-9, err_msg=name)
        n += 1
    assert n > 50
    params = dict(grads['tm'].named_parameters())
    assert params['backbone.channel_lower.weight'].grad.abs().max() > 0
