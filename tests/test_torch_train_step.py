"""One whole training step of the port against the JAX `build_train_step`.

`Vampire(tiny_config())` is initialised in JAX, its BN statistics, BN
affine parameters and biases are randomised from numpy (as in
test_torch_model.py), the density bias is zeroed (the init's
sdf_bias - 10 saturates every ray at its first sample, so the ray backward
would pass almost nothing on), and the weights are carried across with
`weights.from_flax`. Both sides then take one step on the same
`synthetic_batch(mode='train')`: forward in train mode with the camera
renders, all losses, backward, clipping, AdamW and EMA, in fp32 on the CPU.
The JAX model samples an fp32 corner table here (its `sample_dtype`, bf16 by
default, set through a subclass in this file), and the port's
`sample_dtype` matches (its channels-last field is fp32), so that no bf16
rounding of the field's or the table's cotangent hides a difference
downstream of the renders.

Compared: every `logs` entry, every parameter's gradient (the JAX gradient
read off AdamW's first moment, mu = (1 - b1) * g after one step, passed
through `from_flax`), the parameters and the EMA after the step, the new BN
statistics and both confusion matrices. The JAX side is compiled once per
batch shape, in a module fixture: B = 1 (`steps`), and B = 2 (`steps_b2`)
on the two rows that `tests/test_torch_parallel.py` splits over two ranks,
so that the two-rank step is held to the JAX step through the one-process
step at B = 2.
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vampire_tpu.data.synthetic import synthetic_batch, tiny_config
from vampire_tpu.models.centerpoint_head import BEVDepthHead
from vampire_tpu.models.field import FieldBackbone as JaxFieldBackbone
from vampire_tpu.models.vampire import Vampire as JaxVampire
from vampire_tpu.training import train_state as jts
from vampire_tpu.training.train_step import (build_train_step as jax_step,
                                             init_train_confusion)
from vampire_tpu_torch.models.vampire import Vampire
from vampire_tpu_torch.training import train_state as tts
from vampire_tpu_torch.training.train_step import (build_train_step,
                                                   init_train_confusion
                                                   as torch_confusion)
from vampire_tpu_torch.training.trainer import Trainer
from vampire_tpu_torch.weights import from_flax

# fp32 on both sides. Forward values: as test_torch_model.py, 1e-4.
RTOL = ATOL = 1e-4
# gradients: each is a sum over the whole frame, back through ~30 layers and
# the BN batch statistics, in another order on each side; allow 3e-4 of each
# tensor's largest gradient (measured: at most 6e-5; a layout or mapping
# mistake is O(1) of it)
GRAD_RTOL = 3e-4


class _JaxVampireF32Table(JaxVampire):
    """The JAX model with an fp32 corner table (FieldBackbone.sample_dtype);
    parameter names and everything else as JaxVampire."""

    def setup(self):
        self.backbone = JaxFieldBackbone(self.backbone_cfg, dtype=self.dtype,
                                         sample_dtype=jnp.float32,
                                         name='backbone')
        self.head = BEVDepthHead(self.head_cfg, name='head')


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


def _cfg():
    cfg = tiny_config()
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, use_ema=True))


def _adam_mu(opt_state):
    for leaf in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, 'mu')):
        if hasattr(leaf, 'mu'):
            return leaf.mu
    raise AssertionError('no Adam state')


def _two_rows(cfg):
    """[a, b] of tests/test_torch_parallel.py: synthetic seeds 1 and 2, row
    b without 20 of its valid points and 10 of its camera-mask voxels."""
    rows = [synthetic_batch(cfg, batch_size=1, n_points=128, seed=s,
                            mode='train') for s in (1, 2)]
    for k, n in (('point_valid', 20), ('mask_camera', 10)):
        m = np.array(rows[1][k]).reshape(-1)
        m[np.flatnonzero(m)[:n]] = False
        rows[1][k] = m.reshape(np.shape(rows[1][k]))
    return {k: np.concatenate([np.asarray(r[k]) for r in rows])
            for k in rows[0]}


@pytest.fixture(scope='module')
def steps():
    cfg = _cfg()
    return _steps(cfg, synthetic_batch(cfg, batch_size=1, n_points=128,
                                       seed=0, mode='train'))


@pytest.fixture(scope='module')
def steps_b2():
    cfg = _cfg()
    return _steps(cfg, _two_rows(cfg))


def _steps(cfg, batch):
    jm = _JaxVampireF32Table(cfg.backbone, cfg.head, dtype=jnp.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    mats = {k: jb[k] for k in ('sensor2ego', 'intrin', 'ida', 'bda')}
    v = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jb['imgs'], mats,
                                points=jb['points'], train=False))()
    variables = _randomize(jax.device_get(v))
    variables['params']['backbone']['density_conv']['bias'] = np.zeros(
        1, np.float32)
    jstate, tx = jts.create_train_state(variables['params'],
                                        variables['batch_stats'], cfg.train,
                                        steps_per_epoch=1)
    step = jax.jit(jax_step(jm, cfg, tx, 1, with_metrics=True))
    new, jlogs, jconf = jax.device_get(step(jstate, jb,
                                            init_train_confusion(cfg)))
    jgrads = jax.tree.map(lambda m: np.asarray(m, np.float64) / 0.1,
                          _adam_mu(new.opt_state))

    tm = Vampire(cfg.backbone, cfg.head, dtype=torch.float32)
    tm.backbone.sample_dtype = torch.float32
    tm.load_state_dict(from_flax(variables, tm), strict=True)
    state = tts.create_train_state(tm, cfg.train, steps_per_epoch=1)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    state, tlogs, tconf = build_train_step(cfg)(state, tb,
                                                torch_confusion(cfg))

    def mapped(params):
        return from_flax({'params': params,
                          'batch_stats': new.batch_stats}, tm)
    return dict(cfg=cfg, tm=tm, state=state, tlogs=tlogs, tconf=tconf,
                jlogs=jlogs, jconf=jconf, jgrads=mapped(jgrads),
                jparams=mapped(new.params),
                jema=mapped(new.ema_params),
                jbn=from_flax({'params': new.params,
                               'batch_stats': new.batch_stats}, tm),
                old=from_flax(variables, tm))


def _params(tm):
    return dict(tm.named_parameters())


def test_logs_match_jax(steps):
    """Every loss term, the total and the pre-clip grad_norm."""
    _check_logs(steps)


def _check_logs(steps):
    tlogs, jlogs = steps['tlogs'], steps['jlogs']
    assert set(tlogs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(tlogs[k].item(), float(jlogs[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert float(jlogs['grad_norm']) > 0


def test_gradients_match_jax(steps):
    """Every trainable parameter's (clipped) gradient, within GRAD_RTOL of
    its largest element; the frozen stem gets none on either side."""
    _check_gradients(steps)


def _check_gradients(steps):
    n = 0
    for name, p in _params(steps['tm']).items():
        want = steps['jgrads'][name].numpy()
        if '.stem.' in name and 'img_backbone' in name:
            assert p.grad is None and not p.requires_grad
            assert not want.any(), name
            continue
        got = p.grad.numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * scale + 1e-9,
                                   err_msg=name)
        n += 1
    assert n > 50


def test_density_beta_gradient_from_the_renders(steps):
    """density_beta gets a nonzero gradient, as in JAX: the renders'
    losses reach it through the ray kernel's backward (the occupancy and
    BEV densities reach it too)."""
    g = _params(steps['tm'])['backbone.density_beta'].grad
    want = float(steps['jgrads']['backbone.density_beta'])
    assert abs(want) > 1e-6
    np.testing.assert_allclose(g.item(), want, rtol=GRAD_RTOL)


def test_params_and_ema_after_the_step_match_jax(steps):
    """AdamW's first step moves each element by ~lr * sign(g) (plus the
    decay), so elements whose gradient is near 0 can move differently;
    the absolute tolerance is 2 lr beyond the forward's 1e-4 relative."""
    _check_params(steps)


def _check_params(steps):
    lr = steps['cfg'].train.lr
    for name, p in _params(steps['tm']).items():
        for got, want in ((p.detach(), steps['jparams'][name]),
                          (steps['state'].ema_params[name],
                           steps['jema'][name])):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                       atol=2 * lr, err_msg=name)
        # a tensor moves iff it has a nonzero gradient: AdamW's decay alone
        # (lr * 1e-7 of the value) is below fp32 resolution. rgb_conv has
        # none (the rgb loss weight is 0), and taps that only read the zero
        # padding of a 1x2 map have none either, so not every element moves
        moved = bool((p.detach() != steps['old'][name]).any())
        assert moved == bool(steps['jgrads'][name].numpy().any()), name
    assert not steps['jgrads']['backbone.rgb_conv.weight'].numpy().any()


def test_batchnorm_statistics_after_the_step_match_jax(steps):
    """The running statistics after one train-mode forward: flax momentum
    0.9 (image backbone, head) and 0.99 (SECONDFPN), biased variance."""
    _check_batchnorm(steps)


def _check_batchnorm(steps):
    sd = steps['tm'].state_dict()
    n = 0
    for k, v in sd.items():
        if k.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(v.numpy(), steps['jbn'][k].numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
            n += 1
    assert n > 20


def test_confusion_matrices_match_jax(steps):
    _check_confusions(steps)


def _check_confusions(steps):
    for got, want in zip(steps['tconf'], steps['jconf']):
        assert got.sum().item() > 0
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('check', [
    _check_logs, _check_gradients, _check_params, _check_batchnorm,
    _check_confusions], ids=lambda f: f.__name__[len('_check_'):])
def test_batch_of_two_matches_jax(steps_b2, check):
    """The one-process step at B = 2 on the rows of the two-rank test,
    against the JAX step on the same batch, with the same checks and
    tolerances as at B = 1."""
    check(steps_b2)


# ---------------------------------------------------------------------------
# port-only checks of the step and the trainer
# ---------------------------------------------------------------------------

def _tiny_fp32(**train):
    cfg = tiny_config()
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, compute_dtype='float32', **train))


def test_frozen_stem_takes_no_gradient_and_keeps_its_statistics():
    """In train mode the stem's BN normalises with its running statistics
    and leaves them as they are, its output is detached and its parameters
    are outside the optimizer; the next layer's BN statistics do move."""
    cfg = _tiny_fp32()
    tm = Vampire(cfg.backbone, cfg.head)
    tts_state = tts.create_train_state(tm, cfg.train, steps_per_epoch=1)
    stem = tm.backbone.img_backbone.stem
    before = {k: v.clone() for k, v in stem.state_dict().items()}
    nxt = tm.backbone.img_backbone.layer1_0.conv1.bn.running_mean.clone()
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in
             synthetic_batch(cfg, batch_size=1, n_points=128, seed=1,
                             mode='train').items()}
    build_train_step(cfg)(tts_state, batch, torch_confusion(cfg))
    assert tm.training and not stem.training and not stem.bn.training
    for k, v in stem.state_dict().items():
        assert torch.equal(v, before[k]), k
    for p in stem.parameters():
        assert not p.requires_grad and p.grad is None
    opt_ids = {id(p) for g in tts_state.optimizer.param_groups
               for p in g['params']}
    assert not opt_ids & {id(p) for p in stem.parameters()}
    assert not torch.equal(
        tm.backbone.img_backbone.layer1_0.conv1.bn.running_mean, nxt)


def test_lr_schedule_matches_optax():
    """piecewise_constant_schedule scales every update from step
    milestone * steps_per_epoch on (0-based count)."""
    cfg = dataclasses.replace(tiny_config().train, lr_milestones=(1, 3))
    sched = jts.make_lr_schedule(cfg, steps_per_epoch=2)
    for step in range(9):
        np.testing.assert_allclose(tts.lr_at(cfg, 2, step),
                                   float(sched(step)), rtol=1e-6)
    assert tts.lr_at(cfg, 2, 1) == cfg.lr and tts.lr_at(cfg, 2, 2) < cfg.lr


@pytest.mark.parametrize('scale', [0.1, 1.0, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    """g / norm * max when norm >= max, with no epsilon."""
    rng = np.random.RandomState(0)
    grads = [rng.randn(*s).astype(np.float32) * scale
             for s in ((5, 3), (7,), (2, 2, 2))]
    max_norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                 for g in grads)) / 1.0) if scale == 1.0 \
        else 5.0
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = tts.clip_by_global_norm_(got, max_norm)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(
        [jnp.asarray(g) for g in grads])), rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_ema_update_matches_jax():
    rng = np.random.RandomState(1)
    ema = {'a': rng.randn(4, 3).astype(np.float32)}
    params = {'a': rng.randn(4, 3).astype(np.float32)}
    want = jts.ema_update({'a': jnp.asarray(ema['a'])},
                          {'a': jnp.asarray(params['a'])}, jnp.int32(7),
                          0.99)
    m = torch.nn.Module()
    m.a = torch.nn.Parameter(torch.from_numpy(params['a']))
    got = {'a': torch.from_numpy(ema['a'].copy())}
    tts.ema_update(got, m, 7, 0.99)
    np.testing.assert_allclose(got['a'].numpy(), np.asarray(want['a']),
                               rtol=1e-6, atol=1e-7)


def test_trainer_fit_resumes_to_the_same_params():
    """`Trainer.fit` over a list loader of 2 batches: 2 epochs straight,
    against 1 epoch then a new Trainer that resumes from the epoch-0
    state_dict checkpoint and runs epoch 1. The CPU's float ops are
    deterministic, so the two end bit-identical."""
    loader = [synthetic_batch(tiny_config(), batch_size=1, n_points=128,
                              seed=s, mode='train') for s in (3, 4)]
    ends = []
    for epochs in ((2,), (1, 2)):
        with tempfile.TemporaryDirectory() as d:
            for n in epochs:
                tr = Trainer(_tiny_fp32(max_epochs=n), workdir=d,
                             device='cpu')
                state = tr.fit(loader, log_every=1)
            assert tr.saved_epochs() == [0, 1]
            ends.append((state.step, {k: v.clone() for k, v in
                                      state.model.state_dict().items()}))
    assert ends[0][0] == ends[1][0] == 4
    for k, v in ends[0][1].items():
        assert torch.equal(v, ends[1][1][k]), k


def test_trainer_finetune_restarts_the_optimizer():
    """`fit(finetune_from=0)` seeds a fresh run with the epoch-0 weights:
    the step count and AdamW restart, the EMA restarts from the loaded
    weights, and the run trains on from them."""
    loader = [synthetic_batch(tiny_config(), batch_size=1, n_points=128,
                              seed=s, mode='train') for s in (3, 4)]
    cfg = _tiny_fp32(max_epochs=1, use_ema=True)
    with tempfile.TemporaryDirectory() as d:
        first = Trainer(cfg, workdir=d, device='cpu').fit(loader)
        saved = {k: v.clone() for k, v in first.model.state_dict().items()}
        tr = Trainer(cfg, workdir=d, device='cpu')
        loaded = []
        state = tr.init_state(loader[0], len(loader))
        state.optimizer.register_step_pre_hook(
            lambda opt, *_: loaded.append((
                {k: v.clone() for k, v in state.model.state_dict().items()},
                {k: v.clone() for k, v in state.ema_params.items()},
                len(opt.state))) if not loaded else None)
        state = tr.fit(loader, state=state, resume=False, finetune_from=0)
        assert state.step == 2 and tr.saved_epochs() == [0]
    weights, ema, n_adam = loaded[0]
    assert n_adam == 0                      # a fresh AdamW
    for k, v in saved.items():              # the step started from epoch 0
        if 'running_' in k or 'num_batches' in k:
            continue                        # moved by the step's forward
        assert torch.equal(weights[k], v), k
        if k in ema:
            assert torch.equal(ema[k], v), k
    assert any(not torch.equal(p.detach(), saved[k])
               for k, p in state.model.named_parameters())


def test_fit_with_a_val_loader_raises():
    """`fit` validates after the epoch (check_val_every_n_epoch=1 here) and
    an error of the validation propagates: a val batch without
    occ_semantics raises out of `fit`, after the epoch's checkpoint."""
    cfg = _tiny_fp32(max_epochs=1, check_val_every_n_epoch=1)
    train = [synthetic_batch(cfg, batch_size=1, n_points=128, seed=3,
                             mode='train')]
    val = {k: v for k, v in synthetic_batch(
        cfg, batch_size=1, n_points=128, seed=4, mode='val').items()
        if k != 'occ_semantics'}
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(cfg, workdir=d, device='cpu')
        with pytest.raises(KeyError, match='occ_semantics'):
            tr.fit(train, val_loader=[val])
        assert tr.saved_epochs() == [0]
