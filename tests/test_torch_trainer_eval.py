"""The port's eval steps and the Trainer's evaluation paths against the JAX
package, on the CPU at `tiny_config` in fp32.

The JAX model is initialised, its BN statistics, BN affine parameters and
biases randomised from numpy (test_torch_model.py's `_randomize`), and the
weights carried across with `weights.from_flax`. Both `build_eval_step`
(lidar_seg=False: logits, occ_density and the decoded boxes) and
`build_metric_eval_step` (the two confusion matrices) then run on the same
synthetic batch on both sides. The Trainer tests drive `fit` with a
`val_loader`, `validate` with the EMA, `test`, `predict` and
`test(vis=True)` through a duck-typed loader whose batches carry the `meta`,
`num_points` and `sample_valid` of a real loader and whose `dataset` gives
seeded global-frame GT boxes.
"""
import dataclasses
import json
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import ATOL, MATS, RTOL, _randomize
from vampire_tpu.data.synthetic import synthetic_batch, tiny_config
from vampire_tpu.models.vampire import Vampire as JaxVampire
from vampire_tpu.parallel.mesh import make_mesh
from vampire_tpu.training import train_step as jax_steps
from vampire_tpu.training.trainer import Trainer as JaxTrainer
from vampire_tpu_torch.models.vampire import Vampire, init_params_
from vampire_tpu_torch.training import train_state as tts
from vampire_tpu_torch.training.train_step import (build_eval_step,
                                                   build_metric_eval_step,
                                                   eval_confusions)
from vampire_tpu_torch.training.trainer import Trainer
from vampire_tpu_torch.weights import from_flax

DET_KEYS = ('bboxes', 'scores', 'labels', 'valid')


def _tiny_fp32(**train):
    cfg = tiny_config()
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, compute_dtype='float32', **train))


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()
            if k != 'meta'}


def _stack(frames, valid):
    """Frames (B=1 batches) stacked into one batch, with sample_valid."""
    out = {k: np.concatenate([f[k] for f in frames]) for k in frames[0]}
    out['sample_valid'] = np.asarray(valid, bool)
    return out


@pytest.fixture(scope='module')
def steps():
    """The JAX and port eval steps on one batch (B=1, seed 0)."""
    cfg = _tiny_fp32()
    batch = synthetic_batch(cfg, batch_size=1, n_points=128, seed=0,
                            mode='val')
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JaxVampire(cfg.backbone, cfg.head, dtype=jnp.float32)
    v = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jb['imgs'],
                                {k: jb[k] for k in MATS},
                                points=jb['points'], train=False))()
    variables = _randomize(jax.device_get(v))
    args = (variables['params'], variables['batch_stats'], jb)
    jout = jax.device_get(jax.jit(jax_steps.build_eval_step(
        jm, cfg, lidar_seg=False))(*args))
    jconf = jax.device_get(jax.jit(jax_steps.build_metric_eval_step(
        jm, cfg))(*args))
    tm = Vampire(cfg.backbone, cfg.head, dtype=torch.float32)
    tm.load_state_dict(from_flax(variables, tm), strict=True)
    tb = _torch(batch)
    tout = build_eval_step(tm, cfg, lidar_seg=False)(tb)
    tconf = build_metric_eval_step(tm, cfg)(tb)
    return dict(cfg=cfg, batch=batch, variables=variables, tm=tm, jout=jout,
                jconf=jconf, tout=tout, tconf=tconf)


def test_eval_step_outputs_match_jax(steps):
    """pts_logits, occ_logits and occ_density at test_torch_model.py's
    tolerances (the points sample a bf16 copy of the field: 2^-8 of the
    largest logit more); the model is left in eval mode."""
    jout, tout = steps['jout'], steps['tout']
    assert not steps['tm'].training
    for k in ('pts_logits', 'occ_logits', 'occ_density'):
        want = np.asarray(jout[k])
        got = tout[k].numpy()
        assert got.shape == want.shape and not tout[k].requires_grad
        atol = ATOL + (2.0 ** -8 * np.abs(want).max()
                       if k == 'pts_logits' else 0)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol,
                                   err_msg=k)


def test_eval_step_decoded_boxes_match_jax(steps):
    for jd, td in zip(steps['jout']['det'], steps['tout']['det']):
        for k in DET_KEYS:
            got, want = td[k].numpy(), np.asarray(jd[k])
            if k in ('labels', 'valid'):
                np.testing.assert_array_equal(got, want, err_msg=k)
            else:
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                           err_msg=k)
    assert sum(int(np.asarray(d['valid']).sum())
               for d in steps['jout']['det']) > 0


def _near_ties(logits, mask, atol):
    """Elements under `mask` whose two largest logits lie so close that
    each moving by the comparison's tolerance (atol + RTOL |value|) could
    swap them."""
    s = np.sort(logits.reshape(-1, logits.shape[-1]), axis=-1)
    top, second = s[:, -1], s[:, -2]
    room = 2 * atol + RTOL * (np.abs(top) + np.abs(second))
    return int(((top - second <= room) & mask.reshape(-1)).sum())


def test_metric_step_confusions_match_jax(steps):
    """Both confusions equal the JAX step's in every entry, except for the
    elements whose JAX top-two logits are a near-tie within the logits'
    tolerance: the number of elements counted elsewhere must not exceed
    the number of such near-ties."""
    b, jout = steps['batch'], steps['jout']
    pts = np.asarray(jout['pts_logits'])
    seg_mask = b['point_valid'] & (b['point_labels'] != 0)
    ties = (_near_ties(pts[..., 1:-1], seg_mask,
                       ATOL + 2.0 ** -8 * np.abs(pts).max()),
            _near_ties(np.asarray(jout['occ_logits']), b['mask_camera'],
                       ATOL))
    totals = (int(seg_mask.sum()), int(b['mask_camera'].sum()))
    for got, want, n_ties, total in zip(steps['tconf'], steps['jconf'],
                                        ties, totals):
        got, want = got.numpy(), np.asarray(want)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert got.sum() == want.sum() == total
        moved = np.abs(got - want).sum() / 2
        assert moved <= n_ties, (moved, n_ties)


def test_padded_row_counts_nowhere(steps):
    """A B=2 batch whose second row has sample_valid=False gives the first
    row's confusions exactly; and eval_confusions of the padded batch's
    own forward equals that of its first row alone."""
    cfg, tm = steps['cfg'], steps['tm']
    other = synthetic_batch(cfg, batch_size=1, n_points=128, seed=5,
                            mode='val')
    padded = _torch(_stack([steps['batch'], other], [True, False]))
    got = build_metric_eval_step(tm, cfg)(padded)
    for g, w in zip(got, steps['tconf']):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    fo = build_eval_step(tm, cfg)(padded)
    first = eval_confusions({k: v[:1] for k, v in fo.items()},
                            {k: v[:1] for k, v in padded.items()
                             if k != 'sample_valid'},
                            cfg.backbone.num_classes)
    for g, w in zip(eval_confusions(fo, padded, cfg.backbone.num_classes),
                    first):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


# ---------------------------------------------------------------------------
# the Trainer's evaluation paths
# ---------------------------------------------------------------------------

def _frame(cfg, seed, token):
    """A val-mode synthetic frame with what a real loader adds: the meta
    (tokens and ego pose) and the number of points before padding."""
    b = synthetic_batch(cfg, batch_size=1, n_points=128, seed=seed,
                        mode='val')
    rng = np.random.RandomState(seed)
    q = rng.randn(4)
    b['meta'] = dict(token=[token], lidar_token=[f'lidar_{token}'],
                     ego2global_rotation=[(q / np.linalg.norm(q)).tolist()],
                     ego2global_translation=[rng.uniform(-500, 500,
                                                         3).tolist()])
    b['num_points'] = np.array([rng.randint(1, 129)])
    return b


def _batch(frames, valid):
    out = _stack([{k: v for k, v in f.items() if k != 'meta'}
                  for f in frames], valid)
    out['meta'] = {k: sum((f['meta'][k] for f in frames), [])
                   for k in frames[0]['meta']}
    return out


class _GT:
    """The loader's dataset: seeded global-frame GT boxes per token."""

    def __init__(self, tokens, seed=0):
        rng = np.random.RandomState(seed)
        self.boxes = {}
        for t in tokens:
            ego = rng.uniform(-500, 500, 3)
            boxes = []
            for _ in range(6):
                et = np.r_[rng.uniform(-4, 4, 2), 0.0]
                yaw = rng.uniform(-np.pi, np.pi)
                boxes.append(dict(
                    translation=(ego + et).tolist(),
                    ego_translation=et.tolist(),
                    size=rng.uniform(0.5, 4, 3).tolist(),
                    rotation=[np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)],
                    velocity=rng.uniform(-2, 2, 2).tolist(),
                    detection_name='car', attribute_name='vehicle.parked',
                    num_pts=3))
            self.boxes[t] = boxes

    def global_gt_boxes(self):
        return self.boxes


class _Loader(list):
    """A list of batches with a `dataset`, as Trainer.test reads GT."""

    def __init__(self, batches, dataset=None):
        super().__init__(batches)
        self.dataset = dataset


@pytest.fixture(scope='module')
def eval_loader():
    """Two B=2 batches: frames a, b and c, then one padding row."""
    cfg = _tiny_fp32()
    f = [_frame(cfg, 20 + i, t) for i, t in enumerate('abcd')]
    return _Loader([_batch(f[:2], [True, True]),
                    _batch(f[2:], [True, False])], _GT('abcd'))


def _trainer(tmp_path, name, **train):
    cfg = _tiny_fp32(exp_name=name, **train)
    tr = Trainer(cfg, workdir=str(tmp_path), device='cpu')
    return tr, tr.init_state(None, 1)


def test_validate_scores_the_ema_weights(tmp_path, eval_loader):
    """With use_ema=True, validate scores the EMA (here another seeded
    init, far from the weights) with the model's own BN statistics: the
    same numbers as a model holding the EMA weights. The weights are
    bit-equal afterwards and the model is back in train mode, its frozen
    stem still in eval mode."""
    tr, state = _trainer(tmp_path, 'ema', use_ema=True)
    model = state.model
    ema = Vampire(tr.cfg.backbone, tr.cfg.head)
    init_params_(ema, torch.Generator().manual_seed(7))
    state.ema_params = {k: p.detach().clone()
                        for k, p in ema.named_parameters()}
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    got = tr.validate(eval_loader, state)
    for k, p in model.named_parameters():
        assert torch.equal(p, before[k]), k
    stem = model.backbone.img_backbone.stem
    assert model.training and not stem.training and not stem.bn.training
    params = dict(ema.named_parameters())
    ema.load_state_dict({k: v for k, v in model.state_dict().items()
                         if k not in params}, strict=False)
    want = tr.validate(eval_loader, tts.create_train_state(ema, tr.cfg.train,
                                                           1), use_ema=False)
    assert got == want
    assert got != tr.validate(eval_loader, state, use_ema=False)
    assert set(got) == {'val/mIoU', 'val/occ_mIoU'}
    assert all(np.isnan(v) or 0 <= v <= 1 for v in got.values())


def test_fit_validates_every_check_val_every_n_epoch(tmp_path, eval_loader):
    """max_epochs=4, check_val_every_n_epoch=2: `val/*` records after
    epochs 2 and 4 only (one step an epoch)."""
    cfg = _tiny_fp32(max_epochs=4, check_val_every_n_epoch=2)
    train = [synthetic_batch(cfg, batch_size=1, n_points=128, seed=3,
                             mode='train')]
    tr = Trainer(cfg, workdir=str(tmp_path), device='cpu')
    tr.fit(train, val_loader=eval_loader, log_every=1)
    with open(os.path.join(tr.workdir, 'scalars.jsonl')) as f:
        recs = [json.loads(ln) for ln in f]
    val = [r for r in recs if any(k.startswith('val/') for k in r)]
    assert [r['step'] for r in val] == [2, 4]
    assert all(set(r) == {'step', 'val/mIoU', 'val/occ_mIoU'} for r in val)


def test_test_and_predict_write_the_valid_rows(tmp_path, eval_loader):
    """`test` writes results_nusc.json with one entry per valid token and
    scores it with the in-repo metric against the loader's GT; `predict`
    writes one lidarseg bin per valid frame, num_points labels in 1..16,
    and the detection json for v1.0-test. The padding row (d) is skipped."""
    tr, state = _trainer(tmp_path, 'test')
    sub_dir = os.path.join(tr.workdir, 'detection_submit')
    tr.test(eval_loader, state)
    with open(os.path.join(sub_dir, 'results_nusc.json')) as f:
        sub = json.load(f)['results']
    assert set(sub) == set('abc')
    with open(os.path.join(sub_dir, 'metrics_summary.json')) as f:
        assert 0.0 <= json.load(f)['nd_score'] <= 1.0
    tr.predict(eval_loader, state)
    seg_dir = os.path.join(tr.workdir, 'lidarseg_submit', 'lidarseg', 'test')
    assert sorted(os.listdir(seg_dir)) == [f'lidar_{t}_lidarseg.bin'
                                           for t in 'abc']
    for batch in eval_loader:
        for b, t in enumerate(batch['meta']['lidar_token'][:2]):
            if not batch['sample_valid'][b]:
                continue
            labels = np.fromfile(os.path.join(seg_dir, f'{t}_lidarseg.bin'),
                                 np.uint8)
            assert len(labels) == batch['num_points'][b]
            assert ((labels >= 1) & (labels <= 16)).all()
    with open(os.path.join(sub_dir, 'results_nusc.json')) as f:
        assert set(json.load(f)['results']) == set('abc')
    assert state.model.training


def test_vis_pickles_match_jax(tmp_path, steps, eval_loader):
    """`test(vis=True)` writes one pickle per valid frame whose keys,
    shapes and dtypes equal those of the JAX package's `_test_vis` for the
    same weights, with a byte-equal input_image."""
    variables = steps['variables']
    jtr = JaxTrainer(steps['cfg'], workdir=str(tmp_path / 'jax'),
                     mesh=make_mesh(dp=1, cam=1, devices=jax.devices()[:1]))
    jtr._test_vis(eval_loader, types.SimpleNamespace(
        params=variables['params'], batch_stats=variables['batch_stats']))
    tr, state = _trainer(tmp_path / 'port', steps['cfg'].train.exp_name)
    state.model.load_state_dict(from_flax(variables, state.model))
    tr.test(eval_loader, state, vis=True)
    dirs = [os.path.join(t.workdir, 'visualization') for t in (jtr, tr)]
    assert sorted(os.listdir(dirs[1])) == sorted(os.listdir(dirs[0])) == [
        '0.pkl', '1.pkl', '2.pkl']
    for name in ('0.pkl', '1.pkl', '2.pkl'):
        want, got = [pickle.load(open(os.path.join(d, name), 'rb'))
                     for d in dirs]
        assert set(got) == set(want)
        for k, w in want.items():
            g = got[k]
            assert type(g) is type(w), k
            if isinstance(w, np.ndarray):
                assert (g.shape, g.dtype) == (w.shape, w.dtype), k
            else:
                assert g == w, k
        np.testing.assert_array_equal(got['input_image'],
                                      want['input_image'])
    assert state.model.training
