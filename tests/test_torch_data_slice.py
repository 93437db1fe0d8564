"""The whole slice against the JAX package: from one fake nuScenes tree,
through each package's dataset and loader, into each package's train step
and metric step, at `tiny_config` in fp32 on the CPU.

The first train batch of each loader (train mode, every augmentation
live, shuffled) and the first val batch are equal byte for byte. The JAX
model is initialised, its BN statistics, BN affine parameters and biases
are randomised, its density bias is zeroed, and the weights are carried
across with `weights.from_flax`, as in test_torch_train_step.py (whose
fp32-table JAX model this file uses). One train step on each side gives
the same loss terms within that file's tolerance; the metric step on the
val batch gives the JAX confusions, up to the elements whose top two JAX
logits are a near-tie (test_torch_trainer_eval.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import MATS
from test_torch_train_step import ATOL, RTOL, _JaxVampireF32Table, _randomize
from test_torch_trainer_eval import _near_ties
from vampire_tpu import configs as jcfg
from vampire_tpu.data import nuscenes as jn
from vampire_tpu.data.synthetic import tiny_config as j_tiny_config
from vampire_tpu.models.vampire import Vampire as JaxVampire
from vampire_tpu.training import train_state as jts
from vampire_tpu.training import train_step as jax_steps
from vampire_tpu_torch import configs as tcfg
from vampire_tpu_torch.data import nuscenes as tn
from vampire_tpu_torch.data.fake import make_fake_nusc
from vampire_tpu_torch.data.synthetic import tiny_config
from vampire_tpu_torch.models.vampire import Vampire
from vampire_tpu_torch.training import train_state as tts
from vampire_tpu_torch.training.train_step import (build_metric_eval_step,
                                                   build_train_step,
                                                   init_train_confusion)
from vampire_tpu_torch.weights import from_flax


def _first_batch(pkg, mod, tiny, root, info, mode):
    cfg = tiny()
    ida = dataclasses.replace(cfg.ida_aug, rand_flip=True,
                              rot_lim=(-5.4, 5.4), bot_pct_lim=(0.0, 0.22))
    bda = pkg.BdaAugConfig(rot_lim=(-22.5, 22.5), scale_lim=(0.95, 1.05),
                           flip_dx_ratio=0.5, flip_dy_ratio=0.5)
    bc = cfg.backbone
    ds = mod.NuscDetSegDataset(
        ida_aug=ida, bda_aug=bda, classes=list(pkg.DET_CLASSES),
        data_root=root, info_paths=info, head_cfg=cfg.head, mode=mode,
        max_points=cfg.train.max_points, seed=0,
        seg_bounds=(bc.x_bound_seg, bc.y_bound_seg, bc.z_bound_seg))
    loader = mod.DataLoader(ds, batch_size=1, shuffle=mode == 'train',
                            num_workers=1, seed=0, drop_last=False)
    return next(iter(loader))


@pytest.fixture(scope='module')
def slice_(tmp_path_factory):
    cfg = tiny_config()
    root = tmp_path_factory.mktemp('nusc')
    info = make_fake_nusc(root, n_samples=2,
                          n_points=cfg.train.max_points - 8, seed=1,
                          image_content='smooth',
                          occ_shape=cfg.backbone.occ_grid)
    batches = {}
    for mode in ('train', 'val'):
        batches[mode] = [
            _first_batch(pkg, mod, tiny, str(root), info, mode)
            for pkg, mod, tiny in ((jcfg, jn, j_tiny_config),
                                   (tcfg, tn, tiny_config))]
    jtrain, ttrain = batches['train']
    jval, tval = batches['val']

    def to_jax(b):
        return {k: jnp.asarray(v) for k, v in b.items() if k != 'meta'}

    def to_torch(b):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()
                if k != 'meta'}

    jb = to_jax(jtrain)
    jm = _JaxVampireF32Table(cfg.backbone, cfg.head, dtype=jnp.float32)
    v = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jb['imgs'],
                                {k: jb[k] for k in MATS},
                                points=jb['points'], train=False,
                                camera_renders=False))()
    variables = _randomize(jax.device_get(v))
    variables['params']['backbone']['density_conv']['bias'] = np.zeros(
        1, np.float32)
    jstate, tx = jts.create_train_state(variables['params'],
                                        variables['batch_stats'], cfg.train,
                                        steps_per_epoch=1)
    step = jax.jit(jax_steps.build_train_step(jm, cfg, tx, 1,
                                              with_metrics=True))
    _, jlogs, _ = jax.device_get(step(jstate, jb,
                                      jax_steps.init_train_confusion(cfg)))
    jv = to_jax(jval)
    jem = JaxVampire(cfg.backbone, cfg.head, dtype=jnp.float32)
    args = (variables['params'], variables['batch_stats'], jv)
    jconf = jax.device_get(jax.jit(jax_steps.build_metric_eval_step(
        jem, cfg))(*args))
    jout = jax.device_get(jax.jit(jax_steps.build_eval_step(
        jem, cfg, lidar_seg=False))(*args))

    tm = Vampire(cfg.backbone, cfg.head, dtype=torch.float32)
    tm.load_state_dict(from_flax(variables, tm), strict=True)
    tconf = build_metric_eval_step(tm, cfg)(to_torch(tval))
    tm.train()
    tm.backbone.sample_dtype = torch.float32
    state = tts.create_train_state(tm, cfg.train, steps_per_epoch=1)
    _, tlogs, _ = build_train_step(cfg, with_metrics=True)(
        state, to_torch(ttrain), init_train_confusion(cfg))
    return dict(batches=batches, jlogs=jlogs, tlogs=tlogs, jconf=jconf,
                tconf=tconf, jout=jout)


@pytest.mark.parametrize('mode', ['train', 'val'])
def test_loader_batches_are_equal(slice_, mode):
    want, got = slice_['batches'][mode]
    assert set(got) == set(want)
    for k in want:
        if k == 'meta':
            assert repr(got[k]) == repr(want[k])
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got['imgs'].shape == (1, 6, 32, 64, 3)


def test_train_step_on_loader_batches_matches_jax(slice_):
    """Every loss term, the total and the pre-clip grad_norm."""
    tlogs, jlogs = slice_['tlogs'], slice_['jlogs']
    assert set(tlogs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(tlogs[k].item(), float(jlogs[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert float(jlogs['grad_norm']) > 0
    assert float(jlogs['depth_loss']) > 0


def test_metric_step_on_a_loader_batch_matches_jax(slice_):
    _, b = slice_['batches']['val']
    jout = slice_['jout']
    pts = np.asarray(jout['pts_logits'])
    seg_mask = b['point_valid'] & (b['point_labels'] != 0)
    ties = (_near_ties(pts[..., 1:-1], seg_mask,
                       ATOL + 2.0 ** -8 * np.abs(pts).max()),
            _near_ties(np.asarray(jout['occ_logits']), b['mask_camera'],
                       ATOL))
    totals = (int(seg_mask.sum()), int(b['mask_camera'].sum()))
    assert min(totals) > 0
    for got, want, n_ties, total in zip(slice_['tconf'], slice_['jconf'],
                                        ties, totals):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape
        assert got.sum() == want.sum() == total
        assert np.abs(got - want).sum() / 2 <= n_ties
