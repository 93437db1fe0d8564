"""The camera axis on the CPU: gloo ranks of the port's `Trainer` in a dp x
cam layout (`vampire_tpu_torch/parallel/mesh.py`) against the port's one
process on the global batch and against the JAX package's camera-sharded
model, `Vampire(lift_vectorized=True)`, on one device.

The JAX package's step is written over the global batch, so its camera
axis is only a layout (`tests/test_parallel.py::test_dp_equivalence`
holds a dp 2 x cam 2 mesh to one device at B = 4). The port's ranks must
compute the same function by hand: each rank encodes its half of the six
cameras, its lift's partial sums are added over its cam group, the terms
of its camera renders reduce over the world and the terms after the lift
over its dp group, at 1/cam a rank. Two layouts, each spawned once (a
`file://` store, a 600 s limit):
  * world 2: dp 1 x cam 2, both ranks on the 4 rows of the global batch;
  * world 4: dp 2 x cam 2, JAX's own test layout: rows 0-1 on ranks 0-1,
    rows 2-3 on ranks 2-3.
The global batch is 4 synthetic rows (seeds 1-4; rows 1 and 3 lose valid
points and camera-mask voxels, so that the rows hold different counts),
fp32, the port's seeded initial weights (`Trainer.init_state`'s) with the
density bias at 0 so that the renders' losses reach the field, carried to
JAX by the inverse of `weights.from_flax`, the learning rate and the
detection floors of the JAX test (lr 2.5e-5, num_devices = 1) on every
side.

The gradients are a kinked function of the inputs: where a ReLU's input
lies within the fp32 noise of 0 (a few 1e-6 after ~40 layers summed in
another order) and carries a gradient, the two sides route that element's
gradient differently. Measured here: one such element moved
head.task4.reg_conv0's gradient by 0.023 of its norm (world 2 against one
process), another the image backbone's layer2_0 BN gradients by 0.012
(the port against JAX, on every layout alike); with one row a dp block, an
input of 6.4e-7 against 4.7e-6 in head.task2.rot_conv0 moved that tensor
by 0.28 of its largest element. So, as JAX's own test does, the gradients
are held by their global norm (rtol 2e-4) and by the per-tensor relative
error |d| / |g| as `chip_smoke.py`'s multi phase takes it: its median over
the tensors within GRAD_RTOL, its largest within KINK_RTOL. A wrong
reduction group or share moves whole tensors by O(0.1-1): a factor of
cam in the terms after the lift moves every head tensor by 0.5.

Held to the port's one process (`parallel/_testing.trainer_run` in this
process, `lift_vectorized=True`): step-0 logs (JAX's loss bound rtol
2e-5), the unclipped gradients, the parameters and the EMA after the step
(JAX's rtol 5e-4, atol 1e-4 = 4 lr), the BN statistics, the train
confusions summed over a dp group, and `validate`, `test` and `predict`
over a fake tree of 3 samples on the initial weights. Held to JAX, with an
fp32 sampled field on both sides (as `tests/test_torch_train_step.py`):
each rank's eval-mode forward with the camera renders (its cameras'
renders, the whole field's outputs) and its step (logs, clipped
gradients, parameters, EMA, BN statistics, confusions) at that file's
tolerances, its gradients as above. The JAX side compiles while the
ranks run.
"""
import dataclasses
import functools
import json
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampire_tpu.data.synthetic import synthetic_batch, tiny_config
from vampire_tpu.models.centerpoint_head import BEVDepthHead
from vampire_tpu.models.field import FieldBackbone as JaxFieldBackbone
from vampire_tpu.models.vampire import Vampire as JaxVampire
from vampire_tpu.training import train_state as jts
from vampire_tpu.training.train_step import (build_train_step as jax_step,
                                             init_train_confusion)
from vampire_tpu_torch.data.fake import make_fake_nusc
from vampire_tpu_torch.models.vampire import Vampire, init_params_
from vampire_tpu_torch.parallel import distributed
from vampire_tpu_torch.parallel._testing import (load_weights, trainer_run,
                                                 unclipped,
                                                 zero_density_bias)
from vampire_tpu_torch.weights import from_flax

ROWS = 4
LAYOUTS = {2: (1, 2), 4: (2, 2)}          # world: (dp, cam)
MATS = ('sensor2ego', 'intrin', 'ida', 'bda')
# JAX's test_dp_equivalence bounds between layouts of one computation
LOSS_RTOL = 2e-5
NORM_RTOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 5e-4, 1e-4
# the median over the tensors of |d| / |g| (measured: 4.1e-6 to 5.1e-6
# against one process, 1.1e-5 to 1.7e-5 against JAX), and the largest
# (measured: 0.023 where a kink fell, see above; 6.3e-5 elsewhere)
GRAD_RTOL = 3e-4
KINK_RTOL = 0.1
BN_RTOL = BN_ATOL = 1e-5
BOX_TOL = 1e-4
# against JAX: tests/test_torch_train_step.py's bounds
JAX_RTOL = JAX_ATOL = 1e-4


class _JaxCamModel(JaxVampire):
    """`Vampire(lift_vectorized=True)` sampling an fp32 corner table."""

    def setup(self):
        self.backbone = JaxFieldBackbone(self.backbone_cfg, dtype=self.dtype,
                                         sample_dtype=jnp.float32,
                                         lift_vectorized=True,
                                         name='backbone')
        self.head = BEVDepthHead(self.head_cfg, name='head')


def _cfg(world):
    """tiny_config in fp32 with EMA; the global batch of ROWS, and the
    learning rate (basic_lr_per_img * batch_size_per_device * num_devices)
    of the JAX test's tiny_config at B = 1, in every run."""
    cfg = tiny_config()
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, compute_dtype='float32', use_ema=True, max_epochs=1,
        batch_size_per_device=ROWS // world, num_devices=world,
        basic_lr_per_img=cfg.train.lr / ROWS))


def _rows():
    cfg = _cfg(1)
    rows = [synthetic_batch(cfg, batch_size=1, n_points=128, seed=s,
                            mode='train') for s in range(1, ROWS + 1)]
    for r in (1, 3):
        for k, n in (('point_valid', 20), ('mask_camera', 10)):
            m = rows[r][k].reshape(-1)
            m[np.flatnonzero(m)[:n]] = False
    return rows


def _concat(rows):
    return {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}


def _to_flax(jm, batch, tm):
    """The flax variables of the port module `tm`'s weights: the inverse of
    `weights.from_flax`, leaf by leaf of the JAX model's variable tree
    (`jax.eval_shape` of its init: no compile)."""
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(batch['imgs']),
        {k: jnp.asarray(batch[k]) for k in MATS},
        points=jnp.asarray(batch['points']), train=False))
    mods = dict(tm.named_modules())
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    names = {'kernel': 'weight', 'scale': 'weight', 'mean': 'running_mean',
             'var': 'running_var'}

    def leaf(path):
        prefix = '.'.join({'Conv_0': 'conv', 'BatchNorm_0': 'bn'}.get(p, p)
                          for p in path[:-1])
        t = sd['.'.join(filter(None, (prefix, names.get(path[-1],
                                                        path[-1]))))]
        if path[-1] != 'kernel':
            return t.copy()
        mod = mods[prefix]
        if isinstance(mod, torch.nn.ConvTranspose2d):
            return np.ascontiguousarray(t.transpose(2, 3, 0, 1)[::-1, ::-1])
        if isinstance(mod, torch.nn.Conv3d):
            return np.ascontiguousarray(t.transpose(2, 3, 4, 1, 0))
        return np.ascontiguousarray(t.transpose(2, 3, 1, 0))

    def walk(tree, path=()):
        if hasattr(tree, 'items'):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return leaf(path)
    variables = {c: walk(tree) for c, tree in shapes.items()}
    back = from_flax(variables, tm)
    assert all(torch.equal(back[k], v) for k, v in tm.state_dict().items())
    return variables


def _adam_mu(opt_state):
    for leaf in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, 'mu')):
        if hasattr(leaf, 'mu'):
            return leaf.mu
    raise AssertionError('no Adam state')


def _jax_side(variables, glob, tm):
    """JAX's eval-mode forward with the renders and its train step on the
    global batch, mapped to the port's names."""
    cfg = _cfg(1)
    jm = _JaxCamModel(cfg.backbone, cfg.head, dtype=jnp.float32)
    jb = {k: jnp.asarray(v) for k, v in glob.items()}
    mats = {k: jb[k] for k in MATS}
    fo, preds = jax.device_get(jax.jit(lambda v: jm.apply(
        v, jb['imgs'], mats, points=jb['points'], train=False))(variables))
    fwd = {k: np.asarray(v) for k, v in fo.items() if v is not None}
    fwd.update({f'det_{t}_{k}': np.asarray(v) for t, p in enumerate(preds)
                for k, v in p.items()})
    jstate, tx = jts.create_train_state(variables['params'],
                                        variables['batch_stats'], cfg.train,
                                        steps_per_epoch=1)
    step = jax.jit(jax_step(jm, cfg, tx, 1, with_metrics=True))
    new, logs, conf = jax.device_get(step(jstate, jb,
                                          init_train_confusion(cfg)))
    grads = jax.tree.map(lambda m: np.asarray(m, np.float64) / 0.1,
                         _adam_mu(new.opt_state))

    def mapped(params):
        return {k: v.numpy() for k, v in from_flax(
            {'params': params, 'batch_stats': new.batch_stats}, tm).items()}
    return dict(forward=fwd, logs={k: float(v) for k, v in logs.items()},
                conf=[np.asarray(c) for c in conf], grads=mapped(grads),
                state=mapped(new.params), ema=mapped(new.ema_params))


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """A fake tree of 3 samples at tiny_config, as every split."""
    cfg = tiny_config()
    root = tmp_path_factory.mktemp('nusc')
    make_fake_nusc(root, n_samples=3, n_points=cfg.train.max_points - 8,
                   seed=0, image_content='smooth',
                   occ_shape=cfg.backbone.occ_grid)
    for name in ('nuscenes_occ_infos_train.pkl', 'nuscenes_occ_infos_val.pkl',
                 'nuscenes_infos_test.pkl'):
        shutil.copy(root / 'infos_train.pkl', root / name)
    return root


@pytest.fixture(scope='module')
def runs(tree, tmp_path_factory):
    rows = _rows()
    glob = _concat(rows)
    cfg1 = _cfg(1)
    tm = Vampire(cfg1.backbone, cfg1.head)
    gen = torch.Generator()
    gen.manual_seed(cfg1.train.seed)
    init_params_(tm, gen)           # the weights Trainer.init_state draws
    zero_density_bias(tm)
    variables = _to_flax(_JaxCamModel(cfg1.backbone, cfg1.head,
                                      dtype=jnp.float32), glob, tm)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    hook = functools.partial(load_weights, sd, fp32_samples=True)
    dirs = {w: tmp_path_factory.mktemp(f'w{w}') for w in (1,) + tuple(
        LAYOUTS)}
    out = {}

    def port_side():
        try:
            out[1] = trainer_run(cfg1, [[glob]], str(dirs[1]),
                                 data_root=str(tree), device='cpu',
                                 init_hook=hook, num_devices=1,
                                 lift_vectorized=True, forward=[glob],
                                 eval_first=True)
            for world, (dp, cam) in LAYOUTS.items():
                per = ROWS // dp
                blocks = [_concat(rows[d * per:(d + 1) * per])
                          for d in range(dp)]
                mine = [blocks[r // cam] for r in range(world)]
                out[world] = distributed.spawn(
                    trainer_run, world,
                    (_cfg(world), [[b] for b in mine], str(dirs[world]),
                     str(tree), None, hook, 0, 1, cam, None, mine, True),
                    device='cpu', timeout_s=600)
        except BaseException as e:      # raised in the test's thread
            out['error'] = e

    worker = threading.Thread(target=port_side)
    worker.start()
    try:
        jax_ref = _jax_side(variables, glob, tm)
    finally:
        worker.join()
    if 'error' in out:
        raise out['error']
    exp = tiny_config().train.exp_name
    return dict(one=out[1], worlds={w: out[w] for w in LAYOUTS},
                jax=jax_ref, lr=cfg1.train.lr,
                dirs={w: d / exp for w, d in dirs.items()})


def _unclipped(run):
    return unclipped(run['grads'], run['logs'][0]['grad_norm'],
                     tiny_config().train.gradient_clip_val)


def _check_gradients(got, want):
    """Per tensor |d| / |g|: the median within GRAD_RTOL, the largest
    within KINK_RTOL; a tensor with no gradient on one side has none on the
    other."""
    assert set(got) == set(want) and len(want) > 50
    rel = {}
    for n, ref in want.items():
        scale = float(np.linalg.norm(ref))
        if scale == 0.0:
            assert not np.any(got[n]), n
            continue
        rel[n] = float(np.linalg.norm(got[n] - ref)) / scale
    worst = max(rel, key=rel.get)
    assert np.median(list(rel.values())) <= GRAD_RTOL, sorted(
        rel.items(), key=lambda x: -x[1])[:10]
    assert rel[worst] <= KINK_RTOL, (worst, rel[worst])


@pytest.mark.parametrize('world', LAYOUTS)
def test_ranks_take_the_layout(runs, world):
    """Rank r at (r // cam, r % cam), every rank in a gloo group of the
    world, the lift dense (every block selected by every camera)."""
    dp, cam = LAYOUTS[world]
    got = [(r['rank'], r['world'], r['dp'], r['cam'], r['dp_index'],
            r['cam_index'], r['backend']) for r in runs['worlds'][world]]
    assert got == [(r, world, dp, cam, r // cam, r % cam, 'gloo')
                   for r in range(world)]


@pytest.mark.parametrize('world', LAYOUTS)
def test_logs_match_one_process(runs, world):
    """Every logged term of the step, the same on every rank bit for bit
    and within LOSS_RTOL (grad_norm NORM_RTOL) of the one process's."""
    ranks = runs['worlds'][world]
    want = runs['one']['logs']
    for r in ranks[1:]:
        assert r['logs'][0] == ranks[0]['logs'][0]
    assert [set(x) for x in ranks[0]['logs']] == [set(x) for x in want]
    for k, ref in want[0].items():
        np.testing.assert_allclose(
            ranks[0]['logs'][0][k], ref, atol=1e-7,
            rtol=NORM_RTOL if k == 'grad_norm' else LOSS_RTOL, err_msg=k)
    assert want[0]['camera_depth_loss'] > 0 and want[0]['total_loss'] > 0


@pytest.mark.parametrize('world', LAYOUTS)
def test_unclipped_gradients_match_one_process(runs, world):
    """Step 0's gradients before the clip, summed over the world: the same
    on every rank bit for bit, and the one process's (`_check_gradients`;
    their global norm is test_logs_match_one_process's grad_norm)."""
    ranks = runs['worlds'][world]
    want = _unclipped(runs['one'])
    for r in ranks[1:]:
        for n in want:
            np.testing.assert_array_equal(r['grads'][n], ranks[0]['grads'][n])
    _check_gradients(_unclipped(ranks[0]), want)
    # the encoder's gradient comes from both halves of the cameras
    assert np.abs(want['backbone.channel_lower.weight']).max() > 0


@pytest.mark.parametrize('world', LAYOUTS)
def test_params_ema_and_batchnorm_statistics_match_one_process(runs, world):
    """After the step, on every rank: the parameters and the EMA within
    JAX's bounds, the BN running statistics (the encoder's over the world's
    cameras, the head's over a dp group's rows) within BN_RTOL."""
    one = runs['one']
    n_bn = 0
    for rk in runs['worlds'][world]:
        for k, ref in one['state'].items():
            got = rk['state'][k]
            if k.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(got, ref, rtol=BN_RTOL,
                                           atol=BN_ATOL, err_msg=k)
                n_bn += 1
            elif k.endswith('num_batches_tracked'):
                np.testing.assert_array_equal(got, ref, err_msg=k)
            else:
                np.testing.assert_allclose(got, ref, rtol=PARAM_RTOL,
                                           atol=PARAM_ATOL, err_msg=k)
        for k, ref in one['ema'].items():
            np.testing.assert_allclose(rk['ema'][k], ref, rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=k)
    assert n_bn > 40


def _conf_of_rows(ranks):
    """The train confusions of the world's rows, each row once: the ranks
    of cam index 0, one a dp index."""
    mine = [r['train_conf'] for r in ranks if r['cam_index'] == 0]
    return [sum(c[i] for c in mine) for i in range(2)]


@pytest.mark.parametrize('world', LAYOUTS)
def test_train_confusions_match_one_process(runs, world):
    """Each rank's own confusions are its rows', the same in its cam group;
    the dp group's sum is the one process's, and the main process reports
    the train mIoUs of that sum."""
    ranks = runs['worlds'][world]
    cam = LAYOUTS[world][1]
    for r in ranks:
        twin = ranks[r['rank'] - r['cam_index']]
        for a, b in zip(r['train_conf'], twin['train_conf']):
            np.testing.assert_array_equal(a, b)
    for g, w in zip(_conf_of_rows(ranks), runs['one']['train_conf']):
        assert w.sum() > 0
        np.testing.assert_array_equal(g, w)
    rep = [rec for rec in ranks[0]['logs'] if 'train/mIoU' in rec]
    want = [rec for rec in runs['one']['logs'] if 'train/mIoU' in rec]
    assert rep == want and cam == 2


@pytest.mark.parametrize('world', LAYOUTS)
def test_eval_calls_match_one_process(runs, world):
    """validate's mIoUs on every rank; test's submission and its in-repo
    NDS/mAP, and predict's lidarseg bins, written once by rank 0 from its
    dp group's rows, over 3 frames whose last global batch is padded; on
    the initial weights (`eval_first`), which every side holds bit for
    bit (after the step a kink's sign flip moves a weight by 2 lr, and a
    box's yaw by ~5e-4)."""
    one, two = runs['dirs'][1], runs['dirs'][world]
    want = runs['one']['validate']
    for rk in runs['worlds'][world]:
        assert rk['validate'] == want
    sub = 'detection_submit'
    res1 = json.loads((one / sub / 'results_nusc.json').read_text())
    res2 = json.loads((two / sub / 'results_nusc.json').read_text())
    assert sorted(res2['results']) == sorted(res1['results']) == [
        's0', 's1', 's2']
    for tok, boxes in res1['results'].items():
        assert len(res2['results'][tok]) == len(boxes)
        for b1, b2 in zip(boxes, res2['results'][tok]):
            for k in ('translation', 'size', 'rotation', 'velocity',
                      'detection_score'):
                np.testing.assert_allclose(b2[k], b1[k], rtol=BOX_TOL,
                                           atol=BOX_TOL, err_msg=(tok, k))
            assert b2['detection_name'] == b1['detection_name']
    m1 = json.loads((one / sub / 'metrics_summary.json').read_text())
    m2 = json.loads((two / sub / 'metrics_summary.json').read_text())
    for k in ('nd_score', 'mean_ap'):
        np.testing.assert_allclose(m2[k], m1[k], rtol=1e-6, err_msg=k)
    bins1 = sorted(p.relative_to(one) for p in
                   (one / 'lidarseg_submit').rglob('*.bin'))
    bins2 = sorted(p.relative_to(two) for p in
                   (two / 'lidarseg_submit').rglob('*.bin'))
    assert bins1 == bins2 and len(bins1) == 3
    for p in bins1:
        assert (one / p).read_bytes() == (two / p).read_bytes(), p


def _per_view(key, world, ranks):
    """A forward output as one process holds it: the camera renders
    gathered over each cam group's ranks (camera axis 1), the rest from
    the ranks of cam index 0, rows in dp order."""
    dp, cam = LAYOUTS[world]
    blocks = []
    for d in range(dp):
        group = ranks[d * cam:(d + 1) * cam]
        if key in ('rgb_preds', 'seg_logits_preds', 'depth_preds'):
            blocks.append(np.concatenate([r['forward'][key] for r in group],
                                         axis=1))
        else:
            for r in group[1:]:
                np.testing.assert_array_equal(r['forward'][key],
                                              group[0]['forward'][key])
            blocks.append(group[0]['forward'][key])
    return np.concatenate(blocks)


@pytest.mark.parametrize('world', (1,) + tuple(LAYOUTS))
def test_forward_matches_jax(runs, world):
    """Each rank's eval-mode forward with the camera renders against the
    JAX camera-sharded model's on the global batch: the field's outputs
    (the same on every rank of a cam group), its cameras' renders, the
    detection maps."""
    want = runs['jax']['forward']
    ranks = [runs['one']] if world == 1 else runs['worlds'][world]
    keys = set(ranks[0]['forward'])
    assert keys == set(want) and 'depth_preds' in keys
    for k in sorted(keys):
        got = (ranks[0]['forward'][k] if world == 1
               else _per_view(k, world, ranks))
        np.testing.assert_allclose(got, want[k], rtol=JAX_RTOL,
                                   atol=JAX_ATOL, err_msg=k)


@pytest.mark.parametrize('world', (1,) + tuple(LAYOUTS))
def test_train_step_matches_jax(runs, world):
    """Rank 0's step against the JAX step on the global batch: every log
    (grad_norm among them), the clipped gradients (`_check_gradients`),
    the parameters and EMA (2 lr absolute, as AdamW's first step moves each
    element by ~lr sign(g)), the BN statistics and the dp group's
    confusions."""
    j = runs['jax']
    ranks = [runs['one']] if world == 1 else runs['worlds'][world]
    r0, lr = ranks[0], runs['lr']
    for k, ref in j['logs'].items():
        np.testing.assert_allclose(r0['logs'][0][k], ref, rtol=JAX_RTOL,
                                   atol=JAX_ATOL, err_msg=k)
    _check_gradients(r0['grads'], {n: j['grads'][n] for n in r0['grads']})
    for k, got in r0['state'].items():
        if k.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(got, j['state'][k], rtol=JAX_RTOL,
                                       atol=JAX_ATOL, err_msg=k)
        elif k in j['state'] and not k.endswith('num_batches_tracked'):
            np.testing.assert_allclose(got, j['state'][k], rtol=JAX_RTOL,
                                       atol=2 * lr, err_msg=k)
    for k, got in r0['ema'].items():
        np.testing.assert_allclose(got, j['ema'][k], rtol=JAX_RTOL,
                                   atol=2 * lr, err_msg=k)
    conf = (r0['train_conf'] if world == 1 else _conf_of_rows(ranks))
    for g, w in zip(conf, j['conf']):
        np.testing.assert_array_equal(g, w)

