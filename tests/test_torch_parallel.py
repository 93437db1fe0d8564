"""Data parallel on the CPU: two gloo ranks of the port's `Trainer` against
one process on the concatenated batch.

The JAX package's step is written over the global batch, so its data
parallelism is only a layout (`vampire_tpu/parallel/mesh.py`,
`tests/test_parallel.py::test_dp_equivalence`). The port's ranks must
compute the same function: rank 0 steps on row a, rank 1 on row b, and
each must end where one process ends after the step on [a, b]. The rows
(synthetic seeds 1 and 2; row b drops 20 valid points and 10 camera-mask
voxels, which the seeds alone leave equal) hold different
counts of valid points, camera-mask voxels, depth pixels, BEV cells and
positives per detection task (task 1: 3 and 0), so a per-rank mean in any
term would show; every task's global count is at least 2, so the
detection floors max(num_pos, num_devices) do not bind on either side.
`tests/test_torch_train_step.py` holds the one-process step at B = 2 to
the JAX step on the same rows.

One spawn of 2 ranks (`parallel/_testing.trainer_run`, rendezvous through a
file store, 600 s limit) and one in-process run give both sides: init
(rank 1 seeds differently, so only `init_state`'s broadcast makes the
ranks agree), one `fit` step with the density bias zeroed so that the
renders' losses reach the field, then `validate`, `test` and `predict`
over a fake tree of 3 samples: global batches of 2, the last padded.
fp32 throughout.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from vampire_tpu_torch import cli
from vampire_tpu_torch.configs import synthetic_batch, tiny_config
from vampire_tpu_torch.data.fake import make_fake_nusc
from vampire_tpu_torch.parallel import distributed
from vampire_tpu_torch.parallel._testing import (
    in_fresh_process, trainer_run, unclipped, zero_density_bias)

SEEDS = (1, 2)
# every logged loss term, 1-process against each rank: the same sums in
# another order (per-rank partial sums, then the all-reduce); measured
# 2.3e-6 at most
LOG_RTOL = 1e-5
# step-0 gradients: the BN and loss sums in another order, back through ~30
# layers; as test_torch_train_step.py, 3e-4 of each tensor's largest
# element (measured: median 6.9e-6, max 5.7e-5)
GRAD_RTOL = 3e-4
# BN running statistics: the global mean and the centred second moment by
# two all-reduces against torch.var_mean over the concatenated rows
# (measured: 7.2e-7 at most, running variances of ~1)
BN_RTOL = BN_ATOL = 1e-5
# the submitted boxes: the weights after the step differ by up to 2 lr
# (1e-4) on both sides (measured: rotation 3.9e-5, velocity 1.7e-5, the
# rest below 7e-6)
BOX_TOL = 1e-4


def _cfg(world):
    """tiny_config in fp32 with EMA; global batch 2 either way, so the
    learning rate (basic_lr_per_img * batch_size_per_device * num_devices)
    is the same."""
    cfg = tiny_config()
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, compute_dtype='float32', use_ema=True, max_epochs=1,
        batch_size_per_device=2 // world, num_devices=world))


def _rows(cfg):
    """Rows a and b; b loses 20 valid points and 10 camera-mask voxels."""
    rows = [synthetic_batch(cfg, batch_size=1, n_points=128, seed=s,
                            mode='train') for s in SEEDS]
    for k, n in (('point_valid', 20), ('mask_camera', 10)):
        m = rows[1][k].reshape(-1)
        m[np.flatnonzero(m)[:n]] = False
    return rows


def _concat(rows):
    return {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}


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
    rows = _rows(_cfg(1))
    one_dir = tmp_path_factory.mktemp('one')
    two_dir = tmp_path_factory.mktemp('two')
    one = trainer_run(_cfg(1), [[_concat(rows)]], str(one_dir),
                      data_root=str(tree), device='cpu',
                      init_hook=zero_density_bias)
    # rank 1 seeds its weights differently: only init_state's broadcast
    # makes the ranks start equal
    cfgs = [_cfg(2), dataclasses.replace(_cfg(2), train=dataclasses.replace(
        _cfg(2).train, seed=_cfg(2).train.seed + 1))]
    # cam=1: the dp layout, each rank all cameras of its row (the default
    # layout of a world of 2 splits the cameras: test_torch_parallel_cam.py)
    two = distributed.spawn(
        trainer_run, 2, (cfgs, [[rows[0]], [rows[1]]], str(two_dir),
                         str(tree), None, zero_density_bias, 0, None, 1),
        device='cpu', timeout_s=600)
    exp = tiny_config().train.exp_name
    return dict(rows=rows, one=one, two=two, lr=_cfg(1).train.lr,
                one_dir=one_dir / exp, two_dir=two_dir / exp)


def test_the_rows_hold_different_counts():
    a, b = _rows(_cfg(1))
    for k, f in (('point_valid', lambda r: r['point_valid']),
                 ('mask_camera', lambda r: r['mask_camera']),
                 ('depth', lambda r: r['depth_labels'] > 0),
                 ('bev_mask', lambda r: r['bev_mask'])):
        assert f(a).sum() != f(b).sum(), k
    pos = np.array([[int((r[f'heatmap_{t}'] == 1).sum()) for t in range(6)]
                    for r in (a, b)])
    assert (pos[0] != pos[1]).any() and (pos.sum(0) >= 2).all()
    assert (pos == 0).any()          # a rank with no positive in a task


def test_logs_match_one_process_and_each_other(runs):
    """Every logged term of the step (each rank logs the global values, the
    same on both) and the epoch's train mIoUs (rank 0 reports)."""
    want = runs['one']['logs']
    r0, r1 = (r['logs'] for r in runs['two'])
    assert r0[0] == r1[0]               # the step's logs, bit for bit
    assert [set(x) for x in r0] == [set(x) for x in want]
    for got, ref in zip(r0, want):
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=LOG_RTOL,
                                       err_msg=k)
    assert 'train/mIoU' in r0[-1] and len(r1) == 1


def test_step_zero_gradients_match(runs):
    """The gradients AdamW receives (summed over the ranks, clipped): the
    same on both ranks and within GRAD_RTOL of the one process's."""
    want = runs['one']['grads']
    g0, g1 = (r['grads'] for r in runs['two'])
    assert set(g0) == set(want) and len(want) > 50
    for n, ref in want.items():
        np.testing.assert_array_equal(g0[n], g1[n], err_msg=n)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(g0[n], ref, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * scale + 1e-12,
                                   err_msg=n)
    assert np.abs(want['backbone.density_beta']).max() > 0


def test_params_ema_and_batchnorm_statistics_match(runs):
    """After the step, on both ranks: the parameters and the EMA within the
    step test's tolerance (1e-4 relative, 2 lr absolute: AdamW's first step
    moves each element by ~lr sign(g)), the BN running statistics within
    BN_RTOL."""
    lr = runs['lr']
    one = runs['one']
    n_bn = 0
    for rk in runs['two']:
        for k, ref in one['state'].items():
            got = rk['state'][k]
            if k.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(got, ref, rtol=BN_RTOL,
                                           atol=BN_ATOL, err_msg=k)
                n_bn += 1
            elif k.endswith('num_batches_tracked'):
                np.testing.assert_array_equal(got, ref, err_msg=k)
            else:
                np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2 * lr,
                                           err_msg=k)
        for k, ref in one['ema'].items():
            np.testing.assert_allclose(rk['ema'][k], ref, rtol=1e-4,
                                       atol=2 * lr, err_msg=k)
    assert n_bn > 40


def test_train_confusions_sum_to_one_process(runs):
    want = runs['one']['train_conf']
    got = [runs['two'][0]['train_conf'][i] + runs['two'][1]['train_conf'][i]
           for i in range(2)]
    for g, w in zip(got, want):
        assert w.sum() > 0
        np.testing.assert_array_equal(g, w)


def test_eval_calls_match_one_process(runs):
    """validate's mIoUs on both ranks; test's submission and its in-repo
    NDS/mAP, and predict's lidarseg bins, written by rank 0 alone, over 3
    frames whose last global batch carries a padding row."""
    one, two = runs['one_dir'], runs['two_dir']
    want = runs['one']['validate']
    for rk in runs['two']:
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


def test_vis_dumps_refuse_a_world(runs, tree):
    """test(vis=True) names its dumps from a counter of its process: in a
    world of 2 it raises in every rank instead of overwriting."""
    with pytest.raises(RuntimeError, match='test\\(vis=True\\) runs in one'):
        cli.main(['--debug', '--num-devices', '2', '-t', '--vis', '-b', '1',
                  '--data-root', str(tree), '--workdir',
                  str(runs['two_dir'].parent), '--num-workers', '1'])


@pytest.mark.parametrize('fn,args,timeout_s,err', [
    (int, ('not a number',), 300, RuntimeError),
    (__import__('time').sleep, (600,), 5, TimeoutError),
], ids=['raise', 'hang'])
def test_spawn_reports_a_failed_or_hung_rank(fn, args, timeout_s, err):
    """A rank that raises makes spawn raise with its traceback; ranks that
    outlive the limit are killed and spawn raises TimeoutError."""
    with pytest.raises(err, match='ValueError' if err is RuntimeError
                       else 'killed'):
        distributed.spawn(fn, 2, args, device='cpu', timeout_s=timeout_s)


def test_spawn_without_a_deadline_waits_for_its_ranks():
    """timeout_s=None (the CLI's training runs) sets no limit: spawn
    returns the ranks' results when they end."""
    assert distributed.spawn(int, 2, ('7',), device='cpu',
                             timeout_s=None) == [7, 7]


def test_in_fresh_process_runs_outside_any_group():
    """The single-process reference of the card's multi phase: a fresh
    process, no process group; a failure or a hang raises."""
    assert in_fresh_process(distributed.world_size, (), 300) == 1
    with pytest.raises(RuntimeError, match='exit code'):
        in_fresh_process(int, ('not a number',), 300)
    with pytest.raises(TimeoutError, match='killed'):
        in_fresh_process(__import__('time').sleep, (600,), 5)


def test_unclipped_stats_remove_the_clip_scale():
    """`unclipped` undoes `clip_by_global_norm_` (rtol 1e-6: one fp32
    divide and multiply). Two runs whose gradients differ only in the clip's
    scale (a grad_norm 1e-3 apart) show that scale in every tensor clipped
    and, unclipped, no more than the fp32 divides' rounding (below 1e-6;
    `tools/grad_spread.pair_stats`)."""
    import torch
    from vampire_tpu_torch.tools.grad_spread import pair_stats
    from vampire_tpu_torch.training.train_state import clip_by_global_norm_
    rng = np.random.default_rng(0)
    raw = {f'p{i}': rng.normal(size=(3, 4)).astype(np.float32) * 10
           for i in range(5)}
    ts = [torch.from_numpy(v.copy()) for v in raw.values()]
    norm = float(clip_by_global_norm_(ts, 1.0))
    assert norm > 1.0
    clipped = {k: t.numpy() for k, t in zip(raw, ts)}
    for k, v in unclipped(clipped, norm, 1.0).items():
        np.testing.assert_allclose(v, raw[k], rtol=1e-6, err_msg=k)
    assert unclipped(raw, 0.5, 1.0)['p0'].tolist() == raw['p0'].tolist()
    a = dict(logs=[dict(total_loss=1.0, grad_norm=1000.0)],
             grads={k: v / 1000.0 for k, v in raw.items()})
    b = dict(logs=[dict(total_loss=1.0, grad_norm=1001.0)],
             grads={k: v / 1001.0 for k, v in raw.items()})
    st = pair_stats(a, b, 1.0)
    assert st['loss_equal']
    np.testing.assert_allclose([st['clipped'][q] for q in
                                ('median', 'p90', 'max')],
                               1.0 - 1000.0 / 1001.0, rtol=1e-4)
    assert max(st['unclipped'].values()) < 1e-6


def test_collectives_are_the_identity_without_a_group():
    import torch
    x = torch.arange(6.0).reshape(3, 2)
    assert not distributed.active() and distributed.world_size() == 1
    assert distributed.all_reduce_sum(x) is x
    assert distributed.all_gather_rows(x) is x
    assert distributed.process_allgather({'a': 1}) == [{'a': 1}]
    assert distributed.host_local_rows(x) is x
    assert distributed.is_main_process()
    assert distributed.initialize('cpu') == torch.device('cpu')
    assert not distributed.active()


_ENV_RANK = r'''
import sys, torch
from vampire_tpu_torch.parallel import distributed as D
dev = D.initialize('cpu', init_method='file://' + sys.argv[1])
again = D.initialize('cuda')            # idempotent: the rank's device
x = D.all_reduce_sum(torch.tensor([float(D.rank() + 1)]))
print(dev, again, D.rank(), D.world_size(), D.is_main_process(), float(x))
D.shutdown()
'''


def test_initialize_reads_the_torchrun_environment(tmp_path):
    """Two processes with torchrun's WORLD_SIZE, RANK and LOCAL_RANK join
    one gloo group (through a file store here, in place of torchrun's
    MASTER_ADDR/MASTER_PORT), each as its rank, and sum over it."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    store = str(tmp_path / 'store')
    procs = [subprocess.Popen(
        [sys.executable, '-c', _ENV_RANK, store], cwd=root, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, PYTHONPATH=root, WORLD_SIZE='2', RANK=str(r),
                 LOCAL_RANK=str(r)))
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            outs.append(out.split())
    finally:
        for p in procs:
            p.kill()
    assert outs == [['cpu', 'cpu', '0', '2', 'True', '3.0'],
                    ['cpu', 'cpu', '1', '2', 'False', '3.0']]
