"""The port's dataset, collate and loader (`data/nuscenes.py`) against the
JAX package's on one fake nuScenes tree: samples in train, val and test
mode (CBGS, sweep and key frames, fewer cameras, dense clouds) and batches
across shuffle, thread and process workers, prefetch depths, the
drop_last=False padding and a rank of 2, all equal array for array
(`assert_array_equal`, dtypes too), with the same `meta` and
`sample_valid`; and `global_gt_boxes`. The JAX loader runs thread workers
throughout: its batches do not depend on the kind of worker."""
import dataclasses
import os
import pickle

import numpy as np
import pytest

from vampire_tpu import configs as jcfg
from vampire_tpu.data import nuscenes as jn
from vampire_tpu.data.synthetic import tiny_config as j_tiny_config
from vampire_tpu_torch import configs as tcfg
from vampire_tpu_torch.data import nuscenes as tn
from vampire_tpu_torch.data.fake import make_fake_nusc
from vampire_tpu_torch.data.synthetic import tiny_config

N_SAMPLES = 5


def _ann(name, translation, size):
    return dict(category_name=name, translation=translation, size=size,
                rotation=[0.9, 0.0, 0.0, 0.43589], velocity=np.zeros(3),
                attribute_names=[], num_lidar_pts=3, num_radar_pts=0)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """Five samples of one scene ('smooth' images decode fast), each with
    one camera sweep. The fake tree's one car a sample is joined by a
    pedestrian in each and a barrier or a cone, so that CBGS, whose
    per-class share is a tenth of the samples with each class, resamples
    something. The clouds move to nuScenes' samples/LIDAR_TOP/, and the
    even samples get an fp16 dense cloud in occupancy/ (`use_dense`); the
    odd ones fall back to the sparse cloud."""
    root = tmp_path_factory.mktemp('nusc')
    info = make_fake_nusc(root, n_samples=N_SAMPLES, n_points=400, seed=2,
                          image_content='smooth', occ_shape=(8, 8, 4))
    with open(info, 'rb') as f:
        infos = pickle.load(f)
    for si, s in enumerate(infos):
        s['ann_infos'].append(_ann('human.pedestrian.adult',
                                   [103.0 + si, 52.0, 0.9], [0.6, 0.7, 1.7]))
        s['ann_infos'].append(_ann(
            'movable_object.barrier' if si % 2 == 0
            else 'movable_object.trafficcone',
            [98.0 + si, 47.0, 0.5], [2.0, 0.5, 1.0]))
        for li in [s['lidar_infos']] + s['lidar_sweeps']:
            li['LIDAR_TOP']['filename'] = f'samples/LIDAR_TOP/s{si}.bin'
    os.makedirs(root / 'samples' / 'LIDAR_TOP')
    os.makedirs(root / 'occupancy')
    rng = np.random.RandomState(3)
    for si in range(N_SAMPLES):
        sparse = root / 'samples' / 'LIDAR_TOP' / f's{si}.bin'
        os.replace(root / 'lidar' / f's{si}.bin', sparse)
        if si % 2 == 0:
            dense = np.fromfile(sparse, np.float32).reshape(-1, 5)
            dense = np.concatenate([dense, dense + 0.25])
            dense[:, 4] = rng.randint(0, 32, len(dense))
            dense.astype(np.float16).tofile(root / 'occupancy' / f's{si}.bin')
    with open(info, 'wb') as f:
        pickle.dump(infos, f)
    return str(root), info


def _augs(pkg):
    """The flagship's train-time augmentations, every draw live."""
    return dict(
        ida_aug=pkg.IdaAugConfig(resize_lim=(0.04, 0.06), final_dim=(32, 64),
                                 rand_flip=True, rot_lim=(-5.4, 5.4),
                                 bot_pct_lim=(0.0, 0.22)),
        bda_aug=pkg.BdaAugConfig(rot_lim=(-22.5, 22.5),
                                 scale_lim=(0.95, 1.05), flip_dx_ratio=0.5,
                                 flip_dy_ratio=0.5))


def _datasets(tree, n_cams=6, **kw):
    """The JAX and the port dataset over `tree`, same arguments."""
    root, info = tree
    out = []
    for pkg, mod, tiny in ((jcfg, jn, j_tiny_config), (tcfg, tn, tiny_config)):
        augs = _augs(pkg)
        if n_cams != 6:
            augs['ida_aug'] = dataclasses.replace(augs['ida_aug'],
                                                  n_cams=n_cams)
        bc = tiny().backbone
        out.append(mod.NuscDetSegDataset(
            classes=list(pkg.DET_CLASSES), data_root=root, info_paths=info,
            head_cfg=tiny().head, max_points=512, seed=7,
            seg_bounds=(bc.x_bound_seg, bc.y_bound_seg, bc.z_bound_seg),
            **augs, **kw))
    return out


def _same_value(got, want, what):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), what
        assert got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same_value(got[k], want[k], f'{what}.{k}')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same_value(g, w, f'{what}[{i}]')
    else:
        assert type(got) is type(want) and got == want, what


SAMPLE_CASES = {
    'train': dict(mode='train'),
    'val': dict(mode='val'),
    'test': dict(mode='test'),
    'cbgs': dict(mode='train', use_cbgs=True),
    'sweeps': dict(mode='train', sweep_idxes=(0,), key_idxes=(-1,)),
    'sweeps_val': dict(mode='val', sweep_idxes=(0, 3)),
    'cams4': dict(mode='train', n_cams=4),
    'dense': dict(mode='train', use_dense=True),
}


@pytest.mark.parametrize('case', list(SAMPLE_CASES))
def test_samples_match_jax(tree, case):
    """Every sample of the dataset, in order (the dataset's own RNG draws
    the augmentations and, with CBGS, the resampled order)."""
    want_ds, got_ds = _datasets(tree, **SAMPLE_CASES[case])
    assert len(got_ds) == len(want_ds) > 0
    if case == 'cbgs':
        assert got_ds.sample_indices == want_ds.sample_indices
    for i in range(len(want_ds)):
        want, got = want_ds[i], got_ds[i]
        _same_value(got, want, f'sample {i}')
    if 'sweep_idxes' in SAMPLE_CASES[case]:
        assert got['imgs'].ndim == 5
    if case == 'cams4':
        assert got['imgs'].shape[0] == 4
    if case == 'dense':
        # sample 0's dense cloud (800 points) cropped to max_points; sample
        # 1 has none and reads its sparse cloud
        assert got_ds[0]['num_points'] == 512
        assert got_ds[1]['num_points'] == 400


LOADER_CASES = {
    'threads_shuffle': dict(loader=dict(shuffle=True, num_workers=3)),
    'processes_shuffle': dict(loader=dict(shuffle=True, num_workers=2,
                                          use_processes=True)),
    'prefetch1': dict(loader=dict(shuffle=True, prefetch=1)),
    'padding_val': dict(mode='val',
                        loader=dict(drop_last=False, batch_size=3)),
    'padding_test_processes': dict(mode='test', loader=dict(
        drop_last=False, batch_size=3, use_processes=True, prefetch=1)),
    'rank1_of_2': dict(loader=dict(shuffle=True, rank=1, world_size=2,
                                   batch_size=1, drop_last=False)),
    'rank0_of_2': dict(loader=dict(shuffle=True, rank=0, world_size=2,
                                   batch_size=1)),
    'cbgs': dict(use_cbgs=True, loader=dict(shuffle=True)),
    'sweeps': dict(sweep_idxes=(0,), loader=dict(use_processes=True)),
}


@pytest.mark.parametrize('case', list(LOADER_CASES))
def test_loader_batches_match_jax(tree, case):
    """Every batch of two epochs (the loader's RNG carries over), its meta
    and sample_valid, against the JAX loader with thread workers."""
    kw = dict(LOADER_CASES[case])
    lkw = dict(batch_size=2, seed=11)
    lkw.update(kw.pop('loader'))
    kw.setdefault('mode', 'train')
    want_ds, got_ds = _datasets(tree, **kw)
    jkw = {k: v for k, v in lkw.items() if k != 'use_processes'}
    want_ld = jn.DataLoader(want_ds, **jkw)
    got_ld = tn.DataLoader(got_ds, **lkw)
    assert len(got_ld) == len(want_ld) > 0
    for epoch in range(2):
        want, got = list(want_ld), list(got_ld)
        assert len(got) == len(want) == len(want_ld)
        for bi, (g, w) in enumerate(zip(got, want)):
            _same_value(g, w, f'epoch {epoch} batch {bi}')
            assert g['imgs'].shape[0] == lkw['batch_size']
    if not lkw.get('drop_last', True):
        assert not got[-1]['sample_valid'].all()


def test_process_and_thread_workers_give_the_same_bytes(tree):
    """The port's loader gives the same batches with 1 and 3 thread
    workers and 2 process workers."""
    runs = []
    for kw in (dict(num_workers=1), dict(num_workers=3),
               dict(num_workers=2, use_processes=True)):
        _, ds = _datasets(tree, mode='train')
        runs.append(list(tn.DataLoader(ds, batch_size=2, shuffle=True,
                                       seed=5, **kw)))
    for other in runs[1:]:
        _same_value(other, runs[0], 'batches')


def test_a_failing_worker_raises(tree):
    """An error in a process worker reaches the caller."""
    _, ds = _datasets(tree, mode='val')
    ds.data_root = ds.data_root + '_missing'
    with pytest.raises(FileNotFoundError):
        list(tn.DataLoader(ds, batch_size=2, use_processes=True,
                           num_workers=2))


def test_global_gt_boxes_match_jax(tree):
    want_ds, got_ds = _datasets(tree, mode='val')
    want, got = want_ds.global_gt_boxes(), got_ds.global_gt_boxes()
    assert len(got) == N_SAMPLES
    assert sum(len(v) for v in got.values()) == 3 * N_SAMPLES
    _same_value(got, want, 'gt')
