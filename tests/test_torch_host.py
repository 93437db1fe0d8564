"""The port's own copies of the JAX package's host modules match it exactly:
the configs, `synthetic_batch`, `assign_targets_batch`, the three NMS
routines (the C++ library built with `c++`, and its numpy plain version)
and `apply_circle_nms`; and a failed build of the host NMS raises."""
import dataclasses

import numpy as np
import pytest

from vampire_tpu import configs as jcfg
from vampire_tpu.data import synthetic as jsyn
from vampire_tpu.evaluation.det_evaluator import \
    apply_circle_nms as j_apply_circle_nms
from vampire_tpu.ops import nms as jnms
from vampire_tpu.ops.target_assign import \
    assign_targets_batch as j_assign_targets_batch
from vampire_tpu_torch import configs as tcfg
from vampire_tpu_torch.data import synthetic as tsyn
from vampire_tpu_torch.ops import _build
from vampire_tpu_torch.ops import nms as tnms
from vampire_tpu_torch.ops.target_assign import assign_targets_batch


@pytest.mark.parametrize('name', ['flagship_config', 'tiny_config'])
def test_configs_match(name):
    if name == 'flagship_config':
        a, b = tcfg.flagship_config(), jcfg.flagship_config()
    else:
        a, b = tsyn.tiny_config(), jsyn.tiny_config()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.backbone.depth_channels == b.backbone.depth_channels
    assert a.backbone.grid_zyx('det') == b.backbone.grid_zyx('det')
    assert a.head.feature_map_size == b.head.feature_map_size
    assert a.train.lr == b.train.lr
    assert tcfg.LABEL_17_NAMES == jcfg.LABEL_17_NAMES


@pytest.mark.parametrize('mode', ['train', 'val'])
@pytest.mark.parametrize('seed', [0, 5])
def test_synthetic_batch_matches(mode, seed):
    cfg = tsyn.tiny_config()
    got = tsyn.synthetic_batch(cfg, batch_size=2, seed=seed, mode=mode)
    want = jsyn.synthetic_batch(jsyn.tiny_config(), batch_size=2, seed=seed,
                                mode=mode)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tcfg.camera_rig is tsyn.camera_rig
    rig = tsyn.camera_rig(1, 6, (256, 704), seed=seed)
    for k, v in jsyn.camera_rig(1, 6, (256, 704), seed=seed).items():
        np.testing.assert_array_equal(rig[k], v, err_msg=k)


def test_assign_targets_batch_matches():
    rng = np.random.RandomState(0)
    hc = tsyn.tiny_config().head
    boxes, labels = [], []
    for m in (0, 7, 40):        # none, some, more than max_objs
        b = np.zeros((m, 9), np.float32)
        b[:, :2] = rng.uniform(-5, 5, (m, 2))
        b[:, 2] = rng.uniform(-1, 1, m)
        b[:, 3:6] = rng.uniform(0.3, 4.0, (m, 3))
        b[:, 6] = rng.uniform(-np.pi, np.pi, m)
        b[:, 7:] = rng.uniform(-2, 2, (m, 2))
        boxes.append(b)
        labels.append(rng.randint(0, 10, m))
    got = assign_targets_batch(boxes, labels, hc)
    want = j_assign_targets_batch(boxes, labels, jsyn.tiny_config().head)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _boxes(n, seed):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-20, 20, (n, 2)).astype(np.float32)
    wl = rng.uniform(0.5, 5, (n, 2)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, (n, 1)).astype(np.float32)
    score = rng.uniform(0, 1, n).astype(np.float32)
    return xy, wl, yaw, score


@pytest.mark.parametrize('kind', ['circle', 'size_aware', 'rotated'])
@pytest.mark.parametrize('seed', [0, 1])
def test_nms_matches(kind, seed):
    """The port's C++ NMS, built here with `c++`, its numpy plain version
    and the JAX package's NMS keep the same indices."""
    xy, wl, yaw, score = _boxes(300, seed)
    if kind == 'circle':
        dets = np.concatenate([xy, score[:, None]], 1)
        args = (dets, 4.0)
        fns = (tnms.circle_nms, tnms.circle_nms_reference, jnms.circle_nms)
    elif kind == 'size_aware':
        dets = np.concatenate([xy, wl, yaw, score[:, None]], 1)
        args = (dets, 0.5)
        fns = (tnms.size_aware_circle_nms,
               tnms.size_aware_circle_nms_reference,
               jnms.size_aware_circle_nms)
    else:
        args = (np.concatenate([xy, wl, yaw], 1), score, 0.1)
        fns = (tnms.rotated_nms, tnms.rotated_nms_reference, jnms.rotated_nms)
    got = [fn(*args, post_max_size=83) for fn in fns]
    assert 0 < len(got[2]) <= 83
    for g in got[:2]:
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, got[2])
    for fn in fns[:2]:
        assert fn(args[0][:0], *args[1:]).shape == (0,)


@pytest.mark.parametrize('nms_type', ['circle', 'rotate', 'size_aware'])
def test_apply_circle_nms_matches(nms_type):
    hc = dataclasses.replace(tsyn.tiny_config().head, nms_type=nms_type)
    rng = np.random.RandomState(2)
    B, M = 2, 30
    tasks = []
    for _ in hc.tasks:
        boxes = np.zeros((B, M, 9), np.float32)
        boxes[..., :2] = rng.uniform(-6, 6, (B, M, 2))
        boxes[..., 3:6] = rng.uniform(0.5, 3, (B, M, 3))
        boxes[..., 6] = rng.uniform(-np.pi, np.pi, (B, M))
        tasks.append(dict(bboxes=boxes,
                          scores=rng.uniform(0, 1, (B, M)).astype(np.float32),
                          labels=rng.randint(0, 2, (B, M)).astype(np.int32),
                          valid=rng.rand(B, M) > 0.3))
    for b in range(B):
        got = tnms.apply_circle_nms(tasks, hc, b)
        want = j_apply_circle_nms(tasks, hc, b)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert len(got[0]) > 0


def test_failed_host_nms_build_raises(monkeypatch, tmp_path):
    """A host NMS that does not build raises on the serving path
    (`apply_circle_nms`); nothing falls back to the numpy loops."""
    src = tmp_path / 'csrc'
    src.mkdir()
    (src / 'host_nms.cpp').write_text('this is not C++\n')
    monkeypatch.setattr(_build, 'CSRC', str(src))
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(_build, '_libs', {})
    hc = tsyn.tiny_config().head
    task = dict(bboxes=np.zeros((1, 2, 9), np.float32),
                scores=np.ones((1, 2), np.float32),
                labels=np.zeros((1, 2), np.int32),
                valid=np.ones((1, 2), bool))
    with pytest.raises(RuntimeError, match='c\\+\\+ failed'):
        tnms.apply_circle_nms([task] * len(hc.tasks), hc, 0)
