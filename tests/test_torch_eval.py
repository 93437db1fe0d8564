"""The port's numpy evaluators against the JAX package's, on the same inputs.

`evaluation/nusc_metric.py` (the in-repo NDS/mAP), `DetNuscEvaluator`
(submission json, the in-repo branch and the devkit branch driven by the
structural mock of tests/test_eval.py), `evaluation/lidarseg.py`,
`utils/vis.py` (matplotlib's turbo in the JAX package, a carried table in
the port), `JaccardIndex.update` and `data/transforms.quat_to_rot`. Every
input is made from a seed with numpy; the two sides run the same float64 or
float32 arithmetic, so the results must be equal (NaN equal to NaN) unless a
test says otherwise.
"""
import json
import os

import numpy as np
import pytest

from test_eval import _install_mock_devkit
from vampire_tpu.configs import DET_CLASSES
from vampire_tpu.data import transforms as jax_transforms
from vampire_tpu.evaluation import det_evaluator as jax_det
from vampire_tpu.evaluation import lidarseg as jax_lidarseg
from vampire_tpu.evaluation import nusc_metric as jax_metric
from vampire_tpu.training import metrics as jax_metrics
from vampire_tpu.utils import vis as jax_vis
from vampire_tpu_torch.data import transforms
from vampire_tpu_torch.evaluation import det_evaluator, lidarseg, nusc_metric
from vampire_tpu_torch.ops import nms
from vampire_tpu_torch.training import metrics
from vampire_tpu_torch.utils import vis

CLASS_SETS = {'all': tuple(DET_CLASSES),
              'four': ('car', 'pedestrian', 'barrier', 'traffic_cone')}
ATTRS = ('', 'vehicle.moving', 'vehicle.parked', 'pedestrian.standing',
         'cycle.with_rider')


def _yaw_q(yaw):
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def _box_sets(seed, classes, n_tokens=5):
    """Global-frame GT and predictions per token: each GT box seen by a
    noisy prediction with probability 0.8 (some far off, beyond every
    threshold), plus false positives; GT with 0 points, boxes beyond their
    class range and empty tokens occur."""
    rng = np.random.RandomState(seed)
    gt, pred = {}, {}
    for t in range(n_tokens):
        tok = f'tok{t}'
        ego = np.r_[rng.uniform(-500, 500, 2), 0.0]
        g, p = [], []
        for _ in range(rng.randint(0, 14)):
            et = np.r_[rng.uniform(-60, 60, 2), rng.uniform(-2, 2)]
            g.append(dict(
                translation=(ego + et).tolist(), ego_translation=et.tolist(),
                size=rng.uniform(0.3, 5.0, 3).tolist(),
                rotation=_yaw_q(rng.uniform(-np.pi, np.pi)),
                velocity=rng.uniform(-3, 3, 2).tolist(),
                detection_name=classes[rng.randint(len(classes))],
                attribute_name=ATTRS[rng.randint(len(ATTRS))],
                num_pts=int(rng.randint(0, 5))))
        for b in g:
            if rng.rand() > 0.8:
                continue
            et = (np.asarray(b['ego_translation'])
                  + rng.normal(0, 0.3 if rng.rand() < 0.7 else 3.0, 3))
            p.append(dict(
                b, translation=(ego + et).tolist(),
                ego_translation=et.tolist(),
                size=(np.asarray(b['size'])
                      * rng.uniform(0.7, 1.3, 3)).tolist(),
                rotation=_yaw_q(rng.uniform(-np.pi, np.pi)),
                velocity=(np.asarray(b['velocity'])
                          + rng.normal(0, 0.5, 2)).tolist(),
                detection_score=float(rng.rand()),
                attribute_name=ATTRS[rng.randint(len(ATTRS))]))
        for _ in range(rng.randint(0, 8)):
            et = np.r_[rng.uniform(-60, 60, 2), 0.0]
            p.append(dict(
                translation=(ego + et).tolist(), ego_translation=et.tolist(),
                size=rng.uniform(0.3, 5.0, 3).tolist(),
                rotation=_yaw_q(rng.uniform(-np.pi, np.pi)),
                velocity=rng.uniform(-3, 3, 2).tolist(),
                detection_name=classes[rng.randint(len(classes))],
                detection_score=float(rng.rand()),
                attribute_name=ATTRS[rng.randint(len(ATTRS))]))
        gt[tok], pred[tok] = g, p
    return gt, pred


@pytest.mark.parametrize('classes', sorted(CLASS_SETS))
@pytest.mark.parametrize('seed', range(4))
def test_evaluate_detection_matches_jax(seed, classes):
    """Every entry of the metrics_summary dict, tolerance 0, NaN equal."""
    names = CLASS_SETS[classes]
    gt, pred = _box_sets(seed, names)
    want = jax_metric.evaluate_detection(gt, pred, names)
    got = nusc_metric.evaluate_detection(gt, pred, names)
    np.testing.assert_equal(got, want)
    assert 0.0 <= got['nd_score'] <= 1.0
    # the sets exercise matches: some class has a nonzero AP
    assert any(v > 0 for aps in got['label_aps'].values()
               for v in aps.values())


def test_evaluate_detection_keeps_the_box_limit():
    """MAX_BOXES_PER_SAMPLE's guard raises on both sides."""
    gt, pred = _box_sets(0, CLASS_SETS['four'])
    pred['tok0'] = pred['tok0'][:1] * (jax_metric.MAX_BOXES_PER_SAMPLE + 1)
    assert nusc_metric.MAX_BOXES_PER_SAMPLE == 500
    for mod in (jax_metric, nusc_metric):
        with pytest.raises(ValueError, match='max 500'):
            mod.evaluate_detection(gt, pred, CLASS_SETS['four'])


def test_class_ranges_and_constants_match_jax():
    for name in ('DIST_THS', 'DIST_TH_TP', 'MIN_RECALL', 'MIN_PRECISION',
                 'MAX_BOXES_PER_SAMPLE', 'MEAN_AP_WEIGHT', 'NELEM',
                 'TP_METRICS', 'CLASS_RANGE'):
        assert getattr(nusc_metric, name) == getattr(jax_metric, name), name


def _det_inputs(seed, n_tokens=3):
    """Post-NMS results (boxes (M, 9) in the key-ego frame, scores, labels)
    and metas with random ego poses, as Trainer.test hands them over."""
    rng = np.random.RandomState(seed)
    results, metas = [], []
    for t in range(n_tokens):
        m = rng.randint(0, 30)
        boxes = np.zeros((m, 9), np.float32)
        boxes[:, :2] = rng.uniform(-55, 55, (m, 2))
        boxes[:, 2] = rng.uniform(-2, 1, m)
        boxes[:, 3:6] = rng.uniform(0.3, 5, (m, 3))
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, m)
        boxes[:, 7:9] = rng.uniform(-3, 3, (m, 2))
        results.append((boxes, rng.rand(m).astype(np.float32),
                        rng.randint(0, len(DET_CLASSES), m)))
        q = rng.randn(4)
        metas.append(dict(token=f'tok{t}',
                          ego2global_rotation=(q / np.linalg.norm(q)).tolist(),
                          ego2global_translation=rng.uniform(-500, 500,
                                                             3).tolist()))
    return results, metas


def _assert_json_close(got, want, tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_json_close(got[k], want[k], tol)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_json_close(g, w, tol)
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        assert got == want


@pytest.mark.parametrize('seed', range(2))
def test_format_bbox_matches_jax(tmp_path, seed):
    results, metas = _det_inputs(seed)
    docs = []
    for mod, sub in ((jax_det, 'jax'), (det_evaluator, 'port')):
        ev = mod.DetNuscEvaluator(list(DET_CLASSES),
                                  output_dir=str(tmp_path / sub))
        with open(ev.format_bbox(results, metas)) as f:
            docs.append(json.load(f))
    assert sum(len(v) for v in docs[0]['results'].values()) > 0
    _assert_json_close(docs[1], docs[0], 1e-12)


def _gt_for(results, metas, seed):
    """Global-frame GT near the submitted boxes (format_bbox of the JAX
    package gives their global poses), with names drawn at random."""
    rng = np.random.RandomState(seed + 100)
    gt = {}
    for (boxes, _, _), meta in zip(results, metas):
        ego = np.asarray(meta['ego2global_translation'])
        rot = jax_transforms.quat_to_rot(meta['ego2global_rotation'])
        g = []
        for b in boxes:
            tr = rot @ b[:3].astype(np.float64) + ego + rng.normal(0, 0.5, 3)
            g.append(dict(translation=tr.tolist(),
                          ego_translation=(tr - ego).tolist(),
                          size=b[[4, 3, 5]].astype(np.float64).tolist(),
                          rotation=_yaw_q(rng.uniform(-np.pi, np.pi)),
                          velocity=rng.uniform(-3, 3, 2).tolist(),
                          detection_name=DET_CLASSES[
                              rng.randint(len(DET_CLASSES))],
                          attribute_name=ATTRS[rng.randint(len(ATTRS))],
                          num_pts=int(rng.randint(0, 4))))
        gt[meta['token']] = g
    return gt


@pytest.mark.parametrize('seed', range(2))
def test_inrepo_evaluate_matches_jax(tmp_path, seed):
    """The devkit-free branch: the logged detail dict and the written
    metrics_summary.json are equal."""
    results, metas = _det_inputs(seed)
    gt = _gt_for(results, metas, seed)
    out = []
    for mod, sub in ((jax_det, 'jax'), (det_evaluator, 'port')):
        ev = mod.DetNuscEvaluator(list(DET_CLASSES),
                                  output_dir=str(tmp_path / sub))
        detail = ev.evaluate(results, metas, gt_boxes=gt)
        with open(tmp_path / sub / 'metrics_summary.json') as f:
            out.append((detail, json.load(f)))
    np.testing.assert_equal(out[1], out[0])
    assert len(out[1][0]) == len(DET_CLASSES) * 9 + 7
    # without GT and without the devkit neither side scores
    for mod, sub in ((jax_det, 'jax2'), (det_evaluator, 'port2')):
        ev = mod.DetNuscEvaluator(list(DET_CLASSES),
                                  output_dir=str(tmp_path / sub))
        assert ev.evaluate(results, metas) is None


@pytest.mark.parametrize('version,eval_set', [('v1.0-mini', 'mini_val'),
                                              ('v1.0-trainval', 'val')])
def test_devkit_branch_matches_jax(tmp_path, monkeypatch, version, eval_set):
    """The official-NuScenesEval branch under the structural devkit mock
    of tests/test_eval.py: the same calls and the same detail dict."""
    results, metas = _det_inputs(0)
    out = []
    for mod, sub in ((jax_det, 'jax'), (det_evaluator, 'port')):
        calls = {}
        _install_mock_devkit(monkeypatch, tmp_path, calls)
        ev = mod.DetNuscEvaluator(list(DET_CLASSES),
                                  output_dir=str(tmp_path / sub),
                                  data_root=str(tmp_path), version=version)
        out.append(ev.evaluate(results, metas))
        assert calls['nusc']['version'] == version
        assert calls['eval']['eval_set'] == eval_set
        assert calls['eval']['output_dir'] == str(tmp_path / sub)
    assert out[1] == out[0] and len(out[1]) == len(DET_CLASSES) * 9 + 7


def test_apply_circle_nms_is_the_ports_own():
    assert det_evaluator.apply_circle_nms is nms.apply_circle_nms


def test_quat_to_rot_matches_jax():
    rng = np.random.RandomState(0)
    for q in list(rng.randn(8, 4)) + [np.zeros(4)]:
        np.testing.assert_array_equal(transforms.quat_to_rot(q),
                                      jax_transforms.quat_to_rot(q))


@pytest.mark.parametrize('with_ref_index', [False, True])
def test_lidarseg_labels_and_bins_match_jax(tmp_path, with_ref_index):
    rng = np.random.RandomState(3)
    results = {'jax': [], 'port': []}
    for i in range(3):
        P, n = 200, int(rng.randint(1, 200))
        logits = rng.randn(P, 18).astype(np.float32)
        ref = rng.randint(0, n, P) if with_ref_index else None
        want = jax_lidarseg.lidarseg_labels(logits, n, ref)
        got = lidarseg.lidarseg_labels(logits, n, ref)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        assert ((got >= 1) & (got <= 16)).all() and got.shape == (n,)
        results['jax'].append((f'lidar{i}', want))
        results['port'].append((f'lidar{i}', got))
    jax_lidarseg.write_submission(results['jax'], str(tmp_path / 'jax'))
    lidarseg.write_submission(results['port'], str(tmp_path / 'port'))
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / 'jax')
                   for d, _, fs in os.walk(tmp_path / 'jax') for f in fs)
    assert len(files) == 4
    for f in files:
        assert ((tmp_path / 'port' / f).read_bytes()
                == (tmp_path / 'jax' / f).read_bytes()), f


def test_write_submission_refuses_label_0(tmp_path):
    with pytest.raises(AssertionError, match='between 1 and 16'):
        lidarseg.write_submission([('t', np.zeros(3, np.uint8))],
                                  str(tmp_path))


@pytest.mark.parametrize('vmin,vmax', [(2.0, 70.4), (0, 10), (-5.0, 3.0)])
def test_visualize_depth_matches_jax(vmin, vmax):
    """Byte-equal panels over random depths beyond both ends, the ends
    themselves, a sweep across every table entry, inf and NaN."""
    rng = np.random.RandomState(0)
    d = rng.uniform(vmin - 5, vmax + 5, (40, 300)).astype(np.float32)
    d[0, :6] = [vmin, vmax, np.nan, np.inf, -np.inf, vmax + 1e-3]
    d[1] = np.linspace(vmin, vmax, 300, dtype=np.float32)
    want = jax_vis.visualize_depth(d, vmin, vmax)
    got = vis.visualize_depth(d, vmin, vmax)
    assert got.dtype == want.dtype == np.uint8 and got.shape == (40, 300, 3)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[1].reshape(-1, 3), axis=0)) > 200
    np.testing.assert_array_equal(got[0, 2], [0, 0, 0])   # NaN: "bad"


def test_visualize_semantic_and_tiles_match_jax():
    rng = np.random.RandomState(1)
    lab = rng.randint(-3, 22, (6, 9, 11))
    np.testing.assert_array_equal(vis.SEMANTIC_PALETTE,
                                  jax_vis.SEMANTIC_PALETTE)
    sem = [vis.visualize_semantic(x) for x in lab]
    for got, x in zip(sem, lab):
        np.testing.assert_array_equal(got, jax_vis.visualize_semantic(x))
    np.testing.assert_array_equal(vis.tile_cameras(np.stack(sem)),
                                  jax_vis.tile_cameras(np.stack(sem)))


@pytest.mark.parametrize('ignore_index', [None, 0])
@pytest.mark.parametrize('with_valid', [False, True])
def test_jaccard_update_matches_jax(ignore_index, with_valid):
    rng = np.random.RandomState(2)
    got = metrics.JaccardIndex(17, ignore_index=ignore_index)
    want = jax_metrics.JaccardIndex(17, ignore_index=ignore_index)
    for _ in range(3):
        preds, labels = rng.randint(0, 17, (2, 500))
        valid = rng.rand(500) > 0.3 if with_valid else None
        got.update(preds, labels, valid)
        want.update(preds, labels, valid)
    np.testing.assert_array_equal(got.conf, want.conf)
    np.testing.assert_array_equal(got.compute(), want.compute())
