"""In-repo numpy implementation of the official nuScenes detection metric;
the port's copy of `vampire_tpu/evaluation/nusc_metric.py`.

The reference runs `nuscenes.eval.detection.evaluate.NuScenesEval`
(src/evaluators/det_evaluators.py:61-117) — an external devkit dependency.
This module re-implements that metric (the `detection_cvpr_2019`
configuration) so NDS/mAP can be produced without the devkit: per-class
greedy center-distance matching at thresholds {0.5, 1, 2, 4} m, 101-point
interpolated AP with min_recall/min_precision 0.1, the five TP errors
(ATE/ASE/AOE/AVE/AAE) as confidence-interpolated cumulative means at the
2 m threshold, and the NDS composition (5·mAP + Σ(1−err))/10.

Deviations from the devkit (documented, DEVIATIONS.md):
  * no bike-rack filter (needs the map DB); GT num_pts and class-range
    filters are applied.
  * GT attributes come from the info pkl (`attribute_names`, written by
    scripts/gen_info.py); absent attributes behave like the devkit's
    empty-attribute case (AAE contribution is NaN-skipped).

Box dicts (both GT and pred): translation (3,), size (w,l,h), rotation
(wxyz quaternion), velocity (2,), detection_name, ego_translation (3,);
pred adds detection_score + attribute_name; GT adds num_pts +
attribute_name.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

DIST_THS = (0.5, 1.0, 2.0, 4.0)
DIST_TH_TP = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
MAX_BOXES_PER_SAMPLE = 500
MEAN_AP_WEIGHT = 5
NELEM = 101
TP_METRICS = ('trans_err', 'scale_err', 'orient_err', 'vel_err', 'attr_err')

# detection_cvpr_2019 class ranges (devkit eval_detection_configs)
CLASS_RANGE = {
    'car': 50, 'truck': 50, 'bus': 50, 'trailer': 50,
    'construction_vehicle': 50, 'pedestrian': 40, 'motorcycle': 40,
    'bicycle': 40, 'traffic_cone': 30, 'barrier': 30,
}


def quaternion_yaw(q) -> float:
    """Yaw of a wxyz quaternion: heading of the rotated x-axis projected to
    the xy-plane (devkit eval.common.utils.quaternion_yaw)."""
    w, x, y, z = np.asarray(q, np.float64)
    # rotate [1, 0, 0]
    vx = 1 - 2 * (y * y + z * z)
    vy = 2 * (x * y + z * w)
    return float(np.arctan2(vy, vx))


def center_distance(gt, pred) -> float:
    return float(np.linalg.norm(
        np.asarray(pred['translation'][:2], np.float64)
        - np.asarray(gt['translation'][:2], np.float64)))


def scale_iou(gt, pred) -> float:
    """IoU of the two boxes aligned at the same center and orientation."""
    sa = np.asarray(gt['size'], np.float64)
    sb = np.asarray(pred['size'], np.float64)
    assert np.all(sa > 0) and np.all(sb > 0)
    inter = float(np.prod(np.minimum(sa, sb)))
    union = float(np.prod(sa) + np.prod(sb) - inter)
    return inter / union


def yaw_diff(gt, pred, period: float) -> float:
    ya = quaternion_yaw(gt['rotation'])
    yb = quaternion_yaw(pred['rotation'])
    diff = (ya - yb + period / 2) % period - period / 2
    if diff > np.pi:
        diff -= 2 * np.pi
    return abs(float(diff))


def velocity_l2(gt, pred) -> float:
    return float(np.linalg.norm(
        np.asarray(pred['velocity'][:2], np.float64)
        - np.asarray(gt['velocity'][:2], np.float64)))


def attr_acc(gt, pred) -> float:
    if not gt.get('attribute_name', ''):
        return np.nan
    return float(gt['attribute_name'] == pred.get('attribute_name', ''))


def cummean(x: np.ndarray) -> np.ndarray:
    """NaN-skipping cumulative mean (devkit eval.common.utils.cummean)."""
    if np.all(np.isnan(x)):
        return np.ones(len(x))
    sum_vals = np.nancumsum(x.astype(np.float64))
    count_vals = np.cumsum(~np.isnan(x))
    return np.divide(sum_vals, count_vals, out=np.zeros_like(sum_vals),
                     where=count_vals > 0)


def _ego_dist(box) -> float:
    et = box.get('ego_translation')
    if et is None:
        return 0.0
    return float(np.linalg.norm(np.asarray(et[:2], np.float64)))


def filter_eval_boxes(boxes_by_token: Dict[str, List[dict]],
                      is_gt: bool) -> Dict[str, List[dict]]:
    """Class-range + (GT) zero-point filtering (devkit filter_eval_boxes,
    minus the map-dependent bike-rack filter)."""
    out = {}
    for token, boxes in boxes_by_token.items():
        kept = [b for b in boxes
                if _ego_dist(b) < CLASS_RANGE[b['detection_name']]]
        if is_gt:
            kept = [b for b in kept if int(b.get('num_pts', 1)) > 0]
        out[token] = kept
    return out


def _no_predictions_md() -> dict:
    return dict(recall=np.linspace(0, 1, NELEM),
                precision=np.zeros(NELEM), confidence=np.zeros(NELEM),
                trans_err=np.ones(NELEM), vel_err=np.ones(NELEM),
                scale_err=np.ones(NELEM), orient_err=np.ones(NELEM),
                attr_err=np.ones(NELEM))


def accumulate(gt_by_token: Dict[str, List[dict]],
               pred_by_token: Dict[str, List[dict]],
               class_name: str, dist_th: float) -> dict:
    """Greedy matching + interpolated PR / TP-error curves for one
    (class, threshold) pair (devkit eval.detection.algo.accumulate)."""
    npos = sum(1 for boxes in gt_by_token.values() for b in boxes
               if b['detection_name'] == class_name)
    if npos == 0:
        return _no_predictions_md()

    preds = [(t, b) for t, boxes in pred_by_token.items() for b in boxes
             if b['detection_name'] == class_name]
    preds.sort(key=lambda tb: -tb[1]['detection_score'])

    tp, fp, conf = [], [], []
    match_data = {k: [] for k in TP_METRICS}
    match_conf = []
    taken = set()
    period = np.pi if class_name == 'barrier' else 2 * np.pi
    for token, pred in preds:
        min_dist, match_idx = np.inf, None
        for gt_idx, gt in enumerate(gt_by_token.get(token, [])):
            if (gt['detection_name'] == class_name
                    and (token, gt_idx) not in taken):
                d = center_distance(gt, pred)
                if d < min_dist:
                    min_dist, match_idx = d, gt_idx
        score = float(pred['detection_score'])
        if min_dist < dist_th:
            taken.add((token, match_idx))
            gt = gt_by_token[token][match_idx]
            tp.append(1)
            fp.append(0)
            conf.append(score)
            match_data['trans_err'].append(center_distance(gt, pred))
            match_data['vel_err'].append(velocity_l2(gt, pred))
            match_data['scale_err'].append(1 - scale_iou(gt, pred))
            match_data['orient_err'].append(yaw_diff(gt, pred, period))
            match_data['attr_err'].append(1 - attr_acc(gt, pred))
            match_conf.append(score)
        else:
            tp.append(0)
            fp.append(1)
            conf.append(score)

    if len(match_data['trans_err']) == 0:
        return _no_predictions_md()

    tp = np.cumsum(tp).astype(np.float64)
    fp = np.cumsum(fp).astype(np.float64)
    conf = np.array(conf, np.float64)
    prec = tp / (fp + tp)
    rec = tp / float(npos)
    rec_interp = np.linspace(0, 1, NELEM)
    prec_i = np.interp(rec_interp, rec, prec, right=0)
    conf_i = np.interp(rec_interp, rec, conf, right=0)

    md = dict(recall=rec_interp, precision=prec_i, confidence=conf_i)
    mconf = np.array(match_conf, np.float64)
    for key in TP_METRICS:
        tmp = cummean(np.array(match_data[key], np.float64))
        # interp wants ascending x: reverse the descending-confidence curves
        md[key] = np.interp(conf_i[::-1], mconf[::-1], tmp[::-1])[::-1]
    return md


def calc_ap(md: dict, min_recall: float = MIN_RECALL,
            min_precision: float = MIN_PRECISION) -> float:
    prec = np.copy(md['precision'])
    prec = prec[round(100 * min_recall) + 1:]
    prec -= min_precision
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - min_precision)


def _max_recall_ind(md: dict) -> int:
    non_zero = np.nonzero(md['confidence'])[0]
    return int(non_zero[-1]) if len(non_zero) else 0


def calc_tp(md: dict, metric_name: str,
            min_recall: float = MIN_RECALL) -> float:
    first_ind = round(100 * min_recall) + 1
    last_ind = _max_recall_ind(md)
    if last_ind < first_ind:
        return 1.0
    return float(np.mean(md[metric_name][first_ind:last_ind + 1]))


def evaluate_detection(gt_by_token: Dict[str, List[dict]],
                       pred_by_token: Dict[str, List[dict]],
                       class_names: Sequence[str]) -> dict:
    """Full metric: returns a dict shaped like the devkit's
    metrics_summary.json (label_aps, label_tp_errors, tp_errors, mean_ap,
    nd_score)."""
    for token, boxes in pred_by_token.items():
        if len(boxes) > MAX_BOXES_PER_SAMPLE:
            raise ValueError(f'sample {token} has {len(boxes)} boxes '
                             f'(max {MAX_BOXES_PER_SAMPLE})')
    # every GT token must appear in preds (devkit asserts the reverse too,
    # but an eval over a loader subset is legitimate here)
    gt_by_token = {t: b for t, b in gt_by_token.items()
                   if t in pred_by_token}
    gt_by_token = filter_eval_boxes(gt_by_token, is_gt=True)
    pred_by_token = filter_eval_boxes(pred_by_token, is_gt=False)

    label_aps: Dict[str, Dict[str, float]] = {}
    label_tp_errors: Dict[str, Dict[str, float]] = {}
    for cls in class_names:
        mds = {th: accumulate(gt_by_token, pred_by_token, cls, th)
               for th in DIST_THS}
        label_aps[cls] = {str(th): calc_ap(mds[th]) for th in DIST_THS}
        errs = {}
        for metric in TP_METRICS:
            if cls == 'traffic_cone' and metric in ('attr_err', 'vel_err',
                                                    'orient_err'):
                errs[metric] = np.nan
            elif cls == 'barrier' and metric in ('attr_err', 'vel_err'):
                errs[metric] = np.nan
            else:
                errs[metric] = calc_tp(mds[DIST_TH_TP], metric)
        label_tp_errors[cls] = errs

    mean_ap = float(np.mean([v for aps in label_aps.values()
                             for v in aps.values()]))
    tp_errors = {}
    for metric in TP_METRICS:
        vals = [label_tp_errors[c][metric] for c in class_names]
        with np.errstate(invalid='ignore'):
            tp_errors[metric] = float(np.nanmean(vals)) if np.any(
                ~np.isnan(vals)) else np.nan
    tp_scores = {m: max(0.0, 1.0 - tp_errors[m]) if not np.isnan(
        tp_errors[m]) else 0.0 for m in TP_METRICS}
    nd_score = (MEAN_AP_WEIGHT * mean_ap + sum(tp_scores.values())) / (
        MEAN_AP_WEIGHT + len(TP_METRICS))
    return dict(label_aps=label_aps, label_tp_errors=label_tp_errors,
                tp_errors=tp_errors, mean_ap=mean_ap,
                nd_score=float(nd_score))
