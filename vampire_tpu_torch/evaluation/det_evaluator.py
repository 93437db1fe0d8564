"""nuScenes detection submission writer + official eval runner; the port's
copy of `vampire_tpu/evaluation/det_evaluator.py` (numpy, host side).

Re-derives `DetNuscEvaluator` (src/evaluators/det_evaluators.py:15-299)
without mmcv/pyquaternion: boxes decoded in the (bda'd) key-ego frame are
rotated/translated into the global frame, given attribute heuristics, and
written as a nuScenes submission json. Running the official `NuScenesEval`
requires nuscenes-devkit + the dataset (gated import); without them
`evaluate` scores with the in-repo metric (`nusc_metric.py`) when the caller
gives the GT. `apply_circle_nms`, which the JAX package defines here, is
re-exported from the port's `ops/nms.py`.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.transforms import quat_to_rot
from ..ops.nms import apply_circle_nms  # noqa: F401

DEFAULT_ATTRIBUTE = {
    'car': 'vehicle.parked',
    'pedestrian': 'pedestrian.moving',
    'trailer': 'vehicle.parked',
    'truck': 'vehicle.parked',
    'bus': 'vehicle.moving',
    'motorcycle': 'cycle.without_rider',
    'construction_vehicle': 'vehicle.parked',
    'bicycle': 'cycle.without_rider',
    'barrier': '',
    'traffic_cone': '',
}

ERR_NAME_MAPPING = {
    'trans_err': 'mATE', 'scale_err': 'mASE', 'orient_err': 'mAOE',
    'vel_err': 'mAVE', 'attr_err': 'mAAE',
}


def _quat_multiply(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _yaw_quat(yaw: float) -> np.ndarray:
    return np.array([np.cos(yaw / 2.0), 0.0, 0.0, np.sin(yaw / 2.0)])


class DetNuscEvaluator:
    def __init__(self, class_names: Sequence[str],
                 output_dir: str,
                 eval_version: str = 'detection_cvpr_2019',
                 data_root: str = './data/nuScenes',
                 version: str = 'v1.0-trainval',
                 modality: Optional[dict] = None):
        self.class_names = list(class_names)
        self.output_dir = output_dir
        self.eval_version = eval_version
        self.data_root = data_root
        self.version = version
        self.modality = modality or dict(use_lidar=False, use_camera=True,
                                         use_radar=False, use_map=False,
                                         use_external=False)

    def _attr(self, name: str, velocity) -> str:
        """Attribute heuristics (det_evaluators.py:254-274)."""
        if np.sqrt(velocity[0] ** 2 + velocity[1] ** 2) > 0.2:
            if name in ('car', 'construction_vehicle', 'bus', 'truck',
                        'trailer'):
                return 'vehicle.moving'
            if name in ('bicycle', 'motorcycle'):
                return 'cycle.with_rider'
            return DEFAULT_ATTRIBUTE[name]
        if name == 'pedestrian':
            return 'pedestrian.standing'
        if name == 'bus':
            return 'vehicle.stopped'
        return DEFAULT_ATTRIBUTE[name]

    def format_bbox(self, results: List, img_metas: List[dict]) -> str:
        """results: list of (boxes (M, 9), scores (M,), labels (M,)) per
        sample (post-NMS host arrays); img_metas: dicts with token +
        ego2global_{rotation,translation}. Writes results_nusc.json."""
        nusc_annos: Dict[str, list] = {}
        for det, meta in zip(results, img_metas):
            boxes, scores, labels = det[:3]
            token = meta['token']
            trans = np.asarray(meta['ego2global_translation'], np.float64)
            rot_q = np.asarray(meta['ego2global_rotation'], np.float64)
            rot_q = rot_q / np.linalg.norm(rot_q)
            rot_m = quat_to_rot(rot_q)
            annos = []
            for i, box in enumerate(np.asarray(boxes)):
                name = self.class_names[int(labels[i])]
                center = box[:3].astype(np.float64)
                wlh = box[[4, 3, 5]].astype(np.float64)
                yaw = float(box[6])
                vel = np.array([box[7], box[8], 0.0], np.float64)
                # Box.rotate(q) then translate (det_evaluators.py:250-253)
                center = rot_m @ center + trans
                quat = _quat_multiply(rot_q, _yaw_quat(yaw))
                vel = rot_m @ vel
                annos.append(dict(
                    sample_token=token,
                    translation=center.tolist(),
                    size=wlh.tolist(),
                    rotation=quat.tolist(),
                    velocity=vel[:2].tolist(),
                    detection_name=name,
                    detection_score=float(scores[i]),
                    attribute_name=self._attr(name, vel),
                ))
            nusc_annos.setdefault(token, []).extend(annos)
        os.makedirs(self.output_dir, exist_ok=True)
        res_path = os.path.join(self.output_dir, 'results_nusc.json')
        with open(res_path, 'w') as f:
            json.dump({'meta': self.modality, 'results': nusc_annos}, f)
        return res_path

    def evaluate(self, results: List, img_metas: List[dict],
                 gt_boxes: Optional[Dict[str, list]] = None
                 ) -> Optional[dict]:
        """Write submission, then run official NuScenesEval if the devkit and
        dataset are available (det_evaluators.py:61-117). Without the devkit,
        falls back to the in-repo numpy metric (evaluation/nusc_metric.py)
        when the caller supplies `gt_boxes` (global-frame GT per token, as
        built by NuscDetSegDataset.global_gt_boxes). Returns the metric
        detail dict or None when neither path can run."""
        result_path = self.format_bbox(results, img_metas)
        try:
            from nuscenes import NuScenes
            from nuscenes.eval.detection.config import config_factory
            from nuscenes.eval.detection.evaluate import NuScenesEval
        except ImportError:
            if gt_boxes is not None:
                return self._evaluate_inrepo(result_path, img_metas,
                                             gt_boxes)
            print(f'nuscenes-devkit unavailable; submission written to '
                  f'{result_path}')
            return None
        nusc = NuScenes(version=self.version, dataroot=self.data_root,
                        verbose=False)
        eval_set = {'v1.0-mini': 'mini_val', 'v1.0-trainval': 'val',
                    'v1.0-test': 'test'}[self.version]
        nusc_eval = NuScenesEval(nusc,
                                 config=config_factory(self.eval_version),
                                 result_path=result_path, eval_set=eval_set,
                                 output_dir=self.output_dir, verbose=False)
        nusc_eval.main(render_curves=False)
        with open(os.path.join(self.output_dir, 'metrics_summary.json')) as f:
            metrics = json.load(f)
        detail = self._detail(metrics)
        print(f"NDS: {metrics['nd_score']:.4f}  mAP: {metrics['mean_ap']:.4f}")
        return detail

    def _detail(self, metrics: dict) -> dict:
        """The logged keys of a metrics_summary dict (det_evaluators.py:
        100-117)."""
        detail = {}
        prefix = 'img_bbox_NuScenes'
        for cls in self.class_names:
            for k, v in metrics['label_aps'][cls].items():
                detail[f'{prefix}/{cls}_AP_dist_{k}'] = round(float(v), 4)
            for k, v in metrics['label_tp_errors'][cls].items():
                detail[f'{prefix}/{cls}_{k}'] = round(float(v), 4)
        for k, v in metrics['tp_errors'].items():
            detail[f'{prefix}/{ERR_NAME_MAPPING[k]}'] = round(float(v), 4)
        detail[f'{prefix}/NDS'] = metrics['nd_score']
        detail[f'{prefix}/mAP'] = metrics['mean_ap']
        return detail

    def _evaluate_inrepo(self, result_path: str, img_metas: List[dict],
                         gt_boxes: Dict[str, list]) -> dict:
        """Devkit-free metric: read the just-written submission back (so the
        scored boxes are exactly the submitted ones), attach per-box ego
        distances from the sample's ego pose, and run
        nusc_metric.evaluate_detection. Writes metrics_summary.json with the
        devkit's structure."""
        from .nusc_metric import evaluate_detection
        with open(result_path) as f:
            sub = json.load(f)['results']
        ego_by_token = {m['token']: np.asarray(m['ego2global_translation'],
                                               np.float64)
                        for m in img_metas}
        pred_by_token: Dict[str, list] = {}
        for token, annos in sub.items():
            ego = ego_by_token.get(token)
            boxes = []
            for a in annos:
                b = dict(a)
                if ego is not None:
                    b['ego_translation'] = (
                        np.asarray(a['translation']) - ego).tolist()
                boxes.append(b)
            pred_by_token[token] = boxes
        metrics = evaluate_detection(gt_boxes, pred_by_token,
                                     self.class_names)
        summary_path = os.path.join(self.output_dir, 'metrics_summary.json')
        with open(summary_path, 'w') as f:
            json.dump(dict(
                label_aps=metrics['label_aps'],
                label_tp_errors=metrics['label_tp_errors'],
                tp_errors=metrics['tp_errors'],
                mean_ap=metrics['mean_ap'], nd_score=metrics['nd_score']),
                f, default=float)
        detail = self._detail(metrics)
        print(f"[in-repo metric] NDS: {metrics['nd_score']:.4f}  "
              f"mAP: {metrics['mean_ap']:.4f}")
        return detail

