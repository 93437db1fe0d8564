"""nuScenes dataset: info-pkl driven, numpy host pipeline (no torch); the
port of `vampire_tpu/data/nuscenes.py`, which gives the same samples and
batches byte for byte (tests/test_torch_loader.py).

Re-derives `NuscDetSegDataset` (nusc_det_seg_dataset.py:374-946) for the
input pipeline:

  * samples come from the offline info pickles written by
    `scripts/gen_info.py` (same schema as the reference's
    nuscenes_occ_infos_{train,val}.pkl);
  * per-camera matrices are built from quaternions exactly like
    get_image (:599-659): sensor2ego through the global frame of the key
    ego pose, sensor2sensor for sweep frames, 4x4 intrinsics, ida homography;
  * LiDAR depth/label projection to each image (train), ego-frame point cloud
    with lidarseg labels, BEV seg/height raster, Occ3D npz labels;
  * ragged things (points, GT boxes) are padded to static sizes and
    CenterPoint targets are assigned host-side (ops.target_assign), so every
    batch has the same shapes.

Batches stay numpy; `Trainer.to_device` moves them to the card. Every image
is decoded and augmented by `NuscDetSegDataset.load_image`, the one use of
PIL (imported there). The loader's process workers start by `spawn`, which
is safe in a process that already holds a CUDA context and threads; they
import numpy, this package's host modules and (as `spawn` does) the main
module of the parent, and touch no CUDA.

Class-name maps copied semantics (:16-83).
"""
from __future__ import annotations

import concurrent.futures as cf
import copy
import os
import pickle
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..configs import (BdaAugConfig, HeadConfig, IdaAugConfig, IMG_MEAN,
                       IMG_STD)
from ..ops.target_assign import assign_targets_single
from . import transforms as T

MAP_NAME_GENERAL_TO_DET_SEG = {
    'animal': 'ignore',
    'human.pedestrian.adult': 'pedestrian',
    'human.pedestrian.child': 'pedestrian',
    'human.pedestrian.construction_worker': 'pedestrian',
    'human.pedestrian.personal_mobility': 'ignore',
    'human.pedestrian.police_officer': 'pedestrian',
    'human.pedestrian.stroller': 'ignore',
    'human.pedestrian.wheelchair': 'ignore',
    'movable_object.barrier': 'barrier',
    'movable_object.debris': 'ignore',
    'movable_object.pushable_pullable': 'ignore',
    'movable_object.trafficcone': 'traffic_cone',
    'static_object.bicycle_rack': 'ignore',
    'vehicle.bicycle': 'bicycle',
    'vehicle.bus.bendy': 'bus',
    'vehicle.bus.rigid': 'bus',
    'vehicle.car': 'car',
    'vehicle.construction': 'construction_vehicle',
    'vehicle.emergency.ambulance': 'ignore',
    'vehicle.emergency.police': 'ignore',
    'vehicle.motorcycle': 'motorcycle',
    'vehicle.trailer': 'trailer',
    'vehicle.truck': 'truck',
    'flat.driveable_surface': 'driveable_surface',
    'flat.other': 'other_flat',
    'flat.sidewalk': 'sidewalk',
    'flat.terrain': 'terrain',
    'static.manmade': 'manmade',
    'static.other': 'ignore',
    'static.vegetation': 'vegetation',
    'vehicle.ego': 'ignore',
}

# raw lidarseg (32 classes) -> 17-class ids (nusc_det_seg_dataset.py:50-83)
MAP_IDX_GENERAL_TO_SEG = np.array(
    [0, 0, 7, 7, 7, 0, 7, 0, 0, 1, 0, 0, 8, 0, 2, 3, 3, 4, 5, 0, 0, 6, 9,
     10, 11, 12, 13, 14, 15, 0, 16, 0], dtype=np.int8)


def _load_infos(info_paths) -> List[dict]:
    paths = info_paths if isinstance(info_paths, (list, tuple)) else [info_paths]
    infos: List[dict] = []
    for p in paths:
        with open(p, 'rb') as f:
            infos.extend(pickle.load(f))
    return infos


class NuscDetSegDataset:
    """Map-style dataset returning per-sample dicts of numpy arrays."""

    def __init__(self,
                 ida_aug: IdaAugConfig,
                 bda_aug: BdaAugConfig,
                 classes: Sequence[str],
                 data_root: str,
                 info_paths,
                 head_cfg: HeadConfig,
                 mode: str = 'train',
                 use_cbgs: bool = False,
                 use_dense: bool = False,
                 num_sweeps: int = 1,
                 img_mean=IMG_MEAN,
                 img_std=IMG_STD,
                 sweep_idxes: Sequence[int] = (),
                 key_idxes: Sequence[int] = (),
                 max_points: int = 36864,
                 seed: int = 0,
                 seg_bounds=None):
        """seg_bounds: ((x0,x1,sx),(y0,y1,sy),(z0,z1,sz)) of the model's seg
        field grid (cfg.backbone.*_bound_seg) — drives the BEV raster shape;
        None = the reference/flagship grid (get_bev_seg_map, :233-265)."""
        self.infos = _load_infos(info_paths)
        self.mode = mode
        self.ida_aug = ida_aug
        self.bda_aug = bda_aug
        self.classes = list(classes)
        self.data_root = data_root
        self.head_cfg = head_cfg
        self.use_cbgs = use_cbgs
        self.use_dense = use_dense
        self.num_sweeps = num_sweeps
        self.img_mean = np.asarray(img_mean, np.float32)
        self.img_std = np.asarray(img_std, np.float32)
        self.sweeps_idx = list(sweep_idxes)
        self.key_idxes = [0] + list(key_idxes)
        self.max_points = max_points
        self.seg_bounds = seg_bounds
        self.rng = np.random.RandomState(seed)
        if use_cbgs:
            self.cat2id = {n: i for i, n in enumerate(self.classes)}
            self.sample_indices = self._get_sample_indices()

    # ------------------------------------------------------------------
    def _get_sample_indices(self) -> List[int]:
        """CBGS class-balanced resampling (:437-470)."""
        class_sample_idxs: Dict[int, List[int]] = {
            i: [] for i in self.cat2id.values()}
        for idx, info in enumerate(self.infos):
            names = set(a['category_name'] for a in info['ann_infos'])
            for name in names:
                mapped = MAP_NAME_GENERAL_TO_DET_SEG.get(name, 'ignore')
                if mapped in self.classes:
                    class_sample_idxs[self.cat2id[mapped]].append(idx)
        duplicated = sum(len(v) for v in class_sample_idxs.values())
        # classes absent from this split (e.g. mini) contribute no samples;
        # skip them rather than dividing by their zero frequency
        dist = {k: len(v) / duplicated for k, v in class_sample_idxs.items()
                if v}
        out: List[int] = []
        frac = 1.0 / len(self.classes)
        for k, ratio in ((k, frac / v) for k, v in dist.items()):
            cls_inds = class_sample_idxs[k]
            out += self.rng.choice(cls_inds,
                                   int(len(cls_inds) * ratio)).tolist()
        return out

    def __len__(self) -> int:
        return len(self.sample_indices) if self.use_cbgs else len(self.infos)

    def global_gt_boxes(self) -> Dict[str, list]:
        """Global-frame GT boxes per sample token for the in-repo detection
        metric (evaluation/nusc_metric.py) — the data the devkit's load_gt
        reads from the DB: translation/size/rotation/velocity in the global
        frame, ego_translation relative to the sample's ego pose, num_pts,
        attribute name (gen_info.py stores `attribute_names` on each ann;
        absent on older pkls -> '' and AAE falls back to NaN-skip)."""
        out: Dict[str, list] = {}
        for info in self.infos:
            ego = np.asarray(
                info['lidar_infos']['LIDAR_TOP']['ego_pose']['translation'],
                np.float64)
            boxes = []
            for ann in info['ann_infos']:
                name = MAP_NAME_GENERAL_TO_DET_SEG.get(ann['category_name'],
                                                       'ignore')
                if name not in self.classes:
                    continue
                attrs = ann.get('attribute_names', [])
                tr = np.asarray(ann['translation'], np.float64)
                boxes.append(dict(
                    translation=tr.tolist(),
                    size=list(ann['size']),
                    rotation=list(ann['rotation']),
                    velocity=[float(ann['velocity'][0]),
                              float(ann['velocity'][1])],
                    detection_name=name,
                    attribute_name=attrs[0] if attrs else '',
                    num_pts=int(ann.get('num_lidar_pts', 1))
                    + int(ann.get('num_radar_pts', 0)),
                    ego_translation=(tr - ego).tolist()))
            out[info['sample_token']] = boxes
        return out

    # ------------------------------------------------------------------
    def _sample_ida(self):
        """(:472-499)."""
        H, W = self.ida_aug.H, self.ida_aug.W
        fH, fW = self.ida_aug.final_dim
        if self.mode == 'train':
            resize = self.rng.uniform(*self.ida_aug.resize_lim)
            resize_dims = (int(W * resize), int(H * resize))
            newW, newH = resize_dims
            crop_h = int((1 - self.rng.uniform(*self.ida_aug.bot_pct_lim))
                         * newH) - fH
            crop_w = int(self.rng.uniform(0, max(0, newW - fW)))
            crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
            flip = bool(self.ida_aug.rand_flip and self.rng.choice([0, 1]))
            rotate = self.rng.uniform(*self.ida_aug.rot_lim)
        else:
            resize = max(fH / H, fW / W)
            resize_dims = (int(W * resize), int(H * resize))
            newW, newH = resize_dims
            crop_h = int((1 - np.mean(self.ida_aug.bot_pct_lim)) * newH) - fH
            crop_w = int(max(0, newW - fW) / 2)
            crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
            flip, rotate = False, 0.0
        return resize, resize_dims, crop, flip, rotate

    def _sample_bda(self):
        if self.mode == 'train':
            return (self.rng.uniform(*self.bda_aug.rot_lim),
                    self.rng.uniform(*self.bda_aug.scale_lim),
                    self.rng.uniform() < self.bda_aug.flip_dx_ratio,
                    self.rng.uniform() < self.bda_aug.flip_dy_ratio)
        return 0.0, 1.0, False, False

    def _choose_cams(self):
        if self.mode == 'train' and self.ida_aug.n_cams < len(self.ida_aug.cams):
            return list(self.rng.choice(self.ida_aug.cams, self.ida_aug.n_cams,
                                        replace=False))
        return list(self.ida_aug.cams)

    # ------------------------------------------------------------------
    def _get_lidar(self, lidar_info) -> Tuple[np.ndarray, np.ndarray]:
        """Key-frame cloud + 17-class labels (:530-558). With use_dense (train
        only), loads fp16 dense clouds from the occupancy/ mirror path
        (:535-543), falling back to the sparse cloud."""
        path = os.path.join(self.data_root,
                            lidar_info['LIDAR_TOP']['filename'])
        if self.use_dense and self.mode == 'train':
            dense = path.replace('samples/LIDAR_TOP', 'occupancy')
            try:
                arr = np.fromfile(dense, dtype=np.float16).reshape(-1, 5)
                pts = arr[:, :4].astype(np.float32)
                labels = MAP_IDX_GENERAL_TO_SEG[
                    arr[:, 4].astype(np.int64) % 32]
                return pts, labels
            except (OSError, ValueError):
                pass
        pts = np.fromfile(path, dtype=np.float32).reshape(-1, 5)[:, :4]
        seg_path = lidar_info['LIDAR_TOP'].get('lidarseg_labels_filename')
        if seg_path is not None:
            labels = np.fromfile(os.path.join(self.data_root, seg_path),
                                 dtype=np.uint8)
            labels = MAP_IDX_GENERAL_TO_SEG[labels]
        else:
            labels = np.zeros(pts.shape[0], np.int8)
        return pts, labels

    def _lidar_to_image(self, pts4: np.ndarray, labels: np.ndarray,
                        img_size, lidar_info, cam_info):
        """Project cloud into one camera (map_pointcloud_to_image, :312-371).
        Returns (N, 3) [u, v, depth] + labels."""
        lcs = lidar_info['LIDAR_TOP']['calibrated_sensor']
        lep = lidar_info['LIDAR_TOP']['ego_pose']
        ccs = cam_info['calibrated_sensor']
        cep = cam_info['ego_pose']
        p = pts4[:, :3].astype(np.float64)
        p = p @ T.quat_to_rot(lcs['rotation']).T + np.asarray(lcs['translation'])
        p = p @ T.quat_to_rot(lep['rotation']).T + np.asarray(lep['translation'])
        p = (p - np.asarray(cep['translation'])) @ T.quat_to_rot(cep['rotation'])
        p = (p - np.asarray(ccs['translation'])) @ T.quat_to_rot(ccs['rotation'])
        depth = p[:, 2]
        K = np.asarray(ccs['camera_intrinsic'], np.float64)
        uvw = p @ K.T
        uv = uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-9)
        W, H = img_size
        m = ((depth > 0.0) & (uv[:, 0] > 1) & (uv[:, 0] < W - 1)
             & (uv[:, 1] > 1) & (uv[:, 1] < H - 1))
        return (np.concatenate([uv[m], depth[m, None]], 1).astype(np.float32),
                labels[m])

    def _lidar_to_ego(self, pts4: np.ndarray, lidar_info) -> np.ndarray:
        """Cloud -> key lidar-ego frame (map_pointcloud_to_bev, :267-310:
        returns the UNFILTERED cloud; ref_index is the identity)."""
        lcs = lidar_info['LIDAR_TOP']['calibrated_sensor']
        p = pts4[:, :3].astype(np.float64)
        p = p @ T.quat_to_rot(lcs['rotation']).T + np.asarray(lcs['translation'])
        return p.astype(np.float32)

    def _cam_matrices(self, key_info_cam: dict, sweep_info_cam: dict):
        """sensor2(key)ego / keysensor2sweepsensor / intrin (:604-659)."""
        sweep_s2e = T.pose_matrix(sweep_info_cam['calibrated_sensor']['rotation'],
                                  sweep_info_cam['calibrated_sensor']['translation'])
        sweep_e2g = T.pose_matrix(sweep_info_cam['ego_pose']['rotation'],
                                  sweep_info_cam['ego_pose']['translation'])
        key_e2g = T.pose_matrix(key_info_cam['ego_pose']['rotation'],
                                key_info_cam['ego_pose']['translation'])
        key_s2e = T.pose_matrix(key_info_cam['calibrated_sensor']['rotation'],
                                key_info_cam['calibrated_sensor']['translation'])
        g2keyego = np.linalg.inv(key_e2g)
        sweepsensor2keyego = g2keyego @ sweep_e2g @ sweep_s2e
        keysensor2sweepsensor = np.linalg.inv(
            np.linalg.inv(key_s2e) @ g2keyego @ sweep_e2g @ sweep_s2e)
        intrin = np.zeros((4, 4), np.float64)
        intrin[3, 3] = 1
        intrin[:3, :3] = np.asarray(
            sweep_info_cam['calibrated_sensor']['camera_intrinsic'])
        return (sweepsensor2keyego.astype(np.float32),
                keysensor2sweepsensor.astype(np.float32),
                intrin.astype(np.float32))

    def _get_gt(self, info, cams) -> Tuple[np.ndarray, np.ndarray]:
        """GT boxes in mean-camera ego frame (:728-773)."""
        rots = np.mean([info['cam_infos'][c]['ego_pose']['rotation']
                        for c in cams], 0)
        trans = np.mean([info['cam_infos'][c]['ego_pose']['translation']
                         for c in cams], 0)
        # inverse rotation of the mean key ego pose (pyquaternion .inverse;
        # quat_to_rot normalizes internally so the conjugate suffices)
        w, x, y, z = rots
        inv_q = np.array([w, -x, -y, -z])
        rot = T.quat_to_rot(inv_q)
        boxes, labels = [], []
        for ann in info['ann_infos']:
            name = MAP_NAME_GENERAL_TO_DET_SEG.get(ann['category_name'],
                                                   'ignore')
            if name not in self.classes:
                continue
            if ann['num_lidar_pts'] + ann['num_radar_pts'] <= 0:
                continue
            center = np.asarray(ann['translation'], np.float64) - trans
            center = rot @ center
            q = np.asarray(ann['rotation'], np.float64)
            box_rot = rot @ T.quat_to_rot(q)
            yaw = np.arctan2(box_rot[1, 0], box_rot[0, 0])
            wlh = np.asarray(ann['size'], np.float64)
            vel = rot @ np.array([ann['velocity'][0], ann['velocity'][1], 0.0])
            boxes.append(np.concatenate([
                center, wlh[[1, 0, 2]], [yaw], vel[:2]]).astype(np.float32))
            labels.append(self.classes.index(name))
        if not boxes:
            return np.zeros((0, 9), np.float32), np.zeros((0,), np.int64)
        return np.stack(boxes), np.asarray(labels, np.int64)

    def _select_frames(self, idx: int, cams: Sequence[str]
                       ) -> List[Tuple[dict, dict]]:
        """Key-frame + sweep selection with scene-boundary handling
        (nusc_det_seg_dataset.py:790-837). Returns a list of
        (cam_infos, lidar_info) pairs; entry 0 is the key frame.

        For each key offset in self.key_idxes ([0] first): use idx + offset,
        falling back to idx when it precedes the dataset or crosses a scene
        boundary. After each key frame, for each requested sweep index pick
        the latest cam_sweeps entry <= that index containing every chosen
        camera, pairing it with the lidar sweep closest in mean timestamp
        (or the key frame's lidar/cams if no usable sweep exists — the
        reference silently drops the frame in that corner, which would break
        its own stacking; we keep the frame count fixed, DEVIATIONS).
        """
        frames: List[Tuple[dict, dict]] = []
        scene = self.infos[idx].get('scene_token')
        for key_idx in self.key_idxes:
            cur = idx + key_idx
            if (cur < 0 or cur >= len(self.infos)
                    or self.infos[cur].get('scene_token') != scene):
                cur = idx
            info = self.infos[cur]
            frames.append((info['cam_infos'], info['lidar_infos']))
            cam_sweeps = info.get('cam_sweeps', [])
            lidar_sweeps = info.get('lidar_sweeps', [])
            lidar_ts = np.asarray([s['LIDAR_TOP']['timestamp']
                                   for s in lidar_sweeps], np.float64)
            for sweep_idx in self.sweeps_idx:
                chosen = None
                for i in range(min(len(cam_sweeps) - 1, sweep_idx), -1, -1):
                    sw = cam_sweeps[i]
                    if all(c in sw for c in cams):
                        if lidar_sweeps:
                            ts = float(np.mean([v['timestamp']
                                                for v in sw.values()]))
                            li = int(np.argmin(np.abs(lidar_ts - ts)))
                            chosen = (sw, lidar_sweeps[li])
                        else:
                            chosen = (sw, info['lidar_infos'])
                        break
                frames.append(chosen if chosen is not None
                              else (info['cam_infos'], info['lidar_infos']))
        return frames

    # ------------------------------------------------------------------
    def load_image(self, filename: str, resize_dims, crop, flip: bool,
                   rotate: float) -> Tuple[Tuple[int, int], np.ndarray]:
        """Decode the camera image `filename` (relative to data_root) and
        apply its ida augmentation (img_transform's PIL part). Returns the
        raw image's (W, H), which the lidar projection needs, and the
        augmented (fH, fW, 3) uint8 RGB array."""
        from PIL import Image
        img = Image.open(os.path.join(self.data_root, filename))
        size = img.size
        img = T.apply_img_transform(img, resize_dims, crop, flip, rotate)
        return size, np.asarray(img)

    def __getitem__(self, idx: int) -> Dict[str, object]:
        if self.use_cbgs:
            idx = self.sample_indices[idx]
        info = self.infos[idx]
        cams = self._choose_cams()
        frames = self._select_frames(idx, cams)
        key_cam_infos, lidar_info = frames[0]
        multi_frame = len(frames) > 1

        # per-frame lidar clouds (frame 0 = key cloud, used for everything
        # downstream; later frames only supervise their own depth maps,
        # nusc_det_seg_dataset.py:839-845,661-669)
        frame_lidar = [self._get_lidar(li) for _, li in frames]
        pts4, pt_labels = frame_lidar[0]
        fH, fW = self.ida_aug.final_dim

        # one ida sample per CAMERA, shared by that camera's frames
        # (reference samples inside the cam loop, :596-598)
        cam_augs = {cam: self._sample_ida() for cam in cams}

        # leading frame axis; squeezed away below when single-frame
        imgs = [[] for _ in frames]
        s2e_mats = [[] for _ in frames]
        intrin_mats = [[] for _ in frames]
        ida_mats = [[] for _ in frames]
        s2s_mats = [[] for _ in frames]
        depth_maps = [[] for _ in frames]
        label_maps = [[] for _ in frames]
        for cam in cams:
            resize, resize_dims, crop, flip, rotate = cam_augs[cam]
            ida_mat = T.ida_matrix(resize, crop, flip, rotate)
            key_ci = key_cam_infos[cam]
            for f, (f_cam_infos, f_lidar_info) in enumerate(frames):
                ci = f_cam_infos[cam]
                size, img = self.load_image(ci['filename'], resize_dims, crop,
                                            flip, rotate)
                s2e, s2s, intrin = self._cam_matrices(key_ci, ci)
                s2e_mats[f].append(s2e)
                s2s_mats[f].append(s2s)
                intrin_mats[f].append(intrin)
                ida_mats[f].append(ida_mat)
                if self.mode == 'train':
                    # every frame supervises its own depth map with its own
                    # cloud (:661-669 runs per sweep frame)
                    uvd, lab = self._lidar_to_image(
                        frame_lidar[f][0], frame_lidar[f][1], size,
                        f_lidar_info, ci)
                    dmap, lmap = T.make_depth_label(uvd, lab, resize,
                                                    (fH, fW), crop, flip,
                                                    rotate)
                    depth_maps[f].append(dmap)
                    label_maps[f].append(lmap)
                imgs[f].append(T.normalize_image(img, self.img_mean,
                                                 self.img_std))

        ego_pts = self._lidar_to_ego(pts4, lidar_info)
        gt_boxes, gt_labels = (self._get_gt(info, cams)
                               if self.mode == 'train'
                               else (np.zeros((0, 9), np.float32),
                                     np.zeros((0,), np.int64)))
        rot_bda, scale_bda, flip_dx, flip_dy = self._sample_bda()
        gt_boxes, ego_pts, bda_rot = T.bda_transform(
            gt_boxes, ego_pts, rot_bda, scale_bda, flip_dx, flip_dy)
        bda_mat = np.eye(4, dtype=np.float32)
        bda_mat[:3, :3] = bda_rot

        def stack_frames(per_frame):
            """(F, N, ...) when multi-frame, (N, ...) when single-frame —
            the model's num_sweeps==1 contract is the squeezed layout."""
            arr = np.stack([np.stack(x) for x in per_frame])
            return arr if multi_frame else arr[0]

        sample: Dict[str, object] = dict(
            imgs=stack_frames(imgs),                    # ([F,] N, H, W, 3)
            sensor2ego=stack_frames(s2e_mats),
            intrin=stack_frames(intrin_mats),
            ida=stack_frames(ida_mats),
            sensor2sensor=stack_frames(s2s_mats),
            bda=bda_mat,
            token=info['sample_token'],
            lidar_token=lidar_info['LIDAR_TOP'].get('lidar_token', ''),
            ego2global_rotation=np.mean(
                [key_cam_infos[c]['ego_pose']['rotation'] for c in cams], 0),
            ego2global_translation=np.mean(
                [key_cam_infos[c]['ego_pose']['translation'] for c in cams], 0),
        )

        # padded point cloud (replaces ragged inrange_pts; ref_index is the
        # identity in the reference, :294-310)
        P = self.max_points
        if self.mode != 'train' and ego_pts.shape[0] > P:
            # eval/predict must label EVERY point (the lidarseg submission
            # needs one label per cloud point, base_exp.py:835-848) — a
            # silent crop would produce a rejected/incomplete submission
            raise ValueError(
                f'point cloud has {ego_pts.shape[0]} points > max_points='
                f'{P}; raise train.max_points for eval/predict')
        n = min(ego_pts.shape[0], P)
        pts_pad = np.zeros((P, 3), np.float32)
        lab_pad = np.zeros((P,), np.int32)
        pts_pad[:n] = ego_pts[:n]
        lab_pad[:n] = pt_labels[:n]
        valid = np.zeros((P,), bool)
        valid[:n] = True
        sample.update(points=pts_pad, point_labels=lab_pad, point_valid=valid,
                      num_points=np.int32(n))

        if self.mode == 'train':
            sample['depth_labels'] = stack_frames(depth_maps)  # ([F,] N, fH, fW)
            sample['seg_labels'] = stack_frames(label_maps).astype(np.int32)
            if self.seg_bounds is not None:
                (x0, x1, sx), (y0, y1, _), (z0, z1, _) = self.seg_bounds
                seg, height, mask = T.make_bev_seg_map(
                    ego_pts, pt_labels, x_bound=(x0, x1), y_bound=(y0, y1),
                    z_bound=(z0, z1), size=sx)
            else:
                seg, height, mask = T.make_bev_seg_map(ego_pts, pt_labels)
            sample.update(bev_seg=seg, bev_height=height, bev_mask=mask)
            sample.update(assign_targets_single(gt_boxes, gt_labels,
                                                self.head_cfg))
        sample['gt_boxes'] = gt_boxes
        sample['gt_labels'] = gt_labels

        if self.mode != 'test':
            occ = np.load(os.path.join(self.data_root,
                                       info['occ_infos']['occ_gt_path']))
            sem = occ['semantics'].astype(np.int32)
            sample.update(
                occ_semantics=sem,
                occ_density_labels=(sem != 17).astype(np.float32),
                mask_lidar=occ['mask_lidar'].astype(bool),
                mask_camera=occ['mask_camera'].astype(bool))
        return sample


# ---------------------------------------------------------------------------
# Collate + a simple threaded prefetching loader (host-side input pipeline)
# ---------------------------------------------------------------------------

_HOST_KEYS = ('token', 'lidar_token', 'ego2global_rotation',
              'ego2global_translation', 'gt_boxes', 'gt_labels')


def collate(samples: List[Dict[str, object]]) -> Dict[str, object]:
    """Stack numpy arrays; keep eval metadata as host lists under 'meta'."""
    out: Dict[str, object] = {}
    meta = {k: [s[k] for s in samples] for k in _HOST_KEYS if k in samples[0]}
    for k, v in samples[0].items():
        if k in _HOST_KEYS:
            continue
        out[k] = np.stack([s[k] for s in samples])
    out['meta'] = meta
    return out


_WORKER_DS = None


def _proc_init(ds):
    global _WORKER_DS
    _WORKER_DS = ds


def _proc_fetch(idxs, aug_seed):
    # every worker (and every epoch's re-created pool) starts from the
    # parent's pristine dataset RNG, so it would otherwise draw the SAME
    # ida/bda augmentation stream; reseed per batch from the loader's stream
    # instead (torch DataLoader does the analogous worker reseeding)
    _WORKER_DS.rng = np.random.RandomState(aug_seed)
    return collate([_WORKER_DS[int(i)] for i in idxs])


class DataLoader:
    """Prefetching loader with thread or process workers.

    The reference uses torch DataLoader process workers (base_exp.py:954-1043,
    num_workers=4). PIL JPEG decode of 6x1600x900 images per sample is
    GIL-bound under threads, so use_processes=True runs worker processes.
    They start by `spawn` (the JAX package's loader forks): the trainer has
    created a CUDA context and threads before the pool starts, and a fork
    of such a process is unsafe. The dataset goes to each worker pickled
    once, at the pool's start; batches come back pickled. Threads remain
    the default where the host pipeline is not the bottleneck.

    A batch's bytes depend only on the loader's seed, the rank and the
    batch's position, not on the kind or number of workers or the prefetch
    depth: each batch's augmentation draws come from a seed that the
    loader's RNG draws in order.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, drop_last: bool = True, seed: int = 0,
                 prefetch: int = 2, use_processes: bool = False,
                 rank: int = 0, world_size: int = 1):
        """rank/world_size: multi-host sharding (torch DistributedSampler
        semantics, base_cli.py:105/base_exp.py:954-1043). `batch_size` is the
        PER-PROCESS batch; every process draws the same global index order
        (identical `seed`!) and takes its contiguous `batch_size` block of
        each global batch, so the logical global batch is the ranks' blocks
        in order: global row bi*world*bs + rank*bs + r  ==  this loader's
        batch bi row r."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        self.prefetch = prefetch
        self.use_processes = use_processes
        self.rank = rank
        self.world_size = world_size

    def __len__(self):
        n = len(self.dataset)
        gb = self.batch_size * self.world_size
        return n // gb if self.drop_last else -(-n // gb)

    def _pool(self):
        if self.use_processes:
            import multiprocessing as mp
            # a worker that dies raises BrokenProcessPool at its batch's
            # result(), where a multiprocessing.Pool would wait forever
            return cf.ProcessPoolExecutor(
                self.num_workers, mp_context=mp.get_context('spawn'),
                initializer=_proc_init, initargs=(self.dataset,))
        return cf.ThreadPoolExecutor(self.num_workers)

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self.rng.shuffle(order)  # identical across ranks (same seed)
        gb = self.batch_size * self.world_size
        n_batches = len(self)
        # drop_last=False: pad the global order to full batches by repeating
        # the last sample; 'sample_valid' marks the real rows so eval/predict
        # consumers mask/skip the padding — the reference instead gathers and
        # truncates to the dataset length (base_exp.py:920-927)
        total = n_batches * gb
        pad_order = np.concatenate(
            [order[:total], np.full(max(0, total - n), order[-1] if n else 0)])
        # this rank's contiguous block of every global batch (see __init__)
        sel = pad_order.reshape(n_batches, self.world_size,
                                self.batch_size)[:, self.rank]
        val = (np.arange(total) < n).reshape(
            n_batches, self.world_size, self.batch_size)[:, self.rank]
        pool = self._pool()
        try:
            futures = []

            def submit(bi):
                idxs = sel[bi]
                # per-batch augmentation seed drawn from the loader's RNG
                # (advances across batches AND epochs, in step across ranks;
                # mixed with the rank so aug params decorrelate)
                aug_seed = (int(self.rng.randint(0, 2 ** 31 - 1))
                            ^ (self.rank * 0x9E3779B1 & 0x7FFFFFFF))
                if self.use_processes:
                    futures.append(pool.submit(_proc_fetch, idxs, aug_seed))
                else:
                    # thread workers share self.dataset, so reseed a shallow
                    # per-batch copy (shares infos, owns its rng) — same
                    # per-batch/per-rank aug decorrelation as _proc_fetch,
                    # race-free under prefetch>1
                    def fetch(ii, seed):
                        ds = copy.copy(self.dataset)
                        ds.rng = np.random.RandomState(seed)
                        return collate([ds[int(i)] for i in ii])
                    futures.append(pool.submit(fetch, idxs, aug_seed))
            for bi in range(min(self.prefetch, n_batches)):
                submit(bi)
            for bi in range(n_batches):
                fut = futures.pop(0)
                batch = fut.result()
                nxt = bi + self.prefetch
                if nxt < n_batches:
                    submit(nxt)
                batch['sample_valid'] = val[bi].copy()
                yield batch
        finally:
            # a process pool waits for the batches in flight (at most
            # `prefetch`), so that no worker outlives the iteration
            pool.shutdown(wait=self.use_processes, cancel_futures=True)
