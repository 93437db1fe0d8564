"""Fake on-disk mini-nuScenes generator; the port of
`vampire_tpu/data/fake.py`.

Writes a directory tree + info pkl with the exact schema `gen_info.py`
produces from the real database (real-size 1600x900 JPEGs, LiDAR .bin +
lidarseg .bin, Occ3D .npz, camera/lidar sweeps, annotations), so the full
dataset/loader path (`data/nuscenes.py`, reference
`nusc_det_seg_dataset.py:376-935`) runs without nuScenes. For the same
arguments it writes the same files, byte for byte, and the same infos as
the JAX package's generator (tests/test_torch_data.py). Every JPEG goes
through `_write_jpeg`, the one use of PIL on the 'noise' images, so a
caller that never reads the images may replace it; the random stream does
not depend on it.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from ..configs import IdaAugConfig
from .synthetic import camera_rig


def rot_to_quat(r):
    w = np.sqrt(max(0.0, 1 + r[0, 0] + r[1, 1] + r[2, 2])) / 2
    x = (r[2, 1] - r[1, 2]) / (4 * w)
    y = (r[0, 2] - r[2, 0]) / (4 * w)
    z = (r[1, 0] - r[0, 1]) / (4 * w)
    return [float(w), float(x), float(y), float(z)]


def _write_jpeg(img: np.ndarray, path: str) -> None:
    """Write an (H, W, 3) uint8 RGB image as a JPEG (PIL's defaults)."""
    from PIL import Image
    Image.fromarray(img).save(path)


def make_fake_nusc(root, n_samples: int = 2, n_points: int = 1000,
                   seed: int = 0, image_content: str = 'noise',
                   occ_shape=(200, 200, 16)):
    """Build a fake nuScenes tree under `root`; returns the info-pkl path.

    image_content='noise' writes uniform-noise JPEGs (worst-case decode
    entropy); 'smooth' writes low-frequency images (realistic JPEG sizes).
    occ_shape: Occ3D label grid — (200,200,16) for real-shape runs, or the
    model's cfg.backbone.occ_grid for tiny end-to-end tests.
    """
    root = str(root)
    rng = np.random.RandomState(seed)
    cams = list(IdaAugConfig().cams)
    rig = camera_rig(1, 6, final_dim=(256, 704))
    for d in ('imgs', 'lidar', 'occ'):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    infos = []
    for si in range(n_samples):
        cam_infos = {}
        for ci, cam in enumerate(cams):
            fn = f'imgs/s{si}_{cam}.jpg'
            if image_content == 'smooth':
                from PIL import Image
                base = rng.randint(0, 255, (30, 50, 3), np.uint8)
                img = np.asarray(Image.fromarray(base).resize(
                    (1600, 900), Image.BILINEAR))
            else:
                img = rng.randint(0, 255, (900, 1600, 3), np.uint8)
            _write_jpeg(img, os.path.join(root, fn))
            s2e = rig['sensor2ego'][0, ci]
            intr = rig['intrin'][0, ci]
            cam_infos[cam] = dict(
                sample_token=f's{si}',
                ego_pose=dict(rotation=[1.0, 0, 0, 0],
                              translation=[100.0 + si, 50.0, 0.0]),
                timestamp=si * 5 + ci,
                is_key_frame=True, height=900, width=1600, filename=fn,
                calibrated_sensor=dict(
                    rotation=rot_to_quat(s2e[:3, :3]),
                    translation=s2e[:3, 3].tolist(),
                    camera_intrinsic=intr[:3, :3].tolist()))
        pts = np.zeros((n_points, 5), np.float32)
        pts[:, 0] = rng.uniform(-40, 40, n_points)
        pts[:, 1] = rng.uniform(-40, 40, n_points)
        pts[:, 2] = rng.uniform(-3, 3, n_points)
        pts.tofile(os.path.join(root, f'lidar/s{si}.bin'))
        seg = rng.randint(0, 32, n_points).astype(np.uint8)
        seg.tofile(os.path.join(root, f'lidar/s{si}_seg.bin'))
        lidar_infos = {'LIDAR_TOP': dict(
            sample_token=f's{si}', lidar_token=f'lt{si}',
            ego_pose=dict(rotation=[1.0, 0, 0, 0],
                          translation=[100.0 + si, 50.0, 0.0]),
            timestamp=si * 5,
            filename=f'lidar/s{si}.bin',
            calibrated_sensor=dict(rotation=[1.0, 0, 0, 0],
                                   translation=[0.9, 0.0, 1.8]),
            lidarseg_labels_filename=f'lidar/s{si}_seg.bin')}
        sem = rng.randint(0, 18, occ_shape).astype(np.uint8)
        np.savez(os.path.join(root, f'occ/s{si}.npz'), semantics=sem,
                 mask_lidar=rng.rand(*occ_shape) > 0.5,
                 mask_camera=rng.rand(*occ_shape) > 0.5)
        ann_infos = [dict(category_name='vehicle.car',
                          translation=[105.0 + si, 55.0, 0.5],
                          size=[1.9, 4.5, 1.6],
                          rotation=[1.0, 0, 0, 0],
                          velocity=np.array([1.0, 0.5, 0.0]),
                          attribute_names=['vehicle.moving'],
                          num_lidar_pts=10, num_radar_pts=2),
                     dict(category_name='static.other',  # -> ignore class
                          translation=[90.0, 40.0, 0.0], size=[1, 1, 1],
                          rotation=[1.0, 0, 0, 0],
                          velocity=np.zeros(3),
                          num_lidar_pts=5, num_radar_pts=0)]
        # one camera sweep frame: same images, ego pose displaced 0.5m back
        # (a real prev-frame pose), so sensor2sensor is a true translation
        sweep_cam = {}
        for cam, ci_info in cam_infos.items():
            sw = dict(ci_info)
            sw['ego_pose'] = dict(rotation=[1.0, 0, 0, 0],
                                  translation=[99.5 + si, 50.0, 0.0])
            sw['timestamp'] = ci_info['timestamp'] - 1
            sweep_cam[cam] = sw
        sweep_lidar = {'LIDAR_TOP': dict(
            lidar_infos['LIDAR_TOP'],
            ego_pose=dict(rotation=[1.0, 0, 0, 0],
                          translation=[99.5 + si, 50.0, 0.0]),
            timestamp=si * 5 - 1)}
        infos.append(dict(sample_token=f's{si}', timestamp=si,
                          scene_token='scene0', cam_infos=cam_infos,
                          lidar_infos=lidar_infos,
                          occ_infos=dict(occ_gt_path=f'occ/s{si}.npz'),
                          cam_sweeps=[sweep_cam], lidar_sweeps=[sweep_lidar],
                          ann_infos=ann_infos))
    info_path = os.path.join(root, 'infos_train.pkl')
    with open(info_path, 'wb') as f:
        pickle.dump(infos, f)
    return info_path
