"""Offline box-overlay visualization: predicted vs GT 3D boxes over the six
cameras plus a BEV canvas; the port of `scripts/visualize_preds.py`.

The working equivalent of the reference's `scripts/visualize_nusc.py:125`
(`demo`, broken as shipped: it indexes infos with sample tokens and calls a
renamed draw helper). Reads the detection submission json that
`Trainer.test`/`predict` write (nuScenes format, global-frame boxes) and an
info pkl (for calibration, ego poses and image paths), and writes one PNG
per sample: a 2x3 camera grid with projected wireframes and a BEV pane.
Host code only (numpy and PIL, imported where the panels are drawn); for
the same inputs it writes the JAX package's script's PNGs byte for byte.

Usage:
  python -m vampire_tpu_torch.tools.visualize_preds \\
      --info data/nuScenes/nuscenes_occ_infos_val.pkl \\
      --results outputs/<exp>/detection_submit/results_nusc.json \\
      --data-root data/nuScenes --out viz/ [--max-samples 20] [--score-thr 0.3]
"""
import argparse
import json
import os
import pickle

import numpy as np

from ..data.transforms import quat_to_rot

CAM_ORDER = ('CAM_FRONT_LEFT', 'CAM_FRONT', 'CAM_FRONT_RIGHT',
             'CAM_BACK_LEFT', 'CAM_BACK', 'CAM_BACK_RIGHT')
PRED_COLOR = (66, 135, 245)
GT_COLOR = (80, 220, 100)
# box wireframe edges over the 8 corners (nuScenes corner order)
EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
         (0, 4), (1, 5), (2, 6), (3, 7)]


def box_corners(center, size, rot):
    """8 corners (3, 8) of a box; size = (w, l, h), l along box x
    (nuScenes devkit Box.corners order)."""
    w, l, h = size
    x = l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1], np.float64)
    y = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float64)
    z = h / 2 * np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float64)
    pts = rot @ np.stack([x, y, z])
    return pts + np.asarray(center, np.float64)[:, None]


def draw_cam_boxes(draw, corners_ego, s2e, intrin, color, w, h):
    """Project ego-frame corners into one camera and draw wireframe edges."""
    e2s = np.linalg.inv(s2e)
    cam = e2s[:3, :3] @ corners_ego + e2s[:3, 3:4]
    z = cam[2]
    if (z < 0.1).all():
        return
    uv = intrin[:3, :3] @ cam
    uv = uv[:2] / np.maximum(uv[2], 1e-6)
    for a, b in EDGES:
        if z[a] < 0.1 or z[b] < 0.1:
            continue
        draw.line([tuple(uv[:, a]), tuple(uv[:, b])], fill=color, width=2)


def draw_bev_box(draw, corners_ego, color, scale, half):
    """Top-down rectangle from the bottom 4 corners; ego center, x up."""
    pts = [(half + -corners_ego[1, i] * scale, half - corners_ego[0, i]
            * scale) for i in (2, 3, 7, 6)]
    draw.polygon(pts, outline=color)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--info', required=True)
    ap.add_argument('--results', required=True)
    ap.add_argument('--data-root', required=True)
    ap.add_argument('--out', required=True)
    ap.add_argument('--max-samples', type=int, default=20)
    ap.add_argument('--score-thr', type=float, default=0.3)
    ap.add_argument('--bev-range', type=float, default=52.0)
    args = ap.parse_args(argv)
    from PIL import Image, ImageDraw

    with open(args.info, 'rb') as f:
        infos = pickle.load(f)
    with open(args.results) as f:
        res = json.load(f)
    results = res.get('results', res)
    os.makedirs(args.out, exist_ok=True)

    done = 0
    for info in infos:
        token = info['sample_token']
        if token not in results:
            continue
        cam_infos = info['cam_infos']
        # sample ego pose: mean over cameras (data/nuscenes.py:267-269)
        rots = np.mean([cam_infos[c]['ego_pose']['rotation']
                        for c in CAM_ORDER if c in cam_infos], axis=0)
        trans = np.mean([cam_infos[c]['ego_pose']['translation']
                         for c in CAM_ORDER if c in cam_infos], axis=0)
        g2e_r = quat_to_rot(rots / np.linalg.norm(rots)).T
        preds, gts = [], []
        for r in results[token]:
            if r.get('detection_score', 1.0) < args.score_thr:
                continue
            c_ego = g2e_r @ (np.asarray(r['translation'], np.float64) - trans)
            rot = g2e_r @ quat_to_rot(np.asarray(r['rotation'], np.float64))
            preds.append(box_corners(c_ego, r['size'], rot))
        for a in info.get('ann_infos', []):
            c_ego = g2e_r @ (np.asarray(a['translation'], np.float64) - trans)
            rot = g2e_r @ quat_to_rot(np.asarray(a['rotation'], np.float64))
            gts.append(box_corners(c_ego, a['size'], rot))

        tiles = []
        for c in CAM_ORDER:
            ci = cam_infos[c]
            img = Image.open(os.path.join(args.data_root, ci['filename'])
                             ).convert('RGB')
            draw = ImageDraw.Draw(img)
            ccs = ci['calibrated_sensor']
            s2e = np.eye(4)
            s2e[:3, :3] = quat_to_rot(np.asarray(ccs['rotation'], np.float64))
            s2e[:3, 3] = ccs['translation']
            intr = np.asarray(ccs['camera_intrinsic'], np.float64)
            for box in gts:
                draw_cam_boxes(draw, box, s2e, intr, GT_COLOR,
                               img.width, img.height)
            for box in preds:
                draw_cam_boxes(draw, box, s2e, intr, PRED_COLOR,
                               img.width, img.height)
            tiles.append(np.asarray(img.resize((800, 450))))
        grid = np.concatenate([np.concatenate(tiles[:3], axis=1),
                               np.concatenate(tiles[3:], axis=1)], axis=0)

        bev_px = 900
        half = bev_px // 2
        scale = half / args.bev_range
        bev = Image.new('RGB', (bev_px, bev_px), (20, 20, 20))
        draw = ImageDraw.Draw(bev)
        for rr in (10, 20, 30, 40, 50):
            draw.ellipse([half - rr * scale, half - rr * scale,
                          half + rr * scale, half + rr * scale],
                         outline=(60, 60, 60))
        for box in gts:
            draw_bev_box(draw, box, GT_COLOR, scale, half)
        for box in preds:
            draw_bev_box(draw, box, PRED_COLOR, scale, half)
        bev = bev.resize((grid.shape[0], grid.shape[0]))
        out = np.concatenate([grid, np.asarray(bev)], axis=1)
        Image.fromarray(out).save(os.path.join(args.out, f'{token}.png'))
        done += 1
        if done >= args.max_samples:
            break
    print(f'wrote {done} overlay panels to {args.out}')
    return done


if __name__ == '__main__':
    main()
