"""F=1 against F=2 temporal fusion, compared on held-out losses; the port
of `scripts/multisweep_ab.py`.

Two tiny_config models start from the same weights and train on the same
geometrically consistent scenes: one on the key frame only (F=1), one with
a sweep frame of the ego 0.6 m behind folded in (F=2, consistent_batch's
sweep_offsets; on a card its lift runs over 12 views). The scenes of a seed
are the same in both arms (the sweep rig only adds views), so the held-out
labels match and the comparison isolates what the fusion adds. Each arm
reports its mean eval-mode losses over the held-out scenes and its
training totals; `f2_over_f1` is their ratio per term.

Usage (the card unless --device cpu):
  python -m vampire_tpu_torch.tools.multisweep_ab [--steps 150] \\
      [--train-scenes 3] [--val-scenes 3] \\
      [--out build/studies/multisweep_ab.json] [--device cuda]
"""
import argparse
import json
import os
import time

import numpy as np

from .convergence_study import new_model, require_device, to_device

DEFAULT_OUT = os.path.join('build', 'studies', 'multisweep_ab.json')
VAL_KEYS = ['camera_depth_loss', 'camera_seg_loss', 'pts_seg_loss',
            'visible_occ_seg_loss', 'bev_seg_loss', 'detection_loss',
            'total_loss']
SWEEP_OFFSETS = (0.6,)


def make(cfg, seed, sweeps):
    """One arm's numpy scene of `seed` (4 boxes, train mode)."""
    from ..data.synthetic import consistent_batch
    b = consistent_batch(cfg, batch_size=1, n_points=cfg.train.max_points,
                         n_boxes=4, seed=seed, mode='train',
                         sweep_offsets=SWEEP_OFFSETS if sweeps else ())
    return {k: v for k, v in b.items() if k != 'gt_boxes_list'}


def val_losses(model, cfg, batch):
    """The eval-mode forward's loss terms of VAL_KEYS on one batch."""
    import torch
    from ..training.losses import compute_losses
    from ..training.train_step import split_mats
    model.eval()
    with torch.no_grad():
        fo, preds = model(batch['imgs'], split_mats(batch),
                          points=batch['points'])
        _, logs = compute_losses(fo, preds, batch, cfg.train, cfg.head,
                                 cfg.backbone.sdf_bias,
                                 cfg.backbone.density_mode)
        return dict(zip(VAL_KEYS, torch.stack(
            [logs[k].float() for k in VAL_KEYS]).tolist()))


def run_arm(cfg, sweeps, steps, train_scenes, val_scenes, dev, model=None,
            log=print):
    """Train one arm for `steps` steps over scenes 0..train_scenes-1 and
    return its mean held-out losses over scenes 100.. (VAL_KEYS, rounded
    as the record rounds them), each scene's, and the training totals of
    every step. model: a port Vampire with its weights
    (default: seeded random weights, seed 0, fp32), trained in place."""
    import torch
    from ..training.train_state import create_train_state
    from ..training.train_step import build_train_step
    train = [to_device(make(cfg, s, sweeps), dev)
             for s in range(train_scenes)]
    val = [to_device(make(cfg, 100 + s, sweeps), dev)
           for s in range(val_scenes)]
    if model is None:
        model = new_model(cfg, dev, torch.float32)
    state = create_train_state(model, cfg.train, steps_per_epoch=steps)
    step = build_train_step(cfg)
    name = 'F=2' if sweeps else 'F=1'
    totals = []
    t0 = time.perf_counter()
    for i in range(steps):
        state, logs = step(state, train[i % len(train)])
        totals.append(float(logs['total_loss']))
        if i % 50 == 0:
            log(f'  [{name}] step {i} total {totals[-1]:.3f}')
    res = {k: [] for k in VAL_KEYS}
    for vb in val:
        for k, v in val_losses(model, cfg, vb).items():
            res[k].append(v)
    log(f'  arm {name} done in {time.perf_counter() - t0:.0f} s')
    return dict(val={k: round(float(np.mean(v)), 4) for k, v in res.items()},
                val_per_scene=res, train_total=totals)


def ratios(r1, r2):
    return {k: round(r2[k] / r1[k], 3) if r1[k] else None for k in VAL_KEYS}


def run(steps=150, train_scenes=3, val_scenes=3, device='cuda', log=print):
    """Both arms at tiny_config on `device`; the JAX script's record
    (steps, f1, f2, f2_over_f1) plus each arm's training totals."""
    from ..data.synthetic import tiny_config
    from ..serving.server import set_fp32_precision
    dev = require_device(device)
    if dev.type == 'cuda':
        set_fp32_precision()
    cfg = tiny_config()
    a1 = run_arm(cfg, False, steps, train_scenes, val_scenes, dev, log=log)
    a2 = run_arm(cfg, True, steps, train_scenes, val_scenes, dev, log=log)
    return dict(steps=steps, f1=a1['val'], f2=a2['val'],
                f2_over_f1=ratios(a1['val'], a2['val']),
                train_total=dict(f1=a1['train_total'],
                                 f2=a2['train_total']),
                device=str(dev))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=150)
    ap.add_argument('--train-scenes', type=int, default=3)
    ap.add_argument('--val-scenes', type=int, default=3)
    ap.add_argument('--out', default=DEFAULT_OUT)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    out = run(args.steps, args.train_scenes, args.val_scenes, args.device)
    print(json.dumps({k: out[k] for k in ('steps', 'f1', 'f2',
                                          'f2_over_f1')}, indent=1))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(out, f, indent=1)
    print('wrote', args.out)
    return out


if __name__ == '__main__':
    main()
