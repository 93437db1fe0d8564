"""How far the flagship's fp32 step-0 gradients move between layouts of
the same global-batch step: one process, the same in a fresh process, and
two ranks at dp 2 x cam 1 and at dp 1 x cam 2 (`parallel/mesh.py`).

    python vampire_tpu_torch/tools/layout_spread.py

Run from the root of a checkout on a CUDA card (it imports `chip_smoke`
from the working directory, for its BN calibration hook). The two-rank
layouts run as two ranks on cuda:0 over gloo on a one-card machine, over
NCCL on two cards. Each run takes one `fit` step on the same two rows
(`flagship_config()`, fp32, the dense lift, BN calibrated on another
batch) with the detection floors at num_devices = 2. For each run against
the first one process it prints the step-0 loss terms and grad_norm and
the median and largest per-tensor |d| / |g| of the unclipped gradients,
overall and for the image backbone, the image neck, the 3D trunk and the
head, and, last, one JSON line of those numbers with the card's name and
power limit. `chip_smoke.py`'s cam phase holds the cam layout to the dp
layout's spread from this measurement.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import statistics
import sys
import tempfile

PARTS = ('backbone.img_backbone', 'backbone.img_neck', 'backbone.base_conv',
         'head.')
TERMS = ('total_loss', 'detection_loss', 'camera_depth_loss',
         'camera_seg_loss', 'bev_seg_loss', 'pts_seg_loss',
         'visible_occ_seg_loss')


def spread(got: dict, want: dict) -> dict:
    """Per-tensor |d| / |g| of two runs' unclipped gradients: the median
    and the largest (with its tensor), overall and for each of PARTS."""
    import numpy as np
    rel = {n: float(np.linalg.norm(got[n] - g)) / float(np.linalg.norm(g))
           for n, g in want.items() if np.any(g)}
    worst = max(rel, key=rel.get)
    out = dict(median=statistics.median(rel.values()), max=rel[worst],
               worst=worst)
    for p in PARTS:
        vals = [v for n, v in rel.items() if n.startswith(p)]
        out[f'median {p.rstrip(".")}'] = statistics.median(vals)
    return out


def main():
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('layout_spread: no CUDA card')
    import chip_smoke as cs
    from vampire_tpu_torch.configs import flagship_config, synthetic_batch
    from vampire_tpu_torch.parallel.distributed import spawn
    from vampire_tpu_torch.parallel._testing import (in_fresh_process,
                                                      trainer_run, unclipped)
    card = cs.device_phase()
    cs.build_phase()
    cfg = flagship_config()
    P = cfg.train.max_points

    def sized(bs, nd):
        return dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, max_epochs=1, compute_dtype='float32',
            batch_size_per_device=bs, num_devices=nd))

    def rows(seed, mode):
        bs = [synthetic_batch(cfg, batch_size=1, n_points=P, seed=seed + i,
                              mode=mode) for i in range(2)]
        return {k: np.concatenate([b[k] for b in bs]) for k in bs[0]}, bs
    glob, parts = rows(70, 'train')
    hook = functools.partial(cs.cam_calibrate, rows(95, 'val')[0])
    backend = 'nccl' if torch.cuda.device_count() >= 2 else 'gloo'
    runs = {}
    with tempfile.TemporaryDirectory() as wd:
        one = (sized(2, 1), [[glob]], os.path.join(wd, 'one'), None, 'cuda',
               hook, 0, 2, None, True)
        runs['one'] = trainer_run(*one)
        torch.cuda.empty_cache()
        runs['fresh'] = in_fresh_process(trainer_run, one[:2] + (
            os.path.join(wd, 'fresh'),) + one[3:], 600)
        for name, cam, by_rank in (('dp2', 1, [[parts[0]], [parts[1]]]),
                                   ('cam2', 2, [[glob], [glob]])):
            runs[name] = spawn(
                trainer_run, 2, (sized(1, 2), by_rank,
                                 os.path.join(wd, name), None, None, hook, 0,
                                 None, cam, True),
                device='cuda', timeout_s=600,
                backend='gloo' if backend == 'gloo' else None)[0]
    clip = cfg.train.gradient_clip_val
    g = {k: unclipped(r['grads'], r['logs'][0]['grad_norm'], clip)
         for k, r in runs.items()}
    out = dict(card=card, backend=backend,
               logs={k: {t: r['logs'][0][t] for t in TERMS + ('grad_norm',)}
                     for k, r in runs.items()})
    for k in ('fresh', 'dp2', 'cam2'):
        out[k] = spread(g[k], g['one'])
        print(f'{k} against one process: {out[k]}; loss '
              f'{runs[k]["logs"][0]["total_loss"]:.6f} vs '
              f'{runs["one"]["logs"][0]["total_loss"]:.6f} [{card}]',
              flush=True)
    out['dp2_vs_cam2'] = spread(g['cam2'], g['dp2'])
    print(f'cam2 against dp2: {out["dp2_vs_cam2"]}', flush=True)
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
