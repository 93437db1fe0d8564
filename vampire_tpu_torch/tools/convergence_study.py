"""Synthetic-data convergence study: the flagship recipe trained over a few
scenes, then scored end to end; the port of `scripts/convergence_study.py`.

No nuScenes data is at hand, so this is the strongest end-to-end check of
training that the repo has: the full training recipe (AdamW, the LR
schedule, the clip, exactly cfg.train) runs for N steps over a few
synthetic batches and records each loss term's trajectory. Every head must
learn its targets through the shared field, so a gradient fault (a dead
branch, a wrong mask, a sign flip) shows as a term that does not fall.
Every step runs the lift and the ray march forward and backward.

With data='consistent' (the default) the study ends with the detection
chain of `Trainer.test`: `decode_preds` on the device, circle NMS on the
host, the global-frame submission and the in-repo NDS/mAP, scored against
the procedural scenes' GT boxes. So the learned heatmaps must decode into
boxes that match, not only lower the loss.

The JSON has the schema of the JAX package's record,
`scripts/convergence_study.json` (steps, batches, wall_s, summary, det_eval,
history), so the two read side by side, plus the device, the dtype, each
step's host-clock ms and kernel launches, the launches of the eval and the
peak device memory. That record is the JAX package's and is never written
here.

Usage (the flagship in bf16; the card unless --device cpu):
  python -m vampire_tpu_torch.tools.convergence_study \\
      [--steps 300] [--batches 4] [--data consistent|noise] \\
      [--out build/studies/convergence_study.json] [--device cuda]
"""
import argparse
import json
import os
import tempfile
import time

import numpy as np

KEYS = ['total_loss', 'detection_loss', 'camera_depth_loss',
        'camera_seg_loss', 'bev_seg_loss', 'bev_height_loss',
        'pts_seg_loss', 'visible_occ_seg_loss', 'visible_occ_density_loss',
        'invisible_occ_density_loss', 'grad_norm']
DEFAULT_OUT = os.path.join('build', 'studies', 'convergence_study.json')


def require_device(device):
    """torch.device(device); a CUDA device must be present (no CPU
    fallback)."""
    import torch
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device!r} asked for, but torch sees no '
                           f'CUDA card; pass device="cpu" to run on the CPU')
    return dev


def make_batches(cfg, n_batches, data='consistent'):
    """The study's numpy batches: seeds 0..n_batches-1, B=1, train mode,
    cfg.train.max_points points."""
    from ..data.synthetic import consistent_batch, synthetic_batch
    make = consistent_batch if data == 'consistent' else synthetic_batch
    return [make(cfg, batch_size=1, n_points=cfg.train.max_points, seed=i,
                 mode='train') for i in range(n_batches)]


def to_device(batch, dev):
    """A numpy batch as tensors on `dev`, without its GT box list."""
    import torch
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items() if k != 'gt_boxes_list'}


def new_model(cfg, dev, dtype):
    """The port's Vampire with random weights from seed 0
    (`init_params_`)."""
    import torch
    from ..models.vampire import Vampire, init_params_
    model = Vampire(cfg.backbone, cfg.head, dtype=dtype, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    return init_params_(model, g)


def summarize(hist, steps):
    """Each key's mean over the first and the last n_avg steps, n_avg =
    max(1, min(10, steps // 5)), and their ratio, rounded as the JAX
    script rounds them."""
    n_avg = max(1, min(10, steps // 5))
    out = {}
    for k, xs in hist.items():
        first = sum(xs[:n_avg]) / len(xs[:n_avg])
        last = sum(xs[-n_avg:]) / len(xs[-n_avg:])
        out[k] = dict(first=round(first, 4), last=round(last, 4),
                      ratio=round(last / first, 4) if first else None)
    return out


def gt_dicts(boxes):
    """The submission-convention GT dicts of one scene's (n, 9) boxes: the
    decoded dims round-trip the scene's (w, l, h) verbatim, format_bbox
    writes size = box[[4, 3, 5]], and the ego pose is the identity, so
    global == ego and ego_translation == translation."""
    gts = []
    for box in np.asarray(boxes):
        speed = float(np.hypot(box[7], box[8]))
        gts.append(dict(
            translation=[float(box[0]), float(box[1]), float(box[2])],
            size=[float(box[4]), float(box[3]), float(box[5])],
            rotation=[float(np.cos(box[6] / 2)), 0.0, 0.0,
                      float(np.sin(box[6] / 2))],
            velocity=[float(box[7]), float(box[8])],
            detection_name='car',
            attribute_name=('vehicle.moving' if speed > 0.2
                            else 'vehicle.parked'),
            num_pts=10,
            ego_translation=[float(box[0]), float(box[1]), float(box[2])]))
    return gts


def detections(model, cfg, batches, dev):
    """Each batch's boxes after `decode_preds` on the device and circle NMS
    on the host: a list of (boxes, scores, labels), one a scene."""
    from ..ops.nms import apply_circle_nms
    from ..training.train_step import build_eval_step
    step = build_eval_step(model, cfg, lidar_seg=False)
    out = []
    for b in batches:
        det = step(to_device(b, dev))['det']
        det = [{k: v.cpu().numpy() for k, v in t.items()} for t in det]
        out.append(apply_circle_nms(det, cfg.head, 0))
    return out


def score(results, batches, cfg):
    """The in-repo NDS/mAP of the scenes' detections against their GT
    boxes, as the JAX script's `det_eval` dict."""
    from ..evaluation.det_evaluator import DetNuscEvaluator
    metas, gt_by_token = [], {}
    for i, b in enumerate(batches):
        token = f'scene{i}'
        metas.append(dict(token=token,
                          ego2global_rotation=[1.0, 0.0, 0.0, 0.0],
                          ego2global_translation=[0.0, 0.0, 0.0]))
        gt_by_token[token] = gt_dicts(b['gt_boxes_list'][0])
    classes = [c for t in cfg.head.tasks for c in t]
    with tempfile.TemporaryDirectory() as wd:
        ev = DetNuscEvaluator(class_names=classes, output_dir=wd)
        detail = ev.evaluate(results, metas, gt_boxes=gt_by_token)
    pfx = 'img_bbox_NuScenes'
    return dict(
        car_ap={th: detail[f'{pfx}/car_AP_dist_{th}']
                for th in ('0.5', '1.0', '2.0', '4.0')},
        car_trans_err=detail[f'{pfx}/car_trans_err'],
        car_scale_err=detail[f'{pfx}/car_scale_err'],
        car_orient_err=detail[f'{pfx}/car_orient_err'],
        mAP=detail[f'{pfx}/mAP'], NDS=detail[f'{pfx}/NDS'],
        n_pred_boxes=int(sum(len(r[0]) for r in results)),
        n_gt_boxes=int(sum(len(v) for v in gt_by_token.values())))


def _launched(before):
    from ..ops import launch_counts
    now = launch_counts()
    return {k: v - before[k] for k, v in now.items() if v != before[k]}


def run(cfg, steps, n_batches, data='consistent', device='cuda', dtype=None,
        model=None, log=print):
    """Train `cfg`'s model for `steps` steps over `n_batches` batches of
    `data` on `device` and return the study's record (see the module's
    docstring). dtype: the model's compute dtype (default bf16); model: a
    port Vampire with its weights (default: `new_model`'s), trained in
    place."""
    import torch
    from ..ops import launch_counts
    from ..serving.server import set_fp32_precision
    from ..training.train_state import create_train_state
    from ..training.train_step import build_train_step

    dev = require_device(device)
    if dev.type == 'cuda':
        set_fp32_precision()
    dtype = torch.bfloat16 if dtype is None else dtype
    batches = make_batches(cfg, n_batches, data)
    on_dev = [to_device(b, dev) for b in batches]
    if model is None:
        model = new_model(cfg, dev, dtype)
    state = create_train_state(model, cfg.train,
                               steps_per_epoch=max(steps, 1))
    step = build_train_step(cfg)
    cuda = dev.type == 'cuda'
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    hist = {k: [] for k in KEYS}
    step_ms, launches = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        before = launch_counts()
        h0 = time.perf_counter()
        state, logs = step(state, on_dev[i % len(on_dev)])
        # one device read of the step's logs: it waits for the step
        vals = torch.stack([logs[k].float() for k in KEYS]).tolist()
        step_ms.append((time.perf_counter() - h0) * 1e3)
        launches.append(_launched(before))
        for k, v in zip(KEYS, vals):
            hist[k].append(v)
        if i == 0:
            log(f'step 0 (with warm-up): {step_ms[0] / 1e3:.1f} s')
        if i % 25 == 0 or i == steps - 1:
            log(f'step {i:4d}  total {hist["total_loss"][-1]:8.3f}  '
                f'det {hist["detection_loss"][-1]:7.3f}  '
                f'occ {hist["visible_occ_seg_loss"][-1]:6.3f}  '
                f'pts {hist["pts_seg_loss"][-1]:6.3f}  '
                f'gn {hist["grad_norm"][-1]:8.1f}')
    dt = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None

    summary = summarize(hist, steps)
    for k in KEYS:
        log(f'{k:28s} {summary[k]["first"]:10.4f} -> '
            f'{summary[k]["last"]:10.4f}')
    out = None
    eval_launches = None
    if data == 'consistent':
        before = launch_counts()
        out = score(detections(model, cfg, batches, dev), batches, cfg)
        eval_launches = _launched(before)
        log(f'overfit det eval: car AP {out["car_ap"]}  '
            f'ATE {out["car_trans_err"]:.3f}  NDS {out["NDS"]:.4f}')
    decreasing = [k for k in KEYS[:-1]
                  if summary[k]['last'] < summary[k]['first']]
    log(f'decreasing terms: {len(decreasing)}/{len(KEYS) - 1}')
    return dict(steps=steps, batches=n_batches, wall_s=round(dt, 1),
                summary=summary, det_eval=out, history=hist,
                device=str(dev), dtype=str(dtype).replace('torch.', ''),
                data=data, step_ms=step_ms, launches=launches,
                eval_launches=eval_launches, peak_gb=peak_gb)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=150)
    ap.add_argument('--batches', type=int, default=4)
    # 'consistent': the procedural scene, every active term learnable, so a
    # term that does not fall is a fault; 'noise': i.i.d. labels
    ap.add_argument('--data', choices=['consistent', 'noise'],
                    default='consistent')
    ap.add_argument('--out', default=DEFAULT_OUT)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    from ..configs import flagship_config

    rec = run(flagship_config(), args.steps, args.batches, data=args.data,
              device=args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(rec, f)
    print(f'wrote {args.out} ({args.steps} steps, {rec["wall_s"]:.0f} s)')
    return rec


if __name__ == '__main__':
    main()
