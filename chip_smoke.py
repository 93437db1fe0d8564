#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line; any failure raises and the script exits
nonzero without printing a result:

  1. device  - a CUDA card must be present (no CPU fallback); prints
               `nvidia-smi --query-gpu=name,power.limit`.
  2. build   - nvcc builds vampire_tpu_torch/csrc/lift.cu for sm_90a.
  3. kernel  - the lift kernel against its plain torch version at the
               flagship per-camera shapes (D=86, h=64, w=176, C=16, K=264,
               Q=1280; camera_rig geometry, torch.topk selection), in fp32
               and bf16, with the error and the median time of each.
  4. slice   - InferenceServer(flagship_config(), device='cuda',
               outputs='metrics') in bf16 with seeded random weights serves
               3 full-width requests (6x256x704 images, 36,864 points).
               Checks shapes, finiteness, det boxes after NMS, that the lift
               kernel ran 6 times per request, and that request 0 matches
               the same forward with the plain lift on the card.

The line before the last is a JSON object of the kernels run; the last line
is `{"ok": true, "device": {...}}`.
"""
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_REQUESTS = 3
# kernel vs plain: same input values, fp32 weights and sums in the same order
# on both sides; only FMA contraction differs (~1e-7 of |value|)
KERNEL_RTOL = 1e-5
# whole forward, kernel lift vs plain lift: the two lifts differ in the last
# fp32 bits, which can flip the bf16 rounding of a voxel feature (2^-8
# relative) entering the bf16 Unet3D; allow 5% of each output's magnitude
SLICE_RTOL = 5e-2


def say(msg):
    print(f'[chip_smoke] {msg}', flush=True)


def device_phase():
    import torch
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    say(f'device: {torch.cuda.get_device_name(0)} x '
        f'{torch.cuda.device_count()}, torch {torch.__version__}, '
        f'CUDA {torch.version.cuda}')
    print(card, flush=True)
    return card


def build_phase():
    from vampire_tpu_torch.ops import lift
    t0 = time.perf_counter()
    info = lift.build()
    ptxas = [ln for ln in info['log'].splitlines() if 'ptxas' in ln]
    say(f'build: {os.path.relpath(info["path"], ROOT)} in '
        f'{time.perf_counter() - t0:.2f} s (nvcc {info["seconds"]:.2f} s)')
    for ln in ptxas:
        say(f'  {ln.strip()}')


def cuda_ms(fn, iters, warmup=3):
    """Median milliseconds of fn() on the card, one CUDA event pair each."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_phase(card, bc=None, dev='cuda'):
    import torch
    from vampire_tpu_torch.configs import camera_rig, flagship_config
    from vampire_tpu_torch.core.geometry import get_pixel
    from vampire_tpu_torch.models.field import block_major_voxels, coords_valid
    from vampire_tpu_torch.ops import lift

    dev = torch.device(dev)
    bc = bc or flagship_config().backbone
    D, (h, w), C = bc.depth_channels, bc.feat_hw, bc.mid_channels
    rig = {k: torch.from_numpy(v).to(dev)
           for k, v in camera_rig(1, 6, bc.final_dim, seed=0).items()}
    vox = torch.from_numpy(block_major_voxels(bc)).to(dev)
    pix = get_pixel(vox[:, :, None], rig['sensor2ego'], rig['intrin'],
                    rig['ida'], rig['bda'])[..., 0, :]
    coords, valid = coords_valid(pix, bc)
    counts = valid.sum(-1)
    G, Q = valid.shape[2:]
    K = min(bc.lift_block_topk, G)
    g = torch.Generator(device=dev).manual_seed(0)
    depth = torch.softmax(torch.randn(6, D, h, w, device=dev, generator=g),
                          dim=1)
    feat = torch.randn(6, h, w, C, device=dev, generator=g)
    cams = []
    for n in range(6):
        ids = torch.topk(counts[0, n], K).indices
        cams.append((ids, coords[0, n][ids].contiguous(),
                     valid[0, n][ids].contiguous()))
    say(f'kernel: depth ({D},{h},{w}) feat ({h},{w},{C}) K={K} Q={Q} G={G}, '
        f'6 cameras, {int(valid[0].sum())} valid queries')

    result = dict(max_abs_err=0.0)
    for dt in (torch.float32, torch.bfloat16):
        dep, fea = depth.to(dt), feat.to(dt)
        acc_k = [torch.zeros(G, Q, C, device=dev) for _ in range(2)]
        acc_r = [torch.zeros(G, Q, C, device=dev) for _ in range(2)]
        for n, (ids, cc, vv) in enumerate(cams):
            lift.lift_accumulate_(dep[n], fea[n], ids, cc, vv, *acc_k)
            lift.lift_accumulate_reference(dep[n], fea[n], ids, cc, vv,
                                           *acc_r)
        torch.cuda.synchronize()
        err = (acc_k[0] - acc_r[0]).abs().max().item()
        scale = acc_r[0].abs().max().item()
        dmis = int((acc_k[1] != acc_r[1]).sum())
        tol = KERNEL_RTOL * max(1.0, scale)
        ids, cc, vv = cams[1]
        scratch = [torch.zeros(G, Q, C, device=dev) for _ in range(2)]
        ms = cuda_ms(lambda: lift.lift_accumulate_(dep[1], fea[1], ids, cc,
                                                   vv, *scratch), 50)
        plain = cuda_ms(lambda: lift.lift_accumulate_reference(
            dep[1], fea[1], ids, cc, vv, *scratch), 10)
        name = str(dt).replace('torch.', '')
        say(f'kernel {name}: max abs err {err:.3e} (max |ref| {scale:.3e}, '
            f'tol {tol:.1e}); denom mismatches {dmis} of '
            f'{acc_r[1].numel()}; kernel {ms:.4f} ms, plain {plain:.4f} ms '
            f'per camera [{card}]')
        if not err <= tol:
            raise AssertionError(f'lift kernel {name} disagrees with the '
                                 f'plain version: {err} > {tol}')
        # an exact cancellation to 0 can flip one count; allow 1e-6 of them
        if dmis > 1e-6 * acc_r[1].numel():
            raise AssertionError(f'lift kernel {name}: {dmis} denominator '
                                 f'counts differ')
        result['max_abs_err'] = max(result['max_abs_err'], err)
        result[name] = dict(ms=ms, plain_ms=plain)
    return result


def calibrate_batchnorm_(server, frame):
    """Set every BatchNorm's running statistics to the batch statistics of
    one synthetic frame (one train-mode forward, momentum 1).

    Seeded random weights leave BN the identity, so activations grow
    through the residual stacks (~3x in variance per bottleneck) until the
    heads saturate: sigmoid scores of exactly 1 and exp(dim) overflowing.
    Calibrated statistics keep every layer in its working range, as a
    trained model's would.
    """
    import torch
    bns = [m for m in server.model.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.momentum = 1.0
    imgs, mats, points = server.to_device({k: v[None]
                                           for k, v in frame.items()})
    server.model.train()
    with torch.no_grad():
        server.model(imgs, mats, points=points)
    server.model.eval()
    say(f'calibrated {len(bns)} BatchNorm layers on one synthetic frame')


def slice_phase(card, cfg=None, dev='cuda'):
    import numpy as np
    import torch
    from vampire_tpu_torch.configs import flagship_config, synthetic_batch
    from vampire_tpu_torch.ops import lift
    from vampire_tpu_torch.serving import InferenceServer

    cfg = cfg or flagship_config()
    frames = []
    for i in range(N_REQUESTS + 1):
        b = synthetic_batch(cfg, batch_size=1,
                            n_points=cfg.train.max_points, seed=i,
                            mode='val')
        frames.append({k: np.asarray(b[k])[0] for k in
                       ('imgs', 'sensor2ego', 'intrin', 'ida', 'bda',
                        'points')})
    samples, calib = frames[:N_REQUESTS], frames[N_REQUESTS]
    t0 = time.perf_counter()
    server = InferenceServer(cfg, device=dev, dtype=torch.bfloat16,
                             outputs='metrics', seed=0)
    calibrate_batchnorm_(server, calib)
    t1 = time.perf_counter()
    server.start()
    outs, lat = [], []
    try:
        server.warmup()
        say(f'slice: model built and BN calibrated in {t1 - t0:.1f} s, '
            f'warmup request {time.perf_counter() - t1:.1f} s')
        lift.LAUNCHES = 0
        for s in samples:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            a.record()
            outs.append(server.infer(s))
            b.record()
            b.synchronize()
            lat.append((a.elapsed_time(b), (time.perf_counter() - h0) * 1e3))
        launches = lift.LAUNCHES
    finally:
        server.stop()
    for i, (ev, host) in enumerate(lat):
        say(f'request {i}: {ev:.2f} ms (CUDA events), {host:.2f} ms (host '
            f'clock), incl. host NMS [{card}]')
    if launches != 6 * N_REQUESTS:
        raise AssertionError(f'lift kernel launched {launches} times for '
                             f'{N_REQUESTS} requests, want {6 * N_REQUESTS}')
    say(f'lift kernel launches during the requests: {launches}')

    bc, hc = cfg.backbone, cfg.head
    gx, gy, gz = bc.occ_grid
    Kc, P = bc.num_classes, cfg.train.max_points
    want = dict(occ_logits=(gx, gy, gz, Kc), occ_density=(gx, gy, gz),
                pts_logits=(P, Kc))
    for i, o in enumerate(outs):
        if set(o) != set(want) | {'det'}:
            raise AssertionError(f'request {i}: outputs {sorted(o)}')
        for k, shape in want.items():
            if o[k].shape != shape or not np.isfinite(o[k]).all():
                raise AssertionError(f'request {i}: {k} {o[k].shape} '
                                     f'finite={np.isfinite(o[k]).all()}')
        boxes, scores, labels = o['det']
        if len(boxes) == 0:
            raise AssertionError(f'request {i}: no boxes after NMS')
        if (boxes.ndim != 2 or boxes.shape[1] != 9
                or not np.isfinite(boxes).all()
                or scores.shape != (len(boxes),)
                or labels.shape != (len(boxes),)
                or len(boxes) > hc.nms_post_max_size * len(hc.tasks)
                or not (scores > hc.score_threshold).all()):
            raise AssertionError(
                f'request {i}: det {boxes.shape} {scores.shape} '
                f'{labels.shape}; non-finite per column '
                f'{(~np.isfinite(boxes)).sum(0).tolist()}, max |box| per '
                f'column {np.abs(boxes).max(0).tolist()}, scores '
                f'{scores.min() if len(scores) else None}..'
                f'{scores.max() if len(scores) else None}')
        say(f'request {i}: shapes ok, finite, {len(boxes)} boxes after NMS')

    # request 0 again, with the plain lift on the card
    batch = {k: v[None] for k, v in samples[0].items()}
    with torch.inference_mode():
        imgs, mats, points = server.to_device(batch)
        fo, _ = server.model(imgs, mats, points=points, lidar_seg=True,
                             lift_fn=lift.lift_accumulate_reference)
    errs = {}
    for k in want:
        ref = fo[k][0].float().cpu().numpy()
        err = float(np.abs(outs[0][k] - ref).max())
        tol = SLICE_RTOL * max(1.0, float(np.abs(ref).max()))
        errs[k] = err
        say(f'request 0 vs plain-lift forward: {k} max abs err {err:.3e} '
            f'(tol {tol:.3e}, mean abs err '
            f'{float(np.abs(outs[0][k] - ref).mean()):.3e})')
        if not err <= tol:
            raise AssertionError(f'{k}: kernel forward vs plain-lift forward '
                                 f'{err} > {tol}')
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                         'this script runs only on a CUDA card')
    import vampire_tpu_torch  # noqa: F401  (the port, from this checkout)
    card = device_phase()
    build_phase()
    k = kernel_phase(card)
    launches = slice_phase(card)
    leaked = [m for m in ('jax', 'flax', 'optax') if m in sys.modules]
    if leaked:
        raise AssertionError(f'the port imported {leaked}')
    print(json.dumps({'kernels': [{
        'name': 'lift_accumulate',
        'route': 'cuda',
        'source': 'vampire_tpu_torch/csrc/lift.cu',
        'replaces': 'vampire_tpu/ops/pallas_tables.py:289',
        'also_replaces': 'vampire_tpu/ops/pallas_gather.py:68',
        'launches': launches,
        'max_abs_err': k['max_abs_err'],
        'ms': k['bfloat16']['ms'],
        'plain_ms': k['bfloat16']['plain_ms'],
        'fp32_ms': k['float32']['ms'],
        'fp32_plain_ms': k['float32']['plain_ms'],
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    sys.path.insert(0, ROOT)
    main()
