"""Stage split of one flagship request on each serving path, and of one
flagship train step.

    python -m vampire_tpu_torch.tools.stage_split [--iters 10]

Run from the repository root on a CUDA card. For the metrics graph and the
full-render graph in turn it builds `InferenceServer(flagship_config(),
dtype=bfloat16)` with seeded random weights, calibrates BatchNorm on one
synthetic frame (`chip_smoke.calibrate_batchnorm_`), warms up, then times
`--iters` calls of `InferenceServer.forward`. Then it builds
`Trainer(flagship_config())` (bf16, seeded random weights) and times
`--iters` steps of `build_train_step` on two synthetic training batches.
For each it prints:

  * the forward's (the step's) host-clock median, min and max;
  * per stage, the mean CUDA-event span per forward (per step): the
    encoder, the lift (its op in each direction, and its masked-mean divide
    and permute), the Unet3D, the queries, the BEV render, the camera
    rays and their parts (the channels-last field copy, each ray kernel;
    in the step also the ray backward and the field gradient's permute
    back), the det head, each kernel; in the step also the losses, the
    backward, the clipping and the AdamW update. A span
    includes the host's launch gaps inside it, so it is the stage's
    latency, not its device busy time;
  * the peak device memory of one forward (one step);
  * the `torch.profiler` device time per forward (per step) of the top
    entries over three more.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--iters', type=int, default=10)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('stage_split: needs a CUDA card')
    sys.path.insert(0, ROOT)
    import chip_smoke
    from vampire_tpu_torch.configs import flagship_config, synthetic_batch
    from vampire_tpu_torch.models import field as F
    from vampire_tpu_torch.ops import _build, lift, rays
    from vampire_tpu_torch.serving import InferenceServer
    from vampire_tpu_torch.training import train_step as TS
    from vampire_tpu_torch.training.trainer import Trainer

    _build.build(chip_smoke.KERNEL_LIBS)
    cfg = flagship_config()
    frames = []
    for seed in range(2):
        b = synthetic_batch(cfg, batch_size=1, n_points=cfg.train.max_points,
                            seed=seed, mode='val')
        frames.append({k: np.asarray(b[k]) for k in
                       ('imgs', 'sensor2ego', 'intrin', 'ida', 'bda',
                        'points')})
    batch = frames[0]
    calib = {k: v[0] for k, v in frames[1].items()}
    spans = {}
    active = [False]

    def timed(name, fn):
        def g(*a, **kw):
            if not active[0]:
                return fn(*a, **kw)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            spans.setdefault(name, []).append((e0, e1))
            return out
        return g

    fb = F.FieldBackbone
    for meth in ('lift', '_masked_mean', '_query_points', '_query_occ',
                 '_render_bev', '_ray_fields', '_render_cameras'):
        setattr(fb, meth, timed(meth, getattr(fb, meth)))
    for mod, name in ((lift, 'lift_frame_accumulate'),
                      (lift, 'lift_frame_backward'),
                      (rays, 'sample_and_composite_rays'),
                      (rays, 'sample_and_composite_rays_backward')):
        setattr(mod, name, timed(f'{name} kernel', getattr(mod, name)))
    # the lift op's two directions whole: the forward with its
    # accumulators' allocation, the backward with its gradients' zero-fill,
    # the kernel and the cast
    lift.LiftFrame.forward = timed('lift op forward', lift.LiftFrame.forward)
    lift.LiftFrame.backward = timed('lift op backward (zero-fill, kernel, '
                                    'cast)', lift.LiftFrame.backward)
    # the ray branch's other backward parts: the ray op's backward (the
    # d field's zero-fill, the kernel and the cast to the field's dtype) and
    # the field copy's backward (the permute back to channels-first)
    rays.RenderRays.backward = timed('rays backward (zero-fill, kernel, '
                                     'cast)', rays.RenderRays.backward)
    rays.ChannelsLastField.backward = timed(
        'field gradient permute', rays.ChannelsLastField.backward)
    F.G.get_geometry = timed('get_geometry', F.G.get_geometry)
    F.ray_inputs = timed('ray_inputs', F.ray_inputs)
    F.S.resize_linear = timed('resize_linear (x4 up, x0.5 bev)',
                              F.S.resize_linear)

    def time_stages(model, run, label, unit):
        """Warm up, then time args.iters calls of run() and print the
        split, the peak memory and the profiler's top entries."""
        for mod in ('img_backbone', 'img_neck', 'base_conv', 'voxel_output'):
            sub = getattr(model.backbone, mod)
            sub.forward = timed(mod, sub.forward)
        model.head.forward = timed('det head', model.head.forward)
        n = args.iters
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        spans.clear()
        active[0] = True
        host = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        active[0] = False
        print(f'== {label}: host clock median {statistics.median(host):.2f} '
              f'ms, min {min(host):.2f}, max {max(host):.2f} ({n} {unit}s)',
              flush=True)
        for name, ev in spans.items():
            per = [a.elapsed_time(b) for a, b in ev]
            print(f'  {name:40s} {sum(per) / n:8.3f} ms per {unit} '
                  f'({len(per) // n} calls)')
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        print(f'  peak device memory '
              f'{torch.cuda.max_memory_allocated() / 1e9:.3f} GB')
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(3):
                run()
            torch.cuda.synchronize()

        def dev(e):
            return getattr(e, 'self_device_time_total',
                           getattr(e, 'self_cuda_time_total', 0))
        ka = prof.key_averages()
        print(f'  profiler: device self time '
              f'{sum(dev(e) for e in ka) / 3e3:.2f} ms per {unit}')
        for e in sorted(ka, key=dev, reverse=True)[:14]:
            print(f'    {dev(e) / 3e3:8.3f} ms  {e.count // 3:4d}x  '
                  f'{e.key[:90]}', flush=True)

    for outputs in ('metrics', None):
        srv = InferenceServer(cfg, device='cuda', dtype=torch.bfloat16,
                              outputs=outputs, seed=0)
        chip_smoke.calibrate_batchnorm_(
            srv.model, srv.to_device({k: v[None] for k, v in calib.items()}),
            srv.camera_renders)
        time_stages(srv.model, lambda: srv.forward(batch),
                    f'{"metrics" if outputs else "full-render"} forward()',
                    'forward')
        del srv
        torch.cuda.empty_cache()

    # the train step: the same stages, plus the losses, the backward, the
    # clipping and the AdamW update
    loader = [synthetic_batch(cfg, batch_size=1,
                              n_points=cfg.train.max_points, seed=10 + i,
                              mode='train') for i in range(2)]
    with tempfile.TemporaryDirectory() as wd:
        trainer = Trainer(cfg, workdir=wd, device='cuda')
        state = trainer.init_state(loader[0], len(loader))
        on_card = [trainer.to_device(b) for b in loader]
        step = TS.build_train_step(cfg, with_metrics=True)
        conf = [TS.init_train_confusion(cfg, trainer.device)]
        TS.compute_losses = timed('losses', TS.compute_losses)
        TS.clip_by_global_norm_ = timed('clip_by_global_norm_',
                                        TS.clip_by_global_norm_)
        torch.autograd.backward = timed('backward (all of it)',
                                        torch.autograd.backward)
        state.optimizer.step = timed('AdamW step', state.optimizer.step)
        it = [0]

        def train_once():
            nonlocal state
            state, _, conf[0] = step(state, on_card[it[0] % 2], conf[0])
            it[0] += 1
        time_stages(trainer.model, train_once, 'train step (bf16, B=1)',
                    'step')


if __name__ == '__main__':
    main()
