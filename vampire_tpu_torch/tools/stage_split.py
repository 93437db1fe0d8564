"""Stage split of one flagship request on each serving path, and of one
flagship train step, read from the port's own spans (`utils.profiling`).

    python -m vampire_tpu_torch.tools.stage_split [--iters 10]

Run from the repository root on a CUDA card. For the metrics graph and the
full-render graph in turn it builds `InferenceServer(flagship_config(),
dtype=bfloat16)` with seeded random weights, calibrates BatchNorm on one
synthetic frame (`chip_smoke.calibrate_batchnorm_`), warms up, then times
`--iters` calls of `InferenceServer.forward` with the tracer on. Then it
builds `Trainer(flagship_config())` (bf16, seeded random weights) and times
`--iters` steps (`Trainer.to_device`, then the `build_train_step` step) on
two synthetic training batches. For each it prints:

  * the forward's (the step's) host-clock median, min and max;
  * each span's mean host ms per forward (per step) and its calls: the
    `server.*` phases, the `trainer.*` phases and the `model.*` stages,
    and for the step's device spans (`trainer.to_device`,
    `trainer.forward`, `trainer.losses`) their CUDA-event ms. A host span of a stage is the time the host took
    to launch it, not the device's work, which runs behind;
  * the peak device memory of one forward (one step);
  * the `torch.profiler` device time per forward (per step) of the top
    entries over three more.
"""
from __future__ import annotations

import argparse
import collections
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
    from vampire_tpu_torch.ops import _build
    from vampire_tpu_torch.serving import InferenceServer
    from vampire_tpu_torch.training import train_step as TS
    from vampire_tpu_torch.training.trainer import Trainer
    from vampire_tpu_torch.utils import profiling

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

    def time_stages(run, label, unit):
        """Warm up, then time args.iters calls of run() with the tracer on
        and print the split, the peak memory and the profiler's top
        entries."""
        n = args.iters
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        host = []
        profiling.enable()
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        profiling.disable()
        print(f'== {label}: host clock median {statistics.median(host):.2f} '
              f'ms, min {min(host):.2f}, max {max(host):.2f} ({n} {unit}s)',
              flush=True)
        spans = collections.defaultdict(list)
        for s in profiling.collect()['spans']:
            spans[s['name']].append(s)
        for name, ss in spans.items():
            ms = sum(s['end_ns'] - s['start_ns'] for s in ss) / 1e6 / n
            dev = [s['device_ms'] for s in ss if 'device_ms' in s]
            extra = f', device {sum(dev) / n:8.3f}' if dev else ''
            print(f'  {name:24s} host {ms:8.3f} ms per {unit}{extra} '
                  f'({len(ss) / n:g} calls)')
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
        time_stages(lambda: srv.forward(batch),
                    f'{"metrics" if outputs else "full-render"} forward()',
                    'forward')
        del srv
        torch.cuda.empty_cache()

    # the train step: the same stages, plus its own phases
    loader = [synthetic_batch(cfg, batch_size=1,
                              n_points=cfg.train.max_points, seed=10 + i,
                              mode='train') for i in range(2)]
    with tempfile.TemporaryDirectory() as wd:
        trainer = Trainer(cfg, workdir=wd, device='cuda')
        state = trainer.init_state(loader[0], len(loader))
        step = TS.build_train_step(cfg, with_metrics=True)
        conf = [TS.init_train_confusion(cfg, trainer.device)]
        it = [0]

        def train_once():
            nonlocal state
            b = trainer.to_device(loader[it[0] % 2])
            state, _, conf[0] = step(state, b, conf[0])
            it[0] += 1
        time_stages(train_once, 'train step (bf16, B=1)', 'step')


if __name__ == '__main__':
    main()
