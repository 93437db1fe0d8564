"""Run-to-run spread of the flagship train step's step-0 gradients: in one
process, in fresh processes and in world-1 ranks.

    python -m vampire_tpu_torch.tools.grad_spread [--runs 2]

Run from the repository root on a CUDA card. Builds the kernels, then runs
`parallel._testing.trainer_run` (flagship_config, bf16, B=1, one step on
one synthetic batch, seeded random weights) `--runs` times in this process
(label A), `--runs` times in fresh spawned processes that join no process
group (B) and `--runs` times as a spawned world-1 rank over NCCL (C). For
every pair of runs it prints the step-0 loss's equality and, per tensor,
|d|/|g| of the gradients AdamW receives (`clipped`) and of the same
gradients before the global-norm clip (`unclipped`, each run's own
grad_norm / gradient_clip_val times the clipped ones): the median, the
90th percentile and the max over the tensors. Then one JSON line: per
kind, the range of each statistic over the pairs, the grad_norms, and the
card's name and power limit. `chip_smoke.py`'s multi phase holds the
distributed step to these statistics.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
import json
import os
import statistics
import subprocess
import tempfile

import numpy as np


def pair_stats(a: dict, b: dict, max_norm: float) -> dict:
    """Per-tensor |d|/|g| statistics of two runs' step-0 gradients, clipped
    and unclipped."""
    from ..parallel._testing import unclipped
    out = dict(loss_equal=a['logs'][0]['total_loss']
               == b['logs'][0]['total_loss'])
    for kind in ('clipped', 'unclipped'):
        ga, gb = a['grads'], b['grads']
        if kind == 'unclipped':
            ga = unclipped(ga, a['logs'][0]['grad_norm'], max_norm)
            gb = unclipped(gb, b['logs'][0]['grad_norm'], max_norm)
        rel = []
        for n, g in ga.items():
            g = g.astype(np.float64)
            ref = float(np.linalg.norm(g))
            if ref:
                rel.append(float(np.linalg.norm(gb[n] - g)) / ref)
        rel.sort()
        out[kind] = dict(median=statistics.median(rel),
                         p90=rel[int(0.9 * len(rel))], max=rel[-1])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--runs', type=int, default=2,
                    help='runs of each kind (default 2)')
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('grad_spread runs on a CUDA card')
    from ..configs import flagship_config, synthetic_batch
    from ..ops import _build
    from ..parallel.distributed import spawn
    from ..parallel._testing import in_fresh_process, trainer_run
    _build.build(('lift', 'rays'))
    cfg = flagship_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, max_epochs=1, batch_size_per_device=1, num_devices=1))
    batch = synthetic_batch(cfg, batch_size=1, n_points=cfg.train.max_points,
                            seed=40, mode='train')
    runs = {}
    with tempfile.TemporaryDirectory() as wd:
        for i in range(args.runs):
            for kind in 'ABC':
                label = f'{kind}{i + 1}'
                run_args = (cfg, [[batch]], os.path.join(wd, label))
                if kind == 'A':
                    r = trainer_run(*run_args, device='cuda')
                elif kind == 'B':
                    r = in_fresh_process(trainer_run,
                                         run_args + (None, 'cuda'), 600)
                else:
                    r = spawn(trainer_run, 1, run_args, device='cuda',
                              timeout_s=600)[0]
                runs[label] = dict(logs=r['logs'], grads=r['grads'])
                print(f'{label}: loss {r["logs"][0]["total_loss"]!r} '
                      f'grad_norm {r["logs"][0]["grad_norm"]!r}', flush=True)
                del r
                gc.collect()
                torch.cuda.empty_cache()
    clip = cfg.train.gradient_clip_val
    ranges = {k: {q: [] for q in ('median', 'p90', 'max')}
              for k in ('clipped', 'unclipped')}
    all_equal = True
    for a, b in itertools.combinations(runs, 2):
        st = pair_stats(runs[a], runs[b], clip)
        all_equal &= st['loss_equal']
        print(f'{a}-{b} loss equal {st["loss_equal"]}; ' + '; '.join(
            f'{k} median {st[k]["median"]:.3e} p90 {st[k]["p90"]:.3e} '
            f'max {st[k]["max"]:.3e}' for k in ('clipped', 'unclipped')),
            flush=True)
        for k in ranges:
            for q in ranges[k]:
                ranges[k][q].append(st[k][q])
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(
        runs=args.runs, pairs=len(ranges['clipped']['max']),
        losses_equal=all_equal,
        grad_norms={k: v['logs'][0]['grad_norm'] for k, v in runs.items()},
        **{k: {q: [min(v), max(v)] for q, v in d.items()}
           for k, d in ranges.items()}, card=card)), flush=True)


if __name__ == '__main__':
    main()
