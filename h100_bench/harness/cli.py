"""One run of one cell: parse the command line, refuse without the cards
the cell asks for, build and warm the program, measure the window, free
the program, check its outputs against the plain reference, and print
the result line."""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from typing import Callable, Optional

import torch

from . import compare, flops, frames, guard, spec
from .program import Program
from .seeds import torch_seed
from .spans import Spans
from .weights import make_state_dict


class Context:
    """Everything a driver needs about the run it drives."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device, t_start: float, fault: Optional[Callable] = None):
        import reference.configs as RC
        self.cell = cell
        self.traffic = cell['traffic_file']
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = torch.device(device)
        self.cuda = self.device.type == 'cuda'
        self.t_start = t_start
        self.fault = fault
        self.program = Program()
        conf = cell['config_file']
        self.pcfg = spec.build_config(conf['config'], self.program.configs)
        self.rcfg = spec.build_config(conf['config'], RC)
        self.weight_spec = conf.get('weights', {})
        self.spans = Spans(self.device)
        self.keep = {}
        self.setup_s = None
        self.reference_s = 0.0
        self._shapes = None

    def torch_seed(self, tag: str) -> int:
        return torch_seed(self.seed, tag)

    def weights(self, spec: Optional[dict] = None):
        """The seeded state dict on the run's device (made anew a call),
        by the configuration's `weights` (or `spec`)."""
        if self._shapes is None:
            from reference.models.vampire import Vampire
            self._shapes = Vampire(self.rcfg.backbone, self.rcfg.head,
                                   device='meta')
        spec = self.weight_spec if spec is None else spec
        return make_state_dict(self._shapes, self.seed, self.device, spec)

    def calib_frame(self) -> dict:
        """The frame BatchNorm is calibrated on, for a served cell."""
        return frames.frame_pool(self.rcfg, 1, self.seed, 'calib')[0]

    def fit_density(self, frames_, train: bool) -> None:
        """Fit the density head where the configuration asks for it
        (`harness/density.py`), before the program is built; the fit is
        then part of every state dict of the run."""
        if self.weight_spec.get('density_head') != 'partly_opaque':
            return
        from .density import fit_for_run
        t0 = time.perf_counter()
        head = fit_for_run(self, frames_, train)
        self.sync()
        self.reference_s += time.perf_counter() - t0
        self.keep['density_head'] = head
        self.weight_spec = dict(self.weight_spec, density_head=dict(
            weight_scale=head['weight_scale'], bias=head['bias']))
        self.reset_peak()

    def least_seconds(self, rows: int, train: bool) -> float:
        return flops.least_seconds(self.rcfg, rows, train)

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.cuda \
            else 0

    def reset_peak(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def mark_setup_done(self):
        """Set-up ends here; the reference's own seconds in it (the
        density fit) are not the program's and are left out."""
        self.setup_s = time.perf_counter() - self.t_start - self.reference_s


def card(device) -> dict:
    d = torch.device(device)
    if d.type != 'cuda':
        return dict(platform='cpu', kind='cpu', count=1)
    out = dict(platform='gpu', kind=torch.cuda.get_device_name(d), count=1)
    try:
        q = subprocess.run(['nvidia-smi', '--query-gpu=power.limit',
                            '--format=csv,noheader,nounits', '-i',
                            str(d.index or 0)], capture_output=True,
                           text=True, timeout=30)
        out['power_limit_w'] = float(q.stdout.strip())
    except (OSError, ValueError, subprocess.TimeoutExpired):
        pass
    return out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, fault: Optional[Callable] = None):
    """Returns (result dict, the numbers compared, the context)."""
    ctx = Context(cell, seed, seconds, trace, device, t_start, fault)
    info = card(device)
    out = spec.driver(ctx.traffic['kind']).run(ctx)
    gc.collect()
    if ctx.cuda:
        torch.cuda.empty_cache()
    metrics = {}
    readings = out['readings']
    if trace:
        for m in cell['per_layer']:
            v = spec.metric_reader(m['name'], cell['base'])(readings)
            if v is not None:
                metrics[m['name']] = dict(value=float(v), unit=m['unit'])
    else:
        values = dict(out['metrics'], setup_s=ctx.setup_s)
        for m in cell['end_to_end']:
            metrics[m['name']] = dict(value=float(values[m['name']]),
                                      unit=m['unit'])
    numbers = out['check']()
    correct, compared = compare.judge(numbers, cell['limits'])
    device_info = dict(info, count=cell['chips'],
                       memory_peak_bytes=int(out['memory_peak_bytes']))
    result = dict(correct=bool(correct), attempted=int(out['attempted']),
                  failed=int(out['failed']), metrics=metrics,
                  device=device_info)
    summary = readings.get('trace')
    if trace and summary is not None:
        device_info['busy_s'] = summary['busy_s']
        device_info['window_s'] = summary['window_s']
        result['breakdown'] = dict(device_ops=summary['device_ops'],
                                   idle_gaps=summary['idle_gaps'])
    if 'density_head' in ctx.keep:
        result['density_head'] = dict(ctx.keep['density_head'],
                                      seconds=ctx.reference_s)
    if 'diagnostics' in out:
        result['diagnostics'] = out['diagnostics']
    result['compared'] = compared
    return result, compared, ctx


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description='One run of one cell of '
                                 'BENCHMARK.json on the card.')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print('h100_bench: no CUDA device; this benchmark runs on the card '
              'only', file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell['chips']:
        print(f'h100_bench: {args.workload} needs {cell["chips"]} cards, '
              f'{torch.cuda.device_count()} found', file=sys.stderr)
        return 2
    os.environ.setdefault('TORCH_EXTENSIONS_DIR', os.path.join(
        spec.ROOT, 'build', 'torch_extensions'))
    os.environ.setdefault('TRITON_CACHE_DIR', os.path.join(
        spec.ROOT, 'build', 'triton'))
    result, compared, _ = run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace), 'cuda:0', t_start)
    bad = guard.forbidden_loaded()
    if bad:
        print(f'h100_bench: the run loaded {bad}', file=sys.stderr)
        return 3
    for k, v in compared.items():
        print(f'compared {k} {v["value"]!r} limit {v["limit"]!r}',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
