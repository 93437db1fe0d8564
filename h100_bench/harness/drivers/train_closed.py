"""Closed-loop training: the step `Trainer.fit` runs each iteration
(`Trainer.to_device`, then the `build_train_step(cfg, with_metrics=True)`
step) back to back on a pool of host batches, with no loader, no
checkpoint and no validation.

Traffic parameters: `rows` a batch, `pool` batches (every row distinct),
`checked_steps` (the first steps, which the reference follows).

Set-up builds one Trainer, loads the seeded weights, and drives the first
`checked_steps` steps through the window's own call and feed: they warm
every shape and give the program's side of the check. The window then
steps on the same state until `--seconds` have passed, and ends with a
synchronise. Reported: `train_samples_per_s` (rows stepped over the
window's seconds) and `train_peak_gib` (`max_memory_allocated` over the
window)."""
from __future__ import annotations

import gc
import shutil
import tempfile
import time

import torch

from .. import compare, frames, refrun
from ..kernels import OpCalls, install
from ..spans import Patches
from ..trace import Window

STEPS_PER_EPOCH = 10 ** 9       # no learning-rate milestone is reached


def run(ctx) -> dict:
    P = ctx.program
    tr = ctx.traffic
    rows, n_checked = tr['rows'], tr['checked_steps']
    torch.manual_seed(ctx.torch_seed('global'))
    pool = frames.train_pool(ctx.rcfg, rows, tr['pool'], ctx.seed)
    if n_checked > len(pool):
        raise ValueError('checked steps need rows that all differ')
    ctx.fit_density([{k: b[k][r] for k in frames.INPUT_KEYS}
                     for b in pool[:1] for r in range(min(2, rows))],
                    train=True)
    workdir = tempfile.mkdtemp(prefix='h100_bench_')
    trainer = P.trainer_module.Trainer(ctx.pcfg, workdir=workdir,
                                       device=ctx.device)
    trainer.model.load_state_dict(ctx.weights(), strict=True)
    state = P.train_state_module.create_train_state(
        trainer.model, ctx.pcfg.train, STEPS_PER_EPOCH)
    step = P.train_step_module.build_train_step(
        ctx.pcfg, trainer.num_devices, with_metrics=True)
    conf = [P.train_step_module.init_train_confusion(ctx.pcfg,
                                                     trainer.device)]
    if ctx.fault:
        step = ctx.fault(ctx, step, trainer, state)

    def step_fn(s, dev_batch):
        s, logs, conf[0] = step(s, dev_batch, conf[0])
        return logs

    prog = refrun.follow(state, pool[:n_checked], ctx.pcfg, ctx.device,
                         step_fn, trainer.to_device)
    spans = ctx.spans
    ops = OpCalls(spans, keep=rows)
    with Patches() as patches:
        if ctx.trace:
            ts = P.train_step_module
            model = trainer.model
            patches.set(torch.autograd, 'backward',
                        spans.device('trainer.backward',
                                     torch.autograd.backward))
            patches.set(ts, 'clip_by_global_norm_', spans.device(
                'trainer.optimizer', ts.clip_by_global_norm_))
            patches.set(state.optimizer, 'step', spans.device(
                'trainer.optimizer', state.optimizer.step))
            for sub in (model.backbone.img_backbone, model.backbone.img_neck):
                patches.set(sub, 'forward',
                            spans.device('model.encoder', sub.forward))
            install(patches, ops, P, backward=True)
        ctx.sync()
        setup_peak = ctx.peak_bytes()
        ctx.reset_peak()
        n = 0
        spans.on = ctx.trace
        with Window(ctx.trace, ctx.device) as win:
            ctx.mark_setup_done()
            while True:
                batch = pool[(n_checked + n) % len(pool)]
                step_fn(state, trainer.to_device(batch))
                n += 1
                if time.perf_counter() - win.t0 >= ctx.seconds:
                    break
            ctx.sync()
            seconds = win.close()
        spans.on = False
        window_peak = ctx.peak_bytes()
        readings = dict(units=n, window_s=seconds, trace=win.summary,
                        device_spans=spans.device_ms(),
                        least_s_per_unit=ctx.least_seconds(rows, True))
        if ctx.trace and ctx.cuda:
            readings['lift'] = ops.share(('lift.forward', 'lift.backward'))
            readings['rays'] = ops.share(('rays.forward', 'rays.backward'))
        ops.clear()
    if trainer._log_file is not None:
        trainer._log_file.close()
    del trainer, state, step, conf, ops
    gc.collect()
    shutil.rmtree(workdir, ignore_errors=True)
    metrics = dict(train_samples_per_s=n * rows / seconds,
                   train_peak_gib=window_peak / 2 ** 30)

    def check():
        ref = refrun.train(ctx.rcfg, ctx.device, ctx.weights,
                           pool[:n_checked], STEPS_PER_EPOCH)
        ctx.keep.update(reference=ref, program=prog,
                        batches=pool[:n_checked])
        return compare.train_numbers(prog, ref)

    return dict(metrics=metrics, attempted=n, failed=0,
                memory_peak_bytes=max(setup_peak, window_peak),
                readings=readings, check=check)
