"""Test support, not public API: one rank's share of a `Trainer` run,
returned as numpy, and the helpers that hold such runs to each other
(`unclipped`, `in_fresh_process`).

`trainer_run` is what the multi-rank tests and `chip_smoke.py` start in
every rank of a world (`distributed.spawn`) and also run in one process,
to hold the world's run to the one process's on the same global batch.
It lives in the port, not in the tests, so that a spawned rank imports no
test module (and so no jax). No entry point of the port calls it.

    from vampire_tpu_torch.parallel.distributed import spawn
    from vampire_tpu_torch.parallel._testing import trainer_run
    ranks = spawn(trainer_run, 2, (cfg, [[row_a], [row_b]], workdir),
                  device='cpu', timeout_s=600)

The ranks take `cam` (a dp x cam layout of the world, `parallel/mesh.py`;
None: the default layout); each rank's batches are its dp index's rows,
with every camera: `Trainer.to_device` keeps its own.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import statistics
import tempfile
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..ops import launch_counts, reset_launch_counts
from ..training.train_step import (build_metric_eval_step,
                                   build_train_step, init_train_confusion,
                                   split_mats)
from ..training.trainer import Trainer
from .distributed import active, rank, rank_device, world_size
from .mesh import make_layout


class _RecordingTrainer(Trainer):
    """A Trainer that keeps every scalar it logs (on every rank) and this
    rank's own train confusions of the epoch."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.records = []
        self.train_conf = None

    def log_scalars(self, step, scalars):
        self.records.append(dict(step=step, **{k: float(v)
                                               for k, v in scalars.items()}))
        super().log_scalars(step, scalars)

    def _report_train_iou(self, conf, step):
        self.train_conf = [c.cpu().numpy() for c in conf]
        super()._report_train_iou(conf, step)


def _numpy(tensors):
    return {k: v.detach().float().cpu().numpy() if v.is_floating_point()
            else v.detach().cpu().numpy() for k, v in tensors.items()}


def trainer_run(cfg, batches_by_rank: Sequence[Sequence[dict]], workdir: str,
                data_root: Optional[str] = None, device=None,
                init_hook: Optional[Callable] = None, n_timed: int = 0,
                num_devices: Optional[int] = None, cam: Optional[int] = None,
                lift_vectorized: Optional[bool] = None,
                forward: Optional[Sequence[dict]] = None,
                eval_first: bool = False,
                val_batches: Optional[Sequence[Sequence[dict]]] = None,
                image_every: int = 500) -> dict:
    """This rank's run of `Trainer`: `init_state`, `fit` over its batches
    (`batches_by_rank[rank]`, numpy batch dicts) with every step logged,
    `n_timed` more steps timed, then, with a `data_root` (a nuScenes
    layout tree), `validate` on its val split and `test` and `predict` on
    its val and test splits through the CLI's loaders (`cli.make_loader`,
    this rank's block, one worker thread).

    cfg: the config, or one a rank (`cfg[rank]`): ranks may differ only in
        what `init_state`'s broadcast makes equal, the seed.
    init_hook: called with the model after `init_state` (e.g.
        `zero_density_bias`); picklable, from a module that imports no test
        code. The EMA then starts from the weights it leaves.
    num_devices: the Trainer's num_devices, the detection loss's floors
        max(num_pos, num_devices); by default the world size. One process
        held to a world of N takes N, as the JAX package's
        `test_dp_equivalence` pins the floors across its layouts.
    cam: the layout's cam size (`make_layout(cam=cam)`); None: the
        default layout.
    lift_vectorized: the Trainer's; None: where the layout splits the
        cameras.
    forward: one numpy batch dict a rank (`forward[rank]`, its dp index's
        rows with every camera) to run through the model in eval mode with
        the camera renders, after `init_hook` and before `fit`.
    val_batches: one list of numpy batch dicts a rank (its dp index's
        rows): `validate` over it (`val_list`, the global mIoUs) and this
        rank's own confusions of the same forwards (`val_conf`, seg and
        occ, summed over the batches), after the `data_root` calls.
    eval_first: run those calls on the initial weights, before `fit`,
        where the sides of a comparison hold the same bits.
    image_every: `fit`'s panel cadence (its default 500).

    Returns this rank's records: `logs` (each logged step's scalars),
    `grads` (step 0's gradients as AdamW receives them: summed over the
    ranks and clipped), `state` (parameters and buffers after `fit`), `ema`,
    `train_conf` (this rank's own train confusions), `launches` (the kernel
    launches of `fit`), `step_ms` and `peak_gb` of the timed steps,
    `validate`, the process group's `backend` (None without one), the
    layout's `dp`, `cam`, `dp_index` and `cam_index`, and with a `forward`
    its numpy outputs (`forward`: the field outputs and the detection
    preds as `det_<task>_<name>`).
    """
    r = rank()
    seed = (cfg[0] if isinstance(cfg, (list, tuple)) else cfg).train.seed
    if isinstance(cfg, (list, tuple)):
        cfg = cfg[r]                    # the loaders keep rank 0's seed
    device = torch.device(device) if device is not None else rank_device()
    layout = None if cam is None else make_layout(cam=cam)
    trainer = _RecordingTrainer(cfg, workdir=workdir, device=device,
                                layout=layout,
                                lift_vectorized=lift_vectorized)
    if num_devices is not None:
        trainer.num_devices = num_devices
    batches = list(batches_by_rank[r])
    state = trainer.init_state(batches[0], len(batches))
    model = trainer.model
    if init_hook is not None:
        init_hook(model)
        if state.ema_params is not None:
            state.ema_params = {k: v.detach().clone()
                                for k, v in model.named_parameters()}
    out = {}

    def evaluate():
        if data_root is not None:
            from ..cli import make_loader

            def loader(split):
                return make_loader(cfg, data_root, split, split, False, 1,
                                   seed, trainer.layout)
            out['validate'] = trainer.validate(loader('val'), state)
            trainer.test(loader('val'), state)
            trainer.predict(loader('test'), state)
        if val_batches is not None:
            mine = list(val_batches[r])
            out['val_list'] = trainer.validate(mine, state)
            step = build_metric_eval_step(model, cfg)
            confs = [step(trainer.to_device(b)) for b in mine]
            model.train()
            out['val_conf'] = [sum(c[i] for c in confs).cpu().numpy()
                               for i in range(2)]
    if eval_first:
        evaluate()
    fwd = None
    if forward is not None:
        b = trainer.to_device(forward[r])
        model.eval()
        with torch.no_grad():
            fo, preds = model(b['imgs'], split_mats(b), b['points'])
        model.train()
        fwd = _numpy({k: v for k, v in fo.items() if v is not None})
        fwd.update(_numpy({f'det_{t}_{k}': v for t, p in enumerate(preds)
                           for k, v in p.items()}))
    grads = {}

    def keep_grads(opt, *_):
        if not grads:
            grads.update(_numpy({n: p.grad for n, p in
                                 model.named_parameters()
                                 if p.requires_grad}))
    hook = state.optimizer.register_step_pre_hook(keep_grads)
    reset_launch_counts()
    state = trainer.fit(batches, state=state, log_every=1,
                        image_every=image_every)
    launched = launch_counts()
    hook.remove()
    lay = trainer.layout
    out.update(rank=r, world=world_size(), forward=fwd, dp=lay.dp,
               cam=lay.cam, dp_index=lay.dp_index, cam_index=lay.cam_index,
               backend=torch.distributed.get_backend() if active() else None,
               logs=trainer.records, grads=grads,
               state=_numpy(model.state_dict()),
               ema=None if state.ema_params is None
               else _numpy(state.ema_params),
               train_conf=trainer.train_conf, launches=launched)

    if n_timed:
        cuda = device.type == 'cuda'
        step = build_train_step(cfg, trainer.num_devices)
        conf = init_train_confusion(cfg, device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        times = []
        for i in range(n_timed):
            if cuda:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            state, _, conf = step(state, trainer.to_device(
                batches[i % len(batches)]), conf)
            if cuda:
                torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
        out.update(step_ms=statistics.median(times), step_times=times,
                   peak_gb=(torch.cuda.max_memory_allocated(device) / 1e9
                            if cuda else None))

    if not eval_first:
        evaluate()
    return out


@torch.no_grad()
def load_weights(state_dict: dict, model, fp32_samples: bool = False) -> None:
    """An `init_hook` (through `functools.partial(load_weights, sd)`): the
    model's parameters and buffers from `state_dict`, tensors or numpy
    arrays, all keys; with `fp32_samples`, the field's point queries and
    rays sample an fp32 copy (`FieldBackbone.sample_dtype`), as a
    comparison of gradients with another package wants."""
    model.load_state_dict({k: torch.as_tensor(v) for k, v in
                           state_dict.items()}, strict=True)
    if fp32_samples:
        model.backbone.sample_dtype = torch.float32


@torch.no_grad()
def zero_density_bias(model) -> None:
    """An `init_hook`: the density head's bias at 0. The init bias
    (sdf_bias - 10) saturates every ray at its first sample, which leaves
    the ray backward almost nothing to pass on."""
    model.backbone.density_conv.bias.zero_()


def unclipped(grads: dict, grad_norm: float, max_norm: float) -> dict:
    """Numpy gradients as they were before the global-norm clip
    (`clip_by_global_norm_` scales them by max_norm / grad_norm when
    grad_norm >= max_norm), in float64."""
    scale = grad_norm / max_norm if grad_norm >= max_norm else 1.0
    return {n: g.astype(np.float64) * scale for n, g in grads.items()}


def _fresh_entry(fn, args, path):
    with open(path, 'wb') as f:
        pickle.dump(fn(*args), f)


def in_fresh_process(fn: Callable, args: tuple, timeout_s: float):
    """fn(*args) in a fresh spawned process that joins no process group:
    one process whose CUDA context, cuDNN and cuBLAS handles and allocator
    start as a spawned rank's do. Killed, and TimeoutError, after
    `timeout_s`."""
    with tempfile.TemporaryDirectory(prefix='vampire_fresh_') as d:
        path = os.path.join(d, 'out.pkl')
        p = mp.get_context('spawn').Process(target=_fresh_entry,
                                            args=(fn, args, path))
        p.start()
        p.join(timeout_s)
        if p.is_alive():
            p.kill()
            p.join()
            raise TimeoutError(f'{fn.__name__} in a fresh process: still '
                               f'running after {timeout_s} s, killed')
        if p.exitcode != 0:
            raise RuntimeError(f'{fn.__name__} in a fresh process ended '
                               f'with exit code {p.exitcode}')
        with open(path, 'rb') as f:
            return pickle.load(f)
