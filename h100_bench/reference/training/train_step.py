"""The train step in plain torch, one process: the train-mode forward
(camera renders on), every loss term, backward, global-norm clipping and
AdamW at the step's learning rate. A frozen copy of the program's step
without its collectives and confusions."""
from __future__ import annotations

from typing import Dict

import torch

from .losses import compute_losses
from .train_state import TrainState, clip_by_global_norm_, lr_at

MATS_KEYS = ('sensor2ego', 'intrin', 'ida', 'bda')


def split_mats(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: batch[k] for k in MATS_KEYS}


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], cfg):
    """One step on `batch` (tensors on the model's device); `state` moves
    in place. Returns the logs: every loss term and the pre-clip
    `grad_norm`, as 0-dim tensors."""
    tc = cfg.train
    model = state.model
    model.train()
    fo, preds = model(batch['imgs'], split_mats(batch),
                      points=batch['points'])
    total, logs = compute_losses(fo, preds, batch, tc, cfg.head,
                                 cfg.backbone.sdf_bias,
                                 cfg.backbone.density_mode)
    params = state.trainable()
    for p in params:
        p.grad = None
    total.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    for p, g in zip(params, grads):
        p.grad = g
    logs['grad_norm'] = clip_by_global_norm_(grads, tc.gradient_clip_val)
    for group in state.optimizer.param_groups:
        group['lr'] = lr_at(tc, state.steps_per_epoch, state.step)
    state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in logs.items()}
