"""The training step; the port of `vampire_tpu/training/train_step.py`.

One step: the forward in train mode (BN on batch statistics outside the
frozen stem, camera renders on, the lift, corner-table and ray kernels with
their backward kernels), all task losses, backward, global-norm clipping,
AdamW, the optional EMA, and the two train-IoU confusion matrices. The BN
running statistics move during the forward, as flax's mutable batch_stats.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .losses import compute_losses
from .metrics import confusion_update
from .train_state import TrainState, clip_by_global_norm_, ema_update, lr_at

MATS_KEYS = ('sensor2ego', 'intrin', 'ida', 'bda')


def split_mats(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: batch[k] for k in MATS_KEYS}


def init_train_confusion(cfg, device=None) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Zeroed train-IoU confusion accumulators (seg, occ) on `device`."""
    K = cfg.backbone.num_classes
    return (torch.zeros((K - 1, K - 1), device=device),
            torch.zeros((K, K), device=device))


def build_train_step(cfg, num_devices: int = 1, with_metrics: bool = True):
    """Returns train_step(state, batch, conf=None) -> (state, logs, new
    conf), or (state, logs) without metrics; `state` is updated in place
    (torch modules and optimizers are mutable). `logs` holds every loss
    term and the pre-clip `grad_norm`, as 0-dim tensors. with_metrics=True threads the
    (conf_seg, conf_occ) accumulators through the step, updated from the
    same predictions the loss used."""
    tc = cfg.train

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   conf=None):
        model = state.model
        model.train()
        fo, preds = model(batch['imgs'], split_mats(batch),
                          points=batch['points'])
        total, logs = compute_losses(fo, preds, batch, tc, cfg.head,
                                     cfg.backbone.sdf_bias,
                                     cfg.backbone.density_mode, num_devices)
        params = state.trainable()
        for p in params:
            p.grad = None
        total.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        for p, g in zip(params, grads):
            p.grad = g
        logs['grad_norm'] = clip_by_global_norm_(grads,
                                                 tc.gradient_clip_val)
        for group in state.optimizer.param_groups:
            group['lr'] = lr_at(tc, state.steps_per_epoch, state.step)
        state.optimizer.step()
        if state.ema_params is not None:
            ema_update(state.ema_params, model, state.step, tc.ema_decay)
        state.step += 1
        logs = {k: v.detach() for k, v in logs.items()}
        if not with_metrics:
            return state, logs
        with torch.no_grad():
            seg_pred = torch.argmax(fo['pts_logits'][..., 1:-1], dim=-1) + 1
            valid = batch['point_valid'] & (batch['point_labels'] != 0)
            conf_seg = confusion_update(conf[0], seg_pred,
                                        batch['point_labels'], valid)
            occ_pred = torch.argmax(fo['occ_logits'], dim=-1)
            conf_occ = confusion_update(conf[1], occ_pred,
                                        batch['occ_semantics'],
                                        batch['mask_camera'])
        return state, logs, (conf_seg, conf_occ)

    return train_step
