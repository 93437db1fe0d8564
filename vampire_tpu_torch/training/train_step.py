"""The training and eval steps; the port of
`vampire_tpu/training/train_step.py`.

One train step: the forward in train mode (BN on batch statistics outside
the frozen stem, camera renders on, the lift and ray kernels with their
backward kernels), all task losses, backward, global-norm clipping,
AdamW, the optional EMA, and the two train-IoU confusion matrices. The BN
running statistics move during the forward, as flax's mutable batch_stats.

Under a process group (`parallel/distributed.py`) each rank runs the step
on its block of the global batch: the losses are its share of the global
loss, BatchNorm takes the global statistics, and the gradients are summed
over the ranks in one flat all-reduce before the clip, so that the clip,
AdamW, the EMA and the lr schedule see the one-process gradient of the
concatenated batch on every rank. Under a dp x cam layout (the model's,
`Vampire.use_layout`) the rank's block is its rows' share of the cameras,
and the losses reduce each term over the ranks that hold it
(`losses.py`). The confusions stay per rank (the Trainer sums them over
the dp group before it reports).

The eval steps run the metrics graph (no camera renders, the lift kernel
only) in eval mode under `torch.no_grad()`, with the weights the model
holds. Not `inference_mode`: its tensors could not enter autograd later,
and `Trainer.fit` trains on after validating.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models.centerpoint_head import decode_preds
from ..parallel.distributed import all_reduce_sum_
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


def build_train_step(cfg, num_devices: int = 1, with_metrics: bool = False):
    """Returns train_step(state, batch) -> (state, logs), as the JAX
    package's default, or with with_metrics=True train_step(state, batch,
    conf) -> (state, logs, new conf); `state` is updated in place (torch
    modules and optimizers are mutable). `logs` holds every loss term and
    the pre-clip `grad_norm`, as 0-dim tensors. with_metrics=True threads
    the (conf_seg, conf_occ) accumulators through the step, updated from
    the same predictions the loss used."""
    tc = cfg.train

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   conf=None):
        model = state.model
        model.train()
        fo, preds = model(batch['imgs'], split_mats(batch),
                          points=batch['points'])
        total, logs = compute_losses(fo, preds, batch, tc, cfg.head,
                                     cfg.backbone.sdf_bias,
                                     cfg.backbone.density_mode, num_devices,
                                     model.layout)
        params = state.trainable()
        for p in params:
            p.grad = None
        total.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        all_reduce_sum_(grads)
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


def build_eval_step(model, cfg, lidar_seg: bool = True):
    """Returns eval_step(batch) -> the metrics' field outputs (pts_logits,
    occ_logits, occ_density) and, with lidar_seg=False, the boxes decoded
    on the device under 'det' (base_exp.py:634-663). Leaves the model in
    eval mode."""
    def eval_step(batch: Dict[str, torch.Tensor]):
        model.eval()
        with torch.no_grad():
            fo, preds = model(batch['imgs'], split_mats(batch),
                              points=batch['points'], lidar_seg=lidar_seg,
                              camera_renders=False)
            out = dict(pts_logits=fo['pts_logits'],
                       occ_logits=fo['occ_logits'],
                       occ_density=fo['occ_density'])
            if not lidar_seg:
                out['det'] = decode_preds(preds, cfg.head)
        return out

    return eval_step


def eval_confusions(fo: Dict[str, torch.Tensor],
                    batch: Dict[str, torch.Tensor], num_classes: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The validation confusions of one forward, on its device
    (base_exp.py:644-658): the lidarseg argmax over classes 1..16 (+1) on
    valid labelled points, (K - 1, K - 1); the occupancy argmax on
    mask_camera voxels, (K, K). Rows with sample_valid False (the padding
    of a final partial batch) count nowhere."""
    K = num_classes
    seg_pred = torch.argmax(fo['pts_logits'][..., 1:-1], dim=-1) + 1
    valid = batch['point_valid'] & (batch['point_labels'] != 0)
    occ_mask = batch['mask_camera']
    sv = batch.get('sample_valid')
    if sv is not None:
        valid = valid & sv[:, None]
        occ_mask = occ_mask & sv[:, None, None, None]
    dev = seg_pred.device
    conf_seg = confusion_update(torch.zeros((K - 1, K - 1), device=dev),
                                seg_pred, batch['point_labels'], valid)
    occ_pred = torch.argmax(fo['occ_logits'], dim=-1)
    conf_occ = confusion_update(torch.zeros((K, K), device=dev), occ_pred,
                                batch['occ_semantics'], occ_mask)
    return conf_seg, conf_occ


def build_metric_eval_step(model, cfg):
    """Returns eval_step(batch) -> (conf_seg, conf_occ), computed on the
    model's device: only the two (C, C) matrices need leave it."""
    forward = build_eval_step(model, cfg, lidar_seg=True)

    def eval_step(batch: Dict[str, torch.Tensor]):
        fo = forward(batch)
        with torch.no_grad():
            return eval_confusions(fo, batch, cfg.backbone.num_classes)

    return eval_step
