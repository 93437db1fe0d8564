"""All task losses of the training step (fp32); the port of
`vampire_tpu/training/losses.py`.

Batch layout (channels-last, as the JAX package's data pipeline and
`synthetic_batch` produce it), as torch tensors on the model's device:
  imgs (B, N, H, W, 3); depth_labels, seg_labels (B, N, H, W), or with a
  frame axis after B in a multi-sweep batch (frame 0 the key frame);
  bev_seg, bev_height, bev_mask (B, Y, X); points (B, P, 3),
  point_labels, point_valid (B, P); occ_semantics, occ_density_labels,
  mask_camera (B, 200, 200, 16); and the detection targets of
  `ops.target_assign`.

Under a process group each rank holds its block of the global batch and
returns its share of the global loss (the JAX step's function, written
over the global batch): masked means divide the local sum by the global
count, the segmentation terms run over the gathered rows (`ops/lovasz.py`)
and the detection loss divides by the global normalisers. The shares sum
over the ranks to the one-process loss on the concatenated batch; the
`logs` hold the global values, the same on every rank.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs import HeadConfig
from ..models.centerpoint_head import detection_loss
from ..ops.lovasz import ce_lovasz, ce_lovasz_compact
from ..ops.msssim import ms_ssim_per_image
from ..parallel.distributed import active, all_reduce_sum

# ImageNet statistics of the normalized images, RGB, in [0, 1] units
_RGB_MEAN = (0.485, 0.456, 0.406)
_RGB_STD = (0.229, 0.224, 0.225)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    d = torch.abs(pred.to(torch.float32) - target.to(torch.float32))
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The mean of x over the mask; under a process group, this rank's
    share of the global batch's: the local sum over the global count."""
    mf = mask.to(torch.float32)
    return torch.sum(x * mf) / torch.clamp(all_reduce_sum(torch.sum(mf)),
                                           min=1.0)


def denormalize_images(imgs: torch.Tensor) -> torch.Tensor:
    """Normalized (B, N, H, W, 3) -> [0, 1] rgb (base_exp.py:608-616): one
    fp32 multiply, then one add, as the JAX package rounds them."""
    std = torch.tensor(_RGB_STD, dtype=torch.float32, device=imgs.device)
    mean = torch.tensor(_RGB_MEAN, dtype=torch.float32, device=imgs.device)
    return imgs.to(torch.float32) * std + mean


def compute_losses(field_out: Dict[str, torch.Tensor], det_preds,
                   batch: Dict[str, torch.Tensor], train_cfg,
                   head_cfg: HeadConfig, sdf_bias: float,
                   density_mode: str = 'sdf', num_devices: int = 1
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total weighted loss (under a process group, this rank's share) and
    the per-term scalars (global), every term and log key of the JAX
    `compute_losses`.

    The rgb term (loss_weights[2] != 0; no preset sets it) is the mean
    smooth L1 plus 1 - MS-SSIM of the key frame's renders against its
    denormalised images, whose sides need at least 176 pixels
    (`ops.msssim`).
    """
    logs: Dict[str, torch.Tensor] = {}
    tw = train_cfg.task_weights
    lw = train_cfg.loss_weights
    # a multi-sweep batch (imgs (B, F, N, H, W, 3)): the model renders the
    # key frame only, so the camera-view terms take frame 0's labels
    if batch['imgs'].dim() == 6:
        batch = dict(batch, imgs=batch['imgs'][:, 0],
                     depth_labels=batch['depth_labels'][:, 0],
                     seg_labels=batch['seg_labels'][:, 0])

    det_loss = detection_loss(det_preds, batch, head_cfg, num_devices)
    logs['detection_loss'] = det_loss

    fg_mask = batch['depth_labels'] > 0.0
    cam_depth_loss = masked_mean(
        smooth_l1(field_out['depth_preds'], batch['depth_labels']), fg_mask)
    logs['camera_depth_loss'] = cam_depth_loss

    seg_logits = field_out['seg_logits_preds']
    K = seg_logits.shape[-1]
    cam_seg_loss = ce_lovasz_compact(
        seg_logits.reshape(-1, K), batch['seg_labels'].reshape(-1),
        fg_mask.reshape(-1))
    logs['camera_seg_loss'] = cam_seg_loss
    if lw[2] != 0.0:
        rgb_labels = denormalize_images(batch['imgs'])
        rgb_preds = field_out['rgb_preds'].to(torch.float32)
        B, N, H, W, _ = rgb_preds.shape
        ms = ms_ssim_per_image(rgb_preds.reshape(B * N, H, W, 3),
                               rgb_labels.reshape(B * N, H, W, 3))
        # plain means: masked means over all-true masks, the global
        # batch's under a process group
        sl1 = smooth_l1(rgb_preds, rgb_labels)
        rgb_loss = (masked_mean(sl1, torch.ones_like(sl1, dtype=torch.bool))
                    + masked_mean(1.0 - ms,
                                  torch.ones_like(ms, dtype=torch.bool)))
    else:
        rgb_loss = torch.zeros((), device=seg_logits.device)
    logs['rgb_loss'] = rgb_loss

    bev_mask = batch['bev_mask']
    bev_height_loss = masked_mean(
        smooth_l1(batch['bev_height'], field_out['bev_height_preds']),
        bev_mask)
    logs['bev_height_loss'] = bev_height_loss
    bev_seg_loss = ce_lovasz_compact(
        field_out['bev_seg_logits_preds'].reshape(-1, K),
        batch['bev_seg'].reshape(-1), bev_mask.reshape(-1))
    logs['bev_seg_loss'] = bev_seg_loss

    pts_seg_loss = ce_lovasz(field_out['pts_logits'].reshape(-1, K),
                             batch['point_labels'].reshape(-1),
                             batch['point_valid'].reshape(-1))
    logs['pts_seg_loss'] = pts_seg_loss

    if density_mode == 'sdf' and lw[3] != 0.0:
        sdf_loss = masked_mean(
            (field_out['pts_sdf'].to(torch.float32) - sdf_bias) ** 2,
            batch['point_valid'])
    else:
        sdf_loss = torch.zeros((), device=seg_logits.device)
    logs['sdf_loss'] = sdf_loss

    mask_cam = batch['mask_camera'].reshape(-1)
    occ_seg_loss = ce_lovasz(field_out['occ_logits'].reshape(-1, K),
                             batch['occ_semantics'].reshape(-1), mask_cam)
    logs['visible_occ_seg_loss'] = occ_seg_loss

    occ_density = field_out['occ_density'].reshape(-1).to(torch.float32)
    occ_labels = batch['occ_density_labels'].reshape(-1).to(torch.float32)
    sq = (occ_labels - occ_density) ** 2
    vis_density_loss = masked_mean(sq, mask_cam)
    invis_density_loss = masked_mean(sq, ~mask_cam)
    logs['visible_occ_density_loss'] = vis_density_loss
    logs['invisible_occ_density_loss'] = invis_density_loss
    density_loss = vis_density_loss + invis_density_loss

    depth_loss = cam_depth_loss + bev_height_loss
    seg_loss = cam_seg_loss + bev_seg_loss
    logs['depth_loss'] = depth_loss
    logs['seg_loss'] = seg_loss

    total = (tw[0] * occ_seg_loss + tw[1] * pts_seg_loss + tw[2] * det_loss
             + lw[0] * depth_loss + lw[1] * seg_loss + lw[2] * rgb_loss
             + lw[3] * sdf_loss + lw[4] * density_loss)
    logs['total_loss'] = total
    if active():    # the shares summed: the global terms, on every rank
        names = list(logs)
        glob = all_reduce_sum(torch.stack([logs[k].detach() for k in names]))
        logs = dict(zip(names, glob.unbind()))
    return total, logs
