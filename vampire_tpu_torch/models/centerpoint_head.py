"""CenterPoint-style BEV detection head, its loss and its decode; the port
of `vampire_tpu/models/centerpoint_head.py`.

fp32 throughout: trunk ResNet-18-ish (no maxpool) with the raw input
prepended to the pyramid, SECONDFPN neck, a shared 3x3 ConvBN, then one
SeparateHead per task group. Outputs are channels-last maps (B, H, W, ch),
the JAX package's layout; circle NMS runs on the host afterwards.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn

from ..configs import HeadConfig
from .resnet import Conv2d, ConvBN, ResNet
from .second_fpn import SECONDFPN


class SeparateHead(nn.Module):
    """Per-task branches: (num_conv - 1) ConvBN(head_conv) + Conv(out, bias)."""

    def __init__(self, cin: int, heads, head_conv: int = 64,
                 final_kernel: int = 3, device=None):
        super().__init__()
        self.names = []
        k = final_kernel
        for name, (classes, num_conv) in heads:
            c = cin
            for i in range(num_conv - 1):
                self.add_module(f'{name}_conv{i}',
                                ConvBN(c, head_conv, k, 1, relu=True,
                                       device=device))
                c = head_conv
            self.add_module(f'{name}_out', Conv2d(c, classes, k, 1, k // 2,
                                                  bias=True, device=device))
            self.names.append((name, num_conv))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        out = {}
        for name, num_conv in self.names:
            h = x
            for i in range(num_conv - 1):
                h = getattr(self, f'{name}_conv{i}')(h)
            out[name] = getattr(self, f'{name}_out')(h)
        return out


class BEVDepthHead(nn.Module):

    def __init__(self, cfg: HeadConfig, device=None):
        super().__init__()
        c = cfg
        self.cfg = c
        self.trunk = ResNet(depth=c.bev_backbone_depth,
                            in_channels=c.bev_backbone_in_channels,
                            num_stages=c.bev_backbone_num_stages,
                            base_channels=c.bev_backbone_base_channels,
                            strides=c.bev_backbone_strides,
                            out_indices=c.bev_backbone_out_indices,
                            with_maxpool=False, device=device)
        self.neck = SECONDFPN(c.bev_neck_in_channels, c.bev_neck_out_channels,
                              c.bev_neck_upsample_strides, device=device)
        self.shared_conv = ConvBN(sum(c.bev_neck_out_channels),
                                  c.share_conv_channel, 3, 1, relu=True,
                                  device=device)
        for t, task in enumerate(c.tasks):
            heads = tuple(c.common_heads) + (
                ('heatmap', (len(task), c.num_heatmap_convs)),)
            self.add_module(f'task{t}', SeparateHead(
                c.share_conv_channel, heads,
                final_kernel=c.separate_head_final_kernel, device=device))

    def forward(self, x: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        """x: (B, H, W, C) BEV feature. Returns per-task dicts of
        channels-last maps (B, H, W, ch)."""
        x = x.to(torch.float32).permute(0, 3, 1, 2)
        fpn = self.neck([x] + self.trunk(x))
        shared = self.shared_conv(fpn)
        return [{k: v.permute(0, 2, 3, 1)
                 for k, v in getattr(self, f'task{t}')(shared).items()}
                for t in range(len(self.cfg.tasks))]


def clip_sigmoid(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """mmdet3d clip_sigmoid: sigmoid clamped to [eps, 1-eps]."""
    return torch.clamp(torch.sigmoid(x.to(torch.float32)), eps, 1.0 - eps)


def gaussian_focal_loss(pred: torch.Tensor, gt: torch.Tensor,
                        alpha: float = 2.0, gamma: float = 4.0
                        ) -> torch.Tensor:
    """mmdet GaussianFocalLoss (sum; the caller divides by avg_factor)."""
    eps = 1e-12
    pos_w = (gt == 1.0).to(torch.float32)
    neg_w = torch.pow(1.0 - gt, gamma)
    pos = -torch.log(pred + eps) * torch.pow(1.0 - pred, alpha) * pos_w
    neg = -torch.log(1.0 - pred + eps) * torch.pow(pred, alpha) * neg_w
    return torch.sum(pos + neg)


def detection_loss(preds: List[Dict[str, torch.Tensor]],
                   targets: Dict[str, torch.Tensor], cfg: HeadConfig,
                   num_devices: int = 1) -> torch.Tensor:
    """Sum over tasks of the heatmap focal loss and the weighted L1 box
    loss, in fp32.

    `targets` come from `vampire_tpu.ops.target_assign` (the jax-free
    module `synthetic_batch` uses): heatmap_{t} (B, H, W, ncls_t),
    anno_box_{t} (B, max_objs, 10), ind_{t} (B, max_objs) int (y*W + x),
    mask_{t} (B, max_objs). As in the JAX package, the focal loss divides by
    max(num_pos, num_devices) and the box loss by max(num_boxes,
    1e-4 * num_devices): the reference's reduce_mean floors written as one
    global loss.
    """
    total = torch.zeros((), dtype=torch.float32,
                        device=preds[0]['heatmap'].device)
    code_w = torch.tensor(cfg.code_weights, dtype=torch.float32,
                          device=total.device)
    for t, pd in enumerate(preds):
        hm_pred = clip_sigmoid(pd['heatmap'])
        hm_gt = targets[f'heatmap_{t}'].to(torch.float32)
        num_pos = torch.sum((hm_gt == 1.0).to(torch.float32))
        cls_avg = torch.clamp(num_pos, min=float(num_devices))
        total = total + gaussian_focal_loss(hm_pred, hm_gt) / cls_avg

        anno = torch.cat([pd['reg'], pd['height'], pd['dim'], pd['rot'],
                          pd['vel']], dim=-1)
        B, H, W, C = anno.shape
        ind = targets[f'ind_{t}'].to(torch.int64)
        pred_box = torch.gather(anno.reshape(B, H * W, C), 1,
                                ind[..., None].expand(-1, -1, C))
        tgt_box = targets[f'anno_box_{t}'].to(torch.float32)
        mask = targets[f'mask_{t}'].to(torch.float32)
        w = (mask[..., None] * torch.isfinite(tgt_box).to(torch.float32)
             * code_w)
        tgt_box = torch.nan_to_num(tgt_box)
        num = torch.clamp(torch.sum(mask), min=1e-4 * float(num_devices))
        l1 = torch.sum(torch.abs(pred_box - tgt_box) * w) / num
        total = total + cfg.loss_bbox_weight * l1
    return total


def decode_preds(preds: List[Dict[str, torch.Tensor]], cfg: HeadConfig
                 ) -> List[Dict[str, torch.Tensor]]:
    """Top-k decode per task: per-task dicts of fixed-shape (B, max_num)
    tensors bboxes (., 9), scores, labels, valid. Circle NMS follows on the
    host (`vampire_tpu.evaluation.det_evaluator.apply_circle_nms`)."""
    out = []
    K = cfg.max_num
    pcr = torch.tensor(cfg.post_center_range, dtype=torch.float32)
    for pd in preds:
        heat = torch.sigmoid(pd['heatmap'].to(torch.float32))
        B, H, W, ncls = heat.shape
        # one global top-K over all (class, cell) pairs selects the same set
        # as CenterPoint's per-class then global top-K
        hw = heat.permute(0, 3, 1, 2).reshape(B, ncls * H * W)
        scores, sel = torch.topk(hw, K, dim=1)
        labels = (sel // (H * W)).to(torch.int32)
        inds = sel % (H * W)
        ys = (inds // W).to(torch.float32)
        xs = (inds % W).to(torch.float32)

        def gather(name):
            m = pd[name].to(torch.float32)
            m = m.reshape(B, H * W, m.shape[-1])
            return torch.gather(m, 1, inds[..., None].expand(-1, -1,
                                                             m.shape[-1]))
        reg = gather('reg')
        xs = xs + reg[..., 0]
        ys = ys + reg[..., 1]
        rot = gather('rot')
        rot_angle = torch.atan2(rot[..., 0], rot[..., 1])
        hei = gather('height')[..., 0]
        dim = torch.exp(gather('dim')) if cfg.norm_bbox else gather('dim')
        vel = gather('vel')
        xs = xs * cfg.out_size_factor * cfg.voxel_size[0] + cfg.pc_range[0]
        ys = ys * cfg.out_size_factor * cfg.voxel_size[1] + cfg.pc_range[1]
        boxes = torch.cat([xs[..., None], ys[..., None], hei[..., None], dim,
                           rot_angle[..., None], vel], dim=-1)   # (B, K, 9)
        valid = scores > cfg.score_threshold
        p = pcr.to(boxes.device)
        centers_ok = (torch.all(boxes[..., :3] >= p[:3], dim=-1)
                      & torch.all(boxes[..., :3] <= p[3:], dim=-1))
        out.append(dict(bboxes=boxes, scores=scores, labels=labels,
                        valid=valid & centers_ok))
    return out
