"""CenterPoint-style BEV detection head and its decode; the port of
`vampire_tpu/models/centerpoint_head.py` (the loss waits for training).

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
