"""Top-level model: field backbone + CenterPoint head; the port of
`vampire_tpu/models/vampire.py`."""
from __future__ import annotations

import torch
import torch.nn as nn

from ..configs import BackboneConfig, HeadConfig
from .centerpoint_head import BEVDepthHead
from .field import FieldBackbone


class Vampire(nn.Module):
    """The field backbone and the detection head, on one device."""

    def __init__(self, backbone_cfg: BackboneConfig, head_cfg: HeadConfig,
                 dtype=torch.float32, device=None):
        super().__init__()
        # the backbone's BEV feature (det grid, halved iff oY == 256) must
        # land on the head's expected map size
        _, oY, oX = backbone_cfg.grid_zyx('det')
        bev_hw = (oY // 2, oX // 2) if oY == 256 else (oY, oX)
        if bev_hw != tuple(head_cfg.feature_map_size):
            raise ValueError(
                f'backbone BEV feature {bev_hw} != head feature_map_size '
                f'{head_cfg.feature_map_size} (x/y_bound_det vs '
                f'grid_size/out_size_factor)')
        self.backbone = FieldBackbone(backbone_cfg, dtype=dtype,
                                      device=device)
        self.head = BEVDepthHead(head_cfg, device=device)

    def forward(self, imgs, mats, points=None, lidar_seg: bool = False,
                camera_renders: bool = True, plain: bool = False):
        """Returns (field outputs dict, per-task head preds or None).
        `lidar_seg=True` skips the detection head in eval mode only, as the
        JAX module skips it for `lidar_seg and not train`;
        `camera_renders=False` is the metrics graph; `plain` runs the
        kernels' plain versions."""
        fo = self.backbone(imgs, mats, points=points,
                           camera_renders=camera_renders, plain=plain)
        if lidar_seg and not self.training:
            return fo, None
        return fo, self.head(fo['bev_feature'])
