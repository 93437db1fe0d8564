"""Top-level model: field backbone + CenterPoint head; the port of
`vampire_tpu/models/vampire.py`, plus the seeded random initialisation that
mirrors the JAX package's initializers."""
from __future__ import annotations

import math
import torch
import torch.nn as nn

from ..configs import BackboneConfig, HeadConfig
from .centerpoint_head import BEVDepthHead
from .field import FieldBackbone


class Vampire(nn.Module):

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
        `lidar_seg=True` skips the detection head; `camera_renders=False` is
        the metrics graph; `plain` runs the kernels' plain versions (see
        `FieldBackbone.forward`)."""
        fo = self.backbone(imgs, mats, points=points,
                           camera_renders=camera_renders, plain=plain)
        if lidar_seg:
            return fo, None
        return fo, self.head(fo['bev_feature'])


@torch.no_grad()
def init_params_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights with the JAX package's initializers.

    Every conv kernel ~ N(0, 2 / (prod(kernel) * out_channels)) (Kaiming
    fan-out), except the SeparateHead output convs, which keep torch's default
    uniform(+-1/sqrt(fan_in)). Biases are zero except `density_conv`
    (sdf_bias - 10) and the heatmap outputs (separate_head_init_bias). BN is
    identity with unit running variance; `density_beta` is 0.1.
    """
    def draw(shape, like):
        return torch.randn(shape, generator=generator,
                           device=generator.device).to(like.device)

    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d)):
            w = m.weight
            k = math.prod(w.shape[2:])
            if isinstance(m, nn.ConvTranspose2d):
                cout = w.shape[1]
            else:
                cout = w.shape[0]
            if name.endswith('_out'):
                bound = 1.0 / math.sqrt(k * w.shape[1])
                u = torch.rand(w.shape, generator=generator,
                               device=generator.device).to(w.device)
                w.copy_((2.0 * u - 1.0) * bound)
            else:
                w.copy_(draw(w.shape, w) * math.sqrt(2.0 / (k * cout)))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    if isinstance(model, Vampire):
        bb, hc = model.backbone, model.head.cfg
        bb.density_conv.bias.fill_(bb.cfg.sdf_bias - 10.0)
        bb.density_beta.fill_(0.1)
        for t in range(len(hc.tasks)):
            getattr(model.head, f'task{t}').heatmap_out.bias.fill_(
                hc.separate_head_init_bias)
    return model
