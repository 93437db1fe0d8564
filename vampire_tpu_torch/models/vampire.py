"""Top-level model: field backbone + CenterPoint head; the port of
`vampire_tpu/models/vampire.py`, plus the seeded random initialisation that
mirrors the JAX package's initializers."""
from __future__ import annotations

import math
import torch
import torch.nn as nn

from ..configs import BackboneConfig, HeadConfig
from ..parallel.mesh import Layout
from ..utils import profiling
from .centerpoint_head import BEVDepthHead
from .field import FieldBackbone
from .resnet import BatchNorm2d


class Vampire(nn.Module):
    """lift_vectorized: the JAX module's field of that name: the dense lift,
    which a layout that splits the cameras needs (`use_layout`)."""

    def __init__(self, backbone_cfg: BackboneConfig, head_cfg: HeadConfig,
                 dtype=torch.float32, device=None,
                 lift_vectorized: bool = False):
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
                                      device=device,
                                      lift_vectorized=lift_vectorized)
        self.head = BEVDepthHead(head_cfg, device=device)

    @property
    def layout(self) -> Layout:
        return self.backbone.layout

    def use_layout(self, layout: Layout) -> 'Vampire':
        """Run under a dp x cam layout (`parallel/mesh.py`): the field sums
        its lift over the cam group and renders this rank's cameras, and
        the detection head's BatchNorm, after the lift, takes its
        statistics over the dp group (the image encoder's, over the world).
        Returns the model."""
        self.backbone.layout = layout
        for m in self.head.modules():
            if isinstance(m, BatchNorm2d):
                m.group = layout.dp_group
        return self

    def forward(self, imgs, mats, points=None, lidar_seg: bool = False,
                camera_renders: bool = True, plain: bool = False,
                diagnostics=None):
        """Returns (field outputs dict, per-task head preds or None).
        `lidar_seg=True` skips the detection head in eval mode only, as the
        JAX module skips it for `lidar_seg and not train`;
        `camera_renders=False` is the metrics graph; `plain` runs the
        kernels' plain versions; `diagnostics`, a dict, receives the lift's
        diagnostic (see `FieldBackbone.forward`)."""
        fo = self.backbone(imgs, mats, points=points,
                           camera_renders=camera_renders, plain=plain,
                           diagnostics=diagnostics)
        if lidar_seg and not self.training:
            return fo, None
        with profiling.span('model.head'):
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
