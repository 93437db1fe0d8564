"""3D hourglass U-Net over the ego voxel grid (NCDHW); the port of
`vampire_tpu/models/unet3d.py`.

Two stacked hourglasses with skip connections, LeakyReLU(0.01), and
align_corners=True trilinear upsampling. Every conv is a plain 3x3x3
`Conv3d` with padding 1 and stride 1 or 2: the JAX package's banded
z-channels layout is a TPU lane trick over the same (3, 3, 3, Cin, Cout)
parameters and does not carry over.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.sampling import resize_linear


class Conv3d(nn.Conv3d):
    """3x3x3 conv, padding 1, computing in `compute_dtype` (fp32 params)."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 bias: bool = False, compute_dtype=torch.float32,
                 device=None):
        super().__init__(cin, cout, 3, stride, 1, bias=bias, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), b)


def _leaky(x):
    return F.leaky_relu(x, negative_slope=0.01)


def _resize(x, like):
    return resize_linear(x, like.shape[2:], (2, 3, 4))


class Hourglass3D(nn.Module):
    """Returns (out, pre, post)."""

    def __init__(self, cin: int, mid_channels: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        m2 = 2 * mid_channels
        kw = dict(compute_dtype=dtype, device=device)
        self.conv1 = Conv3d(cin, m2, 2, **kw)
        self.conv2 = Conv3d(m2, m2, 1, **kw)
        self.conv3 = Conv3d(m2, m2, 2, **kw)
        self.conv4 = Conv3d(m2, m2, 1, **kw)
        self.conv5 = Conv3d(m2, m2, 1, **kw)
        self.conv6 = Conv3d(m2, mid_channels, 1, **kw)

    def forward(self, x, presqu: Optional[torch.Tensor],
                postsqu: Optional[torch.Tensor]):
        out = _leaky(self.conv1(x))
        pre = self.conv2(out)
        pre = _leaky(pre + postsqu) if postsqu is not None else _leaky(pre)
        out = _leaky(self.conv3(pre))
        out = _leaky(self.conv4(out))
        out = self.conv5(_resize(out, pre))
        post = (_leaky(out + presqu) if presqu is not None
                else _leaky(out + pre))
        out = self.conv6(_resize(post, x))
        return out, pre, post


class Unet3D(nn.Module):
    """Init conv + two hourglasses with residuals: (B, Cin, Z, Y, X) ->
    (B, mid, Z, Y, X) in `dtype`."""

    def __init__(self, in_channels: int, mid_channels: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.init_dres = Conv3d(in_channels, mid_channels, 1,
                                compute_dtype=dtype, device=device)
        self.hg1 = Hourglass3D(mid_channels, mid_channels, dtype, device)
        self.hg2 = Hourglass3D(mid_channels, mid_channels, dtype, device)

    def forward(self, x):
        dres = self.init_dres(x)
        out1, pre1, post1 = self.hg1(dres, None, None)
        out1 = out1 + dres
        out2, _, _ = self.hg2(out1, pre1, post1)
        return out2 + dres
