"""SECOND-style FPN (mmdet3d `SECONDFPN`), NCHW; the port of
`vampire_tpu/models/second_fpn.py`.

Per input scale: ConvTranspose(k=stride, s=stride, bias=False) when the
upsample stride >= 1, else Conv(k=1/stride, s=1/stride, bias=False); each
followed by BN(eps=1e-3, flax momentum 0.99) + ReLU; outputs are
concatenated on channels.

`weights.from_flax` flips the transposed kernels spatially: flax
`ConvTranspose` (transpose_kernel=False) applies the kernel as stored, torch
`conv_transpose2d` applies it flipped.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..precision import lower_operand
from .resnet import BatchNorm2d, Conv2d


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d computing in `compute_dtype` (fp32 parameters)."""

    lower = False       # the control's arithmetic (`precision.py`)

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if self.lower:
            return lower_operand(F.conv_transpose2d(
                lower_operand(x, dt), lower_operand(self.weight, dt), None,
                self.stride, self.padding), dt).to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), None,
                                  self.stride, self.padding)


class SECONDFPN(nn.Module):

    def __init__(self, in_channels: Sequence[int],
                 out_channels: Sequence[int],
                 upsample_strides: Sequence[float], dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.n = len(in_channels)
        for i, (cin, cout, stride) in enumerate(
                zip(in_channels, out_channels, upsample_strides)):
            if stride >= 1:
                s = int(stride)
                conv = ConvTranspose2d(cin, cout, s, s, bias=False,
                                       compute_dtype=dtype, device=device)
            else:
                s = int(round(1.0 / stride))
                conv = Conv2d(cin, cout, s, s, bias=False,
                              compute_dtype=dtype, device=device)
            self.add_module(f'deblock{i}_conv', conv)
            self.add_module(f'deblock{i}_bn',
                            BatchNorm2d(cout, eps=1e-3, momentum=0.01,
                                        device=device))

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(feats) != self.n:
            raise ValueError(f'SECONDFPN takes {self.n} scales, '
                             f'got {len(feats)}')
        outs = []
        for i, x in enumerate(feats):
            x = getattr(self, f'deblock{i}_conv')(x)
            x = getattr(self, f'deblock{i}_bn')(x.to(torch.float32))
            outs.append(F.relu(x).to(self.dtype))
        return torch.cat(outs, dim=1)
