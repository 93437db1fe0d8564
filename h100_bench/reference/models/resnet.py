"""mmdet-style ResNet (NCHW), the port of `vampire_tpu/models/resnet.py`.

Serves as the image backbone (ResNet-50, frozen stem) and as the BEV trunk
of the detection head (ResNet-18-ish, no maxpool). Module names follow the
JAX package (`stem`, `layer{i}_{j}`, `conv1`, `downsample`) so that
`weights.from_flax` maps parameters mechanically.

Precision mirrors the JAX modules: parameters are fp32, each convolution
runs in the module's compute `dtype` (weights cast per call), BatchNorm runs
in fp32, and the result is cast back to `dtype`. In train mode BatchNorm
normalises with the batch statistics and updates its running ones as flax
does (`BatchNorm2d`). One device, one process.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..precision import lower_operand


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in `compute_dtype` (fp32 parameters, cast per
    call)."""

    lower = False       # the control's arithmetic (`precision.py`)

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if self.lower:
            b = None if self.bias is None else self.bias.to(torch.float32)
            return lower_operand(self._conv_forward(
                lower_operand(x, dt), lower_operand(self.weight, dt), b),
                dt).to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), b)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose train mode follows flax `nn.BatchNorm`: the
    running variance is updated with the biased batch variance (torch uses
    the unbiased one), running = (1 - momentum) * running + momentum *
    batch, with torch's `momentum` = 1 - flax's. Eval mode is torch's."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight       # as flax
        return ((x - mean[None, :, None, None]) * mul[None, :, None, None]
                + self.bias[None, :, None, None])


class ConvBN(nn.Module):
    """Conv2d(bias=False) + BatchNorm [+ ReLU]."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 relu: bool = True, bn_eps: float = 1e-5,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False,
                           compute_dtype=dtype, device=device)
        self.bn = BatchNorm2d(cout, eps=bn_eps, device=device)
        self.relu = relu
        self.dtype = dtype

    def forward(self, x):
        x = self.bn(self.conv(x).to(torch.float32)).to(self.dtype)
        return F.relu(x) if self.relu else x


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1, downsample=False,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = ConvBN(cin, planes, 3, stride, relu=True, **kw)
        self.conv2 = ConvBN(planes, planes, 3, 1, relu=False, **kw)
        self.downsample = (ConvBN(cin, planes, 1, stride, relu=False, **kw)
                           if downsample else None)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """pytorch-style bottleneck: the stride lives in the 3x3 conv."""
    expansion = 4

    def __init__(self, cin, planes, stride=1, downsample=False,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        cout = planes * self.expansion
        self.conv1 = ConvBN(cin, planes, 1, 1, relu=True, **kw)
        self.conv2 = ConvBN(planes, planes, 3, stride, relu=True, **kw)
        self.conv3 = ConvBN(planes, cout, 1, 1, relu=False, **kw)
        self.downsample = (ConvBN(cin, cout, 1, stride, relu=False, **kw)
                           if downsample else None)

    def forward(self, x):
        out = self.conv3(self.conv2(self.conv1(x)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


_ARCH = {
    10: (BasicBlock, (1, 1, 1, 1)),   # test-size arch (not in mmdet)
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
}


class ResNet(nn.Module):
    """mmdet-compatible ResNet returning the feature pyramid (NCHW).

    `with_maxpool=False` reproduces the BEV trunk's deleted maxpool.
    `frozen_stem=True` (the image backbone; mmdet frozen_stages=0) keeps the
    stem's BN on its running statistics in train mode, detaches the stem's
    output and gives its parameters requires_grad=False, so the optimizer
    neither updates nor decays them: the JAX package's stop_gradient
    (vampire_tpu/models/resnet.py:138-145) and masked set_to_zero
    (vampire_tpu/training/train_state.py:53).
    """

    def __init__(self, depth: int = 50, in_channels: int = 3,
                 num_stages: int = 4, base_channels: int = 64,
                 strides: Sequence[int] = (1, 2, 2, 2),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 with_maxpool: bool = True, frozen_stem: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        block_cls, stage_blocks = _ARCH[depth]
        self.out_indices = tuple(out_indices)
        self.with_maxpool = with_maxpool
        self.frozen_stem = frozen_stem
        self.stem = ConvBN(in_channels, base_channels, 7, 2, relu=True,
                           dtype=dtype, device=device)
        if frozen_stem:
            self.stem.requires_grad_(False)
            self.stem.eval()
        cin = base_channels
        self.stages: List[List[str]] = []
        for i in range(num_stages):
            planes = base_channels * (2 ** i)
            names = []
            for j in range(stage_blocks[i]):
                s = strides[i] if j == 0 else 1
                need_ds = j == 0 and (s != 1 or
                                      cin != planes * block_cls.expansion)
                name = f'layer{i + 1}_{j}'
                self.add_module(name, block_cls(cin, planes, s, need_ds,
                                                dtype=dtype, device=device))
                names.append(name)
                cin = planes * block_cls.expansion
            self.stages.append(names)

    def train(self, mode: bool = True):
        super().train(mode)
        if self.frozen_stem:
            self.stem.eval()
        return self

    def forward(self, x) -> List[torch.Tensor]:
        x = self.stem(x)
        if self.frozen_stem:
            x = x.detach()
        if self.with_maxpool:
            x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for i, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return outs
