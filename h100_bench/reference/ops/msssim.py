"""Multi-scale SSIM (torchmetrics' defaults); the port of
`vampire_tpu/ops/msssim.py`.

The rgb reconstruction loss's structural term (base_exp.py:286,547:
`MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0)`): a gaussian
window of 11 at sigma 1.5, applied as a depthwise separable blur with VALID
padding, the k1 / k2 constants, betas (0.0448, 0.2856, 0.3001, 0.2363,
0.1333), a 2x average pool between scales that drops a trailing odd row or
column, and relu normalisation. Plain PyTorch in fp32: no TPU kernel
stands behind it. No published experiment sets the rgb loss weight, so the
term never reaches the flagship recipe.

Every scale needs at least `kernel_size` pixels a side after its pools,
i.e. 11 * 2^4 = 176 at the defaults. The JAX function returns NaN below
that (the mean of an empty window); this one raises.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

_BETAS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur_valid(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable gaussian blur with VALID padding of (B, C, H, W) x, one
    depthwise convolution an axis."""
    c, n = x.shape[1], k.numel()
    x = F.conv2d(x, k.reshape(1, 1, n, 1).expand(c, 1, n, 1), groups=c)
    return F.conv2d(x, k.reshape(1, 1, 1, n).expand(c, 1, 1, n), groups=c)


def _ssim_mcs(x, y, k, data_range, k1, k2):
    """Per image: the mean SSIM and the mean contrast-structure term."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x = _blur_valid(x, k)
    mu_y = _blur_valid(y, k)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig_x = _blur_valid(x * x, k) - mu_xx
    sig_y = _blur_valid(y * y, k) - mu_yy
    sig_xy = _blur_valid(x * y, k) - mu_xy
    cs = (2 * sig_xy + c2) / (sig_x + sig_y + c2)
    ssim = ((2 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs
    return torch.mean(ssim, dim=(1, 2, 3)), torch.mean(cs, dim=(1, 2, 3))


def ms_ssim_per_image(pred: torch.Tensor, target: torch.Tensor,
                      data_range: float = 1.0, kernel_size: int = 11,
                      sigma: float = 1.5, betas: Sequence[float] = _BETAS,
                      k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """MS-SSIM of each image of (B, H, W, C) pred and target (cast to
    fp32): (B,) fp32. `ms_ssim` is its mean."""
    need = kernel_size * 2 ** (len(betas) - 1)
    if min(pred.shape[1:3]) < need:
        raise ValueError(f'ms_ssim: {tuple(pred.shape[1:3])} images; '
                         f'{len(betas)} scales of a {kernel_size}-pixel '
                         f'window need at least {need} pixels a side')
    if target.shape != pred.shape:
        raise ValueError(f'ms_ssim: pred {tuple(pred.shape)} and target '
                         f'{tuple(target.shape)} differ')
    k = torch.from_numpy(_gaussian_kernel(kernel_size, sigma)).to(
        pred.device)
    x = pred.to(torch.float32).permute(0, 3, 1, 2)
    y = target.to(torch.float32).permute(0, 3, 1, 2)
    mcs = []
    for i in range(len(betas)):
        ssim, cs = _ssim_mcs(x, y, k, data_range, k1, k2)
        mcs.append(cs)
        if i < len(betas) - 1:
            x = F.avg_pool2d(x, 2)
            y = F.avg_pool2d(y, 2)
    b = torch.tensor(betas, dtype=torch.float32, device=pred.device)
    mcs = torch.stack([F.relu(m) for m in mcs[:-1]])          # (L-1, B)
    prod = torch.prod(mcs ** b[:-1, None], dim=0)
    return prod * F.relu(ssim) ** b[-1]


def ms_ssim(pred: torch.Tensor, target: torch.Tensor,
            data_range: float = 1.0, kernel_size: int = 11,
            sigma: float = 1.5, betas: Sequence[float] = _BETAS,
            k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """MS-SSIM over a batch of (B, H, W, C) images: the fp32 0-dim mean of
    `ms_ssim_per_image`."""
    return torch.mean(ms_ssim_per_image(pred, target, data_range,
                                        kernel_size, sigma, betas, k1, k2))
