"""Volume rendering: VolSDF-style densities and alpha compositing (fp32).

Port of the BEV half of `vampire_tpu/core/rendering.py`. The camera-ray
samplers wait for the camera-ray slice (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import Tuple

import torch


def laplace_density(sdf: torch.Tensor, beta: torch.Tensor,
                    bias: float = 0.0, beta_min: float = 1e-4) -> torch.Tensor:
    """alpha * Laplace(loc=0, scale=beta).cdf(-(sdf - bias)):
    beta_eff = |beta| + beta_min, alpha = 1/beta_eff,
    density = alpha * (0.5 + 0.5*sign(s)*expm1(-|s|/beta_eff)), s = sdf - bias.
    """
    s = sdf.to(torch.float32) - bias
    beta_eff = torch.abs(beta).to(torch.float32) + beta_min
    alpha = 1.0 / beta_eff
    return alpha * (0.5 + 0.5 * torch.sign(s)
                    * torch.expm1(-torch.abs(s) / beta_eff))


def naive_density(x: torch.Tensor) -> torch.Tensor:
    """density_mode='naive': plain sigmoid."""
    return torch.sigmoid(x.to(torch.float32))


def transmittance_weights(density: torch.Tensor, delta: torch.Tensor,
                          axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """w_i = (1 - exp(-sigma_i*delta_i)) * exp(-sum_{j<i} sigma_j*delta_j)
    along `axis`. Returns (weights, acc = sum_i w_i)."""
    sd = density.to(torch.float32) * delta.to(torch.float32)
    alpha = 1.0 - torch.exp(-sd)
    excl = torch.cumsum(sd, dim=axis) - sd
    w = alpha * torch.exp(-excl)
    return w, torch.sum(w, dim=axis)


def composite(weights: torch.Tensor, values: torch.Tensor,
              axis: int) -> torch.Tensor:
    """sum_i w_i * v_i along the sample axis."""
    return torch.sum(weights.to(torch.float32) * values.to(torch.float32),
                     dim=axis)


def render_bev_columns(density: torch.Tensor, seg_logits: torch.Tensor,
                       rgb: torch.Tensor, bev_mids: torch.Tensor,
                       delta_z: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite z-flipped det-grid columns (index 0 = top).

    Args:
      density: (B, S, Y, X) densities; seg_logits: (B, S, Y, X, K);
      rgb: (B, S, Y, X, 3); bev_mids: (S,) z-flipped cell-center heights;
      delta_z: constant z step.

    Returns:
      (bev_rgb (B, Y, X, 3), bev_seg (B, Y, X, K), bev_height (B, Y, X)).
    """
    delta = torch.full_like(density, delta_z, dtype=torch.float32)
    w, _ = transmittance_weights(density, delta, axis=1)
    bev_rgb = composite(w[..., None], rgb, axis=1)
    bev_seg = composite(w[..., None], seg_logits, axis=1)
    mids = bev_mids.to(torch.float32)[None, :, None, None]
    bev_height = composite(w, mids * torch.ones_like(w), axis=1)
    return bev_rgb, bev_seg, bev_height
