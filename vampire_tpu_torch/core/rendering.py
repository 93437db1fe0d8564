"""Volume rendering: VolSDF-style densities and alpha compositing (fp32).

Port of `vampire_tpu/core/rendering.py`: the densities, the BEV column
render, the unfused camera-ray oracle `render_camera_rays`,
`sample_and_composite_rays_reference`, the dense ray sampler and the plain
version of the CUDA kernel in `ops/rays.py`, and its gradient written out,
`sample_and_composite_rays_backward_reference`. The port trains on the
dense sampler too: the JAX package's train-mode compact sampler computes
the same values (it exists because TPU scatters are slow) and, like the
opt-in early-term sampler, is not ported (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import sampling as S


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


def density(x: torch.Tensor, mode: str, beta: torch.Tensor,
            bias: float) -> torch.Tensor:
    """The field's density of `density_mode`: 'sdf' is `laplace_density`
    with the learnable `beta`, 'naive' the sigmoid."""
    if mode == 'naive':
        return naive_density(x)
    return laplace_density(x, beta, bias)


def density_and_grads(x: torch.Tensor, mode: str, beta: torch.Tensor,
                      bias: float, beta_min: float = 1e-4
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`density(x, mode, beta, bias)` and its partial derivatives d/dx and
    d/dbeta, written out (the plain ray backward's; `csrc/rays.cu` computes
    the same). At s = x - bias = 0 the x-derivative is 0, as autodiff of
    sign(s) * expm1(-|s|/beta_eff) gives; 'naive' has no beta."""
    x = x.to(torch.float32)
    if mode == 'naive':
        d = torch.sigmoid(x)
        return d, d * (1.0 - d), torch.zeros_like(d)
    s = x - bias
    beta = beta.to(torch.float32)
    beta_eff = torch.abs(beta) + beta_min
    alpha = 1.0 / beta_eff
    sg = torch.sign(s)
    a = torch.abs(s) / beta_eff
    d = alpha * (0.5 + 0.5 * sg * torch.expm1(-a))
    e = torch.exp(-a)
    dx = -0.5 * alpha * sg * sg * e / beta_eff
    dbeta = (-d / beta_eff + 0.5 * alpha * sg * e * a / beta_eff) \
        * torch.sign(beta)
    return d, dx, dbeta


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


def render_camera_rays(sdf: torch.Tensor, seg_logits: torch.Tensor,
                       rgb: torch.Tensor, geom_xyz: torch.Tensor,
                       camera_mids: torch.Tensor, density_fn,
                       bg_depth: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite per-camera rays from already-sampled fields (the unfused
    oracle of the ray samplers).

    Args:
      sdf: (B, N, S, h, w) sampled (masked) SDF; seg_logits: (..., K);
      rgb: (..., 3); geom_xyz: (B, N, S+1, h, w, 3) ego points along the
      rays (for the deltas); camera_mids: (S,); density_fn: SDF -> density;
      bg_depth: depth given to the untouched remainder (1 - sum w).

    Returns:
      (rgb (B, N, h, w, 3), seg (B, N, h, w, K), depth (B, N, h, w)) fp32.
    """
    dens = density_fn(sdf)
    delta = torch.linalg.norm(geom_xyz[:, :, 1:].to(torch.float32)
                              - geom_xyz[:, :, :-1].to(torch.float32), dim=-1)
    w, acc = transmittance_weights(dens, delta, axis=2)
    rgb_p = composite(w[..., None], rgb, axis=2)
    seg_p = composite(w[..., None], seg_logits, axis=2)
    mids = camera_mids.to(torch.float32)[None, None, :, None, None]
    depth_p = composite(w, mids * torch.ones_like(w), axis=2)
    return rgb_p, seg_p, depth_p + (1.0 - acc) * bg_depth


# the plain sampler gathers (rays, S, 8, Ct) fp32 values per chunk; keep a
# chunk under ~1 GB
_CHUNK_BYTES = 1 << 30


def sample_and_composite_rays_reference(
        table: torch.Tensor, vol_shape: Tuple[int, int, int],
        coords: torch.Tensor, valid: torch.Tensor, deltas: torch.Tensor,
        camera_mids: torch.Tensor, bg_depth: float, density_mode: str,
        beta: torch.Tensor, sdf_bias: float,
        chunk_rays: Optional[int] = None) -> torch.Tensor:
    """Sample the corner table along whole rays and alpha-composite them.

    The same values as `grid_sample_3d_fused(vol, coords) * valid` (zeros
    padding, align_corners=True) followed by `render_camera_rays`, chunked
    over rays so that the gathered samples of a chunk stay under ~1 GB.

    Args:
      table: the corner table of the fused (C, D, H, W) volume with
        channels [sdf | seg (K) | rgb (3)], bf16 or fp32, in either layout:
        `corner_table_reference` or `build_neighborhood_table`.
      vol_shape: (D, H, W) of that volume.
      coords: (R, S, 3) normalized sample coords; valid: (R, S) 0/1;
      deltas: (R, S) path lengths; camera_mids: (S,).
      bg_depth, density_mode, beta, sdf_bias: see `density`.

    Returns:
      (R, 3 + K + 1) fp32: [rgb | seg | depth] per ray.
    """
    D, H, W = vol_shape
    flat = table.reshape((D + 1) * (H + 1) * (W + 1), -1)
    Ct = flat.shape[1] // 8
    K = Ct - 4
    R_, S_n = coords.shape[:2]
    if chunk_rays is None:
        chunk_rays = max(1, _CHUNK_BYTES // (S_n * 8 * Ct * 4))
    mids = camera_mids.to(torch.float32)
    outs = []
    for r0 in range(0, R_, chunk_rays):
        cc = coords[r0:r0 + chunk_rays]
        cr = cc.shape[0]
        rows, w8 = S.corner_rows_weights(cc.reshape(-1, 3), vol_shape, True,
                                         False)
        samp = S.gather_corners(flat, rows, w8).reshape(cr, S_n, Ct)
        samp = samp * valid[r0:r0 + chunk_rays].to(torch.float32)[..., None]
        sd = (density(samp[..., 0], density_mode, beta, sdf_bias)
              * deltas[r0:r0 + chunk_rays].to(torch.float32))
        alpha = 1.0 - torch.exp(-sd)
        w = alpha * torch.exp(-(torch.cumsum(sd, dim=-1) - sd))   # (cr, S)
        acc = torch.sum(w, dim=-1)
        rgb_o = torch.sum(w[..., None] * samp[..., K + 1:K + 4], dim=1)
        seg_o = torch.sum(w[..., None] * samp[..., 1:K + 1], dim=1)
        depth_o = torch.sum(w * mids[None, :], dim=1) + (1.0 - acc) * bg_depth
        outs.append(torch.cat([rgb_o, seg_o, depth_o[:, None]], dim=-1))
    return torch.cat(outs, dim=0)


def sample_and_composite_rays_backward_reference(
        table: torch.Tensor, vol_shape: Tuple[int, int, int],
        coords: torch.Tensor, valid: torch.Tensor, deltas: torch.Tensor,
        camera_mids: torch.Tensor, bg_depth: float, density_mode: str,
        beta: torch.Tensor, sdf_bias: float, g_out: torch.Tensor,
        chunk_rays: Optional[int] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of `sample_and_composite_rays_reference`, written out.

    Given g_out = d out (R, 3 + K + 1), returns (d table fp32 of the table's
    (rows, 8*Ct) flat shape, d beta fp32 0-dim). Each chunk of rays
    is sampled again (as the JAX package's checkpointed chunks are), and with
    u_i = g_rgb . rgb_i + g_seg . seg_i + g_depth * (mid_i - bg) per sample:

      d seg_i, d rgb_i = w_i * g_seg, w_i * g_rgb
      d sd_i = T_{i+1} u_i - sum_{j>i} w_j u_j   (a suffix sum here; the
               kernel takes the total from the saved outputs instead)
      d sdf_i = d sd_i * delta_i * density'(sdf_i)

    then every sample's d value is scattered into its 8 corner rows with its
    corner weights times `valid`. This is the CPU path and the version the
    CUDA kernel (`csrc/rays.cu`) is held to.
    """
    D, H, W = vol_shape
    flat = table.reshape((D + 1) * (H + 1) * (W + 1), -1)
    Ct = flat.shape[1] // 8
    K = Ct - 4
    R_, S_n = coords.shape[:2]
    if chunk_rays is None:
        chunk_rays = max(1, _CHUNK_BYTES // (S_n * 8 * Ct * 4))
    mids = camera_mids.to(torch.float32)
    d_table = torch.zeros(flat.shape, dtype=torch.float32,
                          device=flat.device)
    d_beta = torch.zeros((), dtype=torch.float32, device=flat.device)
    for r0 in range(0, R_, chunk_rays):
        cc = coords[r0:r0 + chunk_rays]
        cr = cc.shape[0]
        vm = valid[r0:r0 + chunk_rays].to(torch.float32)
        dl = deltas[r0:r0 + chunk_rays].to(torch.float32)
        g = g_out[r0:r0 + chunk_rays].to(torch.float32)
        g_rgb, g_seg, g_d = g[:, :3], g[:, 3:K + 3], g[:, K + 3]
        rows, w8 = S.corner_rows_weights(cc.reshape(-1, 3), vol_shape, True,
                                         False)
        samp = S.gather_corners(flat, rows, w8).reshape(cr, S_n, Ct)
        samp = samp * vm[..., None]
        dens, ddx, ddb = density_and_grads(samp[..., 0], density_mode, beta,
                                           sdf_bias)
        sd = dens * dl
        csum = torch.cumsum(sd, dim=-1)
        w = (1.0 - torch.exp(-sd)) * torch.exp(-(csum - sd))
        t_next = torch.exp(-csum)
        u = (torch.einsum('rsk,rk->rs', samp[..., K + 1:K + 4], g_rgb)
             + torch.einsum('rsk,rk->rs', samp[..., 1:K + 1], g_seg)
             + g_d[:, None] * (mids[None, :] - bg_depth))
        wu = w * u
        after = torch.flip(torch.cumsum(torch.flip(wu, (1,)), 1), (1,)) - wu
        dsd = t_next * u - after
        d_beta = d_beta + torch.sum(dsd * dl * ddb)
        dsamp = torch.cat([(dsd * dl * ddx)[..., None],
                           w[..., None] * g_seg[:, None, :],
                           w[..., None] * g_rgb[:, None, :]], dim=-1)
        dsamp = (dsamp * vm[..., None]).reshape(cr * S_n, 1, Ct)
        d_table.index_add_(0, rows,
                           (dsamp * w8[:, :, None]).reshape(-1, 8 * Ct))
    return d_table, d_beta
