"""Volume rendering: VolSDF-style densities and alpha compositing (fp32).

Port of `vampire_tpu/core/rendering.py`: the densities, the BEV column
render, the unfused camera-ray oracle `render_camera_rays`,
`sample_and_composite_rays_reference`, the dense ray sampler on the corner
table as the JAX package runs it, and its gradient written out,
`sample_and_composite_rays_backward_reference`; and the same two reading the
channels-last field instead of the table
(`sample_and_composite_rays_field_reference` and
`sample_and_composite_rays_field_backward_reference`), the plain versions
of the CUDA kernels in `ops/rays.py`, which also take a per-ray stop
(the samples from it on add nothing) and give each ray's optical depth.

The JAX package's two pass-structured samplers reduce to that march on
changed inputs (`compact_valid`, `earlyterm_stops`): the train-mode compact
sampler (vampire_tpu/core/rendering.py:240) is the march on a validity
cut at each ray's processed prefix, whose closed-form fog tail is what the
march gives an invalid sample; the early-termination sampler (`:331`) is
the march stopped where each ray's last pass ends, every exited ray
marched whole.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

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


# the plain samplers gather (rays, S, 8, Ct) fp32 values per chunk; keep a
# chunk under ~1 GB
_CHUNK_BYTES = 1 << 30


def _composite(samp, vm, dl, mids, bg_depth, density_mode, beta, sdf_bias,
               live=None):
    """[rgb | seg | depth] of a chunk from its (cr, S, Ct) samples, and
    each ray's optical depth; `live` (cr, S), 1 before each ray's stop and
    0 from it on, zeroes the optical depth and so the weight of the samples
    past the stop (None: every sample counts)."""
    K = samp.shape[-1] - 4
    samp = samp * vm[..., None]
    sd = density(samp[..., 0], density_mode, beta, sdf_bias) * dl
    if live is not None:
        sd = sd * live
    alpha = 1.0 - torch.exp(-sd)
    w = alpha * torch.exp(-(torch.cumsum(sd, dim=-1) - sd))   # (cr, S)
    acc = torch.sum(w, dim=-1)
    rgb_o = torch.sum(w[..., None] * samp[..., K + 1:K + 4], dim=1)
    seg_o = torch.sum(w[..., None] * samp[..., 1:K + 1], dim=1)
    depth_o = torch.sum(w * mids[None, :], dim=1) + (1.0 - acc) * bg_depth
    return (torch.cat([rgb_o, seg_o, depth_o[:, None]], dim=-1),
            torch.sum(sd, dim=-1))


def _march(sample, Ct, coords, valid, deltas, camera_mids, bg_depth,
           density_mode, beta, sdf_bias, chunk_rays, stop=None):
    """Composite whole rays, chunk by chunk; `sample(c)` gives the (P, Ct)
    fp32 samples at the (P, 3) coords c. Returns ([rgb | seg | depth],
    optical depth) per ray; a ray's samples from `stop` (R,) on add
    nothing."""
    R_, S_n = coords.shape[:2]
    if chunk_rays is None:
        chunk_rays = max(1, _CHUNK_BYTES // (S_n * 8 * Ct * 4))
    mids = camera_mids.to(torch.float32)
    s_idx = torch.arange(S_n, device=coords.device)
    outs, sds = [], []
    for r0 in range(0, R_, chunk_rays):
        cc = coords[r0:r0 + chunk_rays]
        samp = sample(cc.reshape(-1, 3)).reshape(cc.shape[0], S_n, Ct)
        live = (None if stop is None else
                (s_idx[None, :] < stop[r0:r0 + chunk_rays, None]).to(
                    torch.float32))
        out, sd = _composite(
            samp, valid[r0:r0 + chunk_rays].to(torch.float32),
            deltas[r0:r0 + chunk_rays].to(torch.float32), mids, bg_depth,
            density_mode, beta, sdf_bias, live)
        outs.append(out)
        sds.append(sd)
    return torch.cat(outs, dim=0), torch.cat(sds, dim=0)


def sample_and_composite_rays_reference(
        table: torch.Tensor, vol_shape: Tuple[int, int, int],
        coords: torch.Tensor, valid: torch.Tensor, deltas: torch.Tensor,
        camera_mids: torch.Tensor, bg_depth: float, density_mode: str,
        beta: torch.Tensor, sdf_bias: float,
        chunk_rays: Optional[int] = None) -> torch.Tensor:
    """Sample the corner table along whole rays and alpha-composite them.

    The same values as `grid_sample_3d_fused(vol, coords) * valid` (zeros
    padding, align_corners=True) followed by `render_camera_rays`, chunked
    over rays so that the gathered samples of a chunk stay under ~1 GB. The
    JAX package's dense sampler reads this table; the port's ray op reads
    the field instead (`sample_and_composite_rays_field_reference`, the
    same values).

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

    def sample(c):
        rows, w8 = S.corner_rows_weights(c, vol_shape, True, False)
        return S.gather_corners(flat, rows, w8)
    return _march(sample, flat.shape[1] // 8, coords, valid, deltas,
                  camera_mids, bg_depth, density_mode, beta, sdf_bias,
                  chunk_rays)[0]


def sample_and_composite_rays_field_reference(
        field: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
        deltas: torch.Tensor, camera_mids: torch.Tensor, bg_depth: float,
        density_mode: str, beta: torch.Tensor, sdf_bias: float,
        chunk_rays: Optional[int] = None,
        stop: Optional[torch.Tensor] = None, with_sd: bool = False):
    """`sample_and_composite_rays_reference` reading the 8 corners of each
    sample from the channels-last (D, H, W, C) field (bf16 or fp32, any
    strides) instead of its corner table: the same terms in the same order,
    so in fp32 the same results bit for bit. The plain version of the CUDA
    kernel in `ops/rays.py`.

    `stop` (R,) int32: sample i of a ray adds no optical depth and no
    weight where i >= stop[ray] (the early-termination sampler's cut;
    None: every sample counts). `with_sd`: also return each ray's optical
    depth summed over its samples before the stop, (R,) fp32."""
    C = field.shape[-1]
    out, sd = _march(lambda c: S.gather_field_corners(field, c), C, coords,
                     valid, deltas, camera_mids, bg_depth, density_mode,
                     beta, sdf_bias, chunk_rays, stop)
    return (out, sd) if with_sd else out


def _sample_grads(samp, vm, dl, g, mids, bg_depth, density_mode, beta,
                  sdf_bias):
    """For a chunk's (cr, S, Ct) samples and its (cr, Ct) d out: d samples
    (cr, S, Ct) fp32, times `valid`, and the chunk's d beta."""
    K = samp.shape[-1] - 4
    g_rgb, g_seg, g_d = g[:, :3], g[:, 3:K + 3], g[:, K + 3]
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
    dsamp = torch.cat([(dsd * dl * ddx)[..., None],
                       w[..., None] * g_seg[:, None, :],
                       w[..., None] * g_rgb[:, None, :]], dim=-1)
    return dsamp * vm[..., None], torch.sum(dsd * dl * ddb)


def _march_backward(sample, scatter, Ct, coords, valid, deltas, camera_mids,
                    bg_depth, density_mode, beta, sdf_bias, g_out,
                    chunk_rays):
    """d beta of whole rays, chunk by chunk; `sample(c)` as in `_march`,
    `scatter(c, d)` adds the (P, Ct) d samples at the coords c into the
    caller's gradient."""
    R_, S_n = coords.shape[:2]
    if chunk_rays is None:
        chunk_rays = max(1, _CHUNK_BYTES // (S_n * 8 * Ct * 4))
    mids = camera_mids.to(torch.float32)
    d_beta = torch.zeros((), dtype=torch.float32, device=coords.device)
    for r0 in range(0, R_, chunk_rays):
        c = coords[r0:r0 + chunk_rays].reshape(-1, 3)
        cr = c.shape[0] // S_n
        dsamp, db = _sample_grads(
            sample(c).reshape(cr, S_n, Ct),
            valid[r0:r0 + chunk_rays].to(torch.float32),
            deltas[r0:r0 + chunk_rays].to(torch.float32),
            g_out[r0:r0 + chunk_rays].to(torch.float32), mids, bg_depth,
            density_mode, beta, sdf_bias)
        d_beta = d_beta + db
        scatter(c, dsamp.reshape(cr * S_n, 1, Ct))
    return d_beta


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
    corner weights times `valid`.
    """
    D, H, W = vol_shape
    flat = table.reshape((D + 1) * (H + 1) * (W + 1), -1)
    Ct = flat.shape[1] // 8
    d_table = torch.zeros(flat.shape, dtype=torch.float32,
                          device=flat.device)

    def sample(c):
        rows, w8 = S.corner_rows_weights(c, vol_shape, True, False)
        return S.gather_corners(flat, rows, w8)

    def scatter(c, dsamp):
        rows, w8 = S.corner_rows_weights(c, vol_shape, True, False)
        d_table.index_add_(0, rows,
                           (dsamp * w8[:, :, None]).reshape(-1, 8 * Ct))
    d_beta = _march_backward(sample, scatter, Ct, coords, valid, deltas,
                             camera_mids, bg_depth, density_mode, beta,
                             sdf_bias, g_out, chunk_rays)
    return d_table, d_beta


def sample_and_composite_rays_field_backward_reference(
        field: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
        deltas: torch.Tensor, camera_mids: torch.Tensor, bg_depth: float,
        density_mode: str, beta: torch.Tensor, sdf_bias: float,
        g_out: torch.Tensor, chunk_rays: Optional[int] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of `sample_and_composite_rays_field_reference`: (d field
    fp32 (D, H, W, C), d beta fp32 0-dim). As
    `sample_and_composite_rays_backward_reference`, but each sample's d
    value goes with its corner weights straight into the field's gradient,
    so no table cotangent exists; in fp32 it is that version's d table
    passed through the table's transpose, summed in another order. This is
    the CPU path and the version the CUDA kernel (`csrc/rays.cu`) is held
    to."""
    D, H, W, C = field.shape
    d_field = torch.zeros((D * H * W, C), dtype=torch.float32,
                          device=field.device)

    def scatter(c, dsamp):
        vox, _, w8 = S.field_corners(c, (D, H, W))
        # corners outside the field weigh 0: they add 0 at a clamped voxel
        d_field.index_add_(0, vox.reshape(-1),
                           (dsamp * w8[:, :, None]).reshape(-1, C))
    d_beta = _march_backward(lambda c: S.gather_field_corners(field, c),
                             scatter, C, coords, valid, deltas, camera_mids,
                             bg_depth, density_mode, beta, sdf_bias, g_out,
                             chunk_rays)
    return d_field.reshape(D, H, W, C), d_beta


# --- the pass-structured samplers of the JAX package, as inputs of the march


def ray_lengths(valid: torch.Tensor) -> torch.Tensor:
    """Each ray's in-field length L (R,) int64 from its (R, S) validity:
    one past its last valid sample, 0 for a ray with none (the JAX
    samplers' `where(any(valid), S - argmax(flip(valid) > 0), 0)`)."""
    S_n = valid.shape[1]
    pos = torch.arange(1, S_n + 1, device=valid.device)
    return torch.amax(torch.where(valid > 0, pos, 0), dim=1)


def pass_caps(fracs: Sequence[float], n_rays: int) -> List[int]:
    """The JAX samplers' static ray count a pass, min(R, ceil(f * R / 256)
    * 256) in Python floats, made non-increasing from the last pass back
    (a ray a pass drops stays dropped)."""
    caps = [min(n_rays, int(math.ceil(f * n_rays / 256.0) * 256))
            for f in fracs]
    for j in range(len(caps) - 2, -1, -1):
        caps[j] = max(caps[j], caps[j + 1])
    return caps


def _ranks(key: torch.Tensor) -> torch.Tensor:
    """Each element's position in the stable ascending sort of `key` (the
    JAX argsort, stable by default)."""
    order = torch.argsort(key, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(len(order), device=key.device)
    return rank


def _covered(rank, caps, first, chunk, S_n):
    """The samples passes first, first + 1, ... of `chunk` samples give the
    ray at sorted position `rank`: a pass's samples where rank < its cap."""
    n = torch.zeros_like(rank)
    for j, cap in enumerate(caps):
        s0 = (first + j) * chunk
        n = n + torch.where(rank < cap, min(S_n, s0 + chunk) - s0, 0)
    return n


def compact_valid(valid: torch.Tensor, chunk: int,
                  pass_fracs: Sequence[float]) -> torch.Tensor:
    """The validity under which the dense march computes the JAX train-mode
    `sample_and_composite_rays_compact` (vampire_tpu/core/rendering.py:240),
    forward and backward: valid * (s < processed[rank]), fp32 (R, S).

    The JAX sampler sorts the rays by in-field length L, descending
    (stable), and runs ceil(S / chunk) passes of `chunk` samples, pass j
    over the first `pass_caps(pass_fracs)[j]` sorted rays; a ray's samples
    past the passes that take it (`processed`) get closed-form fog, the
    density of a zero sample with no value, which is what the march gives a
    sample whose valid is 0. So only the samples from `processed` on
    change, and only where they lie in the field (s < L), i.e. where a cap
    does not cover the ray's in-field prefix."""
    R_, S_n = valid.shape
    n_pass = -(-S_n // chunk)
    if len(pass_fracs) != n_pass:
        raise ValueError(f'ray_pass_fracs has {len(pass_fracs)} entries but '
                         f'the ray axis makes {n_pass} passes (S={S_n}, '
                         f'chunk={chunk})')
    rank = _ranks(-ray_lengths(valid))
    processed = _covered(rank, pass_caps(pass_fracs, R_), 0, chunk, S_n)
    s_idx = torch.arange(S_n, device=valid.device)
    return valid.to(torch.float32) * (s_idx[None, :]
                                      < processed[:, None]).to(torch.float32)


def earlyterm_stops(sd_prefix: torch.Tensor, valid: torch.Tensor,
                    chunk: int, prefix: int, caps_fracs: Sequence[float]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The per-ray stops of the JAX `sample_and_composite_rays_earlyterm`
    (vampire_tpu/core/rendering.py:331), from each ray's optical depth over
    its first prefix * chunk samples `sd_prefix` (R,) fp32 and its validity.

    The JAX sampler runs `prefix` passes of `chunk` samples over every
    ray, then sorts the rays (stable) by key = sd_prefix + 1e9 for the
    exited rays (L <= prefix * chunk), added in fp32 as it is there (an
    exited ray's key with sd < 32 rounds to 1e9 exactly, so those rays tie
    and keep their order), and runs the remaining passes, pass j over the
    first `pass_caps(caps_fracs)[j]` sorted rays. A non-exited ray gets
    nothing past its last pass, not even fog; an exited ray's untouched
    samples get closed-form fog, so it is the dense ray. Returns
    (stop (R,) int32: S for an exited ray, else prefix * chunk plus the
    samples of the passes whose cap covers its rank; exited (R,) bool;
    misses (R,) int32, the passes whose cap the ray's rank misses)."""
    R_, S_n = valid.shape
    n_pass = -(-S_n // chunk)
    if not 0 < prefix <= n_pass or len(caps_fracs) != n_pass - prefix:
        raise ValueError(f'ray_et_fracs has {len(caps_fracs)} entries but '
                         f'needs {n_pass - prefix} (S={S_n}, chunk={chunk}, '
                         f'prefix={prefix})')
    exited = ray_lengths(valid) <= prefix * chunk
    key = sd_prefix.to(torch.float32) + torch.where(
        exited, torch.tensor(1e9, dtype=torch.float32, device=valid.device),
        torch.tensor(0.0, dtype=torch.float32, device=valid.device))
    rank = _ranks(key)
    caps = pass_caps(caps_fracs, R_)
    stop = min(S_n, prefix * chunk) + _covered(rank, caps, prefix, chunk,
                                               S_n)
    stop = torch.where(exited, S_n, stop).to(torch.int32)
    misses = torch.zeros_like(rank)
    for cap in caps:
        misses = misses + (rank >= cap).to(misses.dtype)
    return stop, exited, misses.to(torch.int32)


def earlyterm_uncovered_drops(sd_stop: torch.Tensor, exited: torch.Tensor,
                              misses: torch.Tensor, tau: float
                              ) -> torch.Tensor:
    """The JAX early-term sampler's coverage diagnostic (`return_diag`,
    vampire_tpu/core/rendering.py:421-428): the (ray, pass) drops of rays
    neither exited nor saturated, i.e. the sum over the non-exited rays
    whose optical depth at their stop `sd_stop` is below `tau` of the
    passes their rank misses (a dropped ray stays dropped, and its optical
    depth stops growing). int64 0-dim."""
    bad = (~exited) & (sd_stop < tau)
    return torch.sum(torch.where(bad, misses, 0).to(torch.int64))
