"""The image -> field backbone; the port of `vampire_tpu/models/field.py`
(`FieldBackbone`), in its four variants: `lss_inpaintor` (the flagship),
`vampire2` (the default), `lss` and `bilinear`.

Cameras are encoded by ResNet + SECONDFPN, lifted through the depth softmax
(`bilinear`: the features alone, no depth head) into one ego voxel field by
the block-compacted lift, or the dense lift with every block selected
(`lift_block=0` or `lift_block_topk=0`), whose inner step is the CUDA kernel
of `ops/lift.py`, refined by the Unet3D (`lss` and `bilinear`: one conv and
a softplus), and queried for the Occ3D grid (`vampire2`: rotated by bda),
the LiDAR points, the BEV column renders and the BEV feature of the
detection head. A (B, F, N, H, W, 3) multi-sweep input folds its F frames
into the view axis of the encoder and the lift; the renders and queries use
the key frame (frame 0). With `camera_renders=True` (the default, as in the JAX
package) the fused field [sdf | seg | rgb] is also copied channels-last in
bf16 once per frame, and the camera rays are rendered from that copy
(`ops/rays.py`); the ray renders are upsampled x4. The JAX package reads
the same corner values through a corner table (a TPU gather layout), which
the port builds only in its kernel checks (`ops/tables.py`). The two
kernels' ops are `torch.autograd.Function`s with backward kernels, so the
same forward trains (`training/`).

Under a dp x cam layout (`parallel/mesh.py`, set by `Vampire.use_layout`)
the rank holds its part of each frame's cameras: it encodes them, lifts
them with the dense lift (`lift_vectorized`, the JAX module's field) into
partial sums that the cam group adds (`lift`), runs the trunk and the heads
on the whole field as every rank of its cam group does, and renders the
rays of its own cameras, whose pass samplers sort the whole frame's rays.

With `utils.profiling` on, the forward's stages are spans:
`model.encoder` (image backbone and neck), `model.lift` (the depth
softmax, `channel_lower`, the lift, the position channels), `model.trunk`
(`base_conv` and the density/seg/feature/rgb heads), `model.queries`
(points, Occ3D), `model.rays` (the camera rays) and `model.bev` (the BEV
render, the gate, `voxel_output`, the resize).

Layouts: inputs and outputs keep the JAX package's layouts (channels-last
images, (B, Z, Y, X) ordering, occ as (B, X, Y, Z, K)); inside, tensors are
channels-first as torch convolutions want them.

dtype flow (as in the JAX package): convolution stacks run in `dtype`; the
depth softmax is fp32 then cast to `dtype`; the lift returns fp32; the heads'
outputs, the density, queries and rendering are fp32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..configs import BackboneConfig
from ..core import geometry as G
from ..core import rendering as R
from ..core import sampling as S
from ..ops import lift as lift_ops
from ..ops import rays as ray_ops
from ..parallel.distributed import all_reduce_sum
from ..parallel.mesh import SINGLE, Layout, ray_split
from ..utils import profiling
from .resnet import Conv2d, ResNet
from .second_fpn import SECONDFPN
from .unet3d import Conv3d, ConvSoftplus3D, Unet3D

VARIANTS = ('vampire2', 'lss', 'lss_inpaintor', 'bilinear')
# the per-view matrices, which a multi-sweep input carries per frame
VIEW_KEYS = ('sensor2ego', 'intrin', 'ida')


def lift_layout(c: BackboneConfig,
                dense: bool = False) -> Tuple[int, bool]:
    """(block size, compact) of the lift. The block-compacted lift, as the
    JAX package runs it, where lift_block and lift_block_topk are set and
    the block divides the (Y, X) plane, unless `dense` (the JAX
    `lift_vectorized`); else the dense lift, as every block selected by
    every camera at the largest of 8, 4, 2 and 1 that divides Y and X and
    keeps the block count under the kernel's 2^16."""
    _, Y, X = c.grid_zyx('seg')
    blk = c.lift_block
    if not dense and blk and c.lift_block_topk and not Y % blk \
            and not X % blk:
        return blk, True
    for blk in (8, 4, 2, 1):
        if not Y % blk and not X % blk and (Y // blk) * (X // blk) < 2 ** 16:
            return blk, False
    raise ValueError(f'the dense lift of a {Y}x{X} plane needs over 2^16 '
                     f'blocks, more than the lift kernel takes')


def block_major_voxels(c: BackboneConfig,
                       blk: Optional[int] = None) -> np.ndarray:
    """(G, Q, 4) voxel centers, block-major: G = (Y/blk)*(X/blk) blocks of
    Q = Z*blk*blk voxels, each block a (Z, blk, blk) column; blk defaults to
    the lift's (`lift_layout`)."""
    blk = blk or lift_layout(c)[0]
    Z, Y, X = c.grid_zyx('seg')
    vox = G.make_voxel_coords(c.x_bound_seg, c.y_bound_seg, c.z_bound_seg)
    v6 = vox.reshape(Z, Y // blk, blk, X // blk, blk, 4)
    v6 = v6.transpose(1, 3, 0, 2, 4, 5)
    return np.ascontiguousarray(v6.reshape((Y // blk) * (X // blk),
                                           Z * blk * blk, 4))


def coords_valid(pix: torch.Tensor, c: BackboneConfig):
    """Per-camera pixel coords -> (normalized lift coords, fp32 validity).

    The coords are clipped to [-2, 2] and sampled with align_corners=False.
    The `bilinear` variant samples the depth-1 feature volume: a voxel is
    valid in front of the camera (z > 0, no depth window) and its norm_z is 0.
    """
    fH, fW = c.final_dim
    x, y, z = pix[..., 0], pix[..., 1], pix[..., 2]
    norm_x = 2.0 * (x / (fW - 1.0)) - 1.0
    norm_y = 2.0 * (y / (fH - 1.0)) - 1.0
    if c.variant == 'bilinear':
        z_valid = z > 0.0
        norm_z = torch.zeros_like(norm_x)
    else:
        z_valid = (z > c.d_bound[0]) & (z < c.d_bound[1])
        norm_z = 2.0 * ((z - c.d_bound[0])
                        / (c.d_bound[1] - c.d_bound[0])) - 1.0
    valid = ((x > -0.5) & (x < fW - 0.5) & (y > -0.5) & (y < fH - 0.5)
             & z_valid).to(torch.float32)
    coords = torch.stack([norm_x, norm_y, norm_z], dim=-1)
    return torch.clamp(coords, -2.0, 2.0), valid


def ray_inputs(geom_xyz: torch.Tensor, c: BackboneConfig):
    """Camera-frustum points -> the ray sampler's inputs, ray-major.

    geom_xyz: (B, N, D, fh, fw, 3) ego xyz of the D depth planes. The first
    S = D-1 planes are the samples. Returns coords (B, R, S, 3) normalized
    to the field grid, valid (B, R, S) fp32 in-range mask and deltas
    (B, R, S) distances to the next plane, with R = N*fh*fw rays.
    """
    geom_xyz = torch.nan_to_num(geom_xyz.to(torch.float32), nan=-1e3)
    norm = G.normalize_coords(geom_xyz[:, :, :-1], c.x_bound_seg,
                              c.y_bound_seg, c.z_bound_seg)
    valid = G.inrange_mask(norm).to(torch.float32)
    delta = torch.linalg.norm(geom_xyz[:, :, 1:] - geom_xyz[:, :, :-1],
                              dim=-1)
    B, N, S, fh, fw = norm.shape[:5]

    def ray_major(x, tail):
        return torch.movedim(x, 2, 4).reshape((B, N * fh * fw, S) + tail)
    return (ray_major(norm, (3,)).contiguous(),
            ray_major(valid, ()).contiguous(),
            ray_major(delta, ()).contiguous())


def _norm1d(centers, bound):
    return (centers - bound[0]) / (bound[1] - bound[0]) * 2.0 - 1.0


class FieldBackbone(nn.Module):
    """Camera images -> ego 3D feature field -> metric outputs.

    lift_vectorized: the JAX module's field of that name, which keeps the
    camera axis so that a camera-sharded mesh sums it by a collective: here
    the dense lift (`lift_layout(dense=True)`), whatever the config's
    blocks. A layout that splits the cameras needs it (`layout`)."""

    def __init__(self, cfg: BackboneConfig, dtype=torch.float32,
                 device=None, lift_vectorized: bool = False):
        super().__init__()
        c = cfg
        if c.variant not in VARIANTS:
            raise ValueError(f'variant {c.variant!r}: one of {VARIANTS}')
        self.cfg = c
        self.dtype = dtype
        # dtype of the field the point queries and the camera rays sample
        # (the JAX module's `sample_dtype`; weights and sums stay fp32). A
        # test sets float32 to compare gradients without bf16 roundings.
        self.sample_dtype = torch.bfloat16
        K = c.num_classes
        mid = c.mid_channels
        Zs, Ys, Xs = c.grid_zyx('seg')
        Zd, _, _ = c.grid_zyx('det')

        def buf(name, a):
            self.register_buffer(
                name, torch.as_tensor(np.ascontiguousarray(a), device=device),
                persistent=False)

        self.lift_vectorized = lift_vectorized
        self.lift_block, self.lift_compact = lift_layout(c, lift_vectorized)
        self._layout = SINGLE
        buf('voxel_coords_bm', block_major_voxels(c, self.lift_block))
        buf('norm_voxel_coords', G.make_norm_voxel_coords(
            c.x_bound_seg, c.y_bound_seg, c.z_bound_seg).transpose(3, 0, 1, 2))
        buf('bev_mids', G.make_bev_mids(c.z_bound_det))
        buf('frustum', G.make_frustum(c.final_dim, c.downsample_factor,
                                      c.d_bound))
        buf('camera_mids', G.make_camera_mids(c.d_bound))
        # static-grid queries as separable interpolation matrices
        for i, ax in enumerate('zyx'):
            bd = getattr(c, f'{ax}_bound_det')
            bs = getattr(c, f'{ax}_bound_seg')
            buf(f'det_mat_{ax}', S.make_sample_matrix(
                _norm1d(G.centers_of(bd), bs), (Zs, Ys, Xs)[i], True,
                'zeros'))
        occ_c = G.make_occ_coords(c.occ_pc_range, c.occ_voxel_size,
                                  c.occ_grid)
        if c.variant == 'vampire2':
            # the occ grid is rotated by each frame's bda: sampled points
            buf('occ_coords', occ_c)
        else:
            # the static occ grid: separable interpolation matrices
            occ_n = dict(x=occ_c[:, 0, 0, 0], y=occ_c[0, :, 0, 1],
                         z=occ_c[0, 0, :, 2])
            for i, ax in enumerate('zyx'):
                n = _norm1d(occ_n[ax], getattr(c, f'{ax}_bound_seg'))
                for pad in ('border', 'zeros'):
                    buf(f'occ_mat_{pad}_{ax}', S.make_sample_matrix(
                        n, (Zs, Ys, Xs)[i], True, pad))

        kw = dict(device=device)
        self.img_backbone = ResNet(depth=c.img_backbone_depth,
                                   out_indices=c.img_backbone_out_indices,
                                   frozen_stem=True, dtype=dtype, **kw)
        self.img_neck = SECONDFPN(c.img_neck_in_channels,
                                  c.img_neck_out_channels,
                                  c.img_neck_upsample_strides, dtype=dtype,
                                  **kw)
        cimg = c.img_out_channels
        if c.variant != 'bilinear':
            self.mapping_along_depth = Conv2d(cimg, c.depth_channels, 3, 1,
                                              1, bias=False,
                                              compute_dtype=dtype, **kw)
        self.channel_lower = Conv2d(cimg, mid, 3, 1, 1, bias=False,
                                    compute_dtype=dtype, **kw)
        base = (Unet3D if c.variant in ('vampire2', 'lss_inpaintor')
                else ConvSoftplus3D)
        self.base_conv = base(mid + (3 if c.cat_pos else 0), mid,
                              dtype=dtype, **kw)
        self.density_conv = Conv3d(mid, 1, bias=True, compute_dtype=dtype,
                                   **kw)
        self.seg_conv = Conv3d(mid, K, bias=True, compute_dtype=dtype, **kw)
        self.rgb_conv = Conv3d(mid, 3, bias=True, compute_dtype=dtype, **kw)
        if c.variant == 'bilinear':
            self.feature_conv = Conv3d(mid, mid, bias=True,
                                       compute_dtype=dtype, **kw)
        self.density_beta = nn.Parameter(
            torch.tensor(0.1, dtype=torch.float32, device=device))
        cv = mid + (K if c.cat_seg else 0)
        self.voxel_output = Conv2d(cv * Zd, c.output_channels, 1, bias=True,
                                   **kw)

    # ------------------------------------------------------------------
    @property
    def layout(self) -> Layout:
        """The dp x cam layout the forward runs under (`parallel/mesh.py`);
        one that splits the cameras needs `lift_vectorized`."""
        return self._layout

    @layout.setter
    def layout(self, layout: Layout) -> None:
        if layout.cam > 1 and not self.lift_vectorized:
            raise ValueError('a layout that splits the cameras sums the '
                             'lift over them: build the model with '
                             'lift_vectorized=True')
        self._layout = layout

    def _density(self, x):
        return R.density(x, self.cfg.density_mode, self.density_beta,
                         self.cfg.sdf_bias)

    def lift(self, depth: Optional[torch.Tensor], feat: torch.Tensor,
             mats: Dict[str, torch.Tensor], plain: bool = False,
             diagnostics: Optional[dict] = None) -> torch.Tensor:
        """Block-major masked-mean lift.

        depth: (B, N, D, h, w) depth distribution, None for `bilinear`;
        feat: (B, N, h, w, C). The compacted lift: each camera selects its
        top-K (Y, X) blocks by valid-query count. The dense lift: every
        camera selects every block, in block order, which sums each voxel's
        cameras in camera order as the JAX dense loop does. Then
        `ops.lift.lift_frame` (one launch of the lift kernel a frame,
        `plain`: its plain version; differentiable) sums the frame's samples
        into block-major (G, Q, C) accumulators. With a `diagnostics` dict,
        the compacted lift puts there `lift_dropped_blocks`: the blocks that
        hold a valid query and that the top-K dropped, summed over (B, N),
        the JAX package's sown diagnostic. Where the layout splits the
        cameras, feat, depth and mats hold this rank's, and the partial sums
        are added over the cam group (`all_reduce_sum`, whose backward adds
        the field's cotangent over it) before the masked mean. Returns
        (B, C, Z, Y, X) fp32.
        """
        c = self.cfg
        Z, Y, X = c.grid_zyx('seg')
        blk = self.lift_block
        B, N = feat.shape[:2]
        Gn, Q = (Y // blk) * (X // blk), Z * blk * blk
        # geometry straight from the block-major voxel constant:
        # coords (B, N, G, Q, 3), validity (B, N, G, Q)
        pix = G.get_pixel(self.voxel_coords_bm[:, :, None],
                          mats['sensor2ego'], mats['intrin'], mats['ida'],
                          mats.get('bda'))[..., 0, :]
        coords, valid = coords_valid(pix, c)
        if self.lift_compact:
            counts = valid.sum(-1)                           # (B, N, G)
            top = torch.topk(counts, min(c.lift_block_topk, Gn), dim=-1)
            ids = top.indices                                # (B, N, K)
            if diagnostics is not None:
                diagnostics['lift_dropped_blocks'] = torch.sum(
                    (counts > 0).sum(-1) - (top.values > 0).sum(-1))
            sel = ids[..., None]
            coords = torch.gather(coords, 2, sel[..., None].expand(
                -1, -1, -1, Q, 3))                           # (B, N, K, Q, 3)
            valid = torch.gather(valid, 2, sel.expand(-1, -1, -1, Q))
        else:
            ids = torch.arange(Gn, device=feat.device).expand(B, N, Gn)
        accs = [lift_ops.lift_frame(
            None if depth is None else depth[b].contiguous(),
            feat[b].contiguous(), ids[b].contiguous(), coords[b].contiguous(),
            valid[b].contiguous(), Gn, plain)
            for b in range(B)]
        if self.layout.split_cameras:
            # the cameras' sums over the cam group; the denominator takes
            # no gradient, as the lift gives it none
            group = self.layout.cam_group
            numer = all_reduce_sum(torch.stack([n for n, _ in accs]), group)
            denom = all_reduce_sum(torch.stack([d for _, d in accs]).detach(),
                                   group)
            accs = list(zip(numer.unbind(), denom.unbind()))
        return self._masked_mean(accs)

    def _masked_mean(self, accs) -> torch.Tensor:
        """The lift's masked mean: per batch element its block-major (G, Q,
        C) (numer, denom) -> numer / (denom + 1e-6) as (B, C, Z, Y, X)."""
        Z, Y, X = self.cfg.grid_zyx('seg')
        blk = self.lift_block
        C = accs[0][0].shape[-1]
        out = torch.stack([n / (d + 1e-6) for n, d in accs])
        out = out.reshape(len(accs), Y // blk, X // blk, Z, blk, blk, C)
        return out.permute(0, 6, 3, 1, 4, 2, 5).reshape(-1, C, Z, Y, X)

    def _query_points(self, fused, points):
        """Point queries: pts_logits (B, P, K), pts_sdf (B, P).

        `grid_sample` on a `sample_dtype`-rounded copy of the fused volume
        with fp32 weights and accumulation, like the JAX package. The
        JAX full-render graph reads the same values through its corner table
        (a TPU gather layout); here both graphs take this path, which gives
        them up to the fp32 summation order and is the faster one on a card.
        """
        c = self.cfg
        K = c.num_classes
        norm = G.normalize_coords(points, c.x_bound_seg, c.y_bound_seg,
                                  c.z_bound_seg)
        vol = fused.to(self.sample_dtype).to(torch.float32)
        samp = S.grid_sample_3d(vol, norm, align_corners=True,
                                padding_mode='border')
        pts_logits = samp[..., 1:K + 1]
        pts_sdf = samp[..., 0] * G.inrange_mask(norm).to(torch.float32)
        return pts_logits, pts_sdf

    def _query_occ(self, seg_vol, sdf_vol, bda=None):
        """Occ3D grid queries: (B, X, Y, Z, K), (B, X, Y, Z). On the static
        grid through separable matrices; for `vampire2` on the grid rotated
        by bda (None: the static grid) through `grid_sample`, border
        padding for the logits and zeros for the density."""
        c = self.cfg
        dens = self._density(sdf_vol)
        if c.variant != 'vampire2':
            occ_logits = S.apply_sample_matrices(
                seg_vol,
                [getattr(self, f'occ_mat_border_{a}') for a in 'zyx'],
                (2, 3, 4))                               # (B, K, Z', Y', X')
            occ_density = S.apply_sample_matrices(
                dens, [getattr(self, f'occ_mat_zeros_{a}') for a in 'zyx'],
                (2, 3, 4))[:, 0]                         # (B, Z', Y', X')
            return (occ_logits.permute(0, 4, 3, 2, 1),
                    torch.tanh(occ_density.permute(0, 3, 2, 1)))
        if bda is not None:
            occ = G.rotate_occ_coords(self.occ_coords, bda)  # (B, X, Y, Z, 3)
        else:
            occ = self.occ_coords[None].expand(seg_vol.shape[0], -1, -1, -1,
                                               -1)
        norm = G.normalize_coords(occ, c.x_bound_seg, c.y_bound_seg,
                                  c.z_bound_seg)
        occ_logits = S.grid_sample_3d(seg_vol, norm, align_corners=True,
                                      padding_mode='border')
        occ_density = S.grid_sample_3d(dens, norm, align_corners=True,
                                       padding_mode='zeros')[..., 0]
        return occ_logits, torch.tanh(occ_density)

    def _render_bev(self, fused, base_vol):
        """BEV column renders over the det grid, z flipped (sky -> ground).
        Returns bev_rgb, bev_seg, bev_height, bev_density (B, Zd, Y, X) and
        vox_out (B, Cv, Zd, Y, X)."""
        c = self.cfg
        K = c.num_classes
        fused_bev = torch.cat([fused, base_vol], dim=1)
        vox = S.apply_sample_matrices(
            fused_bev, [getattr(self, f'det_mat_{a}') for a in 'zyx'],
            (2, 3, 4))
        vox = torch.flip(vox, dims=(2,))
        bev_density = self._density(vox[:, 0])
        bev_seg_l = vox[:, 1:K + 1].permute(0, 2, 3, 4, 1)
        bev_rgb_v = vox[:, K + 1:K + 4].permute(0, 2, 3, 4, 1)
        vox_out = vox[:, K + 4:]
        if c.cat_seg:
            vox_out = torch.cat([vox_out, vox[:, 1:K + 1]], dim=1)
        bev_rgb, bev_seg, bev_height = R.render_bev_columns(
            bev_density, bev_seg_l, bev_rgb_v, self.bev_mids,
            c.z_bound_det[2])
        return bev_rgb, bev_seg, bev_height, bev_density, vox_out

    def _ray_fields(self, fused):
        """One channels-last `sample_dtype` copy (Z, Y, X, C) of each
        frame's fused (C, Z, Y, X) field, the camera rays' input, with its
        voxels padded to 16 bytes (`ops.rays.channels_last_field`). The
        gradient flows back through the copy."""
        fused_t = fused.to(self.sample_dtype)
        return [ray_ops.channels_last_field(fused_t[b])
                for b in range(fused.shape[0])]

    def _render_cameras(self, mats, fields, plain=False, diagnostics=None):
        """Camera-ray renders through the frames' channels-last fields
        (`_ray_fields`), x4 upsampled: rgb (B, N, H, W, 3), seg logits
        (B, N, H, W, K), depth (B, N, H, W), with (H, W) = feat_hw *
        upsample_factor.

        The sampler is the JAX package's choice: in train mode with
        `ray_pass_fracs` set, the compact sampler (the march on
        `R.compact_valid`'s validity); in eval mode with `ray_et_fracs` set,
        the early-termination sampler (`ray_ops.render_rays_earlyterm`,
        forward only), whose coverage diagnostic, summed over the frames,
        goes into `diagnostics['ray_et_uncovered_drops']`; the dense march
        otherwise. Where the layout splits the cameras, the rays are this
        rank's cameras', the two pass samplers sort each frame's rays over
        the cam group (`parallel.mesh.ray_split`) and the diagnostic is the
        group's sum."""
        c = self.cfg
        K = c.num_classes
        Snum = self.frustum.shape[0] - 1    # samples: all planes but the last
        n_pass = -(-Snum // c.ray_chunk)
        n_et_pass = -(-Snum // c.ray_et_chunk)
        if c.ray_pass_fracs and len(c.ray_pass_fracs) != n_pass:
            raise ValueError(
                f'ray_pass_fracs has {len(c.ray_pass_fracs)} entries but the '
                f'ray axis makes {n_pass} passes (S={Snum}, chunk='
                f'{c.ray_chunk}); re-measure the curve or set () to disable')
        if c.ray_et_fracs and \
                len(c.ray_et_fracs) != n_et_pass - c.ray_et_prefix:
            raise ValueError(
                f'ray_et_fracs has {len(c.ray_et_fracs)} entries but needs '
                f'{n_et_pass - c.ray_et_prefix} (S={Snum}, chunk='
                f'{c.ray_et_chunk}, prefix={c.ray_et_prefix}); set () to '
                f'disable')
        geom = G.get_geometry(self.frustum, mats['sensor2ego'],
                              mats['intrin'], mats['ida'], mats.get('bda'))
        coords, valid, delta = ray_inputs(geom, c)
        B, N, _, fh, fw = geom.shape[:5]
        use_compact = bool(self.training and c.ray_pass_fracs)
        use_et = bool((not self.training) and c.ray_et_fracs)
        split = ray_split(self.layout)
        outs, drops = [], []
        for b, f in enumerate(fields):
            args = (f, coords[b],
                    (R.compact_valid(valid[b], c.ray_chunk, c.ray_pass_fracs,
                                     split)
                     if use_compact else valid[b]),
                    delta[b], self.camera_mids, c.d_bound[1], c.density_mode,
                    self.density_beta, c.sdf_bias)
            if use_et:
                out, diag = ray_ops.render_rays_earlyterm(
                    *args, c.ray_et_chunk, c.ray_et_prefix, c.ray_et_fracs,
                    c.ray_et_tau, plain, split)
                drops.append(diag)
            else:
                out = ray_ops.render_rays(*args, plain)
            outs.append(out)
        if use_et and diagnostics is not None:
            drops = torch.stack(drops).sum()
            if split is not None:
                drops = all_reduce_sum(drops, self.layout.cam_group)
            diagnostics['ray_et_uncovered_drops'] = drops
        out = torch.stack(outs).reshape(B, N, fh, fw, K + 4)
        up = c.upsample_factor
        size = (fh * up, fw * up)
        rgb = S.resize_linear(out[..., :3], size, (2, 3))
        seg = S.resize_linear(out[..., 3:K + 3], size, (2, 3))
        depth = S.resize_linear(out[..., K + 3:], size, (2, 3))[..., 0]
        return rgb, seg, depth

    # ------------------------------------------------------------------
    def forward(self, imgs: torch.Tensor, mats: Dict[str, torch.Tensor],
                points: Optional[torch.Tensor] = None,
                camera_renders: bool = True,
                plain: bool = False,
                diagnostics: Optional[dict] = None
                ) -> Dict[str, Optional[torch.Tensor]]:
        """Forward in the module's mode: `model.train()` is the JAX
        package's train=True (BN on batch statistics outside the frozen
        stem), `eval()` its train=False. The forward is differentiable: the
        two kernels' ops carry their backward kernels.

        Args:
          imgs: (B, N, H, W, 3) normalized images (channels-last), or
            (B, F, N, H, W, 3) with F frames, frame 0 the key frame (the
            loader's multi-sweep layout): the F*N views go through the
            encoder and the lift together (at most
            `ops.lift.MAX_CAMERAS` of them), the camera renders use the key
            frame's matrices. F = 1 gives the 5-D input's outputs bit for
            bit.
          mats: 'sensor2ego'/'intrin'/'ida' (B, N, 4, 4), or (B, F, N, 4, 4)
            with a 6-D imgs, and 'bda' (B, 4, 4).
          points: optional (B, P, 3) padded ego-frame query points.
          camera_renders: also render the camera rays through the frame's
            field, as the JAX package does by default and as training needs;
            False is the metrics graph, whose outputs carry None for the
            camera renders.
          plain: run the plain PyTorch versions of the kernels (lift, rays),
            forward and backward, instead of the kernels. Only
            a caller comparing the two on a card sets it; on the CPU both
            are the plain versions.
          diagnostics: a dict to receive the lift's `lift_dropped_blocks`
            (see `lift`) and, where the early-termination sampler runs,
            `ray_et_uncovered_drops` (see `_render_cameras`); None asks for
            nothing and costs nothing.

        Returns the JAX package's output dict. The camera-ray branch takes
        the JAX package's sampler: the compact one in train mode with
        `ray_pass_fracs` set, the early-termination one in eval mode with
        `ray_et_fracs` set, the dense one otherwise (`_render_cameras`).
        """
        c = self.cfg
        if imgs.dim() == 6:
            B, F, N = imgs.shape[:3]
            imgs = imgs.reshape(B, F * N, *imgs.shape[3:])
            lift_mats = dict(mats, **{k: mats[k].reshape(B, F * N, 4, 4)
                                      for k in VIEW_KEYS})
            key_mats = dict(mats, **{k: mats[k][:, 0] for k in VIEW_KEYS})
        else:
            lift_mats = key_mats = mats
        B, NT, H, W, _ = imgs.shape                  # NT = F * N views
        if NT > lift_ops.MAX_CAMERAS:
            raise ValueError(f'{NT} views a frame (frames x cameras): the '
                             f'lift kernel sums at most '
                             f'{lift_ops.MAX_CAMERAS}')
        x = imgs.reshape(B * NT, H, W, 3).permute(0, 3, 1, 2)
        with profiling.span('model.encoder'):
            feats = self.img_neck(self.img_backbone(x.to(self.dtype)))
        h, w = feats.shape[2:]
        with profiling.span('model.lift'):
            depth = None
            if c.variant != 'bilinear':
                depth = torch.softmax(
                    self.mapping_along_depth(feats).to(torch.float32), dim=1)
                depth = depth.to(self.dtype).reshape(B, NT, -1, h, w)
            low = self.channel_lower(feats).permute(0, 2, 3, 1)
            low = low.reshape(B, NT, h, w, -1)
            voxel_feats = self.lift(depth, low, lift_mats, plain,
                                    diagnostics)                  # fp32
            if c.cat_pos:
                pos = self.norm_voxel_coords[None].expand(B, -1, -1, -1, -1)
                voxel_feats = torch.cat([voxel_feats, pos], dim=1)
        with profiling.span('model.trunk'):
            base = self.base_conv(voxel_feats.to(self.dtype))
            sdf_vol = self.density_conv(base).to(torch.float32)
            seg_vol = self.seg_conv(base).to(torch.float32)
            rgb_in = (self.feature_conv(base) if c.variant == 'bilinear'
                      else base)
            rgb_vol = torch.sigmoid(self.rgb_conv(rgb_in).to(torch.float32))
            fused = torch.cat([sdf_vol, seg_vol, rgb_vol], dim=1)

        with profiling.span('model.queries'):
            pts_logits = pts_sdf = None
            if points is not None:
                pts_logits, pts_sdf = self._query_points(fused, points)
            occ_logits, occ_density = self._query_occ(seg_vol, sdf_vol,
                                                      mats.get('bda'))
        rgb_p = seg_p = depth_p = None
        if camera_renders:
            with profiling.span('model.rays'):
                rgb_p, seg_p, depth_p = self._render_cameras(
                    key_mats, self._ray_fields(fused), plain, diagnostics)
        with profiling.span('model.bev'):
            (bev_rgb, bev_seg, bev_height, bev_density,
             vox_out) = self._render_bev(fused, base.to(torch.float32))

            # BEV feature for the det head; channel order c*Zd+z
            gate = (torch.tanh(bev_density) if c.density_mode == 'sdf'
                    else bev_density)
            vo = vox_out * gate[:, None]                # (B, Cv, Zd, Y, X)
            Bv, Cv, Zd, Yd, Xd = vo.shape
            bev_feat = self.voxel_output(vo.reshape(Bv, Cv * Zd, Yd, Xd))
            _, oY, oX = c.grid_zyx('det')
            if oY == 256:
                bev_feat = S.resize_linear(bev_feat, (oY // 2, oX // 2),
                                           (2, 3))

        return dict(
            bev_feature=bev_feat.permute(0, 2, 3, 1),  # (B, Y', X', C)
            rgb_preds=rgb_p,                           # (B, N, H, W, 3)
            seg_logits_preds=seg_p,                    # (B, N, H, W, K)
            depth_preds=depth_p,                       # (B, N, H, W)
            bev_rgb_preds=bev_rgb,                     # (B, Y, X, 3)
            bev_seg_logits_preds=bev_seg,              # (B, Y, X, K)
            bev_height_preds=bev_height,               # (B, Y, X)
            bev_density=bev_density,                   # (B, Zd, Y, X)
            pts_logits=pts_logits,                     # (B, P, K) or None
            pts_sdf=pts_sdf,                           # (B, P) or None
            occ_logits=occ_logits,                     # (B, X, Y, Z, K)
            occ_density=occ_density,                   # (B, X, Y, Z)
        )
