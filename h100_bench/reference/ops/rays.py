"""The camera rays in plain torch: the march of `core.rendering` as a
differentiable op.

A frozen copy of the plain versions of the program's ray op. `render_rays`
runs `core.rendering.sample_and_composite_rays_field_reference` forward and
`..._backward_reference` backward (both per frame, no kernel);
`channels_last_field` is the channels-last view of a (C, D, H, W) volume
that the march reads.
"""
from __future__ import annotations

import torch

from ..core.rendering import (
    sample_and_composite_rays_field_backward_reference,
    sample_and_composite_rays_field_reference)


class ChannelsLastField(torch.autograd.Function):
    """(C, D, H, W) -> a contiguous (D, H, W, C) copy; the backward
    permutes the gradient back."""

    @staticmethod
    def forward(ctx, vol):
        return vol.permute(1, 2, 3, 0).contiguous()

    @staticmethod
    def backward(ctx, g):
        return g.permute(3, 0, 1, 2).contiguous()


def channels_last_field(vol: torch.Tensor) -> torch.Tensor:
    return ChannelsLastField.apply(vol)


class RenderRays(torch.autograd.Function):
    """The march with its plain backward: gradients reach the field (summed
    in fp32, cast to the field's dtype) and `beta`; the geometry takes
    none."""

    @staticmethod
    def forward(ctx, field, beta, coords, valid, deltas, mids, bg_depth,
                density_mode, sdf_bias):
        out = sample_and_composite_rays_field_reference(
            field, coords, valid, deltas, mids, bg_depth, density_mode, beta,
            sdf_bias)
        ctx.save_for_backward(field, beta, coords, valid, deltas, mids)
        ctx.args = (bg_depth, density_mode, sdf_bias)
        return out

    @staticmethod
    def backward(ctx, g_out):
        field, beta, coords, valid, deltas, mids = ctx.saved_tensors
        bg_depth, density_mode, sdf_bias = ctx.args
        d_field, d_beta = sample_and_composite_rays_field_backward_reference(
            field, coords, valid, deltas, mids, bg_depth, density_mode, beta,
            sdf_bias, g_out.contiguous())
        return ((d_field.to(field.dtype), d_beta.reshape(beta.shape))
                + (None,) * 7)


def render_rays(field, coords, valid, deltas, mids, bg_depth, density_mode,
                beta, sdf_bias, plain=True):
    """Differentiable march: (R, 3 + K + 1) fp32 [rgb | seg | depth] per
    ray. `plain` is accepted for the field's call and ignored."""
    del plain
    return RenderRays.apply(field, beta, coords, valid, deltas, mids,
                            bg_depth, density_mode, sdf_bias)
