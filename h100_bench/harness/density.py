"""The density head of a run's weights, fitted on the reference before
the program is built, as `chip_smoke.py`'s `partly_opaque_density` fits
it on the program: from the sdf field of one forward of the plain fp32
reference with the run's weights, sampled along every camera ray of the
first frame, the density conv's weight is scaled so that the sdf's spread
over the in-range samples is 2 beta, and its bias is bisected so that the
median ray is half opaque.

The random-init bias (sdf_bias - 10) saturates every ray at its first
sample, so renders, their gradients and the occupancy density would test
that sample only; one fixed head for every seed does not do either,
because the sdf's spread and offset move with the seed (weight scales
0.044 to 0.114 and biases -0.48 to -0.01 over three seeds). The fit runs
once a run; both sides then load the same weights."""
from __future__ import annotations

import gc
from typing import Dict

import torch

from reference.core import geometry as G
from reference.core import rendering as R
from reference.core import sampling as S
from reference.models.field import ray_inputs


def sdf_along_rays(sdf_vol, coords, valid):
    """(R, S) sdf of each ray sample (a plain grid_sample of the (1, D, H,
    W) sdf channel, zeros padding), masked by `valid`."""
    Rn, Sn = valid.shape
    s = S.grid_sample_3d(sdf_vol[None].float(), coords.reshape(1, -1, 3),
                         True, 'zeros')
    return s.reshape(Rn, Sn) * valid


def ray_opacity(sdf, delta, bc, beta):
    """Each ray's opacity 1 - exp(-sum density * delta), and the share of
    rays in (0.05, 0.95)."""
    sd = R.density(sdf, bc.density_mode, beta, bc.sdf_bias) * delta
    opacity = 1.0 - torch.exp(-sd.sum(-1))
    partial = ((opacity > 0.05) & (opacity < 0.95)).float().mean().item()
    return opacity, partial


@torch.no_grad()
def fit(model, inputs, train: bool) -> Dict[str, float]:
    """{'weight_scale', 'bias', 'partial'} of the model's density head on
    `inputs` (imgs, mats, points), the forward in train mode (batch
    statistics) or eval mode."""
    imgs, mats, points = inputs
    bb = model.backbone
    bc = bb.cfg
    got = {}
    hook = bb.density_conv.register_forward_hook(
        lambda m, i, o: got.setdefault('sdf', o.detach()))
    model.train(train)
    try:
        model(imgs, mats, points=points, camera_renders=False)
    finally:
        hook.remove()
    geom = G.get_geometry(bb.frustum, mats['sensor2ego'][:1],
                          mats['intrin'][:1], mats['ida'][:1],
                          mats['bda'][:1])
    coords, valid, delta = (t[0] for t in ray_inputs(geom, bc))
    bias0 = bb.density_conv.bias.detach().float()
    u = sdf_along_rays(got['sdf'][0].float() - bias0, coords, valid)
    beta = bb.density_beta.detach()
    scale = 2.0 * (beta.abs().item() + 1e-4) / u[valid > 0].std().item()
    lo, hi = -100.0, 100.0
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        op, _ = ray_opacity((scale * u + mid) * valid, delta, bc, beta)
        lo, hi = (mid, hi) if op.median().item() > 0.5 else (lo, mid)
    bias = 0.5 * (lo + hi)
    partial = ray_opacity((scale * u + bias) * valid, delta, bc, beta)[1]
    return dict(weight_scale=scale, bias=bias, partial=partial)


def fit_for_run(ctx, frames_, train: bool) -> Dict[str, float]:
    """The run's density head: the reference with the run's weights (the
    head left at its init), BN calibrated on the run's calibration frame
    for an eval-mode fit, one forward of `frames_`. Frees what it used."""
    from . import refrun
    from .calib import calibrate_batchnorm_
    refrun.fp32_exact()
    spec = dict(ctx.weight_spec, density_head=None)
    model = refrun.build(ctx.rcfg, ctx.device, ctx.weights(spec))
    if not train:
        calibrate_batchnorm_(model, refrun.served_inputs(
            [ctx.calib_frame()], ctx.device))
    out = fit(model, refrun.served_inputs(frames_, ctx.device), train)
    del model
    gc.collect()
    if ctx.cuda:
        torch.cuda.empty_cache()
    return out
