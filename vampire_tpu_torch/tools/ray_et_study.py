"""Derive the early-termination cap schedule (`BackboneConfig.ray_et_fracs`)
from scene statistics; the port of `scripts/ray_et_study.py`.

For each synthetic street scene (a ground plane, walls or boxes at
plausible depths, open sky) the study computes each camera ray's carried
optical depth sd(s) under the flagship geometry (the real frustum, the
eval-mode rig) and the Laplace density, then, at each early-termination
pass boundary, the share of the rays that must still be marched:

    demand_j = mean( NOT exited(s_j)  AND  sd(s_j) < tau )

The schedule is the worst case over the scene family plus a margin
(x 1.10 + 0.02), so a ray the schedule drops carries sd >= tau (its
remaining transmittance <= exp(-tau)) unless the scene is far outside this
family. The study also says whether the shipped schedule covers the
demand at cfg.backbone.ray_et_tau: the config's `ray_et_fracs` when set,
else the opt-in schedule that the config documents (the JAX study's worst
case + 10 %), which the flagship leaves off.

Scene family (termination-hostile on purpose):
  * 'open'   - ground only: every ray above the horizon is sky and never
               saturates; about the worst realistic case.
  * 'suburb' - ground and sparse low boxes.
  * 'urban'  - ground and dense tall walls: most rays end early.
  * 'fog'    - a uniform low density everywhere and ground (like an
               untrained net).

Geometry and density run on the device (the card unless --device cpu); the
scenes and the sums are numpy.

Usage:
  python -m vampire_tpu_torch.tools.ray_et_study [--out PATH] [--device cuda]
"""
import argparse
import json
import os

import numpy as np

from .convergence_study import require_device

SCENES = ('open', 'suburb', 'urban', 'fog')
RIG_SEEDS = (0, 1, 2)
TAUS = (5.0, 7.0, 9.0)
# the opt-in schedule of vampire_tpu/configs.py's ray_et_fracs comment
# (scripts/ray_et_study.py's worst case + 10 %), chip_smoke.py's ET_FRACS
DOCUMENTED_FRACS = (0.71, 0.47, 0.37, 0.14, 0.06, 0.03)


def build_scene(kind, rng, Z, Y, X, zb, yb, xb):
    """(Z, Y, X) float32 sdf volume, negative inside surfaces."""
    zs = zb[0] + (np.arange(Z) + 0.5) * zb[2]
    ys = yb[0] + (np.arange(Y) + 0.5) * yb[2]
    xs = xb[0] + (np.arange(X) + 0.5) * xb[2]
    zg, yg, xg = np.meshgrid(zs, ys, xs, indexing='ij')
    # signed distance to the ground plane at z = -1.8 (positive above)
    sdf = zg + 1.8
    if kind in ('suburb', 'urban'):
        n_obj = 25 if kind == 'suburb' else 120
        hmax = 2.5 if kind == 'suburb' else 25.0
        for _ in range(n_obj):
            cx = rng.uniform(xb[0], xb[1])
            cy = rng.uniform(yb[0], yb[1])
            if abs(cx) < 6 and abs(cy) < 6:
                continue  # keep the ego clear
            sx = rng.uniform(1.5, 12.0)
            sy = rng.uniform(1.5, 12.0)
            h = rng.uniform(1.0, hmax)
            inside = ((np.abs(xg - cx) < sx / 2)
                      & (np.abs(yg - cy) < sy / 2) & (zg < -1.8 + h))
            sdf = np.where(inside, np.minimum(sdf, -1.0), sdf)
    elif kind == 'fog':
        # an untrained net's haze: sdf drawn near the bias above ground
        sdf = np.minimum(sdf, rng.uniform(0.5, 3.0, sdf.shape))
    return sdf.astype(np.float32)


def passes(cfg):
    """(samples a ray Sn, chunk, prefix, early-termination passes n_et)."""
    from ..core.geometry import arange_bound
    c = cfg.backbone
    Sn = len(arange_bound(c.d_bound)) - 1
    chunk, prefix = c.ray_et_chunk, c.ray_et_prefix
    return Sn, chunk, prefix, -(-Sn // chunk) - prefix


def ray_samples(cfg, seed, dev):
    """One rig's rays, every 2nd pixel of each camera (1/4 of the rays, the
    same per-pass statistics): normalized sample coords (R, Sn, 3) and the
    sample spacings (R, Sn), numpy."""
    import torch
    from ..core import geometry as G
    from ..data.synthetic import camera_rig
    c = cfg.backbone
    frustum = torch.as_tensor(G.make_frustum(c.final_dim,
                                             c.downsample_factor, c.d_bound),
                              device=dev)
    Sn = frustum.shape[0] - 1
    rig = camera_rig(1, 6, c.final_dim, seed=seed)
    t = {k: torch.as_tensor(rig[k], device=dev)
         for k in ('sensor2ego', 'intrin', 'ida', 'bda')}
    geom = G.get_geometry(frustum, t['sensor2ego'], t['intrin'], t['ida'],
                          t['bda']).cpu().numpy()[0]     # (N, D, h, w, 3)

    def norm(i, b):
        return (geom[..., i] - b[0]) / (b[1] - b[0]) * 2 - 1

    coords = np.stack([norm(0, c.x_bound_seg), norm(1, c.y_bound_seg),
                       norm(2, c.z_bound_seg)], axis=-1)[:, :-1]
    delta = np.linalg.norm(geom[:, 1:] - geom[:, :-1], axis=-1)
    coords = coords[:, :, ::2, ::2]
    delta = delta[:, :, ::2, ::2]
    coords = np.moveaxis(coords, 1, 3).reshape(-1, Sn, 3)
    dl = np.moveaxis(delta, 1, 3).reshape(-1, Sn)
    return coords, dl


def scene_demand(cfg, sdf, coords, dl, dev):
    """One scene's demand at each pass boundary and tau ({tau: (n_et,)})
    and the share of the rays still inside the field there (n_et,)."""
    import torch
    from ..core import rendering as R
    c = cfg.backbone
    Z, Y, X = sdf.shape
    Sn, chunk, prefix, n_et = passes(cfg)
    valid = (np.abs(coords) <= 1.0).all(-1)
    # nearest-neighbour samples along the rays (statistics only: the
    # carried optical depth's curves, not exact field values)
    ix, iy, iz = (np.clip(np.rint((coords[..., a] + 1) / 2 * (n - 1)), 0,
                          n - 1).astype(np.int64)
                  for a, n in ((0, X), (1, Y), (2, Z)))
    samp = sdf[iz, iy, ix] * valid
    dens = R.laplace_density(torch.as_tensor(samp, device=dev),
                             torch.tensor(0.1, device=dev),
                             c.sdf_bias).cpu().numpy()
    sd = np.cumsum(dens * dl, axis=1)          # carried optical depth
    L = np.where(valid.any(1), Sn - valid[:, ::-1].argmax(1), 0)
    demand = {t: np.zeros(n_et) for t in TAUS}
    alive = np.zeros(n_et)
    for j in range(n_et):
        s_j = prefix * chunk + j * chunk        # first sample of pass j
        live = L > s_j
        alive[j] = live.mean()
        for t in TAUS:
            demand[t][j] = (live & (sd[:, max(s_j - 1, 0)] < t)).mean()
    return demand, alive


def schedule(demand):
    """The worst demand + 10 % + 0.02, capped at 1."""
    return np.minimum(1.0, np.asarray(demand) * 1.10 + 0.02)


def covers(fracs, need):
    """Whether the schedule `fracs` keeps at least the `need`ed share of
    the rays at every pass (one frac a pass)."""
    return len(fracs) == len(need) and all(f >= d for f, d in zip(fracs,
                                                                  need))


def study(cfg, dev, log=print):
    """The worst demand over the scene family and rigs at each tau, the
    schedule derived from it, its rows against the dense march, and
    whether the shipped schedule covers the demand at
    cfg.backbone.ray_et_tau."""
    c = cfg.backbone
    if c.ray_et_tau not in TAUS:
        raise ValueError(f'ray_et_tau {c.ray_et_tau} is not one of {TAUS}')
    Z, Y, X = c.grid_zyx('seg')
    Sn, chunk, prefix, n_et = passes(cfg)
    rng = np.random.RandomState(0)
    worst = {t: np.zeros(n_et) for t in TAUS}
    scenes = []
    for seed in RIG_SEEDS:
        coords, dl = ray_samples(cfg, seed, dev)
        for kind in SCENES:
            sdf = build_scene(kind, rng, Z, Y, X, c.z_bound_seg,
                              c.y_bound_seg, c.x_bound_seg)
            demand, alive = scene_demand(cfg, sdf, coords, dl, dev)
            for t in TAUS:
                worst[t] = np.maximum(worst[t], demand[t])
            scenes.append(dict(kind=kind, seed=seed, alive=alive.tolist(),
                               demand={str(t): demand[t].tolist()
                                       for t in TAUS}))
            log(f'scene {kind:7s} seed {seed}: alive-by-L '
                + ' '.join(f'{a:.3f}' for a in alive))
    log(f'Sn={Sn} chunk={chunk} prefix={prefix} n_et={n_et}')
    out = dict(Sn=Sn, chunk=chunk, prefix=prefix, n_et=n_et, taus=TAUS,
               scenes=scenes, worst={}, schedule={}, rows_x_dense={})
    for t in TAUS:
        sched = schedule(worst[t])
        rows = (prefix * chunk + chunk * sched.sum()) / Sn
        out['worst'][str(t)] = worst[t].tolist()
        out['schedule'][str(t)] = sched.tolist()
        out['rows_x_dense'][str(t)] = float(rows)
        log(f'tau={t}: worst demand {np.round(worst[t], 3)}')
        log(f'  schedule (+10%+0.02) {np.round(sched, 3).tolist()} '
            f'-> rows {rows:.2f}x dense')
    fracs = tuple(c.ray_et_fracs or DOCUMENTED_FRACS)
    tau = c.ray_et_tau
    need = worst[tau]
    ok = covers(fracs, need)
    out.update(fracs=list(fracs), tau=tau, covers=ok,
               margin=[float(f - d) for f, d in zip(fracs, need)])
    log(f'fracs {fracs} {"cover" if ok else "do NOT cover"} the worst '
        f'demand at tau={tau} (margins '
        f'{np.round(out["margin"], 3).tolist()})')
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--out', default=None)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    from ..configs import flagship_config
    from ..serving.server import set_fp32_precision
    dev = require_device(args.device)
    if dev.type == 'cuda':
        set_fp32_precision()
    out = study(flagship_config(), dev)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=1)
        print('wrote', args.out)
    return out


if __name__ == '__main__':
    main()
