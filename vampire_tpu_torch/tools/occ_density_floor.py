"""The occ-density terms' floor: what the best representable field and the
all-free field score on them; the port of `scripts/occ_density_floor.py`.

The convergence study's two occ-density terms fall only to ~0.61 of their
start while every other term falls below 0.16. This tells "slow but
correct" from "wrong scale or mask":

  1. The oracle floor. Each study scene's true occupancy (the ground plane
     and the car boxes) is rasterised onto the field grid, scaled to a few
     amplitudes, and pushed through the model's own occ query (the
     separable sample matrices of `core/sampling.py`, then tanh) to score
     the two masked MSE terms against the scene's labels. The occ lattice
     is checked against the field's: they share the 0.4 m pitch, so the
     query selects field centres and does not blur.
  2. The all-free baseline: the terms of density 0 everywhere (the
     occupied share of the visible and invisible voxels).
  3. The study's converged values, from a convergence JSON (`--study`):
     by default this port's own record
     (`tools/convergence_study.py`'s default --out), or the JAX package's
     `scripts/convergence_study.json` given by path.

The verdict: converged <= 1.5 x floor is at the floor; floor << converged
< all-free is under-trained but correct; above all-free, the flagship's
loss_weights[4] = 0 leaves the density terms as monitors that nothing
optimises. `--lw4-check` runs the mechanism probe (`lw4_check`).

Usage (the card unless --device cpu):
  python -m vampire_tpu_torch.tools.occ_density_floor \\
      [--study build/studies/convergence_study.json] [--lw4-check] \\
      [--out build/studies/occ_density_floor.json] [--device cuda]
"""
import argparse
import dataclasses
import json
import os

import numpy as np

from .convergence_study import DEFAULT_OUT as STUDY_OUT
from .convergence_study import require_device

DEFAULT_OUT = os.path.join('build', 'studies', 'occ_density_floor.json')
SEEDS = (0, 1, 2, 3)              # the study's --batches 4 scenes
AMPLITUDES = (2.0, 3.0, 5.0, 10.0)


def _norm1d(centers, bound):
    return (centers - bound[0]) / (bound[1] - bound[0]) * 2.0 - 1.0


def lattice(cfg):
    """The field's and the occ grid's centres, the occ lattice's largest
    offset from a field centre per axis, and the occ query's three (out,
    size) sample matrices (z, y, x; zeros padding), as the model's lss
    occ query builds them."""
    from ..core import geometry as G
    from ..core import sampling as S
    bc = cfg.backbone
    Zs, Ys, Xs = bc.grid_zyx('seg')
    zc = G.centers_of(bc.z_bound_seg)
    yc = G.centers_of(bc.y_bound_seg)
    xc = G.centers_of(bc.x_bound_seg)
    occ_c = G.make_occ_coords(bc.occ_pc_range, bc.occ_voxel_size, bc.occ_grid)
    occ_x, occ_y = occ_c[:, 0, 0, 0], occ_c[0, :, 0, 1]
    occ_z = occ_c[0, 0, :, 2]

    def offgrid(q, centers):
        d = np.abs(q[:, None] - centers[None, :]).min(1)
        return float(d[(q >= centers.min()) & (q <= centers.max())].max())

    align = dict(x=offgrid(occ_x, xc), y=offgrid(occ_y, yc),
                 z=offgrid(occ_z, zc))
    mats = (S.make_sample_matrix(_norm1d(occ_z, bc.z_bound_seg), Zs, True,
                                 'zeros'),
            S.make_sample_matrix(_norm1d(occ_y, bc.y_bound_seg), Ys, True,
                                 'zeros'),
            S.make_sample_matrix(_norm1d(occ_x, bc.x_bound_seg), Xs, True,
                                 'zeros'))
    return dict(centers=(zc, yc, xc), align=align, mats=mats)


def query_density(dens_vol, mats):
    """(1, Z, Y, X) field density -> (1, gx, gy, gz) tanh'd occ density,
    the model's static occ query."""
    import torch
    from ..core import sampling as S
    m = [torch.as_tensor(x, device=dens_vol.device) for x in mats]
    out = S.apply_sample_matrices(dens_vol[..., None], m, (1, 2, 3))[..., 0]
    return torch.tanh(out.permute(0, 3, 2, 1))


def masked_mse(pred, labels, mask):
    m = mask.astype(np.float64)
    return float(((labels - pred) ** 2 * m).sum() / max(m.sum(), 1.0))


def occupancy_on_field(cfg, centers, boxes):
    """(Z, Y, X) float32: the field centres inside the scene, the ground
    voxels |z| <= vz / 2 and the scene's boxes."""
    from ..data.synthetic import _points_in_box
    zc, yc, xc = centers
    gz, gy, gx = np.meshgrid(zc, yc, xc, indexing='ij')
    fpts = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)
    occ = np.abs(fpts[:, 2]) <= cfg.backbone.occ_voxel_size[2] / 2.0
    for box in boxes:
        occ |= _points_in_box(fpts.astype(np.float32), box)
    return occ.reshape(gz.shape).astype(np.float32)


def seed_floor(cfg, seed, lat, dev):
    """One study scene's all-free and oracle terms (the best amplitude's,
    by the sum of the two)."""
    import torch
    from ..data.synthetic import consistent_batch
    b = consistent_batch(cfg, batch_size=1, n_points=4096, n_boxes=8,
                         seed=seed, mode='train')
    labels = b['occ_density_labels'][0].astype(np.float64)
    vis = b['mask_camera'][0]
    invis = ~vis
    occ_field = torch.as_tensor(
        occupancy_on_field(cfg, lat['centers'], b['gt_boxes_list'][0]),
        device=dev)
    row = dict(seed=seed,
               vis_frac_occupied=masked_mse(0.0, labels, vis),
               invis_frac_occupied=masked_mse(0.0, labels, invis))
    best = (np.inf, np.inf, None)
    for A in AMPLITUDES:
        pred = query_density(A * occ_field[None], lat['mats'])[0]
        pred = pred.cpu().numpy()
        v = masked_mse(pred, labels, vis)
        iv = masked_mse(pred, labels, invis)
        if v + iv < best[0] + best[1]:
            best = (v, iv, A)
    row.update(oracle_vis=best[0], oracle_invis=best[1],
               oracle_amplitude=best[2])
    return row


def verdict(converged_vis, oracle_vis, all_free_vis):
    if converged_vis <= oracle_vis * 1.5:
        return 'converged-at-floor'
    if converged_vis < all_free_vis:
        return 'under-trained-but-correct (floor << converged < all-free)'
    return ('monitor-only term sits above the all-free baseline: EXPECTED '
            '- flagship loss_weights[4] = 0 (reference parity), the density '
            'terms are logged but not optimized; density is learned only '
            'through the depth-render/bev/det paths. Run --lw4-check for '
            'the direct-gradient proof.')


def floor(cfg, dev, log=print):
    """The lattice check and each seed's floor, and their means."""
    lat = lattice(cfg)
    per_seed = []
    for seed in SEEDS:
        row = seed_floor(cfg, seed, lat, dev)
        per_seed.append(row)
        log(f'seed {seed}: all-free vis {row["vis_frac_occupied"]:.4f} '
            f'invis {row["invis_frac_occupied"]:.4f} | oracle (A='
            f'{row["oracle_amplitude"]}) vis {row["oracle_vis"]:.4f} '
            f'invis {row["oracle_invis"]:.4f}')

    def mean(k):
        return float(np.mean([r[k] for r in per_seed]))

    return dict(lattice_alignment_max_offset_m=lat['align'],
                lattices_aligned=max(lat['align'].values()) < 1e-4,
                per_seed=per_seed,
                mean=dict(all_free_vis=mean('vis_frac_occupied'),
                          all_free_invis=mean('invis_frac_occupied'),
                          oracle_vis=mean('oracle_vis'),
                          oracle_invis=mean('oracle_invis')))


def lw4_check(dev, log=print):
    """The mechanism behind the 0.61 ratio, at tiny_config with
    loss_weights (1, 1, 0, 0, 1), at the reference's init (the density
    bias sdf_bias - 10, so sdf ~ -11): the Laplace density saturates at
    alpha = 1/beta = 10 everywhere and occ_density = tanh(10) = 1 with
    d tanh / dx ~ 8e-9, so the density MSE's gradient into density_conv is
    zero, and so is the camera-depth term's; the one live handle is the
    learnable beta, whose camera-depth gradient is small but nonzero, and
    Adam turns any nonzero gradient into lr-sized steps. The asserts pin
    that mechanism, not a convergence target."""
    import torch
    from ..data.synthetic import consistent_batch, tiny_config
    from ..training.losses import compute_losses, masked_mean
    from ..training.train_step import split_mats
    from .convergence_study import new_model, to_device

    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, loss_weights=(1.0, 1.0, 0.0, 0.0, 1.0)))
    b = consistent_batch(cfg, batch_size=1, n_points=cfg.train.max_points,
                         n_boxes=2, seed=0, mode='train')
    batch = to_device(b, dev)
    model = new_model(cfg, dev, torch.float32)
    model.eval()
    labels = np.asarray(b['occ_density_labels'][0], np.float64)
    vis = np.asarray(b['mask_camera'][0])
    all_free = float((labels ** 2 * vis).sum() / max(vis.sum(), 1))
    bb = model.backbone

    def term_grad(term):
        fo, preds = model(batch['imgs'], split_mats(batch),
                          points=batch['points'])
        if term == 'vis_density':
            d = fo['occ_density'].reshape(-1).float()
            lab = batch['occ_density_labels'].reshape(-1)
            loss = masked_mean((lab - d) ** 2,
                               batch['mask_camera'].reshape(-1))
        else:
            _, logs = compute_losses(fo, preds, batch, cfg.train, cfg.head,
                                     cfg.backbone.sdf_bias,
                                     cfg.backbone.density_mode)
            loss = logs[term]
        conv = list(bb.density_conv.parameters())
        g = torch.autograd.grad(loss, conv + [bb.density_beta],
                                allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x
             for p, x in zip(conv + [bb.density_beta], g)]
        conv_norm = float(torch.sqrt(sum((x.float() ** 2).sum()
                                         for x in g[:-1])))
        return conv_norm, float(g[-1].abs().sum())

    with torch.no_grad():
        fo, _ = model(batch['imgs'], split_mats(batch),
                      points=batch['points'])
    dmin = float(fo['occ_density'].abs().min())
    g_dens, _ = term_grad('vis_density')
    g_depth_conv, g_depth_beta = term_grad('camera_depth_loss')
    log(f'lw4-check (mechanism): occ_density at init min|tanh| = {dmin:.6f}'
        f' (saturated at 1.0); density_conv grad norms: vis-density-MSE '
        f'{g_dens:.3e}, camera-depth {g_depth_conv:.3e}; camera-depth '
        f'grad wrt learnable beta {g_depth_beta:.3e}; all-free baseline '
        f'{all_free:.4f}')
    assert dmin > 0.999, dmin            # saturated everywhere at init
    assert g_dens < 1e-6, g_dens         # the MSE gradient is dead,
    assert g_depth_conv < 1e-4, g_depth_conv   # and the render path's too
    assert g_depth_beta > 1e-8, g_depth_beta   # beta: the one live handle
    return dict(all_free=round(all_free, 4),
                init_min_abs_tanh=round(dmin, 6),
                grad_norm_vis_density=g_dens,
                grad_norm_camera_depth_conv=g_depth_conv,
                grad_camera_depth_beta=g_depth_beta,
                note='density terms desaturate only through the learnable '
                     'Laplace beta at the reference init (tanh(alpha=10)); '
                     'their convergence is rate-limited by beta dynamics')


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--study', default=STUDY_OUT,
                    help='a convergence JSON (this port\'s or the JAX '
                         'package\'s scripts/convergence_study.json)')
    ap.add_argument('--lw4-check', action='store_true')
    ap.add_argument('--out', default=DEFAULT_OUT)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    from ..configs import flagship_config
    from ..serving.server import set_fp32_precision

    dev = require_device(args.device)
    if dev.type == 'cuda':
        set_fp32_precision()
    out = floor(flagship_config(), dev)
    out['study'] = args.study
    study = {}
    if os.path.exists(args.study):
        with open(args.study) as f:
            s = json.load(f)['summary']
        study = dict(vis=s['visible_occ_density_loss']['last'],
                     invis=s['invisible_occ_density_loss']['last'])
    else:
        print(f'no study at {args.study}: no verdict')
    out['study_converged'] = study
    if study:
        out['verdict'] = verdict(study['vis'], out['mean']['oracle_vis'],
                                 out['mean']['all_free_vis'])
        print('verdict:', out['verdict'])
    if args.lw4_check:
        out['lw4_check'] = lw4_check(dev)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(out, f, indent=1)
    print('wrote', args.out)
    return out


if __name__ == '__main__':
    main()
