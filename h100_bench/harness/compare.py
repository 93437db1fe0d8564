"""The numbers that decide `correct`, and their judgment against the
cell's limits (`limits/<cell>.json`: each number's limit, set from the
readings PERF.md gives).

Served frames (the metrics graph), each the worst frame of the sample:
the relative L2 gap of the program's occupancy logits and point logits
to the reference's; `density_gap`, the median over the voxels whose
reference occupancy density is neither empty nor saturated (1e-4 to 0.99)
of the relative gap of that density (in the density's exponential tail
the gap is the sdf's error over beta, which a relative L2 over all voxels
weighs by how many voxels each seed's field puts near the knee); and
`det_gap`, the score mass of the boxes (after circle NMS) that find no
box of the same class within 0.5 m and 0.1 of score on the other side,
over the score mass of both sides.

Training, every number over the first step or the checked steps, and
infinite where a side lost rows: `forward_gap`, the relative L2 gap of
the first step's occupancy logits (its train-mode forward over the
batch's rows); `render_gap`, the larger relative L2 gap of that forward's
camera depth and semantic renders (the compact ray march); `heatmap_gap`,
that of the det head's heatmaps, every task's together; `grad_gap`, the
median over the leaves of the gap between the norms of the first
gradient before the global clip (AdamW's first moment after step 1 over
1 - b1, times each side's own clip scale), each over the larger of the
reference leaf's norm and the median leaf's; and `update_gap`, the same
median of the parameters' change after the checked steps, over the
leaves whose reference gradient is at least a thousandth of the median
leaf's (the others move by round-off alone). The median leaf, and not
the worst: at some seeds single leaves of the bf16 program's first
gradient part from the fp32 reference's by 60 % to 100 % while the
median leaf stays within 2 % (PERF.md gives both readings, by module
group, from `train_diagnostics`). The losses are reported and not
compared: a step's loss gap does not separate the control, nor a loss
over half the rows, from sound runs at every seed (PERF.md)."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

BOX_DIST_M = 0.5
BOX_SCORE = 0.1
DENSITY_RANGE = (1e-4, 0.99)
FLAT_LEAF = 1e-3


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def det_gap(prog, ref, dist_m: float = BOX_DIST_M,
            score_tol: float = BOX_SCORE) -> float:
    """Unmatched score mass over all score mass, boxes matched greedily by
    score: same label, centres within `dist_m`, scores within
    `score_tol`."""
    (pb, ps, pl), (rb, rs, rl) = prog, ref
    pb, ps, pl = (np.asarray(x) for x in (pb, ps, pl))
    rb, rs, rl = (np.asarray(x) for x in (rb, rs, rl))
    total = float(ps.sum() + rs.sum())
    if total == 0.0:
        return 0.0
    free = np.ones(len(rs), bool)
    matched = 0.0
    for i in np.argsort(-ps, kind='stable'):
        d = np.hypot(rb[:, 0] - pb[i, 0], rb[:, 1] - pb[i, 1])
        ok = (free & (rl == pl[i]) & (d <= dist_m)
              & (np.abs(rs - ps[i]) <= score_tol))
        if ok.any():
            j = np.flatnonzero(ok)[np.argmin(d[ok])]
            free[j] = False
            matched += float(ps[i] + rs[j])
    return (total - matched) / total


def density_gap(prog, ref) -> float:
    p = np.asarray(prog, np.float64).ravel()
    r = np.asarray(ref, np.float64).ravel()
    live = (r > DENSITY_RANGE[0]) & (r < DENSITY_RANGE[1])
    if not live.any():
        return 0.0
    return float(np.median(np.abs(p[live] - r[live]) / r[live]))


def serve_numbers(prog: List[dict], ref: List[dict]) -> Dict[str, float]:
    out = dict(occ_gap=0.0, density_gap=0.0, points_gap=0.0, det_gap=0.0)
    for p, r in zip(prog, ref):
        out['occ_gap'] = max(out['occ_gap'],
                             rel_l2(p['occ_logits'], r['occ_logits']))
        out['density_gap'] = max(out['density_gap'],
                                 density_gap(p['occ_density'],
                                             r['occ_density']))
        out['points_gap'] = max(out['points_gap'],
                                rel_l2(p['pts_logits'], r['pts_logits']))
        out['det_gap'] = max(out['det_gap'], det_gap(p['det'], r['det']))
    return out


def _leaf_gaps(prog, ref, keep=None, signed=False) -> np.ndarray:
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    if keep is not None:
        prog, ref = prog[keep], ref[keep]
    gap = (prog - ref) / np.maximum(ref, np.median(ref))
    return gap if signed else np.abs(gap)


def _moving(ref) -> np.ndarray:
    return ref['grad'] >= FLAT_LEAF * np.median(ref['grad'])


def unclipped(side: dict) -> np.ndarray:
    """Each leaf's norm of the first gradient before the global clip."""
    return side['grad'] * max(1.0, side['grad_norm'] / side['clip'])


def _gap(prog, ref, key) -> float:
    p, r = prog[key], ref[key]
    return rel_l2(p, r) if p.shape == r.shape else float('inf')


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    if prog['names'] != ref['names']:
        raise ValueError('the program and the reference train different '
                         'leaves')
    return dict(
        forward_gap=_gap(prog, ref, 'occ0'),
        render_gap=max(_gap(prog, ref, 'depth0'), _gap(prog, ref, 'seg0')),
        heatmap_gap=_gap(prog, ref, 'heat0'),
        grad_gap=float(np.median(_leaf_gaps(unclipped(prog),
                                            unclipped(ref)))),
        update_gap=float(np.median(_leaf_gaps(prog['change'], ref['change'],
                                              _moving(ref)))))


GROUPS = (('encoder', ('backbone.img_backbone', 'backbone.img_neck')),
          ('lift', ('backbone.mapping_along_depth',
                    'backbone.channel_lower')),
          ('trunk', ('backbone.base_conv',)),
          ('field', ('backbone.',)),
          ('head', ('head.',)))


def group_of(name: str) -> str:
    return next(g for g, pre in GROUPS if name.startswith(pre))


def _by_group(names, gaps) -> Dict[str, list]:
    """Each module group's worst leaf: [name, gap]."""
    out = {}
    for n, v in zip(names, gaps):
        g = group_of(n)
        if g not in out or v > out[g][1]:
            out[g] = [n, float(v)]
    return out


def train_diagnostics(prog: dict, ref: dict) -> Dict[str, object]:
    """What the compared numbers leave out: every step's loss gap, each
    loss term's at the first step, and each module group's worst leaf of
    the first gradient and of the change."""
    g = _leaf_gaps(unclipped(prog), unclipped(ref))
    keep = _moving(ref)
    c = _leaf_gaps(prog['change'], ref['change'], keep)
    names = np.asarray(ref['names'])
    return dict(
        loss_gaps=(np.abs(prog['loss'] - ref['loss'])
                   / np.abs(ref['loss'])).tolist(),
        worst_grad=_by_group(names, g),
        worst_change=_by_group(names[keep], c),
        flat_leaves=int((~keep).sum()),
        grad_norms=[prog['grad_norm'], ref['grad_norm']],
        term_gaps={k: abs(prog['terms'][k] - ref['terms'][k])
                   / max(abs(ref['terms'][k]), 1e-30)
                   for k in ref['terms']},
        depth_gap=_gap(prog, ref, 'depth0'),
        seg_gap=_gap(prog, ref, 'seg0'))


def serve_diagnostics(prog: List[dict], ref: List[dict]) -> Dict[str, float]:
    """What the compared numbers were chosen over: `det_gap` at tighter
    tolerances and the density's relative L2 gap."""
    return dict(
        det_gap_tight=max(det_gap(p['det'], r['det'], 0.2, 0.02)
                          for p, r in zip(prog, ref)),
        det_gap_05=max(det_gap(p['det'], r['det'], 0.5, 0.05)
                       for p, r in zip(prog, ref)),
        density_l2=max(rel_l2(p['occ_density'], r['occ_density'])
                       for p, r in zip(prog, ref)))


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """Every number at or under its limit (a NaN or a missing number is
    not); returns (correct, {name: {value, limit}})."""
    if set(numbers) != set(limits):
        raise ValueError(f'numbers {sorted(numbers)} against limits '
                         f'{sorted(limits)}')
    ok = all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
             for k in limits)
    # a number that could not be read (a request of the sample that never
    # came) is null in the result line, which JSON allows
    return ok, {k: dict(value=numbers[k] if math.isfinite(numbers[k])
                        else None, limit=limits[k])
                for k in sorted(limits)}
