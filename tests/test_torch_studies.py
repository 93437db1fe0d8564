"""The port's accuracy studies against the JAX package's computations on the
CPU: `tools/occ_density_floor.py` (d) and `tools/ray_et_study.py` (f); and
(g) every port module imports first in a fresh interpreter. (e), the
multi-sweep A/B, is in test_torch_convergence.py, beside the other tests
that compile a JAX train step.

The JAX side of each is the JAX script's computation rebuilt here from the
JAX package's own functions (`scripts/occ_density_floor.py` writes into
scripts/ from `main`, which is never run; `scripts/ray_et_study.py`'s
`build_scene` is loaded from the script).
JAX is imported inside the CPU tests, so that the card's machine (no JAX)
collects this file: `pytest --noconftest -m gpu` runs its `gpu` cases.
"""
import importlib.util
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import vampire_tpu_torch
from vampire_tpu_torch.configs import flagship_config
from vampire_tpu_torch.tools import multisweep_ab as MS
from vampire_tpu_torch.tools import occ_density_floor as OF
from vampire_tpu_torch.tools import ray_et_study as ET

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device('cpu')
# the floor's terms: the same labels and masks (all-free: equal), the
# oracle through fp32 matmuls summed in another order (measured 1.2e-9)
FLOOR_ATOL = 1e-7
# the rays' normalized sample coords and their spacings (m): the
# geometry's fp32 in another order (measured 4.8e-7 and 1.5e-5, on
# spacings of ~0.5-1 m)
COORD_ATOL = 1e-5
DL_ATOL = 5e-5
# the ET demand: a share of 16,896 rays; measured 0 apart (the geometry's
# fp32 differences move no nearest-neighbour sample here)
DEMAND_ATOL = 1e-9


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread for the port's CPU work in this file: under the
    parallel test run each worker's 8 OpenMP threads wait on each other's
    descheduled ones, and a tiny train step took ~25 s instead of ~0.4."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    path = os.path.join(ROOT, 'scripts', f'{name}.py')
    spec = importlib.util.spec_from_file_location(f'_jax_{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# (d) the occ-density floor
# ---------------------------------------------------------------------------

def _jax_floor(cfg, seed):
    """scripts/occ_density_floor.py's lattice check and one seed's row,
    through vampire_tpu.core.sampling and geometry."""
    import jax.numpy as jnp
    from vampire_tpu.core import geometry as G
    from vampire_tpu.core import sampling as S
    from vampire_tpu.data.synthetic import _points_in_box, consistent_batch
    bc = cfg.backbone
    Zs, Ys, Xs = bc.grid_zyx('seg')
    zc, yc, xc = (G.centers_of(bc.z_bound_seg), G.centers_of(bc.y_bound_seg),
                  G.centers_of(bc.x_bound_seg))
    occ_c = G.make_occ_coords(bc.occ_pc_range, bc.occ_voxel_size, bc.occ_grid)
    occ_x, occ_y = occ_c[:, 0, 0, 0], occ_c[0, :, 0, 1]
    occ_z = occ_c[0, 0, :, 2]

    def offgrid(q, centers):
        d = np.abs(q[:, None] - centers[None, :]).min(1)
        return float(d[(q >= centers.min()) & (q <= centers.max())].max())

    align = dict(x=offgrid(occ_x, xc), y=offgrid(occ_y, yc),
                 z=offgrid(occ_z, zc))

    def norm1d(c, b):
        return (c - b[0]) / (b[1] - b[0]) * 2.0 - 1.0
    mats = tuple(S.make_sample_matrix(norm1d(q, b), n, True, 'zeros')
                 for q, b, n in ((occ_z, bc.z_bound_seg, Zs),
                                 (occ_y, bc.y_bound_seg, Ys),
                                 (occ_x, bc.x_bound_seg, Xs)))

    def mse(pred, labels, mask):
        m = mask.astype(np.float64)
        return float(((labels - pred) ** 2 * m).sum() / max(m.sum(), 1.0))

    b = consistent_batch(cfg, batch_size=1, n_points=4096, n_boxes=8,
                         seed=seed, mode='train')
    labels = b['occ_density_labels'][0].astype(np.float64)
    vis = b['mask_camera'][0]
    gz, gy, gx = np.meshgrid(zc, yc, xc, indexing='ij')
    fpts = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)
    occ = np.abs(fpts[:, 2]) <= bc.occ_voxel_size[2] / 2.0
    for box in b['gt_boxes_list'][0]:
        occ |= _points_in_box(fpts.astype(np.float32), box)
    occ_field = occ.reshape(Zs, Ys, Xs).astype(np.float32)
    row = dict(vis_frac_occupied=mse(0.0, labels, vis),
               invis_frac_occupied=mse(0.0, labels, ~vis))
    best = (np.inf, np.inf, None)
    for A in OF.AMPLITUDES:
        vol = jnp.asarray(A * occ_field[None])[..., None]
        out = S.apply_sample_matrices(vol, mats, (1, 2, 3))[..., 0]
        pred = np.asarray(jnp.tanh(jnp.transpose(out, (0, 3, 2, 1))))[0]
        v, iv = mse(pred, labels, vis), mse(pred, labels, ~vis)
        if v + iv < best[0] + best[1]:
            best = (v, iv, A)
    row.update(oracle_vis=best[0], oracle_invis=best[1],
               oracle_amplitude=best[2])
    return align, mats, row


def test_occ_floor_matches_jax():
    """(d) Seed 0 of the study: the lattice offsets, the sample matrices,
    the all-free and the oracle terms and the oracle's amplitude, against
    the same computation through the JAX package."""
    cfg = flagship_config()
    jalign, jmats, jrow = _jax_floor(cfg, 0)
    lat = OF.lattice(cfg)
    assert lat['align'] == jalign
    for got, want in zip(lat['mats'], jmats):
        np.testing.assert_array_equal(got, np.asarray(want))
    row = OF.seed_floor(cfg, 0, lat, CPU)
    assert row['oracle_amplitude'] == jrow['oracle_amplitude']
    assert row['vis_frac_occupied'] == jrow['vis_frac_occupied']
    assert row['invis_frac_occupied'] == jrow['invis_frac_occupied']
    for k in ('oracle_vis', 'oracle_invis'):
        np.testing.assert_allclose(row[k], jrow[k], rtol=0, atol=FLOOR_ATOL,
                                   err_msg=k)
    # the floor lies far below the all-free baseline, as the record says
    assert row['oracle_vis'] < 0.2 * row['vis_frac_occupied']


def test_occ_floor_verdicts():
    """The three readings of a converged value against the floor and the
    all-free baseline, and the JAX record's own reading."""
    assert OF.verdict(0.01, 0.0075, 0.065) == 'converged-at-floor'
    assert OF.verdict(0.03, 0.0075, 0.065).startswith('under-trained')
    assert OF.verdict(0.1573, 0.0075, 0.065).startswith('monitor-only')


def test_lw4_check_pins_the_mechanism():
    """`--lw4-check` on the CPU: occ_density saturated at init, the
    density MSE's and the camera-depth term's gradients into density_conv
    zero, beta's nonzero (the function asserts these)."""
    out = OF.lw4_check(CPU, log=lambda msg: None)
    assert out['init_min_abs_tanh'] > 0.999
    assert out['grad_camera_depth_beta'] > 1e-8


# ---------------------------------------------------------------------------
# (f) the early-termination study
# ---------------------------------------------------------------------------

def _jax_demand(cfg, seed, kinds, build_scene):
    """scripts/ray_et_study.py's loop body for one rig seed and its scenes
    (the script's rng, seed 0, drawn in the script's order), through
    vampire_tpu's get_geometry and laplace_density."""
    import jax.numpy as jnp
    from vampire_tpu.core import geometry as G
    from vampire_tpu.core import rendering as R
    from vampire_tpu.data.synthetic import camera_rig
    c = cfg.backbone
    Z, Y, X = c.grid_zyx('seg')
    frustum = jnp.asarray(G.make_frustum(c.final_dim, c.downsample_factor,
                                         c.d_bound))
    Sn = frustum.shape[0] - 1
    chunk, prefix = c.ray_et_chunk, c.ray_et_prefix
    n_et = -(-Sn // chunk) - prefix
    rig = camera_rig(1, 6, c.final_dim, seed=seed)
    geom = np.asarray(G.get_geometry(
        frustum, jnp.asarray(rig['sensor2ego']), jnp.asarray(rig['intrin']),
        jnp.asarray(rig['ida']), jnp.asarray(rig['bda'])))[0]
    norm = np.stack([(geom[..., i] - b[0]) / (b[1] - b[0]) * 2 - 1
                     for i, b in enumerate((c.x_bound_seg, c.y_bound_seg,
                                            c.z_bound_seg))],
                    axis=-1)[:, :-1]
    delta = np.linalg.norm(geom[:, 1:] - geom[:, :-1], axis=-1)
    norm, delta = norm[:, :, ::2, ::2], delta[:, :, ::2, ::2]
    coords = np.moveaxis(norm, 1, 3).reshape(-1, Sn, 3)
    dl = np.moveaxis(delta, 1, 3).reshape(-1, Sn)
    valid = (np.abs(coords) <= 1.0).all(-1)
    rng = np.random.RandomState(0)
    out = {}
    for kind in kinds:
        sdf = build_scene(kind, rng, Z, Y, X, c.z_bound_seg, c.y_bound_seg,
                          c.x_bound_seg)
        ix = np.clip(np.rint((coords[..., 0] + 1) / 2 * (X - 1)), 0,
                     X - 1).astype(np.int64)
        iy = np.clip(np.rint((coords[..., 1] + 1) / 2 * (Y - 1)), 0,
                     Y - 1).astype(np.int64)
        iz = np.clip(np.rint((coords[..., 2] + 1) / 2 * (Z - 1)), 0,
                     Z - 1).astype(np.int64)
        samp = sdf[iz, iy, ix] * valid
        dens = np.asarray(R.laplace_density(jnp.asarray(samp), 0.1,
                                            c.sdf_bias))
        sd = np.cumsum(dens * dl, axis=1)
        L = np.where(valid.any(1), Sn - valid[:, ::-1].argmax(1), 0)
        demand = {t: np.zeros(n_et) for t in ET.TAUS}
        for j in range(n_et):
            s_j = prefix * chunk + j * chunk
            alive = L > s_j
            for t in ET.TAUS:
                demand[t][j] = (alive & (sd[:, max(s_j - 1, 0)] < t)).mean()
        out[kind] = (sdf, demand)
    return coords, dl, out


def test_et_demand_matches_jax():
    """(f) Rig seed 0, each scene kind: the scene volume the script builds
    (bit for bit), the rays' coords and spacings, and the demand at each
    pass and tau, against the script's computation through JAX."""
    cfg = flagship_config()
    script = _script('ray_et_study')
    jcoords, jdl, jout = _jax_demand(cfg, 0, ET.SCENES, script.build_scene)
    coords, dl = ET.ray_samples(cfg, 0, CPU)
    np.testing.assert_allclose(coords, jcoords, rtol=0, atol=COORD_ATOL)
    np.testing.assert_allclose(dl, jdl, rtol=0, atol=DL_ATOL)
    c = cfg.backbone
    Z, Y, X = c.grid_zyx('seg')
    rng = np.random.RandomState(0)
    n_et = ET.passes(cfg)[3]
    for kind in ET.SCENES:
        sdf = ET.build_scene(kind, rng, Z, Y, X, c.z_bound_seg,
                             c.y_bound_seg, c.x_bound_seg)
        jsdf, jdemand = jout[kind]
        np.testing.assert_array_equal(sdf, jsdf, err_msg=kind)
        demand, _ = ET.scene_demand(cfg, sdf, coords, dl, CPU)
        for t in ET.TAUS:
            assert demand[t].shape == (n_et,)
            np.testing.assert_allclose(demand[t], jdemand[t], rtol=0,
                                       atol=DEMAND_ATOL,
                                       err_msg=f'{kind} tau {t}')


def test_et_schedule_and_cover():
    """The schedule is the worst demand x 1.10 + 0.02 capped at 1; a
    schedule covers the demand when it keeps at least the demand's share
    at every pass, and has one frac a pass."""
    np.testing.assert_allclose(ET.schedule([0.5, 0.95, 0.0]),
                               [0.57, 1.0, 0.02])
    need = [0.625, 0.406, 0.312, 0.107, 0.035, 0.001]
    assert ET.covers(ET.DOCUMENTED_FRACS, need)
    assert not ET.covers(ET.DOCUMENTED_FRACS, [0.72] + need[1:])
    assert not ET.covers(ET.DOCUMENTED_FRACS[:5], need[:5] + [0.0])
    assert ET.passes(flagship_config())[3] == len(ET.DOCUMENTED_FRACS)


# ---------------------------------------------------------------------------
# (g) every module imports first
# ---------------------------------------------------------------------------

_IMPORT_EACH_FIRST = r"""
import importlib, sys
failed = []
for name in sys.argv[1:]:
    for m in [m for m in sys.modules
              if m.split('.')[0] == 'vampire_tpu_torch']:
        del sys.modules[m]
    try:
        importlib.import_module(name)
    except Exception as e:
        failed.append(f'{name}: {type(e).__name__}: {e}')
print('\n'.join(failed))
sys.exit(1 if failed else 0)
"""


def test_every_module_imports_first_in_a_fresh_interpreter():
    """(g) In a fresh interpreter, every module of vampire_tpu_torch
    imported with no other module of the port loaded (each time, the
    port's modules are dropped from sys.modules first; torch stays): an
    import cycle, as data/synthetic.py <-> configs.py was, fails here. The
    two modules of that cycle are also imported each in an interpreter of
    its own, and configs still gives camera_rig, synthetic_batch and
    tiny_config."""
    mods = ['vampire_tpu_torch'] + [
        m.name for m in pkgutil.walk_packages(vampire_tpu_torch.__path__,
                                              'vampire_tpu_torch.')]
    assert 'vampire_tpu_torch.data.synthetic' in mods
    assert 'vampire_tpu_torch.tools.convergence_study' in mods
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, '-c', _IMPORT_EACH_FIRST] + mods,
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    for code in ('from vampire_tpu_torch.data.synthetic import '
                 'consistent_batch',
                 'import vampire_tpu_torch.configs as c\n'
                 'from vampire_tpu_torch.configs import camera_rig, '
                 'synthetic_batch, tiny_config\n'
                 'assert c.tiny_config is tiny_config\n'
                 'assert not hasattr(c, "no_such_name")'):
        proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_studies_on_gpu():
    """On the card: the occ floor of one seed equals the CPU's (fp32
    matmuls, TF32 off), the ET demand of one scene equals the CPU's, and a
    1-step multi-sweep A/B gives finite held-out losses."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from vampire_tpu_torch.serving.server import set_fp32_precision
    set_fp32_precision()
    cuda = torch.device('cuda')
    cfg = flagship_config()
    lat = OF.lattice(cfg)
    got, want = OF.seed_floor(cfg, 0, lat, cuda), OF.seed_floor(cfg, 0, lat,
                                                                CPU)
    for k in ('oracle_vis', 'oracle_invis'):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    c = cfg.backbone
    Z, Y, X = c.grid_zyx('seg')
    coords, dl = ET.ray_samples(cfg, 0, cuda)
    sdf = ET.build_scene('open', np.random.RandomState(0), Z, Y, X,
                         c.z_bound_seg, c.y_bound_seg, c.x_bound_seg)
    d_gpu, _ = ET.scene_demand(cfg, sdf, coords, dl, cuda)
    d_cpu, _ = ET.scene_demand(cfg, sdf, coords, dl, CPU)
    for t in ET.TAUS:
        np.testing.assert_allclose(d_gpu[t], d_cpu[t], atol=1e-3)
    out = MS.run(steps=1, train_scenes=1, val_scenes=1, device='cuda',
                 log=lambda msg: None)
    for k in MS.VAL_KEYS:
        assert np.isfinite(out['f1'][k]) and np.isfinite(out['f2'][k])
