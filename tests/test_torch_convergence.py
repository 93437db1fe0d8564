"""The convergence study of the port (`tools/convergence_study.py`) against
the JAX package's recipe, the port's overfit test, and the train step's
default.

(a) 5 steps of `convergence_study.run` at `tiny_config` over 2 consistent
scenes, in fp32 on the CPU, against the same loop built from the JAX
package's `create_train_state` / `build_train_step` (the loop of
`scripts/convergence_study.py`, whose `main` writes into scripts/ and is
not run). Both start from the JAX init carried across by
`weights.from_flax`, and both sample an fp32 field (the JAX model through
the subclass of test_torch_train_step.py), as the one-step test does.
(b) The tool's detection eval on the JAX weights after those 5 steps,
against the JAX chain (decode_preds -> apply_circle_nms ->
DetNuscEvaluator). (c) The port's counterpart of tests/test_overfit.py,
the port alone. (e) `tools/multisweep_ab.py`'s arms against the JAX
script's (`scripts/multisweep_ab.py`, whose `main` writes into scripts/ and
is not run). (h) `build_train_step(cfg)(state, batch)` returns
(state, logs), as the JAX step does by default.

JAX is imported inside the CPU fixtures, so that the card's machine (no
JAX) collects this file: `pytest --noconftest -m gpu` runs its `gpu` cases.
"""
import dataclasses
import inspect
import json
import os

import numpy as np
import pytest
import torch

from vampire_tpu_torch.data.synthetic import consistent_batch, tiny_config
from vampire_tpu_torch.models.vampire import Vampire
from vampire_tpu_torch.tools import convergence_study as C
from vampire_tpu_torch.tools import multisweep_ab as MS
from vampire_tpu_torch.training import train_state as tts
from vampire_tpu_torch.training.train_step import (build_train_step,
                                                   init_train_confusion)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 5
N_BATCHES = 2
# each step's log against JAX's, relative to max(|JAX|, 1e-3): measured at
# most 3.5e-6 over the 5 steps (grad_norm; the loss terms <= 1.7e-6); the
# one-step test holds a step to 1e-4, and so does this over 5
TRAJ_RTOL = 1e-4
# the decoded, NMS'd boxes (x, y, z, w, l, h, yaw, vx, vy) and scores of
# the same weights: the forwards differ by fp32 sum orders only (measured:
# 42 boxes a scene, at most 1.3e-5 apart, scores 2.4e-7)
BOX_ATOL = 1e-4
SCORE_ATOL = 1e-5
# held-out losses after 2 steps an arm on one scene, relative to
# max(|JAX|, 1e-3), fp32 fields on both sides. Measured: the F=2 arm from
# the study's init 9.7e-8; an F=1 arm from another init 1.8e-7 at init,
# 6.7e-6 after one step and 3.1e-4 after two: AdamW's first steps move
# each element by ~lr x sign(m), so elements whose gradient is fp32 noise
# move by lr either way, and a second step on the same scene amplifies
# that. A mapping or mask fault is O(1)
AB_RTOL = 2e-3
CPU = torch.device('cpu')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread for the port's CPU work in this file: under the
    parallel test run each worker's 8 OpenMP threads wait on each other's
    descheduled ones, and a tiny train step took ~25 s instead of ~0.4."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_loop(cfg, batches, steps):
    """The JAX study's loop in fp32 on the CPU: init from PRNGKey(0),
    create_train_state(steps_per_epoch=steps), build_train_step; returns
    the init variables, the history of C.KEYS and the state after."""
    import jax
    import jax.numpy as jnp
    from vampire_tpu.models.centerpoint_head import BEVDepthHead
    from vampire_tpu.models.field import FieldBackbone as JaxFieldBackbone
    from vampire_tpu.models.vampire import Vampire as JaxVampire
    from vampire_tpu.training.train_state import create_train_state
    from vampire_tpu.training.train_step import (build_train_step as jstep,
                                                 split_mats)

    class JaxF32(JaxVampire):
        def setup(self):
            self.backbone = JaxFieldBackbone(
                self.backbone_cfg, dtype=self.dtype,
                sample_dtype=jnp.float32, name='backbone')
            self.head = BEVDepthHead(self.head_cfg, name='head')

    jm = JaxF32(cfg.backbone, cfg.head, dtype=jnp.float32)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    v = jax.device_get(jax.jit(lambda: jm.init(
        jax.random.PRNGKey(0), jb[0]['imgs'], split_mats(jb[0]),
        points=jb[0]['points'], train=True))())
    state, tx = create_train_state(v['params'], v['batch_stats'], cfg.train,
                                   steps_per_epoch=steps)
    step = jax.jit(jstep(jm, cfg, tx, num_devices=1))
    hist = {k: [] for k in C.KEYS}
    for i in range(steps):
        state, logs = step(state, jb[i % len(jb)])
        for k in C.KEYS:
            hist[k].append(float(logs[k]))
    return jm, v, hist, jax.device_get(state)


def _port_model(cfg, variables):
    from vampire_tpu_torch.weights import from_flax
    tm = Vampire(cfg.backbone, cfg.head, dtype=torch.float32)
    tm.backbone.sample_dtype = torch.float32
    tm.load_state_dict(from_flax(variables, tm), strict=True)
    return tm


@pytest.fixture(scope='module')
def study():
    from vampire_tpu.data.synthetic import consistent_batch as jax_batch
    cfg = tiny_config()
    batches = [jax_batch(cfg, batch_size=1, n_points=cfg.train.max_points,
                         seed=i, mode='train') for i in range(N_BATCHES)]
    jm, v, jhist, jstate = _jax_loop(cfg, batches, STEPS)
    rec = C.run(cfg, STEPS, N_BATCHES, device='cpu', dtype=torch.float32,
                model=_port_model(cfg, v), log=lambda msg: None)
    return dict(cfg=cfg, batches=batches, jm=jm, jhist=jhist, jstate=jstate,
                rec=rec, jinit=v)


@pytest.mark.parametrize('key', C.KEYS)
def test_trajectory_matches_jax(study, key):
    """(a) Each step's value of each logged key, within TRAJ_RTOL of JAX's;
    the first step's loss is the JAX init's own."""
    got = np.asarray(study['rec']['history'][key])
    want = np.asarray(study['jhist'][key])
    assert got.shape == want.shape == (STEPS,)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TRAJ_RTOL * max(np.abs(want).max(), 1e-3),
                               err_msg=key)


def test_seeded_init_matches_the_jax_init_statistics(study):
    """The study's own weights (`new_model`: `init_params_`, seed 0) are
    drawn as the JAX init draws them: per tensor, the std within 0.8-1.25
    of the JAX init's (PRNGKey(0)) and the means within 0.05 + 0.2 std
    (measured: all 492 tensors of tiny_config inside). A wrong initializer
    scale would change how the density leaves its saturated init."""
    from vampire_tpu_torch.weights import from_flax
    cfg = study['cfg']
    want = from_flax(study['jinit'], Vampire(cfg.backbone, cfg.head))
    got = C.new_model(cfg, CPU, torch.float32).state_dict()
    assert set(got) == set(want) and len(got) > 400
    for k, w in want.items():
        g, w = got[k].double(), w.double()
        if w.numel() > 1:
            gs, ws = g.std().item(), w.std().item()
            assert (gs == ws == 0.0) or 0.8 < gs / ws < 1.25, (k, gs, ws)
        else:
            gs = ws = abs(w.item())
        assert abs(g.mean() - w.mean()) <= 0.05 + 0.2 * max(gs, ws), k


def test_record_has_the_jax_schema(study):
    """The record reads beside scripts/convergence_study.json: its keys,
    the summary's keys and fields, the history's keys, and the summary as
    the JAX script computes it (first and last n_avg means, rounded)."""
    with open(os.path.join(ROOT, 'scripts', 'convergence_study.json')) as f:
        jrec = json.load(f)
    rec = study['rec']
    assert set(jrec) <= set(rec)
    assert set(rec['summary']) == set(jrec['summary']) == set(C.KEYS)
    assert set(rec['history']) == set(jrec['history'])
    assert set(rec['det_eval']) == set(jrec['det_eval'])
    assert set(rec['det_eval']['car_ap']) == set(jrec['det_eval']['car_ap'])
    n_avg = max(1, min(10, STEPS // 5))
    for k in C.KEYS:
        h = study['jhist'][k]
        first = sum(h[:n_avg]) / n_avg
        last = sum(h[-n_avg:]) / n_avg
        s = rec['summary'][k]
        assert set(s) == {'first', 'last', 'ratio'}
        np.testing.assert_allclose([s['first'], s['last']],
                                   [round(first, 4), round(last, 4)],
                                   atol=1.5e-4, err_msg=k)
    assert rec['steps'] == STEPS and rec['batches'] == N_BATCHES
    assert len(rec['step_ms']) == len(rec['launches']) == STEPS
    # on CPU tensors the wrappers run their plain versions: no launch
    assert rec['launches'] == [{}] * STEPS and rec['eval_launches'] == {}
    json.dumps(rec)


@pytest.fixture(scope='module')
def detections(study):
    """The port's and the JAX chain's boxes and metrics on the JAX weights
    after the 5 steps."""
    import jax
    from vampire_tpu.evaluation.det_evaluator import (
        DetNuscEvaluator, apply_circle_nms as jax_nms)
    from vampire_tpu.models.centerpoint_head import decode_preds
    from vampire_tpu.training.train_step import split_mats
    import jax.numpy as jnp
    import tempfile

    cfg, jm, jstate = study['cfg'], study['jm'], study['jstate']
    batches = study['batches']

    @jax.jit
    def det_step(params, batch_stats, batch):
        _, preds = jm.apply({'params': params, 'batch_stats': batch_stats},
                            batch['imgs'], split_mats(batch),
                            points=batch['points'], train=False)
        return decode_preds(preds, cfg.head)

    jres, metas, gts = [], [], {}
    for i, b in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        out = jax.device_get(det_step(jstate.params, jstate.batch_stats, jb))
        jres.append(jax_nms(out, cfg.head, 0))
        metas.append(dict(token=f'scene{i}',
                          ego2global_rotation=[1.0, 0.0, 0.0, 0.0],
                          ego2global_translation=[0.0, 0.0, 0.0]))
        gts[f'scene{i}'] = C.gt_dicts(b['gt_boxes_list'][0])
    classes = [c for t in cfg.head.tasks for c in t]
    with tempfile.TemporaryDirectory() as wd:
        detail = DetNuscEvaluator(class_names=classes, output_dir=wd
                                  ).evaluate(jres, metas, gt_boxes=gts)
    tm = _port_model(cfg, {'params': jstate.params,
                           'batch_stats': jstate.batch_stats})
    tres = C.detections(tm, cfg, batches, torch.device('cpu'))
    return dict(cfg=cfg, batches=batches, jres=jres, tres=tres,
                jdetail=detail, tscore=C.score(tres, batches, cfg))


def test_detections_match_jax(detections):
    """(b) The same boxes, scores and labels per scene after decode and
    circle NMS. No argmax or NMS near-tie moved a box here: the top-k
    scores are apart by far more than the forwards' difference."""
    n = 0
    for (tb, ts, tl), (jb, js, jl) in zip(detections['tres'],
                                          detections['jres']):
        assert len(tb) == len(jb) and len(tb) > 0
        np.testing.assert_array_equal(tl, np.asarray(jl))
        np.testing.assert_allclose(ts, np.asarray(js), atol=SCORE_ATOL)
        np.testing.assert_allclose(tb, np.asarray(jb), atol=BOX_ATOL)
        n += len(tb)
    assert n > 0


def test_detection_metrics_match_jax(detections):
    """(b) The tool's det_eval dict against the JAX evaluator's numbers on
    the JAX chain's boxes: the same APs, errors, mAP and NDS."""
    pfx = 'img_bbox_NuScenes'
    got, d = detections['tscore'], detections['jdetail']
    want = dict(car_ap={th: d[f'{pfx}/car_AP_dist_{th}']
                        for th in ('0.5', '1.0', '2.0', '4.0')},
                car_trans_err=d[f'{pfx}/car_trans_err'],
                car_scale_err=d[f'{pfx}/car_scale_err'],
                car_orient_err=d[f'{pfx}/car_orient_err'],
                mAP=d[f'{pfx}/mAP'], NDS=d[f'{pfx}/NDS'])
    for k, v in want.items():
        if k == 'car_ap':
            for th in v:
                np.testing.assert_allclose(got[k][th], v[th], atol=1e-4,
                                           err_msg=th)
        else:
            np.testing.assert_allclose(got[k], v, atol=1e-4, err_msg=k)
    assert got['n_gt_boxes'] == sum(len(b['gt_boxes_list'][0])
                                    for b in detections['batches'])
    assert got['n_pred_boxes'] == sum(len(r[0]) for r in detections['jres'])


def test_overfit_single_batch():
    """(c) tests/test_overfit.py on the port alone: 40 steps of one
    consistent batch with loss_weights (1, 1, 0, 1, 1), lr 8e-3 and the
    clip at 10; the total falls below 0.7 of its start, each term's last-5
    mean below max(0.95 x, x - 1e-4) of its first-5 max x, and the frozen
    stem is bit-unchanged."""
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, loss_weights=(1., 1., 0., 1., 1.),
        basic_lr_per_img=1e-3 * 8, gradient_clip_val=10.0,
        compute_dtype='float32'))
    torch.manual_seed(0)
    model = C.new_model(cfg, torch.device('cpu'), torch.float32)
    batch = C.to_device(consistent_batch(cfg, batch_size=1, n_points=128,
                                         seed=0), 'cpu')
    state = tts.create_train_state(model, cfg.train, steps_per_epoch=10_000)
    stem = model.backbone.img_backbone.stem
    stem0 = {k: v.clone() for k, v in stem.state_dict().items()}
    step = build_train_step(cfg)
    terms = ['detection_loss', 'camera_depth_loss', 'camera_seg_loss',
             'bev_seg_loss', 'bev_height_loss', 'pts_seg_loss',
             'visible_occ_seg_loss', 'visible_occ_density_loss',
             'invisible_occ_density_loss', 'sdf_loss']
    losses, hist = [], {k: [] for k in terms}
    for _ in range(40):
        state, logs = step(state, batch)
        losses.append(float(logs['total_loss']))
        for k in terms:
            hist[k].append(float(logs[k]))
    assert np.isfinite(losses).all()
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < 0.7 * first, (first, last, losses[::8])
    for k in terms:
        f, l = np.max(hist[k][:5]), np.mean(hist[k][-5:])
        assert l < max(0.95 * f, f - 1e-4), (k, f, l, hist[k][::8])
    for k, v in stem.state_dict().items():
        assert torch.equal(v, stem0[k]), k


# ---------------------------------------------------------------------------
# (e) the multi-sweep A/B
# ---------------------------------------------------------------------------

def _jax_f2_arm(cfg, jm, variables, steps):
    """The F=2 arm of scripts/multisweep_ab.py (fp32 field), 1 + 1 scenes,
    from `variables`: each held-out loss."""
    import jax
    import jax.numpy as jnp
    from vampire_tpu.data.synthetic import consistent_batch
    from vampire_tpu.training.losses import compute_losses
    from vampire_tpu.training.train_state import create_train_state
    from vampire_tpu.training.train_step import build_train_step, split_mats

    def make(seed):
        b = consistent_batch(cfg, batch_size=1,
                             n_points=cfg.train.max_points, n_boxes=4,
                             seed=seed, mode='train', sweep_offsets=(0.6,))
        return {k: jnp.asarray(v) for k, v in b.items()
                if k != 'gt_boxes_list'}

    train, val = make(0), make(100)
    model = jm
    state, tx = create_train_state(variables['params'],
                                   variables['batch_stats'], cfg.train,
                                   steps_per_epoch=steps)
    step = jax.jit(build_train_step(model, cfg, tx, num_devices=1))
    for _ in range(steps):
        state, _ = step(state, train)

    @jax.jit
    def val_losses(params, batch_stats, batch):
        fo, preds = model.apply({'params': params,
                                 'batch_stats': batch_stats},
                                batch['imgs'], split_mats(batch),
                                points=batch['points'], train=False)
        _, logs = compute_losses(fo, preds, batch, cfg.train, cfg.head,
                                 cfg.backbone.sdf_bias,
                                 cfg.backbone.density_mode)
        return {k: logs[k] for k in MS.VAL_KEYS}

    logs = val_losses(state.params, state.batch_stats, val)
    return {k: float(logs[k]) for k in MS.VAL_KEYS}


def test_multisweep_f2_arm_matches_jax(study):
    """(e) The F=2 arm (a key frame and a sweep, 12 views), 2 steps on
    scene 0, its held-out losses on scene 100, from the JAX init carried
    across, against the JAX arm. The F=1 arm runs the train step of (a)
    and the same held-out function at 6 views; its JAX compile is not
    repeated here."""
    cfg = study['cfg']
    want = _jax_f2_arm(cfg, study['jm'], study['jinit'], 2)
    arm = MS.run_arm(cfg, True, 2, 1, 1, CPU,
                     model=_port_model(cfg, study['jinit']),
                     log=lambda msg: None)
    assert len(arm['train_total']) == 2
    for k in MS.VAL_KEYS:
        got = arm['val_per_scene'][k][0]
        np.testing.assert_allclose(got, want[k], rtol=0,
                                   atol=AB_RTOL * max(abs(want[k]), 1e-3),
                                   err_msg=k)
        assert arm['val'][k] == round(got, 4)


def test_multisweep_record():
    """The tool's record at 1 step an arm: the JAX record's keys, finite
    held-out losses and f2_over_f1 = f2 / f1 rounded to 3 places; the F=2
    arm's batches carry two frames."""
    out = MS.run(steps=1, train_scenes=1, val_scenes=1, device='cpu',
                 log=lambda msg: None)
    assert {'steps', 'f1', 'f2', 'f2_over_f1'} <= set(out)
    for k in MS.VAL_KEYS:
        assert np.isfinite(out['f1'][k]) and np.isfinite(out['f2'][k])
        assert out['f2_over_f1'][k] == round(out['f2'][k] / out['f1'][k], 3)
    cfg = tiny_config()
    assert MS.make(cfg, 0, True)['imgs'].ndim == 6
    assert MS.make(cfg, 0, False)['imgs'].ndim == 5


def test_train_step_default_returns_state_and_logs():
    """(h) The JAX package's default: build_train_step(cfg)(state, batch)
    -> (state, logs); with_metrics=True adds the confusions."""
    from vampire_tpu.training.train_step import build_train_step as jstep
    assert (inspect.signature(build_train_step).parameters['with_metrics']
            .default is False
            is inspect.signature(jstep).parameters['with_metrics'].default)
    cfg = tiny_config()
    model = C.new_model(cfg, torch.device('cpu'), torch.float32)
    batch = C.to_device(consistent_batch(cfg, batch_size=1, n_points=128,
                                         seed=1), 'cpu')
    state = tts.create_train_state(model, cfg.train, steps_per_epoch=1)
    out = build_train_step(cfg)(state, batch)
    assert len(out) == 2 and out[0] is state
    assert set(C.KEYS) <= set(out[1])
    out = build_train_step(cfg, with_metrics=True)(
        state, batch, init_train_confusion(cfg))
    assert len(out) == 3 and all(c.sum() > 0 for c in out[2])
    assert state.step == 2


def test_run_refuses_a_missing_card():
    """device='cuda' without a card raises; it never falls back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='no CUDA card'):
        C.run(tiny_config(), 1, 1, device='cuda')


@pytest.mark.gpu
def test_flagship_study_on_gpu():
    """On the card: 3 flagship steps in bf16 over 2 consistent scenes,
    every logged value finite, each step launching the lift and the rays
    once forward and once backward and the corner table never; the eval
    launches the lift once a scene; a det_eval with the JAX record's
    keys."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from vampire_tpu_torch.configs import flagship_config
    rec = C.run(flagship_config(), 3, 2, device='cuda',
                log=lambda msg: None)
    for k in C.KEYS:
        assert np.isfinite(rec['history'][k]).all(), k
    for launched in rec['launches']:
        assert launched == dict(lift=1, lift_bwd=1, rays=1, rays_bwd=1)
    assert rec['eval_launches'] == dict(lift=2)
    assert set(rec['det_eval']['car_ap']) == {'0.5', '1.0', '2.0', '4.0'}
