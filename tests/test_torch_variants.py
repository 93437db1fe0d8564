"""The port's other field variants, the dense lift and the multi-sweep input
against the JAX package.

For each of `vampire2`, `lss` and `bilinear`, `Vampire(tiny_config())` with
that variant is initialised in JAX, its BN statistics, BN affine parameters
and biases are randomised from numpy (as in test_torch_model.py), the
density bias is zeroed (the init's sdf_bias - 10 saturates every ray at its
first sample), and the weights are carried across with `weights.from_flax`.
Both sides sample an fp32 copy of the field (the JAX model through a
subclass with an fp32 corner table, the port through `sample_dtype`), so
that every output is compared at one tolerance. The frame's bda is a
rotation, a scale and a flip, which the lift, the renders and the
`vampire2` occupancy queries all read. Every output of the full-render
graph and the head's maps are compared in eval mode and in train mode (BN
on batch statistics).

Then, at the flagship variant: the dense lift (`lift_block=0`,
`lift_block_topk=0`, or a block that does not divide the grid) against the
JAX dense `_lift`; the 6-D multi-sweep input at F = 1 (bit-identical to
the 5-D input) and at F = 2 against JAX; a duplicated sweep against the
single frame; `compute_losses` on a 6-D batch; and the
`lift_dropped_blocks` diagnostic against the value the JAX lift sows. All
in fp32 on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampire_tpu.data.synthetic import camera_rig, synthetic_batch, tiny_config
from vampire_tpu.models.centerpoint_head import BEVDepthHead
from vampire_tpu.models.field import FieldBackbone as JaxFieldBackbone
from vampire_tpu.models.vampire import Vampire as JaxVampire
from vampire_tpu.training.losses import compute_losses as jax_losses
from vampire_tpu_torch.models.field import FieldBackbone
from vampire_tpu_torch.models.unet3d import ConvSoftplus3D, Unet3D
from vampire_tpu_torch.models.vampire import Vampire
from vampire_tpu_torch.training.losses import compute_losses
from vampire_tpu_torch.weights import from_flax

MATS = ('sensor2ego', 'intrin', 'ida', 'bda')
VIEW = ('sensor2ego', 'intrin', 'ida')
# fp32 on both sides, as test_torch_model.py: the two frameworks sum the
# convolutions, matmuls and gathers in different orders through ~30 layers;
# 1e-4 is ~1000 fp32 ulps of O(1) values, far below a mapping mistake's
# O(0.1-1)
RTOL = ATOL = 1e-4
# bilinear: both sides' intermediates agree to ~2e-6 of their magnitude as
# in the other variants (measured: channel_lower, base_conv, density_conv),
# but its lift averages the raw features, not depth-weighted ones, and its
# sdf field is ~3x theirs (max |sdf| 41 against 13); the Laplace density
# multiplies an sdf error by up to 1 / (2 beta^2) = 50 at its knee, which
# gives bev_density 1.1e-3 of 10. Its outputs are held to 2e-4 of each
# output's largest magnitude besides the 1e-4; a mapping mistake is O(1)
# of it.
SCALED_ATOL = dict(bilinear=2e-4)
OUT_KEYS = ('occ_logits', 'occ_density', 'pts_logits', 'pts_sdf',
            'bev_rgb_preds', 'bev_seg_logits_preds', 'bev_height_preds',
            'bev_density', 'bev_feature', 'rgb_preds', 'seg_logits_preds',
            'depth_preds')


class JaxVampireF32Table(JaxVampire):
    """The JAX model with an fp32 corner table (FieldBackbone.sample_dtype);
    parameter names and everything else as JaxVampire."""

    def setup(self):
        self.backbone = JaxFieldBackbone(self.backbone_cfg, dtype=self.dtype,
                                         sample_dtype=jnp.float32,
                                         name='backbone')
        self.head = BEVDepthHead(self.head_cfg, name='head')


def randomize(variables, seed=0):
    rng = np.random.RandomState(seed)

    def walk(tree, path=()):
        if hasattr(tree, 'items'):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        a = np.asarray(tree, np.float32)
        name = path[-1]
        if name == 'mean':
            return rng.normal(0.0, 0.2, a.shape).astype(np.float32)
        if name == 'var':
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == 'scale':
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        if name == 'bias':
            return (a + rng.normal(0.0, 0.1, a.shape)).astype(np.float32)
        return a
    return walk(variables)


def bda_matrix(rot_deg=15.0, scale=1.05):
    """A BEV augmentation: a rotation about z, a scale and a flip in y."""
    a = np.deg2rad(rot_deg)
    m = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                  [0.0, 0.0, 1.0]]) * scale
    m = np.diag([1.0, -1.0, 1.0]) @ m
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = m
    return out


def variant_cfg(variant, **bc):
    cfg = tiny_config()
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, variant=variant, **bc))


def train_batch(cfg, seed=0):
    b = synthetic_batch(cfg, batch_size=1, n_points=128, seed=seed,
                        mode='train')
    b['bda'] = bda_matrix()[None]
    return b


def jax_variables(cfg, batch):
    """Randomised JAX variables of JaxVampireF32Table with a zero density
    bias; returns (module, variables)."""
    jm = JaxVampireF32Table(cfg.backbone, cfg.head, dtype=jnp.float32)
    mats = {k: jnp.asarray(batch[k]) for k in MATS}
    v = jax.jit(lambda: jm.init(jax.random.PRNGKey(0),
                                jnp.asarray(batch['imgs']), mats,
                                points=jnp.asarray(batch['points']),
                                train=False))()
    variables = randomize(jax.device_get(v))
    variables['params']['backbone']['density_conv']['bias'] = np.zeros(
        1, np.float32)
    return jm, variables


def port_model(cfg, variables):
    tm = Vampire(cfg.backbone, cfg.head, dtype=torch.float32)
    tm.backbone.sample_dtype = torch.float32
    sd = from_flax(variables, tm)
    tm.load_state_dict(sd, strict=True)
    return tm, sd


def jax_forward(jm, variables, imgs, mats, points, train):
    def fwd(v):
        out = jm.apply(v, jnp.asarray(imgs),
                       {k: jnp.asarray(m) for k, m in mats.items()},
                       points=jnp.asarray(points), train=train,
                       mutable=['batch_stats'] if train else False)
        return out[0] if train else out
    return jax.device_get(jax.jit(fwd)(variables))


def port_forward(tm, imgs, mats, points, train, **kw):
    tm.train(train)
    with torch.no_grad():
        return tm(torch.from_numpy(np.asarray(imgs)),
                  {k: torch.from_numpy(np.asarray(m)) for k, m in mats.items()},
                  points=torch.from_numpy(np.asarray(points)), **kw)


def assert_outputs_match(got, want, scaled_atol=0.0):
    """Every output and head map within RTOL and ATOL, plus scaled_atol of
    its largest magnitude."""
    tfo, tpreds = got
    jfo, jpreds = want
    pairs = [(k, tfo[k].numpy(), np.asarray(jfo[k])) for k in OUT_KEYS]
    assert len(tpreds) == len(jpreds)
    for jp, tp in zip(jpreds, tpreds):
        assert set(jp) == set(tp)
        pairs += [(k, tp[k].numpy(), np.asarray(jp[k])) for k in jp]
    for k, g, w in pairs:
        assert g.shape == w.shape, k
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(
            g, w, rtol=RTOL, atol=ATOL + scaled_atol * np.abs(w).max(),
            err_msg=k)


@pytest.fixture(scope='module', params=['vampire2', 'lss', 'bilinear'])
def variant(request):
    cfg = variant_cfg(request.param)
    batch = train_batch(cfg)
    jm, variables = jax_variables(cfg, batch)
    mats = {k: batch[k] for k in MATS}
    args = (batch['imgs'], mats, batch['points'])
    tm, sd = port_model(cfg, variables)
    return dict(
        name=request.param, cfg=cfg, variables=variables, tm=tm, sd=sd,
        jax={mode: jax_forward(jm, variables, *args, mode == 'train')
             for mode in ('eval', 'train')},
        port={mode: port_forward(tm, *args, mode == 'train')
              for mode in ('eval', 'train')})


@pytest.mark.parametrize('mode', ['eval', 'train'])
def test_variant_forward_matches_jax(variant, mode):
    """All 12 outputs of the full-render graph and every head map, in eval
    mode and in train mode (BN on the batch's statistics), at 1e-4
    (bilinear: SCALED_ATOL besides)."""
    assert_outputs_match(variant['port'][mode], variant['jax'][mode],
                         SCALED_ATOL.get(variant['name'], 0.0))


def test_from_flax_covers_each_variant(variant):
    """from_flax consumes every flax leaf of the variant's tree once and
    fills every torch parameter and buffer; the variant's modules are the
    JAX package's: no depth head for bilinear, its feature_conv, the
    Unet3D or the ConvSoftplus3D base_conv."""
    variables, sd, tm = variant['variables'], variant['sd'], variant['tm']
    n_leaves = len(jax.tree.leaves((variables['params'],
                                    variables['batch_stats'])))
    n_bn = sum(k.endswith('num_batches_tracked') for k in sd)
    assert len(sd) == n_leaves + n_bn
    assert set(sd) == set(tm.state_dict())
    name, bb = variant['name'], tm.backbone
    jb = variables['params']['backbone']
    assert ('mapping_along_depth' in jb) == (name != 'bilinear')
    assert hasattr(bb, 'mapping_along_depth') == (name != 'bilinear')
    assert ('feature_conv' in jb) == hasattr(bb, 'feature_conv') == (
        name == 'bilinear')
    base = Unet3D if name == 'vampire2' else ConvSoftplus3D
    assert isinstance(bb.base_conv, base)
    if base is ConvSoftplus3D:
        assert set(jb['base_conv']) == {'conv'}
        assert 'backbone.base_conv.conv.bias' in sd


def test_default_and_ablation_configs_build():
    """VampireConfig() (variant vampire2) and every ablation preset build a
    port model at full width without running it."""
    from vampire_tpu_torch import configs as tcfg
    names = ('bilinear', 'lss', 'lss_inpaintor', 'lss_inpaintor_depth',
             'lss_inpaintor_depth_semantic', 'vampire2')
    for cfg in [tcfg.VampireConfig()] + [tcfg.ablation_config(n)
                                         for n in names]:
        fb = FieldBackbone(cfg.backbone, device='meta')
        assert fb.lift_compact and fb.lift_block == 8


def dense_inputs(bc, seed=0):
    rng = np.random.RandomState(seed)
    h, w = bc.feat_hw
    logits = rng.randn(2, 6, h, w, bc.depth_channels).astype(np.float32)
    depth = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    feat = rng.randn(2, 6, h, w, bc.mid_channels).astype(np.float32)
    mats = camera_rig(2, 6, bc.final_dim, seed=3)
    mats['bda'] = np.stack([bda_matrix(), bda_matrix(-30.0, 0.95)])
    return depth.astype(np.float32), feat, mats


def jax_lift(bc, depth, feat, mats, diagnostics=False):
    m = JaxFieldBackbone(bc, dtype=jnp.float32)
    args = (None if depth is None else jnp.asarray(depth), jnp.asarray(feat),
            {k: jnp.asarray(v) for k, v in mats.items()})
    v = jax.jit(lambda: m.init(jax.random.PRNGKey(0), *args,
                               method='_lift'))()
    out, aux = jax.jit(lambda: m.apply(v, *args, method='_lift',
                                       mutable=['diagnostics']))()
    if diagnostics:
        return np.asarray(out), jax.device_get(aux.get('diagnostics', {}))
    return np.asarray(out)


def port_lift(bc, depth, feat, mats, diagnostics=None):
    fb = FieldBackbone(bc)
    out = fb.lift(None if depth is None else
                  torch.from_numpy(depth).permute(0, 1, 4, 2, 3),
                  torch.from_numpy(feat),
                  {k: torch.from_numpy(v) for k, v in mats.items()},
                  diagnostics=diagnostics)
    return out.permute(0, 2, 3, 4, 1).numpy(), fb


@pytest.mark.parametrize('variant_name,kw', [
    ('lss_inpaintor', dict(lift_block=0)),
    ('lss_inpaintor', dict(lift_block_topk=0)),
    ('lss_inpaintor', dict(lift_block=3)),
    ('bilinear', dict(lift_block=0)),
])
def test_dense_lift_matches_jax(variant_name, kw):
    """The port's dense lift (every block selected by every camera, at the
    block size `lift_layout` picks) against the JAX dense loop, 6 cameras,
    2 batch elements, bda-rotated rigs. The JAX package takes the dense
    branch for lift_block_topk=0 or a block that does not divide the grid
    (its lift_block=0 with the default top-k divides by zero), so its side
    runs lift_block_topk=0 where the port's runs lift_block=0. The same
    sampler arithmetic and camera order; the geometry's 4x4 products are
    reassociated: 1e-5. The bilinear lift samples the raw features, whose
    slope across a pixel is O(1) where the depth-weighted ones' is ~1/D, so
    the same coordinate rounding moves it more: 1e-4 absolute (measured:
    2.4e-5 for values O(1), dense and compacted alike)."""
    bc = dataclasses.replace(tiny_config().backbone, variant=variant_name,
                             **kw)
    jbc = (dataclasses.replace(bc, lift_block=8, lift_block_topk=0)
           if kw.get('lift_block') == 0 else bc)
    depth, feat, mats = dense_inputs(bc)
    if variant_name == 'bilinear':
        depth = None
    want = jax_lift(jbc, depth, feat, mats)
    got, fb = port_lift(bc, depth, feat, mats)
    assert not fb.lift_compact and fb.lift_block == 8
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-4 if depth is None else 1e-5)


@pytest.mark.parametrize('blk,topk', [(2, 3), (2, 6), (8, 264)])
def test_lift_dropped_blocks_matches_jax(blk, topk):
    """The compacted lift's count of live blocks that the top-K drops,
    summed over the batch and the cameras, equals the value the JAX lift
    sows under 'diagnostics' (nonzero at K = 3 of 64 blocks), and the lift
    itself agrees where nothing is dropped."""
    bc = dataclasses.replace(tiny_config().backbone, lift_block=blk,
                             lift_block_topk=topk)
    depth, feat, mats = dense_inputs(bc, seed=1)
    want, diags = jax_lift(bc, depth, feat, mats, diagnostics=True)
    got_diag = {}
    got, _ = port_lift(bc, depth, feat, mats, diagnostics=got_diag)
    want_n = int(np.asarray(diags['lift_dropped_blocks'][0]))
    assert int(got_diag['lift_dropped_blocks']) == want_n
    if topk == 3:
        assert want_n > 0
    else:
        assert want_n == 0
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def sweep_inputs(cfg, frames, seed=0):
    """A (B=1, F, N, ...) batch: frame 0 the train batch's key frame, the
    other frames other synthetic images and rigs (camera_rig seeds 1..);
    the labels carry the frame axis as the loader's do."""
    b = train_batch(cfg, seed)
    out = dict(b)
    for k in ('imgs', 'depth_labels', 'seg_labels') + VIEW:
        extra = []
        for f in range(1, frames):
            if k in VIEW:
                extra.append(camera_rig(1, 6, cfg.backbone.final_dim,
                                        seed=f)[k])
            else:
                extra.append(train_batch(cfg, seed + 10 * f)[k])
        out[k] = np.stack([b[k]] + extra, axis=1)
    return b, out


@pytest.fixture(scope='module')
def sweeps():
    """The flagship variant's F = 2 forward in eval mode, on both sides."""
    cfg = tiny_config()
    b5, b6 = sweep_inputs(cfg, 2)
    jm, variables = jax_variables(cfg, b5)
    tm, _ = port_model(cfg, variables)
    mats = {k: b6[k] for k in MATS}
    return dict(cfg=cfg, b5=b5, b6=b6, tm=tm,
                jax=jax_forward(jm, variables, b6['imgs'], mats,
                                b6['points'], False),
                port=port_forward(tm, b6['imgs'], mats, b6['points'],
                                  False))


def test_two_frames_match_jax(sweeps):
    """A key frame and a sweep frame of other images and rig fold into 12
    views: every output against the JAX forward, at 1e-4; the renders are
    the key frame's 6 cameras."""
    assert sweeps['port'][0]['depth_preds'].shape[1] == 6
    assert_outputs_match(sweeps['port'], sweeps['jax'])


def test_single_frame_6d_is_bit_identical(sweeps):
    """(B, 1, N, ...) gives the (B, N, ...) outputs bit for bit, as the JAX
    package's tests/test_model.py asserts for its model."""
    tm, b5 = sweeps['tm'], sweeps['b5']
    mats5 = {k: b5[k] for k in MATS}
    mats6 = dict(mats5, **{k: b5[k][:, None] for k in VIEW})
    fo5, p5 = port_forward(tm, b5['imgs'], mats5, b5['points'], False)
    fo6, p6 = port_forward(tm, b5['imgs'][:, None], mats6, b5['points'],
                           False)
    for k, v in fo5.items():
        assert torch.equal(v, fo6[k]), k
    for a, b in zip(p5, p6):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_duplicated_sweep_matches_single_frame(sweeps):
    """A sweep frame that duplicates the key frame doubles the masked
    mean's numerator and denominator, so the field matches the single
    frame's up to the 1e-6 epsilon of the denominator (the JAX package's
    test_multisweep_two_frames, same keys and 2e-4)."""
    tm, b5 = sweeps['tm'], sweeps['b5']
    mats5 = {k: b5[k] for k in MATS}
    mats6 = dict(mats5, **{k: np.concatenate([b5[k][:, None]] * 2, 1)
                           for k in VIEW})
    imgs6 = np.concatenate([b5['imgs'][:, None]] * 2, 1)
    fo5, _ = port_forward(tm, b5['imgs'], mats5, b5['points'], False)
    fo6, _ = port_forward(tm, imgs6, mats6, b5['points'], False)
    for k in ('depth_preds', 'occ_logits', 'bev_seg_logits_preds',
              'pts_logits', 'bev_feature'):
        np.testing.assert_allclose(fo6[k].numpy(), fo5[k].numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=k)


def test_6d_losses_match_jax(sweeps):
    """compute_losses on the 6-D batch (labels with the frame axis) and the
    JAX F = 2 forward's outputs, on both sides from the same numpy values:
    every term, the key frame's labels taken on both sides (1e-5)."""
    cfg, b6 = sweeps['cfg'], sweeps['b6']
    jfo, jpreds = sweeps['jax']
    _, jlogs = jax.device_get(jax.jit(lambda fo, preds, b: jax_losses(
        fo, preds, b, cfg.train, cfg.head, cfg.backbone.sdf_bias))(
            jfo, jpreds, {k: jnp.asarray(v) for k, v in b6.items()}))

    def tt(tree):
        if isinstance(tree, dict):
            return {k: tt(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [tt(v) for v in tree]
        return None if tree is None else torch.from_numpy(np.asarray(tree))
    _, tlogs = compute_losses(tt(jfo), tt(jpreds), tt(b6), cfg.train,
                              cfg.head, cfg.backbone.sdf_bias)
    assert b6['depth_labels'].ndim == 5 and set(tlogs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(tlogs[k].item(), float(jlogs[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_more_views_than_the_lift_kernel_takes_raise(sweeps):
    """F * N views a frame above the lift kernel's 32 cameras raise before
    any work, on every device."""
    tm, b5 = sweeps['tm'], sweeps['b5']
    mats = {k: b5[k] for k in MATS}
    mats.update({k: np.repeat(b5[k][:, None], 6, 1) for k in VIEW})
    imgs = np.repeat(b5['imgs'][:, None], 6, 1)          # 36 views
    with pytest.raises(ValueError, match='views'):
        port_forward(tm, imgs, mats, b5['points'], False)
