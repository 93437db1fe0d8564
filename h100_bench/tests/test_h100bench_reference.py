"""The frozen plain reference against the program at `tiny_config` on the
CPU: the same names and shapes of every weight (also at the flagship's
and the bilinear variant's published sizes, on the meta device), the
same served outputs and the same train steps (with the program's bf16
field samples, which the reference then takes too, the two are the same
arithmetic)."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from harness import compare, frames, refrun, spec
from harness.weights import make_state_dict
from reference import configs as RC
from reference.models.vampire import Vampire as RVampire
from reference.training.train_state import create_train_state as r_state
from reference.training.train_step import train_step as r_step


def tiny(variant='lss_inpaintor', dtype='float32'):
    from vampire_tpu_torch.data.synthetic import tiny_config
    t = tiny_config()
    t = dataclasses.replace(
        t, backbone=dataclasses.replace(t.backbone, variant=variant),
        train=dataclasses.replace(t.train, compute_dtype=dtype))
    d = spec.as_dict(t)
    from vampire_tpu_torch import configs as PC
    return spec.build_config(d, PC), spec.build_config(d, RC)


@pytest.mark.parametrize('name', ['flagship', 'bilinear', 'lss'])
def test_weight_names_and_shapes_match_the_program(name):
    from vampire_tpu_torch import configs as PC
    from vampire_tpu_torch.models.vampire import Vampire
    pc = (PC.flagship_config() if name == 'flagship'
          else PC.ablation_config(name))
    rc = spec.build_config(spec.as_dict(pc), RC)
    got = {k: tuple(v.shape) for k, v in
           RVampire(rc.backbone, rc.head, device='meta').state_dict().items()}
    want = {k: tuple(v.shape) for k, v in
            Vampire(pc.backbone, pc.head, device='meta').state_dict().items()}
    assert got == want


def program_model(pc, sd):
    from vampire_tpu_torch.models.vampire import Vampire
    dtype = torch.bfloat16 if pc.train.compute_dtype == 'bfloat16' \
        else torch.float32
    m = Vampire(pc.backbone, pc.head, dtype=dtype)
    m.load_state_dict(sd, strict=True)
    return m


@pytest.mark.parametrize('variant', ['lss_inpaintor', 'bilinear'])
def test_served_outputs_equal_the_program(variant):
    pc, rc = tiny(variant)
    shapes = RVampire(rc.backbone, rc.head, device='meta')
    sd = make_state_dict(shapes, 5, 'cpu', dict(
        residual_bn_gamma=0.1,
        density_head=dict(weight_scale=0.13, bias=-0.49)))
    prog = program_model(pc, sd)
    ref = refrun.build(rc, 'cpu', sd)
    ref.backbone.sample_dtype = prog.backbone.sample_dtype
    fr = frames.frame_pool(rc, 2, 5)
    inputs = refrun.served_inputs(fr, 'cpu')
    for m in (prog, ref):
        m.eval()
    with torch.no_grad():
        a, pa = prog(*inputs[:2], points=inputs[2], camera_renders=False)
        b, pb = ref(*inputs[:2], points=inputs[2], camera_renders=False)
    for k in ('occ_logits', 'occ_density', 'pts_logits', 'bev_feature'):
        assert torch.equal(a[k], b[k]), k
    for ta, tb in zip(pa, pb):
        for k in ta:
            assert torch.equal(ta[k], tb[k]), k


def test_train_steps_equal_the_program():
    from vampire_tpu_torch.training.train_state import create_train_state
    from vampire_tpu_torch.training.train_step import build_train_step
    pc, rc = tiny()
    shapes = RVampire(rc.backbone, rc.head, device='meta')
    sd = make_state_dict(shapes, 9, 'cpu', dict(
        residual_bn_gamma=0.1,
        density_head=dict(weight_scale=0.13, bias=-0.49)))
    pool = frames.train_pool(rc, 2, 2, 9)
    prog = program_model(pc, sd)
    p_state = create_train_state(prog, pc.train, 10 ** 9)
    step = build_train_step(pc)
    got = refrun.follow(p_state, pool, pc, 'cpu',
                        lambda s, b: step(s, b)[1])
    ref = refrun.build(rc, 'cpu', sd)
    ref.backbone.sample_dtype = prog.backbone.sample_dtype
    want = refrun.follow(r_state(ref, rc.train, 10 ** 9), pool, rc, 'cpu',
                         lambda s, b: r_step(s, b, rc))
    assert got['names'] == want['names']
    for k in ('loss', 'grad', 'change'):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ('occ0', 'depth0', 'seg0', 'heat0'):
        np.testing.assert_array_equal(got[k], want[k])
    assert compare.train_numbers(got, want) == dict(
        forward_gap=0.0, render_gap=0.0, heatmap_gap=0.0, grad_gap=0.0,
        update_gap=0.0)


def test_checkpointed_encoder_gives_the_same_step():
    _, rc = tiny()
    shapes = RVampire(rc.backbone, rc.head, device='meta')
    sd = make_state_dict(shapes, 3, 'cpu')
    pool = frames.train_pool(rc, 2, 1, 3)
    out = []
    for ckpt in (False, True):
        m = refrun.build(rc, 'cpu', copy.deepcopy(sd))
        m.backbone.checkpoint_encoder = ckpt
        out.append(refrun.follow(r_state(m, rc.train, 10 ** 9), pool, rc,
                                 'cpu', lambda s, b: r_step(s, b, rc)))
    for k in ('loss', 'grad', 'change', 'occ0', 'depth0', 'seg0', 'heat0'):
        np.testing.assert_allclose(out[0][k], out[1][k], rtol=1e-5)


def test_the_weights_are_seeded_and_complete():
    _, rc = tiny()
    shapes = RVampire(rc.backbone, rc.head, device='meta')
    a = make_state_dict(shapes, 2 ** 31 + 7, 'cpu')
    b = make_state_dict(shapes, 2 ** 31 + 7, 'cpu')
    c = make_state_dict(shapes, 2 ** 31 + 8, 'cpu')
    assert set(a) == set(shapes.state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a['backbone.channel_lower.weight'],
                           c['backbone.channel_lower.weight'])
    assert float(a['backbone.density_conv.bias'][0]) == rc.backbone.sdf_bias - 10
    d = make_state_dict(shapes, 2 ** 31 + 7, 'cpu', dict(
        residual_bn_gamma=0.1,
        density_head=dict(weight_scale=0.5, bias=-0.25)))
    last = [k for k in d if k.endswith('.conv2.bn.weight') and 'layer' in k]
    assert last and all(torch.all(d[k] == 0.1) for k in last)
    assert all(torch.all(d[k] == 1.0) for k in d
               if k.endswith('.conv1.bn.weight'))
    assert torch.equal(d['backbone.density_conv.weight'],
                       0.5 * a['backbone.density_conv.weight'])
    assert float(d['backbone.density_conv.bias'][0]) == -0.25
