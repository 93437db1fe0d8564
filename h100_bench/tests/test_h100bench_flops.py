"""The analytic operation count against a forward-hook count of the
program's convolutions at `tiny_config`, for each variant."""
import dataclasses

import numpy as np
import pytest
import torch

from harness import flops, spec
from reference import configs as RC


def hook_count(model, imgs, mats, points):
    """2 x multiply-adds of every conv the forward runs, by output size
    (transposed convs by input size)."""
    total = [0]

    def hook(m, inp, out):
        w = m.weight
        if isinstance(m, torch.nn.ConvTranspose2d):
            total[0] += 2 * inp[0].numel() * w.shape[1] * w[0, 0].numel()
        else:
            total[0] += 2 * out.numel() * w.shape[1] * w[0, 0].numel()
    hs = [m.register_forward_hook(hook) for m in model.modules()
          if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d,
                            torch.nn.ConvTranspose2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            model(imgs, mats, points=points, camera_renders=False)
    finally:
        for h in hs:
            h.remove()
    return total[0]


@pytest.mark.parametrize('variant', ['lss_inpaintor', 'bilinear', 'lss'])
@pytest.mark.parametrize('rows', [1, 2])
def test_analytic_count_matches_the_program_hooks(variant, rows):
    from vampire_tpu_torch import configs as PC
    from vampire_tpu_torch.data.synthetic import synthetic_batch, tiny_config
    from vampire_tpu_torch.models.vampire import Vampire
    tiny = tiny_config()
    tiny = dataclasses.replace(tiny, backbone=dataclasses.replace(
        tiny.backbone, variant=variant))
    model = Vampire(tiny.backbone, tiny.head)
    model.eval()
    b = synthetic_batch(tiny, rows, n_points=tiny.train.max_points, seed=0,
                        mode='val')
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    mats = {k: t[k] for k in ('sensor2ego', 'intrin', 'ida', 'bda')}
    got = hook_count(model, t['imgs'], mats, t['points'])
    ref_cfg = spec.build_config(spec.as_dict(tiny), RC)
    assert flops.forward_ops(ref_cfg, rows) == got
    assert spec.build_config(spec.as_dict(tiny), PC) == tiny


def test_flagship_parts_and_dtypes():
    """At the flagship's published shapes: each part charged at its
    configured dtype, and a train step three forwards."""
    cfg = RC.flagship_config()
    p = flops.parts(cfg)
    assert p['voxel_output'][1] == 'float32' and p['det_head'][1] == 'float32'
    assert p['encoder'][1] == 'bfloat16'
    assert flops.least_seconds(cfg, 8, True) == pytest.approx(
        24 * flops.least_seconds(cfg, 1))
