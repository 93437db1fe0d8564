"""The byte bounds of the two roofline readers against the program's
kernel table (PERF.md, "Every TPU kernel of the repo"), at the
flagship's and the bilinear variant's frame shapes, built as
`chip_smoke.py`'s kernel phase builds them: ms at 3.35 TB/s."""
import numpy as np
import pytest
import torch

from harness import frames, roofline
from reference import configs as RC
from reference.core import geometry as G
from reference.models.field import (block_major_voxels, coords_valid,
                                    ray_inputs)


def lift_frame_inputs(bc, dtype):
    D, (h, w), C = bc.depth_channels, bc.feat_hw, bc.mid_channels
    rig = {k: torch.from_numpy(v) for k, v in
           frames.camera_rig(1, 6, bc.final_dim, seed=0).items()}
    vox = torch.from_numpy(block_major_voxels(bc))
    pix = G.get_pixel(vox[:, :, None], rig['sensor2ego'], rig['intrin'],
                      rig['ida'], rig['bda'])[..., 0, :]
    coords, valid = coords_valid(pix, bc)
    Gn, Q = valid.shape[2:]
    K = min(bc.lift_block_topk, Gn)
    g = torch.Generator().manual_seed(0)
    depth = torch.softmax(torch.randn(6, D, h, w, generator=g), dim=1)
    feat = torch.randn(6, h, w, C, generator=g)
    ids = torch.topk(valid[0].sum(-1), K, dim=-1).indices
    sel = ids[..., None]
    coords = torch.gather(coords[0], 1, sel[..., None].expand(-1, -1, Q, 3))
    valid = torch.gather(valid[0], 1, sel.expand(-1, -1, Q))
    dep = None if bc.variant == 'bilinear' else depth.to(dtype)
    return (dep, feat.to(dtype), ids.contiguous(), coords.contiguous(),
            valid.contiguous(), Gn)


# (config, dtype): (forward ms, backward ms) as PERF.md's table gives them
LIFT = {('flagship', torch.bfloat16): (0.0639, 0.0420),
        ('flagship', torch.float32): (0.0680, 0.0461),
        ('bilinear', torch.bfloat16): (0.0604, 0.0310),
        ('bilinear', torch.float32): (0.0611, None)}


@pytest.mark.parametrize('key', sorted(LIFT, key=str))
def test_lift_bounds_match_the_kernel_table(key):
    name, dtype = key
    cfg = RC.flagship_config() if name == 'flagship' else \
        RC.ablation_config('bilinear')
    args = lift_frame_inputs(cfg.backbone, dtype)
    fwd, bwd = LIFT[key]
    got = roofline.bound_ms(roofline.lift_forward_bytes(*args))
    assert got == pytest.approx(fwd, abs=6e-5)
    if bwd is not None:
        got = roofline.bound_ms(roofline.lift_backward_bytes(*args))
        assert got == pytest.approx(bwd, abs=6e-5)


def test_ray_bounds_match_the_kernel_table():
    bc = RC.flagship_config().backbone
    rig = {k: torch.from_numpy(v) for k, v in
           frames.camera_rig(1, 6, bc.final_dim, seed=0).items()}
    frustum = torch.from_numpy(G.make_frustum(
        bc.final_dim, bc.downsample_factor, bc.d_bound))
    mids = torch.from_numpy(G.make_camera_mids(bc.d_bound))
    geom = G.get_geometry(frustum, rig['sensor2ego'], rig['intrin'],
                          rig['ida'], rig['bda'])
    coords, valid, delta = (t[0] for t in ray_inputs(geom, bc))
    C = 1 + bc.num_classes + 3
    field = torch.empty(tuple(bc.grid_zyx('seg')) + (C,),
                        dtype=torch.bfloat16)
    fwd = roofline.bound_ms(roofline.ray_forward_bytes(
        field, coords, valid, delta, mids))
    bwd = roofline.bound_ms(roofline.ray_backward_bytes(
        field, coords, valid, delta, mids))
    assert fwd == pytest.approx(0.0518, abs=6e-5)
    assert bwd == pytest.approx(0.0880, abs=6e-5)
    assert np.isfinite(fwd) and valid.shape == (67584, 85)
