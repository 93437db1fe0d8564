"""The kernels under the camera axis of the dp x cam layout, on the card at
tiny_config: a frame's cameras split over the ranks of a cam group
(`parallel/mesh.py`) must give, summed, the frame's lift, and each ray's
render must not depend on which cameras march beside it. The flagship
frame's check is `chip_smoke.py`'s cam phase. No JAX here: the card's
machine runs this file with `pytest --noconftest -m gpu`."""
import numpy as np
import pytest
import torch

from vampire_tpu_torch.configs import synthetic_batch, tiny_config
from vampire_tpu_torch.core import geometry as G
from vampire_tpu_torch.models.field import coords_valid, ray_inputs
from vampire_tpu_torch.models.vampire import Vampire
from vampire_tpu_torch.ops import lift as lift_ops
from vampire_tpu_torch.ops import rays as ray_ops

MATS = ('sensor2ego', 'intrin', 'ida', 'bda')
# fp32 units of the lift of |feat|: the kernel adds each camera's sample in
# camera order (`acc += v`, csrc/lift.cu); two orders of 6 terms are each
# within 5 u sum|v| of the exact sum, so within 10 u of each other
SPLIT_ULPS = 10


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_camera_halves_of_the_lift_and_rays_make_the_frame_on_gpu(dtype):
    """The dense lift over cameras 0-2 plus the lift over 3-5 is the lift
    over 0-5 (denominators exactly, numerators within SPLIT_ULPS), each
    half matches its plain version, and the ray kernel over cameras 3-5 is
    rows 3-5 of the six-camera march, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    cfg = tiny_config()
    torch.manual_seed(0)
    tm = Vampire(cfg.backbone, cfg.head, device='cuda',
                 lift_vectorized=True).eval()
    bb = tm.backbone
    b = synthetic_batch(cfg, batch_size=1, n_points=64, seed=7, mode='val')
    dev = {k: torch.from_numpy(np.asarray(v)).cuda() for k, v in b.items()}
    mats = {k: dev[k] for k in MATS}
    with torch.no_grad():
        feats = bb.img_neck(bb.img_backbone(
            dev['imgs'][0].permute(0, 3, 1, 2)))
        depth = torch.softmax(bb.mapping_along_depth(feats), dim=1)
        low = bb.channel_lower(feats).permute(0, 2, 3, 1).contiguous()
    depth, low = depth.to(dtype), low.to(dtype)
    _, Y, X = cfg.backbone.grid_zyx('seg')
    Gn = (Y // bb.lift_block) * (X // bb.lift_block)
    pix = G.get_pixel(bb.voxel_coords_bm[:, :, None], mats['sensor2ego'],
                      mats['intrin'], mats['ida'], mats['bda'])[..., 0, :]
    coords, valid = (t[0] for t in coords_valid(pix, cfg.backbone))
    ids = torch.arange(Gn, device='cuda').expand(6, Gn).contiguous()

    def lift(cams, feat=low):
        return lift_ops.lift_frame_accumulate(
            depth[cams].contiguous(), feat[cams].contiguous(),
            ids[cams].contiguous(), coords[cams].contiguous(),
            valid[cams].contiguous(), Gn)
    whole, a, c = lift(slice(0, 6)), lift(slice(0, 3)), lift(slice(3, 6))
    assert torch.equal(a[1] + c[1], whole[1])
    mag = lift(slice(0, 6), low.abs())[0]
    assert bool(((a[0] + c[0] - whole[0]).abs()
                 <= SPLIT_ULPS * 2.0 ** -24 * mag).all())
    assert whole[1].sum() > 0
    for part, cams in ((a, slice(0, 3)), (c, slice(3, 6))):
        want = lift_ops.lift_frame_accumulate_reference(
            depth[cams], low[cams], ids[cams], coords[cams], valid[cams], Gn)
        torch.testing.assert_close(part[0], want[0], rtol=1e-5, atol=1e-5)
        assert torch.equal(part[1], want[1])

    g = torch.Generator(device='cuda').manual_seed(1)
    vol = torch.randn((cfg.backbone.num_classes + 4,)
                      + tuple(cfg.backbone.grid_zyx('seg')), device='cuda',
                      generator=g).to(dtype)
    field = ray_ops.channels_last_field(vol)
    geom = G.get_geometry(bb.frustum, mats['sensor2ego'], mats['intrin'],
                          mats['ida'], mats['bda'])
    rc, rv, rd = (t[0] for t in ray_inputs(geom, cfg.backbone))
    per = rc.shape[0] // 6
    rest = (bb.camera_mids, cfg.backbone.d_bound[1],
            cfg.backbone.density_mode, bb.density_beta.detach(),
            cfg.backbone.sdf_bias)
    full = ray_ops.sample_and_composite_rays(field, rc, rv, rd, *rest)
    half = ray_ops.sample_and_composite_rays(
        field, rc[3 * per:].contiguous(), rv[3 * per:].contiguous(),
        rd[3 * per:].contiguous(), *rest)
    assert torch.equal(half, full[3 * per:])
