"""Port geometry vs the JAX package: the numpy grid builders bit-equal, the
fp32 projective transforms to fp32 reassociation."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampire_tpu.configs import flagship_config
from vampire_tpu.core import geometry as JG
from vampire_tpu.data.synthetic import camera_rig, tiny_config
from vampire_tpu_torch.core import geometry as G
from vampire_tpu_torch.models.field import block_major_voxels, coords_valid


@pytest.mark.parametrize('cfg_fn', [tiny_config, flagship_config])
def test_grid_builders_bit_equal(cfg_fn):
    c = cfg_fn().backbone
    pairs = [
        (G.make_frustum, JG.make_frustum,
         (c.final_dim, c.downsample_factor, c.d_bound)),
        (G.make_camera_mids, JG.make_camera_mids, (c.d_bound,)),
        (G.make_bev_mids, JG.make_bev_mids, (c.z_bound_det,)),
        (G.make_voxel_coords, JG.make_voxel_coords,
         (c.x_bound_seg, c.y_bound_seg, c.z_bound_seg)),
        (G.make_norm_voxel_coords, JG.make_norm_voxel_coords,
         (c.x_bound_seg, c.y_bound_seg, c.z_bound_seg)),
        (G.make_occ_coords, JG.make_occ_coords,
         (c.occ_pc_range, c.occ_voxel_size, c.occ_grid)),
        (G.centers_of, JG.centers_of, (c.x_bound_det,)),
        (G.arange_bound, JG.arange_bound, (c.d_bound,)),
    ]
    for port, ref, args in pairs:
        got, want = port(*args), ref(*args)
        assert got.dtype == want.dtype, port.__name__
        np.testing.assert_array_equal(got, want, err_msg=port.__name__)


def _mats(seed=3, bda_rot=0.3):
    rig = camera_rig(2, 6, tiny_config().backbone.final_dim, seed=seed)
    a = bda_rot
    bda = np.eye(4, dtype=np.float32)
    bda[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    rig['bda'] = np.stack([bda, np.eye(4, dtype=np.float32)])
    return rig


@pytest.mark.parametrize('with_bda', [True, False])
def test_get_pixel_matches_jax(with_bda):
    """Pixel coords reach ~1e3 behind the camera (z clamped to eps gives
    far larger values, which both sides then mask out); compare the
    in-front points at fp32 relative precision over 3 chained 4x4 products
    and one inverse: 1e-5 relative, 1e-3 px absolute."""
    c = tiny_config().backbone
    vox = G.make_voxel_coords(c.x_bound_seg, c.y_bound_seg, c.z_bound_seg)
    m = _mats()
    bda = m['bda'] if with_bda else None
    want = np.asarray(JG.get_pixel(
        jnp.asarray(vox), *(jnp.asarray(m[k]) for k in
                            ('sensor2ego', 'intrin', 'ida')),
        None if bda is None else jnp.asarray(bda)))
    got = G.get_pixel(torch.from_numpy(vox),
                      *(torch.from_numpy(m[k]) for k in
                        ('sensor2ego', 'intrin', 'ida')),
                      None if bda is None else torch.from_numpy(bda)).numpy()
    assert got.shape == want.shape == (2, 6) + vox.shape[:3] + (3,)
    front = want[..., 2] > 0.1
    assert front.any()
    np.testing.assert_allclose(got[front], want[front], rtol=1e-5, atol=1e-3)


def test_normalize_and_inrange():
    c = tiny_config().backbone
    rng = np.random.RandomState(0)
    xyz = rng.uniform(-6, 6, (3, 50, 3)).astype(np.float32)
    want = np.asarray(JG.normalize_coords(jnp.asarray(xyz), c.x_bound_seg,
                                          c.y_bound_seg, c.z_bound_seg))
    got = G.normalize_coords(torch.from_numpy(xyz), c.x_bound_seg,
                             c.y_bound_seg, c.z_bound_seg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(G.inrange_mask(got).numpy(),
                                  np.asarray(JG.inrange_mask(
                                      jnp.asarray(got.numpy()))))


def test_block_major_coords_valid():
    """The lift's block-major geometry: same voxels as the dense (Z, Y, X)
    grid in another order, and validity identical to the JAX rule on the
    same pixel coords."""
    c = tiny_config().backbone
    bm = block_major_voxels(c)
    Z, Y, X = c.grid_zyx('seg')
    assert bm.shape == ((Y // 8) * (X // 8), Z * 64, 4)
    dense = G.make_voxel_coords(c.x_bound_seg, c.y_bound_seg, c.z_bound_seg)
    np.testing.assert_array_equal(np.sort(bm.reshape(-1, 4), axis=0),
                                  np.sort(dense.reshape(-1, 4), axis=0))
    m = _mats()
    pix = G.get_pixel(torch.from_numpy(bm)[:, :, None],
                      *(torch.from_numpy(m[k]) for k in
                        ('sensor2ego', 'intrin', 'ida', 'bda')))[..., 0, :]
    coords, valid = coords_valid(pix, c)
    p = pix.numpy()
    fH, fW = c.final_dim
    want_valid = ((p[..., 0] > -0.5) & (p[..., 0] < fW - 0.5)
                  & (p[..., 1] > -0.5) & (p[..., 1] < fH - 0.5)
                  & (p[..., 2] > c.d_bound[0]) & (p[..., 2] < c.d_bound[1]))
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    assert valid.numpy().any()
    assert coords.abs().max() <= 2.0


@pytest.mark.parametrize('with_bda', [True, False])
def test_get_geometry_matches_jax(with_bda):
    """Frustum -> ego xyz: two inverses and three chained 4x4 products in
    fp32 on both sides (HIGHEST precision on the JAX side); points reach
    ~20 m at tiny_config: 1e-5."""
    c = tiny_config().backbone
    fr = G.make_frustum(c.final_dim, c.downsample_factor, c.d_bound)
    m = _mats()
    bda = m['bda'] if with_bda else None
    want = np.asarray(JG.get_geometry(
        jnp.asarray(fr), *(jnp.asarray(m[k]) for k in
                           ('sensor2ego', 'intrin', 'ida')),
        None if bda is None else jnp.asarray(bda)))
    got = G.get_geometry(torch.from_numpy(fr),
                         *(torch.from_numpy(m[k]) for k in
                           ('sensor2ego', 'intrin', 'ida')),
                         None if bda is None else torch.from_numpy(bda))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (2, 6) + fr.shape[:3] + (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
