"""The port's host input pipeline against the JAX package's, on the same
seeded inputs at tolerance 0: the transforms of `data/transforms.py`, the
two rasterizers (the C++ of `csrc/host.cpp`, their numpy plain versions
and the JAX package's `rasterize_*`), `consistent_batch`, and the fake
nuScenes tree of `data/fake.py`, file by file; and a failed build of the
host library raises on the rasterizers' path."""
import filecmp
import os
import pickle
import types

import numpy as np
import pytest

from vampire_tpu import configs as jcfg
from vampire_tpu.data import synthetic as jsyn
from vampire_tpu.data import transforms as jT
from vampire_tpu.data.fake import make_fake_nusc as j_make_fake_nusc
from vampire_tpu.ops import nms as jnms
from vampire_tpu_torch import configs as tcfg
from vampire_tpu_torch.data import nuscenes as tnusc
from vampire_tpu_torch.data import synthetic as tsyn
from vampire_tpu_torch.data import transforms as T
from vampire_tpu_torch.data.fake import make_fake_nusc
from vampire_tpu_torch.ops import _build
from vampire_tpu_torch.ops import nms as tnms


def _same(got, want):
    """Equal values, dtypes and shapes, element for element."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the transforms
# ---------------------------------------------------------------------------

def _unit_quats(seed, n=4):
    rng = np.random.RandomState(seed)
    q = rng.randn(n, 4)
    return list(q / np.linalg.norm(q, axis=1, keepdims=True)) + [
        np.array([1.0, 0, 0, 0]), np.zeros(4)]


@pytest.mark.parametrize('seed', [0, 1])
def test_quaternion_helpers_match_jax(seed):
    rng = np.random.RandomState(seed + 10)
    for q in _unit_quats(seed):
        _same(T.quat_to_rot(q), jT.quat_to_rot(q))
        assert T.quat_yaw(q) == jT.quat_yaw(q)
        t = rng.uniform(-100, 100, 3)
        _same(T.pose_matrix(q, t), jT.pose_matrix(q, t))


def _ida_params(mode, seed):
    """(resize, resize_dims, crop) as the dataset draws them in `mode` under
    the flagship's train augmentation (`_sample_ida`)."""
    ida = tcfg.IdaAugConfig(rand_flip=True, rot_lim=(-5.4, 5.4),
                            bot_pct_lim=(0.0, 0.22))
    stub = types.SimpleNamespace(ida_aug=ida, mode=mode,
                                 rng=np.random.RandomState(seed))
    resize, resize_dims, crop, _, _ = \
        tnusc.NuscDetSegDataset._sample_ida(stub)
    return resize, resize_dims, crop


@pytest.mark.parametrize('mode', ['train', 'val'])
@pytest.mark.parametrize('flip', [False, True])
@pytest.mark.parametrize('rotate', [0.0, -4.3])
@pytest.mark.parametrize('seed', [0, 3])
def test_image_space_transforms_match_jax(mode, flip, rotate, seed):
    """ida_matrix, the PIL image pipeline, normalize_image and
    make_depth_label, at the resize and crop the dataset draws in `mode`."""
    from PIL import Image
    resize, resize_dims, crop = _ida_params(mode, seed)
    _same(T.ida_matrix(resize, crop, flip, rotate),
          jT.ida_matrix(resize, crop, flip, rotate))

    rng = np.random.RandomState(seed)
    raw = Image.fromarray(rng.randint(0, 256, (90, 160, 3), np.uint8))
    raw = raw.resize((1600, 900))
    img = np.asarray(T.apply_img_transform(raw, resize_dims, crop, flip,
                                           rotate))
    _same(img, np.asarray(jT.apply_img_transform(raw, resize_dims, crop,
                                                 flip, rotate)))
    assert img.shape == (256, 704, 3)
    mean, std = tcfg.IMG_MEAN, tcfg.IMG_STD
    _same(T.normalize_image(img, mean, std),
          jT.normalize_image(img, jcfg.IMG_MEAN, jcfg.IMG_STD))

    n = 3000
    uvd = np.stack([rng.uniform(-50, 1650, n), rng.uniform(-50, 950, n),
                    rng.uniform(1, 60, n)], 1).astype(np.float32)
    uvd[n // 2:, 2] = np.round(uvd[n // 2:, 2])   # depth ties
    lab = rng.randint(0, 17, n).astype(np.int8)
    got = T.make_depth_label(uvd.copy(), lab, resize, (256, 704), crop, flip,
                             rotate)
    want = jT.make_depth_label(uvd.copy(), lab, resize, (256, 704), crop,
                               flip, rotate)
    for g, w in zip(got, want):
        _same(g, w)
    assert (got[0] > 0).sum() > 100


@pytest.mark.parametrize('rotate,scale,flip_dx,flip_dy', [
    (0.0, 1.0, False, False), (17.5, 1.04, False, True),
    (-22.5, 0.95, True, False), (3.0, 1.0, True, True)])
def test_bda_transform_matches_jax(rotate, scale, flip_dx, flip_dy):
    rng = np.random.RandomState(0)
    boxes = rng.randn(6, 9).astype(np.float32)
    pts = rng.uniform(-50, 50, (200, 3)).astype(np.float32)
    for b in (boxes, boxes[:0]):
        got = T.bda_transform(b, pts, rotate, scale, flip_dx, flip_dy)
        want = jT.bda_transform(b, pts, rotate, scale, flip_dx, flip_dy)
        for g, w in zip(got, want):
            _same(g, w)


@pytest.mark.parametrize('bounds', ['flagship', 'tiny'])
def test_bev_seg_map_matches_jax(bounds):
    bc = (tcfg.flagship_config() if bounds == 'flagship'
          else tsyn.tiny_config()).backbone
    x, y, z = bc.x_bound_seg, bc.y_bound_seg, bc.z_bound_seg
    rng = np.random.RandomState(1)
    n = 5000
    pts = np.stack([rng.uniform(-1.2, 1.2, n) * x[1],
                    rng.uniform(-1.2, 1.2, n) * y[1],
                    rng.uniform(z[0] - 1, z[1] + 1, n)], 1).astype(np.float32)
    pts[::7, 2] = np.round(pts[::7, 2])             # height ties
    lab = rng.randint(0, 17, n).astype(np.int8)
    kw = dict(x_bound=x[:2], y_bound=y[:2], z_bound=z[:2], size=x[2])
    got = T.make_bev_seg_map(pts, lab, **kw)
    want = jT.make_bev_seg_map(pts, lab, **kw)
    for g, w in zip(got, want):
        _same(g, w)
    assert got[2].sum() > 0


# ---------------------------------------------------------------------------
# the rasterizers
# ---------------------------------------------------------------------------

def _cloud(seed, h, w, n=700):
    """Rows (a, b, key, label) with coordinates across and beyond the grid
    (negative, fractional in (-1, 0), at and past the far edge) and keys
    with many ties."""
    rng = np.random.RandomState(seed)
    a = rng.uniform(-3, w + 3, n)
    b = rng.uniform(-3, h + 3, n)
    a[:20] = rng.uniform(-0.99, 0, 20)      # truncates to 0: in the grid
    b[20:40] = h + rng.uniform(0, 1, 20)    # past the far edge
    key = rng.randint(0, 6, n).astype(np.float64) * 0.5   # ties
    key[40:60] = -key[40:60]
    lab = rng.randint(0, 17, n)
    return np.stack([a, b, key, lab], 1).astype(np.float32)


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('n', [0, 1, 700])
def test_rasterizers_match_plain_and_jax(seed, n):
    """The C++ rasterizers equal their plain versions and the JAX
    package's, bit for bit: ties keep input order (stable sorts: depth
    farthest first, z lowest first), coordinates truncate toward zero."""
    h, w = 23, 41
    uvdl = _cloud(seed, h, w)[:n]
    for got, plain, want in (
            (tnms.rasterize_depth(uvdl, h, w),
             tnms.rasterize_depth_reference(uvdl, h, w),
             jnms.rasterize_depth(uvdl, h, w)),
            (tnms.rasterize_bev(uvdl, h, w),
             tnms.rasterize_bev_reference(uvdl, h, w),
             jnms.rasterize_bev(uvdl, h, w))):
        for g, p, wt in zip(got, plain, want):
            _same(g, p)
            _same(g, wt)
            assert g.dtype == np.float32
        if n > 1:
            assert got[0].any()


def test_rasterizers_refuse_rows_of_another_width():
    with pytest.raises(ValueError, match='expected \\(N, 4\\)'):
        tnms.rasterize_depth(np.zeros((5, 3), np.float32), 4, 4)


def test_failed_host_build_raises_on_the_rasterizers(monkeypatch, tmp_path):
    """A host library that does not build raises on the input pipeline's
    path (`make_depth_label`); nothing falls back to the numpy loops."""
    src = tmp_path / 'csrc'
    src.mkdir()
    (src / 'host.cpp').write_text('this is not C++\n')
    monkeypatch.setattr(_build, 'CSRC', str(src))
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(_build, '_libs', {})
    uvd = np.array([[10.0, 10.0, 5.0]], np.float32)
    with pytest.raises(RuntimeError, match='c\\+\\+ failed'):
        T.make_depth_label(uvd, np.zeros(1, np.int8), 0.5, (32, 64),
                           (0, 0, 64, 32), False, 0.0)
    with pytest.raises(RuntimeError, match='c\\+\\+ failed'):
        T.make_bev_seg_map(np.zeros((1, 3), np.float32), np.ones(1))


# ---------------------------------------------------------------------------
# consistent_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('mode,sweep_offsets', [
    ('train', ()), ('val', ()), ('train', (0.5, 1.5))])
def test_consistent_batch_matches_jax(mode, sweep_offsets):
    got = tsyn.consistent_batch(tsyn.tiny_config(), batch_size=2, seed=3,
                                mode=mode, sweep_offsets=sweep_offsets)
    want = jsyn.consistent_batch(jsyn.tiny_config(), batch_size=2, seed=3,
                                 mode=mode, sweep_offsets=sweep_offsets)
    assert set(got) == set(want)
    for k in want:
        if k == 'gt_boxes_list':
            for g, w in zip(got[k], want[k]):
                _same(g, w)
        else:
            _same(got[k], want[k])
    F = 1 + len(sweep_offsets)
    assert got['imgs'].shape[:3] == ((2, F, 6) if sweep_offsets else
                                     (2, 6, 32))
    assert got['depth_labels'].any() and got['bev_mask'].any()


# ---------------------------------------------------------------------------
# the fake nuScenes tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp('fake')
    out = {}
    for name, make in (('torch', make_fake_nusc), ('jax', j_make_fake_nusc)):
        for content in ('noise', 'smooth'):
            d = root / f'{name}_{content}'
            out[name, content] = (d, make(d, n_samples=2, n_points=300,
                                          seed=4, image_content=content,
                                          occ_shape=(8, 8, 4)))
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize('content', ['noise', 'smooth'])
def test_fake_tree_matches_jax_byte_for_byte(trees, content):
    (got, got_pkl), (want, want_pkl) = (trees['torch', content],
                                        trees['jax', content])
    files = _files(want)
    assert _files(got) == files and len(files) == 2 * 6 + 2 * 3 + 1
    _, mismatch, errors = filecmp.cmpfiles(want, got, files, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    with open(got_pkl, 'rb') as f:
        a = pickle.load(f)
    with open(want_pkl, 'rb') as f:
        b = pickle.load(f)
    assert repr(a) == repr(b)


def test_fake_tree_writes_jpegs_only_through_its_helper(monkeypatch,
                                                        tmp_path, trees):
    """With the JPEG writer replaced, the tree's other files and its infos
    are those of the full tree: the images take no other path and the
    random stream does not depend on them."""
    from vampire_tpu_torch.data import fake
    written = []
    monkeypatch.setattr(fake, '_write_jpeg',
                        lambda img, path: written.append(img.shape))
    make_fake_nusc(tmp_path, n_samples=2, n_points=300, seed=4,
                   occ_shape=(8, 8, 4))
    assert written == [(900, 1600, 3)] * 12
    full, _ = trees['torch', 'noise']
    files = [f for f in _files(full) if not f.startswith('imgs')]
    assert _files(tmp_path) == files
    _, mismatch, errors = filecmp.cmpfiles(full, tmp_path, files,
                                           shallow=False)
    assert not mismatch and not errors
