"""The port's dp x cam layout (`vampire_tpu_torch/parallel/mesh.py`) against
the JAX package's mesh (`vampire_tpu/parallel/mesh.py`) on the suite's 8
virtual CPU devices, with no process group: the default shape of each
world, each rank's coordinates, each rank's share of a batch, and the ray
samplers' frame-wide sort when a frame's cameras are split.

JAX lays its devices out as `np.asarray(devices).reshape(dp, cam)`; the
port puts rank r where JAX puts device r. JAX shards a batch by
`batch_pspecs` (rows over 'dp', the camera axis of the camera-carrying keys
over 'cam'); the port's loader gives a rank the rows of its dp index, and
`shard_batch` keeps its cameras. Each device's addressable shard must be,
key by key, byte for byte, the port's rank's batch.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from vampire_tpu.data.synthetic import synthetic_batch, tiny_config
from vampire_tpu.parallel import mesh as jmesh
from vampire_tpu_torch.core import rendering as R
from vampire_tpu_torch.parallel import distributed, mesh

WORLDS = range(1, 9)
# rows of the sharded batches: a multiple of every dp size of worlds 1-8
ROWS = 12


def _position(jax_mesh, device):
    """(dp index, cam index) of `device` in a JAX mesh."""
    (pos,) = np.argwhere(jax_mesh.devices == device)
    return tuple(int(v) for v in pos)


@pytest.mark.parametrize('world', WORLDS)
def test_default_layout_is_the_default_mesh(world):
    """`default_shape` is `default_mesh`'s (dp, cam), and each rank's
    coordinates are its device's place in that mesh."""
    devices = jax.devices()[:world]
    jm = jmesh.default_mesh(devices)
    dp, cam = mesh.default_shape(world)
    assert (jm.shape['dp'], jm.shape['cam']) == (dp, cam)
    for r, dev in enumerate(devices):
        lay = mesh.make_layout(dp, cam, world, r)
        assert (lay.dp_index, lay.cam_index) == _position(jm, dev)
        assert (lay.dp, lay.cam, lay.size) == (dp, cam, world)
        assert lay.cam_group is None and lay.dp_group is None
        assert not lay.split_cameras


@pytest.mark.parametrize('world', WORLDS)
def test_every_layout_matches_make_mesh(world):
    """For every cam size that divides the world, `coords` places rank r
    where `make_mesh(dp, cam)` places device r."""
    devices = jax.devices()[:world]
    for cam in [c for c in range(1, world + 1) if world % c == 0]:
        jm = jmesh.make_mesh(dp=world // cam, cam=cam, devices=devices)
        for r, dev in enumerate(devices):
            assert mesh.coords(r, cam) == _position(jm, dev), (cam, r)


def test_make_layout_refuses_a_wrong_shape():
    with pytest.raises(ValueError, match='layout'):
        mesh.make_layout(3, 2, 8, 0)
    assert mesh.make_layout() == mesh.SINGLE
    assert mesh.default_layout() == mesh.SINGLE
    assert not distributed.active()


def _sweep_batch(cfg, rows):
    """A (B, F=2, N, ...) multi-sweep batch of two synthetic frames (the
    loader's `stack_frames` layout), with the loader's `sensor2sensor`."""
    a = synthetic_batch(cfg, batch_size=rows, n_points=16, seed=3)
    b = synthetic_batch(cfg, batch_size=rows, n_points=16, seed=4)
    out = dict(a)
    for k in ('imgs', 'sensor2ego', 'intrin', 'ida', 'depth_labels',
              'seg_labels'):
        out[k] = np.stack([a[k], b[k]], axis=1)
    out['sensor2sensor'] = np.stack([a['sensor2ego'], b['sensor2ego']],
                                    axis=1)
    return out


def _single_batch(cfg, rows):
    out = synthetic_batch(cfg, batch_size=rows, n_points=16, seed=5)
    out['sensor2sensor'] = out['sensor2ego'].copy()
    return out


@pytest.mark.parametrize('frames', ['single', 'sweeps'])
@pytest.mark.parametrize('world', [2, 3, 4, 6, 8])
def test_shard_batch_is_each_devices_shard(world, frames):
    """Each device's shard of the batch under `batch_pspecs` +
    `NamedSharding` equals, key by key, byte for byte, `shard_batch` of its
    rank's dp rows (axis 1 the camera axis of a 5-D batch, axis 2 of a
    6-D one)."""
    cfg = tiny_config()
    batch = (_single_batch if frames == 'single' else _sweep_batch)(cfg,
                                                                    ROWS)
    devices = jax.devices()[:world]
    jm = jmesh.default_mesh(devices)
    dp, cam = mesh.default_shape(world)
    specs = jmesh.batch_pspecs(batch)
    shards = {k: {s.device: np.asarray(s.data) for s in jax.device_put(
        v, NamedSharding(jm, specs[k])).addressable_shards}
        for k, v in batch.items()}
    per = ROWS // dp
    split = 0
    for r, dev in enumerate(devices):
        lay = mesh.make_layout(dp, cam, world, r)
        rows = {k: v[lay.dp_index * per:(lay.dp_index + 1) * per]
                for k, v in batch.items()}
        mine = mesh.shard_batch(rows, lay)
        assert set(mine) == set(batch)
        for k, v in mine.items():
            want = shards[k][dev]
            assert v.dtype == want.dtype and v.shape == want.shape, (r, k)
            assert np.ascontiguousarray(v).tobytes() == want.tobytes(), \
                (r, k)
            split += v.shape[:3] != rows[k].shape[:3]
    # the camera-carrying keys split where cam > 1, and only they
    assert split == (7 * world if cam > 1 else 0)


def test_shard_batch_of_tensors_and_a_wrong_camera_count():
    lay = mesh.make_layout(1, 2, 2, 1)
    x = torch.arange(2 * 6 * 3).reshape(2, 6, 3)
    out = mesh.shard_batch({'imgs': x.reshape(2, 6, 3, 1, 1),
                            'points': x}, lay)
    assert torch.equal(out['imgs'], x.reshape(2, 6, 3, 1, 1)[:, 3:])
    assert out['points'] is x
    with pytest.raises(ValueError, match='cameras'):
        mesh.shard_batch({'intrin': np.zeros((1, 5, 4, 4))}, lay)
    assert mesh.shard_batch({'imgs': x}, mesh.SINGLE)['imgs'] is x


@pytest.mark.parametrize('cut', [2, 3])
def test_compact_validity_sorts_the_whole_frame(cut):
    """With a frame's rays cut into parts (its cameras over the ranks of a
    cam group), each part's `compact_valid` under the split equals its rows
    of the whole frame's: the sort and the caps are the frame's."""
    rng = np.random.default_rng(cut)
    Rn, S, chunk = 1536, 24, 8
    lengths = rng.integers(0, S + 1, Rn)
    valid = torch.from_numpy((np.arange(S)[None] < lengths[:, None])
                             .astype(np.float32))
    fracs = (0.9, 0.4, 0.1)
    whole = R.compact_valid(valid, chunk, fracs)
    parts = torch.chunk(valid, cut)
    got = []
    for i, p in enumerate(parts):
        def split(x, i=i):
            rows = [R.ray_lengths(q) for q in parts]
            rows[i] = x
            return torch.cat(rows), sum(len(q) for q in parts[:i])
        got.append(R.compact_valid(p, chunk, fracs, split))
    assert torch.equal(torch.cat(got), whole)
    # the parts alone would cap each part's rays apart: not the frame's
    alone = torch.cat([R.compact_valid(p, chunk, fracs) for p in parts])
    assert not torch.equal(alone, whole)


@pytest.mark.parametrize('cut', [2, 3])
def test_earlyterm_stops_sort_the_whole_frame(cut):
    """The early-termination stops under the split: each part's stops,
    exits and misses are its rows of the whole frame's."""
    rng = np.random.default_rng(10 + cut)
    Rn, S, chunk, prefix = 1536, 36, 6, 2
    lengths = rng.integers(0, S + 1, Rn)
    valid = torch.from_numpy((np.arange(S)[None] < lengths[:, None])
                             .astype(np.float32))
    sd = torch.from_numpy(rng.uniform(0, 8, Rn).astype(np.float32))
    fracs = (0.8, 0.5, 0.3, 0.1)
    whole = R.earlyterm_stops(sd, valid, chunk, prefix, fracs)
    vparts, sparts = torch.chunk(valid, cut), torch.chunk(sd, cut)
    got = []
    for i, (v, s) in enumerate(zip(vparts, sparts)):
        def split(x, i=i):
            if x.dtype == torch.float32:
                rows = list(sparts)
            else:
                rows = [R.ray_lengths(q) for q in vparts]
            rows[i] = x
            return torch.cat(rows), sum(len(q) for q in vparts[:i])
        got.append(R.earlyterm_stops(s, v, chunk, prefix, fracs, split))
    for j in range(3):
        assert torch.equal(torch.cat([g[j] for g in got]), whole[j])
    alone = torch.cat([R.earlyterm_stops(s, v, chunk, prefix, fracs)[0]
                       for v, s in zip(vparts, sparts)])
    assert not torch.equal(alone, whole[0])
