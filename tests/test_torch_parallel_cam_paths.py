"""Two more paths under the camera axis (`vampire_tpu_torch/parallel/mesh.py`),
two gloo ranks at dp 1 x cam 2 against one process on the same batch: a
multi-sweep batch, (B, F, N, ...), whose camera axis is axis 2, so that
each rank lifts F x N/2 views and renders its key-frame cameras; and the
render panels of `log_images`, which under a camera split every rank
renders for its own cameras and rank 0 draws for the frame's six.

The batch is two rows of two frames (synthetic seeds 3 and 4 stacked as
the loader's `stack_frames` stacks a key frame and a sweep), tiny_config
in fp32 with the dense lift on both sides and the density bias at 0; one
`fit` step with `image_every=1`. The bounds are
`tests/test_torch_parallel_cam.py`'s: JAX's loss and grad_norm bounds,
and per-tensor |d| / |g| by its median and its largest (measured:
5.6e-6 and 1.6e-5)."""
import dataclasses

import numpy as np
import pytest

from vampire_tpu_torch.configs import synthetic_batch, tiny_config
from vampire_tpu_torch.parallel import distributed
from vampire_tpu_torch.parallel._testing import (trainer_run, unclipped,
                                                 zero_density_bias)

VIEW_KEYS = ('imgs', 'sensor2ego', 'intrin', 'ida', 'depth_labels',
             'seg_labels')
PANELS = ('rgb_gts', 'rgb_preds', 'depth_preds', 'seg_preds', 'bev_seg',
          'bev_height')
LOSS_RTOL, NORM_RTOL = 2e-5, 2e-4
GRAD_RTOL, KINK_RTOL = 3e-4, 0.1


def _cfg(world):
    cfg = tiny_config()
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, compute_dtype='float32', max_epochs=1,
        batch_size_per_device=2 // world, num_devices=world))


def _sweep_batch():
    """Two rows of two frames: every view key stacked on a frame axis."""
    cfg = _cfg(1)
    a, b = (synthetic_batch(cfg, batch_size=2, n_points=128, seed=s,
                            mode='train') for s in (3, 4))
    out = dict(a)
    for k in VIEW_KEYS:
        out[k] = np.stack([a[k], b[k]], axis=1)
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    batch = _sweep_batch()
    dirs = [tmp_path_factory.mktemp(f'w{w}') for w in (1, 2)]
    one = trainer_run(_cfg(1), [[batch]], str(dirs[0]), device='cpu',
                      init_hook=zero_density_bias, num_devices=2,
                      lift_vectorized=True, image_every=1)
    two = distributed.spawn(
        trainer_run, 2, (_cfg(2), [[batch], [batch]], str(dirs[1]), None,
                         None, zero_density_bias, 0, None, 2, None, None,
                         False, None, 1),
        device='cpu', timeout_s=600)
    exp = tiny_config().train.exp_name
    return dict(one=one, two=two,
                panels=[d / exp / 'panels' for d in dirs])


def test_a_multi_sweep_step_matches_one_process(runs):
    """The step on a (2, 2, 6, ...) batch, each rank lifting 2 x 3 views:
    its logs, and its unclipped gradients summed over the ranks."""
    one, (r0, r1) = runs['one'], runs['two']
    assert (r0['cam'], r0['cam_index'], r1['cam_index']) == (2, 0, 1)
    assert r0['logs'][0] == r1['logs'][0]
    for k, ref in one['logs'][0].items():
        np.testing.assert_allclose(
            r0['logs'][0][k], ref, atol=1e-7,
            rtol=NORM_RTOL if k == 'grad_norm' else LOSS_RTOL, err_msg=k)
    clip = tiny_config().train.gradient_clip_val
    want = unclipped(one['grads'], one['logs'][0]['grad_norm'], clip)
    got = unclipped(r0['grads'], r0['logs'][0]['grad_norm'], clip)
    rel = {n: float(np.linalg.norm(got[n] - g) / np.linalg.norm(g))
           for n, g in want.items() if np.any(g)}
    assert len(rel) > 50
    assert np.median(list(rel.values())) <= GRAD_RTOL
    assert max(rel.values()) <= KINK_RTOL, max(rel, key=rel.get)
    # the launches of the step: none on the CPU (plain versions)
    assert set(r0['launches'].values()) == {0}


def test_panels_of_the_split_cameras_match_one_process(runs):
    """`log_images` after the step: rank 0 alone writes the six panels; the
    input tile is the one process's byte for byte, and the renders' and BEV
    panels agree but for pixels where a rendered value sits at a
    quantisation or argmax boundary (at most 1e-3 of them; measured: every
    panel byte for byte)."""
    from PIL import Image
    ones, twos = runs['panels']
    names = sorted(p.name for p in twos.iterdir())
    assert names == sorted(p.name for p in ones.iterdir())
    assert sorted(n.split('_', 1)[1][:-4] for n in names) == sorted(PANELS)
    for name in names:
        a = np.asarray(Image.open(ones / name)).astype(np.int16)
        b = np.asarray(Image.open(twos / name)).astype(np.int16)
        assert a.shape == b.shape, name
        if 'rgb_gts' in name:
            assert np.array_equal(a, b)
        moved = np.any(np.abs(a - b) > 1, axis=-1).mean()
        assert moved <= 1e-3, (name, moved)
