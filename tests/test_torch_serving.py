"""The port's InferenceServer on the CPU at tiny_config: micro-batching,
padding, output selection and host NMS."""
import numpy as np
import pytest
import torch

from vampire_tpu.data.synthetic import synthetic_batch, tiny_config
from vampire_tpu_torch.serving import InferenceServer


@pytest.fixture(scope='module')
def server():
    srv = InferenceServer(tiny_config(), device='cpu', max_batch=2,
                          max_wait_ms=50, outputs='metrics').warmup().start()
    yield srv
    srv.stop()


def _sample(cfg, seed):
    b = synthetic_batch(cfg, batch_size=1, n_points=cfg.train.max_points,
                        seed=seed, mode='val')
    return {k: np.asarray(v)[0] for k, v in b.items()}


def test_single_and_batched_requests_match(server):
    """The same sample gives the same outputs alone (padded) and inside a
    micro-batch with another sample. Batch rows are computed independently
    except for fp32 reassociation in batched convs: 1e-5."""
    cfg = server.cfg
    s0, s1 = _sample(cfg, 1), _sample(cfg, 2)
    r0 = server.infer(s0)
    before = server.stats['batches']
    f0, f1 = server.submit(s0), server.submit(s1)
    r0b, r1 = f0.result(timeout=300), f1.result(timeout=300)
    assert server.stats['requests'] >= 3
    assert server.stats['batches'] - before in (1, 2)
    assert set(r0) == {'occ_logits', 'occ_density', 'pts_logits', 'det'}
    for k in ('occ_logits', 'occ_density', 'pts_logits'):
        assert np.isfinite(r0[k]).all()
        np.testing.assert_allclose(r0[k], r0b[k], rtol=1e-5, atol=1e-5)
        assert r1[k].shape == r0[k].shape
    gx, gy, gz = cfg.backbone.occ_grid
    assert r0['occ_logits'].shape == (gx, gy, gz, cfg.backbone.num_classes)
    assert r0['pts_logits'].shape == (cfg.train.max_points,
                                      cfg.backbone.num_classes)


def test_det_output_after_host_nms(server):
    """(boxes (M, 9), scores (M,), labels (M,)) after circle NMS, at most
    nms_post_max_size per task, sorted by score within each task."""
    cfg = server.cfg
    boxes, scores, labels = server.infer(_sample(cfg, 3))['det']
    assert boxes.ndim == 2 and boxes.shape[1] == 9
    assert np.isfinite(boxes).all()
    assert scores.shape == labels.shape == (boxes.shape[0],)
    assert boxes.shape[0] <= cfg.head.nms_post_max_size * len(cfg.head.tasks)
    assert (scores > cfg.head.score_threshold).all()


def test_missing_input_key_raises(server):
    """A request missing a required input fails loudly; one without
    'points' is allowed (camera-only)."""
    cfg = server.cfg
    s = _sample(cfg, 4)
    with pytest.raises(KeyError):
        server.submit({k: v for k, v in s.items()
                       if k != 'intrin'}).result(timeout=300)
    out = server.submit({k: v for k, v in s.items()
                         if k != 'points'}).result(timeout=300)
    assert np.isfinite(out['occ_logits']).all()


def test_bev_render_outputs(server):
    """'bev_renders' returns the BEV seg argmax, height and rgb; without
    'det' no boxes are decoded."""
    cfg = server.cfg
    srv = InferenceServer(cfg, device='cpu',
                          state_dict=server.model.state_dict(),
                          outputs=('bev_renders',))
    got = srv.forward({k: v[None] for k, v in _sample(cfg, 5).items()})
    _, Y, X = cfg.backbone.grid_zyx('det')
    assert set(got) == {'bev_seg', 'bev_height', 'bev_rgb'}
    assert got['bev_seg'].shape == (1, Y, X)
    assert got['bev_rgb'].shape == (1, Y, X, 3)
    assert np.isfinite(got['bev_height']).all()


def test_stop_fails_queued_requests(server):
    srv = InferenceServer(server.cfg, device='cpu',
                          state_dict=server.model.state_dict(),
                          outputs='metrics')
    fut = srv.submit({})          # never started: stays queued
    srv.stop()
    with pytest.raises(RuntimeError, match='stopped'):
        fut.result(timeout=10)


@pytest.mark.parametrize('outputs,err', [
    (None, NotImplementedError),
    (('occ', 'camera_renders'), NotImplementedError),
    (('occ', 'nope'), ValueError),
])
def test_output_selection_rejects(outputs, err):
    """The JAX default (outputs=None) and 'camera_renders' need the camera-
    ray branch, which is not ported yet."""
    with pytest.raises(err):
        InferenceServer(tiny_config(), device='cpu', outputs=outputs)


def test_same_weights_same_outputs_across_servers(server):
    """A server built from another's state_dict serves identical outputs."""
    cfg = server.cfg
    srv = InferenceServer(cfg, device='cpu',
                          state_dict=server.model.state_dict(),
                          outputs='metrics')
    batch = {k: v[None] for k, v in _sample(cfg, 6).items()}
    a, b = server.forward(batch), srv.forward(batch)
    np.testing.assert_array_equal(a['occ_logits'], b['occ_logits'])
    for da, db in zip(a['det'], b['det']):
        np.testing.assert_array_equal(da['scores'], db['scores'])
    assert torch.equal(server.model.backbone.density_conv.bias,
                       srv.model.backbone.density_conv.bias)
