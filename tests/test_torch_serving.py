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


# the JAX server's output keys (vampire_tpu/serving/server.py, `fwd`)
FULL_KEYS = {'occ_logits', 'occ_density', 'pts_logits', 'depth_preds',
             'seg_preds', 'bev_seg', 'det'}
RENDER_KEYS = {'occ_logits', 'occ_density', 'depth_preds', 'seg_preds',
               'rgb_preds'}


@pytest.mark.parametrize('outputs,err', [
    (None, FULL_KEYS),
    (('occ', 'camera_renders'), RENDER_KEYS),
    (('occ', 'nope'), ValueError),
])
def test_output_selection_rejects(server, outputs, err):
    """An unknown output group is rejected. The JAX default (outputs=None,
    the full-render graph) and an explicit 'camera_renders' serve, with the
    JAX server's keys, shapes and dtypes; the rendered depth lies within the
    depth bounds."""
    cfg = server.cfg
    if err is ValueError:
        with pytest.raises(ValueError):
            InferenceServer(cfg, device='cpu', outputs=outputs)
        return
    srv = InferenceServer(cfg, device='cpu',
                          state_dict=server.model.state_dict(),
                          outputs=outputs).start()
    try:
        got = srv.infer(_sample(cfg, 7))
    finally:
        srv.stop()
    assert set(got) == err
    bc = cfg.backbone
    N, (H, W), K = 6, bc.final_dim, bc.num_classes
    assert got['depth_preds'].shape == (N, H, W)
    assert got['depth_preds'].dtype == np.float32
    assert got['seg_preds'].shape == (N, H, W)
    assert got['seg_preds'].dtype == np.int32
    assert ((got['seg_preds'] >= 0) & (got['seg_preds'] < K)).all()
    depth = got['depth_preds']
    assert np.isfinite(depth).all()
    assert (depth >= bc.d_bound[0]).all() and (depth <= bc.d_bound[1]).all()
    if 'rgb_preds' in err:
        assert got['rgb_preds'].shape == (N, H, W, 3)
        assert got['rgb_preds'].dtype == np.float32
    if 'bev_seg' in err:
        _, Y, X = bc.grid_zyx('det')
        assert got['bev_seg'].shape == (Y, X)
        assert got['bev_seg'].dtype == np.int32
        boxes, scores, labels = got['det']
        assert boxes.ndim == 2 and boxes.shape[1] == 9


def test_full_render_matches_metrics_graph(server):
    """The full-render graph serves the metric outputs of the metrics
    graph exactly: the corner table serves the camera rays only, and both
    graphs sample the points with grid_sample on a bf16 copy of the
    field."""
    cfg = server.cfg
    srv = InferenceServer(cfg, device='cpu',
                          state_dict=server.model.state_dict(),
                          outputs=None)
    batch = {k: v[None] for k, v in _sample(cfg, 8).items()}
    full, metrics = srv.forward(batch), server.forward(batch)
    for k in ('occ_logits', 'occ_density', 'pts_logits'):
        np.testing.assert_array_equal(full[k], metrics[k], err_msg=k)


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
