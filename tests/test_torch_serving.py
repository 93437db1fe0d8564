"""The port's InferenceServer on the CPU at tiny_config: micro-batching,
padding, output selection and host NMS; the ReplicaPool and the TCP
front-end, as tests/test_serving.py holds the JAX server's."""
import inspect

import numpy as np
import pytest
import torch

from vampire_tpu.data.synthetic import synthetic_batch, tiny_config
from vampire_tpu_torch.serving import (InferenceServer, ReplicaPool,
                                       TcpClient, serve_tcp)


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
    graph exactly: the channels-last field copy serves the camera rays
    only, and both graphs sample the points with grid_sample on a bf16 copy
    of the field."""
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


def test_with_det_and_the_default_device(server):
    """`device` defaults to 'cuda' (positional order unchanged);
    with_det=False serves no boxes, and an explicit `outputs` decides
    instead of it, as in the JAX server."""
    params = inspect.signature(InferenceServer).parameters
    assert list(params)[:2] == ['cfg', 'device']
    assert params['device'].default == 'cuda'
    cfg = server.cfg
    batch = {k: v[None] for k, v in _sample(cfg, 9).items()}
    sd = server.model.state_dict()
    for kw, det in ((dict(with_det=False), False),
                    (dict(with_det=False, outputs=('occ', 'det')), True),
                    (dict(with_det=True, outputs=('occ',)), False)):
        srv = InferenceServer(cfg, 'cpu', sd, **kw)
        assert srv.with_det == det
        assert ('det' in srv.forward(batch)) == det, kw
    got = InferenceServer(cfg, 'cpu', sd, with_det=False).forward(batch)
    want = server.forward(batch)
    for k in ('occ_logits', 'occ_density', 'pts_logits'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_replica_pool_distributes(server):
    """ReplicaPool spreads requests over its replicas and returns the single
    server's results: replica 2 holds the first server's weights. Rows of a
    micro-batch differ from a padded single row by fp32 reassociation in
    the batched convs: 1e-5, as test_single_and_batched_requests_match."""
    cfg = server.cfg
    srv2 = InferenceServer(cfg, 'cpu', server.model.state_dict(),
                           max_batch=2, max_wait_ms=20,
                           outputs='metrics').start()
    try:
        pool = ReplicaPool([server, srv2])
        want = server.infer(_sample(cfg, 5))
        before = server.stats['requests'], srv2.stats['requests']
        futs = [pool.submit(_sample(cfg, 5)) for _ in range(6)]
        outs = [f.result(timeout=300) for f in futs]
        for o in outs:
            for k in ('occ_logits', 'pts_logits'):
                np.testing.assert_allclose(o[k], want[k], rtol=1e-5,
                                           atol=1e-5, err_msg=k)
            np.testing.assert_allclose(o['det'][0], want['det'][0],
                                       rtol=1e-5, atol=1e-5)
        assert server.stats['requests'] > before[0]
        assert srv2.stats['requests'] > before[1], 'replica 2 got no work'
        assert pool.stats['requests'] == (server.stats['requests']
                                          + srv2.stats['requests'])
    finally:
        srv2.stop()
    with pytest.raises(ValueError):
        ReplicaPool([])


def test_tcp_roundtrip(server):
    """A request over TCP returns what `infer` returns for the same sample,
    array for array and byte for byte; a bad request comes back as the
    server's error and the connection serves on."""
    import pickle
    cfg = server.cfg
    srv = serve_tcp(server)
    try:
        host, port = srv.server_address
        cl = TcpClient(host, port)
        s = _sample(cfg, 3)
        got, want = cl.infer(s), server.infer(s)
        assert set(got) == set(want)
        for k in want:
            if k == 'det':
                for a, b in zip(got[k], want[k]):
                    np.testing.assert_array_equal(a, b)
            else:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert pickle.dumps(got) == pickle.dumps(want)
        with pytest.raises(RuntimeError, match='intrin'):
            cl.infer({k: v for k, v in s.items() if k != 'intrin'})
        assert np.isfinite(cl.infer(s)['pts_logits']).all()
        cl.close()
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.fixture(scope='module')
def three_rows(server):
    """An unstarted server of three rows on the fixture's weights: its
    dispatcher's batch function is driven directly, so that a batch holds
    exactly the requests given."""
    return InferenceServer(server.cfg, 'cpu', server.model.state_dict(),
                           max_batch=3, outputs='metrics')


def _served(srv, samples):
    """`_run_batch` over `samples` as one micro-batch: the results."""
    from concurrent.futures import Future
    reqs = [(s, Future()) for s in samples]
    srv._run_batch(reqs)
    return [f.result(timeout=0) for _, f in reqs]


def test_partial_batch_rows_equal_full_forward(three_rows):
    """A batch of 2 requests in 3 rows: each request gets, bit for bit,
    its row of the full padded forward (`forward` of a plain dict returns
    all rows), boxes after NMS included; the outputs' bytes counted are
    those of the 2 rows, not of 3, and none went through pinned blocks
    on the CPU."""
    from vampire_tpu_torch.serving.server import apply_circle_nms
    srv = three_rows
    cfg = srv.cfg
    samples = [_sample(cfg, 11), _sample(cfg, 12)]
    before = dict(srv.stats)
    got = _served(srv, samples)
    after = dict(srv.stats)
    full = srv.forward(dict(srv._assemble([(s, None) for s in samples])))
    assert all(v.shape[0] == 3 for k, v in full.items() if k != 'det')
    for i, res in enumerate(got):
        assert set(res) == set(full)
        for k in ('occ_logits', 'occ_density', 'pts_logits'):
            assert res[k].dtype == full[k].dtype
            np.testing.assert_array_equal(res[k], full[k][i], err_msg=k)
        for a, b in zip(res['det'], apply_circle_nms(full['det'], cfg.head,
                                                     i)):
            np.testing.assert_array_equal(a, b)
    rows_bytes = sum(v[:2].nbytes for k, v in full.items() if k != 'det')
    rows_bytes += sum(v[:2].nbytes for task in full['det']
                      for v in task.values())
    assert after['d2h_bytes'] - before['d2h_bytes'] == rows_bytes
    assert after['d2h_pinned_bytes'] == before['d2h_pinned_bytes']
    assert after['padded_rows'] - before['padded_rows'] == 1


def test_kept_result_survives_later_batches(three_rows):
    """A result kept from one batch is unchanged after two later batches
    ran on other inputs: no later copy writes into a kept result."""
    srv = three_rows
    cfg = srv.cfg
    kept = _served(srv, [_sample(cfg, 13)])[0]
    frozen = {k: v.copy() for k, v in kept.items() if k != 'det'}
    later = [_served(srv, [_sample(cfg, 14 + j), _sample(cfg, 16 + j)])
             for j in range(2)]
    assert not np.array_equal(later[0][0]['occ_logits'], frozen['occ_logits'])
    for k, v in frozen.items():
        np.testing.assert_array_equal(kept[k], v, err_msg=k)


@pytest.mark.parametrize('rows', [None, 2])
def test_to_numpy_keeps_the_tree(rows):
    """`_to_numpy` (the trainer's too) gives the tree back with numpy
    arrays for tensors: dicts stay dicts, lists and tuples come back as
    lists, other leaves as they are; with `rows`, the first rows of each
    tensor, `leaf[i]` row i; the bytes it counts are those handed out."""
    from vampire_tpu_torch.serving.server import _to_numpy
    g = torch.Generator().manual_seed(0)
    a = torch.randn(3, 4, generator=g)
    b = torch.randint(0, 9, (3, 2), generator=g, dtype=torch.int32)
    c = torch.rand(3, generator=g) > 0.5
    tree = {'a': a, 'nest': [b, {'c': c, 'tag': 'x'}], 'pair': (a, 7)}
    stats = dict(d2h_bytes=0, d2h_pinned_bytes=0)
    out = _to_numpy(tree, rows=rows, stats=stats)
    assert set(out) == {'a', 'nest', 'pair'}
    assert isinstance(out['nest'], list) and isinstance(out['pair'], list)
    assert out['nest'][1]['tag'] == 'x' and out['pair'][1] == 7
    n = 3 if rows is None else rows
    for got, want in ((out['a'], a), (out['nest'][0], b),
                      (out['nest'][1]['c'], c), (out['pair'][0], a)):
        assert isinstance(got, np.ndarray) and got.dtype == want.numpy().dtype
        np.testing.assert_array_equal(got, want.numpy()[:n])
        for i in range(n):
            np.testing.assert_array_equal(got[i], want.numpy()[i])
    assert stats == dict(d2h_bytes=n * (2 * 16 + 8 + 1), d2h_pinned_bytes=0)


@pytest.mark.gpu
def test_outputs_leave_the_card_through_pinned_blocks():
    """On a card: `_to_numpy` of a tree of card tensors equals `.cpu()
    .numpy()` of each, in pinned memory, one block for the tree, or with
    `rows` one block a row; a served batch of 2 requests in 3 rows gives
    each request its own pinned block, its rows of the full padded
    forward, and every byte handed out went through a pinned block."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (pinned host blocks)')
    from vampire_tpu_torch.serving.server import _to_numpy
    g = torch.Generator(device='cuda').manual_seed(0)
    a = torch.randn(3, 5, 7, device='cuda', generator=g)
    b = torch.randint(0, 9, (3, 4), device='cuda', generator=g,
                      dtype=torch.int32)
    c = torch.rand(3, 6, device='cuda', generator=g) > 0.5
    tree = {'a': a, 'nest': [b, {'c': c}], 't': a.transpose(1, 2)}
    want = {'a': a, 'b': b, 'c': c, 't': a.transpose(1, 2)}

    def leaves(out):
        return dict(a=out['a'], b=out['nest'][0], c=out['nest'][1]['c'],
                    t=out['t'])

    whole = leaves(_to_numpy(tree))
    for k, v in whole.items():
        np.testing.assert_array_equal(v, want[k].cpu().numpy(), err_msg=k)
        assert torch.from_numpy(v).is_pinned(), k
    stats = dict(d2h_bytes=0, d2h_pinned_bytes=0)
    split = leaves(_to_numpy(tree, rows=2, stats=stats))
    assert stats['d2h_bytes'] == stats['d2h_pinned_bytes'] == 2 * sum(
        t[0].numel() * t.element_size() for t in want.values())
    for k, v in split.items():
        assert isinstance(v, list) and len(v) == 2
        for i in range(2):
            np.testing.assert_array_equal(v[i], want[k][i].cpu().numpy())
            assert torch.from_numpy(v[i]).is_pinned(), k
        assert not np.shares_memory(v[0], v[1])
    assert _blocks(split['a'][0], split['c'][0], split['t'][0]) == 1
    assert _blocks(split['a'][0], split['a'][1]) == 2

    cfg = tiny_config()
    srv = InferenceServer(cfg, 'cuda', max_batch=3, outputs='metrics')
    samples = [_sample(cfg, 21), _sample(cfg, 22)]
    before = dict(srv.stats)
    got = _served(srv, samples)
    d2h = srv.stats['d2h_bytes'] - before['d2h_bytes']
    pinned = srv.stats['d2h_pinned_bytes'] - before['d2h_pinned_bytes']
    full = srv.forward(dict(srv._assemble([(s, None) for s in samples])))
    assert d2h == pinned > 0
    arrays = [[v for k, v in r.items() if k != 'det'] for r in got]
    for i, res in enumerate(got):
        for k in ('occ_logits', 'occ_density', 'pts_logits'):
            assert res[k].dtype == full[k].dtype
            assert torch.from_numpy(res[k]).is_pinned(), k
            np.testing.assert_allclose(res[k], full[k][i], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        assert _blocks(*arrays[i]) == 1
    assert _blocks(arrays[0][0], arrays[1][0]) == 2
    assert not any(np.shares_memory(x, y) for x in arrays[0]
                   for y in arrays[1])


def _blocks(*arrays) -> int:
    """How many distinct host blocks the arrays view: the storages of the
    tensors at the ends of their `base` chains."""
    def block(a):
        while not isinstance(a, torch.Tensor):
            a = a.base
        return a.untyped_storage().data_ptr()
    return len({block(a) for a in arrays})
