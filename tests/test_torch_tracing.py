"""`utils/profiling.py`'s tracer and the span sites of the server, the
train step and the model, on the CPU at `tiny_config`: off it records
nothing and touches no clock, event or profiler range; on, spans nest by
thread, sit on the profiler's host timeline, count the server's requests,
batches and padding as `stats` does, follow the train step's phases in
order, and change no output bit."""
import copy
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from vampire_tpu_torch.data.synthetic import synthetic_batch, tiny_config
from vampire_tpu_torch.serving import InferenceServer
from vampire_tpu_torch.training.train_step import (build_train_step,
                                                   init_train_confusion)
from vampire_tpu_torch.training.trainer import Trainer
from vampire_tpu_torch.utils import profiling

TRAINER_SPANS = ['trainer.to_device', 'trainer.forward', 'trainer.losses',
                 'trainer.backward', 'trainer.clip', 'trainer.adamw',
                 'trainer.metrics']
MODEL_SPANS = ['model.encoder', 'model.lift', 'model.trunk', 'model.queries',
               'model.rays', 'model.bev', 'model.head']


@pytest.fixture(autouse=True)
def tracer_off():
    profiling.disable()
    yield
    profiling.disable()


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


@pytest.fixture(scope='module')
def trainer():
    """A seeded Trainer at `tiny_config`, one training batch, and the
    state as it was before any step."""
    cfg = tiny_config()
    batch = synthetic_batch(cfg, batch_size=1, n_points=128, seed=0,
                            mode='train')
    with tempfile.TemporaryDirectory() as wd:
        tr = Trainer(cfg, workdir=wd, device='cpu')
        state = tr.init_state(batch, 10)
        tr._log_file.close()
    start = (copy.deepcopy(state.model.state_dict()),
             copy.deepcopy(state.optimizer.state_dict()))
    return tr, state, batch, start


def _one_step(trainer, trace: bool):
    """The first step from the fixture's starting state: its logs, the
    parameters after it, and the spans it gave where `trace`."""
    tr, state, batch, (params, opt) = trainer
    state.model.load_state_dict(params)
    state.optimizer.load_state_dict(copy.deepcopy(opt))
    state.step = 0
    step = build_train_step(tr.cfg, with_metrics=True)
    if trace:
        profiling.enable()
    state, logs, _ = step(state, tr.to_device(batch),
                          init_train_confusion(tr.cfg))
    profiling.disable()
    params = {k: v.detach().clone() for k, v in
              state.model.state_dict().items()}
    return logs, params, profiling.collect()['spans'] if trace else None


def test_off_records_nothing_and_touches_nothing(monkeypatch, trainer):
    """Off (the default), the sites of a served request and of a train step
    run with the profiler range, the CUDA event and the tracer's clock all
    made to raise, and nothing is kept."""
    def boom(*a, **kw):
        raise AssertionError('a span site did work while tracing was off')
    profiling.enable()
    profiling.disable()
    monkeypatch.setattr(torch.profiler, 'record_function', boom)
    monkeypatch.setattr(torch.cuda, 'Event', boom)
    monkeypatch.setattr(profiling.time, 'perf_counter_ns', boom)
    assert profiling.span('server.batch', rows=1) is profiling.span('x')
    with profiling.span('model.lift', device=True) as s:
        assert s is None
    profiling.end(profiling.begin('server.queue', id=3))
    _one_step(trainer, trace=False)
    srv = InferenceServer(tiny_config(), device='cpu', max_batch=2,
                          max_wait_ms=1, outputs='metrics').start()
    try:
        fut = srv.submit(_sample(srv.cfg, 1))
        assert 'det' in fut.result(timeout=300)
        assert not hasattr(fut, 'trace_id')
    finally:
        srv.stop()
    monkeypatch.undo()
    assert profiling.collect()['spans'] == []


def test_spans_nest_by_thread_and_cross_threads(monkeypatch):
    """Parents come from the thread's open spans; `begin`/`end` cross
    threads and parent nothing; `enable` drops an earlier window; past
    MAX_SPANS only the count goes up."""
    profiling.enable()
    with profiling.span('trainer.forward', rows=2) as outer:
        with profiling.span('model.encoder') as inner:
            inner.attrs['extra'] = 1
        q = profiling.begin('server.queue', id=7)
        with profiling.span('model.lift'):
            pass
    seen = {}

    def other():
        with profiling.span('server.batch') as b:
            seen['thread'] = threading.get_native_id()
            profiling.end(q)
            seen['batch'] = b.id
    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    rec = profiling.collect()
    by = {s['name']: s for s in rec['spans']}
    assert [s['name'] for s in rec['spans']] == [
        'model.encoder', 'model.lift', 'trainer.forward', 'server.queue',
        'server.batch']
    assert by['trainer.forward']['parent'] is None
    assert by['trainer.forward']['attrs'] == {'rows': 2}
    assert by['model.encoder']['parent'] == outer.id
    assert by['model.encoder']['attrs'] == {'extra': 1}
    assert by['model.lift']['parent'] == outer.id
    assert by['server.batch']['parent'] is None
    assert by['server.batch']['thread'] == seen['thread']
    assert by['server.queue']['attrs'] == {'id': 7}
    assert by['server.queue']['end_ns'] <= by['server.batch']['end_ns']
    assert all(s['start_ns'] <= s['end_ns'] for s in rec['spans'])
    assert rec['dropped'] == 0 and 'device_ms' not in by['model.lift']

    monkeypatch.setattr(profiling, 'MAX_SPANS', 2)
    profiling.enable()
    for _ in range(5):
        with profiling.span('model.head'):
            pass
    rec = profiling.collect()
    assert len(rec['spans']) == 2 and rec['dropped'] == 3


def _clock_gaps():
    """One CPU profiler window of nested spans: each span's start and end,
    moved by `clock_offset_ns`, less its `record_function` range's (ns)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    profiling.enable()
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.span('model.encoder'):     # the first range's set-up
            pass
        for _ in range(3):
            with profiling.span('model.trunk'):
                with profiling.span('model.queries'):
                    time.sleep(0.002)
    profiling.disable()
    rec = profiling.collect()
    ranges = sorted((e.start_ns(), e.end_ns(), e.name()) for e in
                    prof.profiler.kineto_results.events()
                    if e.name() in ('model.trunk', 'model.queries'))
    spans = sorted((s['start_ns'] + rec['clock_offset_ns'],
                    s['end_ns'] + rec['clock_offset_ns'], s['name'])
                   for s in rec['spans'] if s['name'] != 'model.encoder')
    assert len(ranges) == len(spans) == 6
    assert [r[2] for r in ranges] == [s[2] for s in spans]
    return [max(abs(a0 - b0), abs(a1 - b1))
            for (a0, a1, _), (b0, b1, _) in zip(ranges, spans)]


def test_spans_sit_on_the_profiler_clock():
    """Each span's in-memory start and end, moved by `clock_offset_ns`,
    lie within 50 us of its `record_function` range in a CPU profiler
    window: in one of up to five windows, as the OS may stop the thread
    between the two clocks' reads on a loaded machine."""
    worst = []
    for _ in range(5):
        worst.append(max(_clock_gaps()))
        if worst[-1] < 50_000:
            break
    assert worst[-1] < 50_000, worst


def test_served_requests_give_their_spans(server):
    """max_batch=2: one `server.queue` and one `server.nms` per request,
    under the request's id; one `server.batch` per batch, whose rows and
    padding add up to the `stats` deltas; the batch's phases inside it;
    the outputs bit for bit those of the untraced server."""
    cfg = server.cfg
    samples = [_sample(cfg, s) for s in (5, 6, 7)]
    plain = server.infer(samples[2])
    before = dict(server.stats)
    profiling.enable()
    futs = [server.submit(s) for s in samples[:2]]
    outs = [f.result(timeout=300) for f in futs]
    futs.append(server.submit(samples[2]))
    traced = futs[2].result(timeout=300)
    profiling.disable()

    def named(n):
        return [s for s in spans if s['name'] == n]
    # the dispatcher ends a batch's spans just after its last result
    deadline = time.monotonic() + 60
    while True:
        spans = profiling.collect()['spans']
        if len(named('server.batch')) == server.stats['batches'] - \
                before['batches'] or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    ids = [f.trace_id for f in futs]
    assert len(set(ids)) == 3
    assert sorted(s['attrs']['id'] for s in named('server.queue')) == \
        sorted(ids)
    assert sorted(s['attrs']['id'] for s in named('server.nms')) == \
        sorted(ids)
    batches = named('server.batch')
    d = {k: server.stats[k] - before[k] for k in before}
    assert len(batches) == d['batches']
    assert sum(b['attrs']['rows'] for b in batches) == d['requests'] == 3
    assert sum(b['attrs']['padded'] for b in batches) == d['padded_rows']
    assert sorted(i for b in batches for i in b['attrs']['ids']) == \
        sorted(ids)
    batch_ids = {b['id'] for b in batches}
    for n in ('server.assemble', 'server.h2d', 'server.forward',
              'server.decode', 'server.d2h', 'server.nms',
              'server.deliver'):
        assert named(n) and all(s['parent'] in batch_ids for s in named(n))
    assert len(named('server.linger')) == len(batches)
    assert {s['name'] for s in spans if s['parent'] in
            {x['id'] for x in named('server.forward')}} == {
        'model.encoder', 'model.lift', 'model.trunk', 'model.queries',
        'model.bev', 'model.head'}
    assert all(outs) and set(traced) == set(plain)
    for k in ('occ_logits', 'occ_density', 'pts_logits'):
        assert np.array_equal(traced[k], plain[k])
    for a, b in zip(traced['det'], plain['det']):
        assert np.array_equal(a, b)


def test_train_step_gives_its_phases_in_order_and_the_same_bits(trainer):
    """One train step: each `trainer.*` span once, in the step's order,
    the `model.*` stages in `trainer.forward`; its logs and parameters
    bit for bit those of the untraced step."""
    logs0, params0, _ = _one_step(trainer, trace=False)
    logs1, params1, spans = _one_step(trainer, trace=True)
    top = sorted((s for s in spans if s['name'].startswith('trainer.')),
                 key=lambda s: s['start_ns'])
    assert [s['name'] for s in top] == TRAINER_SPANS
    fwd = top[1]
    model = sorted((s for s in spans if s['name'].startswith('model.')),
                   key=lambda s: s['start_ns'])
    assert [s['name'] for s in model] == MODEL_SPANS
    assert all(s['parent'] == fwd['id'] for s in model)
    assert all(s['parent'] is None for s in top)
    assert all(fwd['start_ns'] <= s['start_ns'] <= s['end_ns']
               <= fwd['end_ns'] for s in model)
    assert logs0.keys() == logs1.keys()
    for k in logs0:
        assert torch.equal(logs0[k], logs1[k]), k
    assert params0.keys() == params1.keys()
    for k in params0:
        assert torch.equal(params0[k], params1[k]), k
