"""Device time by owner (`harness/owners.py`) on hand-written events and
on a CPU profiler window, and the program-span readings
(`harness/program_spans.py`, `tools/traced.py`) of tiny CPU runs."""
import time

import pytest
import torch

import harness_cpu
from harness import owners, spec
from harness import program_spans as P
from harness.owners import Event
from tools import traced
from vampire_tpu_torch.utils import profiling

EVAL = owners.BACKWARD


def _host(name, s, e, thread=1, corr=0, linked=0, seq=-1, fwd=0):
    return Event(name, s, e, False, thread, corr, linked, seq, fwd)


def _kernel(s, e, corr):
    return Event('kernel', s, e, True, 0, corr, corr)


def test_owners_on_hand_written_events():
    """A forward launch goes to the span around its operator; a backward
    launch, on another thread numbering, to its forward operator's span
    through `sequence_nr`; a launch with no runtime call is unowned; where
    the call has no operator its own thread and time decide; a range that
    is not the program's owns nothing."""
    ev = [
        _host('model.lift', 100, 200),
        _host('aten::conv2d', 110, 150, corr=5, seq=0),
        _host('cudaLaunchKernel', 120, 125, thread=99, corr=1000, linked=5),
        _host('model.trunk', 210, 300),
        _host('aten::linear', 220, 260, corr=6, seq=1),
        _host('cudaLaunchKernel', 230, 231, corr=1003),
        _host('trainer.backward', 400, 600),
        _host(EVAL + 'AddmmBackward0', 410, 450, thread=2, seq=1, fwd=1),
        _host('AddmmBackward0', 411, 449, thread=2, corr=8, seq=1, fwd=1),
        _host('aten::mm', 415, 440, thread=2, corr=7),
        _host('cudaLaunchKernel', 420, 421, thread=98, corr=1001, linked=7),
        _host(EVAL + 'ConvolutionBackward0', 460, 500, thread=2, seq=0,
              fwd=1),
        _host('aten::convolution_backward', 465, 490, thread=2, corr=9),
        _host('cudaLaunchKernel', 470, 471, thread=98, corr=1002, linked=9),
        _host('trainer.adamw', 700, 800),
        _host('trainer.optimizer', 710, 790),
        _host('aten::_foreach_add_', 720, 730, corr=10),
        _host('cudaLaunchKernel', 721, 722, thread=98, corr=1004, linked=10),
        _kernel(300, 350, 1000),
        _kernel(350, 360, 1003),
        _kernel(500, 560, 1001),
        _kernel(600, 700, 1002),
        _kernel(800, 805, 1004),
        _kernel(900, 1000, 2000),
    ]
    own = owners.Owners(ev, P.NAMES)
    assert own.owner(ev[-6]) == ('model.lift', 'forward')
    assert own.owner(ev[-5]) == ('model.trunk', 'forward')
    assert own.owner(ev[-4]) == ('model.trunk', 'backward')
    assert own.owner(ev[-3]) == ('model.lift', 'backward')
    assert own.owner(ev[-2]) == ('trainer.adamw', 'forward')
    assert own.launcher(ev[-1]) is None
    by = owners.device_by_span(ev, P.NAMES)
    assert by == {'model.lift': [50e-9, 100e-9],
                  'model.trunk': [10e-9, 60e-9],
                  'trainer.adamw': [5e-9, 0.0], 'unowned': [100e-9, 0.0]}
    assert own.split(1, 90, 220) == {'': 20, 'model.lift': 100,
                                     'model.trunk': 10}
    assert own.split(2, 405, 455) == {'': 10, 'backward': 40}
    # without the program's names every prefixed range owns
    assert owners.Owners(ev).owner(ev[-2]) == ('trainer.optimizer',
                                               'forward')


def test_a_cpu_backward_splits_between_its_forward_spans():
    """A CPU profiler window over a conv in one span and a linear in
    another, then backward in a third: each backward function's moment
    belongs to the forward span of its operator, and the forward
    operators to their own spans."""
    conv, lin = torch.nn.Conv2d(3, 4, 3), torch.nn.Linear(16, 2)
    x = torch.randn(2, 3, 6, 6)
    profiling.enable()
    acts = [torch.profiler.ProfilerActivity.CPU]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with profiling.span('model.encoder'):
                y = conv(x)
            with profiling.span('model.head'):
                z = lin(y.reshape(2, 4, 16)).sum()
            with profiling.span('trainer.backward'):
                z.backward()
    finally:
        profiling.disable()
    ev = owners.events_of(prof)
    own = owners.Owners(ev, P.NAMES)
    got = {}
    for e in ev:
        if e.name.startswith(EVAL) and e.seq >= 0:
            got[e.name[len(EVAL):]] = own.at(e.thread, e.start + 1)
    assert got['ConvolutionBackward0'] == ('model.encoder', 'backward')
    assert got['AddmmBackward0'] == ('model.head', 'backward')
    assert got['SumBackward0'] == ('model.head', 'backward')
    fwd = {e.name: own.at(e.thread, e.start) for e in ev
           if e.name in ('aten::conv2d', 'aten::addmm')}
    assert fwd == {'aten::conv2d': ('model.encoder', 'forward'),
                   'aten::addmm': ('model.head', 'forward')}


@pytest.mark.parametrize('traffic', harness_cpu.TRAFFIC)
def test_span_readings_of_tiny_cpu_runs(traffic):
    """With the program's tracer on over the window, a served run reads
    its queue, busy, padding, D2H and NMS spans, and no device time (the
    CPU has no CUDA events and no device trace); without it, nothing."""
    c = spec.cell(f'tiny.{traffic}', harness_cpu.bench(), spec.ROOT,
                  harness_cpu.DATA)
    c['base'] = spec.BENCH_DIR
    result, extra = traced.run(c, 11, 0.5, True, True, 'cpu',
                               time.perf_counter())
    assert result['correct']
    got = extra['spans']
    if traffic.startswith('serve'):
        assert set(got) == {'queue_ms_p50', 'busy_share', 'padded_share',
                            'd2h_ms_a_batch', 'nms_ms_a_batch'}
        assert 0 < got['busy_share'] <= 100
        assert 0 <= got['padded_share'] < 100
    else:
        assert got == {} and extra['spans_kept'] > 0
    assert 'owned_ms_a_unit' not in extra and extra['spans_dropped'] == 0
    _, plain = traced.run(c, 11, 0.5, False, False, 'cpu',
                          time.perf_counter())
    assert plain['spans'] == {} and 'spans_kept' not in plain
