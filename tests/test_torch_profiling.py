"""`utils/profiling.py`: `run_time`'s printed line and running averages
against the JAX package's, `timing_summary`, `named_scope`, and a `trace`
window on CPU work, whose Chrome trace JSON is written into the log
directory. The JAX module is read as text (it imports jax at its top):
its print format is the one the port must keep."""
import json
import os
import re

import pytest
import torch

from vampire_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_run_time_prints_the_jax_line(capsys):
    """Each call prints `<name>: <ms>ms (avg <ms>ms over <n>)` with the JAX
    decorator's f-string, returns the function's result, and feeds
    `timing_summary` the running mean in seconds."""
    with open(os.path.join(ROOT, 'vampire_tpu', 'utils', 'profiling.py')) as f:
        jax_src = f.read()
    fmt = ("print(f'{name}: {dt * 1000:.1f}ms '\n"
           "                  f'(avg {acc[0] / acc[1] * 1000:.1f}ms over "
           "{acc[1]})')")
    assert fmt in jax_src
    with open(os.path.join(ROOT, 'vampire_tpu_torch', 'utils',
                           'profiling.py')) as f:
        assert fmt in f.read()

    @profiling.run_time('test_profiling_matmul')
    def work(n):
        x = torch.ones(n, n)
        return {'y': x @ x, 'n': [n]}

    outs = [work(64), work(32)]
    assert torch.equal(outs[1]['y'], torch.full((32, 32), 32.0))
    lines = capsys.readouterr().out.splitlines()
    pat = re.compile(r'test_profiling_matmul: (\d+\.\d)ms '
                     r'\(avg (\d+\.\d)ms over (\d+)\)$')
    got = [pat.match(ln) for ln in lines]
    assert all(got) and [int(m.group(3)) for m in got] == [1, 2]
    first, second = (float(m.group(1)) for m in got)
    assert float(got[1].group(2)) == pytest.approx((first + second) / 2,
                                                   abs=0.11)
    summary = profiling.timing_summary()
    assert summary['test_profiling_matmul'] * 1000 == pytest.approx(
        (first + second) / 2, abs=0.11)


def test_trace_writes_a_chrome_trace(tmp_path):
    """A CPU window over a named section: the file exists under the log
    directory, is a Chrome trace (traceEvents) and holds the section's
    name; asking for the CUDA activity without a card raises instead of
    dropping it."""
    logdir = tmp_path / 'trace'
    with profiling.trace(str(logdir), device='cpu') as prof:
        with profiling.named_scope('test_profiling_section'):
            torch.ones(128, 128) @ torch.ones(128, 128)
    path = prof.trace_path
    assert os.path.dirname(path) == str(logdir)
    assert os.path.getsize(path) > 0
    with open(path) as f:
        events = json.load(f)['traceEvents']
    assert any(e.get('name') == 'test_profiling_section' for e in events)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            with profiling.trace(str(logdir)):
                pass
