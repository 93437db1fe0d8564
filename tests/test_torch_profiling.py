"""`utils/profiling.py`: `named_scope` and a `trace` window on CPU work,
whose Chrome trace JSON is written into the log directory (the tracer's
spans: `test_torch_tracing.py`)."""
import json
import os

import pytest
import torch

from vampire_tpu_torch.utils import profiling


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
