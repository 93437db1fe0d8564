"""The control at the tests' tiny size on the CPU: the reference one
precision step below the configuration's (here fp32, so bf16 operands),
in the program's place, is not correct by the cell's limits, while the
program is. On the card the same is read at each cell's own size by
`tools/readings.py` (PERF.md gives the readings)."""
import pytest

from harness import compare, control
from harness_cpu import run


@pytest.mark.parametrize('traffic', ['train_b2', 'serve_offline_mb2'])
def test_the_control_is_not_correct(traffic):
    result, compared, ctx = run(traffic, seed=21)
    assert result['correct'], compared
    low = control.numbers(ctx)
    ok, judged = compare.judge(low, ctx.cell['limits'])
    assert not ok, judged
    # and it reads worse than the program on every number it fails
    assert any(low[k] > 3 * compared[k]['value'] for k in low)
