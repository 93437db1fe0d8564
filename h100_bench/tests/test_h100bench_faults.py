"""A whole run at the tests' tiny size on the CPU, sound and with the
timed path broken underneath: `correct` is true for the sound runs and
false for each fault a cell can have (the one-card cells exchange
nothing between chips, so that fault has no cell here)."""
import pytest

from harness import faults
from harness_cpu import run


@pytest.mark.parametrize('traffic', ['train_b2', 'serve_poisson_mb2',
                                     'serve_offline_mb2'])
def test_sound_runs_are_correct(traffic):
    result, compared, _ = run(traffic)
    assert result['correct'], compared
    assert result['failed'] == 0 and result['attempted'] > 0
    assert list(result)[-1] == 'compared'


@pytest.mark.parametrize('fault', sorted(faults.TRAIN))
def test_train_faults_are_not_correct(fault):
    keep = {}
    try:
        result, compared, ctx = run('train_b2', fault=planted(
            faults.TRAIN[fault], keep))
    finally:
        keep.get('undo', lambda: None)()
    assert not result['correct'], compared


def planted(fault, keep):
    """`fault`, its undo kept where the test can call it."""
    def plant(ctx, *a):
        out = fault(ctx, *a)
        keep.update(ctx.keep)
        return out
    return plant


@pytest.mark.parametrize('traffic', ['serve_poisson_mb2',
                                     'serve_offline_mb2'])
@pytest.mark.parametrize('fault', sorted(faults.SERVE))
def test_serve_faults_are_not_correct(traffic, fault):
    keep = {}
    try:
        result, compared, _ = run(traffic, fault=planted(
            faults.SERVE[fault], keep))
    finally:
        keep.get('undo', lambda: None)()
    assert not result['correct'], compared
