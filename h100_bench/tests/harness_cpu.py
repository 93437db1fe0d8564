"""Runs of the harness on the CPU at the tests' tiny sizes (`data/`):
every step of a run but the look for a card, so that a test can break
the timed path underneath and see what the check decides."""
import os
import time

from harness import cli, spec

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data')
TRAFFIC = ('train_b2', 'serve_poisson_mb2', 'serve_offline_mb2')


def bench():
    cells = [f'tiny.{t}' for t in TRAFFIC]
    return dict(
        configs=[dict(name='tiny', file='h100_bench/tests/data/configs/'
                      'tiny.json')],
        workloads=[dict(name=c, config='tiny', traffic=c.split('.')[1],
                        chips=1, why='test') for c in cells],
        end_to_end=[
            dict(name='setup_s', unit='s'),
            dict(name='train_samples_per_s', unit='samples/s',
                 workloads=[cells[0]]),
            dict(name='train_peak_gib', unit='GiB', workloads=[cells[0]]),
            dict(name='serve_p50_ms', unit='ms', workloads=[cells[1]]),
            dict(name='serve_frames_per_s', unit='frames/s',
                 workloads=[cells[2]])],
        per_layer=[dict(name='server.wait_ms.p50', unit='ms',
                        workloads=[cells[1]]),
                   dict(name='server.tail_p95_ms.p50', unit='ms',
                        workloads=[cells[1]]),
                   dict(name='server.post_ms.fps', unit='ms',
                        workloads=[cells[2]])])


def run(traffic, seed=11, seconds=1.0, trace=False, fault=None):
    c = spec.cell(f'tiny.{traffic}', bench(), spec.ROOT, DATA)
    # the per-layer readers are the benchmark's own
    c['base'] = spec.BENCH_DIR
    return cli.run_cell(c, seed, seconds, trace, 'cpu', time.perf_counter(),
                        fault)
