"""The benchmark's data files: BENCHMARK.json against the contract's
shape, every configuration, traffic mix, limits file and per-layer
reader found by name and parsed, and a new cell, configuration, traffic
mix and metric added as new files only."""
import hashlib
import json
import os
import re
import shutil

import pytest

from harness import spec

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}
CHECKED = {'train_closed': {'forward_gap', 'render_gap', 'heatmap_gap',
                            'grad_gap', 'update_gap'},
           'serve_open': {'occ_gap', 'density_gap', 'points_gap', 'det_gap'},
           'serve_closed': {'occ_gap', 'density_gap', 'points_gap',
                            'det_gap'}}


@pytest.fixture(scope='module')
def bench():
    return spec.benchmark()


def test_top_level_shape(bench):
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert bench['paths'] == ['h100_bench']
    assert bench['command'] == ['python3', 'h100_bench/run.py']
    assert 1 <= bench['run_seconds'] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_entries(bench):
    names = [c['name'] for c in bench['configs']]
    cells = [w['name'] for w in bench['workloads']]
    metrics = [m['name'] for m in bench['end_to_end'] + bench['per_layer']]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in bench['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('h100_bench/configs/')
        assert c['reduced'] == []
    for w in bench['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['config'] in names and w['chips'] == 1
        assert 1 <= len(w['why']) <= 200 and '\n' not in w['why']
    e2e = {m['name']: m for m in bench['end_to_end']}
    assert e2e['setup_s']['bound'] <= 0.25
    for m in bench['end_to_end'] + bench['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        assert m['source'] in SOURCES
        assert set(m.get('workloads', cells)) <= set(cells)
    for m in bench['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in bench['per_layer']:
        assert m['moves'] in e2e and m['moves'] != 'setup_s'
        assert set(m['workloads']) <= set(e2e[m['moves']].get('workloads',
                                                              cells))
        assert 1 <= len(m['layer']) <= 200


@pytest.mark.parametrize('name', [w['name'] for w in
                                  spec.benchmark()['workloads']])
def test_every_cell_resolves(name, bench):
    c = spec.cell(name, bench)
    assert {m['name'] for m in c['end_to_end']} >= {'setup_s'}
    assert len(c['end_to_end']) >= 2 and c['per_layer']
    kind = c['traffic_file']['kind']
    assert spec.driver(kind).run
    assert set(c['limits']) == CHECKED[kind]
    for m in c['per_layer']:
        assert callable(spec.metric_reader(m['name']))


@pytest.mark.parametrize('name', [c['name'] for c in
                                  spec.benchmark()['configs']])
def test_configs_are_the_published_presets(name, bench):
    from vampire_tpu_torch import configs as PC
    from reference import configs as RC
    conf = spec.config_file(name, bench)
    preset = {'lss_inpaintor_ds': PC.flagship_config(),
              'bilinear': PC.ablation_config('bilinear')}[name]
    assert conf['config'] == spec.as_dict(preset)
    assert spec.build_config(conf['config'], PC) == preset
    assert spec.as_dict(spec.build_config(conf['config'], RC)) == \
        spec.as_dict(preset)
    assert conf['reduced'] == []
    assert set(conf['weights']) == {'residual_bn_gamma', 'density_head'}
    assert conf['weights']['density_head'] == 'partly_opaque'


def _digests(folder):
    out = {}
    for d, _, files in os.walk(folder):
        for f in files:
            p = os.path.join(d, f)
            with open(p, 'rb') as fh:
                out[os.path.relpath(p, folder)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_files_only_add_a_cell(tmp_path, bench):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    cell with its limits and a per-layer metric, each a new file (and
    the cell's and metric's entries in BENCHMARK.json); the files that
    were there are unchanged and everything resolves by name."""
    root = tmp_path / 'checkout'
    base = root / 'h100_bench'
    for d in ('configs', 'traffic', 'limits', 'metrics'):
        shutil.copytree(os.path.join(spec.BENCH_DIR, d), base / d)
    before = _digests(base)
    conf = json.load(open(os.path.join(spec.BENCH_DIR, 'configs',
                                       'bilinear.json')))
    conf['name'] = 'bilinear_copy'
    (base / 'configs' / 'bilinear_copy.json').write_text(json.dumps(conf))
    (base / 'traffic' / 'serve_closed_mb2.json').write_text(json.dumps(
        dict(kind='serve_closed', in_flight=4, max_batch=2, max_wait_ms=5.0,
             outputs='metrics', pool=4, check_sample=2)))
    (base / 'limits' / 'bilinear_copy.serve_closed_mb2.json').write_text(
        json.dumps(dict(occ_gap=1, density_gap=1, points_gap=1, det_gap=1)))
    (base / 'metrics' / 'server.fill.fps.py').write_text(
        'def read(readings):\n    s = readings.get("server_stats")\n'
        '    return None if not s else s["requests"] / s["batches"]\n')
    b = json.loads(json.dumps(bench))
    b['configs'].append(dict(name='bilinear_copy', source='x',
                             file='h100_bench/configs/bilinear_copy.json',
                             reduced=[], why='x'))
    b['workloads'].append(dict(name='bilinear_copy.serve_closed_mb2',
                               config='bilinear_copy',
                               traffic='serve_closed_mb2', chips=1,
                               why='x'))
    for m in b['end_to_end']:
        if 'serve_frames_per_s' == m['name']:
            m['workloads'].append('bilinear_copy.serve_closed_mb2')
    b['per_layer'].append(dict(name='server.fill.fps', unit='%',
                               better='higher', source='program_counter',
                               layer='server (serving/server.py)',
                               moves='serve_frames_per_s',
                               workloads=['bilinear_copy.serve_closed_mb2']))
    c = spec.cell('bilinear_copy.serve_closed_mb2', b, str(root), str(base))
    assert c['config_file']['name'] == 'bilinear_copy'
    assert c['traffic_file']['max_batch'] == 2
    assert [m['name'] for m in c['per_layer']] == ['server.fill.fps']
    read = spec.metric_reader('server.fill.fps', str(base))
    assert read(dict(server_stats=dict(requests=6, batches=3))) == 2
    assert read({}) is None
    after = _digests(base)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {
        'configs/bilinear_copy.json', 'traffic/serve_closed_mb2.json',
        'limits/bilinear_copy.serve_closed_mb2.json',
        'metrics/server.fill.fps.py'}
