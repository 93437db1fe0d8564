"""The benchmark's data, found by name: `BENCHMARK.json` at the root of
the checkout, `configs/<config>.json`, `traffic/<traffic>.json`,
`limits/<cell>.json` and `metrics/<metric>.py` under the benchmark's
folder. Nothing here names a cell: a new cell, configuration, traffic mix
or per-layer metric is a new file."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Callable, Dict, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, 'BENCHMARK.json'))


def cell(name: str, bench: Optional[dict] = None, root: str = ROOT,
         base: str = BENCH_DIR) -> dict:
    """The `workloads` entry of `name`, with its configuration, traffic and
    limits files read, and the metrics `BENCHMARK.json` asks of it (each
    file under `base`, the benchmark's folder)."""
    bench = benchmark(root) if bench is None else bench
    found = [w for w in bench['workloads'] if w['name'] == name]
    if not found:
        raise SystemExit(f'no workload named {name!r} in BENCHMARK.json')
    w = dict(found[0])
    w['config_file'] = config_file(w['config'], bench, root)
    w['traffic_file'] = load_json(os.path.join(base, 'traffic',
                                               w['traffic'] + '.json'))
    w['limits'] = load_json(os.path.join(base, 'limits', name + '.json'))
    w['base'] = base
    w['end_to_end'] = [m for m in bench['end_to_end']
                       if name in m.get('workloads', [name])]
    w['per_layer'] = [m for m in bench['per_layer']
                      if name in m.get('workloads', [name])]
    return w


def config_file(name: str, bench: dict, root: str = ROOT) -> dict:
    found = [c for c in bench['configs'] if c['name'] == name]
    if not found:
        raise SystemExit(f'no configuration named {name!r}')
    return load_json(os.path.join(root, found[0]['file']))


def _tuples(v):
    if isinstance(v, list):
        return tuple(_tuples(x) for x in v)
    return v


def build_config(config: dict, module) -> Any:
    """The `VampireConfig` of a configuration file's `config` (the whole
    dataclass tree as `dataclasses.asdict` gives it), built from the
    classes of `module`: the program's `configs` or the reference's."""
    groups = dict(backbone=module.BackboneConfig, head=module.HeadConfig,
                  ida_aug=module.IdaAugConfig, bda_aug=module.BdaAugConfig,
                  train=module.TrainConfig)
    kw = {}
    for key, cls in groups.items():
        names = {f.name for f in dataclasses.fields(cls)}
        given = config[key]
        if set(given) != names:
            raise ValueError(f'config group {key}: keys differ from '
                             f'{cls.__name__}: '
                             f'{sorted(set(given) ^ names)}')
        kw[key] = cls(**{k: _tuples(v) for k, v in given.items()})
    return module.VampireConfig(**kw)


def metric_reader(name: str, base: str = BENCH_DIR) -> Callable:
    """`read` of `metrics/<name>.py` under `base`."""
    path = os.path.join(base, 'metrics', name + '.py')
    spec = importlib.util.spec_from_file_location(
        'bench_metric_' + name.replace('.', '_').replace('-', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(kind: str):
    """The driver module of a traffic kind: `harness/drivers/<kind>.py`."""
    return importlib.import_module(f'harness.drivers.{kind}')


def as_dict(cfg) -> Dict[str, Any]:
    return json.loads(json.dumps(dataclasses.asdict(cfg)))
