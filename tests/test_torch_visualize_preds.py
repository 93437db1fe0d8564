"""The port's box-overlay tool (`vampire_tpu_torch/tools/visualize_preds.py`)
against the JAX package's `scripts/visualize_preds.py`: the same submission
json and info pkl give the same PNGs, byte for byte."""
import importlib.util
import json
import os
import pickle

import numpy as np
import pytest

from vampire_tpu_torch.data.fake import make_fake_nusc
from vampire_tpu_torch.tools import visualize_preds

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        'jax_visualize_preds', os.path.join(ROOT, 'scripts',
                                            'visualize_preds.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    """A fake tree of 3 samples and a submission of its boxes moved and
    turned a little, scored 0.1 to 0.9; one sample has no entry."""
    root = tmp_path_factory.mktemp('nusc')
    info_path = make_fake_nusc(root, n_samples=3, n_points=64, seed=1,
                               image_content='smooth', occ_shape=(8, 8, 4))
    with open(info_path, 'rb') as f:
        infos = pickle.load(f)
    rng = np.random.default_rng(0)
    results = {}
    for info in infos[:2]:
        boxes = []
        for a in info['ann_infos']:
            q = np.asarray(a['rotation'], np.float64) + rng.normal(0, 0.05, 4)
            boxes.append(dict(
                sample_token=info['sample_token'],
                translation=(np.asarray(a['translation'])
                             + rng.normal(0, 0.5, 3)).tolist(),
                size=list(a['size']), rotation=(q / np.linalg.norm(q))
                .tolist(), velocity=[0.0, 0.0],
                detection_name='car',
                detection_score=float(rng.uniform(0.1, 0.9))))
        results[info['sample_token']] = boxes
    res_path = root / 'results_nusc.json'
    res_path.write_text(json.dumps({'meta': {}, 'results': results}))
    assert sum(len(b) for b in results.values()) > 2
    return root, info_path, res_path


@pytest.mark.parametrize('argv', [[], ['--score-thr', '0.5',
                                       '--max-samples', '1',
                                       '--bev-range', '30']],
                         ids=['defaults', 'threshold'])
def test_panels_equal_the_jax_scripts(inputs, tmp_path, argv):
    root, info_path, res_path = inputs
    common = ['--info', str(info_path), '--results', str(res_path),
              '--data-root', str(root)] + argv
    n_jax = _jax_script().main(common + ['--out', str(tmp_path / 'jax')])
    n_port = visualize_preds.main(common + ['--out', str(tmp_path / 'port')])
    want = sorted(os.listdir(tmp_path / 'jax'))
    assert n_port == n_jax == len(want) == (1 if argv else 2)
    assert sorted(os.listdir(tmp_path / 'port')) == want
    for name in want:
        a = (tmp_path / 'jax' / name).read_bytes()
        b = (tmp_path / 'port' / name).read_bytes()
        assert a == b, name
