"""The port's CLI (`vampire_tpu_torch/cli.py`) against the JAX package's:
the argument parser (the same namespace for the same argv, but for the
port's `--device`), the `ablation_config` presets, the flags that reach
code the port does not have yet (each raises and names its ROADMAP.md
item), and `--debug` end to end on a fake nuScenes tree at `tiny_config`
on the CPU: fit for one epoch, then `-v`, `-t` (the in-repo NDS/mAP), `-p`
(the lidarseg bins) and `-t --vis` (the pickles)."""
import dataclasses
import json
import shutil

import numpy as np
import pytest

from vampire_tpu import cli as jcli
from vampire_tpu import configs as jcfg
from vampire_tpu_torch import cli
from vampire_tpu_torch import configs as tcfg
from vampire_tpu_torch.data.fake import make_fake_nusc
from vampire_tpu_torch.data.synthetic import tiny_config

ARGVS = [
    [],
    ['-v', '--ckpt-step', '23', '-b', '2'],
    ['-t', '--vis', '--use-ema'],
    ['-p', '--trainval', '--num-workers', '0', '--seed', '3'],
    ['--exp', 'flagship', '--debug', '--max-epochs', '1', '--no-resume',
     '--data-root', '/data', '--workdir', '/out', '--num-devices', '1',
     '--sweep-idxes', '0,2', '--pretrained-backbone', 'r50.pth'],
]


@pytest.mark.parametrize('argv', ARGVS, ids=lambda a: ' '.join(a) or 'none')
def test_argparser_matches_jax(argv):
    got = vars(cli.build_argparser().parse_args(argv))
    want = vars(jcli.build_argparser().parse_args(argv))
    assert got.pop('device') == 'cuda'
    assert got == want
    assert cli._parse_sweep_idxes('0, 2') == jcli._parse_sweep_idxes('0, 2')


def test_argparser_modes_exclude_each_other():
    for argv in (['-v', '-t'], ['-t', '-p']):
        with pytest.raises(SystemExit):
            cli.build_argparser().parse_args(argv)


@pytest.mark.parametrize('name', ['bilinear', 'lss', 'lss_inpaintor',
                                  'lss_inpaintor_depth',
                                  'lss_inpaintor_depth_semantic',
                                  'vampire2'])
def test_ablation_presets_match_jax(name):
    assert (dataclasses.asdict(tcfg.ablation_config(name))
            == dataclasses.asdict(jcfg.ablation_config(name)))


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """A fake tree at tiny_config (its Occ3D labels on the model's occ
    grid, every cloud inside max_points, which eval must not crop), as the
    train, val and test splits."""
    cfg = tiny_config()
    root = tmp_path_factory.mktemp('nusc')
    make_fake_nusc(root, n_samples=2, n_points=cfg.train.max_points - 8,
                   seed=0, image_content='smooth',
                   occ_shape=cfg.backbone.occ_grid)
    for name in ('nuscenes_occ_infos_train.pkl', 'nuscenes_occ_infos_val.pkl',
                 'nuscenes_infos_test.pkl'):
        shutil.copy(root / 'infos_train.pkl', root / name)
    return root


@pytest.mark.parametrize('argv,item', [
    (['--num-devices', '2'], 'item 5'),
    (['--exp', 'bilinear'], 'item 6'),
    (['--exp', 'lss'], 'item 6'),
    (['--exp', 'vampire2'], 'item 6'),
    (['--debug', '--sweep-idxes', '0', '--no-resume'], 'item 6'),
    (['--debug', '--sweep-idxes', '0', '-v'], 'item 6'),
    (['--debug', '--pretrained-backbone', 'r50.pth'], 'item 9'),
])
def test_flags_of_unported_code_raise(tree, tmp_path, argv, item):
    """Each raises NotImplementedError naming the ROADMAP.md item: the
    device count at once, the other variants when their model is built,
    the sweeps at the first multi-frame forward, the pretrained backbone at
    init. --sweep-idxes -v restores a checkpoint of the same tree first."""
    common = ['--device', 'cpu', '-b', '1', '--max-epochs', '1',
              '--data-root', str(tree), '--workdir', str(tmp_path),
              '--num-workers', '1']
    if '-v' in argv:
        cli.main(common + ['--debug', '--no-resume'])
    with pytest.raises(NotImplementedError, match=item):
        cli.main(common + argv)


def test_cli_debug_end_to_end(tree, tmp_path):
    """fit writes a checkpoint and finite losses; -v restores it and
    validates; -t writes the submission and a finite in-repo NDS; -p the
    test split's lidarseg bins; -t --vis one pickle a frame."""
    cfg = tiny_config()
    wd = tmp_path / 'out'
    common = ['--debug', '-b', '1', '--data-root', str(tree),
              '--workdir', str(wd), '--num-workers', '2']
    cli.main(common + ['--max-epochs', '1', '--no-resume'])
    exp = wd / cfg.train.exp_name
    assert [p.name for p in (exp / 'checkpoints').iterdir()] == ['0.pt']
    rows = [json.loads(ln) for ln in
            (exp / 'scalars.jsonl').read_text().splitlines()]
    losses = [r['total_loss'] for r in rows if 'total_loss' in r]
    assert losses and all(np.isfinite(v) for v in losses)

    cli.main(common + ['-v'])
    cli.main(common + ['-t'])
    sub = exp / 'detection_submit'
    assert sorted(json.loads((sub / 'results_nusc.json').read_text())
                  ['results']) == ['s0', 's1']
    summary = json.loads((sub / 'metrics_summary.json').read_text())
    assert np.isfinite(summary['nd_score'])
    assert np.isfinite(summary['mean_ap'])
    assert 'car' in summary['label_aps']

    cli.main(common + ['-p'])
    bins = sorted(p.name for p in (exp / 'lidarseg_submit').rglob('*.bin'))
    assert bins == ['lt0_lidarseg.bin', 'lt1_lidarseg.bin']
    for name in bins:
        lab = np.fromfile(next((exp / 'lidarseg_submit').rglob(name)),
                          np.uint8)
        assert len(lab) == cfg.train.max_points - 8

    cli.main(common + ['-t', '--vis'])
    assert sorted(p.name for p in (exp / 'visualization').iterdir()) == [
        '0.pkl', '1.pkl']
