"""The port's CLI (`vampire_tpu_torch/cli.py`) against the JAX package's:
the argument parser (the same namespace for the same argv, but for the
port's `--device`), the `ablation_config` presets, the flags of the
ROADMAP.md items (items 5, 6 and 9 are ported and run; item 9's
`--pretrained-backbone` raises the JAX converter's KeyError at the tiny
depth 10), and `--debug` end to end on a fake nuScenes tree at `tiny_config`
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
from vampire_tpu_torch.data.synthetic import synthetic_batch, tiny_config
from vampire_tpu_torch.training.trainer import Trainer

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


def test_num_devices_spawns_ranks_without_a_deadline(monkeypatch):
    """`--num-devices N` starts N ranks of `_rank_main` with the argv and
    no time limit: a training run lasts as long as it lasts, as under
    torchrun."""
    from vampire_tpu_torch.parallel import distributed
    calls = []
    monkeypatch.setattr(distributed, 'spawn',
                        lambda *a, **kw: calls.append((a, kw)))
    argv = ['--debug', '--num-devices', '3', '--max-epochs', '24']
    cli.main(argv)
    assert calls == [((cli._rank_main, 3, (argv,)),
                      dict(device='cpu', timeout_s=None))]


@pytest.mark.parametrize('argv,item', [
    (['--num-devices', '2'], 'item 5'),
    (['--exp', 'bilinear'], 'item 6'),
    (['--exp', 'lss'], 'item 6'),
    (['--exp', 'vampire2'], 'item 6'),
    (['--debug', '--sweep-idxes', '0', '--no-resume'], 'item 6'),
    (['--debug', '--sweep-idxes', '0', '-v'], 'item 6'),
    (['--debug', '--pretrained-backbone', 'r50.pth'], 'item 9'),
    (['--debug', '--pretrained-backbone', 'r18.pth'], 'item 9 graft'),
])
def test_flags_of_unported_code_raise(tree, tmp_path, monkeypatch, argv,
                                      item):
    """The flags of the ROADMAP.md items, all ported now. Item 9's
    `--pretrained-backbone` reads the .pth it names (written here, the keys
    of torchvision's ResNet-18): `--debug` (tiny_config, image backbone
    depth 10) raises the JAX converter's KeyError for depth 10, and with
    tiny_config's image backbone at depth 18 the file is grafted at init
    and one epoch fits, the frozen stem still the file's conv1 and bn1 in
    the checkpoint. Item 5's: `--debug --device cpu --num-devices 2`
    starts two gloo ranks, which fit one epoch (one global batch of the 2
    samples) with a checkpoint and the losses from rank 0 alone, then
    validate to their end. Item 6's are ported and run to their end:
    --sweep-idxes fits for one epoch on 12-view batches, and -v restores a
    checkpoint of the same tree first, then validates on them; an --exp
    of the bilinear, lss and vampire2 experiments resolves its config
    (`cli.experiment_config`) and, at tiny_config's widths with that
    variant and those loss weights (--debug would take tiny_config whole),
    runs init_state and one fit step with finite losses."""
    common = ['--device', 'cpu', '-b', '1', '--max-epochs', '1',
              '--data-root', str(tree), '--workdir', str(tmp_path),
              '--num-workers', '1']
    if item == 'item 5':
        cli.main(common + ['--debug', '--no-resume'] + argv)
        exp = tmp_path / tiny_config().train.exp_name
        rows = [json.loads(ln) for ln in
                (exp / 'scalars.jsonl').read_text().splitlines()]
        losses = [r['total_loss'] for r in rows if 'total_loss' in r]
        assert len(losses) == 1 and np.isfinite(losses[0])
        assert [p.name for p in (exp / 'checkpoints').iterdir()] == ['0.pt']
        cli.main(common + ['--debug', '-v'] + argv)
        return
    if item.startswith('item 9'):
        import torch
        from test_torch_torch_weights import torchvision_resnet
        from vampire_tpu_torch.data import synthetic
        sd = torchvision_resnet(18)
        path = tmp_path / argv[-1]
        torch.save(sd, path)
        argv = argv[:-1] + [str(path)]
        if item == 'item 9':
            with pytest.raises(KeyError, match='10'):
                cli.main(common + argv)
            return
        tiny = synthetic.tiny_config()
        r18 = dataclasses.replace(tiny, backbone=dataclasses.replace(
            tiny.backbone, img_backbone_depth=18))
        monkeypatch.setattr(synthetic, 'tiny_config', lambda: r18)
        cli.main(common + ['--no-resume'] + argv)
        exp = tmp_path / tiny.train.exp_name
        bundle = torch.load(exp / 'checkpoints' / '0.pt', weights_only=False)
        stem = {k: v for k, v in dict(bundle['params'],
                                      **bundle['buffers']).items()
                if k.startswith('backbone.img_backbone.stem.')
                and 'num_batches' not in k}
        assert len(stem) == 5
        for k, v in stem.items():
            src = k.replace('backbone.img_backbone.stem.conv', 'conv1')
            src = src.replace('backbone.img_backbone.stem.bn', 'bn1')
            assert torch.equal(v, sd[src]), k
        return
    if '--exp' in argv:
        cfg = cli.experiment_config(cli.build_argparser().parse_args(
            common + argv))
        want = tcfg.ablation_config(argv[1])
        assert cfg.backbone == want.backbone
        assert cfg.train.loss_weights == want.train.loss_weights
        tiny = tiny_config()
        tiny = dataclasses.replace(
            tiny,
            backbone=dataclasses.replace(tiny.backbone,
                                         variant=cfg.backbone.variant),
            train=dataclasses.replace(tiny.train,
                                      exp_name=cfg.train.exp_name,
                                      loss_weights=cfg.train.loss_weights,
                                      max_epochs=1))
        batch = synthetic_batch(tiny, batch_size=1, n_points=64, seed=0,
                                mode='train')
        trainer = Trainer(tiny, workdir=str(tmp_path), device='cpu')
        state = trainer.init_state(batch, 1)
        state = trainer.fit([batch], state=state, log_every=1)
        assert state.step == 1
        rows = [json.loads(ln) for ln in (
            tmp_path / cfg.train.exp_name / 'scalars.jsonl').read_text()
            .splitlines()]
        losses = [r['total_loss'] for r in rows if 'total_loss' in r]
        assert len(losses) == 1 and np.isfinite(losses[0])
        return
    if '-v' in argv:
        cli.main(common + ['--debug', '--no-resume'])
    cli.main(common + argv)
    exp = tmp_path / tiny_config().train.exp_name
    rows = [json.loads(ln) for ln in
            (exp / 'scalars.jsonl').read_text().splitlines()]
    losses = [r['total_loss'] for r in rows if 'total_loss' in r]
    assert losses and all(np.isfinite(v) for v in losses)
    assert (exp / 'checkpoints' / '0.pt').exists()


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


def test_num_devices_trains_and_validates_at_dp_1_x_cam_2(tree, tmp_path,
                                                          capfd):
    """`--num-devices 2` takes the JAX default mesh, dp 1 x cam 2: both
    gloo ranks load the global batch's rows (`make_loader` over the dp
    size) and split its cameras. fit trains an epoch, rank 0 alone writes
    the logs and the checkpoint, and `-v` validates it at the same layout
    (tests/test_torch_parallel_cam.py holds the layout's numbers)."""
    wd = tmp_path / 'out'
    common = ['--debug', '--num-devices', '2', '-b', '1', '--data-root',
              str(tree), '--workdir', str(wd), '--num-workers', '1']
    cli.main(common + ['--max-epochs', '1', '--no-resume'])
    out = capfd.readouterr().out
    assert out.count('ranks: dp 1 x cam 2') == 1
    exp = wd / tiny_config().train.exp_name
    assert [p.name for p in (exp / 'checkpoints').iterdir()] == ['0.pt']
    rows = [json.loads(ln) for ln in
            (exp / 'scalars.jsonl').read_text().splitlines()]
    assert [r['step'] for r in rows if 'total_loss' in r] == [1]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    cli.main(common + ['-v'])
    out = capfd.readouterr().out
    assert 'ranks: dp 1 x cam 2' in out and 'Current val miou' in out
