"""Experiment CLI (reference `run_cli`, src/exps/base_cli.py:12-136); the
port of `vampire_tpu/cli.py`.

Usage:
  python -m vampire_tpu_torch.cli --exp lss_inpaintor_depth_semantic    # fit
  python -m vampire_tpu_torch.cli --exp ... -v --ckpt-step 23           # validate
  python -m vampire_tpu_torch.cli --exp ... -t                          # test (det)
  python -m vampire_tpu_torch.cli --exp ... -p                          # predict/submit

The flags and modes are the JAX CLI's. `--device` (default `cuda`) takes
the place of the JAX device mesh: the port runs one process on one device.
`--debug` runs `tiny_config()` on the CPU. Flags that reach code the port
does not have yet raise and name the ROADMAP.md item that ports it:
`--num-devices` above 1 (item 5); the bilinear, lss and vampire2
experiments (their model, item 6); a non-empty `--sweep-idxes` (the
multi-sweep forward, item 6); `--pretrained-backbone` (item 9).

Defaults mirror the reference trainer config (base_cli.py:69-92): bf16
compute with fp32 islands (the reference uses fp16 AMP), grad clip 35, val
every 4 epochs, max_epochs 24, per-device batch via -b, seed 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import os


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser('vampire-tpu-torch')
    p.add_argument('--exp', default='lss_inpaintor_depth_semantic',
                   help='ablation name (configs.ablation_config) or "flagship"')
    mode = p.add_mutually_exclusive_group()
    mode.add_argument('-v', '--validate', action='store_true')
    mode.add_argument('-t', '--test', action='store_true')
    mode.add_argument('-p', '--predict', action='store_true')
    p.add_argument('--vis', action='store_true')
    p.add_argument('--debug', action='store_true',
                   help='CPU tiny-config smoke run (reference --debug)')
    p.add_argument('--trainval', action='store_true')
    p.add_argument('-b', '--batch-size-per-device', type=int, default=8)
    p.add_argument('--max-epochs', type=int, default=24)
    p.add_argument('--data-root', default='data/nuScenes')
    p.add_argument('--workdir', default='./outputs')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--ckpt-step', type=int, default=None,
                   help='checkpoint index: eval modes restore it; fit mode '
                        'fine-tunes from its weights (reference --ckpt_path, '
                        'base_cli.py:130-136)')
    p.add_argument('--no-resume', action='store_true',
                   help='fit: do NOT auto-resume from the latest checkpoint '
                        'in the workdir')
    p.add_argument('--use-ema', action='store_true')
    p.add_argument('--num-workers', type=int, default=4)
    p.add_argument('--num-devices', type=int, default=None,
                   help='the number of devices (reference --gpus, '
                        'base_cli.py:33); the port runs on one, and more '
                        'raise (ROADMAP.md, Queue 1 item 5)')
    p.add_argument('--pretrained-backbone', default='',
                   help='torchvision resnet .pth grafted onto the image '
                        'backbone at init (the reference recipe, '
                        'base_exp.py:73); not ported, raises (ROADMAP.md, '
                        'Queue 1 item 9)')
    p.add_argument('--sweep-idxes', default=None,
                   help='comma-separated temporal sweep-frame indexes into '
                        'the infos\' cam_sweeps history (e.g. "0" or "0,2"); '
                        'enables multi-sweep temporal fusion, which the '
                        'port\'s model does not run yet (ROADMAP.md, Queue 1 '
                        'item 6). Default: the experiment config\'s '
                        'sweep_idxes')
    p.add_argument('--device', default='cuda',
                   help='the torch device to run on (--debug: cpu)')
    return p


def _parse_sweep_idxes(s):
    s = s.strip()
    return tuple(int(t) for t in s.split(',') if t.strip()) if s else ()


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.num_devices is not None and args.num_devices > 1:
        raise NotImplementedError(
            f'--num-devices {args.num_devices}: the port runs on one device; '
            'multi-GPU waits, see ROADMAP.md, Queue 1 item 5')
    from .configs import DET_CLASSES, ablation_config, flagship_config
    from .data.nuscenes import DataLoader, NuscDetSegDataset
    from .data.synthetic import tiny_config
    from .training.trainer import Trainer

    if args.debug:
        cfg = tiny_config()
    elif args.exp == 'flagship':
        cfg = flagship_config()
    else:
        cfg = ablation_config(args.exp)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train,
        batch_size_per_device=args.batch_size_per_device,
        max_epochs=args.max_epochs,
        data_root=args.data_root,
        num_devices=1,
        use_ema=args.use_ema,
        pretrained_backbone=args.pretrained_backbone,
        seed=args.seed,
        **({'sweep_idxes': _parse_sweep_idxes(args.sweep_idxes)}
           if args.sweep_idxes is not None else {})))

    trainer = Trainer(cfg, workdir=args.workdir,
                      device='cpu' if args.debug else args.device)
    data_root = args.data_root

    def make_loader(split: str, mode: str, shuffle: bool):
        # the test split has no Occ3D labels (base_exp.py:313-314)
        name = ('nuscenes_infos_test.pkl' if split == 'test'
                else f'nuscenes_occ_infos_{split}.pkl')
        info = os.path.join(data_root, name)
        ds = NuscDetSegDataset(
            ida_aug=cfg.ida_aug, bda_aug=cfg.bda_aug,
            classes=list(DET_CLASSES), data_root=data_root, info_paths=info,
            head_cfg=cfg.head, mode=mode,
            sweep_idxes=cfg.train.sweep_idxes,
            max_points=cfg.train.max_points, seed=args.seed,
            seg_bounds=(cfg.backbone.x_bound_seg, cfg.backbone.y_bound_seg,
                        cfg.backbone.z_bound_seg))
        # eval/predict must cover EVERY sample (the reference truncates the
        # DDP gather to the dataset length, base_exp.py:920-927); only the
        # train loader drops the ragged tail. One process: rank 0 of 1.
        return DataLoader(ds, batch_size=cfg.train.batch_size_per_device,
                          shuffle=shuffle, num_workers=args.num_workers,
                          seed=args.seed, drop_last=(mode == 'train'))

    if args.validate or args.test or args.predict:
        loader = make_loader('val' if not args.predict else 'test',
                             'val' if not args.predict else 'test', False)
        first = next(iter(loader))
        state = trainer.init_state(first, steps_per_epoch=max(1, len(loader)))
        state = trainer.restore_checkpoint(state, args.ckpt_step,
                                           weights_only=True)
        if args.validate:
            trainer.validate(loader, state)
        elif args.predict:
            trainer.predict(loader, state)
        else:
            trainer.test(loader, state, vis=args.vis)
        return

    train_loader = make_loader('trainval' if args.trainval else 'train',
                               'train', True)
    val_loader = make_loader('val', 'val', False)
    trainer.fit(train_loader, val_loader, resume=not args.no_resume,
                finetune_from=args.ckpt_step)


if __name__ == '__main__':
    main()
