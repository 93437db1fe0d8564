"""Experiment CLI (reference `run_cli`, src/exps/base_cli.py:12-136); the
port of `vampire_tpu/cli.py`.

Usage:
  python -m vampire_tpu_torch.cli --exp lss_inpaintor_depth_semantic    # fit
  python -m vampire_tpu_torch.cli --exp ... -v --ckpt-step 23           # validate
  python -m vampire_tpu_torch.cli --exp ... -t                          # test (det)
  python -m vampire_tpu_torch.cli --exp ... -p                          # predict/submit

The flags and modes are the JAX CLI's. `--device` (default `cuda`) takes
the place of the JAX device mesh: the port runs one process a device.
`--debug` runs `tiny_config()` on the CPU. Every ablation experiment runs
(`--exp bilinear|lss|lss_inpaintor|...|vampire2`), and so does a non-empty
`--sweep-idxes` (multi-sweep batches: the sweep frames' views join the key
frame's in the lift). `--pretrained-backbone PATH` grafts a torchvision
ResNet .pth of the backbone's depth onto the image backbone at init
(`utils/torch_weights.py`; depth 10, the tiny config's, has none and
raises KeyError, as in the JAX package).

Data parallel, one process a device (`parallel/distributed.py`):
  torchrun --nproc-per-node N -m vampire_tpu_torch.cli --exp ...
joins the process group that torchrun's environment describes, each rank
on cuda:LOCAL_RANK (gloo with `--device cpu`); and in a plain run
  python -m vampire_tpu_torch.cli --num-devices N --exp ...
starts the N ranks itself, on cuda:0..N-1 (N gloo ranks with `--device
cpu` or `--debug`). Each rank loads its (rank, world) block of every
global batch of batch_size_per_device * N rows; the step is the JAX
package's global-batch step.

Defaults mirror the reference trainer config (base_cli.py:69-92): bf16
compute with fp32 islands (the reference uses fp16 AMP), grad clip 35, val
every 4 epochs, max_epochs 24, per-device batch via -b, seed 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys


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
                        'base_cli.py:33): a plain run above 1 starts that '
                        'many ranks, one a device; under torchrun the '
                        'world is its WORLD_SIZE')
    p.add_argument('--pretrained-backbone', default='',
                   help='torchvision resnet .pth grafted onto the image '
                        'backbone at init (the reference recipe, '
                        'base_exp.py:73)')
    p.add_argument('--sweep-idxes', default=None,
                   help='comma-separated temporal sweep-frame indexes into '
                        'the infos\' cam_sweeps history (e.g. "0" or "0,2"); '
                        'enables multi-sweep temporal fusion. Default: the '
                        'experiment config\'s sweep_idxes')
    p.add_argument('--device', default='cuda',
                   help='the torch device to run on (--debug: cpu)')
    return p


def _parse_sweep_idxes(s):
    s = s.strip()
    return tuple(int(t) for t in s.split(',') if t.strip()) if s else ()


def experiment_config(args):
    """The run's VampireConfig from parsed arguments: tiny_config() with
    --debug, else the --exp preset, with the train fields the flags set;
    num_devices is the process group's world size (1 without one)."""
    from .configs import ablation_config, flagship_config
    from .data.synthetic import tiny_config
    from .parallel.distributed import world_size
    if args.debug:
        cfg = tiny_config()
    elif args.exp == 'flagship':
        cfg = flagship_config()
    else:
        cfg = ablation_config(args.exp)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train,
        batch_size_per_device=args.batch_size_per_device,
        max_epochs=args.max_epochs,
        data_root=args.data_root,
        num_devices=world_size(),
        use_ema=args.use_ema,
        pretrained_backbone=args.pretrained_backbone,
        seed=args.seed,
        **({'sweep_idxes': _parse_sweep_idxes(args.sweep_idxes)}
           if args.sweep_idxes is not None else {})))


def make_loader(cfg, data_root: str, split: str, mode: str, shuffle: bool,
                num_workers: int = 4, seed: int = 0):
    """The DataLoader of one split for this rank: its (rank, world) block of
    every global batch of batch_size_per_device * world rows."""
    from .configs import DET_CLASSES
    from .data.nuscenes import DataLoader, NuscDetSegDataset
    from .parallel.distributed import rank, world_size
    # the test split has no Occ3D labels (base_exp.py:313-314)
    name = ('nuscenes_infos_test.pkl' if split == 'test'
            else f'nuscenes_occ_infos_{split}.pkl')
    ds = NuscDetSegDataset(
        ida_aug=cfg.ida_aug, bda_aug=cfg.bda_aug,
        classes=list(DET_CLASSES), data_root=data_root,
        info_paths=os.path.join(data_root, name),
        head_cfg=cfg.head, mode=mode,
        sweep_idxes=cfg.train.sweep_idxes,
        max_points=cfg.train.max_points, seed=seed,
        seg_bounds=(cfg.backbone.x_bound_seg, cfg.backbone.y_bound_seg,
                    cfg.backbone.z_bound_seg))
    # eval/predict must cover EVERY sample (the reference truncates the
    # DDP gather to the dataset length, base_exp.py:920-927); only the
    # train loader drops the ragged tail, and the last global batch of the
    # others is padded (sample_valid)
    return DataLoader(ds, batch_size=cfg.train.batch_size_per_device,
                      shuffle=shuffle, num_workers=num_workers,
                      seed=seed, drop_last=(mode == 'train'),
                      rank=rank(), world_size=world_size())


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_argparser().parse_args(argv)
    n = args.num_devices
    if n is not None and n > 1 and 'WORLD_SIZE' not in os.environ:
        from .parallel.distributed import spawn
        device = 'cpu' if args.debug else args.device
        if device.startswith('cuda'):   # once here, not in every rank
            from .ops import _build
            _build.build(('lift', 'rays'))
        # a training run has no deadline, as under torchrun
        spawn(_rank_main, n, (argv,), device=device, timeout_s=None)
        return
    run(args)


def _rank_main(argv):
    """A rank started by `main`, in the process group `spawn` joined."""
    run(build_argparser().parse_args(argv))


def run(args):
    """One process of the run (the only one, or one rank of a group)."""
    from .parallel.distributed import initialize, world_size
    from .training.trainer import Trainer

    device = initialize('cpu' if args.debug else args.device)
    if world_size() > 1 and args.num_devices not in (None, world_size()):
        raise SystemExit(f'--num-devices {args.num_devices} in a world of '
                         f'{world_size()} ranks (torchrun sets the world)')
    cfg = experiment_config(args)
    trainer = Trainer(cfg, workdir=args.workdir, device=device)

    def split_loader(split, mode, shuffle):
        return make_loader(cfg, args.data_root, split, mode, shuffle,
                           args.num_workers, args.seed)

    if args.validate or args.test or args.predict:
        split = 'val' if not args.predict else 'test'
        loader = split_loader(split, split, False)
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

    train_loader = split_loader('trainval' if args.trainval else 'train',
                                'train', True)
    val_loader = split_loader('val', 'val', False)
    trainer.fit(train_loader, val_loader, resume=not args.no_resume,
                finetune_from=args.ckpt_step)


if __name__ == '__main__':
    main()
