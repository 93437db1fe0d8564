"""The training loop; the port of `vampire_tpu/training/trainer.py`
(`Trainer.__init__`, `init_state`, `fit`, checkpoints, `log_scalars` and
the epoch-end train-IoU report).

One process on one device: the batch dict of numpy arrays (the JAX
package's loader layout) goes to the device, one train step runs, and the
scalars go to `<workdir>/<exp_name>/scalars.jsonl`. A checkpoint is a torch
`state_dict` bundle (params, buffers, optimizer, step, EMA) saved after
every epoch as `checkpoints/<epoch>.pt`; `fit` resumes from the latest.
Validation, test, predict, image logging, the CLI and DDP are not ported
(ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs import LABEL_17_NAMES
from ..models.vampire import Vampire, init_params_
from ..serving.server import set_fp32_precision
from .metrics import JaccardIndex, format_iou_report
from .train_state import TrainState, create_train_state
from .train_step import build_train_step, init_train_confusion

DEVICE_KEYS_EXCLUDE = ('meta',)
_TODO = 'see ROADMAP.md, Queue 1'


class Trainer:

    def __init__(self, cfg, workdir: str = './outputs', device='cuda'):
        """`device` is explicit (no device is guessed). The compute dtype
        follows cfg.train.compute_dtype; on a card the fp32 islands run in
        full fp32 (TF32 off), as the server runs them."""
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == 'cuda':
            set_fp32_precision()
        self.workdir = os.path.join(workdir, cfg.train.exp_name)
        os.makedirs(self.workdir, exist_ok=True)
        self.dtype = (torch.bfloat16 if cfg.train.compute_dtype == 'bfloat16'
                      else torch.float32)
        self.model = Vampire(cfg.backbone, cfg.head, dtype=self.dtype,
                             device=self.device)
        self.num_devices = 1
        self._log_file = open(os.path.join(self.workdir, 'scalars.jsonl'),
                              'a')

    # ------------------------------------------------------------------
    def init_state(self, example_batch: Dict[str, np.ndarray],
                   steps_per_epoch: int) -> TrainState:
        """Seeded random weights (a torch.Generator seeded with
        cfg.train.seed on the model's device) and a fresh optimizer. The
        torchvision-pretrained backbone of the reference recipe is not
        ported."""
        del example_batch   # shapes come from the config
        if self.cfg.train.pretrained_backbone:
            raise NotImplementedError(f'pretrained_backbone: {_TODO}')
        g = torch.Generator(device=self.device)
        g.manual_seed(self.cfg.train.seed)
        init_params_(self.model, g)
        return create_train_state(self.model, self.cfg.train,
                                  steps_per_epoch)

    def to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in batch.items() if k not in DEVICE_KEYS_EXCLUDE}

    def log_scalars(self, step: int, scalars: Dict[str, Any]):
        rec = {'step': step}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._log_file.write(json.dumps(rec) + '\n')
        self._log_file.flush()

    # ------------------------------------------------------------------
    def checkpoint_dir(self) -> str:
        return os.path.join(self.workdir, 'checkpoints')

    def saved_epochs(self):
        d = self.checkpoint_dir()
        if not os.path.isdir(d):
            return []
        return sorted(int(m.group(1)) for m in
                      (re.fullmatch(r'(\d+)\.pt', f) for f in os.listdir(d))
                      if m)

    def save_checkpoint(self, state: TrainState, epoch: int):
        """Save the state after `epoch`, keeping the newest
        cfg.train.keep_checkpoints (0 keeps all)."""
        d = self.checkpoint_dir()
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, f'{epoch}.pt.tmp')
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, os.path.join(d, f'{epoch}.pt'))
        keep = self.cfg.train.keep_checkpoints
        if keep:
            for old in self.saved_epochs()[:-keep]:
                os.remove(os.path.join(d, f'{old}.pt'))

    def restore_checkpoint(self, state: TrainState,
                           epoch: Optional[int] = None,
                           weights_only: bool = False) -> TrainState:
        epoch = self.saved_epochs()[-1] if epoch is None else epoch
        bundle = torch.load(os.path.join(self.checkpoint_dir(),
                                         f'{epoch}.pt'),
                            map_location=self.device, weights_only=False)
        state.load_state_dict(bundle, weights_only)
        return state

    # ------------------------------------------------------------------
    def fit(self, train_loader, val_loader=None,
            state: Optional[TrainState] = None, log_every: int = 50,
            resume: bool = True,
            finetune_from: Optional[int] = None) -> TrainState:
        """Train loop over `train_loader` (an iterable of batch dicts with
        a len) for cfg.train.max_epochs.

        resume: restore the latest checkpoint of this workdir (params,
            buffers, optimizer, step) and continue at the next epoch.
        finetune_from: epoch whose weights only seed a fresh run.
        """
        if val_loader is not None:
            raise NotImplementedError(f'validation is not ported, {_TODO}')
        cfg = self.cfg
        steps_per_epoch = len(train_loader)
        if state is None:
            state = self.init_state(next(iter(train_loader)),
                                    steps_per_epoch)
        start_epoch = 0
        if finetune_from is not None:
            state = self.restore_checkpoint(state, finetune_from,
                                            weights_only=True)
            if state.ema_params is not None:
                state.ema_params = {k: v.detach().clone() for k, v in
                                    state.model.named_parameters()}
            print(f'fine-tuning from checkpoint {finetune_from} '
                  '(weights only, fresh optimizer)')
        elif resume and self.saved_epochs():
            latest = self.saved_epochs()[-1]
            state = self.restore_checkpoint(state, latest)
            start_epoch = latest + 1
            print(f'resuming from checkpoint {latest} (epoch {start_epoch}, '
                  f'step {state.step})')
        train_step = build_train_step(cfg, self.num_devices,
                                      with_metrics=True)
        for epoch in range(start_epoch, cfg.train.max_epochs):
            t_ep = time.time()
            conf = init_train_confusion(cfg, self.device)
            for it, batch in enumerate(train_loader):
                state, logs, conf = train_step(state, self.to_device(batch),
                                               conf)
                if it % log_every == 0:
                    self.log_scalars(state.step, logs)
                    print(f'epoch {epoch} it {it}/{steps_per_epoch} '
                          f"loss {float(logs['total_loss']):.4f}", flush=True)
            print(f'epoch {epoch} done in {time.time() - t_ep:.1f}s')
            self._report_train_iou(conf, state.step)
            self.save_checkpoint(state, epoch)
        return state

    def _report_train_iou(self, conf, step: int) -> None:
        """Epoch-end train IoU reports: per-class lidarseg IoU over classes
        1..16 and occupancy IoU over 0..16, accumulated on the device."""
        conf_seg, conf_occ = (c.cpu().numpy() for c in conf)
        seg = JaccardIndex(17, ignore_index=0)
        seg.update_confusion(conf_seg)
        iou = seg.compute()[1:]
        miou = float(np.nanmean(iou))
        print(format_iou_report(iou, LABEL_17_NAMES[1:-1], 'Training'))
        print(f'Current training miou is {miou * 100:.3f}')
        occm = JaccardIndex(self.cfg.backbone.num_classes)
        occm.update_confusion(conf_occ)
        occ = occm.compute()[:-1]
        occ_miou = float(np.nanmean(occ))
        print(format_iou_report(occ, LABEL_17_NAMES[:-1],
                                'Training occupancy'))
        print(f'Current train occupancy miou is {occ_miou * 100:.3f}')
        self.log_scalars(step, {'train/mIoU': miou,
                                'train/occ_mIoU': occ_miou})
