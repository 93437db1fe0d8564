"""The training system; the port of `vampire_tpu/training/trainer.py`:
`Trainer.__init__`, `init_state`, `fit` (with validation every
check_val_every_n_epoch epochs), checkpoints, `log_scalars`, the epoch-end
train-IoU report, `validate`, `test` (detection eval; `vis=True`: the --vis
dumps) and `predict` (the test-split submission).

The batch dict of numpy arrays (the JAX package's loader layout) goes to
the device, one step runs, and the scalars go to
`<workdir>/<exp_name>/scalars.jsonl` (and, where `tensorboardX` imports,
to a TensorBoard writer under `tb/`, as in the JAX package). Every
`image_every` steps `fit` writes the render panels (`log_images`, PNGs
under `panels/`). A checkpoint is a torch `state_dict` bundle (params,
buffers, optimizer, step, EMA) saved after every epoch as
`checkpoints/<epoch>.pt`; `fit` resumes from the latest. `init_state`
grafts a torchvision ResNet onto the image backbone where
`train.pretrained_backbone` names one (`utils/torch_weights.py`).

In a process group (`parallel/distributed.py`, one process a device) the
Trainer is one rank of a data-parallel run, with the JAX Trainer's
semantics: `num_devices` is the world size (the detection floors; the lr
scale is the config's `num_devices`); `init_state` broadcasts rank 0's
weights and buffers; each step is the global-batch step
(`train_step.py`); only the main process writes `scalars.jsonl`, saves
checkpoints (the others wait at a barrier before they read one) and
prints the IoU reports; `fit`'s train confusions and `validate`'s are
summed over the ranks; `test` and `predict` gather every rank's results
(`process_allgather`) and the main process scores and writes them.
`test(vis=True)` is one process only, as in the JAX package. Without a
group every process is the main one and the collectives are the
identity. The CLI (`cli.py`) drives it over the loaders of
`data/nuscenes.py`.

The ranks take a dp x cam layout (`parallel/mesh.py`), by default the JAX
`default_mesh` policy, as the JAX Trainer takes its mesh: cam = 2 in an
even world above 1. Then the model is the dense-lift one
(`lift_vectorized`, as the JAX Trainer picks it), `to_device` keeps the
rank's cameras of its loader rows (`mesh.shard_batch`), the confusions are
summed over the dp group, and `test` and `predict` gather over it, so that
each row counts once; `log_images` gathers the panel frame's cameras over
the cam group.
"""
from __future__ import annotations

import contextlib
import json
import os
import pickle
import re
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs import LABEL_17_NAMES
from ..evaluation.det_evaluator import DetNuscEvaluator, apply_circle_nms
from ..evaluation.lidarseg import lidarseg_labels, write_submission
from ..models.vampire import Vampire, init_params_
from ..parallel.distributed import (all_gather_rows, all_reduce_sum,
                                    barrier, broadcast_module_,
                                    is_main_process, process_allgather, rank,
                                    world_size)
from ..parallel.mesh import Layout, default_layout, shard_batch
from ..serving.server import _argmax, _to_numpy, set_fp32_precision
from ..utils import profiling
from ..utils.torch_weights import graft_into_model_, load_torchvision_resnet
from ..utils.vis import tile_cameras, visualize_depth, visualize_semantic
from .losses import denormalize_images
from .metrics import JaccardIndex, format_iou_report
from .train_state import TrainState, create_train_state
from .train_step import (build_eval_step, build_metric_eval_step,
                         build_train_step, init_train_confusion, split_mats)

DEVICE_KEYS_EXCLUDE = ('meta',)


class Trainer:

    def __init__(self, cfg, workdir: str = './outputs', device='cuda',
                 layout: Optional[Layout] = None,
                 lift_vectorized: Optional[bool] = None):
        """`device` is explicit (no device is guessed). The compute dtype
        follows cfg.train.compute_dtype; on a card the fp32 islands run in
        full fp32 (TF32 off), as the server runs them. `layout`: the ranks'
        dp x cam layout (`parallel.mesh.make_layout`); None takes
        `default_layout()`, which in a process group every rank builds at
        once (it makes the groups), as every rank builds its Trainer.
        `lift_vectorized`: the dense lift (the JAX Trainer's argument);
        None takes it where the layout splits the cameras."""
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == 'cuda':
            set_fp32_precision()
        self.workdir = os.path.join(workdir, cfg.train.exp_name)
        os.makedirs(self.workdir, exist_ok=True)
        self.dtype = (torch.bfloat16 if cfg.train.compute_dtype == 'bfloat16'
                      else torch.float32)
        self.layout = default_layout() if layout is None else layout
        if lift_vectorized is None:
            lift_vectorized = self.layout.cam > 1
        self.model = Vampire(cfg.backbone, cfg.head, dtype=self.dtype,
                             device=self.device,
                             lift_vectorized=lift_vectorized)
        self.model.use_layout(self.layout)
        # the devices the step runs over (one process a device): the
        # detection loss floors, as the JAX Trainer's mesh.size
        self.num_devices = world_size()
        self._log_file = self._tb = None
        if is_main_process():
            self._log_file = open(os.path.join(self.workdir,
                                               'scalars.jsonl'), 'a')
            # the optional TensorBoard sink of the JAX Trainer, which
            # mirrors the scalars and panels (base_exp.py:370-433)
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(os.path.join(self.workdir, 'tb'))

    # ------------------------------------------------------------------
    def init_state(self, example_batch: Dict[str, np.ndarray],
                   steps_per_epoch: int) -> TrainState:
        """Seeded random weights (a torch.Generator seeded with
        cfg.train.seed on the model's device), then, where
        cfg.train.pretrained_backbone names a torchvision ResNet .pth, that
        checkpoint grafted onto the image backbone (the reference recipe,
        base_exp.py:73; a bad path, depth or key raises), then in a process
        group rank 0's weights broadcast; and a fresh optimizer."""
        del example_batch   # shapes come from the config
        g = torch.Generator(device=self.device)
        g.manual_seed(self.cfg.train.seed)
        init_params_(self.model, g)
        pb = self.cfg.train.pretrained_backbone
        if pb:
            graft_into_model_(self.model, load_torchvision_resnet(
                pb, depth=self.cfg.backbone.img_backbone_depth))
            msg = f'image backbone: torchvision weights grafted from {pb}'
        else:
            msg = ('image backbone: random init (set '
                   'train.pretrained_backbone / --pretrained-backbone for '
                   'the reference recipe)')
        if is_main_process():
            print(msg)
        broadcast_module_(self.model)
        return create_train_state(self.model, self.cfg.train,
                                  steps_per_epoch)

    def to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The batch on the device: under the layout, this rank's cameras
        of its rows (`mesh.shard_batch`)."""
        with profiling.span('trainer.to_device', device=True):
            batch = shard_batch({k: v for k, v in batch.items()
                                 if k not in DEVICE_KEYS_EXCLUDE},
                                self.layout)
            return {k: torch.as_tensor(np.ascontiguousarray(v)).to(
                self.device) for k, v in batch.items()}

    def log_scalars(self, step: int, scalars: Dict[str, Any]):
        if self._log_file is None:      # not the main process
            return
        rec = {'step': step}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._log_file.write(json.dumps(rec) + '\n')
        self._log_file.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k != 'step':
                    self._tb.add_scalar(k, v, step)

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
        cfg.train.keep_checkpoints (0 keeps all). The main process writes;
        every rank returns once the file is there."""
        if is_main_process():
            d = self.checkpoint_dir()
            os.makedirs(d, exist_ok=True)
            tmp = os.path.join(d, f'{epoch}.pt.tmp')
            torch.save(state.state_dict(), tmp)
            os.replace(tmp, os.path.join(d, f'{epoch}.pt'))
            keep = self.cfg.train.keep_checkpoints
            if keep:
                for old in self.saved_epochs()[:-keep]:
                    os.remove(os.path.join(d, f'{old}.pt'))
        barrier()

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
            image_every: int = 500, resume: bool = True,
            finetune_from: Optional[int] = None) -> TrainState:
        """Train loop over `train_loader` (an iterable of batch dicts with
        a len) for cfg.train.max_epochs.

        image_every: `log_images` after every image_every-th step (0:
            never), by the main process; a failure there is printed and
            training goes on, as in the JAX loop.
        resume: restore the latest checkpoint of this workdir (params,
            buffers, optimizer, step) and continue at the next epoch.
        finetune_from: epoch whose weights only seed a fresh run.
        val_loader: validated after every check_val_every_n_epoch-th epoch
            (base_cli.py:88), its mIoUs logged.
        """
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
                dev_batch = self.to_device(batch)
                state, logs, conf = train_step(state, dev_batch, conf)
                if it % log_every == 0:
                    self.log_scalars(state.step, logs)
                    if is_main_process():
                        print(f'epoch {epoch} it {it}/{steps_per_epoch} loss '
                              f"{float(logs['total_loss']):.4f}", flush=True)
                if (image_every and state.step % image_every == 0
                        and (is_main_process()
                             or self.layout.split_cameras)):
                    try:
                        self.log_images(state, dev_batch)
                    except Exception as e:  # vis must never stop training
                        print(f'log_images failed: {e!r}')
            if is_main_process():
                print(f'epoch {epoch} done in {time.time() - t_ep:.1f}s')
            self._report_train_iou(conf, state.step)
            self.save_checkpoint(state, epoch)
            if val_loader is not None and \
                    (epoch + 1) % cfg.train.check_val_every_n_epoch == 0:
                self.log_scalars(state.step,
                                 self.validate(val_loader, state))
        return state

    def _report_train_iou(self, conf, step: int) -> None:
        """Epoch-end train IoU reports: per-class lidarseg IoU over classes
        1..16 and occupancy IoU over 0..16, accumulated on the device and
        summed over the dp group (each row once); the main process
        reports."""
        conf_seg, conf_occ = (all_reduce_sum(c, self.layout.dp_group)
                              .cpu().numpy() for c in conf)
        if not is_main_process():
            return
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

    def log_images(self, state: TrainState, dev_batch) -> None:
        """The periodic image panels (base_exp.py:419-513): an eval-mode
        forward of row 0 of the device batch (camera renders, no detection
        head), and six PNGs `<workdir>/panels/<step:07d>_<name>.png`
        written with PIL: rgb_gts (the key frame's denormalised images),
        rgb_preds, depth_preds, seg_preds (argmax on the device), bev_seg
        and bev_height. Mirrored to TensorBoard where the sink exists. The
        model is back in its mode afterwards. Where the layout splits the
        cameras, every rank calls it: the forward sums the lift over the
        cam group, and the camera panels gather its ranks' cameras."""
        from PIL import Image
        model = state.model
        mats = {k: v[:1] for k, v in split_mats(dev_batch).items()}
        gt_imgs = dev_batch['imgs']
        if gt_imgs.dim() == 6:       # multi-sweep batch: panel the key frame
            gt_imgs = gt_imgs[:, 0]
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                fo, _ = model(dev_batch['imgs'][:1], mats,
                              points=dev_batch['points'][:1],
                              lidar_seg=True)
                out = dict(
                    depth=fo['depth_preds'][0],
                    seg=_argmax(fo['seg_logits_preds'][0]),
                    rgb=fo['rgb_preds'][0],
                    gt=denormalize_images(gt_imgs[:1])[0],
                    bev_seg=_argmax(fo['bev_seg_logits_preds'][0]),
                    bev_height=fo['bev_height_preds'][0])
                if self.layout.split_cameras:   # the frame's cameras
                    for k in ('depth', 'seg', 'rgb', 'gt'):
                        out[k] = all_gather_rows(out[k],
                                                 self.layout.cam_group)
        finally:
            model.train(was_training)
        if not is_main_process():
            return
        out = _to_numpy(out)
        gt = out['gt']
        step = int(state.step)
        d = os.path.join(self.workdir, 'panels')
        os.makedirs(d, exist_ok=True)
        panels = {
            'rgb_gts': tile_cameras(
                (np.clip(gt, 0, 1) * 255).astype(np.uint8)),
            'rgb_preds': tile_cameras(
                (np.clip(out['rgb'], 0, 1) * 255).astype(np.uint8)),
            'depth_preds': tile_cameras(np.stack(
                [visualize_depth(x) for x in out['depth']])),
            'seg_preds': tile_cameras(np.stack(
                [visualize_semantic(x) for x in out['seg']])),
            'bev_seg': visualize_semantic(out['bev_seg']),
            'bev_height': visualize_depth(out['bev_height'], -5.0, 3.0),
        }
        for name, img in panels.items():
            Image.fromarray(img).save(os.path.join(d, f'{step:07d}_{name}.png'))
            if self._tb is not None:
                self._tb.add_image(name, img, step, dataformats='HWC')

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _eval_params(self, state: TrainState, use_ema: Optional[bool] = None):
        """The model with the weights to evaluate: the EMA when the run
        trained with it (the reference evaluates the EMA .pth,
        ema.py:101-117), else its own. The BN running statistics stay the
        model's, as the JAX package evaluates EMA params with the state's
        batch_stats. On exit the training weights are back bit for bit and
        the model is in train mode (`ResNet.train` keeps the frozen stem in
        eval mode)."""
        if use_ema is None:
            use_ema = self.cfg.train.use_ema
        model = state.model
        params = dict(model.named_parameters())
        saved = None
        try:
            if use_ema and state.ema_params is not None:
                saved = {k: p.detach().clone() for k, p in params.items()}
                with torch.no_grad():
                    for k, p in params.items():
                        p.copy_(state.ema_params[k])
            yield model
        finally:
            if saved is not None:
                with torch.no_grad():
                    for k, p in params.items():
                        p.copy_(saved[k])
            model.train()

    def validate(self, val_loader, state: TrainState,
                 use_ema: Optional[bool] = None) -> Dict[str, float]:
        """Lidarseg + occupancy IoU over the val split (base_exp.py:634-663,
        880-910). The confusion matrices are computed on the device; only
        two (C, C) arrays come back per batch. Their float64 sums are then
        summed over the ranks: every rank returns the global mIoUs, and the
        main process prints the reports."""
        cfg = self.cfg
        val_iou = JaccardIndex(17, ignore_index=0)
        occ_iou = JaccardIndex(cfg.backbone.num_classes)
        with self._eval_params(state, use_ema) as model:
            step = build_metric_eval_step(model, cfg)
            for batch in val_loader:
                conf_seg, conf_occ = step(self.to_device(batch))
                val_iou.update_confusion(conf_seg.cpu().numpy())
                occ_iou.update_confusion(conf_occ.cpu().numpy())
        for m in (val_iou, occ_iou):       # each row once: the dp group
            m.conf = all_reduce_sum(torch.from_numpy(m.conf).to(
                self.device), self.layout.dp_group).cpu().numpy()
        iou = val_iou.compute()[1:]
        miou = float(np.nanmean(iou))
        occ = occ_iou.compute()[:-1]
        occ_miou = float(np.nanmean(occ))
        if is_main_process():
            print(format_iou_report(iou, LABEL_17_NAMES[1:-1], 'Validation'))
            print(f'Current val miou is {miou * 100:.3f}')
            print(format_iou_report(occ, LABEL_17_NAMES[:-1],
                                    'Validation occupancy'))
            print(f'Current val occupancy miou is {occ_miou * 100:.3f}')
        return {'val/mIoU': miou, 'val/occ_mIoU': occ_miou}

    def _det_results(self, batch, out, results, metas) -> np.ndarray:
        """Host circle NMS of one batch's decoded boxes and their metas,
        appended for every row but the padding of a final partial batch;
        returns the rows' sample_valid."""
        B = np.asarray(batch['imgs']).shape[0]
        sv = np.asarray(batch.get('sample_valid', np.ones(B, bool)))
        meta = batch['meta']
        for b in range(B):
            if not sv[b]:
                continue
            results.append(apply_circle_nms(out['det'], self.cfg.head, b))
            metas.append(dict(
                token=meta['token'][b],
                ego2global_rotation=meta['ego2global_rotation'][b],
                ego2global_translation=meta['ego2global_translation'][b]))
        return sv

    def test(self, test_loader, state: TrainState, vis: bool = False,
             use_ema: Optional[bool] = None) -> None:
        """Detection eval: the metrics graph with the head, decode on the
        device, host circle NMS and the submission scored by
        `DetNuscEvaluator` (base_exp.py:665-746, 912-929): by the devkit
        where it is installed, else by the in-repo metric against the GT of
        `test_loader.dataset.global_gt_boxes()` where the loader has one.
        Only the decoded boxes leave the device; every rank's results are
        gathered and the main process scores them. With vis=True, dump
        per-frame pickles of rendered rgb/depth/seg/bev/occ instead
        (base_exp.py:678-708), in one process only: the JAX `_test_vis`
        fetches the global arrays and numbers its dumps from a counter of
        its own process."""
        cfg = self.cfg
        if vis and world_size() > 1:
            raise RuntimeError(
                f'test(vis=True) runs in one process; this is rank {rank()} '
                f'of {world_size()}, and the ranks\' dumps <idx>.pkl would '
                'overwrite each other')
        results, metas = [], []
        with self._eval_params(state, use_ema) as model:
            if vis:
                self._test_vis(test_loader)
                return
            step = build_eval_step(model, cfg, lidar_seg=False)
            for batch in test_loader:
                out = step(self.to_device(batch))
                self._det_results(batch, {'det': _to_numpy(out['det'])},
                                  results, metas)
        # the dp group's rows: rank 0's group holds each row once
        pairs = process_allgather((results, metas), self.layout.dp_group)
        if not is_main_process():
            return
        results = [r for rs, _ in pairs for r in rs]
        metas = [m for _, ms in pairs for m in ms]
        evaluator = DetNuscEvaluator(
            class_names=[c for t in cfg.head.tasks for c in t],
            output_dir=os.path.join(self.workdir, 'detection_submit'),
            data_root=cfg.train.data_root,
            version=cfg.train.nusc_version)
        # devkit-free GT (in-repo NDS/mAP) from the loader's infos
        gt = getattr(test_loader, 'dataset', None)
        gt = gt.global_gt_boxes() if gt is not None else None
        evaluator.evaluate(results, metas, gt_boxes=gt)

    def _test_vis(self, loader) -> None:
        """--vis dumps (base_exp.py:678-708): per-frame pickles of the input
        tile, rendered depth/semantics, BEV maps and occ prediction, from
        the full-render graph with the weights the model holds (`test`
        puts the EMA in first where it evaluates with it). The argmaxes and
        the density sum run on the device."""
        model = self.model
        vis_dir = os.path.join(self.workdir, 'visualization')
        os.makedirs(vis_dir, exist_ok=True)
        model.eval()
        idx = 0
        for batch in loader:
            dev = self.to_device(batch)
            with torch.no_grad():
                fo, _ = model(dev['imgs'], split_mats(dev),
                              points=dev['points'])
                out = _to_numpy(dict(
                    depth_preds=fo['depth_preds'],
                    seg_preds=_argmax(fo['seg_logits_preds']),
                    bev_seg=_argmax(fo['bev_seg_logits_preds']),
                    bev_height=fo['bev_height_preds'],
                    bev_density=torch.sum(fo['bev_density'], dim=1),
                    occ=_argmax(fo['occ_logits']
                                * fo['occ_density'][..., None])))
            imgs = np.asarray(batch['imgs'])
            if imgs.ndim == 6:      # multi-sweep batch: dump the key frame
                imgs = imgs[:, 0]
            rgb = denormalize_images(torch.as_tensor(imgs)).numpy()
            B = rgb.shape[0]
            sv = np.asarray(batch.get('sample_valid', np.ones(B, bool)))
            tokens = batch['meta'].get('lidar_token', [''] * B)
            for b in range(B):
                if not sv[b]:
                    continue  # padding row of the final partial batch
                d = dict(
                    batch_idx=idx,
                    lidar_token=tokens[b],
                    input_image=tile_cameras(
                        (rgb[b] * 255).astype(np.uint8)),
                    camera_depth=tile_cameras(np.stack(
                        [visualize_depth(x) for x in out['depth_preds'][b]])),
                    camera_semantics=tile_cameras(np.stack(
                        [visualize_semantic(x) for x in out['seg_preds'][b]])),
                    bev_semantics=visualize_semantic(out['bev_seg'][b]),
                    bev_density=visualize_depth(out['bev_density'][b],
                                                vmin=0, vmax=10),
                    occ=out['occ'][b],
                )
                with open(os.path.join(vis_dir, f'{idx}.pkl'), 'wb') as f:
                    pickle.dump(d, f)
                idx += 1

    def predict(self, loader, state: TrainState,
                use_ema: Optional[bool] = None) -> None:
        """Test-split submission: detection json + per-token lidarseg bins
        (base_exp.py:800-849, base_cli.py:112-129). Only the decoded boxes
        and the point logits leave the device; every rank's results are
        gathered and the main process writes the submission."""
        cfg = self.cfg
        results, metas, seg_results = [], [], []
        with self._eval_params(state, use_ema) as model:
            step = build_eval_step(model, cfg, lidar_seg=False)
            for batch in loader:
                out = step(self.to_device(batch))
                out = _to_numpy(dict(det=out['det'],
                                     pts_logits=out['pts_logits']))
                sv = self._det_results(batch, out, results, metas)
                for b in np.flatnonzero(sv):
                    n = int(np.asarray(batch['num_points'][b]))
                    seg_results.append(
                        (batch['meta']['lidar_token'][b],
                         lidarseg_labels(out['pts_logits'][b], n)))
        gathered = process_allgather((results, metas, seg_results),
                                     self.layout.dp_group)
        if not is_main_process():
            return
        results = [r for rs, _, _ in gathered for r in rs]
        metas = [m for _, ms, _ in gathered for m in ms]
        seg_results = [s for _, _, ss in gathered for s in ss]
        write_submission(seg_results,
                         os.path.join(self.workdir, 'lidarseg_submit'),
                         split='test')
        evaluator = DetNuscEvaluator(
            class_names=[c for t in cfg.head.tasks for c in t],
            output_dir=os.path.join(self.workdir, 'detection_submit'),
            data_root=cfg.train.data_root,
            version='v1.0-test')
        evaluator.format_bbox(results, metas)
