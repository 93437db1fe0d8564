"""In-process inference serving on one device: warm model, micro-batched
queue; the port of `InferenceServer` in `vampire_tpu/serving/server.py`.

A dispatcher thread drains a request queue into micro-batches of at most
`max_batch` frames; partial batches are padded by repeating the last sample
and the padding rows are dropped on the way out. Detection boxes are
decoded on the device and circle-NMSed on the host.

`outputs` selects the output groups as in the JAX server, with the same
keys: None (the default, the full-render graph) or a selection that holds
'camera_renders' runs the camera-ray branch; the others run the metrics
graph (`camera_renders=False`), which skips the corner table and the rays.
`ReplicaPool` and the TCP front-end are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, Optional

import numpy as np
import torch

from vampire_tpu.evaluation.det_evaluator import apply_circle_nms

from ..configs import synthetic_batch
from ..models.centerpoint_head import decode_preds
from ..models.vampire import Vampire, init_params_

MATS_KEYS = ('sensor2ego', 'intrin', 'ida', 'bda')
INPUT_KEYS = ('imgs',) + MATS_KEYS + ('points',)


def set_fp32_precision():
    """fp32 islands run in full fp32 on the card: TF32 off for matmuls and
    for cuDNN convolutions (cuDNN's default is TF32 on). The bf16 conv
    stacks are unaffected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class InferenceServer:
    """Micro-batching inference engine for the flagship multi-task model.

    Args:
      cfg: VampireConfig.
      device: the torch device the model runs on ('cuda', 'cuda:1', 'cpu').
      state_dict: the port's weights (e.g. `weights.from_flax`); None
        initializes seeded random weights (`init_params_` with `seed`).
      dtype: compute dtype of the conv stacks; None follows
        cfg.train.compute_dtype.
      max_batch: micro-batch size.
      max_wait_ms: dispatcher linger before running a partial batch.
      outputs: None, a subset of OUTPUT_GROUPS, or 'metrics' = ('occ',
        'lidarseg', 'det'). None returns occ_logits, occ_density, pts_logits,
        depth_preds, seg_preds (argmax), bev_seg (argmax) and det; an explicit
        'camera_renders' adds rgb_preds, an explicit 'bev_renders' adds
        bev_height and bev_rgb. 'det' decodes boxes on the device and runs
        circle NMS on the host.
    """

    OUTPUT_GROUPS = ('occ', 'lidarseg', 'det', 'camera_renders',
                     'bev_renders')

    def __init__(self, cfg, device, state_dict=None, dtype=None,
                 max_batch: int = 1, max_wait_ms: float = 5.0,
                 seed: int = 0, outputs=None):
        if outputs == 'metrics':
            outputs = ('occ', 'lidarseg', 'det')
        if outputs is not None:
            outputs = tuple(outputs)
            bad = set(outputs) - set(self.OUTPUT_GROUPS)
            if bad:
                raise ValueError(f'unknown output groups {sorted(bad)}; '
                                 f'valid: {self.OUTPUT_GROUPS}')
        self.cfg = cfg
        self.device = torch.device(device)
        self.outputs = outputs
        self.with_det = outputs is None or 'det' in outputs
        self.camera_renders = outputs is None or 'camera_renders' in outputs
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        if dtype is None:
            dtype = (torch.bfloat16 if cfg.train.compute_dtype == 'bfloat16'
                     else torch.float32)
        if self.device.type == 'cuda':
            set_fp32_precision()
        self.model = Vampire(cfg.backbone, cfg.head, dtype=dtype,
                             device=self.device)
        if state_dict is None:
            init_params_(self.model, torch.Generator().manual_seed(seed))
        else:
            self.model.load_state_dict(state_dict, strict=True)
        self.model.eval()

        ex = synthetic_batch(cfg, batch_size=max_batch,
                             n_points=cfg.train.max_points, seed=seed,
                             mode='val')
        self._example = {k: np.asarray(ex[k]) for k in INPUT_KEYS}
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.stats = dict(requests=0, batches=0, padded_rows=0)

    # ------------------------------------------------------------------
    def to_device(self, batch: Dict[str, np.ndarray]):
        """numpy batch -> (imgs, mats, points) tensors on the device."""
        t = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(
            self.device) for k in INPUT_KEYS}
        return t['imgs'], {k: t[k] for k in MATS_KEYS}, t['points']

    @torch.inference_mode()
    def forward(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """One micro-batch through the model; returns numpy outputs (the
        per-task decoded boxes under 'det')."""
        imgs, mats, points = self.to_device(batch)
        fo, preds = self.model(imgs, mats, points=points,
                               lidar_seg=not self.with_det,
                               camera_renders=self.camera_renders)
        g = self.outputs

        def want(group):
            return g is None or group in g
        out = {}
        if want('occ'):
            out['occ_logits'] = fo['occ_logits']
            out['occ_density'] = fo['occ_density']
        if want('lidarseg'):
            out['pts_logits'] = fo['pts_logits']
        if want('camera_renders'):
            out['depth_preds'] = fo['depth_preds']
            out['seg_preds'] = _argmax(fo['seg_logits_preds'])
            if g is not None:
                out['rgb_preds'] = fo['rgb_preds']
        if want('bev_renders'):
            out['bev_seg'] = _argmax(fo['bev_seg_logits_preds'])
            if g is not None:
                out['bev_height'] = fo['bev_height_preds']
                out['bev_rgb'] = fo['bev_rgb_preds']
        if self.with_det:
            out['det'] = decode_preds(preds, self.cfg.head)
        return _to_numpy(out)

    def warmup(self):
        """Run the example batch once (kernel build, allocations, cuDNN and
        cuBLAS handles). Once `start()`ed, the run goes through the
        dispatcher thread, whose per-thread CUDA library handles the
        requests then find ready."""
        if self._thread is not None:
            self.infer({k: v[0] for k, v in self._example.items()})
        else:
            self.forward(self._example)
        return self

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        # fail anything still queued so blocked infer() callers don't hang
        while True:
            try:
                _, fut = self._q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError('InferenceServer stopped'))

    # ------------------------------------------------------------------
    def submit(self, sample: Dict[str, np.ndarray]) -> Future:
        """sample: one frame: imgs (N, H, W, 3), sensor2ego/intrin/ida
        (N, 4, 4), bda (4, 4), optional points (P, 3). Returns a Future
        resolving to the per-frame output dict."""
        fut: Future = Future()
        self._q.put((sample, fut))
        return fut

    def infer(self, sample: Dict[str, np.ndarray]) -> Dict[str, Any]:
        return self.submit(sample).result()

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            reqs = [first]
            deadline = time.monotonic() + self.max_wait
            while len(reqs) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    reqs.append(self._q.get(timeout=timeout))
                except queue.Empty:
                    break
            try:
                self._run_batch(reqs)
            except Exception as e:  # the dispatcher must outlive a bad batch
                for _, fut in reqs:
                    if not fut.done():
                        fut.set_exception(e)

    def _run_batch(self, reqs):
        n = len(reqs)
        batch = {}
        for k in INPUT_KEYS:
            rows = []
            for sample, _ in reqs:
                if k in sample:
                    rows.append(np.asarray(sample[k]))
                elif k == 'points':
                    # camera-only request: zero point cloud (pts_logits in
                    # the response are then meaningless padding)
                    rows.append(np.zeros_like(self._example[k][0]))
                else:
                    raise KeyError(f"request missing input '{k}'")
            rows += [rows[-1]] * (self.max_batch - n)   # pad: repeat last
            batch[k] = np.stack(rows)
        out = self.forward(batch)
        self.stats['requests'] += n
        self.stats['batches'] += 1
        self.stats['padded_rows'] += self.max_batch - n
        for i, (_, fut) in enumerate(reqs):
            res = {k: v[i] for k, v in out.items() if k != 'det'}
            if self.with_det:
                res['det'] = apply_circle_nms(out['det'], self.cfg.head, i)
            fut.set_result(res)


def _argmax(logits):
    """Class labels over the last axis, int32 like the JAX server's."""
    return torch.argmax(logits, -1).to(torch.int32)


def _to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return tree
