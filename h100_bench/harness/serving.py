"""What the two serving drivers share: the `InferenceServer` built with
the seeded weights and calibrated BN, warmed on its one batch shape; the
traced window's spans around it; the sample of served results kept for
the check; and the check itself."""
from __future__ import annotations

import threading
import time
from typing import Dict, List

import numpy as np
import torch

from . import compare, frames, refrun
from .calib import calibrate_batchnorm_
from .kernels import OpCalls, install
from .seeds import rng

WARM_REQUESTS = 3


def build(ctx):
    """The started, calibrated and warmed server, the cell's frame pool,
    and the calibration frame."""
    tr = ctx.traffic
    S = ctx.program.server_module
    torch.manual_seed(ctx.torch_seed('global'))
    pool = frames.frame_pool(ctx.rcfg, tr['pool'], ctx.seed)
    calib = ctx.calib_frame()
    ctx.fit_density(pool[:1], train=False)
    server = S.InferenceServer(ctx.pcfg, device=ctx.device,
                               state_dict=ctx.weights(),
                               max_batch=tr['max_batch'],
                               max_wait_ms=tr['max_wait_ms'],
                               outputs=tr['outputs'])
    calibrate_batchnorm_(server.model, refrun.served_inputs([calib],
                                                            ctx.device))
    if ctx.fault:
        ctx.fault(ctx, server)
    server.start()
    for f in pool[:WARM_REQUESTS]:
        server.infer(f)
    return server, pool, calib


class Recorder:
    """Per request: its due time, its completion time, whether it failed,
    and, for the requests of the sample, its result. In the traced window
    also each batch's forward start and post-processing time."""

    def __init__(self, ctx, server, sample_size: int):
        self.ctx = ctx
        self.server = server
        self.lock = threading.Lock()
        self.due: Dict[int, float] = {}
        self.done: Dict[int, float] = {}
        self.failed: Dict[int, str] = {}
        self.results: Dict[int, dict] = {}
        self.frame_of: Dict[int, int] = {}
        self.keep_slots: List[int] = []
        self.sample_size = sample_size
        self._rng = rng(ctx.seed, 'sample')
        self.wait_ms: List[float] = []
        self.post_ms: List[float] = []
        self._current = None

    def _keep(self, i: int) -> bool:
        """Reservoir sampling over the submission order: a uniform sample
        of `sample_size` requests, drawn from the seed."""
        with self.lock:
            if len(self.keep_slots) < self.sample_size:
                self.keep_slots.append(i)
                return True
            j = int(self._rng.integers(0, i + 1))
            if j >= self.sample_size:
                return False
            self.results.pop(self.keep_slots[j], None)
            self.keep_slots[j] = i
            return True

    def submit(self, i: int, frame_index: int, frame: dict, due: float):
        keep = self._keep(i)
        self.due[i] = due
        self.frame_of[i] = frame_index
        fut = self.server.submit(frame)
        fut.request_index = i

        def on_done(f):
            t = time.perf_counter()
            with self.lock:
                self.done[i] = t
                if f.exception() is not None:
                    self.failed[i] = repr(f.exception())
                elif keep and i in self.keep_slots:
                    self.results[i] = f.result()
        fut.add_done_callback(on_done)
        return fut

    def install_spans(self, patches, ops: OpCalls):
        """Host spans of the server (a batch's forward start against each
        request's due time; its device-to-host copy and NMS) and device
        spans of the model's forward and the lift."""
        server, spans = self.server, self.ctx.spans
        S = self.ctx.program.server_module
        run_batch, forward = server._run_batch, server.forward

        def timed_run_batch(reqs):
            if not spans.on:
                return run_batch(reqs)
            self._current = reqs
            n0 = [len(spans.host[k]) for k in ('server.d2h', 'server.nms')]
            out = run_batch(reqs)
            self.post_ms.append(sum(
                sum(spans.host[k][m:]) for k, m in
                zip(('server.d2h', 'server.nms'), n0)))
            return out

        def timed_forward(batch):
            if spans.on and self._current is not None:
                t = time.perf_counter()
                for _, fut in self._current:
                    self.wait_ms.append(
                        (t - self.due[fut.request_index]) * 1e3)
            return forward(batch)
        patches.set(server, '_run_batch', timed_run_batch)
        patches.set(server, 'forward', timed_forward)
        patches.set(S, '_to_numpy', spans.hosted('server.d2h', S._to_numpy))
        patches.set(S, 'apply_circle_nms',
                    spans.hosted('server.nms', S.apply_circle_nms))
        patches.set(server.model, 'forward',
                    spans.device('model.forward', server.model.forward))
        install(patches, ops, self.ctx.program, backward=False)

    def wait_all(self, futures, grace_s: float) -> None:
        """Wait for every request, at most `grace_s` past now."""
        end = time.perf_counter() + grace_s
        for f in futures:
            try:
                f.exception(timeout=max(0.0, end - time.perf_counter()))
            except TimeoutError:
                pass


def check(ctx, rec: Recorder, pool, calib):
    """The reference over the sampled requests' frames, compared with what
    the server returned for them. A request of the sample that failed
    is not correct."""
    idx = sorted(rec.results)
    missing = [i for i in rec.keep_slots if i not in rec.results]
    prog = [rec.results[i] for i in idx]
    ref = refrun.serve(ctx.rcfg, ctx.device, ctx.weights, calib,
                       [pool[rec.frame_of[i]] for i in idx])
    ctx.keep['reference'] = ref
    ctx.keep['program'] = prog
    ctx.keep['frames'] = [pool[rec.frame_of[i]] for i in idx]
    ctx.keep['calib'] = calib
    numbers = compare.serve_numbers(prog, ref)
    if missing:
        numbers = {k: float('nan') for k in numbers}
    return numbers


def latencies_ms(rec: Recorder, attempted: List[int], waited_until: float
                 ) -> np.ndarray:
    """Due time to result, ms; a request that failed or never came counts
    the whole wait."""
    out = []
    for i in attempted:
        if i in rec.failed or i not in rec.done:
            out.append((waited_until - rec.due[i]) * 1e3)
        else:
            out.append((rec.done[i] - rec.due[i]) * 1e3)
    return np.asarray(out)
