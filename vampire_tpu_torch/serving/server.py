"""Inference serving: warm model, micro-batched queue; the port of
`vampire_tpu/serving/server.py`.

A dispatcher thread drains a request queue into micro-batches of at most
`max_batch` frames; partial batches are padded by repeating the last sample
so that the forward keeps one shape, and only the requests' rows leave the
device: on a card each request's outputs are copied into a pinned host
block of its own, all copies of a batch non-blocking, then one
synchronisation (`_to_numpy`). Detection boxes are decoded on the device
and circle-NMSed on the host by the C++ library of `ops/nms.py` (a failed
build of it raises).

`outputs` selects the output groups as in the JAX server, with the same
keys: None (the default, the full-render graph) or a selection that holds
'camera_renders' runs the camera-ray branch; the others run the metrics
graph (`camera_renders=False`), which skips the camera rays.

With `utils.profiling`'s tracer on, a request's wait in the queue is a
`server.queue` span (under its id, `Future.trace_id`), and each batch a
`server.batch` span (rows, padding rows, request ids) holding its phases:
`server.assemble`, `server.h2d`, `server.forward`, `server.decode`,
`server.d2h`, `server.nms` (per request) and `server.deliver` (the
futures' callbacks); `server.linger` is the dispatcher's wait for a batch
to fill.

Front-ends, as in the JAX package:
  * in-process: `InferenceServer.submit(sample) -> Future` (thread-safe)
    or the synchronous `infer(sample)`;
  * `ReplicaPool`: one InferenceServer per card (or several on one),
    requests sent to the emptiest queue, round robin among equals;
  * TCP: `serve_tcp(server_or_pool, port)`, length-prefixed pickles,
    stdlib only; `TcpClient` is the matching client. A pickle can run code
    when it is loaded: serve only clients you trust, as the JAX server.
"""
from __future__ import annotations

import pickle
import queue
import socket
import socketserver
import struct
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..configs import synthetic_batch
from ..models.centerpoint_head import decode_preds
from ..models.vampire import Vampire, init_params_
from ..ops.nms import apply_circle_nms
from ..utils import profiling

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
      with_det: decode detection boxes ('det'; device decode, host NMS);
        with `outputs` given, 'det' in outputs decides instead, as in the
        JAX server.
      outputs: None, a subset of OUTPUT_GROUPS, or 'metrics' = ('occ',
        'lidarseg', 'det'). None returns occ_logits, occ_density, pts_logits,
        depth_preds, seg_preds (argmax), bev_seg (argmax) and det; an explicit
        'camera_renders' adds rgb_preds, an explicit 'bev_renders' adds
        bev_height and bev_rgb. 'det' decodes boxes on the device and runs
        circle NMS on the host.
    """

    OUTPUT_GROUPS = ('occ', 'lidarseg', 'det', 'camera_renders',
                     'bev_renders')

    def __init__(self, cfg, device='cuda', state_dict=None, dtype=None,
                 max_batch: int = 1, max_wait_ms: float = 5.0,
                 seed: int = 0, outputs=None, with_det: bool = True):
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
        self.with_det = with_det if outputs is None else 'det' in outputs
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
        # d2h_bytes: output bytes handed out; d2h_pinned_bytes: those of
        # them copied from a card into pinned blocks
        self.stats = dict(requests=0, batches=0, padded_rows=0,
                          d2h_bytes=0, d2h_pinned_bytes=0)

    # ------------------------------------------------------------------
    def to_device(self, batch: Dict[str, np.ndarray]):
        """numpy batch -> (imgs, mats, points) tensors on the device."""
        t = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(
            self.device) for k in INPUT_KEYS}
        return t['imgs'], {k: t[k] for k in MATS_KEYS}, t['points']

    @torch.inference_mode()
    def forward(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """One micro-batch through the model; returns numpy outputs (the
        per-task decoded boxes under 'det'). A batch that `_assemble` made
        gives back only its requests' rows (`_to_numpy` with `rows`: on a
        card each output a list of rows, one pinned block a request); any
        other batch all of its rows, each output one array."""
        with profiling.span('server.h2d'):
            imgs, mats, points = self.to_device(batch)
        with profiling.span('server.forward'):
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
            with profiling.span('server.decode'):
                out['det'] = decode_preds(preds, self.cfg.head)
        with profiling.span('server.d2h'):
            return _to_numpy(out, rows=getattr(batch, 'rows', None),
                             stats=self.stats)

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
        queued = profiling.begin('server.queue')
        if queued is not None:      # the request's id: its queue span's
            queued.attrs['id'] = fut.trace_id = queued.id
            fut.trace_queued = queued
        self._q.put((sample, fut))
        return fut

    def infer(self, sample: Dict[str, np.ndarray]) -> Dict[str, Any]:
        return self.submit(sample).result()

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = _dequeued(self._q.get(timeout=0.05))
            except queue.Empty:
                continue
            reqs = [first]
            deadline = time.monotonic() + self.max_wait
            with profiling.span('server.linger'):
                while len(reqs) < self.max_batch:
                    timeout = deadline - time.monotonic()
                    if timeout <= 0:
                        break
                    try:
                        reqs.append(_dequeued(self._q.get(timeout=timeout)))
                    except queue.Empty:
                        break
            try:
                self._run_batch(reqs)
            except Exception as e:  # the dispatcher must outlive a bad batch
                for _, fut in reqs:
                    if not fut.done():
                        fut.set_exception(e)

    def _assemble(self, reqs) -> "_Batch":
        """The requests' inputs stacked into one batch of `max_batch`
        rows, padded by repeating the last."""
        n = len(reqs)
        batch = _Batch(rows=n)
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
        return batch

    def _run_batch(self, reqs):
        n = len(reqs)
        with profiling.span('server.batch') as traced:
            if traced is not None:
                traced.attrs.update(
                    rows=n, padded=self.max_batch - n,
                    ids=[getattr(f, 'trace_id', None) for _, f in reqs])
            with profiling.span('server.assemble'):
                batch = self._assemble(reqs)
            out = self.forward(batch)
            self.stats['requests'] += n
            self.stats['batches'] += 1
            self.stats['padded_rows'] += self.max_batch - n
            for i, (_, fut) in enumerate(reqs):
                res = {k: v[i] for k, v in out.items() if k != 'det'}
                if self.with_det:
                    with profiling.span('server.nms',
                                        id=getattr(fut, 'trace_id', None)):
                        res['det'] = apply_circle_nms(out['det'],
                                                      self.cfg.head, i)
                with profiling.span('server.deliver'):
                    fut.set_result(res)


class _Batch(dict):
    """A micro-batch's stacked inputs and `rows`, the number of leading
    rows that belong to requests: `forward` copies out only those."""

    def __init__(self, rows: int):
        super().__init__()
        self.rows = rows


def _dequeued(item):
    """A (sample, future) pair the dispatcher took from the queue: ends
    its `server.queue` span where tracing made one."""
    profiling.end(getattr(item[1], 'trace_queued', None))
    return item


def _argmax(logits):
    """Class labels over the last axis, int32 like the JAX server's."""
    return torch.argmax(logits, -1).to(torch.int32)


# where each array starts in a host block, bytes
_BLOCK_ALIGN = 256


def _to_numpy(tree, rows: Optional[int] = None,
              stats: Optional[Dict[str, int]] = None):
    """The tensors of a tree of dicts, lists and tuples as numpy arrays,
    in the same tree (a tuple comes back as a list).

    A CPU tensor comes back as its `.numpy()` view. Tensors on a card are
    copied into pinned host memory from PyTorch's caching host allocator,
    every copy non-blocking on the current stream, then one
    synchronisation; the arrays are views of that memory.

    With `rows`, only the first `rows` rows of each tensor come out. On a
    card row i of every tensor goes into a block of its own, and each
    tensor comes back as the list of its rows, so that whoever keeps row
    i's arrays holds only that block; a CPU tensor comes back as the one
    array of its first `rows` rows. `leaf[i]` is row i either way. Without
    `rows`, one block holds the whole tree.

    `stats`, where given, adds the bytes that come out to `d2h_bytes` and
    those copied into pinned blocks to `d2h_pinned_bytes`.
    """
    leaves = []
    _leaves(tree, leaves)
    cut = [t.detach() if rows is None else t.detach()[:rows]
           for t in leaves]
    on_card = [t for t in cut if t.device.type != 'cpu']
    copies = iter(_pinned_copies(on_card, rows))
    arrays = [next(copies) if t.device.type != 'cpu' else t.numpy()
              for t in cut]
    if stats is not None:
        stats['d2h_bytes'] += sum(_nbytes(t) for t in cut)
        stats['d2h_pinned_bytes'] += sum(_nbytes(t) for t in on_card)
    return _rebuild(tree, iter(arrays))


def _leaves(tree, out: list) -> None:
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)


def _rebuild(tree, arrays):
    """`tree` with its tensors replaced by `arrays`, in `_leaves` order."""
    if isinstance(tree, torch.Tensor):
        return next(arrays)
    if isinstance(tree, dict):
        return {k: _rebuild(v, arrays) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, arrays) for v in tree]
    return tree


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _pinned_copies(ts, rows: Optional[int]) -> list:
    """Host copies of the card's tensors `ts` as numpy arrays, one for each
    tensor: without `rows` all in one pinned block; with `rows` the list of
    the tensor's `rows` rows, row i of every tensor in block i."""
    if not ts:
        return []
    groups = [ts] if rows is None else [[t[i] for t in ts]
                                        for i in range(rows)]
    views = [_pinned_block(g) for g in groups]
    for device in {t.device for t in ts}:
        torch.cuda.current_stream(device).synchronize()
    arrays = [[v.numpy() for v in g] for g in views]
    if rows is None:
        return arrays[0]
    return [[a[j] for a in arrays] for j in range(len(ts))]


def _pinned_block(ts) -> list:
    """One block of pinned host memory with room for each tensor of `ts`,
    each copied into its view of it, non-blocking; the views."""
    offsets, size = [], 0
    for t in ts:
        offsets.append(size)
        size += -(-_nbytes(t) // _BLOCK_ALIGN) * _BLOCK_ALIGN
    block = torch.empty(size, dtype=torch.uint8, pin_memory=True)
    views = []
    for t, o in zip(ts, offsets):
        v = block[o:o + _nbytes(t)].view(t.dtype).view(t.shape)
        v.copy_(t, non_blocking=True)
        views.append(v)
    return views


class ReplicaPool:
    """Requests fanned out over several InferenceServer replicas, one per
    card (the JAX package scales serving by replicas, not by batch). Each
    request goes to the replica with the emptiest queue, round robin among
    equals. The pool has the submit/infer surface of one server, so
    `serve_tcp(ReplicaPool([...]))` works unchanged."""

    def __init__(self, servers: Sequence[InferenceServer]):
        if not servers:
            raise ValueError('a ReplicaPool needs at least one replica')
        self._servers = list(servers)
        self._rr = 0
        self._lock = threading.Lock()

    def submit(self, sample: Dict[str, np.ndarray]) -> Future:
        with self._lock:
            n = len(self._servers)
            best = min(range(n), key=lambda i: (self._servers[i]._q.qsize(),
                                                (i - self._rr) % n))
            self._rr = (best + 1) % n
        return self._servers[best].submit(sample)

    def infer(self, sample: Dict[str, np.ndarray]) -> Dict[str, Any]:
        return self.submit(sample).result()

    @property
    def stats(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self._servers:
            for k, v in s.stats.items():
                out[k] = out.get(k, 0) + v
        return out

    def stop(self):
        for s in self._servers:
            s.stop()


# ---------------------------------------------------------------------------
# TCP front-end: length-prefixed pickles (stdlib only)
# ---------------------------------------------------------------------------

def _send_msg(sock, obj):
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack('>Q', len(data)))
    sock.sendall(data)


def _recv_msg(sock):
    hdr = _recv_exact(sock, 8)
    if hdr is None:
        return None
    (n,) = struct.unpack('>Q', hdr)
    data = _recv_exact(sock, n)
    return None if data is None else pickle.loads(data)


def _recv_exact(sock, n):
    """n bytes from sock, read into one buffer, or None if the peer closes
    first."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:])
        if not k:
            return None
        got += k
    return buf


def serve_tcp(server, host: str = '127.0.0.1', port: int = 0):
    """Serve an InferenceServer (or ReplicaPool) over TCP in a background
    thread; returns the ThreadingTCPServer (`.server_address` is the bound
    address, `.shutdown()` stops it). Each message is a sample; each reply
    is {'ok': True, 'result': ...} or {'ok': False, 'error': repr}."""

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            while True:
                msg = _recv_msg(self.request)
                if msg is None:
                    return
                try:
                    out = server.infer(msg)
                except Exception as e:      # reported to the client
                    _send_msg(self.request, dict(ok=False, error=repr(e)))
                else:
                    _send_msg(self.request, dict(ok=True, result=out))

    srv = socketserver.ThreadingTCPServer((host, port), Handler)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


class TcpClient:
    """The client of `serve_tcp`: one connection, one request at a time."""

    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port))

    def infer(self, sample: Dict[str, np.ndarray]) -> Dict[str, Any]:
        _send_msg(self._sock, sample)
        resp = _recv_msg(self._sock)
        if resp is None:
            raise ConnectionError('server closed the connection')
        if not resp['ok']:
            raise RuntimeError(resp['error'])
        return resp['result']

    def close(self):
        self._sock.close()
