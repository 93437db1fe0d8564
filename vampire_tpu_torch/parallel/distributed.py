"""Multi-process runtime; the port of `vampire_tpu/parallel/distributed.py`
and the collectives under the dp x cam layout of `parallel/mesh.py`.

The JAX package writes its train step over the GLOBAL batch and lets the
mesh's sharding place the rows and the cameras, so that data and camera
parallelism are only a layout (`vampire_tpu/parallel/mesh.py:1-15`): every
masked mean divides by the global count, the Lovász terms sort the global
set of errors, the detection loss divides by the global number of
positives and BatchNorm takes its statistics over the global batch. The
port runs one process a device, joined in a process group (rank r on
`cuda:LOCAL_RANK` over NCCL; on the CPU over gloo), and keeps that
function by hand with the collectives below: each rank computes its SHARE
of the global loss, the shares sum to the one-process loss on the global
batch, and the gradients of the shares, summed over the ranks
(`all_reduce_sum_`), are the one-process gradient. The ranks' rows of a
global batch come from the loader (`data/nuscenes.py`
`DataLoader(rank, world_size)`, given the rank's dp index and the dp
size), their cameras from `mesh.shard_batch`, so the JAX
`make_global_batch` has no counterpart. Every collective takes an optional
`group` (None: the world); `parallel/mesh.py` says which group each term
reduces over. `world_size()` and `rank()` are the world's.

Without a process group every collective here is the identity and the
process is rank 0 of 1. With one they run, except over a group of one
rank, where they are the identity too.

`spawn(fn, nprocs, args, device)` starts `nprocs` ranks of `fn` in fresh
processes on one host, rendezvoused through a file store, and returns
each rank's result: the CLI's `--num-devices` and the multi-rank tests and
checks use it. `fn` must be importable by name from a module that imports
no test code. `backend='gloo'` on a `cuda` device, asked for by name,
puts ranks that share a card on it (rank r on card r modulo the cards):
there the collectives stage CUDA tensors through the host.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import multiprocessing.connection
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

# how long a collective waits for the other ranks before it raises
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=30)
# this rank's device, set by `initialize`
_DEVICE: Optional[torch.device] = None


def active() -> bool:
    """Whether this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def is_main_process() -> bool:
    return rank() == 0


def barrier() -> None:
    if active():
        dist.barrier()


def rank_device() -> torch.device:
    """This rank's device (`initialize`'s); the CPU outside a group."""
    if active() and _DEVICE is not None:
        return _DEVICE
    return torch.device('cpu')


def group_size(group=None) -> int:
    """The ranks of `group` (None: the world); 1 without a process group."""
    return dist.get_world_size(group) if active() else 1


def initialize(device='cuda', init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               local_rank: Optional[int] = None,
               backend: Optional[str] = None) -> torch.device:
    """Join the process group and return this rank's device; idempotent.

    The world comes from the arguments or from torchrun's environment
    (WORLD_SIZE, RANK, LOCAL_RANK; MASTER_ADDR and MASTER_PORT through the
    default `env://` rendezvous). With neither, this is a single process:
    no group, and `device` comes back as given. A `cuda` device puts the
    rank on `cuda:LOCAL_RANK` over NCCL (no fallback); `cpu` uses gloo.
    `backend='gloo'` with a `cuda` device, only where the caller names it,
    is for ranks that share a card: the rank goes on card LOCAL_RANK
    modulo the visible cards.
    """
    global _DEVICE
    if active():
        return rank_device()
    env = os.environ
    if world_size is None and 'WORLD_SIZE' in env:
        world_size = int(env['WORLD_SIZE'])
    if world_size is None:
        return torch.device(device)
    if rank is None:
        rank = int(env.get('RANK', 0))
    if local_rank is None:
        local_rank = int(env.get('LOCAL_RANK', rank))
    dev = torch.device(device)
    if dev.type == 'cuda':
        if backend == 'gloo':
            local_rank %= torch.cuda.device_count()
        elif backend not in (None, 'nccl'):
            raise ValueError(f'backend {backend!r} on a card: nccl, or gloo '
                             f'for ranks that share one')
        dev = torch.device('cuda', local_rank)
        torch.cuda.set_device(dev)
        backend = backend or 'nccl'
    else:
        if backend not in (None, 'gloo'):
            raise ValueError(f'backend {backend!r} on the CPU: gloo')
        dev = torch.device('cpu')
        backend = 'gloo'
    dist.init_process_group(
        backend, init_method=init_method or 'env://', world_size=world_size,
        rank=rank, timeout=COLLECTIVE_TIMEOUT)
    if backend == 'gloo':
        # gloo connects its pairs while the group is built, and a rank can
        # leave init first: were it to end at once, it would close its
        # sockets under a peer still connecting. Hold every rank until all
        # have joined.
        dist.barrier()
    _DEVICE = dev
    return dev


def shutdown() -> None:
    global _DEVICE
    if active():
        dist.destroy_process_group()
    _DEVICE = None


# ---------------------------------------------------------------------------
# collectives of the global-batch form
# ---------------------------------------------------------------------------

def _staged(x: torch.Tensor, group) -> torch.Tensor:
    """`x` as the group's backend takes it: a host copy of a CUDA tensor
    for gloo (ranks that share a card), else `x`."""
    if x.is_cuda and dist.get_backend(group) == 'gloo':
        return x.cpu()
    return x


def _all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum `x` over the group in place (through the host where `_staged`
    says so) and return it."""
    y = _staged(x, group)
    dist.all_reduce(y, group=group)
    if y is not x:
        x.copy_(y)
    return x


def _all_gather(x: torch.Tensor, group) -> list:
    """Every rank's `x` (one shape on all), in group rank order."""
    y = _staged(x, group)
    bufs = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(bufs, y, group=group)
    return [b.to(x.device) for b in bufs]


class _AllReduceSum(torch.autograd.Function):
    """y = sum over the group's ranks of x, on each of them. Each of their
    losses reads y, so d(sum of the losses)/dx is the sum over the group
    of dL_r/dy."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `x` over the ranks of `group` (None: the world),
    differentiable; the identity without a process group or over one
    rank."""
    if group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


class _AllGatherRows(torch.autograd.Function):
    """The group's row blocks, concatenated in group rank order, on each of
    its ranks. Backward: each rank's gradient of the gathered rows is
    summed over the group (one all-reduce: gloo has no reduce-scatter),
    and the rank keeps its own block."""

    @staticmethod
    def forward(ctx, x, sizes, group):
        ctx.sizes, ctx.group = sizes, group
        ctx.rank = dist.get_rank(group)
        pad = x.new_zeros((max(sizes),) + tuple(x.shape[1:]))
        pad[:x.shape[0]] = x
        bufs = _all_gather(pad, group)
        return torch.cat([b[:n] for b, n in zip(bufs, sizes)])

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce_(g.contiguous().clone(), ctx.group)
        start = sum(ctx.sizes[:ctx.rank])
        return g[start:start + ctx.sizes[ctx.rank]], None, None


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's rows of `x` (ranks may hold different counts), over
    `group` (None: the world), concatenated in rank order: the rows one
    process would hold for the ranks' rows together. Differentiable for
    floating tensors; bool tensors travel as uint8. The identity without a
    process group or over one rank."""
    if group_size(group) == 1:
        return x
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    sizes = [int(v) for v in torch.cat(_all_gather(n, group)).tolist()]
    if x.dtype == torch.bool:
        return _AllGatherRows.apply(x.to(torch.uint8), sizes,
                                    group).to(torch.bool)
    return _AllGatherRows.apply(x, sizes, group)


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum each tensor (of one dtype) over the ranks of `group` (None: the
    world) in place, through one flat buffer: the gradient all-reduce of
    the train step."""
    if group_size(group) == 1:
        return
    flat = _all_reduce_(torch.cat([t.reshape(-1) for t in tensors]), group)
    torch._foreach_copy_(list(tensors), [c.view_as(t) for c, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)])


@torch.no_grad()
def broadcast_module_(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank, in place."""
    if not active():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        y = _staged(t.data, None)
        dist.broadcast(y, 0)
        if y is not t.data:
            t.data.copy_(y)


def process_allgather(obj: Any, group=None) -> list:
    """`torch_dist.all_gather_object`: every rank's picklable `obj` of
    `group` (None: the world), in group rank order, on each of its ranks;
    [obj] without a process group."""
    if group_size(group) == 1:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def host_local_rows(tree: Any) -> Any:
    """This rank's rows of a batch-sharded result: the identity, since each
    rank computes only the rows of its own loader block."""
    return tree


# ---------------------------------------------------------------------------
# ranks in processes of their own
# ---------------------------------------------------------------------------

def _rank_entry(fn, rank_, nprocs, init_method, device, args, out_path,
                threads, backend=None):
    """One spawned rank: join the group, run fn(*args), write
    ('ok', result) or ('error', traceback) to out_path."""
    if threads:
        torch.set_num_threads(threads)
    try:
        initialize(device, init_method=init_method, world_size=nprocs,
                   rank=rank_, local_rank=rank_, backend=backend)
        result = ('ok', fn(*args))
    except Exception:       # reported by the parent with the rank's number
        result = ('error', traceback.format_exc())
    with open(out_path + '.tmp', 'wb') as f:
        pickle.dump(result, f)
    os.replace(out_path + '.tmp', out_path)
    shutdown()
    if result[0] != 'ok':
        raise SystemExit(1)


def spawn(fn: Callable, nprocs: int, args: tuple = (), device='cuda',
          timeout_s: Optional[float] = None,
          backend: Optional[str] = None) -> list:
    """Run fn(*args) in `nprocs` fresh processes, ranks 0..nprocs-1 of one
    process group (rank r on cuda:r over NCCL, or gloo on the CPU), and
    return their results in rank order. `backend='gloo'` with a `cuda`
    device puts rank r on cuda:(r modulo the cards), so that ranks may
    share a card (`initialize`).

    The ranks rendezvous through a file store in a temporary directory. A
    rank that raises makes this raise with its traceback; the other ranks,
    which may wait in a collective, are killed. With a `timeout_s`, so is
    every rank still running after that many seconds, and then this raises
    TimeoutError; None (a training run) waits for the ranks to end. On the
    CPU each rank takes its share of this process's threads.
    """
    dev = torch.device(device)
    if dev.type == 'cuda' and backend != 'gloo' and \
            nprocs > torch.cuda.device_count():
        raise ValueError(f'{nprocs} ranks need {nprocs} cards; '
                         f'{torch.cuda.device_count()} visible')
    threads = (max(1, torch.get_num_threads() // nprocs)
               if dev.type == 'cpu' else 0)
    ctx = mp.get_context('spawn')
    with tempfile.TemporaryDirectory(prefix='vampire_ranks_') as d:
        init_method = 'file://' + os.path.join(d, 'store')
        outs = [os.path.join(d, f'rank{r}.pkl') for r in range(nprocs)]
        procs = [ctx.Process(target=_rank_entry, name=f'rank{r}',
                             args=(fn, r, nprocs, init_method, dev.type,
                                   args, outs[r], threads, backend))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        try:
            timed_out = _wait(procs, None if timeout_s is None
                              else time.monotonic() + timeout_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
        results, missing = [], []
        for r, path in enumerate(outs):
            if not os.path.exists(path):
                missing.append(r)
                continue
            with open(path, 'rb') as f:
                status, value = pickle.load(f)
            if status != 'ok':
                raise RuntimeError(f'rank {r} of {nprocs} failed:\n{value}')
            results.append(value)
        if timed_out:
            raise TimeoutError(f'{fn.__name__}: ranks still running after '
                               f'{timeout_s} s were killed')
        if missing:
            codes = [procs[r].exitcode for r in missing]
            raise RuntimeError(f'ranks {missing} of {nprocs} ended with '
                               f'exit codes {codes} and no result')
        return results


def _wait(procs, deadline: Optional[float]) -> bool:
    """Wait until every process has ended or one has failed; True when the
    deadline (None: none) passed first."""
    pending = list(procs)
    while pending:
        left = None if deadline is None else deadline - time.monotonic()
        if left is not None and left <= 0:
            return True
        ready = mp.connection.wait([p.sentinel for p in pending], left)
        for p in [p for p in pending if p.sentinel in ready]:
            p.join()
            pending.remove(p)
            if p.exitcode != 0:
                return False
    return False
