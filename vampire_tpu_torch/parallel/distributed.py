"""Multi-process runtime; the port of `vampire_tpu/parallel/distributed.py`
and of the `dp` axis of `vampire_tpu/parallel/mesh.py`.

The JAX package writes its train step over the GLOBAL batch and lets the
mesh's sharding place the rows, so that data parallelism is only a layout
(`mesh.py:1-15`): every masked mean divides by the global count, the
Lovász terms sort the global set of errors, the detection loss divides by
the global number of positives and BatchNorm takes its statistics over the
global batch. The port runs one process a device, joined in a process
group (rank r on `cuda:LOCAL_RANK` over NCCL; on the CPU over gloo), and
keeps that function by hand with the collectives below: each rank
computes its SHARE of the global loss, the shares sum to the one-process
loss on the concatenated batch, and the gradients of the shares, summed
over the ranks (`all_reduce_sum_`), are the one-process gradient. The
ranks' blocks of a global batch come from the loader
(`data/nuscenes.py` `DataLoader(rank, world_size)`), so the JAX
`make_global_batch` has no counterpart. The mesh's `cam` axis (the
camera-sharded `lift_vectorized` lift) is left out of the port.

Without a process group every collective here is the identity and the
process is rank 0 of 1. With one (of any size, 1 included) they run.

`spawn(fn, nprocs, args, device)` starts `nprocs` ranks of `fn` in fresh
processes on one host, rendezvoused through a file store, and returns
each rank's result: the CLI's `--num-devices` and the multi-rank tests and
checks use it. `fn` must be importable by name from a module that imports
no test code.
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
    """This rank's device: its card under NCCL, else the CPU."""
    if active() and dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def initialize(device='cuda', init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               local_rank: Optional[int] = None) -> torch.device:
    """Join the process group and return this rank's device; idempotent.

    The world comes from the arguments or from torchrun's environment
    (WORLD_SIZE, RANK, LOCAL_RANK; MASTER_ADDR and MASTER_PORT through the
    default `env://` rendezvous). With neither, this is a single process:
    no group, and `device` comes back as given. A `cuda` device puts the
    rank on `cuda:LOCAL_RANK` over NCCL (no fallback); `cpu` uses gloo.
    """
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
        dev = torch.device('cuda', local_rank)
        torch.cuda.set_device(dev)
        backend = 'nccl'
    else:
        dev = torch.device('cpu')
        backend = 'gloo'
    dist.init_process_group(
        backend, init_method=init_method or 'env://', world_size=world_size,
        rank=rank, timeout=COLLECTIVE_TIMEOUT)
    return dev


def shutdown() -> None:
    if active():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# collectives of the global-batch form
# ---------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """y = sum over the ranks of x, on every rank. Every rank's loss reads
    y, so d(sum of the losses)/dx is the sum over the ranks of dL_r/dy."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, differentiable; the identity without
    a process group."""
    if not active():
        return x
    return _AllReduceSum.apply(x)


class _AllGatherRows(torch.autograd.Function):
    """The ranks' row blocks, concatenated in rank order, on every rank.
    Backward: each rank's gradient of the gathered rows is summed over the
    ranks (one all-reduce: gloo has no reduce-scatter), and the rank keeps
    its own block."""

    @staticmethod
    def forward(ctx, x, sizes):
        ctx.sizes = sizes
        ctx.rank = dist.get_rank()
        pad = x.new_zeros((max(sizes),) + tuple(x.shape[1:]))
        pad[:x.shape[0]] = x
        bufs = [torch.empty_like(pad) for _ in sizes]
        dist.all_gather(bufs, pad)
        return torch.cat([b[:n] for b, n in zip(bufs, sizes)])

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        start = sum(ctx.sizes[:ctx.rank])
        return g[start:start + ctx.sizes[ctx.rank]], None


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of `x` (ranks may hold different counts),
    concatenated in rank order: the rows one process would hold for the
    concatenated batch. Differentiable for floating tensors; bool tensors
    travel as uint8. The identity without a process group."""
    if not active():
        return x
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    ns = [torch.zeros_like(n) for _ in range(dist.get_world_size())]
    dist.all_gather(ns, n)
    sizes = [int(v) for v in torch.cat(ns).tolist()]
    if x.dtype == torch.bool:
        return _AllGatherRows.apply(x.to(torch.uint8), sizes).to(torch.bool)
    return _AllGatherRows.apply(x, sizes)


def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum each tensor (of one dtype) over the ranks in place, through one
    flat buffer: the gradient all-reduce of the train step."""
    if not active():
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    torch._foreach_copy_(list(tensors), [c.view_as(t) for c, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)])


@torch.no_grad()
def broadcast_module_(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank, in place."""
    if not active():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, 0)


def process_allgather(obj: Any) -> list:
    """`torch_dist.all_gather_object`: every rank's picklable `obj`, in rank
    order, on every rank; [obj] without a process group."""
    if not active():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def host_local_rows(tree: Any) -> Any:
    """This rank's rows of a batch-sharded result: the identity, since each
    rank computes only the rows of its own loader block."""
    return tree


# ---------------------------------------------------------------------------
# ranks in processes of their own
# ---------------------------------------------------------------------------

def _rank_entry(fn, rank_, nprocs, init_method, device, args, out_path,
                threads):
    """One spawned rank: join the group, run fn(*args), write
    ('ok', result) or ('error', traceback) to out_path."""
    if threads:
        torch.set_num_threads(threads)
    try:
        initialize(device, init_method=init_method, world_size=nprocs,
                   rank=rank_, local_rank=rank_)
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
          timeout_s: Optional[float] = None) -> list:
    """Run fn(*args) in `nprocs` fresh processes, ranks 0..nprocs-1 of one
    process group (rank r on cuda:r over NCCL, or gloo on the CPU), and
    return their results in rank order.

    The ranks rendezvous through a file store in a temporary directory. A
    rank that raises makes this raise with its traceback; the other ranks,
    which may wait in a collective, are killed. With a `timeout_s`, so is
    every rank still running after that many seconds, and then this raises
    TimeoutError; None (a training run) waits for the ranks to end. On the
    CPU each rank takes its share of this process's threads.
    """
    dev = torch.device(device)
    if dev.type == 'cuda' and nprocs > torch.cuda.device_count():
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
                                   args, outs[r], threads))
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
