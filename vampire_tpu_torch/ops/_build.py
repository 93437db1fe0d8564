"""Build the port's native sources into plain-C shared libraries at first use.

One `.cu` per CUDA library: `lift`, `corner_table`, `rays`, `gather_probe`.
`build(names)` starts one nvcc per library not built yet, all together.
One `.cpp` per host library: `host` (the NMS and the rasterizers), which
`load_host_library` builds with the host C++ compiler (`c++`) on any
machine.

`nvcc` compiles `vampire_tpu_torch/csrc/<name>.cu` for `sm_90a` into
`build/vampire_tpu_torch/<name>-<hash>.so` under the repository root; the
hash covers the sources and the flags, so an edited source rebuilds and an
unchanged one is reused. The library has a plain C interface and is loaded
with ctypes: no PyTorch headers are compiled, which keeps a build at seconds.
`kernel(library, symbol, argtypes)` gives an entry point typed once, and
`launch(fn, device, *args)` calls it on the card's current stream.

Nothing here touches CUDA when it is imported; the CPU tests import it on
machines without `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'vampire_tpu_torch')
ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')
NVCC_FLAGS = ('-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v') + ARCH_FLAGS
# no FMA contraction: the host library computes as its numpy plain version
CXX_FLAGS = ('-std=c++17', '-O3', '-shared', '-fPIC', '-ffp-contract=off')
# the dynamic shared memory one block may ask for on an H100 (227 KB)
SMEM_LIMIT = 232448

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# per library: {'path', 'seconds' (0.0 when reused), 'log' (nvcc output)}
BUILD_INFO: Dict[str, dict] = {}


def find_nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc (default /usr/local/cuda),
    else the one on PATH. Raises if there is none."""
    nvcc = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                        'bin', 'nvcc')
    found = nvcc if os.path.exists(nvcc) else shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA kernels of '
                           'vampire_tpu_torch build only where the CUDA '
                           'toolkit is installed')
    return found


def _digest(source: str, flags: Sequence[str]) -> str:
    h = hashlib.sha256(' '.join(flags).encode())
    with open(source, 'rb') as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def build(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Build (where needed) and load csrc/<name>.cu for every name. The nvcc
    processes of the libraries not built yet all start together and run in
    parallel. Raises on any failure."""
    with _lock:
        jobs = {}
        for name in names:
            if name in _libs or name in jobs:
                continue
            src = os.path.join(CSRC, f'{name}.cu')
            path = os.path.join(BUILD_DIR,
                                f'{name}-{_digest(src, NVCC_FLAGS)}.so')
            BUILD_INFO[name] = dict(path=path, seconds=0.0, log='')
            if os.path.exists(path):
                jobs[name] = None
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f'{path}.{os.getpid()}.tmp'
            cmd = [find_nvcc(), *NVCC_FLAGS, '-o', tmp, src]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, src, time.perf_counter())
        failed = []
        for name, job in jobs.items():
            if job is None:
                continue
            proc, tmp, src, t0 = job
            log, _ = proc.communicate()
            info = BUILD_INFO[name]
            info['seconds'] = time.perf_counter() - t0
            info['log'] = log
            if proc.returncode != 0:
                failed.append(f'nvcc failed ({proc.returncode}) for '
                              f'{src}:\n{log[-4000:]}')
            else:
                os.replace(tmp, info['path'])
        if failed:
            raise RuntimeError('\n'.join(failed))
        for name in jobs:
            _libs[name] = ctypes.CDLL(BUILD_INFO[name]['path'])
        return {name: _libs[name] for name in names}


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu. Raises on any failure."""
    return build([name])[name]


# the typed ctypes function of each (library, symbol), made at its first use
_fns: Dict[Tuple[str, str], Callable] = {}


def kernel(library: str, symbol: str, argtypes: Sequence) -> Callable:
    """The C entry point `symbol` of csrc/<library>.cu, built and loaded at
    its first use, with its argument types set once and an int result (the
    CUDA error code)."""
    fn = _fns.get((library, symbol))
    if fn is None:
        fn = getattr(load_library(library), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _fns[(library, symbol)] = fn
    return fn


def launch(fn: Callable, device, *args) -> int:
    """fn(*args, stream) on the current stream of `device`'s card, with that
    card current; returns fn's result, the CUDA error code. The raw stream
    handle costs the host 0.13 us where `torch.cuda.current_stream` costs
    6.6 on an H100's host (PERF.md)."""
    import torch
    args = args + (torch._C._cuda_getCurrentRawStream(device.index),)
    if device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


def load_host_library(name: str) -> ctypes.CDLL:
    """Build (if needed) with the host C++ compiler and load
    csrc/<name>.cpp. Raises on any failure."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = os.path.join(CSRC, f'{name}.cpp')
        path = os.path.join(BUILD_DIR, f'{name}-{_digest(src, CXX_FLAGS)}.so')
        BUILD_INFO[name] = dict(path=path, seconds=0.0, log='')
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f'{path}.{os.getpid()}.tmp'
            t0 = time.perf_counter()
            proc = subprocess.run(['c++', *CXX_FLAGS, '-o', tmp, src],
                                  capture_output=True, text=True)
            BUILD_INFO[name].update(seconds=time.perf_counter() - t0,
                                    log=proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(f'c++ failed ({proc.returncode}) for '
                                   f'{src}:\n{BUILD_INFO[name]["log"][-4000:]}')
            os.replace(tmp, path)
        _libs[name] = ctypes.CDLL(path)
        return _libs[name]
