"""Build the port's CUDA sources into plain-C shared libraries at first use.

`nvcc` compiles `vampire_tpu_torch/csrc/<name>.cu` for `sm_90a` into
`build/vampire_tpu_torch/<name>-<hash>.so` under the repository root; the
hash covers the sources and the flags, so an edited source rebuilds and an
unchanged one is reused. The library has a plain C interface and is loaded
with ctypes: no PyTorch headers are compiled, which keeps a build at seconds.

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
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'vampire_tpu_torch')
ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')
NVCC_FLAGS = ('-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v') + ARCH_FLAGS

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


def _digest(sources: Sequence[str]) -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for s in sources:
        with open(s, 'rb') as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu. Raises on any failure."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = os.path.join(CSRC, f'{name}.cu')
        path = os.path.join(BUILD_DIR, f'{name}-{_digest([src])}.so')
        info = dict(path=path, seconds=0.0, log='')
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f'{path}.{os.getpid()}.tmp'
            cmd = [find_nvcc(), *NVCC_FLAGS, '-o', tmp, src]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  check=False)
            info['seconds'] = time.perf_counter() - t0
            info['log'] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed ({proc.returncode}) for '
                                   f'{src}:\n{info["log"][-4000:]}')
            os.replace(tmp, path)
        _libs[name] = ctypes.CDLL(path)
        BUILD_INFO[name] = info
        return _libs[name]
