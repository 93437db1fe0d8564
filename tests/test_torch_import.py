"""Every module of the PyTorch port imports with JAX, flax and optax blocked:
the machine with the card has none of them."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r'''
import importlib, pkgutil, sys
for name in ('jax', 'jaxlib', 'flax', 'optax'):
    sys.modules[name] = None
import vampire_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(vampire_tpu_torch.__path__,
                                              'vampire_tpu_torch.')]
for m in mods:
    importlib.import_module(m)
leaked = sorted(k for k in sys.modules
                if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax')
                and sys.modules[k] is not None)
assert not leaked, leaked
print(len(mods))
'''


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, '-c', _SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    # core/3, models/6, ops/4 (lift, tables, rays, _build), serving/1 +
    # packages and top-level modules
    assert int(proc.stdout.strip()) >= 20, proc.stdout
