"""Every module of the PyTorch port imports with JAX, flax, optax,
matplotlib, PIL and the JAX package `vampire_tpu` blocked: the port depends
on none of them when a module is imported (PIL is imported only inside the
functions that decode or write images), and keeps its own copies of what it
needs from `vampire_tpu`."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r'''
import importlib, pkgutil, sys
BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'matplotlib', 'vampire_tpu',
           'PIL')
for name in BLOCKED:
    sys.modules[name] = None
import vampire_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(vampire_tpu_torch.__path__,
                                              'vampire_tpu_torch.')]
for m in mods:
    importlib.import_module(m)
leaked = sorted(k for k in sys.modules
                if k.split('.')[0] in BLOCKED and sys.modules[k] is not None)
assert not leaked, leaked
print(len(mods))
'''


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, '-c', _SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    # core/3, models/6, ops/9 (_build, lift, tables, rays, lovasz, nms,
    # target_assign, gather_probe, msssim), serving/1, training/5, tools/3
    # (stage_split, gather_probe, grad_spread), data/4
    # (synthetic, transforms, fake, nuscenes), evaluation/3 (nusc_metric,
    # det_evaluator, lidarseg), utils/3 (vis, torch_weights, profiling),
    # exps/5 (the experiment entries), parallel/2 (distributed, _testing),
    # configs, weights, cli, and the 11 packages
    assert int(proc.stdout.strip()) >= 58, proc.stdout
