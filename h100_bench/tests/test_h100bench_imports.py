"""What a run and the reference load, compared by whole top-level module
names: no `jax`, `jaxlib`, `flax` or `vampire_tpu` (the program's name,
`vampire_tpu_torch`, begins with the JAX package's and passes), and the
reference nothing of the program. Each in a fresh interpreter."""
import os
import subprocess
import sys

from harness import guard

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)


def loaded_after(code: str) -> set:
    prog = ('import sys\n'
            f'sys.path[:0] = [{BENCH!r}, {HERE!r}, {ROOT!r}]\n'
            + code +
            '\nprint("MODULES", sorted({m.split(".")[0] for m in '
            'sys.modules}))\n')
    out = subprocess.run([sys.executable, '-c', prog], capture_output=True,
                         text=True, timeout=600, cwd=ROOT,
                         env=dict(os.environ, USE_FLAX='0'))
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith('MODULES')]
    return set(eval(line[-1][len('MODULES '):]))


def test_guard_compares_whole_names():
    assert guard.forbidden_loaded(['vampire_tpu_torch.ops', 'numpy']) == []
    assert guard.forbidden_loaded(['vampire_tpu.ops', 'jaxlib.xla',
                                   'flax']) == ['flax', 'jaxlib',
                                                'vampire_tpu']


def test_a_run_loads_no_jax():
    """A whole run of each kind at the tiny size (the program, the
    reference, the check, every per-layer reader) and the entry point's
    modules."""
    mods = loaded_after(
        'import run\n'
        'from harness import cli, control, spec\n'
        'import harness_cpu\n'
        'for t in harness_cpu.TRAFFIC:\n'
        '    r, c, ctx = harness_cpu.run(t, seconds=0.5)\n'
        '    control.numbers(ctx)\n'
        'for m in spec.benchmark()["per_layer"]:\n'
        '    spec.metric_reader(m["name"])\n'
        'from harness import guard\n'
        'assert guard.forbidden_loaded() == [], guard.forbidden_loaded()\n')
    assert not mods & set(guard.FORBIDDEN)
    assert 'vampire_tpu_torch' in mods and 'reference' in mods


def test_the_reference_loads_nothing_of_the_program():
    mods = loaded_after(
        'import pkgutil, importlib, reference\n'
        'for m in pkgutil.walk_packages(reference.__path__, "reference."):\n'
        '    importlib.import_module(m.name)\n')
    assert 'reference' in mods
    assert not mods & (set(guard.FORBIDDEN) | {'vampire_tpu_torch',
                                               'harness'})
