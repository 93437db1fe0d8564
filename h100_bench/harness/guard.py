"""The modules a run may not hold: JAX and the JAX package, compared by
whole top-level name (the program's name begins with the JAX package's)."""
from __future__ import annotations

import sys

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'vampire_tpu')


def forbidden_loaded(modules=None):
    modules = sys.modules if modules is None else modules
    return sorted({m.split('.')[0] for m in modules
                   if m.split('.')[0] in FORBIDDEN})
