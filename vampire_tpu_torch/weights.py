"""Carry the JAX model's weights across: flax variables -> torch state_dict.

The port's modules keep the flax module names, so the mapping is mechanical
(the inverse direction of `vampire_tpu/utils/torch_weights.py`):

  flax path                                  torch key
  .../Conv_0/kernel, .../<conv>/kernel       ...conv.weight, ...<conv>.weight
  .../BatchNorm_0/{scale,bias}               ...bn.{weight,bias}
  batch_stats .../{mean,var}                 ...{running_mean,running_var}
  .../<conv>/bias, density_beta              same name

Layouts follow the torch module found at the mapped name:
  Conv2d           HWIO -> OIHW
  Conv3d           DHWIO -> OIDHW (Unet3D, the `lss` and `bilinear`
                   ConvSoftplus3D `base_conv/conv`, and the Conv3dZ heads,
                   `feature_conv` among them, whose params are the plain 3D
                   kernel in every JAX execution layout)
  ConvTranspose2d  HWIO -> flip H and W -> IOHW (flax ConvTranspose applies
                   the kernel as stored, torch conv_transpose2d flipped)
BatchNorm's `num_batches_tracked` is filled with 0.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn as nn

_RENAME = {'Conv_0': 'conv', 'BatchNorm_0': 'bn'}


def _leaves(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if hasattr(tree, 'items'):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, np.asarray(tree)


def _kernel(w: np.ndarray, mod: nn.Module) -> np.ndarray:
    if isinstance(mod, nn.ConvTranspose2d):
        return w[::-1, ::-1].transpose(2, 3, 0, 1)
    if isinstance(mod, nn.Conv3d):
        return w.transpose(4, 3, 0, 1, 2)
    if isinstance(mod, nn.Conv2d):
        return w.transpose(3, 2, 0, 1)
    raise TypeError(f'flax kernel for a {type(mod).__name__}')


def from_flax(variables, module: nn.Module) -> Dict[str, torch.Tensor]:
    """flax `{'params', 'batch_stats'}` tree (numpy leaves) -> a complete
    state_dict for `module` (the port module the variables belong to).

    Raises if a flax leaf maps to no torch entry, if two leaves map to the
    same entry, if a shape disagrees, or if any torch parameter or buffer is
    left unfilled.
    """
    mods = dict(module.named_modules())
    want = module.state_dict()
    sd: Dict[str, np.ndarray] = {}

    def put(key, value):
        if key in sd:
            raise KeyError(f'from_flax: two flax leaves map to {key!r}')
        if key not in want:
            raise KeyError(f'from_flax: {key!r} is not in the torch module')
        if tuple(value.shape) != tuple(want[key].shape):
            raise ValueError(f'from_flax: {key!r} has shape {value.shape}, '
                             f'the module wants {tuple(want[key].shape)}')
        sd[key] = value

    for collection, names in (('params', {'kernel': 'weight',
                                          'scale': 'weight'}),
                              ('batch_stats', {'mean': 'running_mean',
                                               'var': 'running_var'})):
        for path, leaf in _leaves(variables.get(collection, {})):
            prefix = '.'.join(_RENAME.get(p, p) for p in path[:-1])
            key = '.'.join(filter(None, (prefix, names.get(path[-1],
                                                            path[-1]))))
            if path[-1] == 'kernel':
                leaf = _kernel(leaf, mods[prefix])
            put(key, leaf)
    for name, mod in mods.items():
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            put(f'{name}.num_batches_tracked', np.zeros((), np.int64))
    missing = sorted(set(want) - set(sd))
    if missing:
        raise KeyError(f'from_flax: no flax leaf for {missing}')
    return {k: torch.from_numpy(np.array(v, order='C')).to(want[k].dtype)
            for k, v in sd.items()}
