"""Torchvision ResNet checkpoint -> the port's image backbone; the port of
`vampire_tpu/utils/torch_weights.py`.

The reference initialises its image backbone from torchvision
(`init_cfg=dict(type='Pretrained', checkpoint='torchvision://resnet50')`,
base_exp.py:73). `load_torchvision_resnet` reads a torchvision state dict
from a local .pth file (nothing is downloaded) and maps it onto the keys of
`models.resnet.ResNet`; `graft_into_model_` copies it into a model's
`backbone.img_backbone`.

Mapping (torchvision -> port):
  conv1 / bn1                      -> stem.conv / stem.bn
  layer{i}.{j}.conv{k} / bn{k}     -> layer{i}_{j}.conv{k}.conv / .bn
  layer{i}.{j}.downsample.0 / .1   -> layer{i}_{j}.downsample.conv / .bn
Convolution kernels are OIHW on both sides, so nothing is transposed (the
JAX converter transposes to HWIO). BatchNorm keeps weight, bias,
running_mean and running_var; `fc.*` and `num_batches_tracked` are not
read.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

# blocks a stage of each torchvision depth; the tiny configs' depth 10 has
# no torchvision counterpart (KeyError, as in the JAX converter)
STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3)}
_BN_KEYS = ('weight', 'bias', 'running_mean', 'running_var')


def convert_torchvision_resnet(state_dict: Mapping[str, torch.Tensor],
                               depth: int = 50) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet state dict -> the state dict of the port's
    `ResNet(depth)` (parameters and BN running statistics, keyed as
    `img_backbone.state_dict()` keys them, without num_batches_tracked).
    Raises KeyError for a depth outside {18, 34, 50, 101} and for a key
    the dict lacks."""
    blocks = STAGE_BLOCKS[depth]
    n_convs = 3 if depth >= 50 else 2
    out: Dict[str, torch.Tensor] = {}

    def convbn(name, conv, bn):
        out[f'{name}.conv.weight'] = torch.as_tensor(
            state_dict[f'{conv}.weight'])
        for k in _BN_KEYS:
            out[f'{name}.bn.{k}'] = torch.as_tensor(state_dict[f'{bn}.{k}'])

    convbn('stem', 'conv1', 'bn1')
    for i, nb in enumerate(blocks):
        for j in range(nb):
            base, name = f'layer{i + 1}.{j}', f'layer{i + 1}_{j}'
            for k in range(1, n_convs + 1):
                convbn(f'{name}.conv{k}', f'{base}.conv{k}', f'{base}.bn{k}')
            if f'{base}.downsample.0.weight' in state_dict:
                convbn(f'{name}.downsample', f'{base}.downsample.0',
                       f'{base}.downsample.1')
    return out


def load_torchvision_resnet(path: str,
                            depth: int = 50) -> Dict[str, torch.Tensor]:
    """Read a torchvision ResNet .pth (tensors only, on the CPU) and
    convert it (`convert_torchvision_resnet`)."""
    sd = torch.load(path, map_location='cpu', weights_only=True)
    return convert_torchvision_resnet(sd, depth)


def graft_into_model_(model: torch.nn.Module,
                      converted: Mapping[str, torch.Tensor]) -> None:
    """Copy a converted state dict into `model.backbone.img_backbone`, in
    place (the JAX graft returns a new tree). Every parameter and BN
    running statistic of the backbone must be in the dict at its exact
    shape, and the dict must hold nothing else: a missing key, an extra
    one or a shape mismatch raises before anything is copied."""
    target = model.backbone.img_backbone
    own = {k: v for k, v in target.state_dict().items()
           if not k.endswith('num_batches_tracked')}
    missing = sorted(set(own) - set(converted))
    extra = sorted(set(converted) - set(own))
    if missing or extra:
        raise KeyError(f'pretrained backbone: {len(missing)} backbone '
                       f'tensors missing from the checkpoint '
                       f'{missing[:4]}, {len(extra)} not in the backbone '
                       f'{extra[:4]}')
    for k, v in own.items():
        if tuple(converted[k].shape) != tuple(v.shape):
            raise ValueError(f'pretrained backbone: {k} has shape '
                             f'{tuple(converted[k].shape)}, the model '
                             f'{tuple(v.shape)}')
    with torch.no_grad():
        for k, v in own.items():
            v.copy_(converted[k])
