"""The benchmark's weights: made on the run's device from the seed, in
two large draws, for the modules of the reference model, whose parameter
names are the program's. Both sides load the same state dict.

The scheme is the program's seeded initialisation (Kaiming fan-out normal
conv kernels; the SeparateHead output convs uniform within 1 / sqrt(fan
in); zero biases but the density head's (sdf_bias - 10) and the heatmap
outputs' (separate_head_init_bias); BatchNorm the identity; density_beta
0.1), with the configuration file's `weights`: the last BatchNorm of each
residual branch scaled to `residual_bn_gamma` (the zero-init-residual
recipe, short of zero), and the density head scaled and biased so that
the camera rays end partly opaque rather than at their first sample.

With every BatchNorm at the identity the random network is chaotic: a
rounding grows about 1.25x a residual block, so that bf16 and fp32 runs of
the same ResNet-50 part by 55 % (relative L2) at its last stage, and a
check against the reference could not tell bf16 from fp8. At 0.1 they
part by 2.4 % and fp8 by 22 %."""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn

from .seeds import torch_seed


def make_state_dict(model: nn.Module, seed: int, device,
                    weights: Optional[dict] = None
                    ) -> Dict[str, torch.Tensor]:
    """Every entry of `model.state_dict()`, fp32 on `device`. `model` is a
    reference `Vampire` (on any device: only its names and shapes are
    read); `weights` is a configuration file's `weights`:
    `residual_bn_gamma` (default 1) and `density_head`, {'weight_scale',
    'bias'} (default: the random init's)."""
    weights = weights or {}
    density = weights.get('density_head')
    gamma = weights.get('residual_bn_gamma', 1.0)
    device = torch.device(device)
    want = model.state_dict()
    normal, uniform, out = [], [], {}
    for name, m in model.named_modules():
        pre = name + '.' if name else ''
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d)):
            shape = tuple(m.weight.shape)
            k = math.prod(shape[2:])
            if name.endswith('_out'):
                uniform.append((pre + 'weight', shape,
                                1.0 / math.sqrt(k * shape[1])))
            else:
                cout = (shape[1] if isinstance(m, nn.ConvTranspose2d)
                        else shape[0])
                normal.append((pre + 'weight', shape,
                               math.sqrt(2.0 / (k * cout))))
            if m.bias is not None:
                out[pre + 'bias'] = torch.zeros(m.bias.shape, device=device)
        elif isinstance(m, nn.BatchNorm2d):
            c = m.num_features
            out[pre + 'weight'] = torch.ones(c, device=device)
            out[pre + 'bias'] = torch.zeros(c, device=device)
            out[pre + 'running_mean'] = torch.zeros(c, device=device)
            out[pre + 'running_var'] = torch.ones(c, device=device)
            out[pre + 'num_batches_tracked'] = torch.zeros(
                (), dtype=torch.long, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, 'weights'))
    for entries, draw in ((normal, torch.randn), (uniform, torch.rand)):
        n = sum(math.prod(s) for _, s, _ in entries)
        flat = draw(n, generator=g, device=device)
        at = 0
        for key, shape, scale in entries:
            v = flat[at:at + math.prod(shape)].view(shape)
            at += v.numel()
            out[key] = (v * scale if draw is torch.randn
                        else (2.0 * v - 1.0) * scale)
    for name, m in model.named_modules():
        last = {'Bottleneck': 'conv3', 'BasicBlock': 'conv2'}.get(
            type(m).__name__)
        if last:
            out[f'{name}.{last}.bn.weight'].fill_(gamma)
    bc = model.backbone.cfg
    hc = model.head.cfg
    out['backbone.density_beta'] = torch.tensor(0.1, device=device)
    out['backbone.density_conv.bias'].fill_(bc.sdf_bias - 10.0)
    for t in range(len(hc.tasks)):
        out[f'head.task{t}.heatmap_out.bias'].fill_(
            hc.separate_head_init_bias)
    if density:
        out['backbone.density_conv.weight'].mul_(density['weight_scale'])
        out['backbone.density_conv.bias'].fill_(density['bias'])
    missing = set(want) - set(out)
    extra = set(out) - set(want)
    if missing or extra:
        raise ValueError(f'weights: missing {sorted(missing)}, '
                         f'extra {sorted(extra)}')
    return {k: out[k].to(want[k].dtype) for k in want}
