"""The control's arithmetic: the reference computed one precision step
below the one the configuration states, the step a later change might be
tempted to take. A conv whose `lower` is set rounds its input, its
weight and its output: bf16 (or fp16) values go to fp8 e4m3 with a
per-tensor scale, as fp8 matmuls take and give them, and are summed in
fp32; fp32 values go to bf16. The field that the point queries and the
camera rays sample, bf16 in the program, goes to fp8 the same way
(`lower_samples`). The gradient passes each rounding straight through."""
from __future__ import annotations

import torch
import torch.nn as nn


def lower_operand(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    t32 = t.to(torch.float32)
    with torch.no_grad():
        if dtype in (torch.bfloat16, torch.float16):
            amax = t32.abs().amax().clamp(min=1e-30)
            scale = 448.0 / amax
            q = (t32 * scale).to(torch.float8_e4m3fn).to(torch.float32)
            q = q / scale
        else:
            q = t32.to(torch.bfloat16).to(torch.float32)
    return t32 + (q - t32).detach()


def lower_model_(model: nn.Module) -> nn.Module:
    """Set `lower` on every conv of the reference model and
    `lower_samples` on its field."""
    model.backbone.lower_samples = True
    n = 0
    for m in model.modules():
        if hasattr(m, 'lower') and isinstance(
                m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d)):
            m.lower = True
            n += 1
    if not n:
        raise ValueError('no reference conv to lower')
    return model
