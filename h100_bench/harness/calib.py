"""BatchNorm calibration, the benchmark's copy of `chip_smoke.py`'s: the
same recipe is applied to the program's model and, afterwards, to the
reference's, each from the same frame."""
from __future__ import annotations

import torch


def calibrate_batchnorm_(model, inputs, camera_renders=False) -> int:
    """Set every BatchNorm's running statistics to the batch statistics of
    one frame: one train-mode forward of `inputs` (imgs, mats, points on
    the model's device), momentum 1. Leaves the model in eval mode.

    Seeded random weights leave BN the identity, so activations grow
    through the residual stacks until the heads saturate; calibrated
    statistics keep every layer in its working range, as a trained
    model's would. Returns the number of BatchNorm layers."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.momentum = 1.0
    imgs, mats, points = inputs
    model.train()
    for m in bns:       # the frozen stem's BN too, which train() leaves out
        m.train()
    with torch.no_grad():
        model(imgs, mats, points=points, camera_renders=camera_renders)
    model.eval()
    return len(bns)
