"""The system under test: `vampire_tpu_torch`, the PyTorch and CUDA
package at the root of the checkout. Only this module imports it, and
only when a run builds it."""
from __future__ import annotations

import importlib
import sys

from .spec import ROOT


class Program:

    def __init__(self):
        if ROOT not in sys.path:
            sys.path.append(ROOT)
        imp = importlib.import_module
        self.configs = imp('vampire_tpu_torch.configs')
        self.server_module = imp('vampire_tpu_torch.serving.server')
        self.train_step_module = imp('vampire_tpu_torch.training.train_step')
        self.train_state_module = imp(
            'vampire_tpu_torch.training.train_state')
        self.trainer_module = imp('vampire_tpu_torch.training.trainer')
        self.lift_module = imp('vampire_tpu_torch.ops.lift')
        self.rays_module = imp('vampire_tpu_torch.ops.rays')
