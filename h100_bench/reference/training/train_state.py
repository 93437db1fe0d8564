"""Train state, optimizer and LR schedule; the port of
`vampire_tpu/training/train_state.py`.

The recipe, as optax runs it there: global-norm gradient clipping at
`gradient_clip_val`, then AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled
weight decay `weight_decay` on every trainable parameter) at a
piecewise-constant LR that is multiplied by `lr_gamma` from step
`milestone * steps_per_epoch` on. The EMA of the parameters, which
changes none of them, has no counterpart here. The frozen image stem has
requires_grad=False and is not in the optimizer: no update and no decay,
like the JAX package's masked set_to_zero.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.nn as nn


def lr_at(cfg, steps_per_epoch: int, step: int) -> float:
    """optax.piecewise_constant_schedule(cfg.lr, {m * steps_per_epoch:
    gamma}) at update number `step` (0-based): a boundary b scales the LR
    of every update with step >= b."""
    lr = cfg.lr
    for m in sorted(cfg.lr_milestones):
        if step >= m * steps_per_epoch:
            lr = lr * cfg.lr_gamma
    return lr


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32 (optax), from the
    per-tensor norms of one foreach launch."""
    norms = torch._foreach_norm([t.to(torch.float32) for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g <- g / norm * max_norm when
    norm >= max_norm (no epsilon, unlike torch's clip_grad_norm_), else g
    (divided and multiplied by 1, exactly), with no host sync. Returns the
    norm before clipping."""
    norm = global_norm(grads)
    clipped = norm >= max_norm
    torch._foreach_div_(grads, torch.where(clipped, norm, 1.0))
    torch._foreach_mul_(grads, torch.where(clipped, max_norm, 1.0))
    return norm


@dataclasses.dataclass
class TrainState:
    """The mutable training state: the model (parameters and BN buffers),
    its AdamW and the number of steps taken."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    steps_per_epoch: int
    step: int = 0

    def trainable(self) -> List[nn.Parameter]:
        return [p for p in self.model.parameters() if p.requires_grad]


def make_optimizer(cfg, model: nn.Module) -> torch.optim.Optimizer:
    """AdamW over the trainable parameters, the LR set per step by the
    train step (`lr_at`)."""
    params = [p for p in model.parameters() if p.requires_grad]
    return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=cfg.weight_decay)


def create_train_state(model: nn.Module, cfg, steps_per_epoch: int
                       ) -> TrainState:
    return TrainState(model=model, optimizer=make_optimizer(cfg, model),
                      steps_per_epoch=steps_per_epoch)
