"""Lovász-Softmax and cross-entropy segmentation losses; the port of
`vampire_tpu/ops/lovasz.py`.

`lovasz_softmax` keeps the JAX package's masking: invalid elements get
fg = 0 and error = 0, so they sort to the tail of each class's descending
error sort and add exactly 0, while every valid position sees the same
cumulative sums as the reference's boolean filtering. The Jaccard slope is
detached, as in the JAX `custom_vjp` (and the reference's
`torch.dot(errors_sorted, Variable(grad))`): d loss / d errors is the slope
routed back through the sort. `ce_lovasz_compact` filters the valid rows
with boolean indexing first and returns exactly `ce_lovasz`'s value.

Plain PyTorch: no kernel of the JAX package lives here.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """The Jaccard slope of (..., P) 0/1 floats sorted by error."""
    gts = torch.sum(gt_sorted, dim=-1, keepdim=True)
    intersection = gts - torch.cumsum(gt_sorted, dim=-1)
    union = gts + torch.cumsum(1.0 - gt_sorted, dim=-1)
    jaccard = 1.0 - intersection / union
    return torch.cat([jaccard[..., :1],
                      jaccard[..., 1:] - jaccard[..., :-1]], dim=-1)


def lovasz_softmax(probas: torch.Tensor, labels: torch.Tensor,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-class Lovász-Softmax over flat predictions.

    Args:
      probas: (P, C) class probabilities (softmax output).
      labels: (P,) int labels in [0, C).
      valid: optional (P,) bool mask; invalid elements are excluded exactly
        as the reference's boolean filtering would.

    Returns the scalar loss, the mean over the classes present in the valid
    labels.
    """
    P, C = probas.shape
    probas = probas.to(torch.float32)
    vf = (torch.ones(P, device=probas.device) if valid is None
          else valid.to(torch.float32))
    classes = torch.arange(C, device=probas.device)
    fg = (labels[None, :] == classes[:, None]).to(torch.float32) * vf
    errors = torch.abs(fg - probas.t()) * vf                   # (C, P)
    present = (torch.sum(fg, dim=-1) > 0).to(torch.float32)
    w = present / torch.clamp(torch.sum(present), min=1.0)     # (C,)
    errors_sorted, perm = torch.sort(errors, dim=-1, descending=True)
    slope = _lovasz_grad(torch.gather(fg, 1, perm))
    return torch.sum(torch.sum(errors_sorted * slope.detach(), dim=-1) * w)


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         valid: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Mean CE over the valid elements (torch `F.cross_entropy`'s 'mean')."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].to(torch.int64))[..., 0]
    if valid is None:
        return torch.mean(nll)
    vf = valid.to(torch.float32)
    return torch.sum(nll * vf) / torch.clamp(torch.sum(vf), min=1.0)


def ce_lovasz(logits: torch.Tensor, labels: torch.Tensor,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's seg loss pairing: CE + Lovász(softmax probs)."""
    ce = masked_cross_entropy(logits, labels, valid)
    lov = lovasz_softmax(torch.softmax(logits.to(torch.float32), dim=-1),
                         labels, valid)
    return ce + lov


def ce_lovasz_compact(logits: torch.Tensor, labels: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """`ce_lovasz` on the valid rows only: the same value, with the sorts
    over the valid rows instead of all P (the camera seg mask covers ~2 %
    of the pixels). The JAX package compacts to a static cap for its
    compiler; boolean indexing needs none (it synchronises with the host
    once for the count)."""
    idx = torch.nonzero(valid.reshape(-1), as_tuple=True)[0]
    ones = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    return ce_lovasz(logits.index_select(0, idx), labels.index_select(0, idx),
                     ones)        # no valid row: 0, as ce_lovasz gives
