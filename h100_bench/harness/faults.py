"""Faults planted under the timed path, for the check's own tests (on the
CPU at a tiny size) and for reading a fault's numbers on the card
(`tools/readings.py --fault`). A training fault takes (ctx, step,
trainer, state) and returns the step the run drives; a serving fault
takes (ctx, server) and changes the server in place. Each undoes itself
through `ctx.keep['undo']` where it patches a module."""
from __future__ import annotations

import numpy as np


def state_unchanged(ctx, step, trainer, state):
    """Every step leaves the parameters and the optimizer as they were."""
    state.optimizer.step = lambda *a, **k: None
    return step


def half_batch(ctx, step, trainer, state):
    """Every step on the first half of its rows, the mean over those."""
    def halved(s, batch, conf):
        n = batch['imgs'].shape[0] // 2
        return step(s, {k: v[:n] for k, v in batch.items()}, conf)
    return halved


def half_loss(ctx, step, trainer, state):
    """Every step's forward over all its rows, its losses (and so its
    backward) over the first half of them, the mean over those: every
    tensor of the predictions and the batch whose leading axis is the
    rows is cut to its first half before the program's `compute_losses`."""
    ts = ctx.program.train_step_module
    losses = ts.compute_losses

    def first_half(x, n):
        if isinstance(x, dict):
            return {k: first_half(v, n) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(first_half(v, n) for v in x)
        if hasattr(x, 'shape') and x.dim() > 0 and x.shape[0] == n:
            return x[:n // 2]
        return x

    def halved(fo, preds, batch, *a, **k):
        n = batch['imgs'].shape[0]
        return losses(first_half(fo, n), first_half(preds, n),
                      first_half(batch, n), *a, **k)
    ts.compute_losses = halved
    ctx.keep['undo'] = lambda: setattr(ts, 'compute_losses', losses)
    return step


def logits_altered(ctx, step, trainer, state):
    """The model's occupancy logits altered where it makes them, in every
    training forward: one class's logits one higher."""
    model = trainer.model
    forward = model.forward

    def altered(*a, **k):
        fo, preds = forward(*a, **k)
        occ = fo['occ_logits'].clone()
        occ[..., 3] += 1.0
        return dict(fo, occ_logits=occ), preds
    model.forward = altered
    return step


def answer_altered(ctx, server):
    """Every response's occupancy logits altered where the server makes
    them: one class's logits one higher."""
    fwd = server.forward

    def forward(batch):
        out = fwd(batch)
        out['occ_logits'] = out['occ_logits'].copy()
        out['occ_logits'][..., 3] += 1.0
        return out
    server.forward = forward


def boxes_altered(ctx, server):
    """The boxes of every response moved by a metre where the server
    makes them (its circle NMS)."""
    from vampire_tpu_torch.serving import server as S
    nms = S.apply_circle_nms

    def moved(*a, **k):
        b, s, lab = nms(*a, **k)
        return b + np.array([1.0] + [0.0] * 8), s, lab
    S.apply_circle_nms = moved
    ctx.keep['undo'] = lambda: setattr(S, 'apply_circle_nms', nms)


def half_batch_served(ctx, server):
    """The second half of every micro-batch answered with the first
    half's rows."""
    fwd = server.forward

    def forward(batch):
        n = len(batch['imgs'])
        h = max(1, n // 2)
        half = {k: np.concatenate([v[:h]] * (n // h + 1))[:n]
                for k, v in batch.items()}
        return fwd(half)
    server.forward = forward


TRAIN = dict(state_unchanged=state_unchanged, half_batch=half_batch,
             half_loss=half_loss, logits_altered=logits_altered)
SERVE = dict(answer_altered=answer_altered, boxes_altered=boxes_altered,
             half_batch_served=half_batch_served)
