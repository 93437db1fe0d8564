"""The plain reference's side of the check, run once the window has
closed, the program's peak memory has been read and its state is freed:
the same inputs and the same seeded weights, the reference's own BN
calibration, fp32 with TF32 off. With `lower` it is the control: the
reference in the program's dtypes with every conv one precision step
below (`reference/precision.py`)."""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from reference.models.centerpoint_head import decode_preds
from reference.models.vampire import Vampire
from reference.ops.nms import apply_circle_nms
from reference.precision import lower_model_
from reference.training.train_state import create_train_state
from reference.training.train_step import train_step

from .calib import calibrate_batchnorm_
from .frames import INPUT_KEYS

MATS = ('sensor2ego', 'intrin', 'ida', 'bda')


def fp32_exact() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build(rcfg, device, state_dict: Dict[str, torch.Tensor],
          lower: bool = False) -> Vampire:
    """The reference model with the benchmark's weights: fp32 with an fp32
    sampled field, or (`lower`) the control."""
    dtype = (torch.bfloat16 if lower and rcfg.train.compute_dtype ==
             'bfloat16' else torch.float32)
    model = Vampire(rcfg.backbone, rcfg.head, dtype=dtype, device=device)
    model.load_state_dict(state_dict, strict=True)
    if lower:
        lower_model_(model)
    else:
        model.backbone.sample_dtype = torch.float32
    return model


def served_inputs(frames: List[dict], device):
    t = {k: torch.from_numpy(np.ascontiguousarray(
        np.stack([f[k] for f in frames]))).to(device) for k in INPUT_KEYS}
    return t['imgs'], {k: t[k] for k in MATS}, t['points']


def serve(rcfg, device, weights: Callable[[], dict], calib: dict,
          frames: List[dict], lower: bool = False) -> List[dict]:
    """The metrics graph of each frame, one at a time, in eval mode after
    the reference's calibration on `calib`: occ_logits, occ_density,
    pts_logits and the boxes after circle NMS, as numpy."""
    fp32_exact()
    model = build(rcfg, device, weights(), lower)
    calibrate_batchnorm_(model, served_inputs([calib], device))
    outs = []
    with torch.no_grad():
        for f in frames:
            imgs, mats, points = served_inputs([f], device)
            fo, preds = model(imgs, mats, points=points,
                              camera_renders=False)
            det = [{k: v.cpu().numpy() for k, v in d.items()}
                   for d in decode_preds(preds, rcfg.head)]
            outs.append(dict(
                occ_logits=fo['occ_logits'][0].cpu().numpy(),
                occ_density=fo['occ_density'][0].cpu().numpy(),
                pts_logits=fo['pts_logits'][0].cpu().numpy(),
                det=apply_circle_nms(det, rcfg.head, 0)))
    del model
    return outs


def train(rcfg, device, weights: Callable[[], dict], batches: List[dict],
          steps_per_epoch: int, lower: bool = False) -> dict:
    """The reference's first len(batches) steps from the same weights:
    each step's loss, the first step's occupancy logits, camera depth and
    semantic renders and det heatmaps (its train-mode forward), each
    leaf's norm of the first (clipped) gradient as AdamW holds it after
    step 1, the global norm before that clip, and each
    leaf's norm of its change after the last step."""
    fp32_exact()
    model = build(rcfg, device, weights(), lower)
    model.backbone.checkpoint_encoder = True
    state = create_train_state(model, rcfg.train, steps_per_epoch)
    return follow(state, batches, rcfg, device,
                  lambda s, b: train_step(s, b, rcfg))


def follow(state, batches, cfg, device, step_fn, to_device=None) -> dict:
    """Drive `step_fn(state, batch)` over `batches` and read the numbers the
    check compares; shared by the program's and the reference's side."""
    names = [n for n, p in state.model.named_parameters() if p.requires_grad]
    params = state.trainable()
    p0 = [p.detach().clone() for p in params]
    beta1 = state.optimizer.param_groups[0]['betas'][0]
    losses, g1, first = [], None, {}
    model = state.model
    forward = model.forward
    patched = 'forward' in vars(model)

    def first_forward(*a, **kw):
        fo, preds = forward(*a, **kw)
        heat = torch.cat([pd['heatmap'] for pd in preds], dim=-1)
        for k, v in (('occ0', fo['occ_logits']),
                     ('depth0', fo['depth_preds']),
                     ('seg0', fo['seg_logits_preds']), ('heat0', heat)):
            first[k] = v.detach().float().cpu().numpy()
        return fo, preds
    for i, b in enumerate(batches):
        dev = (to_device(b) if to_device is not None else
               {k: torch.as_tensor(np.ascontiguousarray(v)).to(device)
                for k, v in b.items()})
        if i == 0:
            model.forward = first_forward
        try:
            logs = step_fn(state, dev)
        finally:
            if i == 0 and patched:
                model.forward = forward
            elif i == 0:
                del model.forward
        losses.append(float(logs['total_loss']))
        if i == 0:
            norm0 = float(logs['grad_norm'])
            terms = {k: float(v) for k, v in logs.items() if k != 'grad_norm'}
            # AdamW's first moment after one step is (1 - b1) g; a step
            # that never reached the optimizer leaves none
            g1 = torch.stack([
                torch.linalg.vector_norm(state.optimizer.state[p].get(
                    'exp_avg', torch.zeros_like(p)).float())
                for p in params]).cpu().numpy() / (1.0 - beta1)
        del dev, logs
    dp = torch.stack([torch.linalg.vector_norm((p.detach() - q).float())
                      for p, q in zip(params, p0)]).cpu().numpy()
    return dict(names=names, loss=np.asarray(losses), grad=g1, change=dp,
                grad_norm=norm0, clip=cfg.train.gradient_clip_val,
                terms=terms, **first)
