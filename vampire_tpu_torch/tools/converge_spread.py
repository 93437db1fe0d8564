"""The run-to-run spread of the convergence study on one card: the same
study (`tools/convergence_study.run`, the same seeded weights and scenes)
N times back to back, each run's loss ratios, car AP, box count, the
learned density beta and where the BEV height term stands every 50 steps.
First, at the study's saturated init, step 0's fp32 gradients through the
kernels against `plain=True` and against a second kernel run (the
relative L2 difference a tensor: median, the largest, density_beta's).

bf16 steps are not bit-reproducible on a card (atomics and split sums
order differently from run to run), and the density leaves its saturated
init only through the learnable Laplace beta (`occ_density_floor
--lw4-check`), so terms that read the density through a render (the BEV
height) may learn in one run and not in the next. This measures how often.

Usage (the card; 300 steps over 4 scenes, as `chip_smoke.py`'s phase 13):
  python -m vampire_tpu_torch.tools.converge_spread [--runs 4] \\
      [--dtype bfloat16|float32]
"""
import argparse
import json

STEPS = 300
N_BATCHES = 4


def init_gradients(cfg, dev):
    """Step 0's fp32 gradients at the seeded init on scene 0: kernels,
    kernels again and plain=True, compared per tensor."""
    import statistics
    import torch
    from ..training.losses import compute_losses
    from ..training.train_step import split_mats
    from . import convergence_study as C
    model = C.new_model(cfg, dev, torch.float32)
    model.train()
    b = C.to_device(C.make_batches(cfg, 1)[0], dev)
    init = {k: v.clone() for k, v in model.state_dict().items()}

    def grads(plain):
        model.load_state_dict(init)   # the forward moves BN statistics
        model.zero_grad(set_to_none=True)
        fo, preds = model(b['imgs'], split_mats(b), points=b['points'],
                          plain=plain)
        total, _ = compute_losses(fo, preds, b, cfg.train, cfg.head,
                                  cfg.backbone.sdf_bias,
                                  cfg.backbone.density_mode)
        total.backward()
        return {n: p.grad.detach().float().clone()
                for n, p in model.named_parameters() if p.grad is not None}

    kernel, again, plain = grads(False), grads(False), grads(True)
    out = {}
    for label, other in (('plain', plain), ('again', again)):
        rel = {n: ((kernel[n] - g).norm() / g.norm()).item()
               for n, g in other.items() if g.norm() > 0}
        beta = 'backbone.density_beta'
        out[label] = dict(median=statistics.median(rel.values()),
                          max=max(rel.values()), beta=rel[beta],
                          beta_grad=[kernel[beta].item(), other[beta].item()])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--runs', type=int, default=4)
    ap.add_argument('--dtype', choices=['bfloat16', 'float32'],
                    default='bfloat16')
    args = ap.parse_args(argv)
    import torch
    from ..configs import flagship_config
    from ..serving.server import set_fp32_precision
    from . import convergence_study as C

    dev = C.require_device('cuda')
    set_fp32_precision()
    cfg = flagship_config()
    dtype = getattr(torch, args.dtype)
    print(json.dumps(dict(init_gradients=init_gradients(cfg, dev))),
          flush=True)
    out = []
    for r in range(args.runs):
        model = C.new_model(cfg, dev, dtype)
        rec = C.run(cfg, STEPS, N_BATCHES, device='cuda',
                    dtype=dtype, model=model, log=lambda msg: None)
        line = dict(
            run=r, dtype=args.dtype, wall_s=rec['wall_s'],
            ratios={k: v['ratio'] for k, v in rec['summary'].items()},
            car_ap=rec['det_eval']['car_ap'],
            n_pred_boxes=rec['det_eval']['n_pred_boxes'],
            density_beta=float(model.backbone.density_beta.detach()
                               .float().reshape(-1)[0]),
            bev_height_every_50=rec['history']['bev_height_loss'][::50])
        out.append(line)
        print(json.dumps(line), flush=True)
    return out


if __name__ == '__main__':
    main()
