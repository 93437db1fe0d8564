"""The lift kernels on `chip_smoke.py`'s flagship frame, for a before/after
comparison of two trees in one chip call.

    python vampire_tpu_torch/tools/lift_bilinear.py

Run from the root of a checkout on a CUDA card. The script imports
`chip_smoke` and `vampire_tpu_torch` from the working directory, so the
same file measures another tree, e.g. a parent commit unpacked into an
ignored directory:

    (cd build/parent && python ../../vampire_tpu_torch/tools/lift_bilinear.py)

It builds the kernels, makes `chip_smoke.lift_cameras`' frame (6 cameras,
K = 264 of G = 1,024 blocks, Q = 1,280 queries, C = 16) for the flagship
and for the bilinear variant, and times with CUDA events around runs of
100 calls back to back (the median of 5 runs, ms a call, so that the
host's launch gaps between a call's launches hide as they do on the
model's path): the depth-less forward and backward (`lift_frame_accumulate`
and `lift_frame_backward` with depth None, the bilinear lift) in bf16 and
fp32, and the depth mode's forward and backward in bf16. It prints the
sha256 of each forward's outputs (numer and denom; equal digests from two
trees mean the same bits) and of the dense ray march's output on the
kernel phase's frame (C = 22). The last line is one JSON object with the
numbers and the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys

RUNS, CALLS = 5, 100


def batched_ms(fn):
    """ms a call of fn, the median over RUNS runs of CALLS calls back to
    back, one CUDA event pair a run."""
    import statistics
    import torch
    for _ in range(5):
        fn()
    times = []
    for _ in range(RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(CALLS):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / CALLS)
    return statistics.median(times)


def _digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def main():
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('lift_bilinear: no CUDA card')
    import chip_smoke as cs
    from vampire_tpu_torch.configs import flagship_config
    from vampire_tpu_torch.ops import lift, rays
    card = cs.device_phase()
    cs.build_phase()
    bc = flagship_config().backbone
    rec = dict(tree=os.getcwd(), card=card)
    for variant in ('bilinear', bc.variant):
        (depth, feat, ids, coords, valid), (G, Q, C, K, _) = \
            cs.lift_cameras(dataclasses.replace(bc, variant=variant), 'cuda')
        g = torch.randn(G, Q, C, device='cuda',
                        generator=torch.Generator(device='cuda').manual_seed(3))
        for dt in ((torch.bfloat16, torch.float32) if variant == 'bilinear'
                   else (torch.bfloat16,)):
            dep = None if variant == 'bilinear' else depth.to(dt)
            fea = feat.to(dt)
            args = (dep, fea, ids, coords, valid)
            out = lift.lift_frame_accumulate(*args, G)
            name = f'{variant} {str(dt).replace("torch.", "")}'
            rec[name] = dict(
                digest=_digest(*out),
                ms=batched_ms(lambda: lift.lift_frame_accumulate(*args, G)),
                bwd_ms=batched_ms(lambda: lift.lift_frame_backward(*args,
                                                                   g)))
            cs.say(f'lift_bilinear tool: {name}: forward '
                   f'{rec[name]["ms"]:.4f} ms, backward '
                   f'{rec[name]["bwd_ms"]:.4f} ms, forward sha256 '
                   f'{rec[name]["digest"][:16]} [{card}]')
            del out
    args = cs.ray_field(bc, 'cuda')
    rec['rays_digest'] = _digest(rays.sample_and_composite_rays(*args))
    print(json.dumps(rec), flush=True)


if __name__ == '__main__':
    main()
