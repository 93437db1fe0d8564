"""The ray kernel's dense march and its stop mode on `chip_smoke.py`'s
flagship frame, for a before/after comparison of two trees in one chip
call.

    python vampire_tpu_torch/tools/ray_stop.py

Run from the root of a checkout on a CUDA card. The script imports
`chip_smoke` and `vampire_tpu_torch` from the working directory, so the
same file measures another tree, e.g. a parent commit unpacked into an
ignored directory:

    (cd build/parent && python ../../vampire_tpu_torch/tools/ray_stop.py)

It builds the kernels, makes `chip_smoke.ray_field`'s frame (67,584 rays
x 85 samples through a bf16 field), runs that tree's `ray_check` and
`ray_stop_check` (the dense march and the early-termination sampler's
launches against their plain versions, each timed), and prints the
sha256 of the dense march's output: equal digests from two trees mean the
same bits. The last line is one JSON object with the numbers and the
card's name and power limit.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys


def main():
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('ray_stop: no CUDA card')
    import chip_smoke as cs
    from vampire_tpu_torch.configs import flagship_config
    from vampire_tpu_torch.ops import rays
    card = cs.device_phase()
    cs.build_phase()
    bc = flagship_config().backbone
    args = cs.ray_field(bc, 'cuda')
    dense = cs.ray_check(card, bc, 'cuda', args)
    stop = cs.ray_stop_check(card, bc, 'cuda', args)
    out = rays.sample_and_composite_rays(*args)
    torch.cuda.synchronize()
    rec = dict(tree=os.getcwd(), card=card,
               dense_digest=hashlib.sha256(
                   out.cpu().numpy().tobytes()).hexdigest(),
               dense=dict(ms=dense['ms'], bound_ms=dense['bound_ms'],
                          plan=dense['plan']),
               stop={k: v for k, v in stop.items() if k != 'plan'})
    print(json.dumps(rec), flush=True)


if __name__ == '__main__':
    main()
