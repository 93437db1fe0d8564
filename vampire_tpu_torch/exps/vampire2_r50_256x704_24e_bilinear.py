"""Experiment entry: vampire2_r50_256x704_24e_bilinear
(reference src/exps/nuscenes/ablation/vampire2_r50_256x704_24e_bilinear.py).

The bilinear variant: no depth head; each camera's features are lifted by
a 2-D bilinear sample (the depth-less mode of the lift kernel) and refined
by one conv and a softplus.

Run: python -m vampire_tpu_torch.exps.vampire2_r50_256x704_24e_bilinear [cli args]
"""
import sys

from ..cli import main

if __name__ == '__main__':
    main(['--exp', 'bilinear'] + sys.argv[1:])
