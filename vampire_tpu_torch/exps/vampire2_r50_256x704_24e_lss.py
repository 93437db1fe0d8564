"""Experiment entry: vampire2_r50_256x704_24e_lss
(reference src/exps/nuscenes/ablation/vampire2_r50_256x704_24e_lss.py).

The lss variant: the depth-softmax lift refined by one conv and a softplus
(no Unet3D inpaintor).

Run: python -m vampire_tpu_torch.exps.vampire2_r50_256x704_24e_lss [cli args]
"""
import sys

from ..cli import main

if __name__ == '__main__':
    main(['--exp', 'lss'] + sys.argv[1:])
