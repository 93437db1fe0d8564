"""Experiment entry: vampire2_r50_256x704_24e_lss
(reference src/exps/nuscenes/ablation/vampire2_r50_256x704_24e_lss.py).

The port's model runs only the lss_inpaintor variant: this experiment raises
when its model is built (ROADMAP.md, Queue 1 item 6).

Run: python -m vampire_tpu_torch.exps.vampire2_r50_256x704_24e_lss [cli args]
"""
import sys

from ..cli import main

if __name__ == '__main__':
    main(['--exp', 'lss'] + sys.argv[1:])
