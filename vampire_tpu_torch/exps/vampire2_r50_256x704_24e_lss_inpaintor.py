"""Experiment entry: vampire2_r50_256x704_24e_lss_inpaintor
(reference src/exps/nuscenes/ablation/vampire2_r50_256x704_24e_lss_inpaintor.py).

Run: python -m vampire_tpu_torch.exps.vampire2_r50_256x704_24e_lss_inpaintor [cli args]
"""
import sys

from ..cli import main

if __name__ == '__main__':
    main(['--exp', 'lss_inpaintor'] + sys.argv[1:])
