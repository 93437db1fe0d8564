"""Experiment entry: vampire2_r50_256x704_24e_lss_inpaintor_depth_semantic
(reference src/exps/nuscenes/ablation/vampire2_r50_256x704_24e_lss_inpaintor_depth_semantic.py).

Run: python -m vampire_tpu_torch.exps.vampire2_r50_256x704_24e_lss_inpaintor_depth_semantic [cli args]
"""
import sys

from ..cli import main

if __name__ == '__main__':
    main(['--exp', 'lss_inpaintor_depth_semantic'] + sys.argv[1:])
