"""The reference's experiment entries, one module each; the port of the
repository's `exps/*.py`. Each runs the CLI with its `--exp`:

    python -m vampire_tpu_torch.exps.vampire2_r50_256x704_24e_lss_inpaintor_depth_semantic [cli args]
"""
