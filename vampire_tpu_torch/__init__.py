"""vampire_tpu_torch: the PyTorch/CUDA port of vampire_tpu for NVIDIA Hopper.

The JAX package `vampire_tpu` stays the reference. This package ports its
serving path (the flagship metrics graph) slice by slice; see ROADMAP.md.

Package layout (each module mirrors its counterpart in vampire_tpu)
  core/      geometry, field sampling, BEV volume rendering (plain torch)
  models/    ResNet, SECONDFPN, Unet3D, field backbone, CenterPoint head
  ops/       the lift kernel's wrapper and the nvcc build of csrc/
  csrc/      hand-written CUDA kernels (sm_90a)
  serving/   the micro-batching InferenceServer
  weights.py flax variables -> torch state_dict
  configs.py the jax-free configuration and synthetic-input modules of
             vampire_tpu, reused as they are
"""
