"""vampire_tpu_torch: the PyTorch/CUDA port of vampire_tpu for NVIDIA Hopper.

The JAX package `vampire_tpu` stays the reference. This package ports its
serving paths slice by slice (the flagship metrics graph, then the
full-render graph with the camera rays); see ROADMAP.md.

Package layout (each module mirrors its counterpart in vampire_tpu)
  core/      geometry, field sampling and the corner table, volume rendering
             (plain torch: the reference versions of the kernels)
  models/    ResNet, SECONDFPN, Unet3D, field backbone, CenterPoint head
  ops/       the wrappers of the lift, corner-table and ray kernels, and the
             nvcc build of csrc/
  csrc/      hand-written CUDA kernels (sm_90a)
  serving/   the micro-batching InferenceServer
  weights.py flax variables -> torch state_dict
  configs.py the jax-free configuration and synthetic-input modules of
             vampire_tpu, reused as they are
"""
