"""vampire_tpu_torch: the PyTorch/CUDA port of vampire_tpu for NVIDIA Hopper.

The JAX package `vampire_tpu` stays the reference. This package ports its
paths slice by slice (the flagship metrics graph, the full-render graph
with the camera rays, the train step, evaluation, the row-gather probes,
the input pipeline and the CLI); see ROADMAP.md. It imports neither JAX
nor anything of `vampire_tpu`: the modules it needs from there are
copied.

Package layout (each module mirrors its counterpart in vampire_tpu)
  core/      geometry, field sampling and the corner table, volume rendering
             (plain torch: the reference versions of the kernels)
  models/    ResNet, SECONDFPN, Unet3D, field backbone, CenterPoint head
  ops/       the wrappers of the lift, ray, corner-table (kernel checks only)
             and row-gather probe kernels, host NMS and rasterizers, target
             assignment, and the build of csrc/
  csrc/      hand-written CUDA kernels (sm_90a) and the host C++ (NMS,
             rasterizers)
  data/      the nuScenes dataset, loader and transforms, the fake tree,
             synthetic camera rigs and batches
  serving/   the micro-batching InferenceServer
  training/  losses, metrics, AdamW, the train step and the Trainer
  tools/     measurement scripts: stage_split, gather_probe
  weights.py flax variables -> torch state_dict
  configs.py the configuration dataclasses and the experiment presets
  cli.py     the experiment CLI; exps/ its five experiment entries
"""
