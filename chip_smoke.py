#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training and evaluation paths,
its input pipeline, its other field variants, its multi-device paths, its
other ray samplers, losses and init and logging extras, its row-gather
probes and its accuracy studies once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line; any failure raises and the script exits
nonzero without printing a result (numbered as they run):

  1. device  - a CUDA card must be present (no CPU fallback); prints
               `nvidia-smi --query-gpu=name,power.limit`.
  2. build   - nvcc builds vampire_tpu_torch/csrc/{lift,corner_table,rays,
               gather_probe}.cu for sm_90a, one process per source, all
               started together.
  3. kernel  - each kernel against its plain torch version at the flagship
               shapes, with the error and the median time of each:
               the lift over a frame's 6 cameras in one launch (D=86,
               h=64, w=176, C=16, K=264, Q=1280, G=1024; camera_rig
               geometry, torch.topk selection) in fp32 and bf16, also with
               every selected block selected by two cameras, and the same
               in its depth-less mode (`lift_bilinear`: the bilinear
               variant's frame, no depth, z > 0 validity; its slot-map
               kernel exactly equal to its plain version); the corner
               table of a (22, 20, 256, 256) field in fp32 and bf16, which
               must be byte-identical and launched on its plan's staging
               route (its plan and the route the kernel's C entry reports
               are printed; 16-byte loads at the flagship; timed beside a pad + strided copy, a one-hot
               conv3d and a zero_() of the table; the corner-table
               kernels left the model's path; they are the port of the TPU
               table kernels and are checked here only); the ray sampler over 67,584 rays x 85
               samples of camera_rig geometry through the bf16 channels-last
               field (voxel stride 24) of a synthetic field whose rays end
               partly opaque, and in its stop mode as the early-
               termination sampler launches it (the opt-in schedule
               ET_FRACS: launch 1 over prefix x chunk samples into each
               ray's carried state and the sort key, launch 2 resuming
               each ray there to its stop; each timed beside its plain
               version and its bound, the frame beside the dense march of
               the same call). Then the three backward
               kernels: the lift's
               per frame in fp32 and bf16 (the same two cases, and its
               depth-less mode, d feat only, with each CTA's route, sorted
               or direct, equal to the plain rule's, the share of direct
               CTAs and the terms a (CTA, pixel) pair), the corner
               table's from an fp32
               and a bf16 (21, 257, 257, 176) cotangent (byte-identical;
               timed beside a one-hot conv_transpose3d),
               and the rays' over the same 67,584 rays (d field and d
               beta). Last, the ray op above one launch's channels: at
               num_classes 29 (C = 33, two channel groups) the dense march
               and its backward, at 27 (C = 31, a state of 33 columns)
               the early-termination sampler, against their plain
               versions.
  4. slice   - InferenceServer(flagship_config(), device='cuda') in bf16 with
               seeded random weights (BN calibrated on one frame) serves 3
               full-width requests (6x256x704 images, 36,864 points) on each
               path: outputs='metrics' (the metrics graph) and outputs=None
               (the full-render graph, with the camera renders). Checks
               keys, shapes, finiteness, the depth range, det boxes after
               NMS, the kernels' launch counts per request, and that
               request 0 matches the same forward with the plain versions
               of the kernels on the card; the renders also under a
               density head that leaves the rays partly opaque. Per request
               the full-render graph launches the lift and the rays once
               each, the corner table never; the metrics graph the lift
               only.
  5. train   - Trainer(flagship_config(), device='cuda') in bf16 with seeded
               random weights. Under a density head that leaves the rays
               partly opaque, step 0's gradients through the kernels
               against the same step with plain=True in fp32 compute, and
               through the backward kernels against their plain versions
               in bf16 compute; then
               `fit` over a list loader of 3 full-width training batches
               for one epoch. Checks the launch counts per step (lift 1
               forward and 1 backward, rays 1 and 1, corner table 0 and 0),
               finite loss terms and grad_norm, every parameter with a
               gradient moved, the frozen stem bit-unchanged; then times
               more steps and reads the peak memory.
  6. eval    - Trainer(flagship_config(), device='cuda') in bf16 with seeded
               random weights and BN calibrated on one frame, through its
               evaluation entry points: `validate` over 4 frames, `test`
               (in-repo NDS/mAP against seeded GT boxes), `predict` and
               `test(vis=True)` over 2; each loader's last frame comes as
               a batch of 2 whose second row sample_valid marks padding.
               Checks each confusion's total (the valid points, the masked
               voxels), `eval_confusions` on the card against np.add.at on
               the same forward, the mIoUs in [0, 1] or NaN, the files
               each call writes (one detection entry, lidarseg bin or
               pickle per valid frame; NDS in [0, 1]) and the launches per
               call: the lift once a row, the rays once a row on vis only,
               nothing else. Prints each call's host-clock ms a row and
               its peak memory.
  7. data    - the input pipeline into the same steps: the port's
               data/fake.py writes a nuScenes-layout tree at real scale
               (4 train and 2 val samples, 35,000 points a cloud, Occ3D
               at 200x200x16, 1600x900 camera geometry; no JPEG is
               written), and its data/nuscenes.py dataset and loader read
               it in the flagship's train-mode augmentation, the image
               read alone replaced by SeededImages (a seeded uint8
               256x704 image a camera: no JPEG decode and no PIL on the
               card's machine; the line says whether PIL imports there).
               Prints __getitem__ ms a sample in train and val mode (one
               thread, decode excluded), the loader's samples/s with 1
               and 4 threads and 1 and 4 spawned processes, one batch's
               bytes and host->device time. Then `Trainer.fit` (flagship,
               bf16, B=1) over the train loader with 4 process workers
               (the train infos twice: 8 steps), its step median against
               the train phase's on synthetic batches and each step's wait
               on the loader, and peak memory; then `validate` and `test`
               over the val loader (BN calibrated on one val frame), the
               in-repo NDS scored against the dataset's
               global_gt_boxes(). Checks that a loader batch has
               synthetic_batch's keys, shapes and dtypes, that process and
               thread workers give the same batches byte for byte, that no
               worker imports torch, finite losses, the launches per row
               (fit: lift 1+1 and rays 1+1 a step; validate and test: the
               lift once a row) and the confusion totals; prints the
               phase's wall time.
  8. variants - the vampire2, lss and bilinear presets (ablation_config)
               at full width, bf16, B=1: each serves 3 requests on each
               graph as the slice phase does (the bilinear's lift through
               the depth-less kernel), takes the train phase's step-0
               gradient check and `fit` over 2 batches plus 3 timed
               steps, and one `validate` row (launches, confusion
               totals). Then flagship_config() with sweep_idxes=(0,): loader
               batches of the data phase's fake tree (a key frame and a
               sweep, 12 views) through the gradient check, one train step
               (launches, peak memory) and one metrics request against
               plain=True; and flagship_config() with lift_block=0 (the
               dense lift) through one metrics request against plain=True
               and against the block-compacted model with the same weights
               on the same inputs (equal where the top-K drops no live
               block).
  9. multi   - the multi-device paths. `Trainer.fit` (flagship, B=1 a
               rank, 3 steps, then 5 timed) in a world of min(cards, 2)
               ranks that `parallel/distributed.spawn` starts over NCCL
               (no gloo fallback; world 1 on a one-card machine), each
               rank on its card, against two single-process runs on the
               same global batches (the second in a fresh process):
               step 0's loss terms, grad_norm and unclipped gradients
               (median and max per tensor) within SPREAD_FACTOR of the
               two runs' difference (bf16 at world 1, where the forward is
               the single process's; fp32 above), the launches of the fit. Then a ReplicaPool of two
               full-render InferenceServers (cuda:0 and cuda:1, or both on
               cuda:0) serves 24 requests of 8 samples back to back, each
               result byte for byte the single server's, against one
               replica alone (frames/s of each); the pool launches the
               lift and the rays once a request. Then the pool behind
               `serve_tcp`: 8 requests through `TcpClient`, byte for byte
               equal to `infer`'s, and the median ms a request over TCP
               and direct.
 10. cam     - the camera axis of the dp x cam layout
               (`parallel/mesh.py`). (a) On the flagship frame in fp32 and
               bf16: the dense lift over cameras 0-2 plus the lift over
               3-5 against the lift over 0-5 (denominators equal,
               numerators within CAM_SPLIT_ULPS fp32 units of the lift of
               |feat|), each half against its plain version, the lift of 3
               cameras timed against 6; the ray kernel over cameras 3-5
               bit for bit rows 3-5 of the six-camera march, and against
               its plain version. (b) `Trainer.fit` (flagship, fp32, B=1
               a rank, 3 steps, then 5 timed) at dp 1 x cam 2: NCCL on two
               cards, else two ranks on cuda:0 over gloo, asked for by
               name (the line says which), against one process with the
               dense lift on the same global batches: step 0's loss terms
               and unclipped gradients (within twice what a dp 2 x cam 1
               step, the control, differs by: the flagship's fp32
               gradients move ~2.5 % in any other sum order), the fit's
               launches, each rank's step time and peak memory. (c) `validate` on the 2 rows of
               a global batch at the same layout against the one process
               (both on the initial weights, BN calibrated on another
               batch): the confusions' totals equal, at most 1e-4 of
               their entries moved by argmax near-ties.
 11. extras  - the flagship (bf16, B=1, seeded weights, BN calibrated)
               beyond the paths above. The early-termination sampler
               (ray_et_fracs = ET_FRACS) under a partly-opaque density
               head: 3 full-render requests (the lift once and the ray
               kernel's stop mode twice a request); request 0's renders
               against the plain march at the forward's own stops (every
               ray within RAY_RTOL; the plain key may move at most
               ET_CROSSED_MAX of the stops) and against plain=True (the
               rays both sides stop alike within SLICE_RTOL, at most
               ET_CROSSED_MAX of the rays stopping differently, printed
               beside exp(-min(sd, tau)) x the value scale); the
               diagnostic and the request ms beside the dense graph's. The compact sampler
               (every pass after the third keeps 0.3 of the rays) with the
               rgb loss (loss_weights[2] = 1): step 0's gradients in fp32
               against plain=True, the train-mode renders against the
               dense sampler's (they must differ: in-field samples were
               dropped), then `fit` over 2 batches with image_every=1
               (launches, a finite rgb_loss, the 6 PNGs a step), one
               direct `log_images` timed, 3 steps timed and one under
               `utils.profiling.trace` (a non-empty Chrome trace). The
               torchvision graft: a ResNet-50 state dict made from a
               seeded generator, saved, grafted by `init_state` (every
               backbone tensor bit for bit), then one request with the
               tracer on (its `server.*` spans). Prints the phase's wall
               time.
 12. probe   - `python -m vampire_tpu_torch.tools.gather_probe`'s vmem,
               layouts and dma sub-commands and its scale sub-command on
               the ray stage's 1,387,029-row tables of 256 and 176 bf16
               (depths 1, 8 and 32, issued 1 and 4 at a time, random and
               coherent indices, the static and the permuted block copy),
               through the four kernels of csrc/gather_probe.cu: each held
               bit for bit to its plain version, the capacity probe run at
               48 KB and 227 KB of shared memory and refused at one byte
               more, every kernel launched; each line carries its time,
               plain time, library time, bound and launch geometry. The
               kernels line shows three kernels at a second configuration
               too (`also_at`): `row_gather` at the vmem bf16 table
               (`gk_tala`), the dma sub-command's depth-8 gather of 2^16
               rows (`k_s2`) and its 2 MB static copy (`k_static`).
 13. converge - the accuracy studies. `tools/convergence_study.run` with
               flagship_config() in bf16 (seeded weights, the flagship
               recipe unchanged): 300 steps over 4 consistent_batch scenes
               at B=1, then the detection chain (decode_preds, circle NMS,
               the in-repo NDS/mAP) against the scenes' GT boxes. Checks
               every term and grad_norm finite at every step; each step's
               launches (lift 1+1, rays 1+1, corner table 0+0) and the
               eval's (the lift once a scene); each of the 9 loss terms
               and the total falls by tests/test_overfit.py's rule (the
               last 10 steps' mean under max(0.95 x, x - 1e-4), x the
               first 10 steps' max); the total's last/first ratio <= 0.10
               (JAX recorded 0.0185); car AP at 2 m >= 0.5 (JAX recorded
               0.9556). Prints each term's first and last beside the JAX
               record's (scripts/convergence_study.json, read only), the
               step's median ms (host clock), the peak memory and the
               det_eval. Then `tools/multisweep_ab.run` at tiny_config
               (120 steps an arm, 3 + 3 scenes, as the JAX record): each
               arm's training total falls, every held-out loss is finite,
               the launches (the F=2 arm's lift over 12 views a frame);
               prints f2_over_f1. Prints the phase's wall time.

Every kernel line carries its bound: the bytes it must move (each input
read once, each output written once; the rows or field voxels the indices
or rays touch, not the whole table or field; the lift's lines are per
frame) at 3.35 TB/s
(`tools/gather_probe.bound_ms`); their operations take less time at every
shape here. The ray kernels' lines also carry the bound of the same
function read through the corner table (`table_bound_ms`), and their
launch geometry (`plan`). The one-hot gather's
function needs no arithmetic; its entry also gives `method_ops_ms`, the
one-hot product's multiply-adds at the tensor cores' peak, and
`method_share`, that time over the kernel's.

Each model kernel's entry also gives its launches in each call of the eval
phase (`eval_launches`), of the data phase (`data_launches`) and of the
variants phase (`variant_launches`; the depth-less lift's entries give the
bilinear variant's), of the multi-device phase (`multi_launches`: rank
0's fit, the pool's requests), of the cam phase (`cam_launches`: rank 0's
fit; the lift's entry also the cam phase's times of the lift over 3 and 6
cameras, `cam_split_ms`) and of the extras phase (`extras_launches`:
the early-termination requests, the fit with panels, the grafted
request); the ray kernel's stop mode has an entry of its own
(`sample_and_composite_rays_stop`, its launches the early-termination
requests'); the object also holds the eval calls' ms a row,
validate's peak memory, the data phase's numbers (`data`) and the variants
phase's request, step and validate times and peak memory (`variants`,
`sweeps`, `dense`), the multi-device phase's world, step times, rates
and TCP overhead (`multi`), the cam phase's backend, step times, peak
memory a rank and gradient differences (`cam`) and the extras phase's
times, diagnostic and trace size (`extras`), and the converge phase's
launches (`converge_launches`: the study's 300 steps and det eval, the
multi-sweep A/B's two arms) and numbers (`converge`). The last three
lines are a JSON object of the kernels run, the card's name and power
limit, and `{"ok": true, "device": {...}}`.
"""
import contextlib
import dataclasses
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

# the loader's dataset, numpy only; its process workers (spawned) import
# this script to find SeededImages below
from vampire_tpu_torch.data.nuscenes import NuscDetSegDataset

ROOT = os.path.dirname(os.path.abspath(__file__))
N_REQUESTS = 3
KERNEL_LIBS = ('lift', 'corner_table', 'rays', 'gather_probe')
# kernel vs plain: same input values, fp32 weights and sums in the same order
# on both sides; only FMA contraction differs (~1e-7 of |value|)
KERNEL_RTOL = 1e-5
# ray kernel vs plain: the same values summed in another order, and the
# plain transmittance is a parallel cumsum where the kernel carries a
# running sum
RAY_RTOL = 1e-4
# at least this share of the ray check's rays must end partly opaque
RAY_PARTIAL_MIN = 0.10
# whole forward, kernels vs plain versions: the two lifts differ in the last
# fp32 bits, which can flip the bf16 rounding of a voxel feature (2^-8
# relative) entering the bf16 Unet3D; allow 5% of each output's magnitude
SLICE_RTOL = 5e-2
# backward kernels vs plain: fp32 atomics add in another order than the plain
# index_add (and the ray kernel takes each ray's total from the saved
# outputs where the plain version sums the tail): 1e-4 of each gradient's
# magnitude; d beta sums ~5.7 M terms of either sign: 1e-3 relative
BWD_RTOL = 1e-4
BETA_RTOL = 1e-3
N_TRAIN_BATCHES = 3
N_TIMED_STEPS = 5
# the eval phase's frames: validate over N_VAL_FRAMES, test, predict and vis
# over N_TEST_FRAMES; each loader's last frame comes padded to 2 rows
N_VAL_FRAMES = 4
N_TEST_FRAMES = 2
# the data phase's fake nuScenes tree: train and val samples, points a
# cloud (scripts/perf_dataloader.py's real-scale count), loader workers;
# the fit and the throughput runs read the train infos DATA_REPEAT times
DATA_TRAIN, DATA_VAL = 4, 2
DATA_POINTS = 35000
DATA_WORKERS = 4
DATA_REPEAT = 2
# the variants phase: the ablation presets served, trained and validated
# at full width, each over this many fit steps and timed steps
VARIANTS = ('vampire2', 'lss', 'bilinear')
N_VARIANT_BATCHES = 2
N_VARIANT_TIMED = 3
# the probe phase's scale pairs (variant, stream) of tools/gather_probe.py
PROBE_SCALE = [(v, s) for v in ('rows', 'dma1', 'dma8', 'dmau8', 'dma32',
                                'dmau32') for s in ('random', 'coherent')]
PROBE_SCALE += [('copy', 'static'), ('copy', 'permuted')]
# step 0's gradients, per parameter tensor, |g - g_ref| / |g_ref| in the L2
# norm. In fp32 compute, kernels vs plain versions in both directions: the
# two lifts differ in the last fp32 bits, and the train-mode network moves
# the gradients by far more (median 1.2e-3, max 3.2e-3 measured on an H100
# at the flagship, the same with an fp32 copy of the field for the point
# queries and the rays, so the copy's bf16 roundings are not the cause; a
# kernel path run twice differs by 1.2e-5); allow 1e-2.
TRAIN_GRAD_RTOL = 1e-2
# The same for the ablation presets of the variants phase. lss measured
# median 5.6e-4, and 1.15e-2 and 1.29e-2 in the two tensors of
# head.task5.vel_conv0 (the next 1.1e-3): with every loss weight 0 the
# preset trains on the task losses alone, and that head's small gradient
# moves most; allow 3e-2.
VARIANT_GRAD_RTOL = 3e-2
# In bf16 compute, the backward kernels vs their plain versions behind the
# same kernel forward: only the order of the fp32 atomics differs, which
# flips bf16 roundings of the gradients downstream (two kernel runs differ
# as much: max 2.5e-2 measured on an H100); allow 0.1. Kernels vs plain in
# both directions is no test in bf16: the forwards' last-bit differences
# flip bf16 roundings throughout the network and the gradients differ by a
# median of 22% (measured), as two forwards in another order would.
TRAIN_BWD_RTOL = 0.1
# the extras phase: the documented opt-in early-termination schedule
# (vampire_tpu/configs.py:192, the ray_et_study.py worst case + 10 %), the
# compact sampler's passes that keep every ray (the others keep 0.3 of
# them), its fit's batches and timed steps, and the panels of a step
ET_FRACS = (0.71, 0.47, 0.37, 0.14, 0.06, 0.03)
# the early-term stops of two sums of a ray's optical depth in different
# orders (kernel and plain) differ only where a key ties at a cap: at most
# this share of the rays may stop differently
ET_CROSSED_MAX = 0.01
# the kernel phase's wide ray checks: C = 33 (two channel groups a launch)
# and, for the early-termination sampler, C = 31 (a state of 33 columns)
WIDE_CLASSES = 29
WIDE_ET_CLASSES = 27
COMPACT_KEEP = 3
N_EXTRA_BATCHES = 2
N_EXTRA_TIMED = 3
PANELS = ('rgb_gts', 'rgb_preds', 'depth_preds', 'seg_preds', 'bev_seg',
          'bev_height')


def say(msg):
    print(f'[chip_smoke] {msg}', flush=True)


def device_phase():
    import torch
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    say(f'device: {torch.cuda.get_device_name(0)} x '
        f'{torch.cuda.device_count()}, torch {torch.__version__}, '
        f'CUDA {torch.version.cuda}')
    print(card, flush=True)
    return card


def build_phase():
    from vampire_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build(KERNEL_LIBS)
    say(f'build: {len(KERNEL_LIBS)} libraries in '
        f'{time.perf_counter() - t0:.2f} s')
    for name in KERNEL_LIBS:
        info = _build.BUILD_INFO[name]
        say(f'  {os.path.relpath(info["path"], ROOT)}: nvcc '
            f'{info["seconds"]:.2f} s')
        for ln in info['log'].splitlines():
            if 'ptxas' in ln:
                say(f'    {ln.strip()}')


def counts():
    """The launch counts of the six kernel wrappers, the lift's two in
    each of its modes."""
    from vampire_tpu_torch.ops import launch_counts
    return launch_counts()


def reset_counts():
    from vampire_tpu_torch.ops import reset_launch_counts
    reset_launch_counts()


def lift_forward_keys(cfg):
    """The launch-count keys of the kernels a config's lift forward runs,
    once each a frame: the depth-less mode and its slot map for the
    bilinear variant."""
    if cfg.backbone.variant == 'bilinear':
        return 'lift_bilinear', 'slot_map'
    return ('lift',)


def lift_keys(cfg):
    """The launch-count keys of the lift kernels a config's model runs,
    forward (`lift_forward_keys`) and backward: the forward's first."""
    bwd = ('lift_bilinear_bwd' if cfg.backbone.variant == 'bilinear'
           else 'lift_bwd')
    return lift_forward_keys(cfg) + (bwd,)


def hbm_ms(*tensors_or_bytes):
    """The least time, ms, to move these bytes (tensors count their whole
    size) through the card's memory once."""
    from vampire_tpu_torch.tools.gather_probe import bound_ms
    n = sum(t if isinstance(t, (int, float)) else t.numel() * t.element_size()
            for t in tensors_or_bytes)
    return bound_ms(n)[0]


def cuda_ms(fn, iters, warmup=3):
    """Median milliseconds of fn() on the card, one CUDA event pair each."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def lift_cameras(bc, dev):
    """One flagship frame's lift inputs: softmax depth and features from a
    seed, and per camera its top-K block ids, coords and validity from the
    camera_rig geometry, stacked as `ops.lift.lift_frame` takes them:
    depth (6, D, h, w), feat (6, h, w, C) fp32, ids (6, K), coords
    (6, K, Q, 3), valid (6, K, Q). Returns those and (G, Q, C, K, the
    valid queries)."""
    import torch
    from vampire_tpu_torch.configs import camera_rig
    from vampire_tpu_torch.core.geometry import get_pixel
    from vampire_tpu_torch.models.field import block_major_voxels, coords_valid

    D, (h, w), C = bc.depth_channels, bc.feat_hw, bc.mid_channels
    rig = {k: torch.from_numpy(v).to(dev)
           for k, v in camera_rig(1, 6, bc.final_dim, seed=0).items()}
    vox = torch.from_numpy(block_major_voxels(bc)).to(dev)
    pix = get_pixel(vox[:, :, None], rig['sensor2ego'], rig['intrin'],
                    rig['ida'], rig['bda'])[..., 0, :]
    coords, valid = coords_valid(pix, bc)
    G, Q = valid.shape[2:]
    K = min(bc.lift_block_topk, G)
    g = torch.Generator(device=dev).manual_seed(0)
    depth = torch.softmax(torch.randn(6, D, h, w, device=dev, generator=g),
                          dim=1)
    feat = torch.randn(6, h, w, C, device=dev, generator=g)
    ids = torch.topk(valid[0].sum(-1), K, dim=-1).indices       # (6, K)
    sel = ids[..., None]
    coords = torch.gather(coords[0], 1, sel[..., None].expand(-1, -1, Q, 3))
    valid = torch.gather(valid[0], 1, sel.expand(-1, -1, Q))
    frame = (depth, feat, ids.contiguous(), coords.contiguous(),
             valid.contiguous())
    return frame, (G, Q, C, K, int(valid.sum()))


def paired_ids(ids):
    """The frame's ids with cameras 1, 3 and 5 taking the blocks of cameras
    0, 2 and 4 in reverse order: every selected block is selected by two
    cameras, whose samples the kernel adds in camera order."""
    out = ids.clone()
    out[1::2] = ids[0::2].flip(-1)
    return out


def lift_check(card, bc, dev):
    """The frame lift kernel against its plain version over all 6 cameras in
    one call, in fp32 and bf16, on the frame and on `paired_ids`; times per
    frame. A bilinear `bc` runs the depth-less mode (depth None) on the
    bilinear lift's geometry (z > 0 valid, z = 0)."""
    import torch
    from vampire_tpu_torch.ops import lift
    from vampire_tpu_torch.tools.lift_bilinear import batched_ms

    dev = torch.device(dev)
    (depth, feat, ids, coords, valid), (G, Q, C, K, n_valid) = \
        lift_cameras(bc, dev)
    D, h, w = depth.shape[1:]
    what = 'lift'
    if bc.variant == 'bilinear':
        what = 'lift_bilinear'
        say(f'{what}: no depth, feat (6,{h},{w},{C}) K={K} Q={Q} G={G}, '
            f'{n_valid} valid queries; one launch a frame')
    else:
        say(f'{what}: depth (6,{D},{h},{w}) feat (6,{h},{w},{C}) K={K} '
            f'Q={Q} G={G}, {n_valid} valid queries; one launch a frame')

    result = dict(max_abs_err=0.0)
    for dt in (torch.float32, torch.bfloat16):
        dep = None if what == 'lift_bilinear' else depth.to(dt)
        fea = feat.to(dt)
        name = str(dt).replace('torch.', '')
        for case, ii in (('frame', ids), ('paired cameras', paired_ids(ids))):
            got = lift.lift_frame_accumulate(dep, fea, ii, coords, valid, G)
            want = lift.lift_frame_accumulate_reference(dep, fea, ii, coords,
                                                        valid, G)
            torch.cuda.synchronize()
            err = (got[0] - want[0]).abs().max().item()
            scale = want[0].abs().max().item()
            dmis = int((got[1] != want[1]).sum())
            tol = KERNEL_RTOL * max(1.0, scale)
            say(f'{what} {name} {case}: max abs err {err:.3e} (max |ref| '
                f'{scale:.3e}, tol {tol:.1e}); denom mismatches {dmis} of '
                f'{want[1].numel()}')
            if not err <= tol:
                raise AssertionError(f'{what} kernel {name} {case} disagrees '
                                     f'with the plain version: {err} > {tol}')
            # an exact cancellation to 0 can flip one count; allow 1e-6
            if dmis > 1e-6 * want[1].numel():
                raise AssertionError(f'{what} kernel {name} {case}: {dmis} '
                                     f'denominator counts differ')
            result['max_abs_err'] = max(result['max_abs_err'], err)
            del got, want
        ms = cuda_ms(lambda: lift.lift_frame_accumulate(
            dep, fea, ids, coords, valid, G), 50)
        plain = cuda_ms(lambda: lift.lift_frame_accumulate_reference(
            dep, fea, ids, coords, valid, G), 5)
        # the frame's inputs read once, numer and denom written once
        bound = hbm_ms(*[t for t in (dep, fea) if t is not None], ids,
                       coords, valid, 2 * G * Q * C * 4)
        back = batched_ms(lambda: lift.lift_frame_accumulate(
            dep, fea, ids, coords, valid, G))
        say(f'{what} {name}: kernel {ms:.4f} ms ({back:.4f} a call back to '
            f'back), plain {plain:.4f} ms per frame, bound {bound:.4f} ms '
            f'(share {bound / ms:.3f}; {bound / back:.3f} back to back) '
            f'[{card}]')
        result[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                            batched_ms=back)
    if what == 'lift_bilinear':
        result['slot_map'] = slot_map_check(card, ids, G)
    return result


def slot_map_check(card, ids, G):
    """The depth-less forward's slot-map kernel against its plain version
    on the frame's ids and on `paired_ids`: exactly equal. Timed beside
    the plain version; bound: the ids read once, the (N, G) int32 map
    written once."""
    import torch
    from vampire_tpu_torch.ops import lift
    from vampire_tpu_torch.tools.lift_bilinear import batched_ms
    for case, ii in (('frame', ids), ('paired cameras', paired_ids(ids))):
        got = lift.slot_map(ii, G)
        if not torch.equal(got, lift.slot_map_reference(ii, G)):
            raise AssertionError(f'slot map kernel {case}: not its plain '
                                 f'version')
    # a call alone measures the host's launch path: time calls back to back
    ms = batched_ms(lambda: lift.slot_map(ids, G))
    plain = cuda_ms(lambda: lift.slot_map_reference(ids, G), 5)
    bound = hbm_ms(ids, got)
    say(f'slot_map: ({ids.shape[0]}, {G}) int32 equal to its plain version '
        f'on the frame and on paired cameras; kernel {ms:.4f} ms a call back '
        f'to back, plain {plain:.4f} ms, bound {bound:.4f} ms (share '
        f'{bound / ms:.3f}) [{card}]')
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bound)


def bilinear_bwd_routes(card, feat_hw, frame, g, G):
    """The depth-less backward's routes on the frame: the kernel's (its
    `routes` output) equal to the plain rule's; the share of CTAs with a
    block that scatter directly; and the duplication the sorted route
    removes: the (query, corner) terms of nonzero weight against the
    distinct (CTA, pixel) pairs they land on."""
    import torch
    from vampire_tpu_torch.ops import lift
    feat, ids, coords, valid = frame
    H, W = feat_hw
    N, K, Q = valid.shape
    routes = torch.full((N, K), -1, dtype=torch.int32, device=ids.device)
    lift.lift_frame_backward(None, feat, ids, coords, valid, g,
                             routes=routes)
    want = lift.bilinear_backward_routes_reference(feat_hw, ids, coords,
                                                   valid, G)
    if not torch.equal(routes, want):
        raise AssertionError('lift_bilinear_bwd: the kernel\'s routes are '
                             'not the plain rule\'s')
    live = int((routes != lift.ROUTE_NONE).sum())
    direct = int((routes == lift.ROUTE_DIRECT).sum())
    x = ((coords[..., 0] + 1.0) * W - 1.0) / 2.0
    y = ((coords[..., 1] + 1.0) * H - 1.0) / 2.0
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    cta = torch.arange(N * K, device=ids.device).reshape(N, K, 1)
    terms, keys = 0, []
    for dy in (0, 1):
        for dx in (0, 1):
            yi, xi = y0 + dy, x0 + dx
            w = (fy if dy else 1.0 - fy) * (fx if dx else 1.0 - fx)
            hit = ((valid != 0) & (w != 0) & (yi >= 0) & (yi < H)
                   & (xi >= 0) & (xi < W))
            terms += int(hit.sum())
            keys.append((cta * (H * W) + (yi * W + xi).long())[hit])
    pairs = torch.unique(torch.cat(keys)).numel()
    say(f'lift_bilinear_bwd routes: the kernel\'s equal the plain rule\'s; '
        f'{direct} of {live} CTAs with a block scatter directly (share '
        f'{direct / max(live, 1):.3f}), {live - direct} sort into at most '
        f'{lift.MAX_BINS} bins; {terms} terms of nonzero weight land on '
        f'{pairs} distinct (CTA, pixel) pairs: {terms / max(pairs, 1):.2f} '
        f'terms a reduction where sorted [{card}]')
    return dict(direct_ctas=direct, live_ctas=live, terms=terms,
                pairs=pairs, duplication=terms / max(pairs, 1))


def table_check(card, bc, dev):
    """The corner-table kernel against its plain version on a fused field of
    the flagship grid: byte-identical, in fp32 and in bf16, with its launch
    plan and the staging route the C entry reports it launched, which must
    be the plan's (16-byte loads, vec16, at the flagship). Beside its time,
    the plain version's, the PyTorch calls' that compute the table (a pad and
    one strided copy, `library_ms`; a one-hot conv3d, TF32 off in fp32)
    and a zero_() of a buffer the table's size (`write_floor_ms`, the
    card's practical store rate)."""
    import torch
    import torch.nn.functional as F
    from vampire_tpu_torch.core.sampling import corner_table_reference
    from vampire_tpu_torch.ops import tables

    shape = (1 + bc.num_classes + 3,) + tuple(bc.grid_zyx('seg'))
    g = torch.Generator(device=dev).manual_seed(1)
    vol = torch.randn(shape, device=dev, generator=g)
    result = dict(max_abs_err=0.0)
    for dt in (torch.float32, torch.bfloat16):
        v = vol.to(dt)
        name = str(dt).replace('torch.', '')
        plan = tables.card_plan(v)
        got = tables.corner_table(v)
        if v.is_cuda:
            plan = dict(plan, launched=tables.LAST_ROUTE)
        say(f'corner_table {name}: launch {plan}')
        if v.is_cuda and plan['launched'] != plan['route']:
            raise AssertionError(f'corner_table {name}: the kernel took the '
                                 f'{plan["launched"]} route, its plan '
                                 f'{plan["route"]}')
        want = corner_table_reference(v)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        err = (got.float() - want.float()).abs().max().item()
        mb = got.numel() * got.element_size() / 1e6
        bound = hbm_ms(v, got)
        floor = cuda_ms(lambda: got.zero_(), 20)
        del got, want
        ms = cuda_ms(lambda: tables.corner_table(v), 20)
        plain = cuda_ms(lambda: corner_table_reference(v), 5)
        library = cuda_ms(lambda: tables.corner_table_library(v), 20)
        w = tables.onehot_corner_weight(shape[0], dt, v.device)
        with no_tf32():
            conv = cuda_ms(lambda: F.conv3d(v[None], w, padding=1), 10)
        say(f'corner_table {name}: {shape} -> {mb:.0f} MB, byte-identical '
            f'{same}, max abs err {err:.3e}; kernel {ms:.4f} ms '
            f'({mb / ms:.0f} GB/s written), plain {plain:.4f} ms, bound '
            f'{bound:.4f} ms (share {bound / ms:.3f}); pad + strided copy '
            f'{library:.4f} ms; one-hot conv3d {conv:.4f} ms'
            f'{" (TF32 off)" if dt == torch.float32 else ""}; zero_() of '
            f'the table {floor:.4f} ms [{card}]')
        if not same:
            raise AssertionError(f'corner_table kernel {name} is not '
                                 f'byte-identical to the plain version')
        result['max_abs_err'] = max(result['max_abs_err'], err)
        result[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                            library_ms=library, conv3d_ms=conv,
                            write_floor_ms=floor, plan=plan)
    return result


@contextlib.contextmanager
def no_tf32():
    """cuDNN convolutions in full fp32 (TF32 off) inside the block."""
    import torch
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def sdf_along_rays(sdf_vol, coords, valid):
    """(R, S) sdf of each ray sample (plain grid_sample of the (1, D, H, W)
    sdf channel, zeros padding), masked by `valid`."""
    from vampire_tpu_torch.core import sampling as S
    Rn, Sn = valid.shape
    s = S.grid_sample_3d(sdf_vol[None].float(), coords.reshape(1, -1, 3),
                         True, 'zeros')
    return s.reshape(Rn, Sn) * valid


def ray_opacity(sdf, delta, bc, beta):
    """Each ray's opacity 1 - exp(-sum density * delta) from its (R, S)
    sampled sdf, and the share of rays in (0.05, 0.95)."""
    import torch
    from vampire_tpu_torch.core import rendering as R
    sd = R.density(sdf, bc.density_mode, beta, bc.sdf_bias) * delta
    opacity = 1.0 - torch.exp(-sd.sum(-1))
    partial = ((opacity > 0.05) & (opacity < 0.95)).float().mean().item()
    return opacity, partial


def ray_field(bc, dev):
    """All rays of one frame (camera_rig geometry through get_geometry) and
    the bf16 channels-last field of a synthetic fused field, made as the
    model makes it (`ops.rays.channels_last_field`). The random-init field
    saturates every ray at its first sample (density bias sdf_bias - 10),
    so the sdf here is drawn around the density's knee instead, and the
    rays end partly opaque. Returns the sampler's arguments."""
    import torch
    from vampire_tpu_torch.configs import camera_rig
    from vampire_tpu_torch.core import geometry as G
    from vampire_tpu_torch.models.field import ray_inputs
    from vampire_tpu_torch.ops import rays

    dev = torch.device(dev)
    rig = {k: torch.from_numpy(v).to(dev)
           for k, v in camera_rig(1, 6, bc.final_dim, seed=0).items()}
    frustum = torch.from_numpy(G.make_frustum(
        bc.final_dim, bc.downsample_factor, bc.d_bound)).to(dev)
    mids = torch.from_numpy(G.make_camera_mids(bc.d_bound)).to(dev)
    geom = G.get_geometry(frustum, rig['sensor2ego'], rig['intrin'],
                          rig['ida'], rig['bda'])
    coords, valid, delta = (t[0] for t in ray_inputs(geom, bc))
    Rn, Sn = valid.shape
    vol_shape = tuple(bc.grid_zyx('seg'))
    K = bc.num_classes
    g = torch.Generator(device=dev).manual_seed(2)
    sdf = bc.sdf_bias + 0.3 + 0.4 * torch.rand((1,) + vol_shape, device=dev,
                                               generator=g)
    seg = torch.randn((K,) + vol_shape, device=dev, generator=g)
    rgb = torch.rand((3,) + vol_shape, device=dev, generator=g)
    vol = torch.cat([sdf, seg, rgb]).to(torch.bfloat16)
    field = rays.channels_last_field(vol)
    beta = torch.tensor(0.1, device=dev)

    opacity, partial = ray_opacity(sdf_along_rays(vol[:1], coords, valid),
                                   delta, bc, beta)
    q = torch.quantile(opacity, torch.tensor([0.05, 0.5, 0.95], device=dev))
    say(f'rays: {Rn} rays x {Sn} samples, field {tuple(field.shape)} bf16 '
        f'at stride {field.stride(2)}; valid samples '
        f'{valid.mean().item():.3f}; ray opacity p5/p50/p95 '
        f'{q[0].item():.3f}/{q[1].item():.3f}/{q[2].item():.3f}, '
        f'{partial:.3f} of rays in (0.05, 0.95)')
    if partial < RAY_PARTIAL_MIN:
        raise AssertionError(f'only {partial:.3f} of the rays end partly '
                             f'opaque; the check would be degenerate')
    return (field, coords, valid, delta, mids, bc.d_bound[1],
            bc.density_mode, beta, bc.sdf_bias)


def ray_read_bytes(args):
    """What the valid samples of `ray_field`'s rays read, each once: the
    distinct field voxels of nonzero weight (C channels each) and, for
    comparison, the distinct rows of the field's corner table (8 C
    channels each). Returns (voxels, their bytes, rows, their bytes)."""
    import torch
    from vampire_tpu_torch.core import sampling as S
    field, coords, valid = args[:3]
    D, H, W, C = field.shape
    c = coords.reshape(-1, 3)[valid.reshape(-1) > 0]
    vox, _, w8 = S.field_corners(c, (D, H, W))
    n_vox = torch.unique(vox[w8 != 0]).numel()
    rows, _ = S.corner_rows_weights(c, (D, H, W), True, False)
    n_rows = torch.unique(rows).numel()
    size = field.element_size()
    return n_vox, n_vox * C * size, n_rows, n_rows * 8 * C * size


def ray_plan(args, kind):
    """The ray kernel's launch on `ray_field`'s field (`ops.rays.plan`;
    kind 'forward', 'backward' or 'stop', the last as the resumed launches
    run it)."""
    from vampire_tpu_torch.ops import rays
    field = args[0]
    return rays.plan(field.dtype, field.shape[3], kind)


def ray_groups(K):
    """The output columns of the ray sampler: (name, slice) of rgb, seg
    and depth."""
    return (('rgb', slice(0, 3)), ('seg', slice(3, K + 3)),
            ('depth', slice(K + 3, K + 4)))


def ray_check(card, bc, dev, args):
    """The ray kernel against its plain version on `ray_field`."""
    import torch
    from vampire_tpu_torch.core import rendering as R
    from vampire_tpu_torch.ops import rays

    K = bc.num_classes
    got = rays.sample_and_composite_rays(*args)
    want = R.sample_and_composite_rays_field_reference(*args)
    torch.cuda.synchronize()
    result = dict(max_abs_err=0.0)
    for name, sl in ray_groups(K):
        err = (got[:, sl] - want[:, sl]).abs().max().item()
        scale = want[:, sl].abs().max().item()
        tol = RAY_RTOL * max(1.0, scale)
        say(f'rays {name}: max abs err {err:.3e} (max |ref| {scale:.3e}, '
            f'tol {tol:.1e})')
        if not err <= tol:
            raise AssertionError(f'ray kernel {name} disagrees with the '
                                 f'plain version: {err} > {tol}')
        result['max_abs_err'] = max(result['max_abs_err'], err)
    depth = got[:, K + 3]
    if not (torch.isfinite(got).all() and (depth >= bc.d_bound[0]).all()
            and (depth <= bc.d_bound[1]).all()):
        raise AssertionError('ray kernel: non-finite output or depth out of '
                             'bounds')
    result['ms'] = cuda_ms(lambda: rays.sample_and_composite_rays(*args), 20)
    result['plain_ms'] = cuda_ms(
        lambda: R.sample_and_composite_rays_field_reference(*args), 5)
    # the voxels the valid samples read, the ray geometry and the output;
    # beside it the same through the corner table's rows
    n_vox, vox_bytes, n_rows, row_bytes = ray_read_bytes(args)
    result['bound_ms'] = hbm_ms(vox_bytes, *args[1:5], got)
    result['table_bound_ms'] = hbm_ms(row_bytes, *args[1:5], got)
    result['plan'] = ray_plan(args, 'forward')
    say(f'rays bf16: kernel {result["ms"]:.4f} ms, plain '
        f'{result["plain_ms"]:.4f} ms per frame, bound '
        f'{result["bound_ms"]:.4f} ms ({n_vox} distinct field voxels read; '
        f'through the table {result["table_bound_ms"]:.4f} ms, {n_rows} '
        f'rows); launch {result["plan"]} [{card}]')
    return result


def stop_read_bytes(args, stop, begin=0):
    """What the samples [begin, stop) of each ray read, each once: valid
    and delta of every such sample (8 bytes), and the coords (12 bytes) and
    the distinct field voxels of nonzero weight (C channels each) of the
    valid ones: the kernel reads a sample's coords only where its valid is
    not 0."""
    import torch
    from vampire_tpu_torch.core import sampling as S
    field, coords, valid = args[:3]
    D, H, W, C = field.shape
    s = torch.arange(valid.shape[1], device=valid.device)[None, :]
    live = (s >= begin) & (s < stop[:, None])
    read = live & (valid > 0)
    c = coords[read]
    vox, _, w8 = S.field_corners(c, (D, H, W))
    n_vox = torch.unique(vox[w8 != 0]).numel()
    return (n_vox * C * field.element_size() + int(live.sum()) * 8
            + int(read.sum()) * 12)


def check_close(what, got, want, rtol):
    """max |got - want| within rtol of max(1, max |want|); returns the
    error."""
    err = (got - want).abs().max().item()
    tol = rtol * max(1.0, want.abs().max().item())
    if not err <= tol:
        raise AssertionError(f'{what}: {err} > {tol}')
    return err


def ray_stop_check(card, bc, dev, args):
    """The ray kernel's stop mode against its plain versions on
    `ray_field`, as the early-termination sampler (ET_FRACS, the flagship's
    ray_et_chunk and ray_et_prefix) launches it: launch 1 marches every
    ray's samples [0, p), p = prefix * chunk, into its carried state (the
    render sums, sum w, sum w * mid and the optical depth, the sort key);
    launch 2 resumes each ray at p from that state and marches it to its
    stop (`earlyterm_stops` of the kernel's key). Launch 1's state must
    agree with the plain prefix's within RAY_RTOL and its key be the
    one-shot stop mode's at p bit for bit; launch 2 with the plain resume
    from the same state; the frame with the one-shot plain march to the
    same stops. The stops the plain key would give are counted where they
    differ (the two sum a ray's optical depth in different orders). Each
    launch is timed beside its plain version and its bound, the bytes of
    its own range of samples and the state it writes or reads; the frame's
    bound is one read of each sample before its final stop, with the
    carried state's bytes (written once, read once) beside it. The dense
    march and the whole early-termination op are timed in the same call."""
    import torch
    from vampire_tpu_torch.core import rendering as R
    from vampire_tpu_torch.ops import rays
    K = bc.num_classes
    field, valid = args[0], args[2]
    Rn, Sn = valid.shape
    C = field.shape[3]
    chunk, prefix = bc.ray_et_chunk, bc.ray_et_prefix
    p = min(Sn, prefix * chunk)
    first = torch.full((Rn,), p, dtype=torch.int32, device=valid.device)
    state = rays.sample_and_composite_rays_prefix(*args, p)
    pstate = R.sample_and_composite_rays_field_prefix_reference(*args, p)
    _, sd1 = rays.sample_and_composite_rays(*args, stop=first, with_sd=True)
    torch.cuda.synchronize()
    if not torch.equal(state[:, -1], sd1):
        raise AssertionError('ray kernel stop mode: launch 1\'s key is not '
                             'the one-shot stop mode\'s bit for bit')
    err = 0.0
    cols = (('rgb', slice(0, 3)), ('seg', slice(3, K + 3)),
            ('acc_w', slice(C - 1, C)), ('acc_d', slice(C, C + 1)),
            ('od', slice(C + 1, C + 2)))
    for name, sl in cols:
        err = max(err, check_close(f'ray kernel stop mode, launch 1 {name}',
                                   state[:, sl], pstate[:, sl], RAY_RTOL))
    stop, exited, misses = R.earlyterm_stops(state[:, -1], valid, chunk,
                                             prefix, ET_FRACS)
    crossed = int((R.earlyterm_stops(pstate[:, -1], valid, chunk, prefix,
                                     ET_FRACS)[0] != stop).sum())
    if crossed > ET_CROSSED_MAX * Rn:
        raise AssertionError(f'ray kernel stop mode: the plain key moves '
                             f'{crossed} of {Rn} stops')
    got, sd = rays.sample_and_composite_rays_resume(*args, state, p, stop)
    want, wsd = R.sample_and_composite_rays_field_resume_reference(
        *args, state, p, stop)
    once, osd = R.sample_and_composite_rays_field_reference(
        *args, stop=stop, with_sd=True)
    torch.cuda.synchronize()
    for name, sl in ray_groups(K) + (('sd', None),):
        for what, ref, rsd in (('launch 2', want, wsd),
                               ('the frame vs the one-shot march', once,
                                osd)):
            g, w = (sd, rsd) if sl is None else (got[:, sl], ref[:, sl])
            err = max(err, check_close(f'ray kernel stop mode, {what}, '
                                       f'{name}', g, w, RAY_RTOL))
    result = dict(max_abs_err=err, crossed=crossed,
                  plan=ray_plan(args, 'stop'))
    result['launch_ms'] = [
        cuda_ms(lambda: rays.sample_and_composite_rays_prefix(*args, p), 20),
        cuda_ms(lambda: rays.sample_and_composite_rays_resume(
            *args, state, p, stop), 20)]
    result['launch_plain_ms'] = [
        cuda_ms(lambda: R.sample_and_composite_rays_field_prefix_reference(
            *args, p), 3),
        cuda_ms(lambda: R.sample_and_composite_rays_field_resume_reference(
            *args, state, p, stop), 3)]
    result['dense_ms'] = cuda_ms(
        lambda: rays.sample_and_composite_rays(*args), 20)
    with torch.no_grad():
        result['op_ms'] = cuda_ms(lambda: rays.render_rays_earlyterm(
            *args, chunk, prefix, ET_FRACS, bc.ray_et_tau), 20)
        result['dense_op_ms'] = cuda_ms(
            lambda: rays.render_rays(*args), 20)
    # each launch's own samples and the state it writes or reads; the
    # frame's work reads each sample before its final stop once and writes
    # the renders and the optical depth; the carried state between the
    # launches is the design's, counted apart
    result['state_bytes'] = 2 * state.numel() * state.element_size()
    result['launch_bound_ms'] = [
        hbm_ms(stop_read_bytes(args, first), args[4], state),
        hbm_ms(stop_read_bytes(args, stop, p), args[4], stop, state, got,
               sd)]
    result['bound_ms'] = hbm_ms(stop_read_bytes(args, stop), args[4], stop,
                                got, sd)
    for k in ('ms', 'plain_ms'):
        result[k] = sum(result[f'launch_{k}'])
    live = ~exited
    result['diag'] = int(R.earlyterm_uncovered_drops(sd, exited, misses,
                                                     bc.ray_et_tau))
    say(f'rays stop mode (early termination, fracs {ET_FRACS}, resumed at '
        f'{p}): {int(exited.sum())} exited rays, '
        f'{int((live & (stop < Sn)).sum())} of {int(live.sum())} others '
        f'stopped early, {int(stop.sum())} of {Rn * Sn} samples marched; '
        f'max abs err {result["max_abs_err"]:.3e}; launch 1\'s key bit-equal '
        f'to the one-shot stop mode\'s; {crossed} rays whose stop the plain '
        f'key would move; uncovered drops {result["diag"]}; launch 1 / 2 '
        f'kernel {result["launch_ms"][0]:.4f} / {result["launch_ms"][1]:.4f}'
        f' ms, plain {result["launch_plain_ms"][0]:.4f} / '
        f'{result["launch_plain_ms"][1]:.4f} ms, bound '
        f'{result["launch_bound_ms"][0]:.4f} / '
        f'{result["launch_bound_ms"][1]:.4f} ms; frame kernel '
        f'{result["ms"]:.4f} ms against the dense march\'s '
        f'{result["dense_ms"]:.4f} ({result["ms"] / result["dense_ms"]:.3f}x)'
        f', bound {result["bound_ms"]:.4f} ms (share '
        f'{result["bound_ms"] / result["ms"]:.3f}), the carried state '
        f'{result["state_bytes"]} B written and read (at the memory\'s rate '
        f'{hbm_ms(result["state_bytes"]):.4f} ms) apart; the early-term op {result["op_ms"]:.4f} ms, the dense '
        f'op {result["dense_op_ms"]:.4f} ms; launch {result["plan"]} '
        f'[{card}]')
    return result


def check_grad(what, got, want, rtol):
    """max |got - want| within rtol of max |want|; returns the error."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = rtol * scale
    say(f'{what}: max abs err {err:.3e} (max |ref| {scale:.3e}, tol '
        f'{tol:.1e})')
    if not err <= tol:
        raise AssertionError(f'{what}: kernel disagrees with the plain '
                             f'version: {err} > {tol}')
    return err


def lift_bwd_check(card, bc, dev):
    """The frame lift backward kernel against its plain version over all 6
    cameras in one call, from a random d numer (G, Q, C) fp32, in fp32 and
    bf16, on the frame and on `paired_ids`; times per frame. A bilinear `bc`
    runs the depth-less mode (d feat only)."""
    import torch
    from vampire_tpu_torch.ops import lift
    from vampire_tpu_torch.tools.lift_bilinear import batched_ms

    dev = torch.device(dev)
    (depth, feat, ids, coords, valid), (G, Q, C, K, n_valid) = \
        lift_cameras(bc, dev)
    h, w = depth.shape[2:]
    g = torch.randn(G, Q, C, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    live = int((valid.sum(-1) > 0).sum())
    # the d numer rows the valid queries read: distinct (block, query)
    rows = torch.zeros(G, Q, dtype=torch.bool, device=dev)
    rows[ids[..., None].expand(-1, -1, Q)[valid > 0],
         torch.arange(Q, device=dev).expand_as(valid)[valid > 0]] = True
    n_rows = int(rows.sum())
    what = 'lift_bilinear_bwd' if bc.variant == 'bilinear' else 'lift_bwd'
    how = ('sorts its queries by pixel in shared memory and adds a '
           'pixel\'s sum, or scatters each term' if bc.variant == 'bilinear'
           else 'adds straight into device memory')
    say(f'{what}: {ids.numel()} CTAs, one a (camera, selected block), '
        f'{live} with a valid query; every CTA {how} (float4 reductions); '
        f'{n_valid} valid queries read {n_rows} d numer rows')
    result = dict(max_abs_err=0.0, ctas=ids.numel(), live_ctas=live)
    for dt in (torch.float32, torch.bfloat16):
        dep = None if what == 'lift_bilinear_bwd' else depth.to(dt)
        fea = feat.to(dt)
        name = str(dt).replace('torch.', '')
        for case, ii in (('frame', ids), ('paired cameras', paired_ids(ids))):
            got = lift.lift_frame_backward(dep, fea, ii, coords, valid, g)
            want = lift.lift_frame_backward_reference(dep, fea, ii, coords,
                                                      valid, g)
            torch.cuda.synchronize()
            if dep is None and got[0] is not None:
                raise AssertionError(f'{what}: a d depth without a depth')
            for grad, a, b in (('d depth', got[0], want[0]),
                               ('d feat', got[1], want[1])):
                if b is None:
                    continue
                err = check_grad(f'{what} {name} {case} {grad}', a, b,
                                 BWD_RTOL)
                result['max_abs_err'] = max(result['max_abs_err'], err)
            del got, want
        ms = cuda_ms(lambda: lift.lift_frame_backward(
            dep, fea, ids, coords, valid, g), 20)
        plain = cuda_ms(lambda: lift.lift_frame_backward_reference(
            dep, fea, ids, coords, valid, g), 3)
        # what the valid queries read (their coords and d numer rows; the
        # kernel skips the others), the rest of the frame's inputs, fp32
        # d depth and d feat written; the depth-less d feat needs neither
        # depth nor the features' values
        if dep is None:
            bound = hbm_ms(ids, valid, n_valid * 3 * 4, n_rows * C * 4,
                           fea.numel() * 4)
        else:
            bound = hbm_ms(dep, fea, ids, valid, n_valid * 3 * 4,
                           n_rows * C * 4, dep.numel() * 4, fea.numel() * 4)
        back = batched_ms(lambda: lift.lift_frame_backward(
            dep, fea, ids, coords, valid, g))
        say(f'{what} {name}: kernel {ms:.4f} ms ({back:.4f} a call back to '
            f'back), plain {plain:.4f} ms per frame, bound {bound:.4f} ms '
            f'(share {bound / ms:.3f}; {bound / back:.3f} back to back) '
            f'[{card}]')
        result[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                            batched_ms=back)
    if what == 'lift_bilinear_bwd':
        result['routes'] = bilinear_bwd_routes(
            card, (h, w), (feat.to(torch.bfloat16), ids, coords, valid), g,
            G)
    return result


def table_bwd_check(card, bc, dev):
    """The corner-table backward kernel against its plain version from a
    random (21, 257, 257, 176) cotangent in fp32 and bf16: byte-identical
    (no atomics, the plain version's summation order). Beside its time, the
    one-hot conv_transpose3d's (`library_ms`, the weight built before the
    timing, TF32 off in fp32)."""
    import torch
    from vampire_tpu_torch.ops import tables

    shape = (1 + bc.num_classes + 3,) + tuple(bc.grid_zyx('seg'))
    C, D, H, W = shape
    gen = torch.Generator(device=dev).manual_seed(4)
    g32 = torch.randn((D + 1, H + 1, W + 1, 8 * C), device=dev,
                      generator=gen)
    result = dict(max_abs_err=0.0)
    for dt in (torch.float32, torch.bfloat16):
        g = g32.to(dt)
        got = tables.corner_table_backward(g, shape)
        want = tables.corner_table_backward_reference(g, shape)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        err = (got - want).abs().max().item()
        mb = g.numel() * g.element_size() / 1e6
        bound = hbm_ms(g, got)
        del got, want
        ms = cuda_ms(lambda: tables.corner_table_backward(g, shape), 20)
        plain = cuda_ms(lambda: tables.corner_table_backward_reference(
            g, shape), 5)
        w = tables.onehot_corner_weight(C, dt, g.device)
        with no_tf32():
            library = cuda_ms(lambda: tables.corner_table_backward_library(
                g, shape, w), 20)
        name = str(dt).replace('torch.', '')
        say(f'corner_table_bwd {name}: {mb:.0f} MB cotangent -> {shape} '
            f'fp32, byte-identical {same}, max abs err {err:.3e}; kernel '
            f'{ms:.4f} ms ({mb / ms:.0f} GB/s read), plain {plain:.4f} ms, '
            f'bound {bound:.4f} ms (share {bound / ms:.3f}); one-hot '
            f'conv_transpose3d {library:.4f} ms'
            f'{" (TF32 off)" if dt == torch.float32 else ""} [{card}]')
        if not same:
            raise AssertionError(f'corner_table backward kernel {name} is '
                                 f'not byte-identical to the plain version')
        result['max_abs_err'] = max(result['max_abs_err'], err)
        result[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                            library_ms=library)
    del g32
    return result


def ray_bwd_check(card, bc, dev, args):
    """The ray backward kernel against its plain version on `ray_field`,
    from a random d out over all rays: d field and d beta."""
    import torch
    from vampire_tpu_torch.core import rendering as R
    from vampire_tpu_torch.ops import rays

    out = rays.sample_and_composite_rays(*args)
    gen = torch.Generator(device=out.device).manual_seed(5)
    g = torch.randn(out.shape, device=out.device, generator=gen)
    g[:, -1] *= 0.05               # depth is ~30x the other outputs
    got = rays.sample_and_composite_rays_backward(*args, out, g)
    want = R.sample_and_composite_rays_field_backward_reference(*args, g)
    torch.cuda.synchronize()
    err = check_grad('rays_bwd d field', got[0], want[0], BWD_RTOL)
    # the voxels the valid samples read, the geometry, out and g_out, and
    # the whole fp32 d field (C channels a voxel) and d beta written; beside
    # it the same through the table: its rows, and the whole fp32 d table
    field = args[0]
    D, H, W, C = field.shape
    _, vox_bytes, _, row_bytes = ray_read_bytes(args)
    bound = hbm_ms(vox_bytes, *args[1:5], out, g, D * H * W * C * 4, 4)
    table_bound = hbm_ms(row_bytes, *args[1:5], out, g,
                         (D + 1) * (H + 1) * (W + 1) * 8 * C * 4, 4)
    b_err = abs(got[1].item() - want[1].item())
    say(f'rays_bwd d beta: {got[1].item():.6e} vs plain '
        f'{want[1].item():.6e}, rel err {b_err / abs(want[1].item()):.3e} '
        f'(tol {BETA_RTOL:.0e})')
    if not b_err <= BETA_RTOL * abs(want[1].item()):
        raise AssertionError(f'ray backward kernel d beta disagrees: '
                             f'{got[1].item()} vs {want[1].item()}')
    del got, want
    ms = cuda_ms(lambda: rays.sample_and_composite_rays_backward(
        *args, out, g), 10)
    plain = cuda_ms(
        lambda: R.sample_and_composite_rays_field_backward_reference(
            *args, g), 3)
    plan = ray_plan(args, 'backward')
    say(f'rays_bwd bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms per frame, '
        f'bound {bound:.4f} ms (through the table {table_bound:.4f} ms); '
        f'launch {plan} [{card}]')
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                table_bound_ms=table_bound, plan=plan)


def wide_ray_check(card, bc, dev):
    """The ray op above one launch's channels, on `ray_field`'s rays with
    more classes: at num_classes WIDE_CLASSES (C = 33) the dense march and
    its backward through the wrappers (two channel groups each, a launch a
    group) against their plain versions: renders within RAY_RTOL, d field
    within BWD_RTOL, d beta within BETA_RTOL; at WIDE_ET_CLASSES (C = 31,
    C + 2 = 33 state columns) the early-termination sampler (both launches
    in two groups) against the plain sampler: at most ET_CROSSED_MAX of the
    stops moved by the kernel's key, the other rays within RAY_RTOL."""
    import torch
    from vampire_tpu_torch.core import rendering as R
    from vampire_tpu_torch.ops import rays
    wide = dataclasses.replace(bc, num_classes=WIDE_CLASSES)
    args = ray_field(wide, dev)
    C = args[0].shape[3]
    groups = len(rays.channel_groups(C, rays.MOST))
    before = (rays.LAUNCHES, rays.BWD_LAUNCHES)
    out = rays.sample_and_composite_rays(*args)
    want = R.sample_and_composite_rays_field_reference(*args)
    g = torch.randn(out.shape, device=out.device,
                    generator=torch.Generator(device=out.device).manual_seed(8))
    g[:, -1] *= 0.05
    d_field, d_beta = rays.sample_and_composite_rays_backward(*args, out, g)
    w_field, w_beta = R.sample_and_composite_rays_field_backward_reference(
        *args, g)
    torch.cuda.synchronize()
    if (rays.LAUNCHES, rays.BWD_LAUNCHES) != (before[0] + groups,
                                              before[1] + groups):
        raise AssertionError(f'wide rays: {groups} groups, launches '
                             f'{rays.LAUNCHES - before[0]} and '
                             f'{rays.BWD_LAUNCHES - before[1]}')
    err = 0.0
    for name, sl in ray_groups(WIDE_CLASSES):
        err = max(err, check_close(f'wide rays C={C} {name}', out[:, sl],
                                   want[:, sl], RAY_RTOL))
    err = max(err, check_grad(f'wide rays_bwd C={C} d field', d_field,
                              w_field, BWD_RTOL))
    b_rel = abs(d_beta.item() - w_beta.item()) / abs(w_beta.item())
    if not b_rel <= BETA_RTOL:
        raise AssertionError(f'wide rays_bwd d beta: rel err {b_rel}')
    del d_field, w_field
    ms = cuda_ms(lambda: rays.sample_and_composite_rays(*args), 20)
    bwd_ms = cuda_ms(lambda: rays.sample_and_composite_rays_backward(
        *args, out, g), 10)
    del args
    et = dataclasses.replace(bc, num_classes=WIDE_ET_CLASSES)
    args = ray_field(et, dev)
    Cet = args[0].shape[3]
    before = rays.STOP_LAUNCHES
    ek = (bc.ray_et_chunk, bc.ray_et_prefix, ET_FRACS, bc.ray_et_tau)
    got, diag, stop = rays.earlyterm_march(
        rays.sample_and_composite_rays_prefix,
        rays.sample_and_composite_rays_resume, args, *ek)
    want, wdiag, wstop = rays.earlyterm_march(
        R.sample_and_composite_rays_field_prefix_reference,
        R.sample_and_composite_rays_field_resume_reference, args, *ek)
    torch.cuda.synchronize()
    et_groups = len(rays.channel_groups(Cet, rays.MOST_CARRIED))
    if rays.STOP_LAUNCHES != before + 2 * et_groups:
        raise AssertionError(f'wide early-term: {et_groups} groups, '
                             f'{rays.STOP_LAUNCHES - before} launches')
    same = stop == wstop
    crossed = int((~same).sum())
    if crossed > ET_CROSSED_MAX * stop.numel():
        raise AssertionError(f'wide early-term: {crossed} stops moved')
    for name, sl in ray_groups(WIDE_ET_CLASSES):
        err = max(err, check_close(f'wide early-term C={Cet} {name}',
                                   got[same][:, sl], want[same][:, sl],
                                   RAY_RTOL))
    say(f'wide rays: C={C} in {groups} channel groups, dense march and '
        f'backward against their plain versions (d beta rel err '
        f'{b_rel:.3e}), {ms:.4f} and {bwd_ms:.4f} ms a frame; early-term '
        f'C={Cet} in {et_groups} groups a launch, {crossed} of '
        f'{stop.numel()} stops moved by the kernel\'s key, diagnostic '
        f'{int(diag)} (plain {int(wdiag)}); max abs err {err:.3e} [{card}]')
    return dict(max_abs_err=err, groups=groups, et_groups=et_groups,
                crossed=crossed, ms=ms, bwd_ms=bwd_ms)


def kernel_phase(card, bc=None, dev='cuda'):
    """Every kernel against its plain version at the flagship's shapes (`bc`,
    the flagship backbone by default); the lift's depth-less mode at the
    bilinear variant's (the same backbone as the bilinear variant)."""
    from vampire_tpu_torch.configs import flagship_config
    bc = bc or flagship_config().backbone
    bil = dataclasses.replace(bc, variant='bilinear')
    out = dict(lift=lift_check(card, bc, dev),
               lift_bilinear=lift_check(card, bil, dev),
               corner_table=table_check(card, bc, dev))
    args = ray_field(bc, dev)
    out['rays'] = ray_check(card, bc, dev, args)
    out['rays_stop'] = ray_stop_check(card, bc, dev, args)
    out['lift_bwd'] = lift_bwd_check(card, bc, dev)
    out['lift_bilinear_bwd'] = lift_bwd_check(card, bil, dev)
    out['corner_table_bwd'] = table_bwd_check(card, bc, dev)
    out['rays_bwd'] = ray_bwd_check(card, bc, dev, args)
    del args
    out['rays_wide'] = wide_ray_check(card, bc, dev)
    return out


def calibrate_batchnorm_(model, inputs, camera_renders=False, keep=None):
    """Set every BatchNorm's running statistics to the batch statistics of
    one synthetic frame: one train-mode forward of `inputs` (imgs, mats,
    points on the model's device), momentum 1. Leaves the model in eval
    mode. The BatchNorms of the module `keep` stay in eval mode and keep
    their statistics.

    Seeded random weights leave BN the identity, so activations grow
    through the residual stacks (~3x in variance per bottleneck) until the
    heads saturate: sigmoid scores of exactly 1 and exp(dim) overflowing.
    Calibrated statistics keep every layer in its working range, as a
    trained model's would.
    """
    import torch
    kept = set(keep.modules()) if keep is not None else set()
    bns = [m for m in model.modules()
           if isinstance(m, torch.nn.BatchNorm2d) and m not in kept]
    for m in bns:
        m.momentum = 1.0
    imgs, mats, points = inputs
    model.train()
    for m in bns:       # the frozen stem's BN too, which train() leaves out
        m.train()
    if keep is not None:
        keep.eval()
    with torch.no_grad():
        model(imgs, mats, points=points, camera_renders=camera_renders)
    model.eval()
    say(f'calibrated {len(bns)} BatchNorm layers on one synthetic frame')


def serve_path(card, server, calib, samples, label, warm=None):
    """Calibrate, start and warm `server` (also on the sample `warm`, where
    the requests' shapes are not the example's), then serve `samples` with
    every launch count set to 0 just before; returns (outputs, launch
    counts, the median request ms on the host clock)."""
    import torch
    t0 = time.perf_counter()
    calibrate_batchnorm_(server.model,
                         server.to_device({k: v[None]
                                           for k, v in calib.items()}),
                         server.camera_renders)
    t1 = time.perf_counter()
    server.start()
    outs, lat = [], []
    try:
        server.warmup()
        if warm is not None:
            server.infer(warm)
        say(f'{label}: model built and BN calibrated in {t1 - t0:.1f} s, '
            f'warmup request {time.perf_counter() - t1:.1f} s')
        reset_counts()
        for s in samples:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            a.record()
            outs.append(server.infer(s))
            b.record()
            b.synchronize()
            lat.append((a.elapsed_time(b), (time.perf_counter() - h0) * 1e3))
        launched = counts()
    finally:
        server.stop()
    for i, (ev, host) in enumerate(lat):
        say(f'{label} request {i}: {ev:.2f} ms (CUDA events), {host:.2f} ms '
            f'(host clock), incl. host NMS [{card}]')
    say(f'{label}: kernel launches during the {len(samples)} requests: '
        f'{launched}')
    return outs, launched, statistics.median(h for _, h in lat)


def check_launches(label, launched, per_request):
    """Every kernel launched as often as per_request says per request (0
    where it says nothing: serving launches no backward kernel)."""
    want = {k: per_request.get(k, 0) * N_REQUESTS for k in launched}
    if launched != want:
        raise AssertionError(f'{label}: kernel launches {launched}, want '
                             f'{want} for {N_REQUESTS} requests')


def check_outputs(label, outs, want, cfg):
    import numpy as np
    hc = cfg.head
    lo, hi = cfg.backbone.d_bound[:2]
    for i, o in enumerate(outs):
        if set(o) != set(want) | {'det'}:
            raise AssertionError(f'{label} request {i}: outputs {sorted(o)}')
        for k, shape in want.items():
            if o[k].shape != shape or not np.isfinite(o[k]).all():
                raise AssertionError(f'{label} request {i}: {k} {o[k].shape} '
                                     f'finite={np.isfinite(o[k]).all()}')
        if 'depth_preds' in o:
            d = o['depth_preds']
            if not ((d >= lo).all() and (d <= hi).all()):
                raise AssertionError(f'{label} request {i}: depth '
                                     f'{d.min()}..{d.max()} outside '
                                     f'[{lo}, {hi}]')
        boxes, scores, labels = o['det']
        if len(boxes) == 0:
            raise AssertionError(f'{label} request {i}: no boxes after NMS')
        if (boxes.ndim != 2 or boxes.shape[1] != 9
                or not np.isfinite(boxes).all()
                or scores.shape != (len(boxes),)
                or labels.shape != (len(boxes),)
                or len(boxes) > hc.nms_post_max_size * len(hc.tasks)
                or not (scores > hc.score_threshold).all()):
            raise AssertionError(
                f'{label} request {i}: det {boxes.shape} {scores.shape} '
                f'{labels.shape}; non-finite per column '
                f'{(~np.isfinite(boxes)).sum(0).tolist()}, max |box| per '
                f'column {np.abs(boxes).max(0).tolist()}, scores '
                f'{scores.min() if len(scores) else None}..'
                f'{scores.max() if len(scores) else None}')
        say(f'{label} request {i}: shapes ok, finite, {len(boxes)} boxes '
            f'after NMS')


def partly_opaque_density(model, imgs, mats, points=None):
    """A density head under which the served graph's rays end partly
    opaque. The random-init bias (sdf_bias - 10) saturates every ray at its
    first sample, and the sdf varies along a ray by several times the
    density's width beta, so a comparison of rendered outputs would test
    the first sample only. From the sdf field of one forward, sampled along
    every ray of the frame: the head's weight is scaled so that the sdf's
    spread over the in-range samples is 2 beta, and its bias is found by
    bisection (opacity falls as the sdf rises) so that the median ray is
    half opaque. Returns (weight scale, bias, share of rays in (0.05, 0.95)
    predicted from the sampled field)."""
    from vampire_tpu_torch.core import geometry as G
    from vampire_tpu_torch.models.field import ray_inputs
    bb = model.backbone
    bc = bb.cfg
    got = {}
    hook = bb.density_conv.register_forward_hook(
        lambda m, i, o: got.setdefault('sdf', o.detach()))
    try:
        model(imgs, mats, points=points, camera_renders=False)
    finally:
        hook.remove()
    if mats['sensor2ego'].dim() == 5:     # multi-sweep: the key frame's
        mats = dict(mats, **{k: mats[k][:, 0]
                             for k in ('sensor2ego', 'intrin', 'ida')})
    geom = G.get_geometry(bb.frustum, mats['sensor2ego'], mats['intrin'],
                          mats['ida'], mats.get('bda'))
    coords, valid, delta = (t[0] for t in ray_inputs(geom, bc))
    bias0 = bb.density_conv.bias.detach().float()
    u = sdf_along_rays(got['sdf'][0].float() - bias0, coords, valid)
    beta = bb.density_beta.detach()
    scale = 2.0 * (beta.abs().item() + 1e-4) / u[valid > 0].std().item()
    lo, hi = -100.0, 100.0
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        op, _ = ray_opacity((scale * u + mid) * valid, delta, bc, beta)
        lo, hi = (mid, hi) if op.median().item() > 0.5 else (lo, mid)
    bias = 0.5 * (lo + hi)
    partial = ray_opacity((scale * u + bias) * valid, delta, bc, beta)[1]
    return scale, bias, partial


def check_against_plain(label, server, sample, served, keys,
                        render_keys=()):
    """Request 0 again through the model: the kernel forward gives the
    served outputs, and it agrees with the forward through the plain
    versions of the kernels on the card within SLICE_RTOL of each output's
    magnitude, for `keys` and `render_keys`. The `render_keys` are then
    compared once more under a density head that leaves the rays partly
    opaque (`partly_opaque_density`; at least RAY_PARTIAL_MIN of them),
    and the head is restored. Under that head the occupancy density sits
    at the density's knee everywhere, where it is steeper than any served
    head's, so only the renders are compared there."""
    import numpy as np
    import torch
    batch = {k: v[None] for k, v in sample.items()}
    every = tuple(keys) + tuple(render_keys)

    def forward(plain, names):
        fo, _ = server.model(imgs, mats, points=points, lidar_seg=True,
                             camera_renders=server.camera_renders,
                             plain=plain)
        return {k: fo[k][0].float().cpu().numpy() for k in names}

    def compare(kern, plain, what):
        for k in kern:
            ref = plain[k]
            diff = np.abs(kern[k] - ref)
            tol = SLICE_RTOL * max(1.0, float(np.abs(ref).max()))
            say(f'{label} request 0, kernels vs plain versions{what}: {k} '
                f'max abs err {float(diff.max()):.3e} (tol {tol:.3e}, mean '
                f'abs err {float(diff.mean()):.3e}, max |ref| '
                f'{float(np.abs(ref).max()):.3e})')
            if not float(diff.max()) <= tol:
                raise AssertionError(f'{label} {k}{what}: kernel forward vs '
                                     f'plain forward {float(diff.max())} > '
                                     f'{tol}')

    head = server.model.backbone.density_conv
    saved = [p.detach().clone() for p in (head.weight, head.bias)]
    with torch.inference_mode():
        imgs, mats, points = server.to_device(batch)
        kern = forward(False, every)
        for k in every:
            if k in served:
                err = float(np.abs(served[k] - kern[k]).max())
                tol = SLICE_RTOL * max(1.0, float(np.abs(kern[k]).max()))
                if not err <= tol:
                    raise AssertionError(f'{label} {k}: served vs kernel '
                                         f'forward {err} > {tol}')
        compare(kern, forward(True, every), '')
        if not render_keys:
            return
        scale, bias, partial = partly_opaque_density(server.model, imgs,
                                                     mats)
        say(f'{label}: density head weight x{scale:.4g}, bias {bias:+.4f}, '
            f'under which {partial:.3f} of the rays end in (0.05, 0.95)')
        if partial < RAY_PARTIAL_MIN:
            raise AssertionError(f'{label}: only {partial:.3f} of the rays '
                                 f'end partly opaque')
        try:
            head.weight.mul_(scale)
            head.bias.fill_(bias)
            compare(forward(False, render_keys),
                    forward(True, render_keys), ', partly opaque rays')
        finally:
            head.weight.copy_(saved[0])
            head.bias.copy_(saved[1])


def request_frames(cfg):
    """N_REQUESTS val-mode synthetic samples of `cfg` (seeds 0, 1, ...) and
    one more, the BN calibration frame."""
    from vampire_tpu_torch.configs import synthetic_batch
    frames = []
    for i in range(N_REQUESTS + 1):
        b = synthetic_batch(cfg, batch_size=1,
                            n_points=cfg.train.max_points, seed=i,
                            mode='val')
        frames.append({k: np.asarray(b[k])[0] for k in
                       ('imgs', 'sensor2ego', 'intrin', 'ida', 'bda',
                        'points')})
    return frames[:N_REQUESTS], frames[N_REQUESTS]


def served_shapes(cfg, N):
    """The shapes of a served request's outputs for N cameras: the metrics
    graph's, and the full-render graph's."""
    bc = cfg.backbone
    gx, gy, gz = bc.occ_grid
    Kc, P = bc.num_classes, cfg.train.max_points
    H, W = bc.final_dim
    _, Yd, Xd = bc.grid_zyx('det')
    metric = dict(occ_logits=(gx, gy, gz, Kc), occ_density=(gx, gy, gz),
                  pts_logits=(P, Kc))
    return metric, dict(metric, depth_preds=(N, H, W), seg_preds=(N, H, W),
                        bev_seg=(Yd, Xd))


def slice_phase(card, cfg=None, dev='cuda', label=''):
    """N_REQUESTS requests on each graph of `cfg` (the flagship's by
    default) through InferenceServer, checked as the docstring of this
    script says. Returns the launch counts of each graph and its median
    request ms (host clock)."""
    import torch
    from vampire_tpu_torch.configs import flagship_config
    from vampire_tpu_torch.serving import InferenceServer

    cfg = cfg or flagship_config()
    fk = dict.fromkeys(lift_forward_keys(cfg), 1)
    samples, calib = request_frames(cfg)
    metric, full = served_shapes(cfg, samples[0]['imgs'].shape[0])
    launched, ms = {}, {}

    # the metrics graph: no corner table, no rays
    server = InferenceServer(cfg, device=dev, dtype=torch.bfloat16,
                             outputs='metrics', seed=0)
    name = f'{label}metrics'
    outs, launched['metrics'], ms['metrics'] = serve_path(
        card, server, calib, samples, name)
    check_launches(name, launched['metrics'], fk)
    check_outputs(name, outs, metric, cfg)
    check_against_plain(name, server, samples[0], outs[0], metric)
    del server, outs
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    # the full-render graph: one ray launch per frame, no corner table
    server = InferenceServer(cfg, device=dev, dtype=torch.bfloat16,
                             outputs=None, seed=0)
    name = f'{label}full-render'
    outs, launched['full'], ms['full'] = serve_path(card, server, calib,
                                                    samples, name)
    check_launches(name, launched['full'], {**fk, 'rays': 1})
    check_outputs(name, outs, full, cfg)
    check_against_plain(name, server, samples[0], outs[0], metric,
                        ('rgb_preds', 'seg_logits_preds', 'depth_preds'))
    del server, outs
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return dict(launched, ms=ms)


@contextlib.contextmanager
def plain_backwards():
    """The two backward wrappers of the model's path swapped for their
    plain versions while the forward kernels stay: the model's `plain`
    switches both."""
    from vampire_tpu_torch.core import rendering as R
    from vampire_tpu_torch.ops import lift, rays

    def rays_ref(*args):            # the plain version takes no saved `out`
        return R.sample_and_composite_rays_field_backward_reference(
            *args[:-2], args[-1])
    swaps = ((lift, 'lift_frame_backward',
              lift.lift_frame_backward_reference),
             (rays, 'sample_and_composite_rays_backward', rays_ref))
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    try:
        for mod, name, ref in swaps:
            setattr(mod, name, ref)
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def step_grads(trainer, b, mats, plain=False):
    """Step 0's loss gradients, {name: fp32 copy} over the trainable
    parameters that get one; the grads are cleared again."""
    from vampire_tpu_torch.training.losses import compute_losses
    model, cfg = trainer.model, trainer.cfg
    for p in model.parameters():
        p.grad = None
    fo, preds = model(b['imgs'], mats, points=b['points'], plain=plain)
    total, _ = compute_losses(fo, preds, b, cfg.train, cfg.head,
                              cfg.backbone.sdf_bias, cfg.backbone.density_mode)
    total.backward()
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters()
             if p.requires_grad and p.grad is not None}
    for p in model.parameters():
        p.grad = None
    return grads


def compare_grads(card, label, got, want, again, rtol):
    """Per tensor |got - want| / |want| (L2) within rtol; `again` is a second
    run of `got`'s path, whose spread is printed beside. Returns the median
    and the max."""
    if set(got) != set(want):
        raise AssertionError(f'{label}: gradients of {set(got) ^ set(want)} '
                             f'exist on one side only')
    rel, spread = {}, {}
    for n, g in want.items():
        ref = g.norm().item()
        if ref == 0.0:
            if got[n].norm().item() != 0.0:
                raise AssertionError(f'{label}: {n} has a gradient on one '
                                     f'side only')
            continue
        rel[n] = (got[n] - g).norm().item() / ref
        spread[n] = (got[n] - again[n]).norm().item() / ref
    worst = sorted(rel, key=rel.get)[-3:]
    med = statistics.median(rel.values())
    beta = 'backbone.density_beta'
    say(f'{label}, |d|/|g| per tensor over {len(rel)} tensors: median '
        f'{med:.3e}, max {rel[worst[-1]]:.3e} '
        f'({", ".join(f"{n} {rel[n]:.2e}" for n in worst)}); run to run '
        f'max {max(spread.values()):.3e}; tol {rtol}; density_beta '
        f'{got[beta].item():.6e} vs {want[beta].item():.6e} [{card}]')
    bad = {n: r for n, r in rel.items() if not r <= rtol}
    if bad:
        raise AssertionError(f'{label}: gradients disagree: {bad}')
    return dict(median=med, max=rel[worst[-1]])


def opaque_step_grads(card, trainer, batch, label, runs):
    """Under `partly_opaque_density` (fitted in train mode), step 0's
    gradients of each of `runs`, a list of (plain, swap the backwards for
    their plain versions); the model's weights and buffers are restored
    afterwards."""
    import torch
    from vampire_tpu_torch.training.train_step import split_mats
    model = trainer.model
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    b = trainer.to_device(batch)
    mats = split_mats(b)
    model.train()
    head = model.backbone.density_conv
    with torch.no_grad():
        scale, bias, partial = partly_opaque_density(model, b['imgs'], mats,
                                                     b['points'])
        head.weight.mul_(scale)
        head.bias.fill_(bias)
    say(f'{label}: density head weight x{scale:.4g}, bias {bias:+.4f}, '
        f'under which {partial:.3f} of the rays end in (0.05, 0.95)')
    if partial < RAY_PARTIAL_MIN:
        raise AssertionError(f'{label}: only {partial:.3f} of the rays end '
                             f'partly opaque')
    grads = []
    for plain, swap in runs:
        with plain_backwards() if swap else contextlib.nullcontext():
            grads.append(step_grads(trainer, b, mats, plain))
    model.load_state_dict(saved)
    return grads


def train_grad_check(card, cfg, trainer, batch, dev,
                     rtol=TRAIN_GRAD_RTOL):
    """Step 0's gradients per trainable parameter tensor, under
    `partly_opaque_density`: (1) in fp32 compute (a second Trainer from the
    same seed), through the kernels against the same step with plain=True
    within `rtol`;
    (2) in `trainer`'s bf16 compute, through the backward kernels against
    their plain versions behind the same kernel forward. The kernel path
    runs twice in each, to show the run-to-run spread of its atomics."""
    from vampire_tpu_torch.training.trainer import Trainer
    cfg32 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, compute_dtype='float32'))
    with tempfile.TemporaryDirectory() as wd:
        tr32 = Trainer(cfg32, workdir=wd, device=dev)
        tr32.init_state(batch, 1)
        kern, again, plain = opaque_step_grads(
            card, tr32, batch, 'train fp32',
            [(False, False), (False, False), (True, False)])
        del tr32
    fp32 = compare_grads(card, 'train step 0 gradients, fp32, kernels vs '
                         'plain versions', kern, plain, again, rtol)
    del kern, again, plain
    kern, again, plain_bwd = opaque_step_grads(
        card, trainer, batch, 'train bf16',
        [(False, False), (False, False), (False, True)])
    bf16 = compare_grads(card, 'train step 0 gradients, bf16, backward '
                         'kernels vs their plain versions', kern, plain_bwd,
                         again, TRAIN_BWD_RTOL)
    return dict(fp32=fp32, bf16_backward=bf16)


def train_phase(card, cfg=None, dev='cuda', n_batches=N_TRAIN_BATCHES,
                n_timed=N_TIMED_STEPS, label='train',
                grad_rtol=TRAIN_GRAD_RTOL):
    """`Trainer.fit` over a list loader of n_batches training batches of
    `cfg` (the flagship's by default) for one epoch, after the step-0
    gradient check; then n_timed more steps are timed. Returns the launch
    counts of the fit and the measurements."""
    import numpy as np
    import torch
    from vampire_tpu_torch.configs import flagship_config, synthetic_batch
    from vampire_tpu_torch.training.train_step import (build_train_step,
                                                       init_train_confusion)
    from vampire_tpu_torch.training.trainer import Trainer

    cfg = cfg or flagship_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, max_epochs=1))
    t0 = time.perf_counter()
    loader = [synthetic_batch(cfg, batch_size=1,
                              n_points=cfg.train.max_points, seed=10 + i,
                              mode='train')
              for i in range(n_batches)]
    with tempfile.TemporaryDirectory() as wd:
        trainer = Trainer(cfg, workdir=wd, device=dev)
        state = trainer.init_state(loader[0], len(loader))
        model = trainer.model
        say(f'{label}: {cfg.train.compute_dtype} Trainer built, '
            f'{sum(p.numel() for p in state.trainable())} trainable '
            f'parameters, {n_batches} batches made, in '
            f'{time.perf_counter() - t0:.1f} s')
        grad = train_grad_check(card, cfg, trainer, loader[0], dev,
                                grad_rtol)
        stem = model.backbone.img_backbone.stem
        stem0 = {k: v.clone() for k, v in stem.state_dict().items()}
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        nonzero = set()
        hooks = [p.register_hook(lambda g, n=n: nonzero.add(n)
                                 if bool(g.any()) else None)
                 for n, p in model.named_parameters() if p.requires_grad]
        reset_counts()
        t1 = time.perf_counter()
        state = trainer.fit(loader, state=state, log_every=1)
        if dev == 'cuda':
            torch.cuda.synchronize()
        fit_s = time.perf_counter() - t1
        launched = counts()
        for h in hooks:
            h.remove()
        with open(os.path.join(trainer.workdir, 'scalars.jsonl')) as f:
            recs = [json.loads(ln) for ln in f]
        saved = trainer.saved_epochs()
    say(f'{label}: fit over {n_batches} steps in {fit_s:.2f} s (host '
        f'clock, incl. the epoch report and checkpoint); kernel launches '
        f'{launched}')
    want = {k: (n_batches if k in lift_keys(cfg) + ('rays', 'rays_bwd')
                else 0) for k in launched}
    if launched != want:
        raise AssertionError(f'{label}: kernel launches {launched}, want '
                             f'{want} for {n_batches} steps')
    steps = [r for r in recs if 'total_loss' in r]
    if len(steps) != n_batches or saved != [0]:
        raise AssertionError(f'{label}: {len(steps)} step logs, checkpoints '
                             f'{saved}')
    for r in steps:
        if not all(np.isfinite(v) for v in r.values()):
            raise AssertionError(f'{label}: non-finite log {r}')
        say(f'{label} step {r["step"]}: total_loss {r["total_loss"]:.4f}, '
            f'grad_norm {r["grad_norm"]:.4f}, '
            + ', '.join(f'{k} {v:.4f}' for k, v in sorted(r.items())
                        if k.endswith('_loss') and k != 'total_loss'))
    for k, v in stem.state_dict().items():
        if not torch.equal(v, stem0[k]):
            raise AssertionError(f'{label}: the frozen stem changed ({k})')
    still = [n for n, p in model.named_parameters()
             if p.requires_grad and torch.equal(p.detach(), before[n])]
    unmoved = [n for n in still if n in nonzero]
    say(f'{label}: {len(before) - len(still)} parameter tensors moved; '
        f'unchanged: the frozen stem and {still} (no nonzero gradient in '
        f'any step)' if not unmoved else f'{label}: {unmoved} did not move')
    if unmoved:
        raise AssertionError(f'{label}: {unmoved} had gradients but did not '
                             f'move')

    # more steps, timed: host clock around each step ending in a
    # synchronize, and the peak memory over them
    step = build_train_step(cfg, with_metrics=True)
    conf = init_train_confusion(cfg, trainer.device)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(n_timed):
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        state, logs, conf = step(state, trainer.to_device(
            loader[i % len(loader)]), conf)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - h0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = statistics.median(times)
    say(f'{label} step ({cfg.backbone.variant}, B=1, '
        f'{cfg.train.compute_dtype}): median {ms:.2f} ms over {n_timed} '
        f'steps '
        f'({", ".join(f"{t:.1f}" for t in times)}), peak memory '
        f'{peak:.3f} GB [{card}]')
    return dict(launched=launched, grad=grad, step_ms=ms, peak_gb=peak)


def eval_frame(cfg, seed, token):
    """A val-mode synthetic flagship frame (B=1) with what a real loader
    adds and the synthetic batches lack: the meta (sample and lidar
    tokens, a seeded ego pose) and the number of points before padding."""
    import numpy as np
    from vampire_tpu_torch.configs import synthetic_batch
    P = cfg.train.max_points
    b = synthetic_batch(cfg, batch_size=1, n_points=P, seed=seed, mode='val')
    rng = np.random.RandomState(seed)
    q = rng.randn(4)
    b['meta'] = dict(token=[token], lidar_token=[f'lidar_{token}'],
                     ego2global_rotation=[(q / np.linalg.norm(q)).tolist()],
                     ego2global_translation=[
                         rng.uniform(-500, 500, 3).tolist()])
    b['num_points'] = np.array([rng.randint(1, P + 1)])
    return b


def padded(frame):
    """`frame` as a final partial batch of 2: a second row, a copy of the
    first under the token 'pad', that sample_valid marks invalid."""
    import numpy as np
    out = {k: np.concatenate([v, v]) for k, v in frame.items()
           if k != 'meta'}
    out['sample_valid'] = np.array([True, False])
    out['meta'] = {k: v + (['pad'] if 'token' in k else v)
                   for k, v in frame['meta'].items()}
    return out


def valid_rows(batch):
    """The rows of a batch that sample_valid does not mark as padding."""
    import numpy as np
    return np.flatnonzero(batch.get('sample_valid',
                                    np.ones(len(batch['imgs']), bool)))


class EvalLoader(list):
    """Batches with a `dataset` whose `global_gt_boxes()` gives seeded
    global-frame GT boxes around each valid frame's ego position, the
    interface `Trainer.test` reads GT through."""

    def __init__(self, batches, classes, seed=0):
        import numpy as np
        super().__init__(batches)
        rng = np.random.RandomState(seed)
        self.gt = {}
        for b in batches:
            for i in valid_rows(b):
                tok = b['meta']['token'][i]
                ego = np.asarray(b['meta']['ego2global_translation'][i])
                boxes = []
                for _ in range(20):
                    et = np.r_[rng.uniform(-40, 40, 2), rng.uniform(-2, 1)]
                    yaw = rng.uniform(-np.pi, np.pi)
                    boxes.append(dict(
                        translation=(ego + et).tolist(),
                        ego_translation=et.tolist(),
                        size=rng.uniform(0.5, 5, 3).tolist(),
                        rotation=[np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)],
                        velocity=rng.uniform(-3, 3, 2).tolist(),
                        detection_name=classes[rng.randint(len(classes))],
                        attribute_name='', num_pts=int(rng.randint(1, 20))))
                self.gt[tok] = boxes
        self.dataset = self

    def global_gt_boxes(self):
        return self.gt


@contextlib.contextmanager
def recorded_confusions(into):
    """Append each (conf_seg, conf_occ) that the validation's metric step
    computes (`train_step.eval_confusions`) to `into`."""
    from vampire_tpu_torch.training import train_step
    original = train_step.eval_confusions

    def record(fo, batch, num_classes):
        out = original(fo, batch, num_classes)
        into.append(out)
        return out
    train_step.eval_confusions = record
    try:
        yield
    finally:
        train_step.eval_confusions = original


def numpy_confusions(fo, batch, K):
    """The validation confusions of one forward's logits on the host: the
    JAX package's semantics with np.add.at (base_exp.py:644-658)."""
    import numpy as np
    sv = np.asarray(batch['sample_valid'])
    pts = fo['pts_logits'].float().cpu().numpy()
    occ = fo['occ_logits'].float().cpu().numpy()
    labels = np.asarray(batch['point_labels'])
    valid = (np.asarray(batch['point_valid']) & (labels != 0)
             & sv[:, None])
    seg = np.zeros((K - 1, K - 1), np.float32)
    np.add.at(seg, (labels[valid], pts[..., 1:-1].argmax(-1)[valid] + 1), 1)
    mask = np.asarray(batch['mask_camera']) & sv[:, None, None, None]
    conf = np.zeros((K, K), np.float32)
    np.add.at(conf, (np.asarray(batch['occ_semantics'])[mask],
                     occ.argmax(-1)[mask]), 1)
    return seg, conf


def eval_phase(card, cfg=None, dev='cuda'):
    """The Trainer's evaluation paths at flagship width, bf16, B=1, through
    their entry points, with every launch count set to 0 just before each
    call and read just after: `validate` over N_VAL_FRAMES frames,
    `test` and `predict` over N_TEST_FRAMES frames with synthetic GT, and
    `test(vis=True)` over the same; each loader's last batch is padded to
    2 rows with sample_valid. Checks the confusions' totals, the device
    confusion function against numpy on one forward, the mIoU range, the
    files each call writes and the launches (the lift once a row on every
    call, the rays once a row on vis only, nothing else). Returns the
    launch counts, the ms a row and validate's peak memory."""
    import numpy as np
    import torch
    from vampire_tpu_torch.configs import flagship_config
    from vampire_tpu_torch.training.train_step import (build_eval_step,
                                                       eval_confusions,
                                                       split_mats)
    from vampire_tpu_torch.training.trainer import Trainer

    cfg = cfg or flagship_config()
    K = cfg.backbone.num_classes
    classes = [c for t in cfg.head.tasks for c in t]
    t0 = time.perf_counter()
    frames = [eval_frame(cfg, 30 + i, f'sample{i}')
              for i in range(N_VAL_FRAMES)]
    val = EvalLoader(frames[:-1] + [padded(frames[-1])], classes)
    tst = EvalLoader(frames[:N_TEST_FRAMES - 1]
                     + [padded(frames[N_TEST_FRAMES - 1])], classes)
    results = {}
    with tempfile.TemporaryDirectory() as wd:
        trainer = Trainer(cfg, workdir=wd, device=dev)
        state = trainer.init_state(None, 1)
        model = trainer.model
        d = trainer.to_device(frames[-1])
        calibrate_batchnorm_(model, (d['imgs'], split_mats(d), d['points']))
        # warm up each graph at both batch shapes (cuDNN and cuBLAS plans)
        with torch.no_grad():
            for b in (frames[0], val[-1]):
                d = trainer.to_device(b)
                for renders in (False, True):
                    model(d['imgs'], split_mats(d), points=d['points'],
                          camera_renders=renders)
        say(f'eval: {cfg.train.compute_dtype} Trainer built, BN calibrated '
            f'and warmed up in {time.perf_counter() - t0:.1f} s')

        def run(label, loader, fn):
            rows = sum(len(b['imgs']) for b in loader)
            if dev == 'cuda':
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            reset_counts()
            h0 = time.perf_counter()
            out = fn(loader)
            if dev == 'cuda':
                torch.cuda.synchronize()
            ms = (time.perf_counter() - h0) * 1e3
            launched = counts()
            peak = (torch.cuda.max_memory_allocated() / 1e9
                    if dev == 'cuda' else float('nan'))
            say(f'eval {label}: {ms:.2f} ms for {rows} rows ({rows - 1} '
                f'frames and a padding row), {ms / rows:.2f} ms a row, host '
                f'clock incl. the host work; peak memory {peak:.3f} GB; '
                f'kernel launches {launched} [{card}]')
            want = dict(lift=rows, rays=rows if label == 'vis' else 0)
            want = {k: want.get(k, 0) for k in launched}
            if launched != want:
                raise AssertionError(f'eval {label}: kernel launches '
                                     f'{launched}, want {want}')
            results[label] = dict(launched=launched, ms_per_row=ms / rows,
                                  ms=ms, rows=rows, peak_gb=peak)
            return out

        confs = []
        with recorded_confusions(confs):
            miou = run('validate', val,
                       lambda ld: trainer.validate(ld, state))
        for b, (seg, occ) in zip(val, confs):
            sv = np.isin(np.arange(len(b['imgs'])), valid_rows(b))
            pts = (b['point_valid'] & (b['point_labels'] != 0)
                   & sv[:, None]).sum()
            vox = (b['mask_camera'] & sv[:, None, None, None]).sum()
            got = (int(seg.sum().item()), int(occ.sum().item()))
            if got != (int(pts), int(vox)):
                raise AssertionError(f'validate: confusion totals {got}, '
                                     f'want {(int(pts), int(vox))}')
        if len(confs) != len(val) or not all(
                np.isnan(v) or 0.0 <= v <= 1.0 for v in miou.values()):
            raise AssertionError(f'validate: {len(confs)} batches, {miou}')
        say(f'eval validate: {miou}; confusion totals equal the valid '
            f'points and the masked voxels of every batch')
        # the device confusion function against numpy on one forward
        d = trainer.to_device(val[-1])
        fo = build_eval_step(model, cfg)(d)
        with torch.no_grad():
            dev_conf = [c.cpu().numpy() for c in eval_confusions(fo, d, K)]
        for what, g, w in zip(('seg', 'occ'), dev_conf,
                              numpy_confusions(fo, val[-1], K)):
            if not np.array_equal(g, w):
                raise AssertionError(f'eval_confusions {what}: device vs '
                                     f'numpy differ in {(g != w).sum()} '
                                     f'entries')
        model.train()
        say('eval: eval_confusions on the device equals np.add.at on the '
            'same forward (both matrices, every entry)')

        tokens = [b['meta']['token'][i] for b in tst for i in valid_rows(b)]
        run('test', tst, lambda ld: trainer.test(ld, state))
        sub = os.path.join(trainer.workdir, 'detection_submit')
        with open(os.path.join(sub, 'results_nusc.json')) as f:
            det = json.load(f)['results']
        with open(os.path.join(sub, 'metrics_summary.json')) as f:
            nds = json.load(f)['nd_score']
        if sorted(det) != sorted(tokens) or not 0.0 <= nds <= 1.0:
            raise AssertionError(f'test: tokens {sorted(det)}, want '
                                 f'{sorted(tokens)}; NDS {nds}')
        say(f'eval test: {sum(len(v) for v in det.values())} boxes over '
            f'{len(det)} tokens, in-repo NDS {nds:.4f}')

        run('predict', tst, lambda ld: trainer.predict(ld, state))
        seg_dir = os.path.join(trainer.workdir, 'lidarseg_submit',
                               'lidarseg', 'test')
        bins = sorted(os.listdir(seg_dir))
        want_bins = sorted(f'lidar_{t}_lidarseg.bin' for t in tokens)
        if bins != want_bins:
            raise AssertionError(f'predict: {bins}, want {want_bins}')
        for b in tst:
            for i in valid_rows(b):
                t = b['meta']['lidar_token'][i]
                lab = np.fromfile(os.path.join(seg_dir, f'{t}_lidarseg.bin'),
                                  np.uint8)
                if (len(lab) != b['num_points'][i]
                        or not ((lab >= 1) & (lab <= 16)).all()):
                    raise AssertionError(f'predict {t}: {len(lab)} labels '
                                         f'in {lab.min()}..{lab.max()}')
        say(f'eval predict: {len(bins)} lidarseg bins, num_points labels '
            f'in 1..16 each')

        run('vis', tst, lambda ld: trainer.test(ld, state, vis=True))
        pkls = sorted(os.listdir(os.path.join(trainer.workdir,
                                              'visualization')))
        if pkls != [f'{i}.pkl' for i in range(len(tokens))]:
            raise AssertionError(f'vis: {pkls}')
        say(f'eval vis: {len(pkls)} pickles')
    return results


class SeededImages(NuscDetSegDataset):
    """The loader's dataset with only its image read replaced: no JPEG is
    opened or decoded. Each camera image is a uint8 (fH, fW, 3) array
    seeded by its file name, as if already resized and cropped, and the
    raw image size is the dataset's (W, H) = (1600, 900). In a process
    worker it refuses to run once torch is imported: workers touch no
    CUDA."""

    def load_image(self, filename, resize_dims, crop, flip, rotate):
        import multiprocessing
        if (multiprocessing.parent_process() is not None
                and 'torch' in sys.modules):
            raise RuntimeError('a loader worker imported torch')
        fH, fW = self.ida_aug.final_dim
        rng = np.random.RandomState(zlib.crc32(filename.encode()))
        return ((self.ida_aug.W, self.ida_aug.H),
                rng.randint(0, 256, (fH, fW, 3), np.uint8))


class TimedLoader:
    """A loader whose iteration records, for each batch, when the consumer
    asked for it and when it got it (host clock)."""

    def __init__(self, loader):
        self.loader = loader
        self.dataset = loader.dataset
        self.asked, self.got = [], []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.asked.append(t0)
            self.got.append(time.perf_counter())
            yield batch


def fake_tree(root, cfg):
    """The port's fake nuScenes tree at real scale under `root`, its JPEG
    writes skipped (SeededImages never reads them; the random stream is
    the same): DATA_TRAIN + DATA_VAL samples of DATA_POINTS points,
    Occ3D labels on the config's occ grid, 1600x900 camera geometry.
    Returns the train and val info paths."""
    from vampire_tpu_torch.data import fake
    write = fake._write_jpeg
    fake._write_jpeg = lambda img, path: None
    try:
        info = fake.make_fake_nusc(root, n_samples=DATA_TRAIN + DATA_VAL,
                                   n_points=DATA_POINTS, seed=0,
                                   occ_shape=cfg.backbone.occ_grid)
    finally:
        fake._write_jpeg = write
    with open(info, 'rb') as f:
        infos = pickle.load(f)
    paths = []
    for split, part in (('train', infos[:DATA_TRAIN]),
                        ('val', infos[DATA_TRAIN:])):
        paths.append(os.path.join(root, f'infos_{split}_part.pkl'))
        with open(paths[-1], 'wb') as f:
            pickle.dump(part, f)
    return paths


def decode_getitem_ms(cfg, root):
    """Median ms of the dataset's own train-mode __getitem__, JPEG decode
    and PIL augmentation included, over a 2-sample fake tree with real
    1600x900 JPEGs ('smooth' images, realistic sizes) under `root`."""
    from vampire_tpu_torch.configs import DET_CLASSES
    from vampire_tpu_torch.data.fake import make_fake_nusc
    tree = os.path.join(root, 'jpeg')
    info = make_fake_nusc(tree, n_samples=2, n_points=DATA_POINTS, seed=1,
                          image_content='smooth',
                          occ_shape=cfg.backbone.occ_grid)
    bc = cfg.backbone
    ds = NuscDetSegDataset(
        ida_aug=cfg.ida_aug, bda_aug=cfg.bda_aug,
        classes=list(DET_CLASSES), data_root=tree,
        info_paths=info, head_cfg=cfg.head, mode='train',
        max_points=cfg.train.max_points, seed=0,
        seg_bounds=(bc.x_bound_seg, bc.y_bound_seg, bc.z_bound_seg))
    times = []
    for i in range(6):
        h0 = time.perf_counter()
        ds[i % 2]
        times.append((time.perf_counter() - h0) * 1e3)
    return statistics.median(times[1:])


def same_batches(a, b):
    """Two batch lists equal key for key, byte for byte, meta included."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if set(x) != set(y) or repr(x['meta']) != repr(y['meta']):
            return False
        for k in x:
            if k != 'meta' and (x[k].dtype != y[k].dtype
                                or not np.array_equal(x[k], y[k])):
                return False
    return True


def data_phase(card, synthetic_step_ms, cfg=None, dev='cuda'):
    """The input pipeline into the train and eval steps: a fake nuScenes
    tree at real scale read by the port's dataset and loader (the image
    read replaced by SeededImages), then `Trainer.fit` over the train
    loader (process workers) and `validate` and `test` over the val loader,
    with every launch count set to 0 just before each call and read just
    after. Checks the batches against synthetic_batch's keys, shapes and
    dtypes, process-worker batches against thread-worker ones byte for
    byte, finite losses, the launches per row, the confusion totals and a
    finite NDS. Returns the launches and the measurements."""
    import torch
    from vampire_tpu_torch.configs import (DET_CLASSES, flagship_config,
                                           synthetic_batch)
    from vampire_tpu_torch.data.nuscenes import DataLoader
    from vampire_tpu_torch.ops import _build
    from vampire_tpu_torch.training.train_step import split_mats
    from vampire_tpu_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    cfg = cfg or flagship_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, max_epochs=1))
    out = {}
    pil = subprocess.run([sys.executable, '-c', 'import PIL'],
                         capture_output=True).returncode == 0
    say(f'data: camera images come from SeededImages.load_image, a seeded '
        f'uint8 {cfg.ida_aug.final_dim} array a camera with the raw size '
        f'({cfg.ida_aug.W}, {cfg.ida_aug.H}); no JPEG is written, read or '
        f'decoded and no PIL resize, crop or flip runs; import PIL on this '
        f'machine: {"works" if pil else "fails"}')
    t0 = time.perf_counter()
    _build.load_host_library('host')
    say(f'data: host library (NMS, rasterizers) ready in '
        f'{time.perf_counter() - t0:.2f} s')
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        train_info, val_info = fake_tree(root, cfg)
        say(f'data: fake tree of {DATA_TRAIN} train and {DATA_VAL} val '
            f'samples ({DATA_POINTS} points a cloud, Occ3D '
            f'{cfg.backbone.occ_grid}) in {time.perf_counter() - t0:.2f} s')
        bc = cfg.backbone

        def dataset(infos, mode):
            return SeededImages(
                ida_aug=cfg.ida_aug, bda_aug=cfg.bda_aug,
                classes=list(DET_CLASSES), data_root=root,
                info_paths=infos, head_cfg=cfg.head,
                mode=mode, max_points=cfg.train.max_points, seed=0,
                seg_bounds=(bc.x_bound_seg, bc.y_bound_seg, bc.z_bound_seg))
        train_ds = dataset([train_info] * DATA_REPEAT, 'train')
        val_ds = dataset(val_info, 'val')

        # __getitem__ alone, one thread, each sample twice; the first call
        # is left out
        for label, ds in (('train', train_ds), ('val', val_ds)):
            times = []
            for i in list(range(len(ds))) * 2:
                h0 = time.perf_counter()
                ds[i]
                times.append((time.perf_counter() - h0) * 1e3)
            ms = statistics.median(times[1:])
            out[f'getitem_{label}_ms'] = ms
            say(f'data: __getitem__ {label} mode {ms:.2f} ms a sample '
                f'(median of {len(times) - 1}, one thread, host clock; '
                f'image decode and PIL augmentation excluded: SeededImages) '
                f'[{card}]')

        if pil:
            out['getitem_train_decode_ms'] = decode_getitem_ms(cfg, root)
            say(f'data: __getitem__ train mode with the JPEG decode and PIL '
                f'augmentation (NuscDetSegDataset.load_image, 1600x900 '
                f'"smooth" JPEGs of data/fake.py): '
                f'{out["getitem_train_decode_ms"]:.2f} ms a sample (median '
                f'of 5, one thread, host clock) [{card}]')

        # the loader's throughput, and its bytes by kind of worker
        ref = None
        rates = {}
        for procs in (False, True):
            for workers in (1, DATA_WORKERS):
                kind = 'processes' if procs else 'threads'
                loader = DataLoader(train_ds, batch_size=1, shuffle=True,
                                    num_workers=workers, prefetch=workers,
                                    seed=3, use_processes=procs)
                h0 = time.perf_counter()
                it = iter(loader)
                batches = [next(it)]
                first = time.perf_counter() - h0
                batches += list(it)
                sec = time.perf_counter() - h0
                n = len(batches)
                rates[f'{kind}_{workers}'] = n / sec
                rates[f'{kind}_{workers}_after_first'] = (n - 1) / (sec - first)
                say(f'data: loader, {workers} {kind}: {n / sec:.2f} samples/s '
                    f'over {n} (B=1, prefetch {workers}, host clock incl. the '
                    f'pool start; first batch after {first * 1e3:.1f} ms, '
                    f'then {(n - 1) / (sec - first):.2f} samples/s) [{card}]')
                if ref is None:
                    ref = batches
                elif not same_batches(batches, ref):
                    raise AssertionError(f'data: {workers} {kind} give other '
                                         f'batches than 1 thread')
        out['loader_samples_per_s'] = rates
        say('data: the batches of 1 and 4 threads and of 1 and 4 processes '
            'are equal byte for byte')
        synth = synthetic_batch(cfg, batch_size=1,
                                n_points=cfg.train.max_points, mode='train')
        got = ref[0]
        bad = [k for k in synth if k not in got or got[k].shape
               != synth[k].shape or got[k].dtype != synth[k].dtype]
        if bad:
            raise AssertionError(f'data: loader batch differs from '
                                 f'synthetic_batch in {bad}')
        out['batch_mb'] = sum(v.nbytes for k, v in got.items()
                              if k != 'meta') / 1e6
        say(f'data: a train batch has synthetic_batch\'s {len(synth)} keys '
            f'with their shapes and dtypes, and '
            f'{sorted(k for k in got if k not in synth)}; '
            f'{out["batch_mb"]:.3f} MB of arrays')

        trainer = Trainer(cfg, workdir=os.path.join(root, 'out'),
                          device=dev)
        state = trainer.init_state(None, len(train_ds))
        times = []
        for _ in range(3):
            if dev == 'cuda':
                torch.cuda.synchronize()
            h0 = time.perf_counter()
            trainer.to_device(got)
            if dev == 'cuda':
                torch.cuda.synchronize()
            times.append((time.perf_counter() - h0) * 1e3)
        out['h2d_ms'] = statistics.median(times)
        say(f'data: host->device of one train batch '
            f'({out["batch_mb"]:.3f} MB, pageable): {out["h2d_ms"]:.2f} ms '
            f'median of 3 [{card}]')
        del ref, batches, got

        # fit over the train loader, process workers
        loader = TimedLoader(DataLoader(
            train_ds, batch_size=1, shuffle=True, num_workers=DATA_WORKERS,
            seed=0, use_processes=True))
        if dev == 'cuda':
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        h0 = time.perf_counter()
        state = trainer.fit(loader, state=state, log_every=1)
        if dev == 'cuda':
            torch.cuda.synchronize()
        fit_s = time.perf_counter() - h0
        launched = counts()
        peak = (torch.cuda.max_memory_allocated() / 1e9 if dev == 'cuda'
                else float('nan'))
        n = len(loader)
        per_step = dict(lift=1, corner_table=0, rays=1, rays_stop=0,
                        lift_bwd=1, corner_table_bwd=0, rays_bwd=1,
                        lift_bilinear=0, lift_bilinear_bwd=0, slot_map=0)
        if launched != {k: v * n for k, v in per_step.items()}:
            raise AssertionError(f'data fit: kernel launches {launched} for '
                                 f'{n} steps, want {per_step} a step')
        with open(os.path.join(trainer.workdir, 'scalars.jsonl')) as f:
            recs = [json.loads(ln) for ln in f]
        steps = [r for r in recs if 'total_loss' in r]
        if len(steps) != n or not all(np.isfinite(v) for r in steps
                                      for v in r.values()):
            raise AssertionError(f'data fit: {len(steps)} step logs, want '
                                 f'{n}, all finite: {steps}')
        step_ms = [(a - g) * 1e3 for g, a in
                   zip(loader.got[:-1], loader.asked[1:])]
        wait_ms = [(g - a) * 1e3 for a, g in zip(loader.asked, loader.got)]
        out.update(fit_s=fit_s, fit_launches=launched, fit_peak_gb=peak,
                   step_ms=statistics.median(step_ms),
                   wait_ms=wait_ms, synthetic_step_ms=synthetic_step_ms)
        say(f'data fit: {n} steps over the loader ({DATA_WORKERS} process '
            f'workers) in {fit_s:.2f} s; step median {out["step_ms"]:.2f} '
            f'ms ({", ".join(f"{t:.1f}" for t in step_ms)}; host clock '
            f'between batches, incl. host->device and the loss read) '
            f'against {synthetic_step_ms:.2f} ms on synthetic batches (train '
            f'phase); waited on the loader {", ".join(f"{t:.1f}" for t in wait_ms)} '
            f'ms a batch (the first incl. the pool start); losses '
            + ', '.join(f'{r["total_loss"]:.4f}' for r in steps)
            + f'; peak memory {peak:.3f} GB; kernel launches {launched} '
            f'[{card}]')

        # validate and test over the val loader
        val_loader = DataLoader(val_ds, batch_size=1,
                                num_workers=DATA_WORKERS, use_processes=True,
                                drop_last=False)
        val_batches = list(val_loader)
        model = trainer.model
        d = trainer.to_device(val_batches[0])
        calibrate_batchnorm_(model, (d['imgs'], split_mats(d), d['points']))
        model.train()
        rows = sum(len(b['imgs']) for b in val_batches)
        confs = []
        for label in ('validate', 'test'):
            if dev == 'cuda':
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            val = TimedLoader(val_loader)
            reset_counts()
            h0 = time.perf_counter()
            with recorded_confusions(confs):
                if label == 'validate':
                    miou = trainer.validate(val, state)
                else:
                    trainer.test(val, state)
            if dev == 'cuda':
                torch.cuda.synchronize()
            ms = (time.perf_counter() - h0) * 1e3
            launched = counts()
            want = {k: (rows if k == 'lift' else 0) for k in launched}
            if launched != want:
                raise AssertionError(f'data {label}: kernel launches '
                                     f'{launched}, want {want}')
            out[f'{label}_ms_per_row'] = ms / rows
            out[f'{label}_launches'] = launched
            peak = (torch.cuda.max_memory_allocated() / 1e9
                    if dev == 'cuda' else float('nan'))
            if label == 'validate' and len(confs) != len(val_batches):
                raise AssertionError(f'data validate: {len(confs)} '
                                     f'confusion pairs')
            first = (val.got[0] - val.asked[0]) * 1e3
            out[f'{label}_first_batch_ms'] = first
            say(f'data {label}: {rows} rows in {ms:.2f} ms, {ms / rows:.2f} '
                f'ms a row (host clock incl. the loader and host work; the '
                f'first batch, with the pool start, after {first:.1f} ms); '
                f'peak memory {peak:.3f} GB; kernel launches {launched} '
                f'[{card}]')
        totals = [(int(seg.sum().item()), int(occ.sum().item()))
                  for seg, occ in confs]
        want = [(int((b['point_valid'] & (b['point_labels'] != 0)).sum()),
                 int(b['mask_camera'].sum())) for b in val_batches]
        if totals != want:
            raise AssertionError(f'data validate: confusion totals {totals}, '
                                 f'want the valid points and voxels {want}')
        out['miou'] = miou
        sub = os.path.join(trainer.workdir, 'detection_submit')
        with open(os.path.join(sub, 'metrics_summary.json')) as f:
            nds = json.load(f)['nd_score']
        with open(os.path.join(sub, 'results_nusc.json')) as f:
            tokens = sorted(json.load(f)['results'])
        want_tokens = sorted(t for b in val_batches for t in b['meta']['token'])
        if not np.isfinite(nds) or tokens != want_tokens:
            raise AssertionError(f'data test: NDS {nds}, tokens {tokens}, '
                                 f'want {want_tokens}')
        out['nds'] = nds
        say(f'data test: in-repo NDS {nds:.4f} against the val infos\' '
            f'global_gt_boxes(), {len(tokens)} tokens; validate {miou}, its '
            f'confusion totals equal the valid points and voxels {want}')
    out['wall_s'] = time.perf_counter() - t_phase
    say(f'data: phase wall time {out["wall_s"]:.1f} s [{card}]')
    return out


def validate_row(card, cfg, dev, label):
    """One `Trainer.validate` row of `cfg` (bf16, BN calibrated on the
    frame), with every launch count set to 0 just before: the lift once
    (the depth-less mode for bilinear), nothing else; the confusion totals
    equal the valid points and the masked voxels. Returns the launches and
    the row's ms (host clock)."""
    import torch
    from vampire_tpu_torch.training.train_step import split_mats
    from vampire_tpu_torch.training.trainer import Trainer

    classes = [c for t in cfg.head.tasks for c in t]
    frame = eval_frame(cfg, 40, f'{label}0')
    confs = []
    with tempfile.TemporaryDirectory() as wd:
        trainer = Trainer(cfg, workdir=wd, device=dev)
        state = trainer.init_state(None, 1)
        d = trainer.to_device(frame)
        calibrate_batchnorm_(trainer.model,
                             (d['imgs'], split_mats(d), d['points']))
        if dev == 'cuda':
            torch.cuda.synchronize()
        reset_counts()
        h0 = time.perf_counter()
        with recorded_confusions(confs):
            miou = trainer.validate(EvalLoader([frame], classes), state)
        if dev == 'cuda':
            torch.cuda.synchronize()
        ms = (time.perf_counter() - h0) * 1e3
        launched = counts()
    want = {k: int(k in lift_forward_keys(cfg)) for k in launched}
    if launched != want:
        raise AssertionError(f'{label} validate: kernel launches {launched}, '
                             f'want {want}')
    pts = int((frame['point_valid'] & (frame['point_labels'] != 0)).sum())
    vox = int(frame['mask_camera'].sum())
    got = [(int(seg.sum().item()), int(occ.sum().item()))
           for seg, occ in confs]
    if got != [(pts, vox)]:
        raise AssertionError(f'{label} validate: confusion totals {got}, '
                             f'want {[(pts, vox)]}')
    say(f'{label} validate: one row in {ms:.2f} ms (host clock incl. the '
        f'host work), confusion totals {got[0]} equal the valid points and '
        f'masked voxels; {miou}; kernel launches {launched} [{card}]')
    return dict(launched=launched, ms=ms)


def sweep_batches(cfg):
    """The first train-mode and the first val-mode loader batch (B=1) of
    the fake tree (`fake_tree`, SeededImages) with cfg's sweep_idxes."""
    from vampire_tpu_torch.configs import DET_CLASSES
    from vampire_tpu_torch.data.nuscenes import DataLoader
    bc = cfg.backbone
    out = []
    with tempfile.TemporaryDirectory() as root:
        infos = fake_tree(root, cfg)
        for info, mode in zip(infos, ('train', 'val')):
            ds = SeededImages(
                ida_aug=cfg.ida_aug, bda_aug=cfg.bda_aug,
                classes=list(DET_CLASSES), data_root=root, info_paths=info,
                head_cfg=cfg.head, mode=mode,
                sweep_idxes=cfg.train.sweep_idxes,
                max_points=cfg.train.max_points, seed=0,
                seg_bounds=(bc.x_bound_seg, bc.y_bound_seg, bc.z_bound_seg))
            loader = DataLoader(ds, batch_size=1, num_workers=1, seed=0,
                                drop_last=False)
            out.append(next(iter(loader)))
    return out


def sweep_phase(card, cfg=None, dev='cuda'):
    """flagship_config() with sweep_idxes=(0,): a key frame and one sweep
    frame, 12 views, from loader batches of the fake tree. Step 0's
    gradients against plain=True (fp32) and the backward kernels against
    their plain versions (bf16), as `train_grad_check`; one bf16 train step
    with its launches (the lift and the rays once each way), finite logs
    and peak memory; one metrics-graph request with its launches (the lift
    once), its outputs and request 0 against plain=True."""
    import numpy as np
    import torch
    from vampire_tpu_torch.configs import flagship_config
    from vampire_tpu_torch.serving import InferenceServer
    from vampire_tpu_torch.serving.server import INPUT_KEYS
    from vampire_tpu_torch.training.train_step import (build_train_step,
                                                       init_train_confusion)
    from vampire_tpu_torch.training.trainer import Trainer

    cfg = cfg or flagship_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, sweep_idxes=(0,), max_epochs=1))
    t0 = time.perf_counter()
    train_b, val_b = sweep_batches(cfg)
    shape = train_b['imgs'].shape
    if shape[:3] != (1, 2, 6) or val_b['imgs'].shape[:3] != (1, 2, 6):
        raise AssertionError(f'sweeps: loader imgs {shape}, '
                             f'{val_b["imgs"].shape}; want (1, 2, 6, ...)')
    say(f'sweeps: loader batches of imgs {shape} (key frame and sweep 0, '
        f'12 views) in {time.perf_counter() - t0:.1f} s')
    out = {}
    with tempfile.TemporaryDirectory() as wd:
        trainer = Trainer(cfg, workdir=wd, device=dev)
        state = trainer.init_state(train_b, 1)
        out['grad'] = train_grad_check(card, cfg, trainer, train_b, dev)
        step = build_train_step(cfg, with_metrics=True)
        conf = init_train_confusion(cfg, trainer.device)
        b = trainer.to_device(train_b)
        if dev == 'cuda':
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        h0 = time.perf_counter()
        state, logs, conf = step(state, b, conf)
        if dev == 'cuda':
            torch.cuda.synchronize()
        out['step_ms'] = (time.perf_counter() - h0) * 1e3
        out['step_launches'] = launched = counts()
        out['peak_gb'] = (torch.cuda.max_memory_allocated() / 1e9
                          if dev == 'cuda' else float('nan'))
        del trainer, state, step, b
    want = {k: int(k in ('lift', 'lift_bwd', 'rays', 'rays_bwd'))
            for k in launched}
    if launched != want or not all(np.isfinite(v.item())
                                   for v in logs.values()):
        raise AssertionError(f'sweeps step: launches {launched}, want '
                             f'{want}; logs {logs}')
    say(f'sweeps step (flagship, F=2, B=1, bf16): {out["step_ms"]:.2f} ms '
        f'(host clock, one step after the gradient check), total_loss '
        f'{logs["total_loss"].item():.4f}, peak memory '
        f'{out["peak_gb"]:.3f} GB; kernel launches {launched} [{card}]')
    if dev == 'cuda':
        torch.cuda.empty_cache()

    sample = {k: np.asarray(val_b[k])[0] for k in INPUT_KEYS}
    bc = cfg.backbone
    gx, gy, gz = bc.occ_grid
    metric = dict(occ_logits=(gx, gy, gz, bc.num_classes),
                  occ_density=(gx, gy, gz),
                  pts_logits=(cfg.train.max_points, bc.num_classes))
    server = InferenceServer(cfg, device=dev, dtype=torch.bfloat16,
                             outputs='metrics', seed=0)
    outs, launched, out['request_ms'] = serve_path(
        card, server, sample, [sample], 'sweeps metrics', warm=sample)
    want = {k: int(k == 'lift') for k in launched}
    if launched != want:
        raise AssertionError(f'sweeps request: launches {launched}, want '
                             f'{want}')
    out['request_launches'] = launched
    check_outputs('sweeps metrics', outs, metric, cfg)
    check_against_plain('sweeps metrics', server, sample, outs[0], metric)
    return out


def dense_phase(card, cfg=None, dev='cuda'):
    """flagship_config() with lift_block=0 (the dense lift: every block
    selected by every camera): one metrics-graph request through
    InferenceServer, its launches (the lift once), its outputs and request
    0 against plain=True; then the same inputs through the flagship's
    block-compacted model with the same weights and BN statistics, whose
    outputs must agree (the top-K covers every live block of this rig:
    `lift_dropped_blocks` must be 0)."""
    import numpy as np
    import torch
    from vampire_tpu_torch.configs import flagship_config, synthetic_batch
    from vampire_tpu_torch.models.vampire import Vampire
    from vampire_tpu_torch.serving import InferenceServer

    cfg = cfg or flagship_config()
    dense = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, lift_block=0))
    frames = []
    for i in (0, N_REQUESTS):
        b = synthetic_batch(cfg, batch_size=1,
                            n_points=cfg.train.max_points, seed=i,
                            mode='val')
        frames.append({k: np.asarray(b[k])[0] for k in
                       ('imgs', 'sensor2ego', 'intrin', 'ida', 'bda',
                        'points')})
    sample, calib = frames
    bc = cfg.backbone
    gx, gy, gz = bc.occ_grid
    metric = dict(occ_logits=(gx, gy, gz, bc.num_classes),
                  occ_density=(gx, gy, gz),
                  pts_logits=(cfg.train.max_points, bc.num_classes))
    server = InferenceServer(dense, device=dev, dtype=torch.bfloat16,
                             outputs='metrics', seed=0)
    if server.model.backbone.lift_compact:
        raise AssertionError('dense: lift_block=0 built the compacted lift')
    outs, launched, ms = serve_path(card, server, calib, [sample],
                                    'dense metrics')
    want = {k: int(k == 'lift') for k in launched}
    if launched != want:
        raise AssertionError(f'dense request: launches {launched}, want '
                             f'{want}')
    check_outputs('dense metrics', outs, metric, cfg)
    check_against_plain('dense metrics', server, sample, outs[0], metric)
    compact = Vampire(cfg.backbone, cfg.head, dtype=torch.bfloat16,
                      device=dev)
    compact.load_state_dict(server.model.state_dict())
    compact.eval()
    diag = {}
    with torch.inference_mode():
        imgs, mats, points = server.to_device(
            {k: v[None] for k, v in sample.items()})
        kw = dict(points=points, lidar_seg=True, camera_renders=False)
        fo_c, _ = compact(imgs, mats, diagnostics=diag, **kw)
        fo_d, _ = server.model(imgs, mats, **kw)
    dropped = int(diag['lift_dropped_blocks'])
    errs = {}
    for k in metric:
        ref = fo_c[k].float()
        errs[k] = (fo_d[k].float() - ref).abs().max().item()
        tol = KERNEL_RTOL * max(1.0, ref.abs().max().item())
        if dropped or not errs[k] <= tol:
            raise AssertionError(f'dense vs compacted lift {k}: max abs err '
                                 f'{errs[k]} (tol {tol}), {dropped} live '
                                 f'blocks dropped by the top-K')
    say(f'dense metrics request vs the flagship\'s block-compacted forward '
        f'on the same inputs and weights: max abs err {errs} (the top-K '
        f'dropped {dropped} live blocks) [{card}]')
    return dict(launched=launched, request_ms=ms, max_abs_err=errs,
                dropped=dropped)


def preset(name, cfg=None):
    """`ablation_config(name)`; with `cfg`, the same preset on cfg's widths
    (its backbone with the preset's variant, its train config with the
    preset's name and loss weights)."""
    from vampire_tpu_torch.configs import ablation_config
    want = ablation_config(name)
    if cfg is None:
        return want
    return dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone,
                                          variant=want.backbone.variant),
        train=dataclasses.replace(cfg.train, exp_name=want.train.exp_name,
                                  loss_weights=want.train.loss_weights))


def variants_phase(card, cfg=None, dev='cuda'):
    """The vampire2, lss and bilinear presets (`ablation_config`) at full
    width, bf16, B=1: N_REQUESTS requests on each graph (`slice_phase`,
    BN calibrated, request 0 against plain=True), the step-0 gradient
    check and `fit` over N_VARIANT_BATCHES steps plus N_VARIANT_TIMED timed
    ones (`train_phase`), and one validate row (`validate_row`); then the
    multi-sweep step and request (`sweep_phase`) and the dense-lift
    request (`dense_phase`), all at the flagship's widths (`cfg`'s, given
    one). Returns each one's launches and times."""
    out = {}
    for name in VARIANTS:
        t0 = time.perf_counter()
        vcfg = preset(name, cfg)
        out[name] = dict(
            serve=slice_phase(card, vcfg, dev, label=f'{name} '),
            train=train_phase(card, vcfg, dev, N_VARIANT_BATCHES,
                              N_VARIANT_TIMED, label=f'{name} train',
                              grad_rtol=VARIANT_GRAD_RTOL),
            validate=validate_row(card, vcfg, dev, name))
        out[name]['wall_s'] = time.perf_counter() - t0
        say(f'{name}: served, trained and validated in '
            f'{out[name]["wall_s"]:.1f} s [{card}]')
    out['sweeps'] = sweep_phase(card, cfg, dev)
    out['dense'] = dense_phase(card, cfg, dev)
    return out


@contextlib.contextmanager
def recording_earlyterm():
    """Record each call of the early-termination op (`render_rays_earlyterm`,
    looked up by the model at call time): its renders and diagnostic, the
    largest |value| of its field's seg and rgb channels, its arguments, its
    stops and each ray's optical depth at its stop."""
    from vampire_tpu_torch.core import rendering as R
    from vampire_tpu_torch.ops import rays
    rec = []
    op, stops, drops = (rays.render_rays_earlyterm, R.earlyterm_stops,
                        R.earlyterm_uncovered_drops)

    def op_rec(*args, **kw):
        rec.append({})
        out, diag = op(*args, **kw)
        field = args[0].detach()
        K = field.shape[-1] - 4
        rec[-1].update(out=out.detach(), diag=int(diag), args=args,
                       field_max=dict(
            seg=field[..., 1:K + 1].abs().max().item(),
            rgb=field[..., K + 1:].abs().max().item()))
        return out, diag

    def stops_rec(*args, **kw):
        res = stops(*args, **kw)
        rec[-1]['stop'] = res[0]
        return res

    def drops_rec(sd_stop, *args, **kw):
        rec[-1]['sd'] = sd_stop
        return drops(sd_stop, *args, **kw)
    try:
        rays.render_rays_earlyterm = op_rec
        R.earlyterm_stops = stops_rec
        R.earlyterm_uncovered_drops = drops_rec
        yield rec
    finally:
        rays.render_rays_earlyterm = op
        R.earlyterm_stops = stops
        R.earlyterm_uncovered_drops = drops


def earlyterm_serve(card, cfg, dev, dense_ms):
    """The full-render graph of `cfg` with ray_et_fracs = ET_FRACS, under a
    partly-opaque density head, through InferenceServer: N_REQUESTS
    requests (the lift once and the ray kernel's stop mode twice a
    request), and the diagnostic. Request 0's kernel forward is checked
    twice over. On its own inputs: the plain march at the forward's own
    stops gives every ray's render within RAY_RTOL, and the stops the plain
    key gives move at most ET_CROSSED_MAX of the rays (the two sum a ray's
    optical depth in different orders). Against the forward under
    plain=True: the rays both stop alike within the dense comparison's
    SLICE_RTOL, at most ET_CROSSED_MAX of the rays stop differently, and
    those are printed beside exp(-min(sd, tau)) x the value scale, sd the
    smaller optical depth at the ray's two stops (what the samples past the
    earlier stop can add; the field's largest |value| of the channels for
    seg and rgb, bg_depth for the depth)."""
    import math
    import torch
    from vampire_tpu_torch.serving import InferenceServer
    bc = dataclasses.replace(cfg.backbone, ray_et_fracs=ET_FRACS)
    cfg = dataclasses.replace(cfg, backbone=bc)
    samples, calib = request_frames(cfg)
    server = InferenceServer(cfg, device=dev, dtype=torch.bfloat16,
                             outputs=None, seed=0)
    model = server.model
    calibrate_batchnorm_(model, server.to_device(
        {k: v[None] for k, v in calib.items()}), True)
    imgs, mats, points = server.to_device({k: v[None]
                                           for k, v in samples[0].items()})
    head = model.backbone.density_conv
    with torch.no_grad():
        scale, bias, partial = partly_opaque_density(model, imgs, mats)
        head.weight.mul_(scale)
        head.bias.fill_(bias)
    say(f'extras early-term: density head weight x{scale:.4g}, bias '
        f'{bias:+.4f}, under which {partial:.3f} of the rays end in '
        f'(0.05, 0.95)')
    server.start()
    outs, lat = [], []
    try:
        server.warmup()
        reset_counts()
        for smp in samples:
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            outs.append(server.infer(smp))
            lat.append((time.perf_counter() - h0) * 1e3)
        launched = counts()
    finally:
        server.stop()
    ms = statistics.median(lat)
    check_launches('extras early-term', launched, {'lift': 1, 'rays_stop': 2})
    check_outputs('extras early-term', outs,
                  served_shapes(cfg, samples[0]['imgs'].shape[0])[1], cfg)
    with torch.inference_mode(), recording_earlyterm() as rec:
        model(imgs, mats, points=points)
        model(imgs, mats, points=points, plain=True)
    kern, plain = rec
    n_rays = kern['stop'].shape[0]
    limit = int(ET_CROSSED_MAX * n_rays)
    # the kernel forward on its own inputs: the plain march at its stops,
    # and the stops of the plain key
    from vampire_tpu_torch.core import rendering as R
    kargs = kern['args']
    march = kargs[:9]
    chunk, prefix, fracs = kargs[9:12]
    with torch.inference_mode():
        first = torch.full_like(kern['stop'], min(kargs[2].shape[1],
                                                  prefix * chunk))
        _, psd1 = R.sample_and_composite_rays_field_reference(
            *march, stop=first, with_sd=True)
        own_crossed = int((R.earlyterm_stops(psd1, kargs[2], chunk, prefix,
                                             fracs)[0] != kern['stop']).sum())
        want, wsd = R.sample_and_composite_rays_field_reference(
            *march, stop=kern['stop'], with_sd=True)
    for name, sl in ray_groups(bc.num_classes) + (('sd', None),):
        g, w = ((kern['sd'], wsd) if sl is None
                else (kern['out'][:, sl], want[:, sl]))
        e = (g - w).abs().max().item()
        tol = RAY_RTOL * max(1.0, w.abs().max().item())
        if not e <= tol:
            raise AssertionError(f'extras early-term {name}: the kernel '
                                 f'forward vs the plain march at its own '
                                 f'stops {e} > {tol}')
    say(f'extras early-term request 0, the kernel forward against the plain '
        f'march at its own stops: every ray within RAY_RTOL; the plain key '
        f'moves {own_crossed} of {n_rays} stops (at most {limit})')
    if own_crossed > limit:
        raise AssertionError(f'extras early-term: the plain key moves '
                             f'{own_crossed} of the forward\'s {n_rays} stops, '
                             f'more than {limit}')
    same = kern['stop'] == plain['stop']
    crossed = int((~same).sum())
    sd_min = torch.minimum(kern['sd'], plain['sd'])
    err = 0.0
    for name, sl in ray_groups(bc.num_classes):
        diff = (kern['out'][:, sl] - plain['out'][:, sl]).abs().amax(-1)
        tol = SLICE_RTOL * max(1.0, plain['out'][:, sl].abs().max().item())
        vscale = (bc.d_bound[1] if name == 'depth' else max(
            kern['field_max'][name], plain['field_max'][name]))
        e_same = diff[same].max().item()
        bound = tol + vscale * torch.exp(-sd_min.clamp(max=bc.ray_et_tau))
        over = int((diff > bound)[~same].sum())
        say(f'extras early-term request 0, kernels vs plain versions: '
            f'{name} max abs err {e_same:.3e} over the rays stopped alike '
            f'(tol {tol:.3e}), '
            + (f'{diff[~same].max().item():.3e} over the {crossed} others, '
               f'{over} of them past tol + exp(-min(sd, tau)) x scale '
               f'(their optical depth at the earlier stop '
               f'{sd_min[~same].min().item():.3f}..'
               f'{sd_min[~same].max().item():.3f}; exp(-tau) x scale '
               f'{math.exp(-bc.ray_et_tau) * vscale:.3e})'
               if crossed else 'no ray stopped differently'))
        if not e_same <= tol:
            raise AssertionError(f'extras early-term {name}: kernel vs plain '
                                 f'{e_same} > {tol} over the rays stopped '
                                 f'alike')
        err = max(err, e_same)
    if crossed > limit:
        raise AssertionError(f'extras early-term: {crossed} of {n_rays} rays '
                             f'stop differently under plain=True, more than '
                             f'{limit}')
    n_unsat = int((sd_min[~same] < bc.ray_et_tau).sum())
    say(f'extras early-term: {N_REQUESTS} requests, median {ms:.2f} ms (the '
        f'dense full-render graph {dense_ms:.2f} ms, host clock); uncovered '
        f'drops {kern["diag"]} (plain {plain["diag"]}); {crossed} rays '
        f'crossed a cap differently, {n_unsat} of them below tau; launches '
        f'{launched} [{card}]')
    return dict(launched=launched, request_ms=ms, dense_request_ms=dense_ms,
                diag=kern['diag'], plain_diag=plain['diag'], crossed=crossed,
                crossed_below_tau=n_unsat, own_crossed=own_crossed,
                max_abs_err=err)


def compact_fracs(bc):
    """ray_pass_fracs that drop in-field samples: every ray in the first
    COMPACT_KEEP passes, 0.3 of them (the longest) in the others."""
    from vampire_tpu_torch.core import geometry as G
    n_pass = -(-len(G.make_camera_mids(bc.d_bound)) // bc.ray_chunk)
    return (1.0,) * COMPACT_KEEP + (0.3,) * (n_pass - COMPACT_KEEP)


def compact_render_gap(card, trainer, batch):
    """Under `partly_opaque_density` (fitted in train mode), the train-mode
    renders of `trainer`'s compact sampler against the dense sampler's on
    the same weights: the largest depth difference, which must exceed the
    dense ray comparison's RAY_RTOL tolerance (the caps dropped in-field
    samples), and the in-field samples dropped. The weights and buffers
    are restored."""
    import torch
    from vampire_tpu_torch.core import geometry as G
    from vampire_tpu_torch.core import rendering as R
    from vampire_tpu_torch.models.field import ray_inputs
    from vampire_tpu_torch.training.train_step import split_mats
    model = trainer.model
    bb = model.backbone
    bc = bb.cfg
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    b = trainer.to_device(batch)
    mats = split_mats(b)
    model.train()
    try:
        with torch.no_grad():
            scale, bias, _ = partly_opaque_density(model, b['imgs'], mats,
                                                   b['points'])
            bb.density_conv.weight.mul_(scale)
            bb.density_conv.bias.fill_(bias)
            fo, _ = model(b['imgs'], mats, points=b['points'])
            bb.cfg = dataclasses.replace(bc, ray_pass_fracs=())
            fd, _ = model(b['imgs'], mats, points=b['points'])
    finally:
        bb.cfg = bc
        model.load_state_dict(saved)
    gap = (fo['depth_preds'] - fd['depth_preds']).abs().max().item()
    tol = RAY_RTOL * max(1.0, fd['depth_preds'].abs().max().item())
    geom = G.get_geometry(bb.frustum, mats['sensor2ego'], mats['intrin'],
                          mats['ida'], mats.get('bda'))
    valid = ray_inputs(geom, bc)[1][0]
    capped = R.compact_valid(valid, bc.ray_chunk, bc.ray_pass_fracs)
    dropped = int(((valid > 0) & (capped == 0)).sum())
    say(f'extras compact: the caps {bc.ray_pass_fracs} drop {dropped} of '
        f'{int((valid > 0).sum())} in-field samples; train-mode depth vs the '
        f'dense sampler max abs {gap:.4f} (the dense comparison\'s tol '
        f'{tol:.2e}) [{card}]')
    if not (dropped > 0 and gap > tol):
        raise AssertionError(f'extras compact: the caps dropped {dropped} '
                             f'samples and moved the depth by {gap}')
    return dict(dropped=dropped, depth_gap=gap)


def extras_train(card, cfg, dev):
    """The compact sampler (`compact_fracs`) and the rgb loss
    (loss_weights[2] = 1) at full width: step 0's gradients in fp32
    through the kernels against plain=True under `partly_opaque_density`
    (`compare_grads`), the renders against the dense sampler's
    (`compact_render_gap`); then `fit` in bf16 over N_EXTRA_BATCHES batches
    with image_every=1 (launches: a step's lift and rays each way, and the
    panels' eval forward; finite rgb_loss; 6 PNGs a step), one direct
    `log_images` call timed, N_EXTRA_TIMED steps timed, and one step under
    `utils.profiling.trace`, whose Chrome trace must be a non-empty file."""
    import torch
    from vampire_tpu_torch.configs import synthetic_batch
    from vampire_tpu_torch.training.train_step import (build_train_step,
                                                       init_train_confusion)
    from vampire_tpu_torch.training.trainer import Trainer
    from vampire_tpu_torch.utils.profiling import trace
    lw = list(cfg.train.loss_weights)
    lw[2] = 1.0
    cfg = dataclasses.replace(
        cfg, backbone=dataclasses.replace(
            cfg.backbone, ray_pass_fracs=compact_fracs(cfg.backbone)),
        train=dataclasses.replace(cfg.train, loss_weights=tuple(lw),
                                  max_epochs=1))
    loader = [synthetic_batch(cfg, batch_size=1,
                              n_points=cfg.train.max_points, seed=30 + i,
                              mode='train') for i in range(N_EXTRA_BATCHES)]
    cfg32 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, compute_dtype='float32'))
    with tempfile.TemporaryDirectory() as wd:
        tr32 = Trainer(cfg32, workdir=wd, device=dev)
        tr32.init_state(loader[0], 1)
        kern, again, plain = opaque_step_grads(
            card, tr32, loader[0], 'extras compact + rgb fp32',
            [(False, False), (False, False), (True, False)])
        grad = compare_grads(card, 'extras compact + rgb step 0 gradients, '
                             'fp32, kernels vs plain versions', kern, plain,
                             again, TRAIN_GRAD_RTOL)
        del kern, again, plain
        gap = compact_render_gap(card, tr32, loader[0])
        del tr32
    with tempfile.TemporaryDirectory() as wd:
        trainer = Trainer(cfg, workdir=wd, device=dev)
        state = trainer.init_state(loader[0], len(loader))
        reset_counts()
        t0 = time.perf_counter()
        state = trainer.fit(loader, state=state, log_every=1, image_every=1)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launched = counts()
        n = N_EXTRA_BATCHES
        want = {k: 0 for k in launched}
        want.update(lift=2 * n, rays=2 * n, lift_bwd=n, rays_bwd=n)
        if launched != want:
            raise AssertionError(f'extras fit: kernel launches {launched}, '
                                 f'want {want} for {n} steps with panels')
        with open(os.path.join(trainer.workdir, 'scalars.jsonl')) as f:
            steps = [r for r in map(json.loads, f) if 'total_loss' in r]
        rgb = [r['rgb_loss'] for r in steps]
        if len(rgb) != n or not all(np.isfinite(v) and v > 0 for v in rgb):
            raise AssertionError(f'extras fit: rgb_loss {rgb}')
        panel_dir = os.path.join(trainer.workdir, 'panels')
        names = sorted(os.listdir(panel_dir))
        want_names = sorted(f'{s:07d}_{p}.png' for s in range(1, n + 1)
                            for p in PANELS)
        if names != want_names or not all(
                os.path.getsize(os.path.join(panel_dir, f)) > 0
                for f in names):
            raise AssertionError(f'extras fit: panels {names}, want '
                                 f'{want_names}')
        dev_batch = trainer.to_device(loader[0])
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        trainer.log_images(state, dev_batch)
        torch.cuda.synchronize()
        panel_ms = (time.perf_counter() - h0) * 1e3
        step = build_train_step(cfg, with_metrics=True)
        conf = init_train_confusion(cfg, trainer.device)
        times = []
        for i in range(N_EXTRA_TIMED):
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            state, logs, conf = step(state, trainer.to_device(
                loader[i % n]), conf)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - h0) * 1e3)
        with trace(os.path.join(wd, 'trace')) as prof:
            state, logs, conf = step(state, dev_batch, conf)
            torch.cuda.synchronize()
        trace_bytes = os.path.getsize(prof.trace_path)
        if trace_bytes == 0:
            raise AssertionError('extras: the trace file is empty')
        with open(prof.trace_path) as f:
            events = json.load(f)['traceEvents']
        n_kernels = sum(e.get('cat') == 'kernel' for e in events)
    ms = statistics.median(times)
    say(f'extras fit (compact caps, rgb loss, panels every step): {n} '
        f'steps in {fit_s:.2f} s, rgb_loss '
        f'{", ".join(f"{v:.4f}" for v in rgb)}'
        f', launches {launched}; {len(names)} panels; log_images '
        f'{panel_ms:.1f} ms; step median {ms:.2f} ms '
        f'({", ".join(f"{t:.1f}" for t in times)}); trace of one step '
        f'{trace_bytes} bytes, {n_kernels} device kernel events [{card}]')
    return dict(grad=grad, compact=gap, fit_launches=launched, rgb_loss=rgb,
                step_ms=ms, log_images_ms=panel_ms, trace_bytes=trace_bytes,
                trace_kernel_events=n_kernels)


def torchvision_resnet50(seed):
    """The state dict torchvision's resnet50 saves (keys, OIHW shapes, BN
    statistics, num_batches_tracked, fc), with values from a seeded
    torch.Generator: He-scaled kernels, BN statistics near (0, 1), and
    each residual branch's last BN weight small (torchvision's
    zero_init_residual would make it 0), so that activations stay in
    range through the 16 blocks."""
    import torch
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[f'{name}.weight'] = (torch.randn(cout, cin, k, k, generator=g)
                                * (2.0 / (cin * k * k)) ** 0.5)

    def bn(name, c, last=False):
        w = torch.rand(c, generator=g)
        sd[f'{name}.weight'] = 0.1 + 0.2 * w if last else 0.8 + 0.4 * w
        sd[f'{name}.bias'] = 0.1 * torch.randn(c, generator=g)
        sd[f'{name}.running_mean'] = 0.1 * torch.randn(c, generator=g)
        sd[f'{name}.running_var'] = 0.5 + torch.rand(c, generator=g)
        sd[f'{name}.num_batches_tracked'] = torch.tensor(1000)

    conv('conv1', 64, 3, 7)
    bn('bn1', 64)
    cin = 64
    for i, nb in enumerate((3, 4, 6, 3)):
        planes = 64 * 2 ** i
        for j in range(nb):
            base = f'layer{i + 1}.{j}'
            for k, (co, ci, ks) in enumerate(
                    ((planes, cin, 1), (planes, planes, 3),
                     (planes * 4, planes, 1)), 1):
                conv(f'{base}.conv{k}', co, ci, ks)
                bn(f'{base}.bn{k}', co, last=k == 3)
            if j == 0:
                conv(f'{base}.downsample.0', planes * 4, cin, 1)
                bn(f'{base}.downsample.1', planes * 4)
            cin = planes * 4
    sd['fc.weight'] = 0.01 * torch.randn(1000, cin, generator=g)
    sd['fc.bias'] = torch.zeros(1000)
    return sd


def graft_serve(card, cfg, dev):
    """`Trainer.init_state` with train.pretrained_backbone naming a
    torchvision ResNet-50 .pth written here (`torchvision_resnet50`, no
    download): every image-backbone tensor must equal the file's bit for
    bit. Then an InferenceServer on the grafted weights (the other BN
    layers calibrated, the backbone's statistics the file's) serves one
    full-render request with `utils.profiling`'s tracer on: one lift and
    one ray launch, finite outputs of the served shapes, one span of each
    of the batch's phases."""
    import torch
    from vampire_tpu_torch.serving import InferenceServer
    from vampire_tpu_torch.training.trainer import Trainer
    from vampire_tpu_torch.utils import profiling
    from vampire_tpu_torch.utils.torch_weights import (
        convert_torchvision_resnet)
    sd = torchvision_resnet50(4)
    samples, calib = request_frames(cfg)
    with tempfile.TemporaryDirectory() as wd:
        path = os.path.join(wd, 'resnet50.pth')
        torch.save(sd, path)
        gcfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, pretrained_backbone=path))
        tr = Trainer(gcfg, workdir=wd, device=dev)
        tr.init_state(None, 1)
        own = {k: v for k, v in
               tr.model.backbone.img_backbone.state_dict().items()
               if not k.endswith('num_batches_tracked')}
        conv = convert_torchvision_resnet(sd, 50)
        bad = sorted(set(own) ^ set(conv)) + [
            k for k in own if k in conv and not torch.equal(own[k].cpu(),
                                                            conv[k])]
        if bad:
            raise AssertionError(f'extras graft: {len(bad)} backbone tensors '
                                 f'differ from the checkpoint: {bad[:5]}')
        state = {k: v.detach().clone() for k, v in
                 tr.model.state_dict().items()}
        del tr
    server = InferenceServer(gcfg, device=dev, state_dict=state,
                             dtype=torch.bfloat16, outputs=None)
    calibrate_batchnorm_(server.model, server.to_device(
        {k: v[None] for k, v in calib.items()}), True,
        keep=server.model.backbone.img_backbone)
    kept = server.model.backbone.img_backbone.state_dict()
    if not all(torch.equal(kept[k].cpu(), conv[k]) for k in conv):
        raise AssertionError('extras graft: calibration moved the grafted '
                             'backbone')
    server.start()
    try:
        reset_counts()
        torch.cuda.synchronize()
        profiling.enable()
        h0 = time.perf_counter()
        out = server.infer(samples[0])
        ms = (time.perf_counter() - h0) * 1e3
        profiling.disable()
        launched = counts()
    finally:
        profiling.disable()
        server.stop()
    spans = {s['name']: (s['end_ns'] - s['start_ns']) / 1e6
             for s in profiling.collect()['spans']}
    phases = ('server.queue', 'server.linger', 'server.batch',
              'server.assemble', 'server.h2d', 'server.forward',
              'server.decode', 'server.d2h', 'server.nms', 'server.deliver')
    missing = [p for p in phases if p not in spans]
    if missing:
        raise AssertionError(f'extras graft: the traced request gave no '
                             f'{missing} spans')
    say('extras graft: traced request, host ms: ' + ', '.join(
        f'{p[7:]} {spans[p]:.2f}' for p in phases))
    want = {k: 0 for k in launched}
    want.update(lift=1, rays=1)
    shapes = served_shapes(cfg, samples[0]['imgs'].shape[0])[1]
    bad = [k for k, shp in shapes.items()
           if out[k].shape != shp or not np.isfinite(out[k]).all()]
    if launched != want or bad:
        raise AssertionError(f'extras graft: launches {launched} (want '
                             f'{want}), bad outputs {bad}')
    say(f'extras graft: {len(conv)} torchvision ResNet-50 tensors grafted '
        f'bit for bit; one request {ms:.2f} ms (first on a new server), '
        f'{len(out["det"][0])} boxes after NMS [{card}]')
    return dict(launched=launched, request_ms=ms, tensors=len(conv))


def extras_phase(card, dense_ms, cfg=None, dev='cuda'):
    """What the JAX package does beyond the paths above, at full width
    (`cfg`, the flagship's by default), bf16, B=1: the early-termination
    sampler served (`earlyterm_serve`), the compact sampler and the rgb
    loss trained with the panels written (`extras_train`), and the
    torchvision graft served (`graft_serve`), with `utils.profiling`
    around a request and a step. Returns each part's launches and
    times."""
    from vampire_tpu_torch.configs import flagship_config
    cfg = cfg or flagship_config()
    t0 = time.perf_counter()
    out = dict(earlyterm=earlyterm_serve(card, cfg, dev, dense_ms),
               train=extras_train(card, cfg, dev),
               graft=graft_serve(card, cfg, dev))
    out['wall_s'] = time.perf_counter() - t0
    say(f'extras: early termination, compact training, the rgb loss, the '
        f'panels, the graft and the profiler in {out["wall_s"]:.1f} s '
        f'[{card}]')
    return out


def extras_launches(ex, kernel):
    """A kernel's launches in each run of the extras phase."""
    return dict(earlyterm=ex['earlyterm']['launched'][kernel],
                fit=ex['train']['fit_launches'][kernel],
                graft=ex['graft']['launched'][kernel])


def probe_phase(card):
    """The probe slice through its entry point, `tools/gather_probe.py`
    (`main`): the vmem, layouts and dma sub-commands and the PROBE_SCALE
    pairs of scale, with the four kernels' launch counts set to 0 just
    before and read just after. The tool holds every kernel to its plain
    version bit for bit and raises otherwise; its lines are printed here
    with the prefix. Checks the capacity probe's refusals and that every
    kernel launched. Returns (records by sub-command, launch counts)."""
    import io
    from vampire_tpu_torch.ops import gather_probe
    from vampire_tpu_torch.tools import gather_probe as tool

    one = [a for v, st in PROBE_SCALE for a in ('--one', v, st)]
    runs = [['vmem'], ['layouts'], ['dma'], ['scale'] + one]
    recs = {}
    t0 = time.perf_counter()
    for k in gather_probe.LAUNCHES:
        gather_probe.LAUNCHES[k] = 0
    for argv in runs:
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                recs[argv[0]] = tool.main(argv)
        finally:
            for ln in buf.getvalue().splitlines():
                say(f'probe {ln}')
    launched = dict(gather_probe.LAUNCHES)
    say(f'probe: {sum(len(r) for r in recs.values())} configurations in '
        f'{time.perf_counter() - t0:.1f} s; kernel launches {launched}')
    refused = {r['smem_bytes']: r['refused'] for r in recs['vmem']
               if r.get('what') == 'capacity'}
    want = {48 * 1024: False, gather_probe.SMEM_LIMIT: False,
            gather_probe.SMEM_LIMIT + 1: True}
    if any(refused.get(k) is not v for k, v in want.items()):
        raise AssertionError(f'capacity probe: refused {refused}, want '
                             f'{want}')
    idle = [k for k, n in launched.items() if n == 0]
    if idle:
        raise AssertionError(f'probe: {idle} never launched')
    return recs, launched


def probe_numbers(recs, name, sub, **match):
    """The measured numbers of the configuration of probe kernel `name`
    that `match` picks in sub-command `sub`, and where it ran."""
    r = next(r for r in recs[sub] if r.get('kernel') == name
             and all(r.get(k) == v for k, v in match.items()))
    out = {k: r[k] for k in ('max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                             'bound_by', 'library_ms', 'method_ops_ms',
                             'method_share')
           if k in r}
    out['at'] = ' '.join(f'{k}={r[k]}' for k in
                         ('probe', 'tpu_kernel', 'R', 'W', 'dtype', 'Q',
                          'stream', 'depth', 'unroll', 'blocks', 'ctas',
                          'loads_in_flight', 'tile_rows', 'chunk_bytes')
                         if k in r)
    return out


def probe_entry(recs, launched, name, sub, also=None, **match):
    """The kernels-line entry of a probe kernel: its launches in the probe
    phase and the numbers of the configuration that `match` picks; `also`
    (sub-command, match) adds a second configuration's numbers under
    `also_at`."""
    entry = dict(name=name, route='cuda',
                 source='vampire_tpu_torch/csrc/gather_probe.cu',
                 replaces=REPLACES[name], launches=launched[name],
                 **probe_numbers(recs, name, sub, **match))
    if also is not None:
        entry['also_at'] = probe_numbers(recs, name, also[0], **also[1])
    return entry


# the TPU kernels each probe kernel replaces (scripts/, file:line)
# the multi-device phase: fit steps a rank, distinct samples served and
# requests through the pool (the samples in turn), requests over TCP
N_DIST_STEPS = 3
N_POOL_SAMPLES = 8
N_POOL_REQUESTS = 24
N_TCP_REQUESTS = 8
# The distributed step against the single process on the same global batch,
# with a second single-process run, in a fresh process that joins no group,
# as the run-to-run spread. Step 0's loss terms are the forward's: they may
# differ by at most SPREAD_FACTOR times what the two single runs differ by.
# A world of one computes the same forward as one process (BatchNorm takes
# its own statistics; every collective is exact), so that is its whole
# allowance (0 measured on an H100). The gradients go through the backward
# kernels' fp32 atomics, whose order varies from run to run, and the bf16
# image backbone carries that to 2-3 % in its layer1 tensors. The clip
# scales every gradient by 35 / |g|, and |g| moves from run to run, so the
# clipped gradients' median difference is a draw of that norm's noise.
# `python -m vampire_tpu_torch.tools.grad_spread --runs 3` on an H100
# (700 W), 36 pairs of 9 runs (3 in one process, 3 in fresh processes, 3
# as world-1 NCCL ranks), step-0 loss bit-equal in all: the clipped median
# per-tensor |d|/|g| 1.3e-5 to 2.0e-3, whichever processes; unclipped (each
# run's gradients times its own |g| / 35) the median 4.7e-7 to 5.6e-7 and
# the max 2.5e-2 to 3.3e-2. So the gradients are compared unclipped, the
# distributed step's median and max each within SPREAD_FACTOR times the two
# single runs', its grad_norm within SPREAD_FACTOR times their max
# (|d|g|| / |g| is at most the largest per-tensor |d|/|g|). In a larger
# world the BN and loss sums run in another order, which bf16 would turn
# into gradient differences of tens of percent (TRAIN_BWD_RTOL's note):
# there the comparison runs in fp32, within TRAIN_GRAD_RTOL per tensor and
# 1e-5 of each loss term.
SPREAD_FACTOR = 2.0


def multi_phase(card, cfg=None, dev='cuda', world=None):
    """The multi-device paths: (1) `Trainer.fit` over N_DIST_STEPS global
    batches of B=1 a rank in a world of min(cards, 2) ranks spawned over
    NCCL (`parallel/distributed.spawn`, `parallel/_testing.trainer_run`), held
    to two single-process runs on the same batches, the second in a fresh
    process; (2) a ReplicaPool of
    two InferenceServers (full-render graph, cuda:0 and cuda:1, or both on
    cuda:0) against one of them alone, result for result; (3) the pool
    over TCP, byte for byte. Returns the launch counts, times and rates."""
    import gc
    import numpy as np
    import torch
    from vampire_tpu_torch.configs import flagship_config, synthetic_batch
    from vampire_tpu_torch.parallel.distributed import spawn
    from vampire_tpu_torch.parallel._testing import (in_fresh_process,
                                                      trainer_run, unclipped)
    from vampire_tpu_torch.serving import (InferenceServer, ReplicaPool,
                                           TcpClient, serve_tcp)

    cfg = cfg or flagship_config()
    cuda = dev == 'cuda'
    if world is None:
        world = min(torch.cuda.device_count(), 2)
    if cuda and not torch.distributed.is_nccl_available():
        raise AssertionError('multi: this torch build has no NCCL')
    dtype = cfg.train.compute_dtype if world == 1 else 'float32'
    say(f'multi: world {world} ({"NCCL" if cuda else "gloo"}), '
        f'{dtype} step, B=1 a rank, {N_DIST_STEPS} steps')

    # the same global batch, learning rate and detection floors
    def sized(bs, nd):
        return dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, max_epochs=1, compute_dtype=dtype,
            batch_size_per_device=bs, num_devices=nd))
    t0 = time.perf_counter()
    rows = [synthetic_batch(cfg, batch_size=1, n_points=cfg.train.max_points,
                            seed=40 + i, mode='train')
            for i in range(world * N_DIST_STEPS)]
    by_rank = [[rows[i * world + r] for i in range(N_DIST_STEPS)]
               for r in range(world)]
    glob = [{k: np.concatenate([rows[i * world + r][k]
                                for r in range(world)]) for k in rows[0]}
            for i in range(N_DIST_STEPS)]
    with tempfile.TemporaryDirectory() as wd:
        single = [trainer_run(sized(world, 1), [glob],
                              os.path.join(wd, 'single'), device=dev,
                              n_timed=N_TIMED_STEPS, num_devices=world),
                  in_fresh_process(trainer_run, (
                      sized(world, 1), [glob], os.path.join(wd, 'fresh'),
                      None, dev, None, 0, world), 300)]
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        # cam=1: the dp layout (the cam phase runs the camera split)
        ranks = spawn(trainer_run, world,
                      (sized(1, world), by_rank, os.path.join(wd, 'dist'),
                       None, None, None, N_TIMED_STEPS, None, 1),
                      device=dev, timeout_s=300)
        spawn_s = time.perf_counter() - t1
    r0 = ranks[0]
    say(f'multi: ranks {[r["rank"] for r in ranks]} of '
        f'{[r["world"] for r in ranks]}, backend {r0["backend"]}, spawned '
        f'and run in {spawn_s:.1f} s (two single-process runs before: '
        f'{t1 - t0:.1f} s)')
    if [r['world'] for r in ranks] != [world] * world or \
            r0['backend'] != ('nccl' if cuda else 'gloo'):
        raise AssertionError(f'multi: ranks ran in worlds '
                             f'{[r["world"] for r in ranks]} over '
                             f'{r0["backend"]}')

    # step 0 against the single process, within the run-to-run spread
    s1, s2 = single[0]['logs'][0], single[1]['logs'][0]
    for r in ranks:
        if r['logs'][0] != r0['logs'][0]:
            raise AssertionError(f'multi: rank {r["rank"]} logged '
                                 f'{r["logs"][0]}, rank 0 {r0["logs"][0]}')
    floor = 0.0 if world == 1 else 1e-5
    for k, ref in s1.items():
        err, spread = abs(r0['logs'][0][k] - ref), abs(s2[k] - ref)
        if k != 'grad_norm' and not err <= (SPREAD_FACTOR * spread
                                            + floor * abs(ref)):
            raise AssertionError(f'multi: step 0 {k} {r0["logs"][0][k]} vs '
                                 f'{ref} (run to run {spread})')
    clip = cfg.train.gradient_clip_val
    want, again, got = (unclipped(r['grads'], r['logs'][0]['grad_norm'], clip)
                        for r in (single[0], single[1], r0))
    if set(got) != set(want):
        raise AssertionError(f'multi: gradients of {set(got) ^ set(want)} '
                             f'on one side only')
    rel, spread = {}, {}
    for n, g in want.items():
        ref = float(np.linalg.norm(g))
        if ref == 0.0:
            if np.any(got[n]):
                raise AssertionError(f'multi: {n} has a gradient on one '
                                     f'side only')
            continue
        rel[n] = float(np.linalg.norm(got[n] - g)) / ref
        spread[n] = float(np.linalg.norm(again[n] - g)) / ref
    worst = max(rel, key=rel.get)
    grad = dict(median=statistics.median(rel.values()), max=rel[worst],
                spread_median=statistics.median(spread.values()),
                spread_max=max(spread.values()))
    norm_rel = abs(r0['logs'][0]['grad_norm'] - s1['grad_norm']) / abs(
        s1['grad_norm'])
    if world == 1:
        tol = dict(median=SPREAD_FACTOR * grad['spread_median'],
                   max=SPREAD_FACTOR * grad['spread_max'])
        norm_tol = SPREAD_FACTOR * grad['spread_max']
    else:
        tol = dict(median=TRAIN_GRAD_RTOL, max=TRAIN_GRAD_RTOL)
        norm_tol = TRAIN_GRAD_RTOL
    say(f'multi: step 0 total_loss {r0["logs"][0]["total_loss"]:.6f} vs '
        f'{s1["total_loss"]:.6f} (run to run '
        f'{abs(s2["total_loss"] - s1["total_loss"]):.3e}), grad_norm '
        f'{r0["logs"][0]["grad_norm"]:.4f} vs {s1["grad_norm"]:.4f} '
        f'(|d|/|g| {norm_rel:.3e}, run to run '
        f'{abs(s2["grad_norm"] - s1["grad_norm"]) / abs(s1["grad_norm"]):.3e};'
        f' tol {norm_tol:.3e})')
    say(f'multi: step 0 unclipped gradients, world {world} vs one process '
        f'({dtype}), |d|/|g| per tensor over {len(rel)} tensors: median '
        f'{grad["median"]:.3e} (tol {tol["median"]:.3e}), max '
        f'{rel[worst]:.3e} ({worst}; tol {tol["max"]:.3e}); one process in '
        f'a fresh process against it: median {grad["spread_median"]:.3e}, '
        f'max {grad["spread_max"]:.3e} [{card}]')
    for q in ('median', 'max'):
        if not grad[q] <= tol[q]:
            raise AssertionError(f'multi: step 0 gradients differ: {q} '
                                 f'{grad[q]} > {tol[q]}')
    if not norm_rel <= norm_tol:
        raise AssertionError(f'multi: step 0 grad_norm differs by '
                             f'{norm_rel} > {norm_tol}')
    lk = lift_keys(cfg)
    fit_want = {k: (N_DIST_STEPS if k in lk + ('rays', 'rays_bwd') else 0)
                for k in r0['launches']}
    for label, launched in (('distributed', r0['launches']),
                            ('single', single[0]['launches'])):
        say(f'multi: {label} fit kernel launches {launched}')
        if cuda and launched != fit_want:
            raise AssertionError(f'multi: {label} fit launched {launched}, '
                                 f'want {fit_want}')
    for r in [single[0]] + ranks:
        for rec in r['logs']:
            if not all(np.isfinite(v) for v in rec.values()):
                raise AssertionError(f'multi: non-finite log {rec}')
    times = ', '.join(f'{t:.1f}' for t in r0['step_times'])
    say(f'multi step ({dtype}, B=1 a rank): distributed median '
        f'{r0["step_ms"]:.2f} ms ({times}), single process '
        f'{single[0]["step_ms"]:.2f} ms, peak {r0["peak_gb"] or 0:.3f} / '
        f'{single[0]["peak_gb"] or 0:.3f} GB [{card}]')
    out = dict(world=world, backend=r0['backend'], dtype=dtype,
               fit_launches=r0['launches'], dist_step_ms=r0['step_ms'],
               single_step_ms=single[0]['step_ms'],
               dist_peak_gb=r0['peak_gb'],
               single_peak_gb=single[0]['peak_gb'],
               grad_rel_median=grad['median'], grad_rel_max=grad['max'],
               grad_spread_median=grad['spread_median'],
               grad_spread_max=grad['spread_max'], grad_norm_rel=norm_rel)
    del single, ranks, r0, rows, by_rank, glob, want, again, got
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the pool: two replicas against one, the full-render graph
    keys = ('imgs', 'sensor2ego', 'intrin', 'ida', 'bda', 'points')
    frames = [{k: np.asarray(b[k])[0] for k in keys} for b in (
        synthetic_batch(cfg, batch_size=1, n_points=cfg.train.max_points,
                        seed=60 + i, mode='val')
        for i in range(N_POOL_SAMPLES + 1))]
    samples, calib = frames[:-1], frames[-1]
    devs = ([f'cuda:{i % world}' for i in range(2)] if cuda
            else ['cpu', 'cpu'])
    bf16 = torch.bfloat16
    a = InferenceServer(cfg, devs[0], dtype=bf16, outputs=None, seed=0)
    calibrate_batchnorm_(a.model, a.to_device({k: v[None]
                                               for k, v in calib.items()}),
                         a.camera_renders)
    b = InferenceServer(cfg, devs[1], state_dict=a.model.state_dict(),
                        dtype=bf16, outputs=None)
    a.start().warmup()
    b.start().warmup()
    srv = cl = None
    try:
        order = [i % N_POOL_SAMPLES for i in range(N_POOL_REQUESTS)]

        def back_to_back(target):
            if cuda:
                torch.cuda.synchronize()
            h0 = time.perf_counter()
            futs = [target.submit(samples[i]) for i in order]
            res = [f.result(timeout=300) for f in futs]
            return res, N_POOL_REQUESTS / (time.perf_counter() - h0)
        alone, fps1 = back_to_back(a)
        want = alone[:N_POOL_SAMPLES]
        pool = ReplicaPool([a, b])
        before = a.stats['requests'], b.stats['requests']
        reset_counts()
        outs, fps2 = back_to_back(pool)
        launched = counts()
        served = (a.stats['requests'] - before[0],
                  b.stats['requests'] - before[1])
        bc = cfg.backbone
        gx, gy, gz = bc.occ_grid
        _, Yd, Xd = bc.grid_zyx('det')
        N, (H, W) = samples[0]['imgs'].shape[0], bc.final_dim
        check_outputs('multi pool', want, dict(
            occ_logits=(gx, gy, gz, bc.num_classes),
            occ_density=(gx, gy, gz),
            pts_logits=(cfg.train.max_points, bc.num_classes),
            depth_preds=(N, H, W), seg_preds=(N, H, W), bev_seg=(Yd, Xd)),
            cfg)
        for j, o in enumerate(outs):
            ref = want[order[j]]
            if pickle.dumps(o) != pickle.dumps(ref):
                diff = {k: float(np.abs(o[k].astype(np.float64)
                                        - ref[k]).max())
                        for k in ref if k != 'det'}
                raise AssertionError(f'multi pool request {j}: not the '
                                     f'single server\'s result ({diff})')
        pool_want = {k: (N_POOL_REQUESTS if k in lift_forward_keys(cfg)
                         + ('rays',) else 0)
                     for k in launched}
        say(f'multi pool: {N_POOL_REQUESTS} requests over {devs}, served '
            f'{served}, each equal to the single server\'s; kernel '
            f'launches {launched}; {fps1:.2f} frames/s with 1 replica, '
            f'{fps2:.2f} with 2, back to back [{card}]')
        if cuda and launched != pool_want:
            raise AssertionError(f'multi pool: launched {launched}, want '
                                 f'{pool_want}')
        if min(served) == 0 or sum(served) != N_POOL_REQUESTS:
            raise AssertionError(f'multi pool: replicas served {served}')

        # TCP: the same samples through the pool, byte for byte
        srv = serve_tcp(pool)
        cl = TcpClient(*srv.server_address)
        direct, tcp = [], []
        for j in range(N_TCP_REQUESTS):
            s = samples[j % N_POOL_SAMPLES]
            h0 = time.perf_counter()
            pool.infer(s)
            h1 = time.perf_counter()
            o = cl.infer(s)
            h2 = time.perf_counter()
            direct.append((h1 - h0) * 1e3)
            tcp.append((h2 - h1) * 1e3)
            if pickle.dumps(o) != pickle.dumps(want[j % N_POOL_SAMPLES]):
                raise AssertionError(f'multi tcp request {j}: not byte for '
                                     f'byte the result of infer')
        overhead = statistics.median(tcp) - statistics.median(direct)
        say(f'multi tcp: {N_TCP_REQUESTS} requests byte for byte equal to '
            f'infer; median {statistics.median(tcp):.2f} ms over TCP, '
            f'{statistics.median(direct):.2f} direct: {overhead:.2f} ms a '
            f'request (host clock) [{card}]')
    finally:
        if cl is not None:
            cl.close()
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        a.stop()
        b.stop()
    out.update(pool_launches=launched, pool_devices=devs,
               fps_1_replica=fps1, fps_2_replicas=fps2,
               tcp_ms=statistics.median(tcp),
               direct_ms=statistics.median(direct),
               tcp_overhead_ms=overhead, wall_s=time.perf_counter() - t0)
    del a, b, pool
    if cuda:
        torch.cuda.empty_cache()
    return out


# The camera axis (phase 10). The lift's numerator sums the cameras in
# order in fp32 (`acc += v` a camera, csrc/lift.cu); two partial sums met in
# one more add change the rounding: each order is within (n - 1) u sum|v|
# of the exact sum (n = 6 cameras, u = 2^-24), so two orders differ by at
# most 2 (n - 1) u sum|v|, sum|v| the lift of |feat| (the depth and the
# bilinear weights are >= 0).
CAM_SPLIT_ULPS = 10
N_CAM_STEPS = 3
# The dp 1 x cam 2 step against one process in fp32: the loss terms within
# 1e-5 (multi's floor). The flagship's fp32 step-0 gradients are chaotic in
# the forward's sum order: any layout moves them. On an H100 (700 W;
# `python vampire_tpu_torch/tools/layout_spread.py`) one process against
# itself in a fresh process moved the unclipped per-tensor |d| / |g| by a
# median 4.0e-7, but dp 2 x cam 1 (two ranks, a row each:
# only the BatchNorm and loss sums run in another order) by a median
# 2.6e-2 and at most 7.4e-2, and dp 1 x cam 2 by 2.5e-2 and 6.6e-2 (the
# image backbone's tensors most, ~5e-2; the head's 3e-4). So the phase
# runs the dp layout beside the cam layout as its control, a layout the
# CPU tests hold to one process (tests/test_torch_parallel.py), and holds
# the cam layout's median, largest and grad_norm within SPREAD_FACTOR times
# the control's; the control itself within CAM_CONTROL_MAX, so that a
# broken control fails.
CAM_LOSS_RTOL = 1e-5
CAM_CONTROL_MAX = 0.25


def dense_lift_frame(bc, dev):
    """One flagship frame's dense lift inputs (every block selected by
    every camera, `lift_layout(dense=True)`): depth (6, D, h, w), feat
    (6, h, w, C) fp32 from a seed, ids (6, G), coords (6, G, Q, 3), valid
    (6, G, Q) of the camera_rig geometry. Returns those and G."""
    import torch
    from vampire_tpu_torch.configs import camera_rig
    from vampire_tpu_torch.core.geometry import get_pixel
    from vampire_tpu_torch.models.field import (block_major_voxels,
                                                coords_valid, lift_layout)

    D, (h, w), C = bc.depth_channels, bc.feat_hw, bc.mid_channels
    rig = {k: torch.from_numpy(v).to(dev)
           for k, v in camera_rig(1, 6, bc.final_dim, seed=0).items()}
    blk = lift_layout(bc, dense=True)[0]
    vox = torch.from_numpy(block_major_voxels(bc, blk)).to(dev)
    pix = get_pixel(vox[:, :, None], rig['sensor2ego'], rig['intrin'],
                    rig['ida'], rig['bda'])[..., 0, :]
    coords, valid = coords_valid(pix, bc)
    G = valid.shape[2]
    g = torch.Generator(device=dev).manual_seed(5)
    depth = torch.softmax(torch.randn(6, D, h, w, device=dev, generator=g),
                          dim=1)
    feat = torch.randn(6, h, w, C, device=dev, generator=g)
    ids = torch.arange(G, device=dev, dtype=torch.int64).expand(6, G)
    return (depth, feat, ids.contiguous(), coords[0].contiguous(),
            valid[0].contiguous()), G


def cam_kernel_check(card, bc, dev):
    """(a) The kernels over a frame's camera halves, in fp32 and bf16: the
    dense lift over cameras 0-2 plus the lift over 3-5 against the lift over
    0-5 (denominators equal, numerators within CAM_SPLIT_ULPS u of the
    lift of |feat|), each half against its plain version, and the time of
    the lift over 3 cameras against 6; the ray kernel over cameras 3-5
    against rows 3-5 of the six-camera march, bit for bit, and against its
    plain version."""
    import torch
    from vampire_tpu_torch.core import rendering as R
    from vampire_tpu_torch.ops import lift, rays

    dev = torch.device(dev)
    (depth, feat, ids, coords, valid), G = dense_lift_frame(bc, dev)
    u = 2.0 ** -24
    out = dict(max_abs_err=0.0)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace('torch.', '')
        dep, fea = depth.to(dt), feat.to(dt)

        def half(c, f=fea):
            return lift.lift_frame_accumulate(
                dep[c].contiguous(), f[c].contiguous(), ids[c].contiguous(),
                coords[c].contiguous(), valid[c].contiguous(), G)
        lo, hi = slice(0, 3), slice(3, 6)
        whole, a, b = half(slice(0, 6)), half(lo), half(hi)
        mag = half(slice(0, 6), fea.abs())[0]
        err = (a[0] + b[0] - whole[0]).abs()
        bound = CAM_SPLIT_ULPS * u * mag
        moved = int((err > 0).sum())
        dmis = int((a[1] + b[1] != whole[1]).sum())
        say(f'cam lift {name}: cameras 0-2 + 3-5 against 0-5 (dense, '
            f'G={G}): denominators differ in {dmis}, numerators in {moved} '
            f'of {err.numel()} elements, max err {err.max().item():.3e}, '
            f'max err / (u sum|v|) '
            f'{(err / (u * mag).clamp_min(1e-30)).max().item():.2f} '
            f'(bound {CAM_SPLIT_ULPS})')
        if dmis or not bool((err <= bound).all()):
            raise AssertionError(f'cam lift {name}: the camera halves do not '
                                 f'sum to the frame')
        for label, part, c in (('0-2', a, lo), ('3-5', b, hi)):
            want = lift.lift_frame_accumulate_reference(
                dep[c], fea[c], ids[c], coords[c], valid[c], G)
            e = (part[0] - want[0]).abs().max().item()
            tol = KERNEL_RTOL * max(1.0, want[0].abs().max().item())
            if not e <= tol or int((part[1] != want[1]).sum()) > \
                    1e-6 * want[1].numel():
                raise AssertionError(f'cam lift {name} cameras {label}: '
                                     f'kernel vs plain {e} > {tol}')
            out['max_abs_err'] = max(out['max_abs_err'], e)
            del want
        ms3 = cuda_ms(lambda: half(lo), 20)
        ms6 = cuda_ms(lambda: half(slice(0, 6)), 20)
        say(f'cam lift {name}: dense lift of 3 cameras {ms3:.4f} ms, of 6 '
            f'{ms6:.4f} ms a frame ({ms3 / ms6:.3f}) [{card}]')
        out[name] = dict(ms_3=ms3, ms_6=ms6, moved=moved, max_err=float(
            err.max()))
        del whole, a, b, mag, err, bound
    del depth, feat, coords, valid

    args = ray_field(bc, dev)
    per = args[1].shape[0] // 6
    fp32 = rays.channels_last_field(args[0].permute(3, 0, 1, 2).float())
    for name, field in (('bfloat16', args[0]), ('float32', fp32)):
        full = rays.sample_and_composite_rays(field, *args[1:])
        rest = tuple(t[3 * per:].contiguous() for t in args[1:4])
        part = rays.sample_and_composite_rays(field, *rest, *args[4:])
        torch.cuda.synchronize()
        same = torch.equal(part, full[3 * per:])
        want = R.sample_and_composite_rays_field_reference(field, *rest,
                                                           *args[4:])
        e = (part - want).abs().max().item()
        tol = RAY_RTOL * max(1.0, want.abs().max().item())
        say(f'cam rays {name}: cameras 3-5 ({part.shape[0]} rays) '
            f'{"bit for bit" if same else "NOT"} rows 3-5 of the 6-camera '
            f'march; against the plain version max abs err {e:.3e} (tol '
            f'{tol:.1e})')
        if not same or not e <= tol:
            raise AssertionError(f'cam rays {name}: a camera subset is not '
                                 f'its rows of the frame ({same}, {e})')
        out['max_abs_err'] = max(out['max_abs_err'], e)
    return out


def cam_calibrate(batch, model):
    """A `trainer_run` init hook: the BN statistics calibrated on the
    global rows `batch` (`calibrate_batchnorm_`), each rank on its cameras
    of them (`mesh.shard_batch` under the model's layout)."""
    import numpy as np
    import torch
    from vampire_tpu_torch.parallel.mesh import shard_batch
    from vampire_tpu_torch.training.train_step import split_mats
    dev = next(model.parameters()).device
    b = {k: torch.as_tensor(np.ascontiguousarray(v)).to(dev)
         for k, v in shard_batch(batch, model.layout).items()}
    calibrate_batchnorm_(model, (b['imgs'], split_mats(b), b['points']))


def cam_phase(card, cfg=None, dev='cuda'):
    """The camera axis: (a) `cam_kernel_check`; (b) `Trainer.fit` at dp 1
    x cam 2 (flagship, fp32, B=1 a rank: 2 rows a global batch,
    N_CAM_STEPS steps, then N_TIMED_STEPS timed), over NCCL on two cards
    or as two ranks on cuda:0 over gloo, asked for by name, against one
    process (the dense lift) on the same global batches: step 0's loss
    terms and unclipped gradients, within SPREAD_FACTOR of a dp 2 x cam 1
    step's (one step, the control), the fit's launches; the step time and
    the peak memory of each rank; (c) `validate` on the 2 rows of one
    global batch at the same layout against the one process, on the
    initial weights with BN calibrated on another global batch."""
    import functools
    import gc
    import numpy as np
    import torch
    from vampire_tpu_torch.configs import flagship_config, synthetic_batch
    from vampire_tpu_torch.parallel.distributed import spawn
    from vampire_tpu_torch.parallel._testing import trainer_run, unclipped

    cfg = cfg or flagship_config()
    cuda = dev == 'cuda'
    t0 = time.perf_counter()
    kern = cam_kernel_check(card, cfg.backbone, dev) if cuda else None
    if cuda:
        torch.cuda.empty_cache()
    world, cam = 2, 2
    backend = ('nccl' if torch.cuda.device_count() >= 2 else 'gloo') \
        if cuda else 'gloo'
    say(f'cam: Trainer.fit at dp 1 x cam 2 over {backend}'
        f'{" (two ranks on cuda:0, asked for by name)" if cuda and backend == "gloo" else ""}'
        f', float32, B=1 a rank ({world} rows a global batch), '
        f'{N_CAM_STEPS} steps + {N_TIMED_STEPS} timed')

    def sized(bs, nd):
        return dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, max_epochs=1, compute_dtype='float32',
            batch_size_per_device=bs, num_devices=nd))
    P = cfg.train.max_points

    def rows(seed, mode):       # one global batch, `world` rows
        bs = [synthetic_batch(cfg, batch_size=1, n_points=P, seed=seed + i,
                              mode=mode) for i in range(world)]
        return {k: np.concatenate([b[k] for b in bs]) for k in bs[0]}
    glob = [rows(70 + world * i, 'train') for i in range(N_CAM_STEPS)]
    val = [rows(90, 'val')]
    hook = functools.partial(cam_calibrate, rows(95, 'val'))
    with tempfile.TemporaryDirectory() as wd:
        single = trainer_run(sized(world, 1), [glob],
                             os.path.join(wd, 'single'), device=dev,
                             init_hook=hook, n_timed=N_TIMED_STEPS,
                             num_devices=world, lift_vectorized=True,
                             eval_first=True, val_batches=[val])
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ranks = spawn(trainer_run, world,
                      (sized(1, world), [glob] * world,
                       os.path.join(wd, 'cam'), None, None, hook,
                       N_TIMED_STEPS, None, cam, None, None, True,
                       [val] * world),
                      device=dev, timeout_s=300,
                      backend='gloo' if backend == 'gloo' else None)
        spawn_s = time.perf_counter() - t1
        # the control: dp 2 x cam 1, a row a rank, step 0 only
        control = spawn(trainer_run, world,
                        (sized(1, world), [[{k: v[r:r + 1] for k, v in
                                             glob[0].items()}]
                                           for r in range(world)],
                         os.path.join(wd, 'dp'), None, None, hook, 0, None,
                         1, True),
                        device=dev, timeout_s=300,
                        backend='gloo' if backend == 'gloo' else None)[0]
    r0 = ranks[0]
    got = [(r['rank'], r['dp_index'], r['cam_index'], r['backend'])
           for r in ranks]
    say(f'cam: ranks (rank, dp, cam, backend) {got}, spawned and run in '
        f'{spawn_s:.1f} s')
    if got != [(r, 0, r, backend) for r in range(world)]:
        raise AssertionError(f'cam: ranks {got}')

    # (b) step 0 against the one process
    s = single['logs'][0]
    for r in ranks[1:]:
        if r['logs'][0] != r0['logs'][0]:
            raise AssertionError(f'cam: rank {r["rank"]} logged '
                                 f'{r["logs"][0]}, rank 0 {r0["logs"][0]}')
    for k, ref in s.items():
        if k == 'grad_norm':
            continue
        if not abs(r0['logs'][0][k] - ref) <= CAM_LOSS_RTOL * abs(ref) + 1e-7:
            raise AssertionError(f'cam: step 0 {k} {r0["logs"][0][k]} vs '
                                 f'{ref}')
    clip = cfg.train.gradient_clip_val
    want = unclipped(single['grads'], s['grad_norm'], clip)

    def against_single(run):
        """(median, largest, its tensor, grad_norm) of |d|/|g|."""
        got = unclipped(run['grads'], run['logs'][0]['grad_norm'], clip)
        rel = {}
        for n, g in want.items():
            ref = float(np.linalg.norm(g))
            if ref == 0.0:
                if np.any(got[n]):
                    raise AssertionError(f'cam: {n} has a gradient on one '
                                         f'side')
                continue
            rel[n] = float(np.linalg.norm(got[n] - g)) / ref
        worst = max(rel, key=rel.get)
        return (statistics.median(rel.values()), rel[worst], worst,
                abs(run['logs'][0]['grad_norm'] - s['grad_norm'])
                / s['grad_norm'])
    med, big, worst, norm_rel = against_single(r0)
    cmed, cbig, cworst, cnorm = against_single(control)
    tol = dict(median=SPREAD_FACTOR * cmed, max=SPREAD_FACTOR * cbig,
               norm=SPREAD_FACTOR * max(cnorm, cbig))
    say(f'cam: step 0 total_loss {r0["logs"][0]["total_loss"]:.6f} vs '
        f'{s["total_loss"]:.6f} (dp 2 x cam 1: '
        f'{control["logs"][0]["total_loss"]:.6f}); unclipped gradients '
        f'|d|/|g| against one process: median {med:.3e} (tol '
        f'{tol["median"]:.3e}), max {big:.3e} ({worst}; tol '
        f'{tol["max"]:.3e}), grad_norm {norm_rel:.3e} (tol '
        f'{tol["norm"]:.3e}); the dp 2 x cam 1 control: median {cmed:.3e}, '
        f'max {cbig:.3e} ({cworst}), grad_norm {cnorm:.3e} [{card}]')
    if not max(cmed, cbig) <= CAM_CONTROL_MAX:
        raise AssertionError(f'cam: the dp control moved the gradients by '
                             f'{cmed}, {cbig}')
    if not (med <= tol['median'] and big <= tol['max']
            and norm_rel <= tol['norm']):
        raise AssertionError('cam: step 0 gradients differ from one '
                             'process beyond the dp control\'s spread')
    cl = control['logs'][0]['total_loss']
    if not abs(cl - s['total_loss']) <= CAM_LOSS_RTOL * abs(
            s['total_loss']) + 1e-7:
        raise AssertionError(f'cam: the dp control\'s loss {cl}')
    for r in [single] + ranks:
        for rec in r['logs']:
            if not all(np.isfinite(v) for v in rec.values()):
                raise AssertionError(f'cam: non-finite log {rec}')
    # a rank lifts and marches each row of its dp block (world / dp = cam
    # rows) once a step, over its own cameras
    fit_want = {k: (N_CAM_STEPS * cam if k in lift_keys(cfg)
                    + ('rays', 'rays_bwd') else 0) for k in r0['launches']}
    say(f'cam: rank 0 fit kernel launches {r0["launches"]}')
    if cuda and (r0['launches'] != fit_want
                 or ranks[1]['launches'] != fit_want):
        raise AssertionError(f'cam: fit launched {r0["launches"]}, want '
                             f'{fit_want}')

    # (c) validate on the initial weights
    conf_one, conf_cam = single['val_conf'], r0['val_conf']
    diff = [int(np.abs(a - b).sum()) for a, b in zip(conf_cam, conf_one)]
    tot = [int(c.sum()) for c in conf_one]
    say(f'cam: validate on {world} rows: mIoUs {r0["val_list"]} vs one '
        f'process {single["val_list"]}; confusion entries moved {diff} of '
        f'{tot} (argmax near-ties)')
    if [int(c.sum()) for c in conf_cam] != tot or \
            any(d > 1e-4 * t for d, t in zip(diff, tot)):
        raise AssertionError(f'cam: validate differs from one process: '
                             f'{diff} of {tot}')
    for r in ranks:
        if r['val_list'] != r0['val_list']:
            raise AssertionError('cam: the ranks report other mIoUs')
    times = [', '.join(f'{t:.1f}' for t in r['step_times']) for r in ranks]
    say(f'cam step (float32, dp 1 x cam 2 over {backend}): rank medians '
        f'{[round(r["step_ms"], 2) for r in ranks]} ms ({times}), one '
        f'process {single["step_ms"]:.2f} ms; peak '
        f'{[round(r["peak_gb"] or 0, 3) for r in ranks]} GB a rank, one '
        f'process {single["peak_gb"] or 0:.3f} GB [{card}]')
    out = dict(backend=backend, fit_launches=r0['launches'],
               step_ms=[r['step_ms'] for r in ranks],
               single_step_ms=single['step_ms'],
               peak_gb=[r['peak_gb'] for r in ranks],
               single_peak_gb=single['peak_gb'], grad_rel_median=med,
               grad_rel_max=big, grad_norm_rel=norm_rel,
               control_grad_rel_median=cmed, control_grad_rel_max=cbig,
               val_moved=diff, kernels=kern,
               wall_s=time.perf_counter() - t0)
    del single, ranks, r0, control
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    say(f'cam: phase wall {out["wall_s"]:.1f} s')
    return out


def cam_launches(cam, kernel):
    """A kernel's launches in the cam phase's fit: rank 0's."""
    return cam['fit_launches'][kernel]


def multi_launches(multi, kernel):
    """A kernel's launches in the multi-device phase: rank 0's fit and the
    pool's requests."""
    return dict(fit=multi['fit_launches'][kernel],
                pool=multi['pool_launches'][kernel])


# the converge phase: tools/convergence_study.py at the JAX record's
# settings (scripts/convergence_study.json: 300 steps over 4 consistent
# scenes, B=1, bf16, the flagship recipe), then tools/multisweep_ab.py at
# the JAX record's 120 steps an arm over 3 + 3 scenes
CONVERGE_STEPS = 300
CONVERGE_BATCHES = 4
# tests/test_overfit.py's rule for each loss term: the mean of the last
# window under max(0.95 x, x - 1e-4), x the first window's max
TERM_FACTOR = 0.95
TERM_SLACK = 1e-4
TERM_WINDOW = 10
# the total's last/first ratio (JAX recorded 0.0185) and car AP at 2 m
# (JAX recorded 0.9556) the run must reach
TOTAL_RATIO_MAX = 0.10
CAR_AP_2M_MIN = 0.5
AB_STEPS = 120
AB_SCENES = 3
LOSS_TERMS = ('detection_loss', 'camera_depth_loss', 'camera_seg_loss',
              'bev_seg_loss', 'bev_height_loss', 'pts_seg_loss',
              'visible_occ_seg_loss', 'visible_occ_density_loss',
              'invisible_occ_density_loss')


def term_falls(xs, window=TERM_WINDOW):
    """tests/test_overfit.py's rule over a trajectory: (first window's max,
    last window's mean, passed)."""
    first = max(xs[:window])
    last = sum(xs[-window:]) / len(xs[-window:])
    return first, last, last < max(TERM_FACTOR * first, first - TERM_SLACK)


def jax_record():
    """The JAX package's convergence record (read only), or None."""
    path = os.path.join(ROOT, 'scripts', 'convergence_study.json')
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def converge_run(card, cfg, dev, steps, n_batches):
    """The convergence study on `dev` in bf16 and its checks: finite logs,
    the launches of each step, each term's fall, the total's ratio and
    car AP at 2 m."""
    import torch
    from vampire_tpu_torch.tools import convergence_study as C
    reset_counts()
    rec = C.run(cfg, steps, n_batches, device=dev, dtype=torch.bfloat16,
                log=lambda msg: say(f'converge: {msg}'))
    launched = counts()
    bad = [k for k in C.KEYS if not all(np.isfinite(rec['history'][k]))]
    if bad:
        raise AssertionError(f'converge: non-finite {bad}')
    want = {k: 1 for k in lift_keys(cfg) + ('rays', 'rays_bwd')}
    wrong = [(i, l) for i, l in enumerate(rec['launches']) if l != want]
    if wrong:
        raise AssertionError(f'converge: steps {wrong[:5]} launched other '
                             f'than {want} ({len(wrong)} steps)')
    if rec['eval_launches'] != {lift_forward_keys(cfg)[0]: n_batches}:
        raise AssertionError(f'converge: the det eval launched '
                             f'{rec["eval_launches"]}')
    jrec = jax_record()
    failed = []
    window = min(TERM_WINDOW, max(1, steps // 5))
    for k in LOSS_TERMS + ('total_loss',):
        first, last, ok = term_falls(rec['history'][k], window)
        s = rec['summary'][k]
        j = jrec['summary'][k] if jrec else None
        say(f'converge {k}: first {s["first"]:.4f} -> last {s["last"]:.4f} '
            f'(ratio {s["ratio"]}; first-window max {first:.4f}, last '
            f'mean {last:.4f}, {"falls" if ok else "DOES NOT FALL"}); JAX '
            f'recorded ' + (f'{j["first"]} -> {j["last"]} (ratio '
                            f'{j["ratio"]})' if j else 'nothing'))
        if not ok:
            failed.append(k)
    ratio = rec['summary']['total_loss']['ratio']
    det = rec['det_eval']
    ms = statistics.median(rec['step_ms'][1:] or rec['step_ms'])
    say(f'converge: {steps} steps over {n_batches} scenes in '
        f'{rec["wall_s"]:.1f} s; step median {ms:.2f} ms (host clock, step '
        f'0 apart), peak memory {rec["peak_gb"] or 0:.3f} GB; launches '
        f'{launched} [{card}]')
    say(f'converge det_eval: {json.dumps(det)}; JAX recorded '
        + (json.dumps(jrec['det_eval']) if jrec else 'nothing'))
    if failed:
        raise AssertionError(f'converge: {failed} do not fall '
                             f'(tests/test_overfit.py rule)')
    if ratio is None or ratio > TOTAL_RATIO_MAX:
        raise AssertionError(f'converge: total loss ratio {ratio} > '
                             f'{TOTAL_RATIO_MAX}')
    if det['car_ap']['2.0'] < CAR_AP_2M_MIN:
        raise AssertionError(f'converge: car AP at 2 m {det["car_ap"]} < '
                             f'{CAR_AP_2M_MIN}')
    return dict(launched=launched, step_ms=ms, peak_gb=rec['peak_gb'],
                wall_s=rec['wall_s'], total_ratio=ratio, det_eval=det,
                summary=rec['summary'])


def multisweep_run(card, dev, steps, scenes):
    """tools/multisweep_ab.py at tiny_config on `dev`: each arm's training
    total falls (last window's mean under the first's), every held-out
    loss is finite, each arm's steps launch the lift and the rays once
    each way and its held-out forwards once each (the F=2 arm's lift over
    a frame's 12 views)."""
    from vampire_tpu_torch.data.synthetic import tiny_config
    from vampire_tpu_torch.tools import multisweep_ab as MS
    cfg = tiny_config()
    reset_counts()
    out = MS.run(steps=steps, train_scenes=scenes, val_scenes=scenes,
                 device=dev, log=lambda msg: say(f'multisweep:{msg}'))
    launched = counts()
    window = min(TERM_WINDOW, max(1, steps // 5))
    for arm in ('f1', 'f2'):
        tot = out['train_total'][arm]
        first = sum(tot[:window]) / window
        last = sum(tot[-window:]) / window
        if not last < first:
            raise AssertionError(f'multisweep {arm}: the training total '
                                 f'does not fall ({first} -> {last})')
        bad = [k for k, v in out[arm].items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f'multisweep {arm}: non-finite {bad}')
        say(f'multisweep {arm}: training total {first:.4f} -> {last:.4f}; '
            f'held-out {out[arm]}')
    fwd = 2 * (steps + scenes)
    want = {k: (fwd if k in lift_forward_keys(cfg) + ('rays',) else
                2 * steps if k in lift_keys(cfg) + ('rays_bwd',) else 0)
            for k in launched}
    if launched != want:
        raise AssertionError(f'multisweep: launches {launched}, want {want}')
    say(f'multisweep: f2_over_f1 {out["f2_over_f1"]}; launches {launched} '
        f'[{card}]')
    return dict(launched=launched, f2_over_f1=out['f2_over_f1'],
                f1=out['f1'], f2=out['f2'])


def converge_phase(card, cfg=None, dev='cuda', steps=CONVERGE_STEPS,
                   n_batches=CONVERGE_BATCHES, ab_steps=AB_STEPS,
                   ab_scenes=AB_SCENES):
    """The accuracy studies on the card: the flagship convergence run with
    its detection eval (`converge_run`), then the multi-sweep A/B
    (`multisweep_run`). Returns both parts' launches and numbers."""
    from vampire_tpu_torch.configs import flagship_config
    cfg = cfg or flagship_config()
    t0 = time.perf_counter()
    out = dict(study=converge_run(card, cfg, dev, steps, n_batches),
               multisweep=multisweep_run(card, dev, ab_steps, ab_scenes))
    out['wall_s'] = time.perf_counter() - t0
    say(f'converge: phase wall {out["wall_s"]:.1f} s [{card}]')
    return out


def converge_launches(cv, kernel):
    """A kernel's launches in the converge phase: the study's steps and
    its det eval, and the multi-sweep A/B's two arms."""
    return dict(study=cv['study']['launched'][kernel],
                multisweep=cv['multisweep']['launched'][kernel])


REPLACES = dict(
    row_gather='scripts/perf_vmem_gather.py:123, '
               'scripts/perf_r3_gather_layouts.py:74, '
               'scripts/perf_r3_gather_layouts.py:126, '
               'scripts/perf_r3_gather_layouts.py:95',
    onehot_gather_mma='scripts/perf_vmem_gather.py:164',
    block_copy_tma='scripts/perf_r3_dma_control.py:27, '
                   'scripts/perf_r3_dma_control.py:56, '
                   'scripts/perf_vmem_gather.py:64',
    row_gather_tma='scripts/perf_r3_dma_gather.py:66, '
                   'scripts/perf_r3_dma_bisect.py:79, '
                   'scripts/perf_r3_dma_bisect.py:96, '
                   'scripts/perf_r3_dma_sweep.py:41, '
                   'scripts/perf_r4_dma_scale.py:49, '
                   'scripts/perf_r4_dma_scale.py:184')


def eval_launches(ev, kernel):
    """A kernel's launches in each call of the eval phase."""
    return {label: r['launched'][kernel] for label, r in ev.items()}


def variant_launches(var, kernel):
    """A kernel's launches in each run of the variants phase: per variant
    its metrics and full-render requests, its fit and its validate row;
    the multi-sweep step and request; the dense-lift request."""
    out = {name: dict(metrics=var[name]['serve']['metrics'][kernel],
                      full=var[name]['serve']['full'][kernel],
                      fit=var[name]['train']['launched'][kernel],
                      validate=var[name]['validate']['launched'][kernel])
           for name in VARIANTS}
    out['sweeps'] = dict(step=var['sweeps']['step_launches'][kernel],
                         request=var['sweeps']['request_launches'][kernel])
    out['dense'] = var['dense']['launched'][kernel]
    return out


def data_launches(data, kernel):
    """A kernel's launches in each call of the data phase."""
    return {label: data[f'{label}_launches'][kernel]
            for label in ('fit', 'validate', 'test')}


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                         'this script runs only on a CUDA card')
    import vampire_tpu_torch  # noqa: F401  (the port, from this checkout)
    card = device_phase()
    build_phase()
    k = kernel_phase(card)
    served = slice_phase(card)
    launched = served['full']
    train = train_phase(card)
    tl = train['launched']
    ev = eval_phase(card)
    data = data_phase(card, train['step_ms'])
    var = variants_phase(card)
    multi = multi_phase(card)
    cam = cam_phase(card)
    extras = extras_phase(card, served['ms']['full'])
    probes, pl = probe_phase(card)
    cv = converge_phase(card)
    leaked = sorted(m for m in sys.modules if m.split('.')[0] in
                    ('jax', 'jaxlib', 'flax', 'optax', 'vampire_tpu'))
    if leaked:
        raise AssertionError(f'the port imported {leaked}')
    csrc = 'vampire_tpu_torch/csrc'
    # library_ms None: no single PyTorch call computes the lift, the rays or
    # their backwards. The corner table's is a pad and one strided copy, its
    # backward's a one-hot conv_transpose3d (ops/tables.py, yardsticks no
    # path calls). The corner-table pair is off the model's path (0
    # launches there) and checked in the kernel phase only; on the bilinear
    # lift the depth-less lift kernels take its place.
    bil = var['bilinear']
    print(json.dumps({'kernels': [{
        'name': 'lift_accumulate',
        'route': 'cuda',
        'source': f'{csrc}/lift.cu',
        'replaces': 'vampire_tpu/ops/pallas_tables.py:289',
        'also_replaces': 'vampire_tpu/ops/pallas_gather.py:68',
        'launches': launched['lift'],
        'train_launches': tl['lift'],
        'per': 'frame',
        'eval_launches': eval_launches(ev, 'lift'),
        'data_launches': data_launches(data, 'lift'),
        'variant_launches': variant_launches(var, 'lift'),
        'multi_launches': multi_launches(multi, 'lift'),
        'cam_launches': cam_launches(cam, 'lift'),
        'cam_split_ms': {n: {c: cam['kernels'][n][f'ms_{c}'] for c in (3, 6)}
                         for n in ('float32', 'bfloat16')},
        'extras_launches': extras_launches(extras, 'lift'),
        'converge_launches': converge_launches(cv, 'lift'),
        'max_abs_err': k['lift']['max_abs_err'],
        'ms': k['lift']['bfloat16']['ms'],
        'plain_ms': k['lift']['bfloat16']['plain_ms'],
        'bound_ms': k['lift']['bfloat16']['bound_ms'],
        'bound_by': 'bytes',
        'library_ms': None,
        'fp32_ms': k['lift']['float32']['ms'],
        'fp32_plain_ms': k['lift']['float32']['plain_ms'],
    }, {
        'name': 'corner_table',
        'route': 'cuda',
        'source': f'{csrc}/corner_table.cu',
        'replaces': 'vampire_tpu/ops/pallas_tables.py:73',
        'launches': launched['corner_table'],
        'train_launches': tl['corner_table'],
        'eval_launches': eval_launches(ev, 'corner_table'),
        'data_launches': data_launches(data, 'corner_table'),
        'extras_launches': extras_launches(extras, 'corner_table'),
        'converge_launches': converge_launches(cv, 'corner_table'),
        'max_abs_err': k['corner_table']['max_abs_err'],
        'ms': k['corner_table']['bfloat16']['ms'],
        'plain_ms': k['corner_table']['bfloat16']['plain_ms'],
        'bound_ms': k['corner_table']['bfloat16']['bound_ms'],
        'bound_by': 'bytes',
        'library_ms': k['corner_table']['bfloat16']['library_ms'],
        'write_floor_ms': k['corner_table']['bfloat16']['write_floor_ms'],
        'conv3d_ms': k['corner_table']['bfloat16']['conv3d_ms'],
        'plan': k['corner_table']['bfloat16']['plan'],
        'fp32_ms': k['corner_table']['float32']['ms'],
        'fp32_plain_ms': k['corner_table']['float32']['plain_ms'],
        'fp32_library_ms': k['corner_table']['float32']['library_ms'],
        'fp32_write_floor_ms':
            k['corner_table']['float32']['write_floor_ms'],
        'fp32_plan': k['corner_table']['float32']['plan'],
    }, {
        'name': 'sample_and_composite_rays',
        'route': 'cuda',
        'source': f'{csrc}/rays.cu',
        'replaces': 'vampire_tpu/core/rendering.py:100',
        'launches': launched['rays'],
        'train_launches': tl['rays'],
        'eval_launches': eval_launches(ev, 'rays'),
        'data_launches': data_launches(data, 'rays'),
        'variant_launches': variant_launches(var, 'rays'),
        'multi_launches': multi_launches(multi, 'rays'),
        'cam_launches': cam_launches(cam, 'rays'),
        'extras_launches': extras_launches(extras, 'rays'),
        'converge_launches': converge_launches(cv, 'rays'),
        'max_abs_err': k['rays']['max_abs_err'],
        'ms': k['rays']['ms'],
        'plain_ms': k['rays']['plain_ms'],
        'bound_ms': k['rays']['bound_ms'],
        'bound_by': 'bytes',
        'library_ms': None,
        'table_bound_ms': k['rays']['table_bound_ms'],
        'plan': k['rays']['plan'],
        'wide': k['rays_wide'],
    }, {
        'name': 'sample_and_composite_rays_stop',
        'route': 'cuda',
        'source': f'{csrc}/rays.cu',
        'replaces': 'vampire_tpu/core/rendering.py:331',
        'replaces_on': 'the early-termination sampler (XLA there), two '
                       'launches of rays_kernel\'s stop mode a frame, the '
                       'second resumed from the first\'s carried state',
        'launches': extras['earlyterm']['launched']['rays_stop'],
        'extras_launches': extras_launches(extras, 'rays_stop'),
        'converge_launches': converge_launches(cv, 'rays_stop'),
        'train_launches': tl['rays_stop'],
        'per': 'frame (ms: launch 1 + launch 2; bound: one read of each '
               'sample before its final stop; the carried state apart, '
               'state_bytes)',
        'max_abs_err': k['rays_stop']['max_abs_err'],
        'ms': k['rays_stop']['ms'],
        'plain_ms': k['rays_stop']['plain_ms'],
        'bound_ms': k['rays_stop']['bound_ms'],
        'bound_by': 'bytes',
        'library_ms': None,
        'launch_ms': k['rays_stop']['launch_ms'],
        'launch_plain_ms': k['rays_stop']['launch_plain_ms'],
        'launch_bound_ms': k['rays_stop']['launch_bound_ms'],
        'state_bytes': k['rays_stop']['state_bytes'],
        'dense_ms': k['rays_stop']['dense_ms'],
        'op_ms': k['rays_stop']['op_ms'],
        'dense_op_ms': k['rays_stop']['dense_op_ms'],
        'crossed': k['rays_stop']['crossed'],
        'plan': k['rays_stop']['plan'],
    }, {
        'name': 'lift_backward',
        'route': 'cuda',
        'source': f'{csrc}/lift.cu',
        'replaces': 'vampire_tpu/ops/pallas_tables.py:374',
        'launches': tl['lift_bwd'],
        'per': 'frame',
        'ctas': k['lift_bwd']['ctas'],
        'live_ctas': k['lift_bwd']['live_ctas'],
        'eval_launches': eval_launches(ev, 'lift_bwd'),
        'data_launches': data_launches(data, 'lift_bwd'),
        'variant_launches': variant_launches(var, 'lift_bwd'),
        'multi_launches': multi_launches(multi, 'lift_bwd'),
        'cam_launches': cam_launches(cam, 'lift_bwd'),
        'extras_launches': extras_launches(extras, 'lift_bwd'),
        'converge_launches': converge_launches(cv, 'lift_bwd'),
        'max_abs_err': k['lift_bwd']['max_abs_err'],
        'ms': k['lift_bwd']['bfloat16']['ms'],
        'plain_ms': k['lift_bwd']['bfloat16']['plain_ms'],
        'bound_ms': k['lift_bwd']['bfloat16']['bound_ms'],
        'bound_by': 'bytes',
        'library_ms': None,
        'fp32_ms': k['lift_bwd']['float32']['ms'],
        'fp32_plain_ms': k['lift_bwd']['float32']['plain_ms'],
    }, {
        'name': 'lift_bilinear',
        'route': 'cuda',
        'source': f'{csrc}/lift.cu',
        'replaces': 'vampire_tpu/ops/pallas_tables.py:73',
        'replaces_on': 'the bilinear lift, with the row gather over the '
                       'table (vampire_tpu/core/sampling.py:287-332)',
        'launches': bil['serve']['full']['lift_bilinear'],
        'metrics_launches': bil['serve']['metrics']['lift_bilinear'],
        'train_launches': bil['train']['launched']['lift_bilinear'],
        'validate_launches': bil['validate']['launched']['lift_bilinear'],
        'extras_launches': extras_launches(extras, 'lift_bilinear'),
        'converge_launches': converge_launches(cv, 'lift_bilinear'),
        'per': 'frame',
        'max_abs_err': k['lift_bilinear']['max_abs_err'],
        'ms': k['lift_bilinear']['bfloat16']['ms'],
        'plain_ms': k['lift_bilinear']['bfloat16']['plain_ms'],
        'bound_ms': k['lift_bilinear']['bfloat16']['bound_ms'],
        'bound_by': 'bytes',
        'library_ms': None,
        'fp32_ms': k['lift_bilinear']['float32']['ms'],
        'fp32_plain_ms': k['lift_bilinear']['float32']['plain_ms'],
        'batched_ms': k['lift_bilinear']['bfloat16']['batched_ms'],
        'fp32_batched_ms': k['lift_bilinear']['float32']['batched_ms'],
    }, {
        'name': 'slot_map',
        'route': 'cuda',
        'source': f'{csrc}/lift.cu',
        'replaces': 'vampire_tpu/ops/pallas_tables.py:73',
        'replaces_on': 'none by itself: the depth-less lift\'s first '
                       'launch, each camera\'s slot of each block, which '
                       'every CTA of the forward found by scanning the ids',
        'launches': bil['serve']['full']['slot_map'],
        'metrics_launches': bil['serve']['metrics']['slot_map'],
        'train_launches': bil['train']['launched']['slot_map'],
        'validate_launches': bil['validate']['launched']['slot_map'],
        'converge_launches': converge_launches(cv, 'slot_map'),
        'per': 'frame (ms: a call back to back)',
        'max_abs_err': k['lift_bilinear']['slot_map']['max_abs_err'],
        'ms': k['lift_bilinear']['slot_map']['ms'],
        'plain_ms': k['lift_bilinear']['slot_map']['plain_ms'],
        'bound_ms': k['lift_bilinear']['slot_map']['bound_ms'],
        'bound_by': 'bytes',
        'library_ms': None,
    }, {
        'name': 'lift_bilinear_backward',
        'route': 'cuda',
        'source': f'{csrc}/lift.cu',
        'replaces': 'vampire_tpu/ops/pallas_tables.py:214',
        'replaces_on': 'the bilinear lift\'s training',
        'launches': bil['train']['launched']['lift_bilinear_bwd'],
        'serve_launches': bil['serve']['full']['lift_bilinear_bwd'],
        'extras_launches': extras_launches(extras, 'lift_bilinear_bwd'),
        'converge_launches': converge_launches(cv, 'lift_bilinear_bwd'),
        'per': 'frame',
        'ctas': k['lift_bilinear_bwd']['ctas'],
        'live_ctas': k['lift_bilinear_bwd']['live_ctas'],
        'routes': k['lift_bilinear_bwd']['routes'],
        'max_abs_err': k['lift_bilinear_bwd']['max_abs_err'],
        'ms': k['lift_bilinear_bwd']['bfloat16']['ms'],
        'plain_ms': k['lift_bilinear_bwd']['bfloat16']['plain_ms'],
        'bound_ms': k['lift_bilinear_bwd']['bfloat16']['bound_ms'],
        'bound_by': 'bytes',
        'library_ms': None,
        'fp32_ms': k['lift_bilinear_bwd']['float32']['ms'],
        'fp32_plain_ms': k['lift_bilinear_bwd']['float32']['plain_ms'],
        'batched_ms': k['lift_bilinear_bwd']['bfloat16']['batched_ms'],
        'fp32_batched_ms': k['lift_bilinear_bwd']['float32']['batched_ms'],
    }, {
        'name': 'corner_table_backward',
        'route': 'cuda',
        'source': f'{csrc}/corner_table.cu',
        'replaces': 'vampire_tpu/ops/pallas_tables.py:214',
        'launches': tl['corner_table_bwd'],
        'eval_launches': eval_launches(ev, 'corner_table_bwd'),
        'data_launches': data_launches(data, 'corner_table_bwd'),
        'extras_launches': extras_launches(extras, 'corner_table_bwd'),
        'converge_launches': converge_launches(cv, 'corner_table_bwd'),
        'max_abs_err': k['corner_table_bwd']['max_abs_err'],
        'ms': k['corner_table_bwd']['bfloat16']['ms'],
        'plain_ms': k['corner_table_bwd']['bfloat16']['plain_ms'],
        'bound_ms': k['corner_table_bwd']['bfloat16']['bound_ms'],
        'bound_by': 'bytes',
        'library_ms': k['corner_table_bwd']['bfloat16']['library_ms'],
        'fp32_ms': k['corner_table_bwd']['float32']['ms'],
        'fp32_plain_ms': k['corner_table_bwd']['float32']['plain_ms'],
        'fp32_library_ms': k['corner_table_bwd']['float32']['library_ms'],
    }, {
        'name': 'sample_and_composite_rays_backward',
        'route': 'cuda',
        'source': f'{csrc}/rays.cu',
        'replaces': 'vampire_tpu/core/rendering.py:155',
        'launches': tl['rays_bwd'],
        'eval_launches': eval_launches(ev, 'rays_bwd'),
        'data_launches': data_launches(data, 'rays_bwd'),
        'variant_launches': variant_launches(var, 'rays_bwd'),
        'multi_launches': multi_launches(multi, 'rays_bwd'),
        'cam_launches': cam_launches(cam, 'rays_bwd'),
        'extras_launches': extras_launches(extras, 'rays_bwd'),
        'converge_launches': converge_launches(cv, 'rays_bwd'),
        'max_abs_err': k['rays_bwd']['max_abs_err'],
        'ms': k['rays_bwd']['ms'],
        'plain_ms': k['rays_bwd']['plain_ms'],
        'bound_ms': k['rays_bwd']['bound_ms'],
        'bound_by': 'bytes',
        'library_ms': None,
        'table_bound_ms': k['rays_bwd']['table_bound_ms'],
        'plan': k['rays_bwd']['plan'],
    },
        probe_entry(probes, pl, 'row_gather', 'scale', variant='rows',
                    stream='random', W=176,
                    also=('vmem', dict(tpu_kernel='gk_tala',
                                       dtype='bfloat16'))),
        probe_entry(probes, pl, 'onehot_gather_mma', 'vmem'),
        probe_entry(probes, pl, 'block_copy_tma', 'scale', variant='copy',
                    stream='static', W=256,
                    also=('dma', dict(tpu_kernel='k_static'))),
        probe_entry(probes, pl, 'row_gather_tma', 'scale', variant='dma8',
                    stream='random', W=176,
                    also=('dma', dict(tpu_kernel='k_s2'))),
    ], 'train_step_ms': train['step_ms'],
        'train_peak_gb': train['peak_gb'],
        'eval_ms_per_row': {k: v['ms_per_row'] for k, v in ev.items()},
        'validate_peak_gb': ev['validate']['peak_gb'],
        'data': {k: data[k] for k in (
            'getitem_train_ms', 'getitem_val_ms', 'loader_samples_per_s',
            'batch_mb', 'h2d_ms', 'step_ms', 'synthetic_step_ms', 'wait_ms',
            'fit_peak_gb', 'validate_ms_per_row', 'test_ms_per_row',
            'validate_first_batch_ms', 'test_first_batch_ms', 'nds',
            'wall_s', 'getitem_train_decode_ms') if k in data},
        'variants': {name: dict(
            request_ms=var[name]['serve']['ms'],
            step_ms=var[name]['train']['step_ms'],
            peak_gb=var[name]['train']['peak_gb'],
            validate_ms=var[name]['validate']['ms'],
            wall_s=var[name]['wall_s']) for name in VARIANTS},
        'sweeps': {k: var['sweeps'][k] for k in (
            'step_ms', 'peak_gb', 'request_ms')},
        'dense': {k: var['dense'][k] for k in (
            'request_ms', 'max_abs_err', 'dropped')},
        'extras': dict(
            wall_s=extras['wall_s'],
            earlyterm={k: extras['earlyterm'][k] for k in (
                'request_ms', 'dense_request_ms', 'diag', 'plain_diag',
                'crossed', 'crossed_below_tau', 'own_crossed',
                'max_abs_err')},
            train={k: extras['train'][k] for k in (
                'step_ms', 'log_images_ms', 'rgb_loss', 'trace_bytes',
                'trace_kernel_events')},
            compact=extras['train']['compact'],
            graft_request_ms=extras['graft']['request_ms']),
        'multi': {k: multi[k] for k in (
            'world', 'backend', 'dtype', 'dist_step_ms', 'single_step_ms',
            'dist_peak_gb', 'single_peak_gb', 'grad_rel_median',
            'grad_rel_max', 'grad_spread_median', 'grad_spread_max',
            'grad_norm_rel', 'fps_1_replica', 'fps_2_replicas', 'tcp_ms', 'direct_ms',
            'tcp_overhead_ms', 'wall_s')},
        'cam': {k: cam[k] for k in (
            'backend', 'step_ms', 'single_step_ms', 'peak_gb',
            'single_peak_gb', 'grad_rel_median', 'grad_rel_max',
            'grad_norm_rel', 'control_grad_rel_median',
            'control_grad_rel_max', 'val_moved', 'wall_s')},
        'converge': dict(
            wall_s=cv['wall_s'],
            step_ms=cv['study']['step_ms'], peak_gb=cv['study']['peak_gb'],
            study_wall_s=cv['study']['wall_s'],
            total_ratio=cv['study']['total_ratio'],
            ratios={k: v['ratio'] for k, v in cv['study']['summary'].items()},
            det_eval=cv['study']['det_eval'],
            multisweep_f2_over_f1=cv['multisweep']['f2_over_f1'])}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    sys.path.insert(0, ROOT)
    main()
