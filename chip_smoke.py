#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training and evaluation paths,
its input pipeline and its row-gather probes once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line; any failure raises and the script exits
nonzero without printing a result:

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
               every selected block selected by two cameras; the corner
               table of a (22, 20, 256, 256) field in fp32 and bf16, which
               must be byte-identical and launched on its plan's staging
               route (its plan and the route the kernel's C entry reports
               are printed; 16-byte loads at the flagship; timed beside a pad + strided copy, a one-hot
               conv3d and a zero_() of the table; the corner-table
               kernels left the model's path; they are the port of the TPU
               table kernels and are checked here only); the ray sampler over 67,584 rays x 85
               samples of camera_rig geometry through the bf16 channels-last
               field (voxel stride 24) of a synthetic field whose rays end
               partly opaque. Then the three backward kernels: the lift's
               per frame in fp32 and bf16 (the same two cases), the corner
               table's from an fp32
               and a bf16 (21, 257, 257, 176) cotangent (byte-identical;
               timed beside a one-hot conv_transpose3d),
               and the rays' over the same 67,584 rays (d field and d
               beta).
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
  8. probe   - `python -m vampire_tpu_torch.tools.gather_probe`'s vmem,
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
phase (`eval_launches`) and of the data phase (`data_launches`); the object
also holds the eval calls' ms a row, validate's peak memory and the data
phase's numbers (`data`). The last three lines are a JSON object of the
kernels run, the card's name and power limit, and `{"ok": true, "device":
{...}}`.
"""
import contextlib
import dataclasses
import json
import os
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
# the probe phase's scale pairs (variant, stream) of tools/gather_probe.py
PROBE_SCALE = [(v, s) for v in ('rows', 'dma1', 'dma8', 'dmau8', 'dma32',
                                'dmau32') for s in ('random', 'coherent')]
PROBE_SCALE += [('copy', 'static'), ('copy', 'permuted')]
# step 0's gradients, per parameter tensor, |g - g_ref| / |g_ref| in the L2
# norm. In fp32 compute, kernels vs plain versions in both directions: the
# two lifts differ in the last fp32 bits, which flip the bf16 rounding of
# the sample_dtype copy of the field that the point queries and the rays
# read (median 1.3e-3, max 3.1e-3 measured on an H100); allow 1e-2.
TRAIN_GRAD_RTOL = 1e-2
# In bf16 compute, the backward kernels vs their plain versions behind the
# same kernel forward: only the order of the fp32 atomics differs, which
# flips bf16 roundings of the gradients downstream (two kernel runs differ
# as much: max 2.5e-2 measured on an H100); allow 0.1. Kernels vs plain in
# both directions is no test in bf16: the forwards' last-bit differences
# flip bf16 roundings throughout the network and the gradients differ by a
# median of 22% (measured), as two forwards in another order would.
TRAIN_BWD_RTOL = 0.1


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
    """The launch counts of the six kernel wrappers."""
    from vampire_tpu_torch.ops import lift, rays, tables
    return dict(lift=lift.LAUNCHES, corner_table=tables.LAUNCHES,
                rays=rays.LAUNCHES, lift_bwd=lift.BWD_LAUNCHES,
                corner_table_bwd=tables.BWD_LAUNCHES,
                rays_bwd=rays.BWD_LAUNCHES)


def reset_counts():
    from vampire_tpu_torch.ops import lift, rays, tables
    lift.LAUNCHES = tables.LAUNCHES = rays.LAUNCHES = 0
    lift.BWD_LAUNCHES = tables.BWD_LAUNCHES = rays.BWD_LAUNCHES = 0


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
    frame."""
    import torch
    from vampire_tpu_torch.ops import lift

    dev = torch.device(dev)
    (depth, feat, ids, coords, valid), (G, Q, C, K, n_valid) = \
        lift_cameras(bc, dev)
    D, h, w = depth.shape[1:]
    say(f'lift: depth (6,{D},{h},{w}) feat (6,{h},{w},{C}) K={K} Q={Q} '
        f'G={G}, {n_valid} valid queries; one launch a frame')

    result = dict(max_abs_err=0.0)
    for dt in (torch.float32, torch.bfloat16):
        dep, fea = depth.to(dt), feat.to(dt)
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
            say(f'lift {name} {case}: max abs err {err:.3e} (max |ref| '
                f'{scale:.3e}, tol {tol:.1e}); denom mismatches {dmis} of '
                f'{want[1].numel()}')
            if not err <= tol:
                raise AssertionError(f'lift kernel {name} {case} disagrees '
                                     f'with the plain version: {err} > {tol}')
            # an exact cancellation to 0 can flip one count; allow 1e-6
            if dmis > 1e-6 * want[1].numel():
                raise AssertionError(f'lift kernel {name} {case}: {dmis} '
                                     f'denominator counts differ')
            result['max_abs_err'] = max(result['max_abs_err'], err)
            del got, want
        ms = cuda_ms(lambda: lift.lift_frame_accumulate(
            dep, fea, ids, coords, valid, G), 50)
        plain = cuda_ms(lambda: lift.lift_frame_accumulate_reference(
            dep, fea, ids, coords, valid, G), 5)
        # the frame's inputs read once, numer and denom written once
        bound = hbm_ms(dep, fea, ids, coords, valid, 2 * G * Q * C * 4)
        say(f'lift {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms per '
            f'frame, bound {bound:.4f} ms (share {bound / ms:.3f}) [{card}]')
        result[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound)
    return result


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


def ray_plan(args, backward):
    """The ray kernel's launch on `ray_field`'s field (`ops.rays.plan`)."""
    from vampire_tpu_torch.ops import rays
    field = args[0]
    return rays.plan(field.dtype, field.shape[3], backward)


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
    for name, sl in (('rgb', slice(0, 3)), ('seg', slice(3, K + 3)),
                     ('depth', slice(K + 3, K + 4))):
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
    result['plan'] = ray_plan(args, False)
    say(f'rays bf16: kernel {result["ms"]:.4f} ms, plain '
        f'{result["plain_ms"]:.4f} ms per frame, bound '
        f'{result["bound_ms"]:.4f} ms ({n_vox} distinct field voxels read; '
        f'through the table {result["table_bound_ms"]:.4f} ms, {n_rows} '
        f'rows); launch {result["plan"]} [{card}]')
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
    bf16, on the frame and on `paired_ids`; times per frame."""
    import torch
    from vampire_tpu_torch.ops import lift

    dev = torch.device(dev)
    (depth, feat, ids, coords, valid), (G, Q, C, K, n_valid) = \
        lift_cameras(bc, dev)
    g = torch.randn(G, Q, C, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    live = int((valid.sum(-1) > 0).sum())
    # the d numer rows the valid queries read: distinct (block, query)
    rows = torch.zeros(G, Q, dtype=torch.bool, device=dev)
    rows[ids[..., None].expand(-1, -1, Q)[valid > 0],
         torch.arange(Q, device=dev).expand_as(valid)[valid > 0]] = True
    n_rows = int(rows.sum())
    say(f'lift_bwd: {ids.numel()} CTAs, one a (camera, selected block), '
        f'{live} with a valid query; every CTA adds straight into device '
        f'memory (float4 reductions); {n_valid} valid queries read '
        f'{n_rows} d numer rows')
    result = dict(max_abs_err=0.0, ctas=ids.numel(), live_ctas=live)
    for dt in (torch.float32, torch.bfloat16):
        dep, fea = depth.to(dt), feat.to(dt)
        name = str(dt).replace('torch.', '')
        for case, ii in (('frame', ids), ('paired cameras', paired_ids(ids))):
            got = lift.lift_frame_backward(dep, fea, ii, coords, valid, g)
            want = lift.lift_frame_backward_reference(dep, fea, ii, coords,
                                                      valid, g)
            torch.cuda.synchronize()
            for what, a, b in (('d depth', got[0], want[0]),
                               ('d feat', got[1], want[1])):
                err = check_grad(f'lift_bwd {name} {case} {what}', a, b,
                                 BWD_RTOL)
                result['max_abs_err'] = max(result['max_abs_err'], err)
            del got, want
        ms = cuda_ms(lambda: lift.lift_frame_backward(
            dep, fea, ids, coords, valid, g), 20)
        plain = cuda_ms(lambda: lift.lift_frame_backward_reference(
            dep, fea, ids, coords, valid, g), 3)
        # what the valid queries read (their coords and d numer rows; the
        # kernel skips the others), the rest of the frame's inputs, fp32
        # d depth and d feat written
        bound = hbm_ms(dep, fea, ids, valid, n_valid * 3 * 4, n_rows * C * 4,
                       dep.numel() * 4, fea.numel() * 4)
        say(f'lift_bwd {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms per '
            f'frame, bound {bound:.4f} ms (share {bound / ms:.3f}) [{card}]')
        result[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound)
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
    plan = ray_plan(args, True)
    say(f'rays_bwd bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms per frame, '
        f'bound {bound:.4f} ms (through the table {table_bound:.4f} ms); '
        f'launch {plan} [{card}]')
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                table_bound_ms=table_bound, plan=plan)


def kernel_phase(card, bc=None, dev='cuda'):
    from vampire_tpu_torch.configs import flagship_config
    bc = bc or flagship_config().backbone
    out = dict(lift=lift_check(card, bc, dev),
               corner_table=table_check(card, bc, dev))
    args = ray_field(bc, dev)
    out['rays'] = ray_check(card, bc, dev, args)
    out['lift_bwd'] = lift_bwd_check(card, bc, dev)
    out['corner_table_bwd'] = table_bwd_check(card, bc, dev)
    out['rays_bwd'] = ray_bwd_check(card, bc, dev, args)
    return out


def calibrate_batchnorm_(model, inputs, camera_renders=False):
    """Set every BatchNorm's running statistics to the batch statistics of
    one synthetic frame: one train-mode forward of `inputs` (imgs, mats,
    points on the model's device), momentum 1. Leaves the model in eval
    mode.

    Seeded random weights leave BN the identity, so activations grow
    through the residual stacks (~3x in variance per bottleneck) until the
    heads saturate: sigmoid scores of exactly 1 and exp(dim) overflowing.
    Calibrated statistics keep every layer in its working range, as a
    trained model's would.
    """
    import torch
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.momentum = 1.0
    imgs, mats, points = inputs
    model.train()
    for m in bns:       # the frozen stem's BN too, which train() leaves out
        m.train()
    with torch.no_grad():
        model(imgs, mats, points=points, camera_renders=camera_renders)
    model.eval()
    say(f'calibrated {len(bns)} BatchNorm layers on one synthetic frame')


def serve_path(card, server, calib, samples, label):
    """Calibrate, start and warm `server`, then serve `samples` with every
    launch count set to 0 just before; returns (outputs, launch counts)."""
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
    return outs, launched


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


def slice_phase(card, cfg=None, dev='cuda'):
    import numpy as np
    import torch
    from vampire_tpu_torch.configs import flagship_config, synthetic_batch
    from vampire_tpu_torch.serving import InferenceServer

    cfg = cfg or flagship_config()
    frames = []
    for i in range(N_REQUESTS + 1):
        b = synthetic_batch(cfg, batch_size=1,
                            n_points=cfg.train.max_points, seed=i,
                            mode='val')
        frames.append({k: np.asarray(b[k])[0] for k in
                       ('imgs', 'sensor2ego', 'intrin', 'ida', 'bda',
                        'points')})
    samples, calib = frames[:N_REQUESTS], frames[N_REQUESTS]
    bc = cfg.backbone
    gx, gy, gz = bc.occ_grid
    Kc, P = bc.num_classes, cfg.train.max_points
    N = samples[0]['imgs'].shape[0]
    H, W = bc.final_dim
    _, Yd, Xd = bc.grid_zyx('det')
    metric = dict(occ_logits=(gx, gy, gz, Kc), occ_density=(gx, gy, gz),
                  pts_logits=(P, Kc))
    launched = {}

    # the metrics graph: no corner table, no rays
    server = InferenceServer(cfg, device=dev, dtype=torch.bfloat16,
                             outputs='metrics', seed=0)
    outs, launched['metrics'] = serve_path(card, server, calib, samples,
                                           'metrics')
    check_launches('metrics', launched['metrics'],
                   dict(lift=1, corner_table=0, rays=0))
    check_outputs('metrics', outs, metric, cfg)
    check_against_plain('metrics', server, samples[0], outs[0], metric)
    del server, outs
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    # the full-render graph: one ray launch per frame, no corner table
    server = InferenceServer(cfg, device=dev, dtype=torch.bfloat16,
                             outputs=None, seed=0)
    outs, launched['full'] = serve_path(card, server, calib, samples,
                                        'full-render')
    check_launches('full-render', launched['full'],
                   dict(lift=1, corner_table=0, rays=1))
    check_outputs('full-render', outs,
                  dict(metric, depth_preds=(N, H, W), seg_preds=(N, H, W),
                       bev_seg=(Yd, Xd)), cfg)
    check_against_plain('full-render', server, samples[0], outs[0], metric,
                        ('rgb_preds', 'seg_logits_preds', 'depth_preds'))
    return launched


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


def train_grad_check(card, cfg, trainer, batch, dev):
    """Step 0's gradients per trainable parameter tensor, under
    `partly_opaque_density`: (1) in fp32 compute (a second Trainer from the
    same seed), through the kernels against the same step with plain=True;
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
                         'plain versions', kern, plain, again,
                         TRAIN_GRAD_RTOL)
    del kern, again, plain
    kern, again, plain_bwd = opaque_step_grads(
        card, trainer, batch, 'train bf16',
        [(False, False), (False, False), (False, True)])
    bf16 = compare_grads(card, 'train step 0 gradients, bf16, backward '
                         'kernels vs their plain versions', kern, plain_bwd,
                         again, TRAIN_BWD_RTOL)
    return dict(fp32=fp32, bf16_backward=bf16)


def train_phase(card, cfg=None, dev='cuda'):
    """`Trainer.fit` over a list loader of N_TRAIN_BATCHES flagship training
    batches for one epoch, after the step-0 gradient check; then
    N_TIMED_STEPS more steps are timed. Returns the launch counts of the
    fit and the measurements."""
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
              for i in range(N_TRAIN_BATCHES)]
    with tempfile.TemporaryDirectory() as wd:
        trainer = Trainer(cfg, workdir=wd, device=dev)
        state = trainer.init_state(loader[0], len(loader))
        model = trainer.model
        say(f'train: {cfg.train.compute_dtype} Trainer built, '
            f'{sum(p.numel() for p in state.trainable())} trainable '
            f'parameters, {N_TRAIN_BATCHES} batches made, in '
            f'{time.perf_counter() - t0:.1f} s')
        grad = train_grad_check(card, cfg, trainer, loader[0], dev)
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
    say(f'train: fit over {N_TRAIN_BATCHES} steps in {fit_s:.2f} s (host '
        f'clock, incl. the epoch report and checkpoint); kernel launches '
        f'{launched}')
    want = dict(lift=1, corner_table=0, rays=1, lift_bwd=1,
                corner_table_bwd=0, rays_bwd=1)
    want = {k: n * N_TRAIN_BATCHES for k, n in want.items()}
    if launched != want:
        raise AssertionError(f'train: kernel launches {launched}, want '
                             f'{want} for {N_TRAIN_BATCHES} steps')
    steps = [r for r in recs if 'total_loss' in r]
    if len(steps) != N_TRAIN_BATCHES or saved != [0]:
        raise AssertionError(f'train: {len(steps)} step logs, checkpoints '
                             f'{saved}')
    for r in steps:
        if not all(np.isfinite(v) for v in r.values()):
            raise AssertionError(f'train: non-finite log {r}')
        say(f'train step {r["step"]}: total_loss {r["total_loss"]:.4f}, '
            f'grad_norm {r["grad_norm"]:.4f}, '
            + ', '.join(f'{k} {v:.4f}' for k, v in sorted(r.items())
                        if k.endswith('_loss') and k != 'total_loss'))
    for k, v in stem.state_dict().items():
        if not torch.equal(v, stem0[k]):
            raise AssertionError(f'train: the frozen stem changed ({k})')
    still = [n for n, p in model.named_parameters()
             if p.requires_grad and torch.equal(p.detach(), before[n])]
    unmoved = [n for n in still if n in nonzero]
    say(f'train: {len(before) - len(still)} parameter tensors moved; '
        f'unchanged: the frozen stem and {still} (no nonzero gradient in '
        f'any step)' if not unmoved else f'train: {unmoved} did not move')
    if unmoved:
        raise AssertionError(f'train: {unmoved} had gradients but did not '
                             f'move')

    # more steps, timed: host clock around each step ending in a
    # synchronize, and the peak memory over them
    step = build_train_step(cfg)
    conf = init_train_confusion(cfg, trainer.device)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(N_TIMED_STEPS):
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        state, logs, conf = step(state, trainer.to_device(
            loader[i % len(loader)]), conf)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - h0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = statistics.median(times)
    say(f'train step (flagship, B=1, {cfg.train.compute_dtype}): median '
        f'{ms:.2f} ms over {N_TIMED_STEPS} steps '
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
    import pickle
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
        per_step = dict(lift=1, corner_table=0, rays=1, lift_bwd=1,
                        corner_table_bwd=0, rays_bwd=1)
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
    launched = slice_phase(card)['full']
    train = train_phase(card)
    tl = train['launched']
    ev = eval_phase(card)
    data = data_phase(card, train['step_ms'])
    probes, pl = probe_phase(card)
    leaked = sorted(m for m in sys.modules if m.split('.')[0] in
                    ('jax', 'jaxlib', 'flax', 'optax', 'vampire_tpu'))
    if leaked:
        raise AssertionError(f'the port imported {leaked}')
    csrc = 'vampire_tpu_torch/csrc'
    # library_ms None: no single PyTorch call computes the lift, the rays or
    # their backwards. The corner table's is a pad and one strided copy, its
    # backward's a one-hot conv_transpose3d (ops/tables.py, yardsticks no
    # path calls). The corner-table pair is off the model's path (0
    # launches there) and checked in the kernel phase only.
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
        'max_abs_err': k['rays']['max_abs_err'],
        'ms': k['rays']['ms'],
        'plain_ms': k['rays']['plain_ms'],
        'bound_ms': k['rays']['bound_ms'],
        'bound_by': 'bytes',
        'library_ms': None,
        'table_bound_ms': k['rays']['table_bound_ms'],
        'plan': k['rays']['plan'],
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
        'max_abs_err': k['lift_bwd']['max_abs_err'],
        'ms': k['lift_bwd']['bfloat16']['ms'],
        'plain_ms': k['lift_bwd']['bfloat16']['plain_ms'],
        'bound_ms': k['lift_bwd']['bfloat16']['bound_ms'],
        'bound_by': 'bytes',
        'library_ms': None,
        'fp32_ms': k['lift_bwd']['float32']['ms'],
        'fp32_plain_ms': k['lift_bwd']['float32']['plain_ms'],
    }, {
        'name': 'corner_table_backward',
        'route': 'cuda',
        'source': f'{csrc}/corner_table.cu',
        'replaces': 'vampire_tpu/ops/pallas_tables.py:214',
        'launches': tl['corner_table_bwd'],
        'eval_launches': eval_launches(ev, 'corner_table_bwd'),
        'data_launches': data_launches(data, 'corner_table_bwd'),
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
            'wall_s', 'getitem_train_decode_ms') if k in data}}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    sys.path.insert(0, ROOT)
    main()
