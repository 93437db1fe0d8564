#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths once on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line; any failure raises and the script exits
nonzero without printing a result:

  1. device  - a CUDA card must be present (no CPU fallback); prints
               `nvidia-smi --query-gpu=name,power.limit`.
  2. build   - nvcc builds vampire_tpu_torch/csrc/{lift,corner_table,rays}.cu
               for sm_90a, one process per source, all started together.
  3. kernel  - each kernel against its plain torch version at the flagship
               shapes, with the error and the median time of each:
               the lift (D=86, h=64, w=176, C=16, K=264, Q=1280; camera_rig
               geometry, torch.topk selection) in fp32 and bf16; the corner
               table of a (22, 20, 256, 256) field in fp32 and bf16, which
               must be byte-identical; the ray sampler over 67,584 rays x 85
               samples of camera_rig geometry through a bf16 table of a
               synthetic field whose rays end partly opaque. Then the three
               backward kernels: the lift's per camera in fp32 and bf16, the
               corner table's from an fp32 and a bf16 (21, 257, 257, 176)
               cotangent (byte-identical), and the rays' over the same
               67,584 rays (d table and d beta).
  4. slice   - InferenceServer(flagship_config(), device='cuda') in bf16 with
               seeded random weights (BN calibrated on one frame) serves 3
               full-width requests (6x256x704 images, 36,864 points) on each
               path: outputs='metrics' (the metrics graph) and outputs=None
               (the full-render graph, with the camera renders). Checks
               keys, shapes, finiteness, the depth range, det boxes after
               NMS, the kernels' launch counts per request, and that
               request 0 matches the same forward with the plain versions
               of the kernels on the card; the renders also under a
               density head that leaves the rays partly opaque.
  5. train   - Trainer(flagship_config(), device='cuda') in bf16 with seeded
               random weights. Under a density head that leaves the rays
               partly opaque, step 0's gradients through the kernels
               against the same step with plain=True in fp32 compute, and
               through the backward kernels against their plain versions
               in bf16 compute; then
               `fit` over a list loader of 3 full-width training batches
               for one epoch. Checks the launch counts per step (lift 6
               forward and 6 backward, corner table and rays 1 and 1 each),
               finite loss terms and grad_norm, every parameter with a
               gradient moved, the frozen stem bit-unchanged; then times
               more steps and reads the peak memory.

The last three lines are a JSON object of the kernels run, the card's name
and power limit, and `{"ok": true, "device": {...}}`.
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

ROOT = os.path.dirname(os.path.abspath(__file__))
N_REQUESTS = 3
KERNEL_LIBS = ('lift', 'corner_table', 'rays')
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
    camera_rig geometry."""
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
    counts_ = valid.sum(-1)
    G, Q = valid.shape[2:]
    K = min(bc.lift_block_topk, G)
    g = torch.Generator(device=dev).manual_seed(0)
    depth = torch.softmax(torch.randn(6, D, h, w, device=dev, generator=g),
                          dim=1)
    feat = torch.randn(6, h, w, C, device=dev, generator=g)
    cams = []
    for n in range(6):
        ids = torch.topk(counts_[0, n], K).indices
        cams.append((ids, coords[0, n][ids].contiguous(),
                     valid[0, n][ids].contiguous()))
    return depth, feat, cams, G, Q, C, K, int(valid[0].sum())


def lift_check(card, bc, dev):
    """The lift kernel against its plain version, one camera at a time."""
    import torch
    from vampire_tpu_torch.ops import lift

    dev = torch.device(dev)
    depth, feat, cams, G, Q, C, K, n_valid = lift_cameras(bc, dev)
    D, h, w = depth.shape[1:]
    say(f'lift: depth ({D},{h},{w}) feat ({h},{w},{C}) K={K} Q={Q} G={G}, '
        f'6 cameras, {n_valid} valid queries')

    result = dict(max_abs_err=0.0)
    for dt in (torch.float32, torch.bfloat16):
        dep, fea = depth.to(dt), feat.to(dt)
        acc_k = [torch.zeros(G, Q, C, device=dev) for _ in range(2)]
        acc_r = [torch.zeros(G, Q, C, device=dev) for _ in range(2)]
        for n, (ids, cc, vv) in enumerate(cams):
            lift.lift_accumulate_(dep[n], fea[n], ids, cc, vv, *acc_k)
            lift.lift_accumulate_reference(dep[n], fea[n], ids, cc, vv,
                                           *acc_r)
        torch.cuda.synchronize()
        err = (acc_k[0] - acc_r[0]).abs().max().item()
        scale = acc_r[0].abs().max().item()
        dmis = int((acc_k[1] != acc_r[1]).sum())
        tol = KERNEL_RTOL * max(1.0, scale)
        ids, cc, vv = cams[1]
        scratch = [torch.zeros(G, Q, C, device=dev) for _ in range(2)]
        ms = cuda_ms(lambda: lift.lift_accumulate_(dep[1], fea[1], ids, cc,
                                                   vv, *scratch), 50)
        plain = cuda_ms(lambda: lift.lift_accumulate_reference(
            dep[1], fea[1], ids, cc, vv, *scratch), 10)
        name = str(dt).replace('torch.', '')
        say(f'lift {name}: max abs err {err:.3e} (max |ref| {scale:.3e}, '
            f'tol {tol:.1e}); denom mismatches {dmis} of '
            f'{acc_r[1].numel()}; kernel {ms:.4f} ms, plain {plain:.4f} ms '
            f'per camera [{card}]')
        if not err <= tol:
            raise AssertionError(f'lift kernel {name} disagrees with the '
                                 f'plain version: {err} > {tol}')
        # an exact cancellation to 0 can flip one count; allow 1e-6 of them
        if dmis > 1e-6 * acc_r[1].numel():
            raise AssertionError(f'lift kernel {name}: {dmis} denominator '
                                 f'counts differ')
        result['max_abs_err'] = max(result['max_abs_err'], err)
        result[name] = dict(ms=ms, plain_ms=plain)
    return result


def table_check(card, bc, dev):
    """The corner-table kernel against its plain version on a fused field of
    the flagship grid: byte-identical, in fp32 and in bf16."""
    import torch
    from vampire_tpu_torch.core.sampling import corner_table_reference
    from vampire_tpu_torch.ops import tables

    shape = (1 + bc.num_classes + 3,) + tuple(bc.grid_zyx('seg'))
    g = torch.Generator(device=dev).manual_seed(1)
    vol = torch.randn(shape, device=dev, generator=g)
    result = dict(max_abs_err=0.0)
    for dt in (torch.float32, torch.bfloat16):
        v = vol.to(dt)
        got = tables.corner_table(v)
        want = corner_table_reference(v)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        err = (got.float() - want.float()).abs().max().item()
        mb = got.numel() * got.element_size() / 1e6
        del got, want
        ms = cuda_ms(lambda: tables.corner_table(v), 20)
        plain = cuda_ms(lambda: corner_table_reference(v), 5)
        name = str(dt).replace('torch.', '')
        say(f'corner_table {name}: {shape} -> {mb:.0f} MB, byte-identical '
            f'{same}, max abs err {err:.3e}; kernel {ms:.4f} ms '
            f'({mb / ms:.0f} GB/s written), plain {plain:.4f} ms '
            f'[{card}]')
        if not same:
            raise AssertionError(f'corner_table kernel {name} is not '
                                 f'byte-identical to the plain version')
        result['max_abs_err'] = max(result['max_abs_err'], err)
        result[name] = dict(ms=ms, plain_ms=plain)
    return result


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
    a bf16 table of a synthetic fused field. The random-init field
    saturates every ray at its first sample (density bias sdf_bias - 10),
    so the sdf here is drawn around the density's knee instead, and the
    rays end partly opaque. Returns the sampler's arguments."""
    import torch
    from vampire_tpu_torch.configs import camera_rig
    from vampire_tpu_torch.core import geometry as G
    from vampire_tpu_torch.core import sampling as S
    from vampire_tpu_torch.models.field import ray_inputs

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
    table = S.build_neighborhood_table(vol)
    beta = torch.tensor(0.1, device=dev)

    opacity, partial = ray_opacity(sdf_along_rays(vol[:1], coords, valid),
                                   delta, bc, beta)
    q = torch.quantile(opacity, torch.tensor([0.05, 0.5, 0.95], device=dev))
    say(f'rays: {Rn} rays x {Sn} samples, table {tuple(table.shape)} bf16; '
        f'valid samples {valid.mean().item():.3f}; ray opacity p5/p50/p95 '
        f'{q[0].item():.3f}/{q[1].item():.3f}/{q[2].item():.3f}, '
        f'{partial:.3f} of rays in (0.05, 0.95)')
    if partial < RAY_PARTIAL_MIN:
        raise AssertionError(f'only {partial:.3f} of the rays end partly '
                             f'opaque; the check would be degenerate')
    return (table, vol_shape, coords, valid, delta, mids, bc.d_bound[1],
            bc.density_mode, beta, bc.sdf_bias)


def ray_check(card, bc, dev, args):
    """The ray kernel against its plain version on `ray_field`."""
    import torch
    from vampire_tpu_torch.core import rendering as R
    from vampire_tpu_torch.ops import rays

    K = bc.num_classes
    got = rays.sample_and_composite_rays(*args)
    want = R.sample_and_composite_rays_reference(*args)
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
        lambda: R.sample_and_composite_rays_reference(*args), 5)
    say(f'rays bf16: kernel {result["ms"]:.4f} ms, plain '
        f'{result["plain_ms"]:.4f} ms per frame [{card}]')
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
    """The lift backward kernel against its plain version, per camera,
    from a random d numer (G, Q, C) fp32, in fp32 and bf16."""
    import torch
    from vampire_tpu_torch.ops import lift

    dev = torch.device(dev)
    depth, feat, cams, G, Q, C, K, _ = lift_cameras(bc, dev)
    g = torch.randn(G, Q, C, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    result = dict(max_abs_err=0.0)
    for dt in (torch.float32, torch.bfloat16):
        dep, fea = depth.to(dt), feat.to(dt)
        name = str(dt).replace('torch.', '')
        for n, (ids, cc, vv) in enumerate(cams):
            got = lift.lift_backward(dep[n], fea[n], ids, cc, vv, g)
            want = lift.lift_backward_reference(dep[n], fea[n], ids, cc, vv,
                                                g)
            torch.cuda.synchronize()
            for what, a, b in (('d depth', got[0], want[0]),
                               ('d feat', got[1], want[1])):
                err = check_grad(f'lift_bwd {name} camera {n} {what}', a, b,
                                 BWD_RTOL)
                result['max_abs_err'] = max(result['max_abs_err'], err)
        ids, cc, vv = cams[1]
        ms = cuda_ms(lambda: lift.lift_backward(dep[1], fea[1], ids, cc, vv,
                                                g), 20)
        plain = cuda_ms(lambda: lift.lift_backward_reference(
            dep[1], fea[1], ids, cc, vv, g), 5)
        say(f'lift_bwd {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms per '
            f'camera [{card}]')
        result[name] = dict(ms=ms, plain_ms=plain)
    return result


def table_bwd_check(card, bc, dev):
    """The corner-table backward kernel against its plain version from a
    random (21, 257, 257, 176) cotangent in fp32 and bf16: byte-identical
    (no atomics, the plain version's summation order)."""
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
        del got, want
        ms = cuda_ms(lambda: tables.corner_table_backward(g, shape), 20)
        plain = cuda_ms(lambda: tables.corner_table_backward_reference(
            g, shape), 5)
        name = str(dt).replace('torch.', '')
        say(f'corner_table_bwd {name}: {mb:.0f} MB cotangent -> {shape} '
            f'fp32, byte-identical {same}, max abs err {err:.3e}; kernel '
            f'{ms:.4f} ms ({mb / ms:.0f} GB/s read), plain {plain:.4f} ms '
            f'[{card}]')
        if not same:
            raise AssertionError(f'corner_table backward kernel {name} is '
                                 f'not byte-identical to the plain version')
        result['max_abs_err'] = max(result['max_abs_err'], err)
        result[name] = dict(ms=ms, plain_ms=plain)
    del g32
    return result


def ray_bwd_check(card, bc, dev, args):
    """The ray backward kernel against its plain version on `ray_field`,
    from a random d out over all rays: d table and d beta."""
    import torch
    from vampire_tpu_torch.core import rendering as R
    from vampire_tpu_torch.ops import rays

    out = rays.sample_and_composite_rays(*args)
    gen = torch.Generator(device=out.device).manual_seed(5)
    g = torch.randn(out.shape, device=out.device, generator=gen)
    g[:, -1] *= 0.05               # depth is ~30x the other outputs
    got = rays.sample_and_composite_rays_backward(*args, out, g)
    want = R.sample_and_composite_rays_backward_reference(*args, g)
    torch.cuda.synchronize()
    err = check_grad('rays_bwd d table', got[0], want[0], BWD_RTOL)
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
    plain = cuda_ms(lambda: R.sample_and_composite_rays_backward_reference(
        *args, g), 3)
    say(f'rays_bwd bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms per frame '
        f'[{card}]')
    return dict(max_abs_err=err, ms=ms, plain_ms=plain)


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


def calibrate_batchnorm_(server, frame):
    """Set every BatchNorm's running statistics to the batch statistics of
    one synthetic frame (one train-mode forward of the graph the server
    serves, momentum 1).

    Seeded random weights leave BN the identity, so activations grow
    through the residual stacks (~3x in variance per bottleneck) until the
    heads saturate: sigmoid scores of exactly 1 and exp(dim) overflowing.
    Calibrated statistics keep every layer in its working range, as a
    trained model's would.
    """
    import torch
    bns = [m for m in server.model.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.momentum = 1.0
    imgs, mats, points = server.to_device({k: v[None]
                                           for k, v in frame.items()})
    server.model.train()
    for m in bns:       # the frozen stem's BN too, which train() leaves out
        m.train()
    with torch.no_grad():
        server.model(imgs, mats, points=points,
                     camera_renders=server.camera_renders)
    server.model.eval()
    say(f'calibrated {len(bns)} BatchNorm layers on one synthetic frame')


def serve_path(card, server, calib, samples, label):
    """Calibrate, start and warm `server`, then serve `samples` with every
    launch count set to 0 just before; returns (outputs, launch counts)."""
    import torch
    t0 = time.perf_counter()
    calibrate_batchnorm_(server, calib)
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
                   dict(lift=N, corner_table=0, rays=0))
    check_outputs('metrics', outs, metric, cfg)
    check_against_plain('metrics', server, samples[0], outs[0], metric)
    del server, outs
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    # the full-render graph: one corner table and one ray launch per frame
    server = InferenceServer(cfg, device=dev, dtype=torch.bfloat16,
                             outputs=None, seed=0)
    outs, launched['full'] = serve_path(card, server, calib, samples,
                                        'full-render')
    check_launches('full-render', launched['full'],
                   dict(lift=N, corner_table=1, rays=1))
    check_outputs('full-render', outs,
                  dict(metric, depth_preds=(N, H, W), seg_preds=(N, H, W),
                       bev_seg=(Yd, Xd)), cfg)
    check_against_plain('full-render', server, samples[0], outs[0], metric,
                        ('rgb_preds', 'seg_logits_preds', 'depth_preds'))
    return launched


@contextlib.contextmanager
def plain_backwards():
    """The three backward wrappers swapped for their plain versions while
    the forward kernels stay: the model's `plain` switches both."""
    from vampire_tpu_torch.core import rendering as R
    from vampire_tpu_torch.ops import lift, rays, tables

    def rays_ref(*args):            # the plain version takes no saved `out`
        return R.sample_and_composite_rays_backward_reference(*args[:-2],
                                                              args[-1])
    swaps = ((lift, 'lift_backward', lift.lift_backward_reference),
             (tables, 'corner_table_backward',
              tables.corner_table_backward_reference),
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
    want = dict(lift=6, corner_table=1, rays=1, lift_bwd=6,
                corner_table_bwd=1, rays_bwd=1)
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
    leaked = [m for m in ('jax', 'flax', 'optax') if m in sys.modules]
    if leaked:
        raise AssertionError(f'the port imported {leaked}')
    csrc = 'vampire_tpu_torch/csrc'
    print(json.dumps({'kernels': [{
        'name': 'lift_accumulate',
        'route': 'cuda',
        'source': f'{csrc}/lift.cu',
        'replaces': 'vampire_tpu/ops/pallas_tables.py:289',
        'also_replaces': 'vampire_tpu/ops/pallas_gather.py:68',
        'launches': launched['lift'],
        'train_launches': tl['lift'],
        'max_abs_err': k['lift']['max_abs_err'],
        'ms': k['lift']['bfloat16']['ms'],
        'plain_ms': k['lift']['bfloat16']['plain_ms'],
        'fp32_ms': k['lift']['float32']['ms'],
        'fp32_plain_ms': k['lift']['float32']['plain_ms'],
    }, {
        'name': 'corner_table',
        'route': 'cuda',
        'source': f'{csrc}/corner_table.cu',
        'replaces': 'vampire_tpu/ops/pallas_tables.py:73',
        'launches': launched['corner_table'],
        'train_launches': tl['corner_table'],
        'max_abs_err': k['corner_table']['max_abs_err'],
        'ms': k['corner_table']['bfloat16']['ms'],
        'plain_ms': k['corner_table']['bfloat16']['plain_ms'],
        'fp32_ms': k['corner_table']['float32']['ms'],
        'fp32_plain_ms': k['corner_table']['float32']['plain_ms'],
    }, {
        'name': 'sample_and_composite_rays',
        'route': 'cuda',
        'source': f'{csrc}/rays.cu',
        'replaces': 'vampire_tpu/core/rendering.py:100',
        'launches': launched['rays'],
        'train_launches': tl['rays'],
        'max_abs_err': k['rays']['max_abs_err'],
        'ms': k['rays']['ms'],
        'plain_ms': k['rays']['plain_ms'],
    }, {
        'name': 'lift_backward',
        'route': 'cuda',
        'source': f'{csrc}/lift.cu',
        'replaces': 'vampire_tpu/ops/pallas_tables.py:374',
        'launches': tl['lift_bwd'],
        'max_abs_err': k['lift_bwd']['max_abs_err'],
        'ms': k['lift_bwd']['bfloat16']['ms'],
        'plain_ms': k['lift_bwd']['bfloat16']['plain_ms'],
        'fp32_ms': k['lift_bwd']['float32']['ms'],
        'fp32_plain_ms': k['lift_bwd']['float32']['plain_ms'],
    }, {
        'name': 'corner_table_backward',
        'route': 'cuda',
        'source': f'{csrc}/corner_table.cu',
        'replaces': 'vampire_tpu/ops/pallas_tables.py:214',
        'launches': tl['corner_table_bwd'],
        'max_abs_err': k['corner_table_bwd']['max_abs_err'],
        'ms': k['corner_table_bwd']['bfloat16']['ms'],
        'plain_ms': k['corner_table_bwd']['bfloat16']['plain_ms'],
        'fp32_ms': k['corner_table_bwd']['float32']['ms'],
        'fp32_plain_ms': k['corner_table_bwd']['float32']['plain_ms'],
    }, {
        'name': 'sample_and_composite_rays_backward',
        'route': 'cuda',
        'source': f'{csrc}/rays.cu',
        'replaces': 'vampire_tpu/core/rendering.py:155',
        'launches': tl['rays_bwd'],
        'max_abs_err': k['rays_bwd']['max_abs_err'],
        'ms': k['rays_bwd']['ms'],
        'plain_ms': k['rays_bwd']['plain_ms'],
    }], 'train_step_ms': train['step_ms'],
        'train_peak_gb': train['peak_gb']}), flush=True)
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    sys.path.insert(0, ROOT)
    main()
