"""Variants of the depth-less lift kernels, built side by side and timed on
`chip_smoke.py`'s bilinear frame in one process.

    python vampire_tpu_torch/tools/lift_variants.py \
        '{"base": {}, "rounds2": {"kBilRounds": 2}, "bins512": {"kMaxBins": 512}}'

Run from the root of a checkout on a CUDA card. Each variant is a copy of
`vampire_tpu_torch/csrc/lift.cu` with the named `constexpr int` constants
set to the given values (`{}`: the source as it is), compiled by nvcc with
the package's flags under `build/lift_variants/<name>/` (all variants at
once) and loaded with ctypes. On the flagship frame of the bilinear
variant (`chip_smoke.lift_cameras`: 6 cameras, K = 264 of G = 1,024
blocks, Q = 1,280, C = 16) each variant's forward (the slot map and the
forward, one call) and its backward (d feat zeroed before each call; the
zeroing, timed alone, is subtracted) are timed in bf16 and fp32 with
`tools/lift_bilinear.batched_ms` and checked against the plain versions:
the forward's max abs error and denominator mismatches, the backward's
error relative to the largest d feat, and the count of CTAs on the direct
route. One line a variant and dtype, and a JSON object of all of them
last.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys


def build(variants, src_path='vampire_tpu_torch/csrc/lift.cu'):
    """{name: loaded library}: each variant's copy of lift.cu compiled,
    all nvcc processes started together."""
    from vampire_tpu_torch.ops import _build
    src = open(src_path).read()
    nvcc = _build.find_nvcc()
    procs = {}
    for name, subs in variants.items():
        text = src
        for k, v in subs.items():
            text, n = re.subn(rf'constexpr int {k} = \d+;',
                              f'constexpr int {k} = {v};', text)
            if n != 1:
                raise SystemExit(f'{name}: no constant {k} in {src_path}')
        d = os.path.join('build', 'lift_variants', name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, 'lift.cu'), 'w') as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, '-o', os.path.join(d, 'lift.so'),
             os.path.join(d, 'lift.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            print(log)
            raise SystemExit(f'{name}: nvcc failed')
        libs[name] = ctypes.CDLL(os.path.abspath(
            os.path.join('build', 'lift_variants', name, 'lift.so')))
    return libs


def main():
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('lift_variants: no CUDA card')
    import chip_smoke as cs
    from vampire_tpu_torch.configs import flagship_config
    from vampire_tpu_torch.ops import lift
    from vampire_tpu_torch.tools.lift_bilinear import batched_ms
    libs = build(json.loads(sys.argv[1]))
    card = cs.device_phase()
    bc = dataclasses.replace(flagship_config().backbone, variant='bilinear')
    (_, feat, ids, coords, valid), (G, Q, C, K, _) = cs.lift_cameras(bc,
                                                                     'cuda')
    g = torch.randn(G, Q, C, device='cuda',
                    generator=torch.Generator(device='cuda').manual_seed(3))
    N, H, W = feat.shape[:3]

    def stream():
        return torch._C._cuda_getCurrentRawStream(0)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        fea = feat.to(dt)
        want = lift.bilinear_lift_frame_accumulate_reference(
            fea, ids, coords, valid, G)
        want_d = lift.bilinear_lift_frame_backward_reference(
            fea, ids, coords, valid, g)
        for name, lib in libs.items():
            fwd_fn = getattr(lib, 'lift_bilinear_' + (
                'bf16' if dt == torch.bfloat16 else 'f32'))
            fwd_fn.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
            bwd_fn = lib.lift_bilinear_backward
            bwd_fn.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
            numer = torch.empty((G, Q, C), device='cuda')
            denom = torch.empty_like(numer)
            slots = torch.empty((N, G), dtype=torch.int32, device='cuda')
            d_feat = torch.zeros((N, H, W, C), device='cuda')
            routes = torch.empty((N, K), dtype=torch.int32, device='cuda')

            def fwd():
                return fwd_fn(fea.data_ptr(), ids.data_ptr(),
                              slots.data_ptr(), coords.data_ptr(),
                              valid.data_ptr(),
                              numer.data_ptr(), denom.data_ptr(), N, H, W, C,
                              K, Q, G, stream())

            def bwd():
                d_feat.zero_()
                return bwd_fn(ids.data_ptr(), coords.data_ptr(),
                              valid.data_ptr(), g.data_ptr(),
                              d_feat.data_ptr(), routes.data_ptr(), N, H, W,
                              C, K, Q, G, stream())
            if fwd() != 0 or bwd() != 0:
                raise SystemExit(f'{name}: launch failed')
            torch.cuda.synchronize()
            zero_ms = batched_ms(d_feat.zero_)
            r = dict(fwd_ms=batched_ms(fwd), bwd_ms=batched_ms(bwd) - zero_ms,
                     zero_ms=zero_ms,
                     fwd_err=(numer - want[0]).abs().max().item(),
                     denom_mismatches=int((denom != want[1]).sum()),
                     bwd_rel_err=((d_feat - want_d).abs().max()
                                  / want_d.abs().max()).item(),
                     direct_ctas=int((routes == lift.ROUTE_DIRECT).sum()))
            key = f'{name} {str(dt).replace("torch.", "")}'
            res[key] = r
            print(key, json.dumps(r), card, flush=True)
    print(json.dumps(dict(card=card, variants=res)), flush=True)


if __name__ == '__main__':
    main()
