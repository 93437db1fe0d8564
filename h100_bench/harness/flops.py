"""The model's convolutions counted from the configuration's published
shapes, and the least time the card needs for them at its published
peaks: the whole step's yardstick (`device.mfu.*`).

The count walks the architecture the configuration names: ResNet image
backbone and SECONDFPN neck on N x H x W, `mapping_along_depth` (not in
the `bilinear` variant) and `channel_lower`, the Unet3D trunk
(`lss_inpaintor`, `vampire2`) or the one-conv `ConvSoftplus3D` (`lss`,
`bilinear`, which also has `feature_conv`), the density, seg and rgb 3D
heads, `voxel_output`, and the detection head: its ResNet trunk (stride-2
stem, no maxpool), SECONDFPN neck, shared conv and one SeparateHead a task
group. It never reads the program's modules, so a change to them cannot
move it. A multiply-add counts two operations; a train step counts three
forwards.

Each part is charged at the peak of the dtype the configuration runs it
in: the conv stacks at `compute_dtype` (bf16: 989 TFLOP/s), the
detection head and `voxel_output` in fp32 at 67 TFLOP/s (TF32 off)."""
from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA's data sheet, H100 SXM, dense
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
HBM_BYTES_PER_S = 3.35e12

SEPARATE_HEAD_CONV = 64     # SeparateHead's head_conv, fixed in the model


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def _conv2d(name, cin, cout, k, s, hw, rows, p=None):
    p = k // 2 if p is None else p
    oh, ow = _out(hw[0], k, s, p), _out(hw[1], k, s, p)
    return (name, 2 * cin * cout * k * k * oh * ow * rows), (oh, ow)


def resnet(prefix, depth, cin, base, strides, num_stages, hw, rows,
           maxpool) -> Tuple[List, List]:
    """The convs of the program's mmdet-style ResNet (pytorch-style
    bottleneck, stride in the 3x3) and its per-stage outputs
    [(channels, hw)]."""
    blocks = {10: ('basic', (1, 1, 1, 1)), 18: ('basic', (2, 2, 2, 2)),
              34: ('basic', (3, 4, 6, 3)), 50: ('bottle', (3, 4, 6, 3)),
              101: ('bottle', (3, 4, 23, 3))}[depth]
    kind, counts = blocks
    exp = 4 if kind == 'bottle' else 1
    convs = []
    c, hw = _conv2d(f'{prefix}.stem', cin, base, 7, 2, hw, rows)
    convs.append(c)
    if maxpool:
        hw = (_out(hw[0], 3, 2, 1), _out(hw[1], 3, 2, 1))
    ch = base
    outs = []
    for i in range(num_stages):
        planes = base * 2 ** i
        for j in range(counts[i]):
            s = strides[i] if j == 0 else 1
            name = f'{prefix}.layer{i + 1}_{j}'
            if kind == 'bottle':
                c1, _ = _conv2d(name + '.conv1', ch, planes, 1, 1, hw, rows)
                c2, ohw = _conv2d(name + '.conv2', planes, planes, 3, s, hw,
                                  rows)
                c3, _ = _conv2d(name + '.conv3', planes, planes * 4, 1, 1,
                                ohw, rows)
                convs += [c1, c2, c3]
            else:
                c1, ohw = _conv2d(name + '.conv1', ch, planes, 3, s, hw,
                                  rows)
                c2, _ = _conv2d(name + '.conv2', planes, planes, 3, 1, ohw,
                                rows)
                convs += [c1, c2]
            if j == 0 and (s != 1 or ch != planes * exp):
                cd, _ = _conv2d(name + '.downsample', ch, planes * exp, 1, s,
                                hw, rows)
                convs.append(cd)
            ch, hw = planes * exp, ohw
        outs.append((ch, hw))
    return convs, outs


def secondfpn(prefix, ins, outs_ch, strides, rows):
    """SECONDFPN: a stride-s transposed conv (k = s) or, below 1, a
    stride-1/s conv (k = 1/s), each to its output channels."""
    convs, hws = [], []
    for i, ((cin, hw), cout, st) in enumerate(zip(ins, outs_ch, strides)):
        if st >= 1:
            s = int(st)
            convs.append((f'{prefix}.deblock{i}', 2 * cin * cout * s * s
                          * hw[0] * hw[1] * rows))
            hws.append((hw[0] * s, hw[1] * s))
        else:
            s = int(round(1.0 / st))
            c, ohw = _conv2d(f'{prefix}.deblock{i}', cin, cout, s, s, hw,
                             rows, p=0)
            convs.append(c)
            hws.append(ohw)
    return convs, hws[0]


def _conv3d(name, cin, cout, s, zyx, rows):
    o = tuple(_out(n, 3, s, 1) for n in zyx)
    return (name, 2 * cin * cout * 27 * o[0] * o[1] * o[2] * rows), o


def parts(cfg, rows: int = 1) -> Dict[str, Tuple[float, str]]:
    """{part: (forward operations for `rows` frames, its dtype)}."""
    bc, hc, tc = cfg.backbone, cfg.head, cfg.train
    dt = tc.compute_dtype
    N = cfg.ida_aug.n_cams
    views = rows * N
    H, W = bc.final_dim
    enc, stages = resnet('img_backbone', bc.img_backbone_depth, 3, 64,
                         (1, 2, 2, 2), 4, (H, W), views, True)
    picked = [stages[i] for i in bc.img_backbone_out_indices]
    neck, fhw = secondfpn('img_neck', picked, bc.img_neck_out_channels,
                          bc.img_neck_upsample_strides, views)
    cimg = sum(bc.img_neck_out_channels)
    lift = []
    if bc.variant != 'bilinear':
        lift.append(_conv2d('mapping_along_depth', cimg, bc.depth_channels,
                            3, 1, fhw, views)[0])
    lift.append(_conv2d('channel_lower', cimg, bc.mid_channels, 3, 1, fhw,
                        views)[0])
    Z, Y, X = bc.grid_zyx('seg')
    mid = bc.mid_channels
    cin = mid + (3 if bc.cat_pos else 0)
    trunk = []
    if bc.variant in ('vampire2', 'lss_inpaintor'):
        trunk.append(_conv3d('init_dres', cin, mid, 1, (Z, Y, X), rows)[0])
        m2 = 2 * mid
        for hg in ('hg1', 'hg2'):
            c1, z1 = _conv3d(hg + '.conv1', mid, m2, 2, (Z, Y, X), rows)
            c2, _ = _conv3d(hg + '.conv2', m2, m2, 1, z1, rows)
            c3, z3 = _conv3d(hg + '.conv3', m2, m2, 2, z1, rows)
            c4, _ = _conv3d(hg + '.conv4', m2, m2, 1, z3, rows)
            c5, _ = _conv3d(hg + '.conv5', m2, m2, 1, z1, rows)
            c6, _ = _conv3d(hg + '.conv6', m2, mid, 1, (Z, Y, X), rows)
            trunk += [c1, c2, c3, c4, c5, c6]
    else:
        trunk.append(_conv3d('base_conv', cin, mid, 1, (Z, Y, X), rows)[0])
    K = bc.num_classes
    heads3d = [_conv3d(n, mid, c, 1, (Z, Y, X), rows)[0]
               for n, c in (('density_conv', 1), ('seg_conv', K),
                            ('rgb_conv', 3))]
    if bc.variant == 'bilinear':
        heads3d.append(_conv3d('feature_conv', mid, mid, 1, (Z, Y, X),
                               rows)[0])
    Zd, Yd, Xd = bc.grid_zyx('det')
    cv = mid + (K if bc.cat_seg else 0)
    vox = [_conv2d('voxel_output', cv * Zd, bc.output_channels, 1, 1,
                   (Yd, Xd), rows)[0]]
    bhw = (Yd // 2, Xd // 2) if Yd == 256 else (Yd, Xd)
    det, dstages = resnet('head.trunk', hc.bev_backbone_depth,
                          hc.bev_backbone_in_channels,
                          hc.bev_backbone_base_channels,
                          hc.bev_backbone_strides,
                          hc.bev_backbone_num_stages, bhw, rows, False)
    dins = [(hc.bev_backbone_in_channels, bhw)] + [
        dstages[i] for i in hc.bev_backbone_out_indices]
    dneck, nhw = secondfpn('head.neck', dins, hc.bev_neck_out_channels,
                           hc.bev_neck_upsample_strides, rows)
    det += dneck
    det.append(_conv2d('head.shared_conv', sum(hc.bev_neck_out_channels),
                       hc.share_conv_channel, 3, 1, nhw, rows)[0])
    k = hc.separate_head_final_kernel
    for t, task in enumerate(hc.tasks):
        heads = tuple(hc.common_heads) + (('heatmap',
                                           (len(task),
                                            hc.num_heatmap_convs)),)
        for name, (classes, num_conv) in heads:
            c = hc.share_conv_channel
            for i in range(num_conv - 1):
                det.append(_conv2d(f'head.task{t}.{name}_conv{i}', c,
                                   SEPARATE_HEAD_CONV, k, 1, nhw, rows)[0])
                c = SEPARATE_HEAD_CONV
            det.append(_conv2d(f'head.task{t}.{name}_out', c, classes, k, 1,
                               nhw, rows)[0])

    def total(convs):
        return float(sum(f for _, f in convs))
    return {'encoder': (total(enc + neck), dt),
            'depth_and_lower': (total(lift), dt),
            'trunk3d': (total(trunk), dt),
            'heads3d': (total(heads3d), dt),
            'voxel_output': (total(vox), 'float32'),
            'det_head': (total(det), 'float32')}


def forward_ops(cfg, rows: int = 1) -> float:
    return sum(f for f, _ in parts(cfg, rows).values())


def least_seconds(cfg, rows: int = 1, train: bool = False) -> float:
    """The least time, s, for the convolutions of `rows` frames' forward
    (three forwards for a train step) at the published peaks."""
    t = sum(f / PEAK_FLOPS[d] for f, d in parts(cfg, rows).values())
    return 3.0 * t if train else t
