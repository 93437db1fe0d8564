"""The configuration of the flagship VAMPIRE model, as typed dataclasses.

The port's own copy of the JAX package's `vampire_tpu/configs.py`: the same
classes, fields and defaults, so that `dataclasses.asdict` of either
package's `flagship_config()` or `ablation_config(name)` is the same dict
(tests/test_torch_host.py, tests/test_torch_cli.py).
The port reads these fields only, and never checks a config's class, so
the JAX package's config instances work in it too. Several fields are knobs
of the JAX package's TPU lowering (`lift_sampler`, `lift_chunk`,
`table_pad_channels`, the compact and early-terminating ray samplers); the
port keeps them so that the configs stay equal, and ignores or rejects them
as its modules say.

`camera_rig`, `synthetic_batch` and `tiny_config` live in
`data/synthetic.py` and are re-exported here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

# image / augmentation (the reference's base_exp.py:29-38, 93-120)
H, W = 900, 1600
FINAL_DIM: Tuple[int, int] = (256, 704)
RESIZE_LIM: Tuple[float, float] = (0.386, 0.55)
SAMPLE_FACTOR = 4

IMG_MEAN = (123.675, 116.28, 103.53)  # RGB order after BGR->RGB (to_rgb=True)
IMG_STD = (58.395, 57.12, 57.375)

CAM_NAMES = (
    'CAM_FRONT_LEFT', 'CAM_FRONT', 'CAM_FRONT_RIGHT',
    'CAM_BACK_LEFT', 'CAM_BACK', 'CAM_BACK_RIGHT',
)


@dataclasses.dataclass(frozen=True)
class IdaAugConfig:
    """Image-space data augmentation."""
    resize_lim: Tuple[float, float] = RESIZE_LIM
    final_dim: Tuple[int, int] = FINAL_DIM
    rot_lim: Tuple[float, float] = (0.0, 0.0)
    H: int = H
    W: int = W
    rand_flip: bool = False
    bot_pct_lim: Tuple[float, float] = (0.0, 0.0)
    cams: Tuple[str, ...] = CAM_NAMES
    n_cams: int = 6


@dataclasses.dataclass(frozen=True)
class BdaAugConfig:
    """BEV-space data augmentation."""
    rot_lim: Tuple[float, float] = (0.0, 0.0)
    scale_lim: Tuple[float, float] = (1.0, 1.0)
    flip_dx_ratio: float = 0.0
    flip_dy_ratio: float = 0.0


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """The image -> field backbone (the reference's backbone_conf)."""
    x_bound_seg: Tuple[float, float, float] = (-51.2, 51.2, 0.4)
    y_bound_seg: Tuple[float, float, float] = (-51.2, 51.2, 0.4)
    z_bound_seg: Tuple[float, float, float] = (-5.0, 3.0, 0.4)
    x_bound_det: Tuple[float, float, float] = (-51.2, 51.2, 0.4)
    y_bound_det: Tuple[float, float, float] = (-51.2, 51.2, 0.4)
    z_bound_det: Tuple[float, float, float] = (-1.0, 3.0, 0.4)
    d_bound: Tuple[float, float, float] = (2.0, 70.4, 0.8)
    final_dim: Tuple[int, int] = FINAL_DIM
    density_mode: str = 'sdf'       # 'sdf' -> Laplace density, 'naive' -> sigmoid
    sdf_bias: float = -1.0
    cat_pos: bool = True
    cat_seg: bool = False
    mid_channels: int = 16
    output_channels: int = 80
    downsample_factor: int = SAMPLE_FACTOR
    upsample_factor: int = SAMPLE_FACTOR
    num_classes: int = 18           # semantic classes incl. 'other'(0) and 'free'(17)
    # image backbone: ResNet-50, out_indices [0,1,2,3]
    img_backbone_depth: int = 50
    img_backbone_out_indices: Tuple[int, ...] = (0, 1, 2, 3)
    # image neck: SECONDFPN
    img_neck_in_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    img_neck_upsample_strides: Tuple[float, ...] = (0.5, 1, 2, 4)
    img_neck_out_channels: Tuple[int, ...] = (128, 128, 128, 128)
    # which field backbone: 'vampire2' | 'lss' | 'lss_inpaintor' | 'bilinear'
    variant: str = 'vampire2'
    # Occ3D grid
    occ_pc_range: Tuple[float, ...] = (-40.0, -40.0, -1.0, 40.0, 40.0, 5.4)
    occ_voxel_size: Tuple[float, float, float] = (0.4, 0.4, 0.4)
    occ_grid: Tuple[int, int, int] = (200, 200, 16)
    # block-compacted lift: each camera lifts only its top-K live 8x8 (Y, X)
    # voxel blocks (at most 208 of 1024 hold a valid query over the camera
    # rigs and bda range the JAX package's tests/test_lift.py measures, so
    # K = 264 keeps a 1.27x margin); 0 = the dense lift
    lift_block: int = 8
    lift_block_topk: int = 264
    # the JAX package's lift table keying ('fused' | 'pixtab' | 'auto') and
    # gather chunk; the port's lift kernel builds no table and reads neither
    lift_sampler: str = 'fused'
    lift_chunk: int = 0
    # the JAX package's lane padding of the fused corner-table rows; 0 = off
    table_pad_channels: int = 0
    # the JAX package's length-sorted compact ray sampler (train mode):
    # per-pass shares of the sorted rays; empty = the dense sampler
    # (core/rendering.py `compact_valid`). ray_remat changes nothing here:
    # in JAX it trades memory for a re-gather in the backward, bit-identical
    # in value and gradient either way (tests/test_rendering.py), and the
    # port's backward kernel keeps no per-sample residuals to trade
    ray_remat: bool = False
    ray_chunk: int = 8
    ray_pass_fracs: Tuple[float, ...] = (
        1.0, 1.0, 1.0, 0.98, 0.76, 0.62, 0.51, 0.43, 0.23, 0.11, 0.04)
    # the JAX package's opt-in early-terminating ray sampler (eval mode;
    # ops/rays.py `render_rays_earlyterm`); empty fracs = the dense sampler
    ray_et_chunk: int = 12
    ray_et_prefix: int = 2
    ray_et_fracs: Tuple[float, ...] = ()
    ray_et_tau: float = 7.0

    @property
    def img_out_channels(self) -> int:
        return sum(self.img_neck_out_channels)

    @property
    def depth_channels(self) -> int:
        """Number of frustum depth planes D (86 for d_bound (2.0, 70.4, 0.8))."""
        lo, hi, step = self.d_bound
        return int(math.ceil((hi - lo) / step - 1e-9))

    @property
    def feat_hw(self) -> Tuple[int, int]:
        """Frustum / render grid resolution (final_dim // downsample_factor)."""
        return (self.final_dim[0] // self.downsample_factor,
                self.final_dim[1] // self.downsample_factor)

    def grid_zyx(self, which: str = 'seg') -> Tuple[int, int, int]:
        xb, yb, zb = ((self.x_bound_seg, self.y_bound_seg, self.z_bound_seg)
                      if which == 'seg' else
                      (self.x_bound_det, self.y_bound_det, self.z_bound_det))

        def n(b):
            return int(round((b[1] - b[0]) / b[2]))
        return (n(zb), n(yb), n(xb))


DET_CLASSES: Tuple[str, ...] = (
    'car', 'truck', 'construction_vehicle', 'bus', 'trailer', 'barrier',
    'motorcycle', 'bicycle', 'pedestrian', 'traffic_cone',
)

DET_TASKS: Tuple[Tuple[str, ...], ...] = (
    ('car',),
    ('truck', 'construction_vehicle'),
    ('bus', 'trailer'),
    ('barrier',),
    ('motorcycle', 'bicycle'),
    ('pedestrian', 'traffic_cone'),
)


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    """The CenterPoint-style detection head (the reference's head_conf)."""
    in_channels: int = 256
    tasks: Tuple[Tuple[str, ...], ...] = DET_TASKS
    # common_heads: name -> (out_channels, num_conv)
    common_heads: Tuple[Tuple[str, Tuple[int, int]], ...] = (
        ('reg', (2, 2)), ('height', (1, 2)), ('dim', (3, 2)),
        ('rot', (2, 2)), ('vel', (2, 2)),
    )
    num_heatmap_convs: int = 2
    share_conv_channel: int = 64
    separate_head_init_bias: float = -2.19
    separate_head_final_kernel: int = 3
    norm_bbox: bool = True
    # bev trunk: ResNet-18-ish, in 80ch, base 160, 3 stages
    bev_backbone_in_channels: int = 80
    bev_backbone_depth: int = 18
    bev_backbone_num_stages: int = 3
    bev_backbone_strides: Tuple[int, ...] = (1, 2, 2)
    bev_backbone_base_channels: int = 160
    bev_backbone_out_indices: Tuple[int, ...] = (0, 1, 2)
    # bev neck: SECONDFPN over [input] + stage outs
    bev_neck_in_channels: Tuple[int, ...] = (80, 160, 320, 640)
    bev_neck_upsample_strides: Tuple[float, ...] = (1, 2, 4, 8)
    bev_neck_out_channels: Tuple[int, ...] = (64, 64, 64, 64)
    # bbox coder
    post_center_range: Tuple[float, ...] = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)
    max_num: int = 500
    score_threshold: float = 0.1
    out_size_factor: int = 4
    voxel_size: Tuple[float, float, float] = (0.2, 0.2, 8.0)
    pc_range: Tuple[float, ...] = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    code_size: int = 9
    # train cfg
    grid_size: Tuple[int, int, int] = (512, 512, 1)
    gaussian_overlap: float = 0.1
    max_objs: int = 500
    min_radius: int = 2
    code_weights: Tuple[float, ...] = (1., 1., 1., 1., 1., 1., 1., 1., 0.5, 0.5)
    loss_bbox_weight: float = 0.25
    # test cfg
    nms_type: str = 'circle'
    nms_min_radius: Tuple[float, ...] = (4, 12, 10, 1, 0.85, 0.175)
    nms_pre_max_size: int = 1000
    nms_post_max_size: int = 83
    nms_thr: float = 0.2

    @property
    def task_num_classes(self) -> Tuple[int, ...]:
        return tuple(len(t) for t in self.tasks)

    @property
    def feature_map_size(self) -> Tuple[int, int]:
        return (self.grid_size[0] // self.out_size_factor,
                self.grid_size[1] // self.out_size_factor)


LABEL_17_NAMES: Tuple[str, ...] = (
    'other', 'barrier', 'bicycle', 'bus', 'car', 'construction_vehicle',
    'motorcycle', 'pedestrian', 'traffic_cone', 'trailer', 'truck',
    'driveable_surface', 'other_flat', 'sidewalk', 'terrain', 'manmade',
    'vegetation', 'free',
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    exp_name: str = 'vampire2_r50_256x704_24e_lss_inpaintor_depth_semantic'
    # task weights [occ, lidarseg, detection]
    task_weights: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    # loss weights [depth, seg, rgb, sdf, density]; flagship = (1,1,0,0,0)
    loss_weights: Tuple[float, float, float, float, float] = (1.0, 1.0, 0.0, 0.0, 0.0)
    data_root: str = 'data/nuScenes'
    nusc_version: str = 'v1.0-trainval'
    batch_size_per_device: int = 8
    num_devices: int = 1
    basic_lr_per_img: float = 2e-4 / 8
    weight_decay: float = 1e-7
    max_epochs: int = 24
    lr_milestones: Tuple[int, ...] = (19, 23)
    lr_gamma: float = 0.1
    gradient_clip_val: float = 35.0
    check_val_every_n_epoch: int = 4
    use_ema: bool = False
    ema_decay: float = 0.9999
    seed: int = 0
    # compute dtype of the conv stacks; geometry, rendering, losses and the
    # det head stay fp32
    compute_dtype: str = 'bfloat16'
    # padded lidar points per sample
    max_points: int = 36864
    # max GT boxes per sample after padding
    max_gt_boxes: int = 500
    # checkpoints kept: 0 = every epoch, N > 0 = the last N
    keep_checkpoints: int = 3
    # path to torchvision ResNet weights for the image backbone; '' = random
    pretrained_backbone: str = ''
    # temporal sweep-frame indexes (multi-frame batches); () = key frame only
    sweep_idxes: Tuple[int, ...] = ()

    @property
    def lr(self) -> float:
        return self.basic_lr_per_img * self.batch_size_per_device * self.num_devices


@dataclasses.dataclass(frozen=True)
class VampireConfig:
    """Top-level bundle: model + head + aug + training."""
    backbone: BackboneConfig = BackboneConfig()
    head: HeadConfig = HeadConfig()
    ida_aug: IdaAugConfig = IdaAugConfig()
    bda_aug: BdaAugConfig = BdaAugConfig()
    train: TrainConfig = TrainConfig()


def flagship_config() -> VampireConfig:
    """The flagship lss_inpaintor + depth + semantic experiment
    (`vampire2_r50_256x704_24e_lss_inpaintor_depth_semantic`)."""
    return VampireConfig(
        backbone=BackboneConfig(variant='lss_inpaintor'),
        train=TrainConfig(loss_weights=(1.0, 1.0, 0.0, 0.0, 0.0)),
    )


def ablation_config(name: str) -> VampireConfig:
    """The reference's ablation experiments
    (src/exps/nuscenes/ablation/*.py): the bilinear, lss and
    lss_inpaintor field variants and the depth and semantic loss terms.
    The port's `FieldBackbone` builds every one."""
    presets: Dict[str, Tuple[str, Tuple[float, ...]]] = {
        'bilinear': ('bilinear', (0., 0., 0., 0., 0.)),
        'lss': ('lss', (0., 0., 0., 0., 0.)),
        'lss_inpaintor': ('lss_inpaintor', (0., 0., 0., 0., 0.)),
        'lss_inpaintor_depth': ('lss_inpaintor', (1., 0., 0., 0., 0.)),
        'lss_inpaintor_depth_semantic': ('lss_inpaintor', (1., 1., 0., 0., 0.)),
        'vampire2': ('vampire2', (1., 1., 0., 0., 0.)),
    }
    variant, weights = presets[name]
    return VampireConfig(
        backbone=BackboneConfig(variant=variant),
        train=TrainConfig(exp_name=f'vampire2_r50_256x704_24e_{name}',
                          loss_weights=tuple(weights)),
    )


_SYNTHETIC = ('camera_rig', 'synthetic_batch', 'tiny_config')


def __getattr__(name):
    """`camera_rig`, `synthetic_batch` and `tiny_config` of
    `data/synthetic.py`, imported on first use: that module imports this
    one, so either can be the first a process imports."""
    if name in _SYNTHETIC:
        from .data import synthetic
        return getattr(synthetic, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
