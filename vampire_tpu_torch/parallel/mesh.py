"""The dp x cam layout of the ranks; the port of
`vampire_tpu/parallel/mesh.py`.

The JAX package lays its devices out as a (dp, cam) mesh: `dp` shards the
batch, `cam` the six-camera axis of the encoder and the lift, whose sums
over the cameras (the masked mean's numerator and denominator) XLA turns
into an all-reduce. The port runs one process a device, so the mesh is a
layout of the ranks: rank r sits at (r // cam, r % cam), the JAX order
`np.asarray(devices).reshape(dp, cam)`. The `cam` ranks of one dp index
form a *cam group*: they hold the same rows and split the cameras. The
`dp` ranks of one cam index form a *dp group*: they hold different rows.

What each collective reduces over (`models/`, `training/losses.py`):
  * the world, for what every rank holds a different part of: the
    encoder's BatchNorm and the terms of the camera renders (depth, camera
    seg, rgb), and the gradients;
  * the cam group, for the lift's partial sums: `FieldBackbone.lift` adds
    the (numerator, denominator) of its cameras over the group, whose
    backward adds the field's cotangent over it;
  * the dp group, for what the ranks of a cam group hold alike, everything
    after the lift: the detection head's BatchNorm, the BEV, point,
    occupancy and detection terms, the confusions. Each rank counts such a
    term 1/cam times, so that the world's sum counts it once.

`default_layout` is the JAX `default_mesh` policy: cam = 2 when the world
is even and above 1, else 1. Without a process group the layout is 1 x 1
and every collective is the identity; a layout made without one for a
larger world (`make_layout(dp, cam, world, rank)`) describes that rank's
coordinates only, as the tests use it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch.distributed as dist

from . import distributed as D

# the leading-axis layout of a training batch (a copy of the JAX
# `_CAM_AXIS_KEYS`): these keys also split their camera axis. Value: the
# key's single-frame ndim (camera axis 1); a multi-sweep batch carries a
# frame axis at dim 1, which moves the camera axis to dim 2.
CAM_AXIS_KEYS = {'imgs': 5, 'sensor2ego': 4, 'intrin': 4, 'ida': 4,
                 'sensor2sensor': 4, 'depth_labels': 4, 'seg_labels': 4}


@dataclasses.dataclass(frozen=True)
class Layout:
    """One rank's place in a dp x cam layout, and its two groups.

    cam_group: the ranks of this rank's dp index (None where cam is 1).
    dp_group: the ranks of this rank's cam index; None means the world,
        which it is where cam is 1.
    """
    dp: int = 1
    cam: int = 1
    dp_index: int = 0
    cam_index: int = 0
    cam_group: Any = None
    dp_group: Any = None

    @property
    def size(self) -> int:
        return self.dp * self.cam

    @property
    def split_cameras(self) -> bool:
        """Whether this rank holds a part of each frame's cameras (and a
        cam group to sum the lift over)."""
        return self.cam > 1 and self.cam_group is not None


SINGLE = Layout()


def default_shape(world: int) -> Tuple[int, int]:
    """(dp, cam) of the JAX `default_mesh` for `world` devices."""
    cam = 2 if (world % 2 == 0 and world > 1) else 1
    return world // cam, cam


def coords(rank: int, cam: int) -> Tuple[int, int]:
    """(dp index, cam index) of `rank`: its place in
    `np.asarray(devices).reshape(dp, cam)`."""
    return rank // cam, rank % cam


def make_layout(dp: Optional[int] = None, cam: int = 1,
                world: Optional[int] = None,
                rank: Optional[int] = None) -> Layout:
    """This rank's layout of a dp x cam world (dp defaults to world // cam).

    In a process group, world and rank default to the group's and must be
    theirs; where cam > 1 this builds every cam group and every dp group,
    with `dist.new_group` on every rank in the same order, so every rank
    calls it at the same point. Without a group the layout carries the
    coordinates only."""
    world = D.world_size() if world is None else world
    rank = D.rank() if rank is None else rank
    dp = world // cam if dp is None else dp
    if cam < 1 or dp < 1 or dp * cam != world:
        raise ValueError(f'a {dp} x {cam} layout of {world} ranks')
    if D.active() and (world, rank) != (D.world_size(), D.rank()):
        raise ValueError(f'rank {rank} of {world} in a group where this is '
                         f'rank {D.rank()} of {D.world_size()}')
    d, c = coords(rank, cam)
    cam_group = dp_group = None
    if D.active() and cam > 1:
        cam_groups = [dist.new_group([i * cam + j for j in range(cam)])
                      for i in range(dp)]
        dp_groups = [dist.new_group([i * cam + j for i in range(dp)])
                     for j in range(cam)]
        cam_group, dp_group = cam_groups[d], dp_groups[c]
    return Layout(dp, cam, d, c, cam_group, dp_group)


def default_layout(world: Optional[int] = None) -> Layout:
    """`make_layout` at the JAX `default_mesh` shape of the world."""
    world = D.world_size() if world is None else world
    dp, cam = default_shape(world)
    return make_layout(dp, cam, world)


def camera_axis(key: str, ndim: int) -> Optional[int]:
    """The camera axis of a batch entry (`batch_pspecs`' rule), or None."""
    base = CAM_AXIS_KEYS.get(key)
    if base is not None and ndim == base:
        return 1
    if base is not None and ndim == base + 1:
        return 2
    return None


def shard_batch(batch: Dict[str, Any], layout: Layout) -> Dict[str, Any]:
    """This rank's batch: its slice of the camera axis of each key of
    `CAM_AXIS_KEYS`; the rest as given (the loader gives the rank the rows
    of its dp index). Numpy arrays or tensors; slices are views."""
    if layout.cam == 1:
        return batch
    out = {}
    for k, v in batch.items():
        ax = camera_axis(k, getattr(v, 'ndim', -1))
        if ax is not None:
            n = v.shape[ax]
            if n % layout.cam:
                raise ValueError(f'{k}: {n} cameras over cam = {layout.cam}')
            per = n // layout.cam
            i = layout.cam_index * per
            v = v[(slice(None),) * ax + (slice(i, i + per),)]
        out[k] = v
    return out


def ray_split(layout: Layout) -> Optional[Callable]:
    """Where the cameras are split, the function that gives every rank of
    the cam group's rows of a (R_rank, ...) per-ray tensor, in camera
    order (the one-process frame's ray order), and this rank's first row
    among them; else None."""
    if not layout.split_cameras:
        return None

    def gather(x):
        rows = D.all_gather_rows(x.detach(), group=layout.cam_group)
        return rows, layout.cam_index * x.shape[0]
    return gather
