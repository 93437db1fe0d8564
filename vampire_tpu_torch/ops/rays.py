"""Sample the fused field along camera rays and composite.

`sample_and_composite_rays(field, coords, valid, deltas, mids, bg_depth,
density_mode, beta, sdf_bias)` returns (R, 3 + K + 1) fp32 [rgb | seg |
depth] per ray from a channels-last (D, H, W, C) field;
`core.rendering.sample_and_composite_rays_field_reference` gives the
semantics and is its plain version.
`sample_and_composite_rays_backward(..., out, g_out)` is its gradient: d
field (fp32, channels-last) and d beta;
`core.rendering.sample_and_composite_rays_field_backward_reference` is the
plain version. `render_rays(...)` is the differentiable op the model calls:
a `torch.autograd.Function` whose forward and backward are those two.
`channels_last_field(vol)` makes the field from a (C, D, H, W) volume,
differentiably, in the layout the kernels read.

The forward also takes a per-ray `stop` (a ray's samples from it on add
nothing) and gives each ray's optical depth (`with_sd`): its stop mode.
`render_rays_earlyterm(...)` is the JAX package's early-termination
sampler (vampire_tpu/core/rendering.py:331, an eval-mode forward with
`ray_et_fracs` set) in two launches of the stop mode a frame:
`sample_and_composite_rays_prefix` marches every ray's first prefix *
chunk samples into its carried state (the render sums, sum w, sum w *
mid, the optical depth: the sort key), then
`sample_and_composite_rays_resume` resumes each ray there and marches it
to its stop (`core.rendering.earlyterm_stops`), so each sample before a
ray's final stop is read once; both run 8 lanes a ray, 4 rays a warp
(`kStopLanes` of csrc/rays.cu: at 8 the flagship's 24-sample prefix fills
every lane and its optical depth is the one-shot stop mode's bit for
bit; 4 and 16 lanes measured no faster, 32 slower). What bounds them is
what bounds the dense march, the corner reads and the instructions that
make them. On an NVIDIA H100 80GB HBM3 at 700 W, over `chip_smoke.py`'s
flagship frame, the two launches take 0.40-0.46 ms against the dense
march's 0.38-0.42 (the one-shot pair they replaced, which marched every
ray again from sample 0, 0.70-0.73), 0.078 of the frame's byte bound
(PERF.md). The sampler is forward only, as the JAX package uses it in
inference only. The train-mode compact sampler is `render_rays` on
`core.rendering.compact_valid`'s validity.

On CUDA tensors both launch hand-written kernels of `csrc/rays.cu`. The
forward replaces the JAX package's dense ray sampler
`sample_and_composite_rays` (vampire_tpu/core/rendering.py:100): one
launch walks every ray of a frame, reading each sample's 8 corners from the
field, so neither the gathered samples nor a corner table reach device
memory. The backward replaces the gradient XLA derives for that sampler
under `jax.checkpoint` (rendering.py:155-176) and the corner table's VJP
after it: one launch walks every ray again and scatters into the field's
gradient. On CPU tensors both run their plain versions; a CUDA tensor never
falls back: the kernel launches or the call raises.

A launch carries at most `MOST` = 32 channels, `MOST_CARRIED` = 30 where
it reads or writes a carried state (one lane a column of C + 2). Above
that the op marches the field in channel groups (`channel_groups`): each
group is the density channel 0 and an even share of the others, copied
into a field of its own and run through the same kernel. The sampled
channels composite independently with the same weights, so the groups'
outputs merge by column (`march_in_groups`); the first group keeps the
depth column (and a state's acc_w, acc_d and optical depth). In the
backward (`backward_in_groups`) each group's field gradient lands in its
channels, while the density channel's gradient and d beta are summed over
the groups; only the first group receives the depth's cotangent. In the
early-termination sampler the stops come from the density alone, so the
prefix's key and the stops are computed once and shared by every group.
At C <= 32 (30 with a state) the one group is the field itself: a single
launch, as before.

The kernels read each voxel in 16-byte loads, so on a card the field's
voxels must start 16 bytes apart: `channels_last_field` makes it the
channel slice `padded[..., :C]` of a zero-padded channels-last (D, H, W,
CS) copy, CS * itemsize a multiple of 16 (24 for the flagship's 22 bf16
channels). The plain versions take any strides.
"""
from __future__ import annotations

import ctypes
from typing import Callable, List, Optional, Tuple

import torch

from ..core import rendering as R
from ..core.rendering import (
    sample_and_composite_rays_field_backward_reference,
    sample_and_composite_rays_field_reference)
from . import _build

# kernel launches made by sample_and_composite_rays, without a stop and in
# its stop mode, and by sample_and_composite_rays_backward (incremented at
# each launch only)
LAUNCHES = 0
STOP_LAUNCHES = 0
BWD_LAUNCHES = 0

_SYMBOLS = {torch.float32: 'rays_f32', torch.bfloat16: 'rays_bf16'}
_BWD_SYMBOLS = {torch.float32: 'rays_backward_f32',
                torch.bfloat16: 'rays_backward_bf16'}
_MODES = {'sdf': 0, 'naive': 1}

# the most channels one launch carries, without and with a carried state
MOST = 32
MOST_CARRIED = 30


def channel_groups(C: int, most: int) -> List[List[int]]:
    """The channels of each launch over a C-channel field [sdf | seg |
    rgb] whose launches carry at most `most` channels: the whole field where
    C <= most, else groups of the density channel 0 and an even share of
    the others in order (each group within one channel of the others, so
    every group has 16 or more)."""
    if C <= most:
        return [list(range(C))]
    n = -(-(C - 1) // (most - 1))
    cuts = [1 + (C - 1) * i // n for i in range(n + 1)]
    return [[0] + list(range(a, b)) for a, b in zip(cuts, cuts[1:])]


def _column(c: int, C: int) -> int:
    """The output column [rgb | seg | depth] of channel c >= 1 of a
    C-channel field [sdf | seg (C - 4) | rgb (3)]."""
    return c - (C - 3) if c >= C - 3 else c + 2


class _Groups:
    """The channel groups of a field of more than one group
    (`channel_groups`) and the column maps between each group's outputs and
    the whole field's."""

    def __init__(self, field: torch.Tensor, chans: List[List[int]]):
        self.field = field
        self.C = C = field.shape[3]
        self.chans = chans
        dev = field.device
        self.cols = [(torch.tensor([_column(i, len(ch))
                                    for i in range(1, len(ch))], device=dev),
                      torch.tensor([_column(c, C) for c in ch[1:]],
                                   device=dev)) for ch in chans]

    def fields(self):
        """Each group's field: a copy of the group's channels whose voxels
        start on 16 bytes."""
        return [_aligned(self.field.index_select(
            3, torch.tensor(ch, device=self.field.device)))
            for ch in self.chans]

    def split(self, x: torch.Tensor, i: int, tail: bool = True):
        """Group i's columns of an (R, C + e) tensor laid out as the
        output or the carried state (the per-channel columns, then from
        column C - 1 on the tail: the depth, or acc_w, acc_d and the
        optical depth); the tail copied where `tail`, else zeros."""
        own, whole = self.cols[i]
        Cg = len(self.chans[i])
        part = torch.zeros((x.shape[0], Cg + x.shape[1] - self.C),
                           dtype=x.dtype, device=x.device)
        part[:, own] = x[:, whole]
        if tail:
            part[:, Cg - 1:] = x[:, self.C - 1:]
        return part.contiguous()

    def merge(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The (R, C + e) tensor of the groups' (R, Cg + e) ones: each
        group's columns, the tail from the first group."""
        first = parts[0]
        Cg0 = len(self.chans[0])
        out = torch.empty((first.shape[0], self.C + first.shape[1] - Cg0),
                          dtype=first.dtype, device=first.device)
        for (own, whole), part in zip(self.cols, parts):
            out[:, whole] = part[:, own]
        out[:, self.C - 1:] = first[:, Cg0 - 1:]
        return out


def _aligned(field: torch.Tensor) -> torch.Tensor:
    """A channels-last (D, H, W, C) field as the channel slice of a copy
    zero-padded to the least voxel stride whose bytes are a multiple of 16
    (the field itself where C already is and it is contiguous)."""
    C = field.shape[-1]
    pad = -C % (16 // field.element_size())
    if pad == 0:
        return field.contiguous()
    return torch.nn.functional.pad(field, (0, pad))[..., :C]


def march_in_groups(launch: Callable, field: torch.Tensor, most: int,
                    state: Optional[torch.Tensor] = None):
    """A forward over the field's channel groups (`channel_groups` at
    `most`), merged. `launch(group_field, group_state)` marches one group
    and returns its (R, Cg) renders or (R, Cg + 2) carried state, or a
    tuple whose first element is such and whose others (the optical depth)
    are the same for every group; `group_state` is group i's columns of
    `state` (None without one). Returns the launch's result for the whole
    field: the per-channel columns from their groups, the depth (a state's
    acc_w, acc_d and optical depth) and the other tuple elements from the
    first group. One group: `launch(field, state)` itself."""
    chans = channel_groups(field.shape[3], most)
    if len(chans) == 1:
        return launch(field, state)
    groups = _Groups(field, chans)
    outs = [launch(f, None if state is None else groups.split(state, i))
            for i, f in enumerate(groups.fields())]
    if isinstance(outs[0], tuple):
        return (groups.merge([o[0] for o in outs]),) + tuple(outs[0][1:])
    return groups.merge(outs)


def backward_in_groups(launch: Callable, field: torch.Tensor, most: int,
                       out: torch.Tensor, g_out: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of `march_in_groups`' renders. `launch(group_field,
    group_out, group_g_out)` returns the group's (d field (D, H, W, Cg)
    fp32, d beta); each group gets its columns of `out` and `g_out`, and
    only the first the depth's cotangent (the others zeros). Returns (d
    field (D, H, W, C) fp32: each group's channels, the density channel's
    summed over the groups in order; d beta summed likewise). One group:
    `launch(field, out, g_out)` itself."""
    chans = channel_groups(field.shape[3], most)
    if len(chans) == 1:
        return launch(field, out, g_out)
    groups = _Groups(field, chans)
    d_field = torch.empty(field.shape, dtype=torch.float32,
                          device=field.device)
    d_beta = None
    for i, f in enumerate(groups.fields()):
        dg, db = launch(f, groups.split(out, i),
                        groups.split(g_out, i, tail=i == 0))
        ch = torch.tensor(groups.chans[i][1:], device=field.device)
        d_field.index_copy_(3, ch, dg[..., 1:])
        if i == 0:
            d_field[..., 0] = dg[..., 0]
            d_beta = db
        else:
            d_field[..., 0] += dg[..., 0]
            d_beta = d_beta + db
    return d_field, d_beta


def channel_stride(field: torch.Tensor) -> int:
    """The voxel stride CS of a (D, H, W, C) field whose channels are
    contiguous and whose voxels follow each other at one stride (a
    channels-last tensor or a channel slice of one); raises otherwise, and
    where the voxels do not start on 16 bytes."""
    if field.dim() != 4:
        raise ValueError(f'rays: the field must be (D, H, W, C), got '
                         f'{tuple(field.shape)}')
    D, H, W, C = field.shape
    CS = field.stride(2) if W > 1 else C
    want = (H * W * CS, W * CS, CS, 1)
    if (CS < C or any(n > 1 and field.stride(d) != s
                      for d, (n, s) in enumerate(zip(field.shape, want)))):
        raise ValueError(f'rays: field strides {field.stride()} are not '
                         f'channels-last for {tuple(field.shape)}')
    if (CS * field.element_size()) % 16 or field.data_ptr() % 16:
        raise ValueError(f'rays: the field\'s voxels must start on 16 bytes '
                         f'(voxel stride {CS}); use channels_last_field')
    return CS


def _check(field, coords, valid, deltas, mids, beta, **more):
    dev = field.device
    tensors = dict(coords=coords, valid=valid, deltas=deltas, mids=mids,
                   beta=beta, **more)
    if field.dtype not in _SYMBOLS:
        raise TypeError(f'rays: the field must be float32 or bfloat16, got '
                        f'{field.dtype}')
    CS = channel_stride(field)
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f'rays: {name} is on {t.device}, field on {dev}')
        if not t.is_contiguous():
            raise ValueError(f'rays: {name} must be contiguous')
        if t.dtype != torch.float32:
            raise TypeError(f'rays: {name} must be float32')
    C = field.shape[3]
    R, S = valid.shape
    if (coords.shape != (R, S, 3) or deltas.shape != (R, S)
            or mids.shape != (S,) or beta.numel() != 1
            or any(t.shape != (R, C) for t in more.values())):
        raise ValueError(
            f'rays: shapes field {tuple(field.shape)} coords '
            f'{tuple(coords.shape)} valid {tuple(valid.shape)} deltas '
            f'{tuple(deltas.shape)} mids {tuple(mids.shape)} beta '
            f'{tuple(beta.shape)} '
            + ' '.join(f'{k} {tuple(t.shape)}' for k, t in more.items())
            + ' do not agree')
    if not 5 <= C <= 32:
        raise ValueError(f'rays: {C} channels; the kernel takes 5 to 32')
    if R >= 2 ** 31 // 32:
        raise ValueError(f'rays: {R} rays exceed one launch')
    if field.shape[0] * field.shape[1] * field.shape[2] * CS >= 2 ** 31:
        raise ValueError(f'rays: a field of {tuple(field.shape)} at stride '
                         f'{CS} exceeds the kernel\'s 32-bit offsets')
    return R, S, C, CS


def _kernel(symbols, dtype, n_ptr, n_int=8):
    """The typed entry point: n_ptr pointers, n_int ints, 2 floats, the
    stream (a null pointer is passed as None)."""
    return _build.kernel('rays', symbols[dtype], [ctypes.c_void_p] * n_ptr
                         + [ctypes.c_int] * n_int + [ctypes.c_float] * 2
                         + [ctypes.c_void_p])


def _launch(fn, field, ptrs, R, S, C, CS, density_mode, sdf_bias, bg_depth):
    """Launch on the current stream of the field's card; returns the CUDA
    error code. `ptrs` may end in ints that come before R."""
    if density_mode not in _MODES:
        raise ValueError(f'rays: density_mode {density_mode!r}')
    D, H, W = field.shape[:3]
    return _build.launch(fn, field.device, field.data_ptr(), *ptrs, R, S, C,
                         CS, D, H, W, _MODES[density_mode], float(sdf_bias),
                         float(bg_depth))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forward(field, coords, valid, deltas, mids, bg_depth, density_mode,
             beta, sdf_bias, stop=None, with_sd=False, state=None,
             keep_state=False, begin=0, end=None):
    """One launch of the forward kernel (`csrc/rays.cu`): the dense march
    with the defaults, else its stop mode over samples [begin, end) and
    each ray's `stop`, from the carried `state` if given (a launch that
    reads or writes a state runs 8 lanes a ray). Returns the
    carried state (R, C + 2) with `keep_state`, else (the renders (R, C),
    the optical depth (R,) with `with_sd` or None). Raises where the
    arguments do not fit the kernel or the launch fails."""
    R, S, C, CS = _check(field, coords, valid, deltas, mids, beta)
    end = S if end is None else end
    named = dict(stop=(stop, torch.int32, (R,)),
                 state=(state, torch.float32, (R, C + 2)))
    for name, (t, dtype, shape) in named.items():
        if t is not None and (t.device != field.device or t.dtype != dtype
                              or t.shape != shape or not t.is_contiguous()):
            raise ValueError(f'rays: {name} must be a contiguous {dtype} '
                             f'{shape} tensor on {field.device}, got '
                             f'{t.dtype} {tuple(t.shape)} on {t.device}')
    if (state is not None or keep_state) and C + 2 > 32:
        raise ValueError(f'rays: the stop mode carries C + 2 = {C + 2} '
                         f'columns a ray, one a lane; at most 32')
    if not 0 <= begin <= end <= S:
        raise ValueError(f'rays: samples [{begin}, {end}) of {S}')
    out = sd = state_out = None
    if keep_state:
        state_out = torch.empty((R, C + 2), dtype=torch.float32,
                                device=field.device)
    else:
        out = torch.empty((R, C), dtype=torch.float32, device=field.device)
        if with_sd:
            sd = torch.empty((R,), dtype=torch.float32, device=field.device)
    err = _launch(_kernel(_SYMBOLS, field.dtype, 11, 10), field,
                  (coords.data_ptr(), valid.data_ptr(), deltas.data_ptr(),
                   mids.data_ptr(), beta.data_ptr(), _ptr(out), _ptr(stop),
                   _ptr(sd), _ptr(state), _ptr(state_out), begin, end),
                  R, S, C, CS, density_mode, sdf_bias, bg_depth)
    if err != 0:
        raise RuntimeError(f'rays: kernel launch failed with CUDA error {err}')
    return state_out if keep_state else (out, sd)


def _device(field):
    """True where the kernels run (a CUDA field), False for the plain
    versions (a CPU field); raises on any other device."""
    if field.device.type == 'cpu':
        return False
    if field.device.type != 'cuda':
        raise NotImplementedError(f'rays: no kernel for {field.device}')
    return True


def sample_and_composite_rays(field: torch.Tensor, coords: torch.Tensor,
                              valid: torch.Tensor, deltas: torch.Tensor,
                              mids: torch.Tensor, bg_depth: float,
                              density_mode: str, beta: torch.Tensor,
                              sdf_bias: float, stop: torch.Tensor = None,
                              with_sd: bool = False):
    """Render R rays of S samples through a channels-last field.

    Args:
      field: the fused field (D, H, W, C), float32 or bfloat16, C = 1 + K +
        3 channels [sdf | seg | rgb]; channels-last (`channel_stride`).
      coords: (R, S, 3), valid: (R, S), deltas: (R, S), mids: (S,), all
        float32: normalized sample coords, in-range mask, path lengths,
        depth-bin midpoints.
      bg_depth: depth given to the untouched remainder of each ray.
      density_mode: 'sdf' (Laplace density of `beta`, a float32 tensor of
        one element, and `sdf_bias`) or 'naive' (sigmoid; `beta` and
        `sdf_bias` are not read).
      stop: None, or (R,) int32: the stop mode, in which sample i of a ray
        is not read and adds nothing where i >= stop[ray].
      with_sd: also return each ray's optical depth summed over the samples
        before its stop, (R,) float32.

    Returns (R, 3 + K + 1) float32, and the optical depth with `with_sd`.
    """
    if not _device(field):
        return sample_and_composite_rays_field_reference(
            field, coords, valid, deltas, mids, bg_depth, density_mode, beta,
            sdf_bias, stop=stop, with_sd=with_sd)

    def launch(f, _):
        global LAUNCHES, STOP_LAUNCHES
        res = _forward(f, coords, valid, deltas, mids, bg_depth,
                       density_mode, beta, sdf_bias, stop=stop,
                       with_sd=with_sd)
        if stop is None and not with_sd:
            LAUNCHES += 1
        else:
            STOP_LAUNCHES += 1
        return res
    out, sd = march_in_groups(launch, field, MOST)
    return (out, sd) if with_sd else out


def sample_and_composite_rays_prefix(
        field: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
        deltas: torch.Tensor, mids: torch.Tensor, bg_depth: float,
        density_mode: str, beta: torch.Tensor, sdf_bias: float,
        n: int) -> torch.Tensor:
    """The first launch of the resumed stop mode: the samples [0, min(S,
    n)) of every ray (the arguments of `sample_and_composite_rays`;
    `bg_depth` is not read). Returns each ray's carried state (R, C + 2)
    float32, [rgb | seg | acc_w | acc_d | od]: the render sums in the
    output's column order, sum w, sum w * mid and the optical depth, whose
    last column is the early-termination sampler's sort key.
    `core.rendering.sample_and_composite_rays_field_prefix_reference` is
    the plain version."""
    if not _device(field):
        return R.sample_and_composite_rays_field_prefix_reference(
            field, coords, valid, deltas, mids, bg_depth, density_mode, beta,
            sdf_bias, n)

    def launch(f, _):
        global STOP_LAUNCHES
        state = _forward(f, coords, valid, deltas, mids, bg_depth,
                         density_mode, beta, sdf_bias, keep_state=True,
                         end=min(valid.shape[1], n))
        STOP_LAUNCHES += 1
        return state
    return march_in_groups(launch, field, MOST_CARRIED)


def sample_and_composite_rays_resume(
        field: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
        deltas: torch.Tensor, mids: torch.Tensor, bg_depth: float,
        density_mode: str, beta: torch.Tensor, sdf_bias: float,
        state: torch.Tensor, begin: int, stop: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The second launch: every ray resumed at sample `begin` from its
    carried `state` (`sample_and_composite_rays_prefix`'s to n = begin)
    and marched to its `stop` (R,) int32. Returns ((R, 3 + K + 1) float32
    renders, (R,) float32 optical depth at each stop), as the one-shot
    stop mode gives them. `core.rendering.
    sample_and_composite_rays_field_resume_reference` is the plain
    version."""
    if not _device(field):
        return R.sample_and_composite_rays_field_resume_reference(
            field, coords, valid, deltas, mids, bg_depth, density_mode, beta,
            sdf_bias, state, begin, stop)

    def launch(f, st):
        global STOP_LAUNCHES
        res = _forward(f, coords, valid, deltas, mids, bg_depth,
                       density_mode, beta, sdf_bias, stop=stop, with_sd=True,
                       state=st, begin=min(valid.shape[1], begin))
        STOP_LAUNCHES += 1
        return res
    return march_in_groups(launch, field, MOST_CARRIED, state=state)


def sample_and_composite_rays_backward(
        field: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
        deltas: torch.Tensor, mids: torch.Tensor, bg_depth: float,
        density_mode: str, beta: torch.Tensor, sdf_bias: float,
        out: torch.Tensor, g_out: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of `sample_and_composite_rays` at its saved output
    `out`, given g_out = d out (R, 3 + K + 1) float32. Returns (d field
    float32 of the field's (D, H, W, C) shape, a channel slice of a
    (D, H, W, CS) buffer on the card; d beta float32 0-dim, zero for
    'naive'). The plain version ignores `out` and sums the ray's tail
    directly."""
    if not _device(field):
        return sample_and_composite_rays_field_backward_reference(
            field, coords, valid, deltas, mids, bg_depth, density_mode, beta,
            sdf_bias, g_out)
    return backward_in_groups(
        lambda f, o, g: _backward(f, coords, valid, deltas, mids, bg_depth,
                                  density_mode, beta, sdf_bias, o, g),
        field, MOST, out, g_out)


def _backward(field, coords, valid, deltas, mids, bg_depth, density_mode,
              beta, sdf_bias, out, g_out):
    """One launch of the backward kernel; raises where the arguments do
    not fit it or the launch fails."""
    global BWD_LAUNCHES
    R, S, C, CS = _check(field, coords, valid, deltas, mids, beta, out=out,
                         g_out=g_out)
    D, H, W = field.shape[:3]
    d_field = torch.zeros((D, H, W, CS), dtype=torch.float32,
                          device=field.device)
    d_beta = torch.zeros((), dtype=torch.float32, device=field.device)
    err = _launch(_kernel(_BWD_SYMBOLS, field.dtype, 10), field,
                  (coords.data_ptr(), valid.data_ptr(), deltas.data_ptr(),
                   mids.data_ptr(), beta.data_ptr(), out.data_ptr(),
                   g_out.data_ptr(), d_field.data_ptr(), d_beta.data_ptr()),
                  R, S, C, CS, density_mode, sdf_bias, bg_depth)
    if err != 0:
        raise RuntimeError(f'rays: backward kernel launch failed with CUDA '
                           f'error {err}')
    BWD_LAUNCHES += 1
    return d_field[..., :C], d_beta


_PLAN_KINDS = {'forward': 0, 'backward': 1, 'stop': 2}


def plan(dtype: torch.dtype, channels: int, kind: str = 'forward') -> dict:
    """The launch of a kernel for a field of `channels` channels on the
    current card, `kind` 'forward' (the dense march), 'backward' or 'stop'
    (the forward's stop mode as the resumed launches run it): blocks per SM
    (the occupancy API's count), registers a thread, the channels the
    registers hold (CMAX), threads a block, lanes a ray."""
    fn = _build.kernel('rays', 'rays_plan',
                       [ctypes.c_int] * 3 + [ctypes.c_void_p])
    info = (ctypes.c_int * 5)()
    err = fn(int(dtype == torch.bfloat16), channels, _PLAN_KINDS[kind],
             ctypes.cast(info, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f'rays: rays_plan failed with CUDA error {err}')
    return dict(blocks_per_sm=info[0], regs=info[1], cmax=info[2],
                threads=info[3], lanes=info[4])


class ChannelsLastField(torch.autograd.Function):
    """(C, D, H, W) -> the channel slice [..., :C] of a zero-padded
    channels-last (D, H, W, CS) copy, CS the least voxel stride >= C whose
    bytes are a multiple of 16 (the padding is empty where C already is).
    The backward permutes the gradient back to (C, D, H, W), contiguous."""

    @staticmethod
    def forward(ctx, vol):
        return _aligned(vol.permute(1, 2, 3, 0))

    @staticmethod
    def backward(ctx, g):
        return g.permute(3, 0, 1, 2).contiguous()


def channels_last_field(vol: torch.Tensor) -> torch.Tensor:
    """The ray sampler's field of a (C, D, H, W) volume, differentiable:
    channels-last, each voxel's C channels starting on 16 bytes
    (`ChannelsLastField`)."""
    return ChannelsLastField.apply(vol)


class RenderRays(torch.autograd.Function):
    """`sample_and_composite_rays` with its backward: gradients reach the
    field (summed in fp32, cast to the field's dtype) and `beta`. The
    geometry (coords, valid, deltas, mids) takes none and must not ask for
    one. `plain` runs the plain versions of both directions."""

    @staticmethod
    def forward(ctx, field, beta, coords, valid, deltas, mids, bg_depth,
                density_mode, sdf_bias, plain):
        names = ('coords', 'valid', 'deltas', 'mids')
        for name, needs in zip(names, ctx.needs_input_grad[2:6]):
            if needs:
                raise ValueError(f'rays: {name} comes from the geometry and '
                                 f'takes no gradient')
        fwd = (sample_and_composite_rays_field_reference if plain
               else sample_and_composite_rays)
        out = fwd(field, coords, valid, deltas, mids, bg_depth, density_mode,
                  beta, sdf_bias)
        ctx.save_for_backward(field, beta, coords, valid, deltas, mids, out)
        ctx.args = (bg_depth, density_mode, sdf_bias, plain)
        return out

    @staticmethod
    def backward(ctx, g_out):
        field, beta, coords, valid, deltas, mids, out = ctx.saved_tensors
        bg_depth, density_mode, sdf_bias, plain = ctx.args
        g_out = g_out.contiguous()
        if plain:
            d_field, d_beta = (
                sample_and_composite_rays_field_backward_reference(
                    field, coords, valid, deltas, mids, bg_depth,
                    density_mode, beta, sdf_bias, g_out))
        else:
            d_field, d_beta = sample_and_composite_rays_backward(
                field, coords, valid, deltas, mids, bg_depth, density_mode,
                beta, sdf_bias, out, g_out)
        # fp32 sums, rounded once to the field's dtype (as autograd would)
        return ((d_field.to(field.dtype), d_beta.reshape(beta.shape))
                + (None,) * 8)


def earlyterm_march(first: Callable, then: Callable, args: tuple,
                    chunk: int, prefix: int, caps_fracs, tau: float,
                    split: Optional[Callable] = None):
    """The early-termination sampler over the arguments `args` of
    `sample_and_composite_rays`: `first(*args, n)` gives each ray's carried
    state over its first n = prefix * chunk samples (the prefix launch, or
    its plain version), whose optical depth decides the stops once; then
    `then(*args, state, n, stop)` resumes each ray to its stop. Returns
    (the (R, 3 + K + 1) renders, the coverage diagnostic of these rays,
    the stops). `split`: where the rays are a part of a frame's, as
    `core.rendering.earlyterm_stops` takes it."""
    valid = args[2]
    n = min(valid.shape[1], prefix * chunk)
    state = first(*args, n)
    stop, exited, misses = R.earlyterm_stops(state[:, -1], valid, chunk,
                                             prefix, caps_fracs, split)
    out, sd = then(*args, state, n, stop)
    return out, R.earlyterm_uncovered_drops(sd, exited, misses, tau), stop


class RenderRaysEarlyTerm(torch.autograd.Function):
    """The early-termination sampler: two launches of the stop mode, the
    first over every ray's prefix, the second resuming each ray there from
    the first's carried state to its stop (`core.rendering.earlyterm_stops`
    of the first's optical depth). Returns the (R, 3 + K + 1) renders and
    the coverage diagnostic. Forward only: the JAX package runs it in
    inference only, and its backward raises."""

    @staticmethod
    def forward(ctx, field, beta, coords, valid, deltas, mids, bg_depth,
                density_mode, sdf_bias, chunk, prefix, caps_fracs, tau,
                plain, split):
        if plain:
            first = R.sample_and_composite_rays_field_prefix_reference
            then = R.sample_and_composite_rays_field_resume_reference
        else:
            first = sample_and_composite_rays_prefix
            then = sample_and_composite_rays_resume
        out, diag, _ = earlyterm_march(
            first, then, (field, coords, valid, deltas, mids, bg_depth,
                          density_mode, beta, sdf_bias),
            chunk, prefix, caps_fracs, tau, split)
        ctx.mark_non_differentiable(diag)
        return out, diag

    @staticmethod
    def backward(ctx, g_out, g_diag):
        raise RuntimeError('rays: the early-termination sampler is forward '
                           'only (the JAX package runs it in eval-mode '
                           'forwards); train with ray_et_fracs=() or in '
                           'train mode')


def render_rays_earlyterm(field: torch.Tensor, coords: torch.Tensor,
                          valid: torch.Tensor, deltas: torch.Tensor,
                          mids: torch.Tensor, bg_depth: float,
                          density_mode: str, beta: torch.Tensor,
                          sdf_bias: float, chunk: int, prefix: int,
                          caps_fracs, tau: float, plain: bool = False,
                          split: Optional[Callable] = None):
    """The JAX `sample_and_composite_rays_earlyterm` with `return_diag`
    (`render_rays`' arguments, then ray_et_chunk, ray_et_prefix,
    ray_et_fracs, ray_et_tau): ((R, 3 + K + 1) fp32 renders, int64 0-dim
    count of uncovered drops among these rays). `plain` runs both passes
    through the plain version. `split`: where the rays are this rank's
    cameras of a frame (`parallel.mesh.ray_split`), the stops come from the
    frame's sort (`core.rendering.earlyterm_stops`)."""
    return RenderRaysEarlyTerm.apply(
        field, beta, coords, valid, deltas, mids, float(bg_depth),
        density_mode, float(sdf_bias), int(chunk), int(prefix),
        tuple(caps_fracs), float(tau), plain, split)


def render_rays(field: torch.Tensor, coords: torch.Tensor,
                valid: torch.Tensor, deltas: torch.Tensor, mids: torch.Tensor,
                bg_depth: float, density_mode: str, beta: torch.Tensor,
                sdf_bias: float, plain: bool = False) -> torch.Tensor:
    """Differentiable `sample_and_composite_rays` (same arguments); `plain`
    selects the plain versions of the forward and the backward."""
    return RenderRays.apply(field, beta, coords, valid, deltas, mids,
                            float(bg_depth), density_mode, float(sdf_bias),
                            plain)
