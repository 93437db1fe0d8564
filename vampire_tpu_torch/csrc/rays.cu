// Trilinear sampling of the channels-last fused field + alpha compositing
// along camera rays, and its backward.
//
// Replaces vampire_tpu/core/rendering.py:100 `sample_and_composite_rays`,
// the dense inference ray sampler of the camera-ray branch
// (vampire_tpu/models/field.py:504-584). In the JAX package it is plain JAX
// (`jnp.take` of corner-table rows inside a `lax.map` over ray chunks); the
// TPU corner table (vampire_tpu/ops/pallas_tables.py:73) exists for that
// gather. Here the kernel reads the 8 corners of each sample straight from
// a channels-last copy of the field, (D, H, W, C) with channel stride CS >=
// C, so no table is built. Per ray, over its S samples:
//
//   b, w8    = corner_rows_weights(coords)   (align_corners=True, zeros)
//   v[c]     = valid * sum_k w8[k] * field[b - 1 + corner(k), c]   (fp32)
//   sd       = density(v[0]) * delta
//   w        = (1 - exp(-sd)) * exp(-sum_{j<i} sd_j)
//   rgb, seg += w * v[K+1..K+3], w * v[1..K];  acc += w;  dsum += w * mid
//
// and out[ray] = [rgb (3) | seg (K) | dsum + (1 - acc) * bg_depth], with
// C = 1 + K + 3 channels [sdf | seg | rgb]. Corner k = (dz, dy, dx) in the
// table's (dz, dy, dx)-major order, and corners outside the field weigh 0,
// so the terms are those the table's row would give. The density is the
// VolSDF Laplace density (mode 0, `beta` read from the device parameter,
// beta_min 1e-4) or the sigmoid (mode 1). expf/expm1f, no fast-math.
//
// What bounds it: the scattered corner reads, and the instructions that
// make them. At the flagship shape a frame is 67,584 rays x 85 samples,
// 2.9 M of them valid, each reading 8 voxels of C = 22 bf16 channels: 1.2 M
// distinct voxels, 91 % of the field, whose 57.7 MB about fit the 50 MB L2
// (the 488 MB corner table the first version read does not). A warp load
// touches 32 scattered voxels, so the time goes to load instructions, the
// L1's wavefronts and registers more than to bytes: with every read folded
// into 4096 voxels the march is only about a third faster.
//
// Design: one warp per ray, one lane per sample. The warp takes the ray's
// samples 32 at a time (85 samples are 3 chunks): each lane loads its own
// sample's coordinates (consecutive lanes read consecutive samples), finds
// its corners and weights, and reads each corner's C channels with 16-byte
// loads, so a warp keeps 32 samples' loads in flight. Every voxel must
// start on 16 bytes: the field's voxel stride is a multiple of 16 bytes
// (the caller pads the flagship's 22 bf16 channels to 24, 48 bytes); at
// stride 22 a voxel took 11 4-byte loads and the march 1.7-2.2x longer.
// The loads of 2 corners start together and a corner of weight 0 is
// read from a clamped voxel instead of branching around it; 4 corners at a
// time cost more registers than they hide. The transmittance is an
// exclusive warp scan of sd (`__shfl_up_sync`), carried from chunk to
// chunk; each lane accumulates w * v for every channel in registers, and
// one warp reduction a channel runs at the ray's end. Templated on the
// dtype and on CMAX (the channel count rounded up to 8, 16, 24 or 32;
// registers hold CMAX channels). Blocks of 4 warps, capped at 102
// registers a thread so that 5 blocks fit an SM (`rays_plan` reports the
// occupancy API's count). An L2 persistence window on the field did not
// pay and is not set.
//
// Backward (`rays_backward_*`): given g = d out (R, C) and the forward's
// saved out, it adds d field into an fp32 channels-last field gradient
// (D, H, W, CS), zeroed by the caller, and writes d beta. The JAX package
// gets this gradient by differentiating the checkpointed chunk of
// `sample_and_composite_rays` (vampire_tpu/core/rendering.py:155-176) and
// then the table's VJP; here it goes straight into the field's gradient, so
// no table cotangent exists. Per ray, with u_i = sum_c g_c v_i[c] + g_depth
// * (mid_i - bg) and O = sum_i w_i u_i:
//
//   dO/dv_i[c]  = w_i g_c                      (seg and rgb channels)
//   dO/dsd_i    = T_{i+1} u_i - (O - O_{<=i})  (T_{i+1} = exp(-sum_{j<=i} sd_j))
//   d sdf_i     = dO/dsd_i * delta_i * density'(sdf_i)
//   d beta     += dO/dsd_i * delta_i * d density/d beta
//
// The same walk as the forward, a lane per sample: u_i is computed in-lane
// (no cross-lane sum), O_{<=i} is an inclusive warp scan of w_i u_i carried
// over chunks, and O comes from the saved outputs. The scatter turns the
// warp around: for each valid sample of the chunk in turn, lane c < C adds
// channel c of its w8[k] * d v into each of the 8 corners, so a corner's C
// channels are one coalesced run of fp32 reductions (`atomicAdd`, result
// unused) into L2. Each lane issuing its own sample's channels as float4
// reductions was 1.3-2.3x slower (4 to 11 scattered requests a corner
// instead of one run); no two adjacent samples of a ray share a corner cell
// at the flagship's depth bins, so merging them first would not pay. d beta
// (Laplace only; it includes beta_eff = |beta| + 1e-4 and the sign of
// beta) is reduced per warp, per block in shared memory, then added with
// one atomic per block. What bounds it: the reductions in L2, 8 corners of
// C channels for each of the 2.9 M valid samples.
//
// Stop mode (`rays_kernel<..., true, G>`): the forward of the JAX package's
// early-termination sampler (vampire_tpu/core/rendering.py:331, plain XLA
// there; its passes over sorted, capped rays reduce to a march stopped per
// ray, core/rendering.py `earlyterm_stops`), in two launches a frame.
// Launch 1 marches every ray's samples [0, p), p = prefix * chunk, and
// writes no renders: only each ray's carried state, a row of C + 2 fp32
// [rgb | seg | acc_w | acc_d | od], whose optical depth od is the sort key
// of the stops. Launch 2 starts each ray at sample p from that state (od
// before its first chunk, the sums added at the end) and marches [p,
// stop[ray]); a ray whose stop is p only composites its state. So each
// sample before a ray's final stop is read once: a stop is at least p by
// the stops' definition. Without a state (begin 0, `stop`, `sd_out`) it
// is the one-shot stop mode, a warp a ray.
//
// The stop mode takes G lanes a ray, 32 / G rays a warp, with the scans
// and sums over each group of G lanes and the warp looping to the longest
// of its rays: G = kStopLanes = 8 for the two resumed launches, 32 for the
// one-shot mode. A ray's ranges in the resumed launches are short and
// ragged ([0, 24) at the flagship, then passes of 12 samples), so at 32
// lanes a warp left a quarter to most of its lanes idle on a chunk that
// costs about as much full; at 8 lanes the prefix fills every lane and the
// passes most. At 8 lanes and p <= 24 the key is the 32-lane scan's sum
// tree (the groups' sums added in order, then zeros), so it equals the
// one-shot stop mode's `sd_out` at a stop of p bit for bit, and the stops
// do not move. The carried state needs a lane a column (C <= 30); the
// one-shot mode takes every C the dense march takes. The dense instance
// (`false`, 32) computes what it computed before the stop mode, bit for
// bit.
//
// What bounds it: as the dense march, the corner reads and the
// instructions that make them, here over [0, p) (launch 1) and [p, stop)
// (launch 2). Measured on an NVIDIA H100 80GB HBM3 at 700 W over
// chip_smoke's flagship frame (tools/ray_stop.py): launch 1 0.183-0.210
// ms, launch 2 0.220-0.250 ms, the frame 0.40-0.46 ms against the dense
// march's 0.38-0.42 in the same runs (the one-shot pair it replaced
// 0.70-0.73), 0.078 of the frame's byte bound (each sample before its
// final stop read once; the 13 MB of carried state apart). At 32 lanes a
// ray the resumed pair took 0.585 ms, at 16 0.451, at 4 0.423 (PERF.md).
//
// The kernels allocate nothing; the caller owns every buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;  // 4 warps, one ray each

// blocks an SM must hold: 5 caps a thread at 102 registers. Fewer registers
// and more warps beat keeping every corner's loads in registers (measured
// on an H100 at the flagship shape); 32 channels spill too much at 5.
constexpr int min_blocks(int cmax) { return cmax <= 24 ? 5 : 4; }
constexpr unsigned kFull = 0xffffffffu;

// One axis of `corner_rows_weights` (core/sampling.py), align_corners=True,
// zeros padding: the table base index b along the axis and the weights of
// the offsets 0 and 1, i.e. of the field rows b - 1 and b. A row outside the
// field weighs 0.
__device__ __forceinline__ void axis_window(float coord, int size, int& b,
                                            float a[2]) {
  const float x = (coord + 1.0f) / 2.0f * static_cast<float>(size - 1);
  const float x0f = floorf(x);
  const float w1 = x - x0f;
  const float w0 = 1.0f - w1;
  // any x0 outside [-1, size] has both weights 0; clamp before the int cast
  const int x0 = static_cast<int>(
      fminf(fmaxf(x0f, -2.0f), static_cast<float>(size + 1)));
  b = min(max(x0 + 1, 0), size);
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const int r = b - 1 + d;
    const bool c0 = (r == x0) && (x0 >= 0) && (x0 <= size - 1);
    const bool c1 = (r == x0 + 1) && (x0 + 1 >= 0) && (x0 + 1 <= size - 1);
    a[d] = (c0 ? w0 : 0.0f) + (c1 ? w1 : 0.0f);
  }
}

// A 16-byte word of the field, loaded through the read-only path; element
// j of it widened to fp32 (bf16 -> fp32 is a 16-bit shift).
__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T>
__device__ __forceinline__ float element(const uint4& q, int j) {
  const int k = sizeof(T) == 4 ? j : (j >> 1);
  const unsigned u = k == 0 ? q.x : (k == 1 ? q.y : (k == 2 ? q.z : q.w));
  if constexpr (sizeof(T) == 4) return __uint_as_float(u);
  return __uint_as_float((j & 1) ? (u & 0xffff0000u) : (u << 16));
}

// A sample's corner window: per axis the base b and the two weights.
struct Window {
  int bx, by, bz;
  float ax[2], ay[2], az[2];
  __device__ __forceinline__ float weight(int k) const {
    return az[k >> 2] * ay[(k >> 1) & 1] * ax[k & 1];
  }
  // the field voxel of corner k (valid only where weight(k) != 0); the
  // wrapper keeps every element offset of the field under 2^31
  __device__ __forceinline__ int voxel(int k, int H, int W) const {
    return ((bz - 1 + (k >> 2)) * H + (by - 1 + ((k >> 1) & 1))) * W +
           (bx - 1 + (k & 1));
  }
  // the same voxel clamped into the field, so that a corner of weight 0
  // can be read without a branch
  __device__ __forceinline__ int clamped_voxel(int k, int D, int H,
                                               int W) const {
    const int z = min(max(bz - 1 + (k >> 2), 0), D - 1);
    const int y = min(max(by - 1 + ((k >> 1) & 1), 0), H - 1);
    const int x = min(max(bx - 1 + (k & 1), 0), W - 1);
    return (z * H + y) * W + x;
  }
};

// corners whose loads start together, before the first is used
constexpr int kCornerBatch = 2;

// v[c] = vm * sum_k w8[k] field[corner k, c] for c < CMAX (channels >= C
// read the voxel's padding or nothing, and are never used). The
// loads of kCornerBatch corners all start before any is used; a corner of
// weight 0 (outside the field, or on a grid plane) reads a voxel inside the
// field and adds value * 0, which is 0 for a finite field (the table holds
// a 0 there instead). A sample with vm == 0 reads nothing and gets v = 0.
template <typename T, int CMAX>
__device__ __forceinline__ void sample_field(const T* __restrict__ field,
                                             const Window& win, float vm,
                                             int C, int CS, int D, int H,
                                             int W, float (&v)[CMAX]) {
  constexpr int EPW = 16 / static_cast<int>(sizeof(T));  // elements a word
  constexpr int NW = (CMAX + EPW - 1) / EPW;
  const int nw = (C + EPW - 1) / EPW;  // <= CS / EPW: inside the voxel
#pragma unroll
  for (int c = 0; c < CMAX; ++c) v[c] = 0.0f;
  if (vm == 0.0f) return;
#pragma unroll
  for (int k0 = 0; k0 < 8; k0 += kCornerBatch) {
    uint4 raw[kCornerBatch][NW];
#pragma unroll
    for (int q = 0; q < kCornerBatch; ++q) {
      const T* p = field + win.clamped_voxel(k0 + q, D, H, W) * CS;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (w < nw) raw[q][w] = load16(p + w * EPW);
      }
    }
#pragma unroll
    for (int q = 0; q < kCornerBatch; ++q) {
      const float wk = win.weight(k0 + q);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (w < nw) {
#pragma unroll
          for (int j = 0; j < EPW; ++j) {
            if (w * EPW + j < CMAX) {
              const float e = element<T>(raw[q][w], j);
              v[w * EPW + j] = v[w * EPW + j] + e * wk;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CMAX; ++c) v[c] = v[c] * vm;
}

__device__ __forceinline__ Window window_of(const float* __restrict__ coords,
                                            int64_t si, int D, int H, int W) {
  Window win;
  axis_window(coords[si * 3 + 0], W, win.bx, win.ax);
  axis_window(coords[si * 3 + 1], H, win.by, win.ay);
  axis_window(coords[si * 3 + 2], D, win.bz, win.az);
  return win;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// inclusive prefix sum over the warp's lanes
__device__ __forceinline__ float warp_scan(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += t;
  }
  return v;
}

// The same over each group of G consecutive lanes (G a power of 2 <= 32;
// G = 32 is the warp's, the same shuffles in the same order)
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

template <int G>
__device__ __forceinline__ float group_scan(float v, int gl) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    const float t = __shfl_up_sync(kFull, v, off, G);
    if (gl >= off) v += t;
  }
  return v;
}

// column `col` of a group's row held G columns a lane (lane gl of the
// group holds columns gl, gl + G, ...), broadcast over the group
template <int G, int NCOL>
__device__ __forceinline__ float group_col(const float (&row)[NCOL],
                                           int col) {
  float v = 0.0f;
#pragma unroll
  for (int k = 0; k < NCOL; ++k) v = (col / G == k) ? row[k] : v;
  return __shfl_sync(kFull, v, col % G, G);
}

// density, d density / d sdf and d density / d beta (mode 0: Laplace of
// beta_eff = |beta| + 1e-4 around sdf_bias; mode 1: sigmoid)
struct Density {
  float beta_eff, alpha, beta_sign;
  int mode;
  float bias;
  __device__ __forceinline__ float value(float sdf) const {
    if (mode == 0) {
      const float s = sdf - bias;
      const float sg = (s > 0.0f) ? 1.0f : ((s < 0.0f) ? -1.0f : 0.0f);
      return alpha * (0.5f + 0.5f * sg * expm1f(-fabsf(s) / beta_eff));
    }
    return 1.0f / (1.0f + expf(-sdf));
  }
  __device__ __forceinline__ float grads(float sdf, float& ddx,
                                         float& ddb) const {
    if (mode == 0) {
      const float s = sdf - bias;
      const float sg = (s > 0.0f) ? 1.0f : ((s < 0.0f) ? -1.0f : 0.0f);
      const float a = fabsf(s) / beta_eff;
      const float d = alpha * (0.5f + 0.5f * sg * expm1f(-a));
      const float e = expf(-a);
      ddx = -0.5f * alpha * sg * sg * e / beta_eff;
      ddb = (-d / beta_eff + 0.5f * alpha * sg * e * a / beta_eff) *
            beta_sign;
      return d;
    }
    const float d = 1.0f / (1.0f + expf(-sdf));
    ddx = d * (1.0f - d);
    ddb = 0.0f;
    return d;
  }
};

__device__ __forceinline__ Density density_of(const float* beta, int mode,
                                              float sdf_bias) {
  Density dn;
  dn.mode = mode;
  dn.bias = sdf_bias;
  dn.beta_eff = 1.0f;
  dn.beta_sign = 0.0f;
  if (mode == 0) {
    dn.beta_eff = fabsf(beta[0]) + 1e-4f;
    dn.beta_sign = (beta[0] > 0.0f) ? 1.0f : ((beta[0] < 0.0f) ? -1.0f : 0.0f);
  }
  dn.alpha = 1.0f / dn.beta_eff;
  return dn;
}

// the output column of field channel c ([rgb | seg | depth] from [sdf | seg
// | rgb]); -1 for the sdf channel
__device__ __forceinline__ int out_col(int c, int K) {
  return c == 0 ? -1 : (c <= K ? 3 + c - 1 : c - K - 1);
}

// The carried state of a ray between the stop mode's launches: a row of
// C + 2 fp32, [rgb | seg | acc_w | acc_d | od] (the render sums in the
// output's column order, sum w, sum w * mid, the optical depth).
__host__ __device__ constexpr int state_cols(int C) { return C + 2; }

// kStop false: the dense march, every sample of every ray, a warp a ray
// (G = 32). kStop true: the stop mode, samples [begin, min(end, stop[ray]))
// of each ray (`stop` optional), G lanes a ray, starting from the carried
// state `state_in` (optional: none is a ray at its first sample) and
// ending in `state_out` (if given) or in the renders `out` and the optical
// depth `sd_out` (optional).
template <typename T, int CMAX, bool kStop, int G>
__global__ void __launch_bounds__(kThreads, min_blocks(CMAX))
    rays_kernel(const T* __restrict__ field, const float* __restrict__ coords,
                const float* __restrict__ valid,
                const float* __restrict__ deltas,
                const float* __restrict__ mids,
                const float* __restrict__ beta, float* __restrict__ out,
                const int* __restrict__ stop, float* __restrict__ sd_out,
                const float* __restrict__ state_in,
                float* __restrict__ state_out, int begin, int end, int R,
                int S, int C, int CS, int D, int H, int W, int mode,
                float sdf_bias, float bg_depth) {
  static_assert(kStop || G == 32, "the dense march takes a warp a ray");
  // the columns a lane holds of its ray's output or state row
  constexpr int NCOL = 32 / G;
  const int64_t thread =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  // the whole warp leaves together: its first ray is past the last
  if (((thread >> 5) << 5) / G >= R) return;
  const int64_t ray = thread / G;
  const bool real = ray < R;  // false for the tail of the last warp only
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);  // the lane within the ray's group
  const int K = C - 4;
  const Density dn = density_of(beta, mode, sdf_bias);
  // the samples this ray marches: all S, or [begin, its stop); the group's
  // loop runs to the largest of the warp's
  int s_begin = 0, n = S, n_warp = S;
  // this lane's columns of the carried state (0 without one)
  float carried[NCOL];
#pragma unroll
  for (int k = 0; k < NCOL; ++k) carried[k] = 0.0f;
  if constexpr (kStop) {
    s_begin = begin;
    n = !real ? 0 : (stop == nullptr ? end : min(end, max(stop[ray], 0)));
    n_warp = n;
#pragma unroll
    for (int off = G; off < 32; off <<= 1) {
      n_warp = max(n_warp, __shfl_xor_sync(kFull, n_warp, off));
    }
#pragma unroll
    for (int k = 0; k < NCOL; ++k) {
      const int col = gl + k * G;
      if (real && state_in != nullptr && col < state_cols(C)) {
        carried[k] = state_in[ray * state_cols(C) + col];
      }
    }
  }

  float acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0.0f;
  float acc_w = 0.0f, acc_d = 0.0f;
  float od = 0.0f;  // optical depth of the samples before this chunk
  if constexpr (kStop) od = group_col<G>(carried, C + 1);
  for (int s0 = s_begin; s0 < n_warp; s0 += G) {
    const int i = s0 + gl;
    const bool in = i < n;
    const int64_t si = ray * S + i;
    const float vm = in ? valid[si] : 0.0f;
    float v[CMAX];
    Window win{};
    if (vm != 0.0f) win = window_of(coords, si, D, H, W);
    sample_field<T, CMAX>(field, win, vm, C, CS, D, H, W, v);
    const float sd = in ? dn.value(v[0]) * deltas[si] : 0.0f;
    const float incl = group_scan<G>(sd, gl);
    const float prev = __shfl_up_sync(kFull, incl, 1, G);
    const float excl = gl == 0 ? 0.0f : prev;
    const float w = (1.0f - expf(-sd)) * expf(-(od + excl));
    od = od + __shfl_sync(kFull, incl, G - 1, G);
    if (in) {
#pragma unroll
      for (int c = 0; c < CMAX; ++c) acc[c] = acc[c] + w * v[c];
      acc_w = acc_w + w;
      acc_d = acc_d + w * mids[i];
    }
  }

  // the values of this lane's output columns gl, gl + G, ...
  float mine[NCOL];
#pragma unroll
  for (int k = 0; k < NCOL; ++k) mine[k] = 0.0f;
#pragma unroll
  for (int c = 1; c < CMAX; ++c) {
    if (c < C) {
      const float s = group_sum<G>(acc[c]);
#pragma unroll
      for (int k = 0; k < NCOL; ++k) {
        if (gl + k * G == out_col(c, K)) mine[k] = s;
      }
    }
  }
  acc_w = group_sum<G>(acc_w);
  acc_d = group_sum<G>(acc_d);
  if constexpr (kStop) {
    // the carried sums plus this launch's
    acc_w = group_col<G>(carried, C - 1) + acc_w;
    acc_d = group_col<G>(carried, C) + acc_d;
#pragma unroll
    for (int k = 0; k < NCOL; ++k) {
      const int col = gl + k * G;
      mine[k] = carried[k] + mine[k];
      if (state_out != nullptr) {
        if (col == C - 1) mine[k] = acc_w;
        if (col == C) mine[k] = acc_d;
        if (col == C + 1) mine[k] = od;
        if (real && col < state_cols(C)) {
          state_out[ray * state_cols(C) + col] = mine[k];
        }
      }
    }
    if (state_out != nullptr) return;
    if (real && sd_out != nullptr && gl == 0) sd_out[ray] = od;
  }
#pragma unroll
  for (int k = 0; k < NCOL; ++k) {
    const int col = gl + k * G;
    if (col == K + 3) mine[k] = acc_d + (1.0f - acc_w) * bg_depth;
    if (real && col < C) out[ray * C + col] = mine[k];
  }
}

template <typename T, int CMAX>
__global__ void __launch_bounds__(kThreads, min_blocks(CMAX))
    rays_backward_kernel(const T* __restrict__ field,
                         const float* __restrict__ coords,
                         const float* __restrict__ valid,
                         const float* __restrict__ deltas,
                         const float* __restrict__ mids,
                         const float* __restrict__ beta,
                         const float* __restrict__ out,
                         const float* __restrict__ g_out,
                         float* __restrict__ d_field,
                         float* __restrict__ d_beta, int R, int S, int C,
                         int CS, int D, int H, int W, int mode,
                         float sdf_bias, float bg_depth) {
  __shared__ float s_beta[kThreads / 32];
  const int64_t ray =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int K = C - 4;
  float db = 0.0f;  // this lane's share of d beta
  if (ray < R) {    // uniform over the warp: the shuffles below are safe
    const Density dn = density_of(beta, mode, sdf_bias);
    const int64_t obase = ray * C;
    // g per field channel (0 for the sdf channel and past C), and
    // O = sum_i w_i u_i from the saved outputs: depth - bg = sum w (mid - bg)
    float g[CMAX];
    const float g_d = g_out[obase + K + 3];
    float total = g_d * (out[obase + K + 3] - bg_depth);
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      g[c] = 0.0f;
      if (c >= 1 && c < C) {
        const int oc = out_col(c, K);
        g[c] = g_out[obase + oc];
        total = total + g[c] * out[obase + oc];
      }
    }

    float od = 0.0f;   // optical depth of the chunks before this one
    float pre = 0.0f;  // O over the chunks before this one
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int i = s0 + lane;
      const bool in = i < S;
      const int64_t si = ray * S + i;
      const float vm = in ? valid[si] : 0.0f;
      float v[CMAX];
      Window win{};
      if (vm != 0.0f) win = window_of(coords, si, D, H, W);
      sample_field<T, CMAX>(field, win, vm, C, CS, D, H, W, v);
      float ddx = 0.0f, ddb = 0.0f;
      const float delta = in ? deltas[si] : 0.0f;
      const float sd = in ? dn.grads(v[0], ddx, ddb) * delta : 0.0f;
      const float incl = warp_scan(sd, lane);
      const float prev = __shfl_up_sync(kFull, incl, 1);
      const float excl = lane == 0 ? 0.0f : prev;
      const float w = (1.0f - expf(-sd)) * expf(-(od + excl));
      const float t_next = expf(-(od + incl));
      od = od + __shfl_sync(kFull, incl, 31);
      float u = 0.0f;
      if (in) {
        u = g_d * (mids[i] - bg_depth);
#pragma unroll
        for (int c = 1; c < CMAX; ++c) {
          if (c < C) u = u + g[c] * v[c];  // v past C may be padding
        }
      }
      const float pin = warp_scan(w * u, lane);
      const float dsd = t_next * u - (total - (pre + pin));
      pre = pre + __shfl_sync(kFull, pin, 31);
      if (in) db = db + dsd * delta * ddb;
      // the scatter, one valid sample of the chunk at a time: lane c < C
      // adds channel c of the sample's d v into its 8 corners, so each
      // corner's C channels are one coalesced run of reductions
      float dv[CMAX];
      const float wg = w * vm;
#pragma unroll
      for (int c = 0; c < CMAX; ++c) dv[c] = wg * g[c];
      dv[0] = dsd * delta * ddx * vm;
      unsigned todo = __ballot_sync(kFull, vm != 0.0f);
      while (todo != 0u) {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1u;
        float mine = 0.0f;
#pragma unroll
        for (int c = 0; c < CMAX; ++c) {
          const float t = __shfl_sync(kFull, dv[c], j);
          if (lane == c) mine = t;
        }
        Window wj;
        wj.bx = __shfl_sync(kFull, win.bx, j);
        wj.by = __shfl_sync(kFull, win.by, j);
        wj.bz = __shfl_sync(kFull, win.bz, j);
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          wj.ax[d] = __shfl_sync(kFull, win.ax[d], j);
          wj.ay[d] = __shfl_sync(kFull, win.ay[d], j);
          wj.az[d] = __shfl_sync(kFull, win.az[d], j);
        }
        if (lane < C) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float wk = wj.weight(k);
            if (wk != 0.0f) {
              atomicAdd(d_field + wj.voxel(k, H, W) * CS + lane, wk * mine);
            }
          }
        }
      }
    }
  }
  db = warp_sum(db);
  if (lane == 0) s_beta[threadIdx.x >> 5] = db;
  __syncthreads();
  if (threadIdx.x == 0 && mode == 0) {
    float sum = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) sum += s_beta[w];
    atomicAdd(d_beta, sum);
  }
}

// CMAX for C channels: 8, 16, 24 or 32
int cmax_of(int C) { return C <= 8 ? 8 : (C <= 16 ? 16 : (C <= 24 ? 24 : 32)); }

// f(integral_constant<CMAX>) for C channels
template <typename F>
int with_cmax(int C, F&& f) {
  switch (cmax_of(C)) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 24: return f(std::integral_constant<int, 24>{});
    default: return f(std::integral_constant<int, 32>{});
  }
}

// every voxel must start on 16 bytes: the loads are 16 bytes wide
template <typename T>
bool bad_shape(const void* field, int C, int CS, int mode) {
  return C < 5 || C > 32 || CS < C || (CS * sizeof(T)) % 16 != 0 ||
         reinterpret_cast<uintptr_t>(field) % 16 != 0 ||
         (mode != 0 && mode != 1);
}

// the lanes a ray of the resumed launches (a state read or written): 4
// rays a warp; the dense march and the one-shot stop mode take a warp a ray
constexpr int kStopLanes = 8;

// blocks for R rays of `lanes` threads each
unsigned int n_blocks(int R, int lanes = 32) {
  return static_cast<unsigned int>(
      (static_cast<int64_t>(R) * lanes + kThreads - 1) / kThreads);
}

template <typename T>
int launch(const void* field, const void* coords, const void* valid,
           const void* deltas, const void* mids, const void* beta, void* out,
           const void* stop, void* sd_out, const void* state_in,
           void* state_out, int begin, int end, int R, int S, int C, int CS,
           int D, int H, int W, int mode, float sdf_bias, float bg_depth,
           void* stream) {
  const bool dense = stop == nullptr && sd_out == nullptr &&
                     state_in == nullptr && state_out == nullptr &&
                     begin == 0 && end == S;
  const bool resumed = state_in != nullptr || state_out != nullptr;
  // the carried state needs a lane a column; the samples lie in [0, S]
  if (bad_shape<T>(field, C, CS, mode) ||
      (resumed && state_cols(C) > 32) || begin < 0 || end > S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R == 0) return static_cast<int>(cudaSuccess);
  return with_cmax(C, [&](auto cm) {
    constexpr int CM = decltype(cm)::value;
    auto kernel = dense     ? rays_kernel<T, CM, false, 32>
                  : resumed ? rays_kernel<T, CM, true, kStopLanes>
                            : rays_kernel<T, CM, true, 32>;
    kernel<<<n_blocks(R, resumed ? kStopLanes : 32), kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(field), static_cast<const float*>(coords),
        static_cast<const float*>(valid), static_cast<const float*>(deltas),
        static_cast<const float*>(mids), static_cast<const float*>(beta),
        static_cast<float*>(out), static_cast<const int*>(stop),
        static_cast<float*>(sd_out), static_cast<const float*>(state_in),
        static_cast<float*>(state_out), begin, end, R, S, C, CS, D, H, W,
        mode, sdf_bias, bg_depth);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int launch_backward(const void* field, const void* coords, const void* valid,
                    const void* deltas, const void* mids, const void* beta,
                    const void* out, const void* g_out, void* d_field,
                    void* d_beta, int R, int S, int C, int CS, int D, int H,
                    int W, int mode, float sdf_bias, float bg_depth,
                    void* stream) {
  if (bad_shape<T>(field, C, CS, mode)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R == 0) return static_cast<int>(cudaSuccess);
  return with_cmax(C, [&](auto cm) {
    rays_backward_kernel<T, decltype(cm)::value>
        <<<n_blocks(R), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(field), static_cast<const float*>(coords),
            static_cast<const float*>(valid),
            static_cast<const float*>(deltas),
            static_cast<const float*>(mids), static_cast<const float*>(beta),
            static_cast<const float*>(out), static_cast<const float*>(g_out),
            static_cast<float*>(d_field), static_cast<float*>(d_beta), R, S,
            C, CS, D, H, W, mode, sdf_bias, bg_depth);
    return static_cast<int>(cudaGetLastError());
  });
}

// kind 0: the dense forward, 1: the backward, 2: the forward's stop mode
// as the resumed launches run it (kStopLanes lanes a ray)
template <typename T>
int plan(int C, int kind, int* info) {
  if (C < 5 || C > 32 || kind < 0 || kind > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return with_cmax(C, [&](auto cm) {
    constexpr int CM = decltype(cm)::value;
    const void* fn =
        kind == 1
            ? reinterpret_cast<const void*>(rays_backward_kernel<T, CM>)
        : kind == 2
            ? reinterpret_cast<const void*>(rays_kernel<T, CM, true,
                                                        kStopLanes>)
            : reinterpret_cast<const void*>(rays_kernel<T, CM, false, 32>);
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], fn,
                                                        kThreads, 0);
    info[1] = attr.numRegs;
    info[2] = CM;
    info[3] = kThreads;
    info[4] = kind == 2 ? kStopLanes : 32;
    return static_cast<int>(err);
  });
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns the CUDA error code
// of the launch: 0 on success. `field` is (D, H, W, C) channels-last with
// voxel stride CS (>= C, a multiple of 16 bytes, the field 16-byte
// aligned), `out` (R, C) fp32. The stop mode's arguments: `stop` (R,)
// int32, `sd_out` (R,) fp32, `state_in` and `state_out` (R, C + 2) fp32,
// each optional (null), and the samples [begin, end) with 0 <= begin and
// end <= S; with every pointer null, begin 0 and end S the launch is the
// dense march. A launch that reads or writes a state (C <= 30) runs
// kStopLanes lanes a ray, any other a warp a ray.
extern "C" int rays_f32(const void* field, const void* coords,
                        const void* valid, const void* deltas,
                        const void* mids, const void* beta, void* out,
                        const void* stop, void* sd_out, const void* state_in,
                        void* state_out, int begin, int end, int R, int S,
                        int C, int CS, int D, int H, int W, int mode,
                        float sdf_bias, float bg_depth, void* stream) {
  return launch<float>(field, coords, valid, deltas, mids, beta, out, stop,
                       sd_out, state_in, state_out, begin, end, R, S, C, CS,
                       D, H, W, mode, sdf_bias, bg_depth, stream);
}

extern "C" int rays_bf16(const void* field, const void* coords,
                         const void* valid, const void* deltas,
                         const void* mids, const void* beta, void* out,
                         const void* stop, void* sd_out, const void* state_in,
                         void* state_out, int begin, int end, int R, int S,
                         int C, int CS, int D, int H, int W, int mode,
                         float sdf_bias, float bg_depth, void* stream) {
  return launch<__nv_bfloat16>(field, coords, valid, deltas, mids, beta, out,
                               stop, sd_out, state_in, state_out, begin, end,
                               R, S, C, CS, D, H, W, mode, sdf_bias, bg_depth,
                               stream);
}

// d field (fp32, (D, H, W, CS), zeroed by the caller) and d beta (one
// fp32, zeroed by the caller) from g_out and the forward's out.
extern "C" int rays_backward_f32(const void* field, const void* coords,
                                 const void* valid, const void* deltas,
                                 const void* mids, const void* beta,
                                 const void* out, const void* g_out,
                                 void* d_field, void* d_beta, int R, int S,
                                 int C, int CS, int D, int H, int W, int mode,
                                 float sdf_bias, float bg_depth,
                                 void* stream) {
  return launch_backward<float>(field, coords, valid, deltas, mids, beta, out,
                                g_out, d_field, d_beta, R, S, C, CS, D, H, W,
                                mode, sdf_bias, bg_depth, stream);
}

extern "C" int rays_backward_bf16(const void* field, const void* coords,
                                  const void* valid, const void* deltas,
                                  const void* mids, const void* beta,
                                  const void* out, const void* g_out,
                                  void* d_field, void* d_beta, int R, int S,
                                  int C, int CS, int D, int H, int W,
                                  int mode, float sdf_bias, float bg_depth,
                                  void* stream) {
  return launch_backward<__nv_bfloat16>(field, coords, valid, deltas, mids,
                                        beta, out, g_out, d_field, d_beta, R,
                                        S, C, CS, D, H, W, mode, sdf_bias,
                                        bg_depth, stream);
}

// The launch of the kernel for C channels (bf16 field if `bf16`; `kind` 0
// the dense forward, 1 the backward, 2 the forward's stop mode as the
// resumed launches run it): info[0] blocks per SM (the occupancy API),
// info[1] registers a thread, info[2] CMAX, info[3] threads a block,
// info[4] lanes a ray.
extern "C" int rays_plan(int bf16, int C, int kind, int* info) {
  return bf16 ? plan<__nv_bfloat16>(C, kind, info)
              : plan<float>(C, kind, info);
}
