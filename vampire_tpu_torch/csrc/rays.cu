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

template <typename T, int CMAX>
__global__ void __launch_bounds__(kThreads, min_blocks(CMAX))
    rays_kernel(const T* __restrict__ field, const float* __restrict__ coords,
                const float* __restrict__ valid,
                const float* __restrict__ deltas,
                const float* __restrict__ mids,
                const float* __restrict__ beta, float* __restrict__ out,
                int R, int S, int C, int CS, int D, int H, int W, int mode,
                float sdf_bias, float bg_depth) {
  const int64_t ray =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (ray >= R) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int K = C - 4;
  const Density dn = density_of(beta, mode, sdf_bias);

  float acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0.0f;
  float acc_w = 0.0f, acc_d = 0.0f;
  float od = 0.0f;  // optical depth of the chunks before this one
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int i = s0 + lane;
    const bool in = i < S;
    const int64_t si = ray * S + i;
    const float vm = in ? valid[si] : 0.0f;
    float v[CMAX];
    Window win{};
    if (vm != 0.0f) win = window_of(coords, si, D, H, W);
    sample_field<T, CMAX>(field, win, vm, C, CS, D, H, W, v);
    const float sd = in ? dn.value(v[0]) * deltas[si] : 0.0f;
    const float incl = warp_scan(sd, lane);
    const float prev = __shfl_up_sync(kFull, incl, 1);
    const float excl = lane == 0 ? 0.0f : prev;
    const float w = (1.0f - expf(-sd)) * expf(-(od + excl));
    od = od + __shfl_sync(kFull, incl, 31);
    if (in) {
#pragma unroll
      for (int c = 0; c < CMAX; ++c) acc[c] = acc[c] + w * v[c];
      acc_w = acc_w + w;
      acc_d = acc_d + w * mids[i];
    }
  }

  float mine = 0.0f;  // the value of this lane's output column
#pragma unroll
  for (int c = 1; c < CMAX; ++c) {
    if (c < C) {
      const float s = warp_sum(acc[c]);
      if (lane == out_col(c, K)) mine = s;
    }
  }
  acc_w = warp_sum(acc_w);
  acc_d = warp_sum(acc_d);
  if (lane == K + 3) mine = acc_d + (1.0f - acc_w) * bg_depth;
  if (lane < C) out[ray * C + lane] = mine;
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

unsigned int n_blocks(int R) {
  return static_cast<unsigned int>(
      (static_cast<int64_t>(R) * 32 + kThreads - 1) / kThreads);
}

template <typename T>
int launch(const void* field, const void* coords, const void* valid,
           const void* deltas, const void* mids, const void* beta, void* out,
           int R, int S, int C, int CS, int D, int H, int W, int mode,
           float sdf_bias, float bg_depth, void* stream) {
  if (bad_shape<T>(field, C, CS, mode)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R == 0) return static_cast<int>(cudaSuccess);
  return with_cmax(C, [&](auto cm) {
    rays_kernel<T, decltype(cm)::value>
        <<<n_blocks(R), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(field), static_cast<const float*>(coords),
            static_cast<const float*>(valid),
            static_cast<const float*>(deltas),
            static_cast<const float*>(mids), static_cast<const float*>(beta),
            static_cast<float*>(out), R, S, C, CS, D, H, W, mode, sdf_bias,
            bg_depth);
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

template <typename T>
int plan(int C, int backward, int* info) {
  if (C < 5 || C > 32) return static_cast<int>(cudaErrorInvalidValue);
  return with_cmax(C, [&](auto cm) {
    constexpr int CM = decltype(cm)::value;
    const void* fn =
        backward ? reinterpret_cast<const void*>(rays_backward_kernel<T, CM>)
                 : reinterpret_cast<const void*>(rays_kernel<T, CM>);
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], fn,
                                                        kThreads, 0);
    info[1] = attr.numRegs;
    info[2] = CM;
    info[3] = kThreads;
    return static_cast<int>(err);
  });
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns the CUDA error code
// of the launch: 0 on success. `field` is (D, H, W, C) channels-last with
// voxel stride CS (>= C, a multiple of 16 bytes, the field 16-byte
// aligned), `out` (R, C) fp32.
extern "C" int rays_f32(const void* field, const void* coords,
                        const void* valid, const void* deltas,
                        const void* mids, const void* beta, void* out, int R,
                        int S, int C, int CS, int D, int H, int W, int mode,
                        float sdf_bias, float bg_depth, void* stream) {
  return launch<float>(field, coords, valid, deltas, mids, beta, out, R, S, C,
                       CS, D, H, W, mode, sdf_bias, bg_depth, stream);
}

extern "C" int rays_bf16(const void* field, const void* coords,
                         const void* valid, const void* deltas,
                         const void* mids, const void* beta, void* out, int R,
                         int S, int C, int CS, int D, int H, int W, int mode,
                         float sdf_bias, float bg_depth, void* stream) {
  return launch<__nv_bfloat16>(field, coords, valid, deltas, mids, beta, out,
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

// The launch of the kernel for C channels (bf16 field if `bf16`, the
// backward if `backward`): info[0] blocks per SM (the occupancy API),
// info[1] registers a thread, info[2] CMAX, info[3] threads a block.
extern "C" int rays_plan(int bf16, int C, int backward, int* info) {
  return bf16 ? plan<__nv_bfloat16>(C, backward, info)
              : plan<float>(C, backward, info);
}
