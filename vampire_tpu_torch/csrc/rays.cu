// Fused corner-table sampling + alpha compositing along camera rays.
//
// Replaces vampire_tpu/core/rendering.py:100 `sample_and_composite_rays`,
// the dense inference ray sampler of the camera-ray branch
// (vampire_tpu/models/field.py:504-584). In the JAX package it is plain JAX
// (`jnp.take` of corner-table rows inside a `lax.map` over ray chunks); the
// corner table that vampire_tpu/ops/pallas_tables.py:73 builds exists for
// this gather. Per ray, walking its S samples in order:
//
//   row, w8  = corner_rows_weights(coords)   (align_corners=True, zeros)
//   v[c]     = valid * sum_k w8[k] * table[row, k*C + c]      (fp32)
//   sd       = density(v[0]) * delta
//   w        = (1 - exp(-sd)) * exp(-sum_{j<i} sd_j)
//   rgb, seg += w * v[K+1..K+3], w * v[1..K];  acc += w;  dsum += w * mid
//
// and writes out[ray] = [rgb (3) | seg (K) | dsum + (1 - acc) * bg_depth],
// with C = 1 + K + 3 channels [sdf | seg | rgb]. The density is the VolSDF
// Laplace density (mode 0, `beta` read from the device parameter, beta_min
// 1e-4) or the sigmoid (mode 1). expf/expm1f, no fast-math intrinsics.
//
// What bounds it: the scattered row reads. Each sample reads one 8*C row
// (352 B in bf16 at C = 22) at a data-dependent place in the table; at the
// flagship shape, 67,584 rays x 85 samples read up to ~2.0 GB per frame from
// a 488 MB table that does not fit the 50 MB L2. Arithmetic is ~30 flops
// per value read and does not matter. This version renders a flagship frame
// in ~1.8 ms on an H100 SXM (700 W), ~1.1 TB/s of row reads.
//
// Design (first, simple version): one warp per ray, lane c < C owns
// channel c. For each sample every lane computes the same row and weights
// (the coordinates are one broadcast load), reads the 8 corners of its
// channel (for each corner the C lanes read C consecutive values, so the
// row is read in 8 coalesced pieces), and sums them in fp32; the sdf of lane
// 0 is shuffled to all lanes, which all carry the same optical depth. Lanes
// C..31 idle (C <= 32 is required). The lever for a later version: read the
// 8 corners straight from the 58 MB bf16 volume, which nearly fits L2,
// instead of from the 488 MB table, and skip the table build entirely.
// The kernel allocates nothing; the caller owns every buffer.
//
// Backward (`rays_backward_*`): given g = d out (R, C) and the forward's
// saved out, it writes d table (fp32, the table's shape) and d beta. The
// JAX package gets this gradient by differentiating the checkpointed chunk
// of `sample_and_composite_rays` (vampire_tpu/core/rendering.py:155-176);
// the transpose of its `jnp.take` is a scatter-add into the table's
// cotangent, and so is this kernel's. Per ray, with u_i = sum_c g_c v_i[c]
// + g_depth * (mid_i - bg) (the value the ray's loss sees at sample i) and
// O = sum_i w_i u_i:
//
//   dO/dv_i[c]  = w_i g_c                      (seg and rgb channels)
//   dO/dsd_i    = T_{i+1} u_i - (O - O_{<=i})  (T_{i+1} = exp(-sum_{j<=i} sd_j))
//   d sdf_i     = dO/dsd_i * delta_i * density'(sdf_i)
//   d beta     += dO/dsd_i * delta_i * d density/d beta
//
// One warp per ray, one lane per channel, as in the forward: one walk along
// the ray recomputes each sample's v, sd, T and w from the table, the prefix
// O_{<=i} comes from the walk and the total O from the saved outputs, and
// each lane adds valid * w8[k] * d v[c] into the 8 corner rows of the sample
// with fp32 atomics (rows are shared by neighbouring samples and rays). d
// beta (the Laplace density only; it includes beta_eff = |beta| + 1e-4 and
// the sign of beta) is reduced per ray in lane 0, then per block in shared
// memory, then added with one atomic per block. What bounds it: the scattered
// read-modify-write of 8 rows of 4*C bytes per valid sample into the 977 MB
// fp32 d table, which does not fit the L2. Scattering straight into the
// volume's gradient instead, so that the table's backward disappears, is the
// lever for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 rays per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One axis of `corner_rows_weights` (core/sampling.py), align_corners=True,
// zeros padding: the table base index b along the axis and the weights of
// the table offsets 0 and 1. Corners outside the volume weigh 0.
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

template <typename T>
__global__ void rays_kernel(const T* __restrict__ table,
                            const float* __restrict__ coords,
                            const float* __restrict__ valid,
                            const float* __restrict__ deltas,
                            const float* __restrict__ mids,
                            const float* __restrict__ beta,
                            float* __restrict__ out, int R, int S, int C,
                            int D, int H, int W, int mode, float sdf_bias,
                            float bg_depth) {
  const int64_t ray =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (ray >= R) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int ch = lane < C ? lane : 0;
  const int K = C - 4;
  float beta_eff = 1.0f;
  if (mode == 0) beta_eff = fabsf(beta[0]) + 1e-4f;
  const float alpha = 1.0f / beta_eff;

  const int64_t base = ray * S;
  const int64_t row_len = 8 * static_cast<int64_t>(C);
  float od = 0.0f;  // optical depth of the samples before this one
  float acc_v = 0.0f, acc_w = 0.0f, acc_d = 0.0f;
  for (int i = 0; i < S; ++i) {
    const float* cc = coords + (base + i) * 3;
    int bx, by, bz;
    float ax[2], ay[2], az[2];
    axis_window(cc[0], W, bx, ax);
    axis_window(cc[1], H, by, ay);
    axis_window(cc[2], D, bz, az);
    const int64_t row =
        (static_cast<int64_t>(bz) * (H + 1) + by) * (W + 1) + bx;
    const T* t = table + row * row_len + ch;
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float wk = az[k >> 2] * ay[(k >> 1) & 1] * ax[k & 1];
      v = v + to_f32(t[k * C]) * wk;
    }
    v = v * valid[base + i];
    const float sdf = __shfl_sync(0xffffffffu, v, 0);
    float dens;
    if (mode == 0) {
      const float s = sdf - sdf_bias;
      const float sg = (s > 0.0f) ? 1.0f : ((s < 0.0f) ? -1.0f : 0.0f);
      dens = alpha * (0.5f + 0.5f * sg * expm1f(-fabsf(s) / beta_eff));
    } else {
      dens = 1.0f / (1.0f + expf(-sdf));
    }
    const float sd = dens * deltas[base + i];
    const float w = (1.0f - expf(-sd)) * expf(-od);
    od = od + sd;
    acc_v = acc_v + w * v;
    acc_w = acc_w + w;
    acc_d = acc_d + w * mids[i];
  }

  float* o = out + ray * (K + 4);
  if (lane == 0) {
    o[K + 3] = acc_d + (1.0f - acc_w) * bg_depth;
  } else if (lane <= K) {
    o[3 + lane - 1] = acc_v;  // seg
  } else if (lane < C) {
    o[lane - K - 1] = acc_v;  // rgb
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T>
__global__ void rays_backward_kernel(
    const T* __restrict__ table, const float* __restrict__ coords,
    const float* __restrict__ valid, const float* __restrict__ deltas,
    const float* __restrict__ mids, const float* __restrict__ beta,
    const float* __restrict__ out, const float* __restrict__ g_out,
    float* __restrict__ d_table, float* __restrict__ d_beta, int R, int S,
    int C, int D, int H, int W, int mode, float sdf_bias, float bg_depth) {
  __shared__ float s_beta[kThreads / 32];
  const int64_t ray =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const bool active = lane < C;
  const int ch = active ? lane : 0;
  const int K = C - 4;
  float db = 0.0f;  // this ray's d beta, in lane 0
  if (ray < R) {    // uniform over the warp: the shuffles below are safe
    float beta_eff = 1.0f, beta_sign = 0.0f;
    if (mode == 0) {
      beta_eff = fabsf(beta[0]) + 1e-4f;
      beta_sign = (beta[0] > 0.0f) ? 1.0f : ((beta[0] < 0.0f) ? -1.0f : 0.0f);
    }
    const float alpha = 1.0f / beta_eff;
    // this lane's output column (-1 for the sdf lane and idle lanes)
    int oi = -1;
    if (lane >= 1 && lane <= K) {
      oi = 3 + lane - 1;  // seg
    } else if (lane > K && lane < C) {
      oi = lane - K - 1;  // rgb
    }
    const int64_t obase = ray * (K + 4);
    const float g_c = (oi >= 0) ? g_out[obase + oi] : 0.0f;
    const float g_d = g_out[obase + K + 3];
    // O = sum_i w_i u_i from the saved outputs: depth - bg = sum w (mid - bg)
    float total = warp_sum((oi >= 0) ? g_c * out[obase + oi] : 0.0f);
    total = total + g_d * (out[obase + K + 3] - bg_depth);

    const int64_t base = ray * S;
    const int64_t row_len = 8 * static_cast<int64_t>(C);
    float od = 0.0f;     // optical depth of the samples before this one
    float prefix = 0.0f;  // O_{<=i}
    for (int i = 0; i < S; ++i) {
      const float* cc = coords + (base + i) * 3;
      int bx, by, bz;
      float ax[2], ay[2], az[2];
      axis_window(cc[0], W, bx, ax);
      axis_window(cc[1], H, by, ay);
      axis_window(cc[2], D, bz, az);
      const int64_t row =
          (static_cast<int64_t>(bz) * (H + 1) + by) * (W + 1) + bx;
      const T* t = table + row * row_len + ch;
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float wk = az[k >> 2] * ay[(k >> 1) & 1] * ax[k & 1];
        v = v + to_f32(t[k * C]) * wk;
      }
      const float vm = valid[base + i];
      v = v * vm;
      const float sdf = __shfl_sync(0xffffffffu, v, 0);
      float dens, ddens_dsdf, ddens_dbeta = 0.0f;
      if (mode == 0) {
        const float s = sdf - sdf_bias;
        const float sg = (s > 0.0f) ? 1.0f : ((s < 0.0f) ? -1.0f : 0.0f);
        const float a = fabsf(s) / beta_eff;
        dens = alpha * (0.5f + 0.5f * sg * expm1f(-a));
        const float e = expf(-a);
        ddens_dsdf = -0.5f * alpha * sg * sg * e / beta_eff;
        ddens_dbeta =
            (-dens / beta_eff + 0.5f * alpha * sg * e * a / beta_eff) *
            beta_sign;
      } else {
        dens = 1.0f / (1.0f + expf(-sdf));
        ddens_dsdf = dens * (1.0f - dens);
      }
      const float delta = deltas[base + i];
      const float sd = dens * delta;
      const float w = (1.0f - expf(-sd)) * expf(-od);
      const float t_next = expf(-(od + sd));
      od = od + sd;
      const float u =
          warp_sum((oi >= 0) ? g_c * v : 0.0f) + g_d * (mids[i] - bg_depth);
      prefix = prefix + w * u;
      const float dsd = t_next * u - (total - prefix);
      db = db + dsd * delta * ddens_dbeta;
      if (vm != 0.0f && active) {
        const float dv = (lane == 0) ? dsd * delta * ddens_dsdf : w * g_c;
        const float gv = dv * vm;
        float* dt = d_table + row * row_len + ch;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float wk = az[k >> 2] * ay[(k >> 1) & 1] * ax[k & 1];
          if (wk != 0.0f) atomicAdd(dt + k * C, wk * gv);
        }
      }
    }
  }
  if (lane == 0) s_beta[threadIdx.x >> 5] = db;
  __syncthreads();
  if (threadIdx.x == 0 && mode == 0) {
    float sum = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) sum += s_beta[w];
    atomicAdd(d_beta, sum);
  }
}

template <typename T>
int launch_backward(const void* table, const void* coords, const void* valid,
                    const void* deltas, const void* mids, const void* beta,
                    const void* out, const void* g_out, void* d_table,
                    void* d_beta, int R, int S, int C, int D, int H, int W,
                    int mode, float sdf_bias, float bg_depth, void* stream) {
  if (C < 5 || C > 32 || (mode != 0 && mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R == 0) return static_cast<int>(cudaSuccess);
  const int64_t threads = static_cast<int64_t>(R) * 32;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  rays_backward_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const float*>(coords),
      static_cast<const float*>(valid), static_cast<const float*>(deltas),
      static_cast<const float*>(mids), static_cast<const float*>(beta),
      static_cast<const float*>(out), static_cast<const float*>(g_out),
      static_cast<float*>(d_table), static_cast<float*>(d_beta), R, S, C, D,
      H, W, mode, sdf_bias, bg_depth);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* table, const void* coords, const void* valid,
           const void* deltas, const void* mids, const void* beta, void* out,
           int R, int S, int C, int D, int H, int W, int mode, float sdf_bias,
           float bg_depth, void* stream) {
  if (C < 5 || C > 32 || (mode != 0 && mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R == 0) return static_cast<int>(cudaSuccess);
  const int64_t threads = static_cast<int64_t>(R) * 32;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  rays_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const float*>(coords),
      static_cast<const float*>(valid), static_cast<const float*>(deltas),
      static_cast<const float*>(mids), static_cast<const float*>(beta),
      static_cast<float*>(out), R, S, C, D, H, W, mode, sdf_bias, bg_depth);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns the CUDA error code
// of the launch: 0 on success.
extern "C" int rays_f32(const void* table, const void* coords,
                        const void* valid, const void* deltas,
                        const void* mids, const void* beta, void* out, int R,
                        int S, int C, int D, int H, int W, int mode,
                        float sdf_bias, float bg_depth, void* stream) {
  return launch<float>(table, coords, valid, deltas, mids, beta, out, R, S, C,
                       D, H, W, mode, sdf_bias, bg_depth, stream);
}

extern "C" int rays_bf16(const void* table, const void* coords,
                         const void* valid, const void* deltas,
                         const void* mids, const void* beta, void* out, int R,
                         int S, int C, int D, int H, int W, int mode,
                         float sdf_bias, float bg_depth, void* stream) {
  return launch<__nv_bfloat16>(table, coords, valid, deltas, mids, beta, out,
                               R, S, C, D, H, W, mode, sdf_bias, bg_depth,
                               stream);
}

// d table (fp32, zeroed by the caller) and d beta (one fp32, zeroed by the
// caller) from g_out and the forward's saved out.
extern "C" int rays_backward_f32(const void* table, const void* coords,
                                 const void* valid, const void* deltas,
                                 const void* mids, const void* beta,
                                 const void* out, const void* g_out,
                                 void* d_table, void* d_beta, int R, int S,
                                 int C, int D, int H, int W, int mode,
                                 float sdf_bias, float bg_depth,
                                 void* stream) {
  return launch_backward<float>(table, coords, valid, deltas, mids, beta, out,
                                g_out, d_table, d_beta, R, S, C, D, H, W, mode,
                                sdf_bias, bg_depth, stream);
}

extern "C" int rays_backward_bf16(const void* table, const void* coords,
                                  const void* valid, const void* deltas,
                                  const void* mids, const void* beta,
                                  const void* out, const void* g_out,
                                  void* d_table, void* d_beta, int R, int S,
                                  int C, int D, int H, int W, int mode,
                                  float sdf_bias, float bg_depth,
                                  void* stream) {
  return launch_backward<__nv_bfloat16>(table, coords, valid, deltas, mids,
                                        beta, out, g_out, d_table, d_beta, R,
                                        S, C, D, H, W, mode, sdf_bias,
                                        bg_depth, stream);
}
