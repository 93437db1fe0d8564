// Fused lift sample + masked-mean accumulate for one (batch, camera).
//
// Replaces two TPU kernels of the JAX package:
//   * vampire_tpu/ops/pallas_tables.py:289 `_lift_table_pallas`, which builds
//     a (D+1, h+1, w+1, 8 + 4C) table holding every query's 2x2x2 depth
//     corners and 2x2 feature block, so that the TPU does one row gather per
//     query instead of twelve;
//   * vampire_tpu/ops/pallas_gather.py:68 `gather_reduce`, the row gather +
//     fp32 weighted reduce over that table (sampling.py:384-393).
//
// On Hopper the table buys nothing. One camera's depth (86*64*176 bf16,
// ~1.9 MB) and feature map (64*176*16 bf16, ~0.36 MB) sit in the 50 MB L2,
// so the twelve scattered reads hit cache, while building the table would
// write and re-read ~144 MB per camera (~1.7 GB per frame). This kernel
// therefore reads the corners straight from `depth` and `feat` (zeros
// padding) and adds the sample into the block-major accumulators:
//
//   v[k,q,:] = sample_outer_product(depth, feat, coords[k,q]) * valid[k,q]
//   numer[ids[k], q, :] += v[k,q,:]
//   denom[ids[k], q, :] += (|v[k,q,:]| > 0)
//
// (vampire_tpu/models/field.py:386-405 for one camera; align_corners=False.)
//
// What bounds it: per query it reads 8 depth scalars and 4 C-vectors (mostly
// from L2) and read-modify-writes 2*C fp32 accumulator values in device
// memory (K*Q*C*16 bytes per launch, ~86 MB at K=264, Q=1280, C=16), so it
// is bound by the accumulator traffic, not by arithmetic. This first version
// moves those 86 MB in ~0.19 ms on an H100 SXM (700 W), ~460 GB/s: each
// thread stores C consecutive floats, so one warp-wide store touches 32
// sectors 4*C bytes apart. One thread per (query, channel) would coalesce
// the stores.
//
// Design (first, simple version): one thread per (k, q) query. The thread
// computes the trilinear weights once, folds the two z corners into one
// weight per (y, x) pixel, then loops over the C channels. Weights and sums
// are fp32; inputs are fp32 or bf16. `ids` are distinct within a camera
// (top-k) and the per-camera launches run in order on one stream, so every
// accumulator element has one writer: plain `+=`, no atomics, deterministic.
// The kernel allocates nothing; the caller owns every buffer.
//
// Backward (`lift_backward_*`): the transpose of the forward for one camera,
// given g = d numer (G, Q, C) fp32. It replaces the VJP of the TPU lift,
// `_lift_table_bwd` (vampire_tpu/ops/pallas_tables.py:374-396) composed with
// the transpose of the row gather: with wk[p] = w2d[p] * sum_dz zw[dz] *
// depth[z_dz, pix_p] and gv = valid * g[ids[k], q, :],
//
//   d feat[pix_p, c]       += wk[p] * gv[c]
//   d depth[z_dz, pix_p]   += w2d[p] * zw[dz] * sum_c feat[pix_p, c] * gv[c]
//
// into fp32 buffers the caller zeroes (3.9 MB and 0.7 MB at the flagship
// shape, which stay in L2); the wrapper casts them to the inputs' dtype, as
// `_lift_table_bwd` does. One thread per (k, q) query recomputes the
// forward's weights. Many queries land on the same pixel, so the adds are
// fp32 atomics with heavy contention (~21.6 M adds into ~180 K feature
// addresses per flagship camera), and their order, hence the last bits of
// the sums, changes from run to run. What bounds it is that contention, not
// bytes; a warp-level pre-reduction of neighbouring queries is the lever for
// a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One axis of torch grid_sample, align_corners=False, zeros padding:
// clamped corner indices, weights zeroed where the corner is out of bounds.
__device__ __forceinline__ void prep_axis(float coord, int size, int idx[2],
                                          float w[2]) {
  const float x = ((coord + 1.0f) * size - 1.0f) / 2.0f;
  const float x0 = floorf(x);
  const float w1 = x - x0;
  const int i0 = static_cast<int>(x0);
  const float ws[2] = {1.0f - w1, w1};
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const int i = i0 + d;
    const bool inb = (i >= 0) && (i <= size - 1);
    idx[d] = min(max(i, 0), size - 1);
    w[d] = inb ? ws[d] : 0.0f;
  }
}

template <typename T>
__global__ void lift_accumulate_kernel(const T* __restrict__ depth,
                                       const T* __restrict__ feat,
                                       const int64_t* __restrict__ ids,
                                       const float* __restrict__ coords,
                                       const float* __restrict__ valid,
                                       float* __restrict__ numer,
                                       float* __restrict__ denom, int D, int H,
                                       int W, int C, int K, int Q, int G) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(K) * Q) return;
  const int k = static_cast<int>(t / Q);
  const int q = static_cast<int>(t - static_cast<int64_t>(k) * Q);
  const int64_t g = ids[k];
  if (g < 0 || g >= G) return;

  const float* c = coords + t * 3;
  int xi[2], yi[2], zi[2];
  float xw[2], yw[2], zw[2];
  prep_axis(c[0], W, xi, xw);
  prep_axis(c[1], H, yi, yw);
  prep_axis(c[2], D, zi, zw);
  const float vmask = valid[t];

  // per (dy, dx) pixel: bilinear weight times the z-interpolated depth,
  // summed in the same order as the plain version
  const int64_t plane = static_cast<int64_t>(H) * W;
  int64_t pix[4];
  float wk[4];
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int p = dy * 2 + dx;
      pix[p] = static_cast<int64_t>(yi[dy]) * W + xi[dx];
      const float w2d = yw[dy] * xw[dx];
      float s = 0.0f;
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        s = s + zw[dz] * to_f32(depth[zi[dz] * plane + pix[p]]);
      }
      wk[p] = w2d * s;
    }
  }

  const int64_t out = (g * Q + q) * C;
  for (int ch = 0; ch < C; ++ch) {
    float acc = 0.0f;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      acc = acc + to_f32(feat[pix[p] * C + ch]) * wk[p];
    }
    const float v = acc * vmask;
    numer[out + ch] += v;
    denom[out + ch] += (fabsf(v) > 0.0f) ? 1.0f : 0.0f;
  }
}

template <typename T>
__global__ void lift_backward_kernel(const T* __restrict__ depth,
                                     const T* __restrict__ feat,
                                     const int64_t* __restrict__ ids,
                                     const float* __restrict__ coords,
                                     const float* __restrict__ valid,
                                     const float* __restrict__ g_numer,
                                     float* __restrict__ d_depth,
                                     float* __restrict__ d_feat, int D, int H,
                                     int W, int C, int K, int Q, int G) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(K) * Q) return;
  const float vmask = valid[t];
  if (vmask == 0.0f) return;  // a masked query passes no gradient on
  const int k = static_cast<int>(t / Q);
  const int q = static_cast<int>(t - static_cast<int64_t>(k) * Q);
  const int64_t g = ids[k];
  if (g < 0 || g >= G) return;

  const float* c = coords + t * 3;
  int xi[2], yi[2], zi[2];
  float xw[2], yw[2], zw[2];
  prep_axis(c[0], W, xi, xw);
  prep_axis(c[1], H, yi, yw);
  prep_axis(c[2], D, zi, zw);
  const float* gq = g_numer + (g * Q + q) * C;
  const int64_t plane = static_cast<int64_t>(H) * W;

#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const float w2d = yw[dy] * xw[dx];
      if (w2d == 0.0f) continue;  // outside the image: weight 0
      const int64_t pix = static_cast<int64_t>(yi[dy]) * W + xi[dx];
      float s = 0.0f;
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        s = s + zw[dz] * to_f32(depth[zi[dz] * plane + pix]);
      }
      const float wk = w2d * s;
      float dwk = 0.0f;  // d wk = sum_c feat[pix, c] * gv[c]
      for (int ch = 0; ch < C; ++ch) {
        const float gv = gq[ch] * vmask;
        dwk = dwk + to_f32(feat[pix * C + ch]) * gv;
        if (wk != 0.0f) atomicAdd(d_feat + pix * C + ch, wk * gv);
      }
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        if (zw[dz] != 0.0f) {
          atomicAdd(d_depth + zi[dz] * plane + pix, w2d * zw[dz] * dwk);
        }
      }
    }
  }
}

template <typename T>
int launch_backward(const void* depth, const void* feat, const void* ids,
                    const void* coords, const void* valid, const void* g_numer,
                    void* d_depth, void* d_feat, int D, int H, int W, int C,
                    int K, int Q, int G, void* stream) {
  const int64_t n = static_cast<int64_t>(K) * Q;
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  lift_backward_kernel<T><<<static_cast<unsigned int>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(depth), static_cast<const T*>(feat),
      static_cast<const int64_t*>(ids), static_cast<const float*>(coords),
      static_cast<const float*>(valid), static_cast<const float*>(g_numer),
      static_cast<float*>(d_depth), static_cast<float*>(d_feat), D, H, W, C,
      K, Q, G);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* depth, const void* feat, const void* ids,
           const void* coords, const void* valid, void* numer, void* denom,
           int D, int H, int W, int C, int K, int Q, int G, void* stream) {
  const int64_t n = static_cast<int64_t>(K) * Q;
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  lift_accumulate_kernel<T><<<static_cast<unsigned int>(blocks), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(depth), static_cast<const T*>(feat),
      static_cast<const int64_t*>(ids), static_cast<const float*>(coords),
      static_cast<const float*>(valid), static_cast<float*>(numer),
      static_cast<float*>(denom), D, H, W, C, K, Q, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns the CUDA error code
// of the launch: 0 on success.
extern "C" int lift_accumulate_f32(const void* depth, const void* feat,
                                   const void* ids, const void* coords,
                                   const void* valid, void* numer, void* denom,
                                   int D, int H, int W, int C, int K, int Q,
                                   int G, void* stream) {
  return launch<float>(depth, feat, ids, coords, valid, numer, denom, D, H, W,
                       C, K, Q, G, stream);
}

extern "C" int lift_accumulate_bf16(const void* depth, const void* feat,
                                    const void* ids, const void* coords,
                                    const void* valid, void* numer,
                                    void* denom, int D, int H, int W, int C,
                                    int K, int Q, int G, void* stream) {
  return launch<__nv_bfloat16>(depth, feat, ids, coords, valid, numer, denom,
                               D, H, W, C, K, Q, G, stream);
}

extern "C" int lift_backward_f32(const void* depth, const void* feat,
                                 const void* ids, const void* coords,
                                 const void* valid, const void* g_numer,
                                 void* d_depth, void* d_feat, int D, int H,
                                 int W, int C, int K, int Q, int G,
                                 void* stream) {
  return launch_backward<float>(depth, feat, ids, coords, valid, g_numer,
                                d_depth, d_feat, D, H, W, C, K, Q, G, stream);
}

extern "C" int lift_backward_bf16(const void* depth, const void* feat,
                                  const void* ids, const void* coords,
                                  const void* valid, const void* g_numer,
                                  void* d_depth, void* d_feat, int D, int H,
                                  int W, int C, int K, int Q, int G,
                                  void* stream) {
  return launch_backward<__nv_bfloat16>(depth, feat, ids, coords, valid,
                                        g_numer, d_depth, d_feat, D, H, W, C,
                                        K, Q, G, stream);
}
