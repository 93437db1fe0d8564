// The lift of one frame: the fused sample + masked-mean accumulate of its N
// cameras in one launch, and its transpose in one launch.
//
// Replaces three TPU kernels of the JAX package:
//   * vampire_tpu/ops/pallas_tables.py:289 `_lift_table_pallas`, which builds
//     a (D+1, h+1, w+1, 8 + 4C) table holding every query's 2x2x2 depth
//     corners and 2x2 feature block, so that the TPU does one row gather per
//     query instead of twelve;
//   * vampire_tpu/ops/pallas_gather.py:68 `gather_reduce`, the row gather +
//     fp32 weighted reduce over that table (sampling.py:384-393);
//   * vampire_tpu/ops/pallas_tables.py:374 `_lift_table_bwd`, the VJP of the
//     two, composed with the transpose of the row gather.
//
// On Hopper the table buys nothing: a frame's bf16 depth (6 x 86x64x176) and
// features (6 x 64x176x16) are 13.8 MB and sit in the 50 MB L2, so the
// twelve scattered reads of a query hit cache. Both kernels read the corners
// straight from `depth` and `feat` (zeros padding, align_corners=False;
// vampire_tpu/models/field.py:386-405):
//
//   v[n,k,q,:] = sample_outer_product(depth[n], feat[n], coords[n,k,q])
//                * valid[n,k,q]
//   numer[g, q, :] = 0 + sum over n in order, k = slot(n, g), of v[n,k,q,:]
//   denom[g, q, :] = the count of those terms with |v| > 0
//
// where slot(n, g) is the k with ids[n, k] == g (ids are distinct within a
// camera, as top-k makes them; ids outside [0, G) are ignored).
//
// Forward (`lift_frame_*`): output-stationary. A CTA owns one block g and
// 4 runs of 64 of its queries; it first reads the frame's N x K ids once to
// find each camera's slot of g, then each thread owns V consecutive channels
// of one query (C = 16: four lanes a query, each lane computing one pixel
// corner's depth weight and sharing it with shuffles; 16-byte streaming
// stores, a warp writing 8 queries x 64 B contiguously), walks the cameras
// in order, adds each selecting camera's sample in registers in the plain
// version's order (0 + camera 0 + camera 1 ...; within a sample the corners
// in the order of `sample_outer_product`), and writes numer and denom once.
// Blocks that no camera selected get zeros from the kernel: no zero-fill, no
// read-modify-write, no atomics, deterministic. What bounds it: the 168 MB
// of numer and denom written once, plus the frame's coords (24 MB),
// validity, ids and the L2-resident depth and features: ~214 MB, 0.064 ms
// at 3.35 TB/s. Measured (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6):
// 0.152-0.159 ms a frame in bf16 against 1.00-1.07 for the six per-camera
// launches and zero-fills it replaces; a slot map built with torch ops
// before the launch (0.07-0.15 ms of its own), one run of queries a CTA
// (more CTAs, each re-reading the ids) and 20 (fewer CTAs, the heavy blocks'
// tail) were slower.
//
// Backward (`lift_frame_backward_*`): given g = d numer (G, Q, C) fp32, into
// fp32 d depth (N, D, h, w) and d feat (N, h, w, C) that the caller zeroes:
//
//   gv = valid * g[ids[n,k], q, :], wk[p] = w2d[p] * sum_dz zw[dz] *
//        depth[z_dz, pix_p]
//   d feat[n, pix_p, c]     += wk[p] * gv[c]
//   d depth[n, z_dz, pix_p] += w2d[p] * zw[dz] * sum_c feat[n, pix_p, c] gv[c]
//
// A CTA per (camera, selected block), all N x K in one launch. Each lane
// first computes one query's weights; then the warp turns around for the
// scatter: per valid query, L lanes hold its channels (C = 16: 4 lanes of 4
// channels, 8 queries a warp at once), each pixel corner's 64 B of d feat go
// out as one float4 reduction a lane (a coalesced run), and the feat . gv
// dot products reduce across those lanes with shuffles before the 8 d depth
// adds. What bounds it: the coords and d numer rows that the valid queries
// read (at the flagship frame 1,271,772 queries and 1,187,531 distinct
// rows: 15.3 and 76.0 MB), the rest of the inputs (21.9 MB in bf16) and
// the 27.5 MB of fp32 gradients written: 140.7 MB, 0.042 ms at 3.35 TB/s;
// in practice the ~20 M float4 and ~10 M scalar reductions (~75 adds land
// on each d feat address, mostly from other CTAs along the same camera
// ray). Measured (same card): 0.362-0.364 ms a frame in bf16 against
// 1.50-1.62 for the six per-camera launches; scalar reductions of a lane per
// channel took 0.68-0.83. A shared-memory copy of each CTA's window of d
// feat (and d depth), summed with shared atomics and flushed once per
// nonzero element, cut the device-memory reductions ~7x but won at no
// budget: a tie at 8 KB (34 CTAs fit), 0.41-2.07 ms from 16 KB to 225 KB.
// A float atomicAdd into shared memory compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN) on sm_90a, and the window costs occupancy; both cost
// more than the contention they save.
// The reductions' order, hence the last bits of the sums, changes from run
// to run. Valid == 0 queries pass no gradient and are skipped.
//
// Depth-less mode (`depth` null, the `bilinear` field variant): the same two
// kernels with DEPTH = false sample the features alone, a 2-D bilinear
// sample with zeros padding at the query's (x, y) (its z is not read):
//
//   v[n,k,q,:] = sum_p w2d[p] * feat[n, pix_p, :] * valid[n,k,q]
//
// and the backward writes d feat only (d feat[n, pix_p, c] += w2d[p] gv[c];
// no depth is read and no d depth is written). It replaces, on the bilinear
// lift, the JAX package's corner table of each camera's depth-1 feature
// volume and the row gather over it (vampire_tpu/ops/pallas_tables.py:73
// `_corner_table_pallas`, sampling.py:287-332), and in training the table's
// VJP (pallas_tables.py:214 `_corner_table_bwd_impl`): with D = 1 the z0
// corner weighs 1 and the z1 corner lies outside the volume, so the table
// row's 8 corners reduce to these 4 pixels. The design is the depth mode's
// (one launch a frame, output-stationary, numer and denom written once, no
// atomics forward); only the depth reads, the z weights and the d depth
// reductions go. What bounds it is what bounds the depth mode less the
// depth: the numer and denom writes and the frame's coords, validity, ids
// and features read once.
//
// The kernels allocate nothing; the caller owns every buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // forward CTA
constexpr int kRounds = 4;        // forward: runs of queries a CTA
constexpr int kBwdThreads = 256;  // backward CTA
constexpr int kMaxCams = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// V consecutive channels as fp32 (V = 4: one 16-byte or 8-byte load)
template <int V>
__device__ __forceinline__ void load_channels(const float* p, float (&o)[V]) {
  if constexpr (V == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    o[0] = f.x; o[1] = f.y; o[2] = f.z; o[3] = f.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = p[j];
  }
}
template <int V>
__device__ __forceinline__ void load_channels(const __nv_bfloat16* p,
                                              float (&o)[V]) {
  if constexpr (V == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = __bfloat162float(p[j]);
  }
}

// One axis of torch grid_sample, align_corners=False, zeros padding:
// clamped corner indices, weights zeroed where the corner is out of bounds.
// The coordinate rounds as the plain version's, step by step: a fused
// multiply-add would move x by up to an ulp of the image width, which moves
// the fractional weights by ~1e-5 (measured: 4.1e-5 on the bilinear lift's
// O(5) sums against the plain version, on an H100).
__device__ __forceinline__ void prep_axis(float coord, int size, int idx[2],
                                          float w[2]) {
  const float x = __fsub_rn(__fmul_rn(__fadd_rn(coord, 1.0f),
                                      static_cast<float>(size)),
                            1.0f) / 2.0f;
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

// A query's corners: clamped indices and per-axis weights.
struct Taps {
  int xi[2], yi[2], zi[2];
  float xw[2], yw[2], zw[2];
};

// DEPTH = false (depth-less mode) reads no z and leaves zi, zw unset.
template <bool DEPTH>
__device__ __forceinline__ Taps taps(const float* c, int D, int H, int W) {
  Taps t;
  prep_axis(c[0], W, t.xi, t.xw);
  prep_axis(c[1], H, t.yi, t.yw);
  if constexpr (DEPTH) prep_axis(c[2], D, t.zi, t.zw);
  return t;
}

// Pixel corner p = 2 dy + dx's weight: w2d * (0 + zw0 * depth[z0, pix] +
// zw1 * depth[z1, pix]), the plain version's order; w2d alone in the
// depth-less mode.
template <bool DEPTH, typename T>
__device__ __forceinline__ float corner_weight(const T* dep, const Taps& t,
                                               int p, int plane, int W) {
  const int dy = p >> 1, dx = p & 1;
  if constexpr (!DEPTH) return t.yw[dy] * t.xw[dx];
  const int pix = t.yi[dy] * W + t.xi[dx];
  float s = 0.0f;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    s = s + t.zw[dz] * to_f32(dep[t.zi[dz] * plane + pix]);
  }
  return t.yw[dy] * t.xw[dx] * s;
}

// Forward. grid (ceil(Q / (qpc * kRounds)), G). Thread: query lq = tid / L
// of each run, channels lane * V ... + V (L = C / V lanes a query, qpc =
// kThreads / L queries a run). C = 16 runs V = 4, with SPLIT in the depth
// mode: lane p of a query computes pixel corner p's weight and the four
// lanes share them (a depth-less weight is one product: every lane takes
// all four); any other C runs V = 1, a lane a channel.
template <typename T, int V, bool SPLIT, bool DEPTH>
__global__ void __launch_bounds__(kThreads)
lift_frame_kernel(const T* __restrict__ depth, const T* __restrict__ feat,
                  const int64_t* __restrict__ ids,
                  const float* __restrict__ coords,
                  const float* __restrict__ valid, float* __restrict__ numer,
                  float* __restrict__ denom, int N, int D, int H, int W,
                  int C, int K, int Q) {
  // each camera's slot of block g: the k with ids[n, k] == g, or -1
  __shared__ int slot[kMaxCams];
  const int g = blockIdx.y;
  if (threadIdx.x < N) slot[threadIdx.x] = -1;
  __syncthreads();
  for (int i = threadIdx.x; i < N * K; i += blockDim.x) {
    if (ids[i] == g) slot[i / K] = i % K;
  }
  __syncthreads();

  const int L = C / V;
  const int qpc = kThreads / L;
  const int lq = threadIdx.x / L;
  const int lane = threadIdx.x - lq * L;
  if (lq >= qpc) return;  // idle threads where L does not divide kThreads
  const int plane = H * W;
  const int64_t dstride = static_cast<int64_t>(D) * plane;
  const int64_t fstride = static_cast<int64_t>(plane) * C;

  for (int r = 0; r < kRounds; ++r) {
    const int q0 = (blockIdx.x * kRounds + r) * qpc + lq;
    if (!SPLIT && q0 >= Q) return;
    const int q = min(q0, Q - 1);  // SPLIT: every lane takes the shuffles
    float acc[V], cnt[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = cnt[j] = 0.0f;
    for (int n = 0; n < N; ++n) {
      const int k = slot[n];
      if (k < 0) continue;
      const int64_t t = (static_cast<int64_t>(n) * K + k) * Q + q;
      const Taps tp = taps<DEPTH>(coords + t * 3, D, H, W);
      const float vmask = valid[t];
      const T* dep = DEPTH ? depth + n * dstride : nullptr;
      const T* fe = feat + n * fstride + lane * V;
      float wk[4];
      if constexpr (SPLIT) {
        const float mine = corner_weight<DEPTH>(dep, tp, lane, plane, W);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          wk[p] = __shfl_sync(0xffffffffu, mine, (threadIdx.x & 28) | p);
        }
      } else {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          wk[p] = corner_weight<DEPTH>(dep, tp, p, plane, W);
        }
      }
      float s[V];
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] = 0.0f;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float f[V];
        load_channels<V>(fe + (tp.yi[p >> 1] * W + tp.xi[p & 1]) * C, f);
#pragma unroll
        for (int j = 0; j < V; ++j) s[j] = s[j] + f[j] * wk[p];
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float v = s[j] * vmask;
        acc[j] = acc[j] + v;
        cnt[j] = cnt[j] + ((fabsf(v) > 0.0f) ? 1.0f : 0.0f);
      }
    }
    if (q0 >= Q) continue;
    const int64_t o = (static_cast<int64_t>(g) * Q + q) * C + lane * V;
    if constexpr (V == 4) {
      __stcs(reinterpret_cast<float4*>(numer + o),
             make_float4(acc[0], acc[1], acc[2], acc[3]));
      __stcs(reinterpret_cast<float4*>(denom + o),
             make_float4(cnt[0], cnt[1], cnt[2], cnt[3]));
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        __stcs(numer + o + j, acc[j]);
        __stcs(denom + o + j, cnt[j]);
      }
    }
  }
}

// Backward. grid (K, N), kBwdThreads threads. L lanes a query in the
// scatter (a power of two >= C / V, at most 32), V channels a lane (V = 4:
// float4 reductions into d feat). DEPTH = false reads no depth and no
// features and writes no d depth.
template <typename T, int V, bool DEPTH>
__global__ void __launch_bounds__(kBwdThreads)
lift_frame_backward_kernel(const T* __restrict__ depth,
                           const T* __restrict__ feat,
                           const int64_t* __restrict__ ids,
                           const float* __restrict__ coords,
                           const float* __restrict__ valid,
                           const float* __restrict__ g_numer,
                           float* __restrict__ d_depth,
                           float* __restrict__ d_feat, int D, int H, int W,
                           int C, int K, int Q, int G, int L) {
  __shared__ int live_lane[kBwdThreads];  // per warp: its live queries' lanes
  const int k = blockIdx.x, n = blockIdx.y;
  const int64_t gid = ids[static_cast<int64_t>(n) * K + k];
  if (gid < 0 || gid >= G) return;
  const int64_t t0 = (static_cast<int64_t>(n) * K + k) * Q;
  const int plane = H * W;
  const T* dep = DEPTH ? depth + static_cast<int64_t>(n) * D * plane
                      : nullptr;
  const T* fe = feat + static_cast<int64_t>(n) * plane * C;
  float* dd = DEPTH ? d_depth + static_cast<int64_t>(n) * D * plane : nullptr;
  float* df = d_feat + static_cast<int64_t>(n) * plane * C;
  const float* gq = g_numer + gid * Q * C;
  const int lane = threadIdx.x & 31;
  const int P = 32 / L;          // queries a warp scatters at once
  const int slotq = lane / L;    // which of them this lane serves
  const int li = lane - slotq * L;
  const int c0 = li * V;
  const bool cl = c0 < C;        // lanes past C / V idle in the scatter
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  int* lanes_of = live_lane + warp * 32;

  for (int base = warp * 32; base < Q; base += nwarps * 32) {
    // a lane a query: its weights
    const int q = base + lane;
    float vm = 0.0f;
    Taps tp{};
    float wk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (q < Q) {
      vm = valid[t0 + q];
      if (vm != 0.0f) {
        tp = taps<DEPTH>(coords + (t0 + q) * 3, D, H, W);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          wk[p] = corner_weight<DEPTH>(dep, tp, p, plane, W);
        }
      }
    }
    const unsigned live = __ballot_sync(0xffffffffu, vm != 0.0f);
    const int nlive = __popc(live);
    __syncwarp();  // the last batch's reads of lanes_of are done
    if (vm != 0.0f) lanes_of[__popc(live & ((1u << lane) - 1u))] = lane;
    __syncwarp();

    // L lanes a query: its channels
    for (int r = 0; r < nlive; r += P) {
      const int j = r + slotq;  // the j-th live query of the warp
      const int src = (j < nlive) ? lanes_of[j] : 0;
      const bool act = (j < nlive) && cl;
      const int sq = __shfl_sync(0xffffffffu, q, src);
      const float svm = __shfl_sync(0xffffffffu, vm, src);
      int yi[2], xi[2], zi[2];
      float yw[2], xw[2], zw[2], swk[4];
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        yi[d] = __shfl_sync(0xffffffffu, tp.yi[d], src);
        xi[d] = __shfl_sync(0xffffffffu, tp.xi[d], src);
        yw[d] = __shfl_sync(0xffffffffu, tp.yw[d], src);
        xw[d] = __shfl_sync(0xffffffffu, tp.xw[d], src);
        if constexpr (DEPTH) {
          zi[d] = __shfl_sync(0xffffffffu, tp.zi[d], src);
          zw[d] = __shfl_sync(0xffffffffu, tp.zw[d], src);
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) swk[p] = __shfl_sync(0xffffffffu, wk[p], src);
      float gv[V];
      if (act) {
        load_channels<V>(gq + static_cast<int64_t>(sq) * C + c0, gv);
      } else {
#pragma unroll
        for (int c = 0; c < V; ++c) gv[c] = 0.0f;
      }
#pragma unroll
      for (int c = 0; c < V; ++c) gv[c] = gv[c] * svm;
      float dwk[4];  // feat[pix_p] . gv, summed over the query's lanes
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int pix = yi[p >> 1] * W + xi[p & 1];
        if constexpr (DEPTH) {
          float part = 0.0f;
          if (act) {
            float f[V];
            load_channels<V>(fe + pix * C + c0, f);
#pragma unroll
            for (int c = 0; c < V; ++c) part = part + f[c] * gv[c];
          }
          for (int o = L >> 1; o > 0; o >>= 1) {
            part += __shfl_xor_sync(0xffffffffu, part, o);
          }
          dwk[p] = part;
        }
        if (act && swk[p] != 0.0f) {
          float* out = df + pix * C + c0;
          if constexpr (V == 4) {
            atomicAdd(reinterpret_cast<float4*>(out),
                      make_float4(swk[p] * gv[0], swk[p] * gv[1],
                                  swk[p] * gv[2], swk[p] * gv[3]));
          } else {
#pragma unroll
            for (int c = 0; c < V; ++c) atomicAdd(out + c, swk[p] * gv[c]);
          }
        }
      }
      // the query's 8 d depth adds, spread over its lanes
      if (DEPTH && j < nlive) {
        for (int i = li; i < 8; i += L) {
          const int p = i >> 1, dz = i & 1;
          const float w2d = yw[p >> 1] * xw[p & 1];
          if (w2d == 0.0f || zw[dz] == 0.0f) continue;
          atomicAdd(dd + zi[dz] * plane + yi[p >> 1] * W + xi[p & 1],
                    w2d * zw[dz] * dwk[p]);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* depth, const void* feat, const void* ids,
           const void* coords, const void* valid, void* numer, void* denom,
           int N, int D, int H, int W, int C, int K, int Q, int G,
           void* stream) {
  if (G == 0 || Q == 0) return static_cast<int>(cudaSuccess);
  const int L = (C == 16) ? 4 : C;
  const int per = kThreads / L * kRounds;
  const dim3 grid((Q + per - 1) / per, G);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* dp = static_cast<const T*>(depth);
  const T* fp = static_cast<const T*>(feat);
  const int64_t* ip = static_cast<const int64_t*>(ids);
  const float* cp = static_cast<const float*>(coords);
  const float* vp = static_cast<const float*>(valid);
  float* np_ = static_cast<float*>(numer);
  float* dn = static_cast<float*>(denom);
  if (dp != nullptr && C == 16) {
    lift_frame_kernel<T, 4, true, true><<<grid, kThreads, 0, s>>>(
        dp, fp, ip, cp, vp, np_, dn, N, D, H, W, C, K, Q);
  } else if (dp != nullptr) {
    lift_frame_kernel<T, 1, false, true><<<grid, kThreads, 0, s>>>(
        dp, fp, ip, cp, vp, np_, dn, N, D, H, W, C, K, Q);
  } else if (C == 16) {
    lift_frame_kernel<T, 4, false, false><<<grid, kThreads, 0, s>>>(
        dp, fp, ip, cp, vp, np_, dn, N, D, H, W, C, K, Q);
  } else {
    lift_frame_kernel<T, 1, false, false><<<grid, kThreads, 0, s>>>(
        dp, fp, ip, cp, vp, np_, dn, N, D, H, W, C, K, Q);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_backward(const void* depth, const void* feat, const void* ids,
                    const void* coords, const void* valid, const void* g_numer,
                    void* d_depth, void* d_feat, int N, int D, int H, int W,
                    int C, int K, int Q, int G, void* stream) {
  if (K == 0 || N == 0 || Q == 0) return static_cast<int>(cudaSuccess);
  const int V = (C % 4 == 0) ? 4 : 1;
  int L = 1;
  while (L * V < C) L *= 2;
  const dim3 grid(K, N);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* dp = static_cast<const T*>(depth);
  const T* fp = static_cast<const T*>(feat);
  const int64_t* ip = static_cast<const int64_t*>(ids);
  const float* cp = static_cast<const float*>(coords);
  const float* vp = static_cast<const float*>(valid);
  const float* gp = static_cast<const float*>(g_numer);
  float* ddp = static_cast<float*>(d_depth);
  float* dfp = static_cast<float*>(d_feat);
  if (dp != nullptr && V == 4) {
    lift_frame_backward_kernel<T, 4, true><<<grid, kBwdThreads, 0, s>>>(
        dp, fp, ip, cp, vp, gp, ddp, dfp, D, H, W, C, K, Q, G, L);
  } else if (dp != nullptr) {
    lift_frame_backward_kernel<T, 1, true><<<grid, kBwdThreads, 0, s>>>(
        dp, fp, ip, cp, vp, gp, ddp, dfp, D, H, W, C, K, Q, G, L);
  } else if (V == 4) {
    lift_frame_backward_kernel<T, 4, false><<<grid, kBwdThreads, 0, s>>>(
        dp, fp, ip, cp, vp, gp, ddp, dfp, D, H, W, C, K, Q, G, L);
  } else {
    lift_frame_backward_kernel<T, 1, false><<<grid, kBwdThreads, 0, s>>>(
        dp, fp, ip, cp, vp, gp, ddp, dfp, D, H, W, C, K, Q, G, L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns the CUDA error code
// of the launch: 0 on success. A null `depth` (and, backward, `d_depth`)
// selects the depth-less mode, where D is not read.
extern "C" int lift_frame_f32(const void* depth, const void* feat,
                              const void* ids, const void* coords,
                              const void* valid, void* numer, void* denom,
                              int N, int D, int H, int W, int C, int K, int Q,
                              int G, void* stream) {
  return launch<float>(depth, feat, ids, coords, valid, numer, denom, N, D,
                       H, W, C, K, Q, G, stream);
}

extern "C" int lift_frame_bf16(const void* depth, const void* feat,
                               const void* ids, const void* coords,
                               const void* valid, void* numer, void* denom,
                               int N, int D, int H, int W, int C, int K, int Q,
                               int G, void* stream) {
  return launch<__nv_bfloat16>(depth, feat, ids, coords, valid, numer, denom,
                               N, D, H, W, C, K, Q, G, stream);
}

extern "C" int lift_frame_backward_f32(const void* depth, const void* feat,
                                       const void* ids, const void* coords,
                                       const void* valid, const void* g_numer,
                                       void* d_depth, void* d_feat, int N,
                                       int D, int H, int W, int C, int K,
                                       int Q, int G, void* stream) {
  return launch_backward<float>(depth, feat, ids, coords, valid, g_numer,
                                d_depth, d_feat, N, D, H, W, C, K, Q, G,
                                stream);
}

extern "C" int lift_frame_backward_bf16(const void* depth, const void* feat,
                                        const void* ids, const void* coords,
                                        const void* valid,
                                        const void* g_numer, void* d_depth,
                                        void* d_feat, int N, int D, int H,
                                        int W, int C, int K, int Q, int G,
                                        void* stream) {
  return launch_backward<__nv_bfloat16>(depth, feat, ids, coords, valid,
                                        g_numer, d_depth, d_feat, N, D, H, W,
                                        C, K, Q, G, stream);
}
