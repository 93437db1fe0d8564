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
// Depth-less mode (the `bilinear` field variant): kernels of their own
// sample the features alone, a 2-D bilinear sample with zeros padding at
// the query's (x, y) (its z is not read):
//
//   v[n,k,q,:] = sum_p w2d[p] * feat[n, pix_p, :] * valid[n,k,q]
//
// and the backward writes d feat only (d feat[n, pix_p, c] += w2d[p] gv[c]).
// They replace, on the bilinear lift, the JAX package's corner table of
// each camera's depth-1 feature volume and the row gather over it
// (vampire_tpu/ops/pallas_tables.py:73 `_corner_table_pallas`,
// sampling.py:287-332), and in training the table's VJP (pallas_tables.py:
// 214 `_corner_table_bwd_impl`): with D = 1 the z0 corner weighs 1 and the
// z1 corner lies outside the volume, so the table row's 8 corners reduce to
// these 4 pixels.
//
// Forward (`slot_map`, then `lift_bilinear_*`): output-stationary as the
// depth mode, the same terms summed in the same order, so the same bits.
// A CTA a camera first writes the frame's (N, G) slot map; each output
// CTA then reads its block's N slots (instead of scanning the frame's
// N x K ids); each (query, camera) pair's taps are computed once, by one
// of the query's lanes, and shuffled to the others; zero-validity samples
// read no features. What bounds it: the 168 MB of numer and denom written
// once and the frame's coords, validity and features read once, ~202 MB,
// 0.060 ms at 3.35 TB/s. Measured (NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md §6, ms a frame, calls back to back): 0.089 in bf16 against the
// depth mode's design's 0.100; two queries a thread at once (more
// registers, fewer warps) 0.130, one or 16 runs of queries a CTA instead
// of 4 0.100 and 0.102.
//
// Backward (`lift_bilinear_backward`): a CTA per (camera, selected block),
// as the depth mode, but the terms are summed before they reach device
// memory. On the flagship frame the 5.07 M (query, pixel corner) terms of
// nonzero weight land on 0.74 M distinct (CTA, pixel) pairs, 6.8 a pair.
// The CTA bins its valid queries by their top-left pixel corner in shared
// memory with integer atomics only (a counting sort: counts, a scan, a
// scatter of query indices), then sums each bin's queries for its 4 corner
// pixels in registers and issues one float4 reduction a (corner, 4
// channels): 2.7 queries a non-empty bin, ~4x fewer reductions than one a
// term. Summing each pixel's terms instead (one reduction a pixel, ~2.5x
// fewer still) read each g row four times and lost; so did carrying a
// bin's right column into the next along a row. A CTA whose bins' box
// exceeds kMaxBins (15 % of the CTAs here, the blocks nearest a camera,
// with ~1.4 queries a bin) scatters each term as the depth mode does.
// What bounds it: the 0.031 ms of its bytes; in practice the reductions
// and the bins' dependent loads. Measured (same card): 0.106 ms a frame
// with the zeroing of d feat, against 0.174 for the depth mode's design.
//
// The kernels allocate nothing; the caller owns every buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // forward CTA
constexpr int kRounds = 4;        // forward: runs of queries a CTA
constexpr int kBwdThreads = 256;  // backward CTA
constexpr int kMaxCams = 32;
constexpr int kSlotThreads = 256; // slot map CTA
constexpr int kSlotTile = 4096;   // slot map: blocks staged at once
constexpr int kBilRounds = 4;     // depth-less forward: runs of queries a CTA
constexpr int kMaxBins = 1024;    // depth-less backward: the largest bin box
// the depth-less backward's routes of a CTA
constexpr int kRouteNone = 0;     // no block (an id outside [0, G))
constexpr int kRouteSorted = 1;
constexpr int kRouteDirect = 2;

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
// `axis_floor` gives the unclamped lower corner and its fraction w1.
__device__ __forceinline__ void axis_floor(float coord, int size, int& i0,
                                           float& w1) {
  const float x = __fsub_rn(__fmul_rn(__fadd_rn(coord, 1.0f),
                                      static_cast<float>(size)),
                            1.0f) / 2.0f;
  const float x0 = floorf(x);
  w1 = x - x0;
  i0 = static_cast<int>(x0);
}

__device__ __forceinline__ void prep_axis(float coord, int size, int idx[2],
                                          float w[2]) {
  int i0;
  float w1;
  axis_floor(coord, size, i0, w1);
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
// kThreads / L queries a run). C = 16 runs V = 4 with SPLIT: lane p of a
// query computes pixel corner p's weight and the four lanes share them;
// any other C runs V = 1, a lane a channel. The depth mode's; the
// depth-less mode has its own kernel below.
template <typename T, int V, bool SPLIT>
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
      const Taps tp = taps<true>(coords + t * 3, D, H, W);
      const float vmask = valid[t];
      const T* dep = depth + n * dstride;
      const T* fe = feat + n * fstride + lane * V;
      float wk[4];
      if constexpr (SPLIT) {
        const float mine = corner_weight<true>(dep, tp, lane, plane, W);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          wk[p] = __shfl_sync(0xffffffffu, mine, (threadIdx.x & 28) | p);
        }
      } else {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          wk[p] = corner_weight<true>(dep, tp, p, plane, W);
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

// Backward, the scatter of a CTA's queries: grid (K, N), kBwdThreads
// threads, CTA (k, n) owns camera n's selected block ids[n, k]. L lanes a
// query in the scatter (a power of two >= C / V, at most 32), V channels a
// lane (V = 4: float4 reductions into d feat). DEPTH = false reads no depth
// and no features and writes no d depth: the depth-less backward's direct
// route.
template <typename T, int V, bool DEPTH>
__device__ __forceinline__ void scatter_queries(
    const T* __restrict__ depth, const T* __restrict__ feat,
    const int64_t* __restrict__ ids, const float* __restrict__ coords,
    const float* __restrict__ valid, const float* __restrict__ g_numer,
    float* __restrict__ d_depth, float* __restrict__ d_feat, int D, int H,
    int W, int C, int K, int Q, int G, int L) {
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
  scatter_queries<T, V, DEPTH>(depth, feat, ids, coords, valid, g_numer,
                               d_depth, d_feat, D, H, W, C, K, Q, G, L);
}

// The slot map of a frame: slots[n, g] = k where ids[n, k] == g, else -1
// (ids outside [0, G) ignored). grid N, kSlotThreads threads: CTA n stages
// its row kSlotTile entries at a time in shared memory (filled with -1, then
// each selected block's k) and writes it out once, coalesced.
__global__ void __launch_bounds__(kSlotThreads)
slot_map_kernel(const int64_t* __restrict__ ids, int* __restrict__ slots,
                int K, int G) {
  __shared__ int row[kSlotTile];
  const int n = blockIdx.x;
  const int64_t* idn = ids + static_cast<int64_t>(n) * K;
  int* out = slots + static_cast<int64_t>(n) * G;
  for (int t0 = 0; t0 < G; t0 += kSlotTile) {
    const int span = min(kSlotTile, G - t0);
    for (int i = threadIdx.x; i < span; i += blockDim.x) row[i] = -1;
    __syncthreads();
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const int64_t i = idn[k] - t0;
      if (i >= 0 && i < span) row[i] = k;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < span; i += blockDim.x) out[t0 + i] = row[i];
    __syncthreads();
  }
}

// The depth-less forward. grid (ceil(Q / (kBilRounds * qpr)), G),
// kThreads threads; CTA (x, g) owns block g's queries [x * kBilRounds *
// qpr, ...), qpr = 8 warps x qpw queries a round. L = C / V lanes a query
// (qpw = 32 / L queries a warp), V channels a lane. Warp 0 reads the
// block's N slots from the slot map and lists the selecting cameras in
// order; then, per round, each of a query's L lanes computes the taps (4
// pixel offsets, 4 weights, the validity) of one camera of the list, so a
// (query, camera) pair's taps are computed once, and the accumulate loop
// takes each camera's taps from their lane by shuffles, in camera order,
// and sums its samples as the depth mode does. A sample of zero validity
// reads no features (it adds nothing: v = s * 0 is a zero for finite
// features).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
lift_bilinear_kernel(const T* __restrict__ feat, const int* __restrict__ slots,
                     const float* __restrict__ coords,
                     const float* __restrict__ valid, float* __restrict__ numer,
                     float* __restrict__ denom, int N, int H, int W, int C,
                     int K, int Q, int G) {
  __shared__ int cam[kMaxCams];        // the selecting cameras, in order
  __shared__ int64_t first[kMaxCams];  // their (n K + k) Q
  __shared__ int ncam_s;
  const int g = blockIdx.y;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    const int k = (lane < N) ? slots[static_cast<int64_t>(lane) * G + g] : -1;
    const unsigned sel = __ballot_sync(0xffffffffu, k >= 0);
    if (k >= 0) {
      const int at = __popc(sel & ((1u << lane) - 1u));
      cam[at] = lane;
      first[at] = (static_cast<int64_t>(lane) * K + k) * Q;
    }
    if (lane == 0) ncam_s = __popc(sel);
  }
  __syncthreads();
  const int ncam = ncam_s;
  const int L = C / V;
  const int qpw = 32 / L;
  const int lq = lane / L;
  const int li = lane - lq * L;
  const int base = lq * L;             // the query's first lane
  const bool mine = lq < qpw;          // lanes past qpw * L idle
  const int qpr = (kThreads / 32) * qpw;
  const int64_t fstride = static_cast<int64_t>(H) * W * C;

  for (int r = 0; r < kBilRounds; ++r) {
    const int q = (blockIdx.x * kBilRounds + r) * qpr + (threadIdx.x >> 5) *
                  qpw + lq;
    float acc[V], cnt[V];
#pragma unroll
    for (int c = 0; c < V; ++c) acc[c] = cnt[c] = 0.0f;
    for (int j0 = 0; j0 < ncam; j0 += L) {
      // this lane's camera j0 + li: the query's taps
      const int j = j0 + li;
      int off[4] = {0, 0, 0, 0};
      float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float vm = 0.0f;
      if (mine && j < ncam && q < Q) {
        const int64_t t = first[j] + q;
        vm = valid[t];
        int xi[2], yi[2];
        float xw[2], yw[2];
        prep_axis(coords[t * 3], W, xi, xw);
        prep_axis(coords[t * 3 + 1], H, yi, yw);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          off[p] = (yi[p >> 1] * W + xi[p & 1]) * C;
          w[p] = yw[p >> 1] * xw[p & 1];
        }
      }
      const int nj = min(L, ncam - j0);
      for (int jj = 0; jj < nj; ++jj) {
        const int src = base + jj;
        const float svm = __shfl_sync(0xffffffffu, vm, src);
        int so[4];
        float sw[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          so[p] = __shfl_sync(0xffffffffu, off[p], src);
          sw[p] = __shfl_sync(0xffffffffu, w[p], src);
        }
        if (svm == 0.0f) continue;
        const T* fe = feat + cam[j0 + jj] * fstride + li * V;
        float fv[4][V];
#pragma unroll
        for (int p = 0; p < 4; ++p) load_channels<V>(fe + so[p], fv[p]);
        float s[V];
#pragma unroll
        for (int c = 0; c < V; ++c) s[c] = 0.0f;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
#pragma unroll
          for (int c = 0; c < V; ++c) s[c] = s[c] + fv[p][c] * sw[p];
        }
#pragma unroll
        for (int c = 0; c < V; ++c) {
          const float v = s[c] * svm;
          acc[c] = acc[c] + v;
          cnt[c] = cnt[c] + ((fabsf(v) > 0.0f) ? 1.0f : 0.0f);
        }
      }
    }
    if (!mine || q >= Q) continue;
    const int64_t o = (static_cast<int64_t>(g) * Q + q) * C + li * V;
    if constexpr (V == 4) {
      __stcs(reinterpret_cast<float4*>(numer + o),
             make_float4(acc[0], acc[1], acc[2], acc[3]));
      __stcs(reinterpret_cast<float4*>(denom + o),
             make_float4(cnt[0], cnt[1], cnt[2], cnt[3]));
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) {
        __stcs(numer + o + c, acc[c]);
        __stcs(denom + o + c, cnt[c]);
      }
    }
  }
}

// An exclusive prefix sum of the n ints a[0, n) in place, with a[n] = the
// total, by one block of kBwdThreads threads.
__device__ __forceinline__ void block_scan(int* a, int n, int* warp_sums) {
  const int per = (n + kBwdThreads - 1) / kBwdThreads;
  const int lo = min(n, threadIdx.x * per), hi = min(n, lo + per);
  int mine = 0;
  for (int i = lo; i < hi; ++i) mine += a[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = incl - mine;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  for (int i = lo; i < hi; ++i) {
    const int c = a[i];
    a[i] = before;
    before += c;
  }
  if (threadIdx.x == kBwdThreads - 1) a[n] = before;
  __syncthreads();
}

// The depth-less backward. grid (K, N), kBwdThreads threads; CTA (k, n)
// owns camera n's selected block ids[n, k] and writes routes[n * K + k]
// where routes is not null (kRouteNone: no block; kRouteSorted;
// kRouteDirect). Sorted route, where Q fits the shared arrays (`sortable`)
// and the valid queries' bins fit kMaxBins: each valid query's bin is its
// unclamped top-left pixel corner (y0, x0), its fractions and validity go
// to shared memory; the CTA takes the bins' bounding box (integer shared
// min/max), counts the queries a bin with integer shared atomics, scans the
// counts and scatters the query indices into bin order. Then L lanes a
// bin (V channels a lane) sum its queries' terms in registers for each of
// its 4 corner pixels (y0 + dy, x0 + dx), weight yw[dy] xw[dx], two
// queries' g rows in flight, and issue one reduction a (corner pixel, V
// channels) into d feat. A CTA whose box exceeds kMaxBins takes the direct
// route: the scatter of every (query, corner) term (`scatter_queries`).
template <int V>
__global__ void __launch_bounds__(kBwdThreads)
lift_bilinear_backward_kernel(const int64_t* __restrict__ ids,
                              const float* __restrict__ coords,
                              const float* __restrict__ valid,
                              const float* __restrict__ g_numer,
                              float* __restrict__ d_feat,
                              int* __restrict__ routes, int H, int W, int C,
                              int K, int Q, int G, int L, bool sortable) {
  extern __shared__ float bins_smem[];
  __shared__ int box[4];               // bins' y min, x min, y max, x max
  __shared__ int warp_sums[kBwdThreads / 32];
  const int k = blockIdx.x, n = blockIdx.y;
  const int64_t gid = ids[static_cast<int64_t>(n) * K + k];
  int* route = routes ? routes + static_cast<int64_t>(n) * K + k : nullptr;
  if (gid < 0 || gid >= G) {
    if (route && threadIdx.x == 0) *route = kRouteNone;
    return;
  }
  if (sortable) {
    const int64_t t0 = (static_cast<int64_t>(n) * K + k) * Q;
    float* fx = bins_smem;
    float* fy = fx + Q;
    float* vms = fy + Q;
    int* key = reinterpret_cast<int*>(vms + Q);
    int* start = key + Q;
    unsigned short* order =
        reinterpret_cast<unsigned short*>(start + kMaxBins + 1);
    if (threadIdx.x == 0) {
      box[0] = box[1] = INT_MAX;
      box[2] = box[3] = INT_MIN;
    }
    __syncthreads();
    // 1. each valid query's bin, shifted by one so that it is >= 0, where
    // one of its corners can lie in the image
    int ylo = INT_MAX, xlo = INT_MAX, yhi = INT_MIN, xhi = INT_MIN;
    for (int q = threadIdx.x; q < Q; q += kBwdThreads) {
      const float vm = valid[t0 + q];
      int packed = -1;
      if (vm != 0.0f) {
        int x0, y0;
        float wx, wy;
        axis_floor(coords[(t0 + q) * 3], W, x0, wx);
        axis_floor(coords[(t0 + q) * 3 + 1], H, y0, wy);
        if (x0 >= -1 && x0 < W && y0 >= -1 && y0 < H) {
          fx[q] = wx;
          fy[q] = wy;
          vms[q] = vm;
          packed = ((y0 + 1) << 16) | (x0 + 1);
          ylo = min(ylo, y0 + 1);
          yhi = max(yhi, y0 + 1);
          xlo = min(xlo, x0 + 1);
          xhi = max(xhi, x0 + 1);
        }
      }
      key[q] = packed;
    }
    ylo = __reduce_min_sync(0xffffffffu, ylo);
    xlo = __reduce_min_sync(0xffffffffu, xlo);
    yhi = __reduce_max_sync(0xffffffffu, yhi);
    xhi = __reduce_max_sync(0xffffffffu, xhi);
    if ((threadIdx.x & 31) == 0 && yhi >= ylo) {
      atomicMin(&box[0], ylo);
      atomicMin(&box[1], xlo);
      atomicMax(&box[2], yhi);
      atomicMax(&box[3], xhi);
    }
    __syncthreads();
    const int by0 = box[0], bx0 = box[1];
    if (box[2] < by0) {                // no query reaches the image
      if (route && threadIdx.x == 0) *route = kRouteSorted;
      return;
    }
    const int bh = box[2] - by0 + 1, bw = box[3] - bx0 + 1;
    if (bh * bw <= kMaxBins) {
      const int nb = bh * bw;
      // 2. the count of each bin and each query's rank in its bin
      for (int i = threadIdx.x; i <= nb; i += kBwdThreads) start[i] = 0;
      __syncthreads();
      for (int q = threadIdx.x; q < Q; q += kBwdThreads) {
        const int kq = key[q];
        if (kq < 0) continue;
        const int b = ((kq >> 16) - by0) * bw + ((kq & 0xffff) - bx0);
        const int rank = atomicAdd(&start[b], 1);
        key[q] = (b << 16) | rank;
      }
      __syncthreads();
      // 3. the bins' starts; 4. the queries in bin order
      block_scan(start, nb, warp_sums);
      for (int q = threadIdx.x; q < Q; q += kBwdThreads) {
        const int kq = key[q];
        if (kq >= 0) order[start[kq >> 16] + (kq & 0xffff)] = q;
      }
      __syncthreads();
      // 5. L lanes a bin, P bins a warp: the bin's queries' terms summed
      // in registers for each of its 4 corner pixels, then one reduction
      // a corner in the image
      const float* gq = g_numer + gid * Q * C;
      float* df = d_feat + static_cast<int64_t>(n) * H * W * C;
      const int lane = threadIdx.x & 31;
      const int P = 32 / L;
      const int slot = lane / L;
      const int c0 = (lane - slot * L) * V;
      const int step = (kBwdThreads / 32) * P;
      if (slot < P && c0 < C) {
        for (int b = (threadIdx.x >> 5) * P + slot; b < nb; b += step) {
          const int e0 = start[b], e1 = start[b + 1];
          if (e0 == e1) continue;
          float s[4][V];
#pragma unroll
          for (int p = 0; p < 4; ++p) {
#pragma unroll
            for (int c = 0; c < V; ++c) s[p][c] = 0.0f;
          }
#pragma unroll 2
          for (int e = e0; e < e1; ++e) {
            const int q = order[e];
            float gv[V];
            load_channels<V>(gq + static_cast<int64_t>(q) * C + c0, gv);
            const float wy[2] = {1.0f - fy[q], fy[q]};
            const float wx[2] = {1.0f - fx[q], fx[q]};
            const float vq = vms[q];
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              const float wq = wy[p >> 1] * wx[p & 1];
#pragma unroll
              for (int c = 0; c < V; ++c) {
                s[p][c] = s[p][c] + wq * (gv[c] * vq);
              }
            }
          }
          const int y0 = by0 + b / bw - 1, x0 = bx0 + b % bw - 1;
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int y = y0 + (p >> 1), x = x0 + (p & 1);
            if (y < 0 || y >= H || x < 0 || x >= W) continue;
            float* out = df + (y * W + x) * C + c0;
            if constexpr (V == 4) {
              atomicAdd(reinterpret_cast<float4*>(out),
                        make_float4(s[p][0], s[p][1], s[p][2], s[p][3]));
            } else {
#pragma unroll
              for (int c = 0; c < V; ++c) atomicAdd(out + c, s[p][c]);
            }
          }
        }
      }
      if (route && threadIdx.x == 0) *route = kRouteSorted;
      return;
    }
  }
  if (route && threadIdx.x == 0) *route = kRouteDirect;
  scatter_queries<float, V, false>(nullptr, nullptr, ids, coords, valid,
                                   g_numer, nullptr, d_feat, 1, H, W, C, K, Q,
                                   G, L);
}

template <typename T>
int launch(const void* depth, const void* feat, const void* ids,
           const void* coords, const void* valid, void* numer, void* denom,
           int N, int D, int H, int W, int C, int K, int Q, int G,
           void* stream) {
  if (depth == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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
  if (C == 16) {
    lift_frame_kernel<T, 4, true><<<grid, kThreads, 0, s>>>(
        dp, fp, ip, cp, vp, np_, dn, N, D, H, W, C, K, Q);
  } else {
    lift_frame_kernel<T, 1, false><<<grid, kThreads, 0, s>>>(
        dp, fp, ip, cp, vp, np_, dn, N, D, H, W, C, K, Q);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_slot_map(const void* ids, void* slots, int N, int K, int G,
                    void* stream) {
  if (N == 0 || G == 0) return static_cast<int>(cudaSuccess);
  slot_map_kernel<<<N, kSlotThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ids), static_cast<int*>(slots), K, G);
  return static_cast<int>(cudaGetLastError());
}

// The slot map into `slots`, then the depth-less forward reading it.
template <typename T>
int launch_bilinear(const void* feat, const void* ids, void* slots,
                    const void* coords, const void* valid, void* numer,
                    void* denom, int N, int H, int W, int C, int K, int Q,
                    int G, void* stream) {
  if (G == 0 || Q == 0) return static_cast<int>(cudaSuccess);
  const int err = launch_slot_map(ids, slots, N, K, G, stream);
  if (err != 0) return err;
  const bool v4 = C % 4 == 0;
  const int qpr = kThreads / 32 * (32 / (v4 ? C / 4 : C));
  const int per = qpr * kBilRounds;
  const dim3 grid((Q + per - 1) / per, G);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* fp = static_cast<const T*>(feat);
  const int* sp = static_cast<const int*>(slots);
  const float* cp = static_cast<const float*>(coords);
  const float* vp = static_cast<const float*>(valid);
  float* np_ = static_cast<float*>(numer);
  float* dn = static_cast<float*>(denom);
  if (v4) {
    lift_bilinear_kernel<T, 4><<<grid, kThreads, 0, s>>>(
        fp, sp, cp, vp, np_, dn, N, H, W, C, K, Q, G);
  } else {
    lift_bilinear_kernel<T, 1><<<grid, kThreads, 0, s>>>(
        fp, sp, cp, vp, np_, dn, N, H, W, C, K, Q, G);
  }
  return static_cast<int>(cudaGetLastError());
}

// The shared memory of the depth-less backward's sorted route: fx, fy,
// validity and key a query, kMaxBins + 1 bin starts, a 16-bit index a query.
size_t bins_smem_bytes(int Q) {
  return static_cast<size_t>(Q) * 16 + (kMaxBins + 1) * 4 +
         static_cast<size_t>(Q) * 2;
}

int launch_bilinear_backward(const void* ids, const void* coords,
                             const void* valid, const void* g_numer,
                             void* d_feat, void* routes, int N, int H, int W,
                             int C, int K, int Q, int G, void* stream) {
  if (K == 0 || N == 0 || Q == 0) return static_cast<int>(cudaSuccess);
  const int V = (C % 4 == 0) ? 4 : 1;
  int L = 1;
  while (L * V < C) L *= 2;
  // the sorted route packs a query's index and its rank in 16 bits and a
  // bin's shifted (y, x) in 15 and 16; its arrays stay within the 48 KB a
  // block may ask for without an attribute
  const size_t smem = bins_smem_bytes(Q);
  const bool sortable = Q < 65536 && H < 32767 && W < 65535 &&
                        smem <= 48 * 1024;
  const dim3 grid(K, N);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* ip = static_cast<const int64_t*>(ids);
  const float* cp = static_cast<const float*>(coords);
  const float* vp = static_cast<const float*>(valid);
  const float* gp = static_cast<const float*>(g_numer);
  float* dfp = static_cast<float*>(d_feat);
  int* rp = static_cast<int*>(routes);
  const size_t dyn = sortable ? smem : 0;
  if (V == 4) {
    lift_bilinear_backward_kernel<4><<<grid, kBwdThreads, dyn, s>>>(
        ip, cp, vp, gp, dfp, rp, H, W, C, K, Q, G, L, sortable);
  } else {
    lift_bilinear_backward_kernel<1><<<grid, kBwdThreads, dyn, s>>>(
        ip, cp, vp, gp, dfp, rp, H, W, C, K, Q, G, L, sortable);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_backward(const void* depth, const void* feat, const void* ids,
                    const void* coords, const void* valid, const void* g_numer,
                    void* d_depth, void* d_feat, int N, int D, int H, int W,
                    int C, int K, int Q, int G, void* stream) {
  if (depth == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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
  if (V == 4) {
    lift_frame_backward_kernel<T, 4, true><<<grid, kBwdThreads, 0, s>>>(
        dp, fp, ip, cp, vp, gp, ddp, dfp, D, H, W, C, K, Q, G, L);
  } else {
    lift_frame_backward_kernel<T, 1, true><<<grid, kBwdThreads, 0, s>>>(
        dp, fp, ip, cp, vp, gp, ddp, dfp, D, H, W, C, K, Q, G, L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns the CUDA error code
// of the launch: 0 on success. `lift_frame_*` and `lift_frame_backward_*`
// are the depth mode; `lift_bilinear_*` (the slot map into `slots`, then
// the forward: two launches, one call) and `lift_bilinear_backward` the
// depth-less mode (the backward reads no features, so one entry serves
// both dtypes); `slot_map` the slot map alone.
extern "C" int slot_map(const void* ids, void* slots, int N, int K, int G,
                        void* stream) {
  return launch_slot_map(ids, slots, N, K, G, stream);
}

extern "C" int lift_bilinear_f32(const void* feat, const void* ids,
                                 void* slots, const void* coords,
                                 const void* valid, void* numer, void* denom,
                                 int N, int H, int W, int C, int K, int Q,
                                 int G, void* stream) {
  return launch_bilinear<float>(feat, ids, slots, coords, valid, numer, denom,
                                N, H, W, C, K, Q, G, stream);
}

extern "C" int lift_bilinear_bf16(const void* feat, const void* ids,
                                  void* slots, const void* coords,
                                  const void* valid, void* numer, void* denom,
                                  int N, int H, int W, int C, int K, int Q,
                                  int G, void* stream) {
  return launch_bilinear<__nv_bfloat16>(feat, ids, slots, coords, valid,
                                        numer, denom, N, H, W, C, K, Q, G,
                                        stream);
}

extern "C" int lift_bilinear_backward(const void* ids, const void* coords,
                                      const void* valid, const void* g_numer,
                                      void* d_feat, void* routes, int N,
                                      int H, int W, int C, int K, int Q, int G,
                                      void* stream) {
  return launch_bilinear_backward(ids, coords, valid, g_numer, d_feat, routes,
                                  N, H, W, C, K, Q, G, stream);
}

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
