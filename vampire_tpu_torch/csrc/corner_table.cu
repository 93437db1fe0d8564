// Corner-block table of a channels-first volume.
//
// Replaces the TPU kernel vampire_tpu/ops/pallas_tables.py:73
// `_corner_table_pallas`, whose semantics are `_corner_table_xla` (:65):
//
//   vol (C, D, H, W) -> out (D+1, H+1, W+1, 8*C)
//   out[bz, by, bx, k*C + c] = pad(vol)[c, bz+dz, by+dy, bx+dx],
//   k = (dz*2 + dy)*2 + dx, zeros outside the volume.
//
// It reads the port's channels-first field directly (the JAX kernel takes a
// channels-last (D, H, W, C) volume), so no permuted copy is made first.
//
// What bounds it: the writes. At the flagship shape, (22, 20, 256, 256)
// bf16 -> (21, 257, 257, 176) bf16, it reads 58 MB and writes 488 MB, eight
// copies of every value: 0.163 ms at 3.35 TB/s, and a zero_() of the table
// takes 0.160 ms on an H100 (700 W). The first version (a block per 64
// positions, a division per staged value, a carry chain per stored value)
// was bound by instructions at 0.64 ms; this one takes about 0.24 ms in
// bf16 and 0.48 ms in fp32 (PERF.md, where the bisect is).
//
// Design: one CTA per output row (bz, by), whole rows where they fit in
// shared memory (the flagship's: 45 KB in bf16, 91 KB in fp32), else row
// segments. The CTA stages its four input planes (z = bz-1, bz by y =
// by-1, by) with 16-byte loads into runs of W + 2 values with the zero
// border columns written in, then writes the row's (W+1) * 8C values,
// which are contiguous in the table, with a fixed per-thread pattern and
// 16-byte streaming stores. Many small CTAs (five an SM in bf16) overlap
// one CTA's staging with the others' stores. Measured and not kept
// (PERF.md): persistent CTAs walking y that stage each plane once for two rows
// (by TMA boxes or cp.async, transposed or read as landed) and a bulk
// store from a shared tile; TMA lands a box's runs on a 16-byte pitch,
// where the store's lanes, reading one column of many channels, conflict
// on the banks, and a box must start on 16 bytes in x.
//
// The values are copied, never converted: the table is byte-identical to
// the plain version, NaN and inf included. The kernel allocates nothing;
// the caller owns both buffers, the table on 16 bytes (a field that does
// not start on 16 bytes is staged a value a lane).
//
// Backward (`corner_table_backward_*`): the table build is linear, and its
// transpose replaces `_corner_table_bwd_impl`
// (vampire_tpu/ops/pallas_tables.py:214-226), the VJP of the TPU build:
//
//   d vol[c, z, y, x] = sum_k g[z+1-dz, y+1-dy, x+1-dx, k*C + c]
//
// over the 8 corners k = (dz*2 + dy)*2 + dx, summed in fp32 in that order
// (the plain version's order, so the two agree bit for bit), from an fp32 or
// bf16 cotangent g. Each table value has exactly one reader: no atomics, and
// the result is deterministic. At the flagship shape it reads the 977 MB
// fp32 (or 488 MB bf16) cotangent once and writes the 115 MB fp32 d vol, so
// it is memory-bound. Design: one block per (z, y, run of 32 x positions).
// Its threads walk the block's (x, c) pairs with c fastest, so each warp
// reads runs of C consecutive values of neighbouring table rows, sum the 8
// corners in registers, and stage the sums in shared memory; the block then
// writes each channel's run of 32 x positions contiguously into the
// channels-first d vol.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;
constexpr int kBwdTx = 32;  // x positions per backward block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename G>
__global__ void corner_table_backward_kernel(const G* __restrict__ g,
                                             float* __restrict__ dvol, int C,
                                             int D, int H, int W) {
  extern __shared__ float s_sum[];  // s_sum[c * kBwdTx + xi]
  const int x0 = blockIdx.x * kBwdTx;
  const int y = blockIdx.y;
  const int z = blockIdx.z;
  const int nx = min(kBwdTx, W - x0);
  const int n = nx * C;
  const int64_t row_len = 8 * static_cast<int64_t>(C);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int xi = i / C;
    const int c = i - xi * C;
    const int x = x0 + xi;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
      const int64_t row =
          (static_cast<int64_t>(z + 1 - dz) * (H + 1) + (y + 1 - dy)) *
              (W + 1) + (x + 1 - dx);
      acc = acc + to_f32(g[row * row_len + k * C + c]);
    }
    s_sum[c * kBwdTx + xi] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = i / nx;
    const int xi = i - c * nx;
    dvol[((static_cast<int64_t>(c) * D + z) * H + y) * W + x0 + xi] =
        s_sum[c * kBwdTx + xi];
  }
}

template <typename G>
int launch_backward(const void* g, void* dvol, int C, int D, int H, int W,
                    void* stream) {
  if (C <= 0 || D <= 0 || H <= 0 || W <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(C) * kBwdTx * sizeof(float);
  if (smem > kSmemBytes || H > 65535 || D > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((W + kBwdTx - 1) / kBwdTx, H, D);
  corner_table_backward_kernel<G><<<grid, kThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const G*>(g), static_cast<float*>(dvol), C, D, H, W);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- the table

constexpr int kRouteVec16 = 0;   // 16-byte loads (rows of 16-byte multiples)
constexpr int kRouteScalar = 1;  // a load an element (any width)
constexpr int kMaxThreads = 512;  // the kernel's launch bound

// The launch's geometry, computed once on the host (make_table).
struct Table {
  int C, D, H, W;
  int seg;        // output positions a work item (a row or a row segment)
  int cols;       // staged columns a run: seg + 1
  int rows;       // (D+1)(H+1)
  int64_t items;  // rows x segments a row: the CTAs
};

// One CTA a work item: output row (bz, by), or its segment sg of positions
// [x0, x0 + seg). T: an element's bits (uint16_t bf16, uint32_t fp32);
// nothing is ever converted.
//
// Staging: plane p = dz*2 + dy (z = bz-1+dz, y = by-1+dy) and channel c
// form run p*C + c of `cols` values in shared memory, value x at column
// x - (x0 - 1); columns outside the volume (x = -1, x = W, and whole runs
// outside it in z or y) are zeros. A warp loads one run at a time: on the
// vec16 route in 16-byte loads (a row of the field starts on 16 bytes),
// else a value a lane. In bf16 a run is an odd number of 4-byte words at
// the flagship (W + 2 = 258 values), so the store's lanes, which read
// different channels at one column, hit different banks.
//
// Store: the CTA's threads are a multiple of the 16-byte chunks a position
// holds (C in bf16, 2C in fp32); a thread keeps one fixed chunk r of every
// position it stores. Value q = r*V + v of a position is corner k = q / C,
// channel c = q % C: run (k >> 1)*C + c at column pos + (k & 1). Those V
// offsets are computed once; a step is V shared loads, V additions and one
// 16-byte streaming store (st.global.cs), and a warp writes 512
// contiguous bytes a step.
template <typename T, int ROUTE>
__global__ void __launch_bounds__(kMaxThreads, 4)
    corner_table_kernel(const T* __restrict__ vol, T* __restrict__ out,
                        const Table t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  constexpr int V = 16 / sizeof(T);  // values a 16-byte chunk
  const int C = t.C, D = t.D, H = t.H, W = t.W, cols = t.cols;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nwarps = (nt + 31) >> 5;
  const int wlanes = min(32, nt - warp * 32);  // lanes of this warp

  const int sg = static_cast<int>(blockIdx.x / t.rows);
  const int rr = static_cast<int>(blockIdx.x - static_cast<int64_t>(sg) *
                                                   t.rows);
  const int bz = rr / (H + 1), by = rr - bz * (H + 1);
  const int x0 = sg * t.seg;
  const int npos = min(t.seg, W + 1 - x0);
  // the window's values in the volume: x = xa .. xb, at columns lead ..
  const int xa = max(x0 - 1, 0), xb = min(x0 + npos - 1, W - 1);
  const int lead = xa - (x0 - 1);

  for (int run = warp; run < 4 * C; run += nwarps) {
    const int p = run / C, c = run - p * C;
    const int z = bz - 1 + (p >> 1), y = by - 1 + (p & 1);
    T* d = s + run * cols;
    if (z < 0 || z >= D || y < 0 || y >= H) {
      for (int i = lane; i <= npos; i += wlanes) d[i] = 0;
      continue;
    }
    const T* src = vol + ((static_cast<int64_t>(c) * D + z) * H + y) * W;
    if (ROUTE == kRouteVec16) {
      const uint4* src4 = reinterpret_cast<const uint4*>(src);
      const bool whole = xa == 0 && xb == W - 1;  // no value to skip
      for (int k = xa / V + lane; k <= xb / V; k += wlanes) {
        union {
          uint4 u;
          T v[V];
        } pack;
        pack.u = __ldg(src4 + k);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int x = k * V + e;
          if (whole || (x >= xa && x <= xb)) d[x - (x0 - 1)] = pack.v[e];
        }
      }
    } else {
      for (int x = xa + lane; x <= xb; x += wlanes) {
        d[x - (x0 - 1)] = src[x];
      }
    }
    if (lane == 0) {
      for (int i = 0; i < lead; ++i) d[i] = 0;
      for (int i = xb - (x0 - 1) + 1; i <= npos; ++i) d[i] = 0;
    }
  }
  __syncthreads();

  const int chunks = C * static_cast<int>(sizeof(T)) / 2;
  const int r = tid % chunks;
  const int pos0 = tid / chunks;
  const int pps = nt / chunks;  // positions a step
  int src[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int q = r * V + v;
    const int k = q / C, c = q - k * C;
    src[v] = ((k >> 1) * C + c) * cols + (k & 1) + pos0;
  }
  uint4* o = reinterpret_cast<uint4*>(
                 out + ((static_cast<int64_t>(bz) * (H + 1) + by) * (W + 1) +
                        x0) * 8 * C) + tid;
  for (int pos = pos0; pos < npos; pos += pps) {
    union {
      uint4 u;
      T v[V];
    } pack;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      pack.v[v] = s[src[v]];
      src[v] += pps;
    }
    __stcs(o, pack.u);
    o += nt;
  }
}

// The shared memory a launch needs: 4C runs of seg + 1 values.
int64_t table_smem(int C, int elem, int seg) {
  return (4LL * C * (seg + 1) * elem + 15) & ~static_cast<int64_t>(15);
}

// The geometry of a launch of `threads` threads a CTA and `seg` positions a
// work item (ops/tables.py table_plan chooses both); false where they do not
// describe a feasible one.
bool make_table(Table* t, int C, int D, int H, int W, int elem, int threads,
                int seg) {
  if (C <= 0 || D <= 0 || H <= 0 || W <= 0 || seg <= 0 || seg > W + 1 ||
      threads <= 0 || threads > kMaxThreads ||
      threads % (C * elem / 2) != 0) {
    return false;
  }
  t->C = C;
  t->D = D;
  t->H = H;
  t->W = W;
  t->seg = seg;
  t->cols = seg + 1;
  t->rows = (D + 1) * (H + 1);
  t->items = static_cast<int64_t>(t->rows) * ((W + 1 + seg - 1) / seg);
  return t->items < (1LL << 31);
}

// The kernel instance for the element size and the route.
typedef void (*TableKernel)(const void*, void*, const Table);

template <typename T, int ROUTE>
TableKernel instance() {
  return reinterpret_cast<TableKernel>(&corner_table_kernel<T, ROUTE>);
}

TableKernel pick(int elem, int route) {
  if (elem == 4) {
    return route == kRouteVec16 ? instance<uint32_t, kRouteVec16>()
                                : instance<uint32_t, kRouteScalar>();
  }
  return route == kRouteVec16 ? instance<uint16_t, kRouteVec16>()
                              : instance<uint16_t, kRouteScalar>();
}

// Let the kernel take `smem` bytes of dynamic shared memory (the SM's
// shared memory carved out at its largest). A refusal is returned and
// cleared.
int allow_smem(TableKernel kernel, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return 0;
}

// The route: 16-byte loads where every row of the field starts on 16 bytes
// (vol does, and a row is a multiple of 16 bytes), else a value a lane.
// The route launched is written to *route.
int launch_table(const void* vol, void* out, int elem, int C, int D, int H,
                 int W, int threads, int seg, int* route, void* stream) {
  Table t;
  if (!make_table(&t, C, D, H, W, elem, threads, seg) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *route = reinterpret_cast<uintptr_t>(vol) % 16 == 0 &&
                   static_cast<int64_t>(W) * elem % 16 == 0
               ? kRouteVec16
               : kRouteScalar;
  // more than the card allows is refused by allow_smem
  const int64_t smem = table_smem(C, elem, seg);
  if (smem > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const TableKernel kernel = pick(elem, *route);
  const int err = allow_smem(kernel, static_cast<int>(smem));
  if (err != 0) return err;
  void* args[] = {const_cast<void**>(&vol), &out, &t};
  const cudaError_t e = cudaLaunchKernel(
      reinterpret_cast<const void*>(kernel),
      dim3(static_cast<unsigned>(t.items)), dim3(threads), args,
      static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns the CUDA error code
// of the launch: 0 on success.
//
// The table: CTAs of `threads` threads, one a work item of `seg` positions,
// as ops/tables.py `table_plan` plans them; the entry derives the grid, the
// shared memory and the route, and writes the route launched (0 vec16,
// 1 scalar) to *route. `out` must start on 16 bytes; vol may start
// anywhere (a vol not on 16 bytes takes the scalar route).
extern "C" int corner_table_f32(const void* vol, void* out, int C, int D,
                                int H, int W, int threads, int seg,
                                int* route, void* stream) {
  return launch_table(vol, out, 4, C, D, H, W, threads, seg, route, stream);
}

extern "C" int corner_table_bf16(const void* vol, void* out, int C, int D,
                                 int H, int W, int threads, int seg,
                                 int* route, void* stream) {
  return launch_table(vol, out, 2, C, D, H, W, threads, seg, route, stream);
}

// d vol (C, D, H, W) fp32 from the table cotangent, fp32 or bf16.
extern "C" int corner_table_backward_f32(const void* g, void* dvol, int C,
                                         int D, int H, int W, void* stream) {
  return launch_backward<float>(g, dvol, C, D, H, W, stream);
}

extern "C" int corner_table_backward_bf16(const void* g, void* dvol, int C,
                                          int D, int H, int W, void* stream) {
  return launch_backward<__nv_bfloat16>(g, dvol, C, D, H, W, stream);
}
