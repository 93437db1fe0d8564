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
// What bounds it: pure data movement. At the flagship shape, (22, 20, 256,
// 256) bf16 -> (21, 257, 257, 176) bf16, it reads 58 MB and writes 488 MB,
// eight copies of every value; the 488 MB of writes set the floor (~0.15 ms
// at 3.35 TB/s on an H100 SXM). This version takes ~0.64 ms there (700 W),
// ~760 GB/s written: the staging loads, which do an integer division per
// 2-byte element, are now the limit.
//
// Design (first, simple version): one block per (bz, by, run of TX output
// x positions). The block stages the input it needs, the 2 (z) x 2 (y)
// planes of TX+1 x positions for all C channels, in shared memory, reading
// each (z, y, c) run of x contiguously; zeros fill the padded border. It then
// writes its TX * 8C outputs, which are contiguous in the table, 16 bytes per
// thread per step, so every warp store is coalesced and wide. (Storing one
// element per thread took as long in bf16 as in fp32: the per-element index
// arithmetic, not the bytes, was the limit.) The values are copied, not
// computed: the table is byte-identical to the plain version. The kernel
// allocates nothing; the caller owns both buffers, and `out` must be 16-byte
// aligned.
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
constexpr int kMaxTx = 64;
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

// T is the element's bit pattern: uint16_t for bf16, uint32_t for fp32. The
// table is a copy, so no value is ever converted; 0 bits are +0.0 in both.
template <typename T>
__global__ void corner_table_kernel(const T* __restrict__ vol,
                                    T* __restrict__ out, int C, int D, int H,
                                    int W, int tx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // s[p][xi][c], p = dz*2 + dy, xi = 0..tx (input x = x0 - 1 + xi)
  T* s = reinterpret_cast<T*>(smem_raw);
  const int x0 = blockIdx.x * tx;  // first output bx of this block
  const int by = blockIdx.y;
  const int bz = blockIdx.z;
  const int nx = min(tx, W + 1 - x0);  // output x positions of this block
  const int span = nx + 1;

  const int nload = 4 * C * span;
  for (int i = threadIdx.x; i < nload; i += blockDim.x) {
    const int xi = i % span;
    const int rest = i / span;
    const int c = rest % C;
    const int p = rest / C;
    const int z = bz - 1 + (p >> 1);
    const int y = by - 1 + (p & 1);
    const int x = x0 - 1 + xi;
    T v = 0;
    if (z >= 0 && z < D && y >= 0 && y < H && x >= 0 && x < W) {
      v = vol[((static_cast<int64_t>(c) * D + z) * H + y) * W + x];
    }
    s[(p * (tx + 1) + xi) * C + c] = v;
  }
  __syncthreads();

  // stores: the block's nx * 8C outputs are contiguous and start 16-byte
  // aligned (a row is 16*C bytes in bf16, 32*C in fp32), so each thread
  // assembles 16 bytes from shared memory and stores them at once
  constexpr int V = 16 / sizeof(T);
  const int row = 8 * C;
  T* o = out + ((static_cast<int64_t>(bz) * (H + 1) + by) * (W + 1) + x0) *
                   row;
  const int nchunk = nx * row / V;
  for (int i = threadIdx.x; i < nchunk; i += blockDim.x) {
    const int e = i * V;
    int bx = e / row;
    const int r = e - bx * row;
    int k = r / C;
    int c = r - k * C;
    union {
      uint4 u;
      T v[V];
    } pack;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      // k = (dz*2 + dy)*2 + dx: staging plane k >> 1, x offset k & 1
      pack.v[j] = s[((k >> 1) * (tx + 1) + bx + (k & 1)) * C + c];
      if (++c == C) {
        c = 0;
        if (++k == 8) {
          k = 0;
          ++bx;
        }
      }
    }
    reinterpret_cast<uint4*>(o)[i] = pack.u;
  }
}

template <typename T>
int launch(const void* vol, void* out, int C, int D, int H, int W,
           void* stream) {
  if (C <= 0 || D <= 0 || H <= 0 || W <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the widest run of x positions whose staging fits the default 48 KB
  int tx = kMaxTx;
  while (tx > 1 && static_cast<int64_t>(4) * (tx + 1) * C * sizeof(T) >
                       kSmemBytes) {
    tx /= 2;
  }
  const size_t smem = static_cast<size_t>(4) * (tx + 1) * C * sizeof(T);
  if (smem > kSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + 1 + tx - 1) / tx, H + 1, D + 1);
  if (grid.y > 65535 || grid.z > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  corner_table_kernel<T><<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vol), static_cast<T*>(out), C, D, H, W, tx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns the CUDA error code
// of the launch: 0 on success.
extern "C" int corner_table_f32(const void* vol, void* out, int C, int D,
                                int H, int W, void* stream) {
  return launch<uint32_t>(vol, out, C, D, H, W, stream);
}

extern "C" int corner_table_bf16(const void* vol, void* out, int C, int D,
                                 int H, int W, void* stream) {
  return launch<uint16_t>(vol, out, C, D, H, W, stream);
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
