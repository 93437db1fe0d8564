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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTx = 64;
constexpr int kSmemBytes = 48 * 1024;

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
