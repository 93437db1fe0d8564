// Row-gather and bulk-copy probes on Hopper: four kernels, each a copy of
// the input's bits (the one-hot product is exact), so each matches its
// plain version in vampire_tpu_torch/ops/gather_probe.py bit for bit.
//
// They replace the Pallas probe kernels of the JAX package's scripts/,
// which measured what a gather of table rows costs, the access pattern of
// the ray march (one 8*C-channel corner-table row per sample; at the
// flagship shape 1,387,029 rows of 176 bf16 = 352 B):
//
// 1. row_gather: out[q] = tab[idx[q]] for rows whose byte width is a
//    multiple of 16, or per lane out[q, j] = tab[idx[q, j], j] for 2- and
//    4-byte elements. Replaces scripts/perf_vmem_gather.py:123 `gk_tala`,
//    scripts/perf_r3_gather_layouts.py:74 `gk_col`, :126 `gk_loop2` and, in
//    per-lane mode, :95 `gk_full`. Bound: the bytes it must move, the
//    output, the distinct rows the indices touch and the indices, at
//    3.35 TB/s. Design: one warp per query row (lanes over its 16-byte
//    pieces, `ld.global.nc` loads and 16-byte stores; a 352 B row keeps 22
//    lanes busy); per lane, one thread per element. The TPU kernels held
//    the table resident in VMEM; a block's 227 KB of shared memory cannot
//    hold the 8 MB f32 probe table, so it is not tiled through shared
//    memory: it fits the 50 MB L2, which keeps it between launches.
//
// 2. onehot_gather_mma: out = sum_j onehot(idx - j*RB) @ bf16(tab_j) in fp32
//    on the tensor cores, which equals f32(bf16(tab))[idx]. Replaces
//    scripts/perf_vmem_gather.py:164 `gk_onehot`. Bound: the function needs
//    no arithmetic, so its bytes (output, table, indices at 3.35 TB/s;
//    0.163 ms at the script's shapes); the one-hot method's 2*Q*R*W
//    multiply-adds need 4.45 ms at 989 TFLOP/s bf16, the floor of this
//    design and not of the function. Design: `mma.sync` m16n8k16 bf16 with
//    fp32 accumulators; a block of 8 warps takes 128 queries (16 a warp)
//    and every column, and walks the whole table in 64-row tiles staged in
//    shared memory; each warp builds its one-hot A fragments in registers
//    from its queries' indices (1.0 = 0x3F80 where the index hits the k
//    column) and reads its B fragments from the staged tile. One product
//    per output value is nonzero, so the fp32 sum is exact (a table holding
//    inf or NaN would poison every output through 0 * inf, as the one-hot
//    product of the TPU kernel would). The RB chunks of the TPU kernel are
//    its grid axis; here the walk over the table is a loop in the block.
//
// 3. block_copy_tma: out block i = tab block i, or tab block perm[i], of
//    B rows each, copied through shared memory by the bulk-copy engine
//    (1-D TMA): `cp.async.bulk` global -> shared completing on an mbarrier,
//    then shared -> global in a bulk group. Replaces
//    scripts/perf_r3_dma_control.py:27 `k_static`, :56 `k_dyn` and the
//    capacity probe of scripts/perf_vmem_gather.py:64. Bound: the table
//    read once and written once. Design: one thread of one block per
//    (block, chunk); a chunk is what fits the block's dynamic shared memory
//    (a 512-row block of 512 B rows is 256 KB, more than a block may hold).
//    The capacity probe is the same kernel asked for S bytes of dynamic
//    shared memory, through which one row is staged: it runs for every S up
//    to 232,448 B (227 KB), and above that the launch is refused, which
//    the wrapper reports by raising.
//
// 4. row_gather_tma: out[q] = tab[idx[q]] by one bulk copy per row, with
//    `depth` copies in flight. Replaces scripts/perf_r3_dma_gather.py:66
//    `dma_kernel`, scripts/perf_r3_dma_bisect.py:79 `k_s1` (depth 1) and
//    :96 `k_s2`, scripts/perf_r3_dma_sweep.py:41 and
//    scripts/perf_r4_dma_scale.py:49 `make_dma_gather`, and :184
//    `make_dma_gather_unrolled` (unroll > 1). Bound: as row_gather.
//    Design: one warp per block of BQ queries. Lane 0 issues the copies,
//    each into one of `depth` shared-memory slots with its own mbarrier
//    (phase parity = use count & 1); the warp waits for a slot, writes its
//    row out with 16-byte stores, and lane 0 refills the slot with the row
//    `depth` queries ahead. The warp reads the indices 32 at a time with
//    one coalesced load and shuffles each to lane 0, as the TPU kernels
//    read theirs from SMEM. On an H100 80GB HBM3 at 700 W,
//    tools/gather_probe.py measures ~0.45 us a row per warp whatever the
//    depth (1 to 32), so with few blocks (Q = 2^16..2^20 at BQ = 2048 or
//    4096) it loses to index_select; loading each index in lane 0 from
//    device memory, as a first version did, cost only ~5 % of that. With unroll u it drains u slots and then
//    issues u copies, as the unrolled TPU kernel does. Hopper's TMA has no
//    row-gather mode, so per-row copies issued by one thread are the
//    counterpart of the TPU's per-row DMAs.
//
// These kernels are right and simple; none is tuned. Each entry point
// returns the CUDA error of its launch (0 when it launched); the caller
// owns every buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// 1-D bulk copy global -> shared, completing `bytes` on the barrier.
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 1-D bulk copy shared -> global in a bulk group, committed and waited for.
__device__ __forceinline__ void bulk_s2g_wait(void* dst, uint32_t src,
                                              uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// generic-proxy accesses of shared memory before later async-proxy ones
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------ row_gather

// One warp per query: out row q = tab row idx[q], in 16-byte pieces.
__global__ void row_gather_rows_kernel(const uint4* __restrict__ tab,
                                       const int* __restrict__ idx,
                                       uint4* __restrict__ out, int64_t Q,
                                       int pieces) {
  const int64_t q =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (q >= Q) return;
  const int lane = threadIdx.x & 31;
  const uint4* src = tab + static_cast<int64_t>(idx[q]) * pieces;
  uint4* dst = out + q * pieces;
  for (int c = lane; c < pieces; c += 32) dst[c] = __ldg(src + c);
}

// One thread per element: out[q, j] = tab[idx[q, j], j].
template <typename T>
__global__ void row_gather_lanes_kernel(const T* __restrict__ tab,
                                        const int* __restrict__ idx,
                                        T* __restrict__ out, int64_t n,
                                        int W) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int j = static_cast<int>(i % W);
  out[i] = __ldg(tab + static_cast<int64_t>(idx[i]) * W + j);
}

// ----------------------------------------------------- onehot_gather_mma

constexpr int kOhWarps = 8;           // 16 queries per warp
constexpr int kOhRows = 64;           // table rows staged per tile
constexpr int kOhMaxTiles = 16;       // W <= 128 = 16 n-tiles of 8

// the two bf16 one-hot values of columns k and k + 1 for index i
__device__ __forceinline__ uint32_t onehot2(int i, int k) {
  return (i == k ? 0x3F80u : 0u) | (i == k + 1 ? 0x3F800000u : 0u);
}

__global__ void onehot_gather_mma_kernel(const uint16_t* __restrict__ tab,
                                         const int* __restrict__ idx,
                                         float* __restrict__ out, int64_t Q,
                                         int R, int W) {
  __shared__ __align__(16) uint16_t tile[kOhRows * 8 * kOhMaxTiles];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // group id: fragment rows g and g + 8
  const int t = lane & 3;   // thread in group: fragment columns 2t, 2t + 1
  const int nt = W / 8;
  const int pieces = W / 8;  // 16-byte pieces of a bf16 row
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * (kOhWarps * 16) +
                     warp * 16;
  const int ia = (q0 + g < Q) ? idx[q0 + g] : -1;
  const int ib = (q0 + g + 8 < Q) ? idx[q0 + g + 8] : -1;

  float acc[kOhMaxTiles][4];
#pragma unroll
  for (int n = 0; n < kOhMaxTiles; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  }

  for (int kb = 0; kb < R; kb += kOhRows) {
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < kOhRows * pieces; e += blockDim.x) {
      const int row = e / pieces;
      const int c = e - row * pieces;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (kb + row < R) {
        v = __ldg(reinterpret_cast<const uint4*>(
                      tab + static_cast<int64_t>(kb + row) * W) +
                  c);
      }
      reinterpret_cast<uint4*>(tile)[row * pieces + c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kOhRows; ks += 16) {
      const int k = kb + ks + 2 * t;
      const uint32_t a0 = onehot2(ia, k);      // row g,     k 2t..2t+1
      const uint32_t a1 = onehot2(ib, k);      // row g + 8, k 2t..2t+1
      const uint32_t a2 = onehot2(ia, k + 8);  // row g,     k 2t+8..2t+9
      const uint32_t a3 = onehot2(ib, k + 8);  // row g + 8, k 2t+8..2t+9
      const uint16_t* b = tile + (ks + 2 * t) * W + g;
#pragma unroll
      for (int n = 0; n < kOhMaxTiles; ++n) {
        if (n < nt) {
          // B fragment: (k 2t, 2t+1) and (k 2t+8, 2t+9) of column 8n + g
          const uint32_t b0 = static_cast<uint32_t>(b[8 * n]) |
                              (static_cast<uint32_t>(b[W + 8 * n]) << 16);
          const uint32_t b1 =
              static_cast<uint32_t>(b[8 * W + 8 * n]) |
              (static_cast<uint32_t>(b[9 * W + 8 * n]) << 16);
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
              "{%0, %1, %2, %3};\n"
              : "+f"(acc[n][0]), "+f"(acc[n][1]), "+f"(acc[n][2]),
                "+f"(acc[n][3])
              : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
        }
      }
    }
  }

  // C fragment: (row g, columns 2t, 2t+1) and (row g + 8, the same)
#pragma unroll
  for (int n = 0; n < kOhMaxTiles; ++n) {
    if (n < nt) {
      const int col = 8 * n + 2 * t;
      if (q0 + g < Q) {
        float* o = out + (q0 + g) * W + col;
        o[0] = acc[n][0];
        o[1] = acc[n][1];
      }
      if (q0 + g + 8 < Q) {
        float* o = out + (q0 + g + 8) * W + col;
        o[0] = acc[n][2];
        o[1] = acc[n][3];
      }
    }
  }
}

// -------------------------------------------------------- block_copy_tma

// Block (blockIdx.x) of the output, chunk blockIdx.y: a one-thread block
// stages it through the dynamic shared memory [mbarrier | 8 B pad | chunk].
__global__ void block_copy_tma_kernel(const char* __restrict__ src,
                                      char* __restrict__ dst,
                                      const int* __restrict__ perm,
                                      int64_t block_bytes, int chunk_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t b = blockIdx.x;
  const int64_t off = static_cast<int64_t>(blockIdx.y) * chunk_bytes;
  const int64_t sb = perm ? perm[b] : b;
  const int64_t left = block_bytes - off;
  const uint32_t n = static_cast<uint32_t>(
      left < chunk_bytes ? left : static_cast<int64_t>(chunk_bytes));
  const uint32_t bar = smem_u32(smem);
  const uint32_t buf = smem_u32(smem + 16);
  mbar_init(bar, 1);
  fence_mbar_init();
  mbar_expect_tx(bar, n);
  bulk_g2s(buf, src + sb * block_bytes + off, n, bar);
  mbar_wait(bar, 0);
  bulk_s2g_wait(dst + b * block_bytes + off, buf, n);
}

// -------------------------------------------------------- row_gather_tma

// One warp per block of bq queries; dynamic shared memory holds `depth`
// mbarriers (padded to 16 B) and then `depth` row slots.
__global__ void row_gather_tma_kernel(const char* __restrict__ tab,
                                      const int* __restrict__ idx,
                                      char* __restrict__ out, int64_t Q,
                                      int row_bytes, int depth, int unroll,
                                      int bq) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* slots = smem + ((depth * 8 + 15) & ~15);
  const int lane = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * bq;
  const int n = static_cast<int>(Q - base < bq ? Q - base : bq);
  const int pieces = row_bytes / 16;
  // the indices of the 32 rows from the one next issued (a multiple of 32),
  // one a lane: read with one coalesced load, handed to lane 0 by a shuffle
  int window = lane < n ? idx[base + lane] : 0;

  // Issue row j of the block into its slot; called by the whole warp for
  // j = 0, 1, 2, ... in order (j < n).
  auto issue = [&](int j) {
    if (j % 32 == 0 && j > 0) window = j + lane < n ? idx[base + j + lane] : 0;
    const int64_t row = __shfl_sync(0xffffffffu, window, j % 32);
    if (lane == 0) {
      const int s = j % depth;
      const uint32_t bar = smem_u32(bars + s);
      mbar_expect_tx(bar, row_bytes);
      bulk_g2s(smem_u32(slots + static_cast<int64_t>(s) * row_bytes),
               tab + row * row_bytes, row_bytes, bar);
    }
  };

  if (lane == 0) {
    for (int s = 0; s < depth; ++s) mbar_init(smem_u32(bars + s), 1);
    fence_mbar_init();
  }
  __syncwarp();
  for (int j = 0; j < depth && j < n; ++j) issue(j);
  for (int g0 = 0; g0 < n; g0 += unroll) {
    const int g1 = (g0 + unroll < n) ? g0 + unroll : n;
    for (int r = g0; r < g1; ++r) {
      const int s = r % depth;
      mbar_wait(smem_u32(bars + s), (r / depth) & 1);
      const uint4* src = reinterpret_cast<const uint4*>(
          slots + static_cast<int64_t>(s) * row_bytes);
      uint4* dst = reinterpret_cast<uint4*>(out + (base + r) * row_bytes);
      for (int c = lane; c < pieces; c += 32) dst[c] = src[c];
    }
    fence_proxy_async();  // this lane's slot reads before the refills
    __syncwarp();
    for (int r = g0; r < g1 && r + depth < n; ++r) issue(r + depth);
  }
}

int launch_error() { return static_cast<int>(cudaGetLastError()); }

// Allow `bytes` of dynamic shared memory for `kernel`. A refusal is returned
// and cleared, so that no later launch check of the process sees it.
template <typename K>
int allow_smem(K kernel, int bytes) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

extern "C" int row_gather_rows(const void* tab, const void* idx, void* out,
                               long long Q, int row_bytes, void* stream) {
  const int pieces = row_bytes / 16;
  const int64_t blocks = (Q + 7) / 8;  // 8 warps, 8 queries a block
  row_gather_rows_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(tab), static_cast<const int*>(idx),
      static_cast<uint4*>(out), Q, pieces);
  return launch_error();
}

extern "C" int row_gather_lanes(const void* tab, const void* idx, void* out,
                                long long Q, int W, int elem_bytes,
                                void* stream) {
  const int64_t n = Q * W;
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    row_gather_lanes_kernel<uint32_t><<<blocks, 256, 0, s>>>(
        static_cast<const uint32_t*>(tab), static_cast<const int*>(idx),
        static_cast<uint32_t*>(out), n, W);
  } else if (elem_bytes == 2) {
    row_gather_lanes_kernel<uint16_t><<<blocks, 256, 0, s>>>(
        static_cast<const uint16_t*>(tab), static_cast<const int*>(idx),
        static_cast<uint16_t*>(out), n, W);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_error();
}

extern "C" int onehot_gather_mma(const void* tab, const void* idx, void* out,
                                 long long Q, int R, int W, void* stream) {
  if (W % 8 != 0 || W > 8 * kOhMaxTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t per_block = kOhWarps * 16;
  const unsigned blocks = static_cast<unsigned>((Q + per_block - 1) /
                                                per_block);
  onehot_gather_mma_kernel<<<blocks, kOhWarps * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(tab), static_cast<const int*>(idx),
      static_cast<float*>(out), Q, R, W);
  return launch_error();
}

extern "C" int block_copy_tma(const void* src, void* dst, const void* perm,
                              long long n_blocks, long long block_bytes,
                              int smem_bytes, void* stream) {
  const int chunk = (smem_bytes - 16) & ~15;
  if (chunk < 16) return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_smem(block_copy_tma_kernel, smem_bytes);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(n_blocks),
                  static_cast<unsigned>((block_bytes + chunk - 1) / chunk));
  block_copy_tma_kernel<<<grid, 1, smem_bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(src), static_cast<char*>(dst),
      static_cast<const int*>(perm), block_bytes, chunk);
  return launch_error();
}

extern "C" int row_gather_tma(const void* tab, const void* idx, void* out,
                              long long Q, int row_bytes, int depth,
                              int unroll, int bq, void* stream) {
  const int smem = ((depth * 8 + 15) & ~15) + depth * row_bytes;
  const int err = allow_smem(row_gather_tma_kernel, smem);
  if (err != 0) return err;
  const unsigned blocks = static_cast<unsigned>((Q + bq - 1) / bq);
  row_gather_tma_kernel<<<blocks, 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(tab), static_cast<const int*>(idx),
      static_cast<char*>(out), Q, row_bytes, depth, unroll, bq);
  return launch_error();
}
