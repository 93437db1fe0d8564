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
//    read once and written once; at 2 MB, and for the probe's one row, the
//    launch, which the host issues. Design: as many blocks as fit on the
//    card walk the (block, chunk) pairs; each block asks for `smem_bytes`
//    of dynamic shared memory, a ring of 4 chunks after its mbarriers, so
//    that loads run ahead of stores and a chunk is refilled once its store
//    has read it (`cp.async.bulk.wait_group.read`). The capacity probe is
//    the same kernel asked for S bytes, through which one row is staged: it
//    runs for every S up to 232,448 B (227 KB), and above that the card
//    refuses the shared memory, which the wrapper reports by raising. The
//    wrapper allows a size once, not at every launch. On an NVIDIA H100
//    80GB HBM3 at 700 W (tools/gather_probe.py): the 710 MB table in
//    0.4906 ms static and 0.4942 ms permuted (copy_ 0.4714, index_select
//    0.4880; one thread a (block, chunk), as before, 0.5133 and 0.5167);
//    the 2 MB control copy and the one-row probe in 0.010-0.018 ms, which
//    the host's ~13 us a launch sets.
//
// 4. row_gather_tma: out[q] = tab[idx[q]] by one bulk copy per row, with
//    `depth` copies in flight a block. Replaces
//    scripts/perf_r3_dma_gather.py:66 `dma_kernel`,
//    scripts/perf_r3_dma_bisect.py:79 `k_s1` (depth 1) and :96 `k_s2`,
//    scripts/perf_r3_dma_sweep.py:41 and scripts/perf_r4_dma_scale.py:49
//    `make_dma_gather`, and :184 `make_dma_gather_unrolled` (unroll > 1).
//    Bound: as row_gather. What bounded the first version, one warp per
//    BQ queries, was its issuing thread: ~0.45 us of serial instructions a
//    row (wait, copy out, fence, shuffle, issue), at every depth, with one
//    such thread on each of 32..256 SMs. Design: the TPU kernels copied each
//    row into its place in a VMEM output block that the pipeline wrote back;
//    here each row lands at its place in a tile of 4 KB of consecutive
//    output rows in shared memory, and one bulk store writes the full tile
//    out (with an L2 evict-first policy, so that table rows read again
//    stay in L2), so no thread reads a row and no proxy fence runs. One
//    thread a block issues, with counters in place of divisions, and the
//    grid holds as many blocks as fit on the card (9..26 an SM at the
//    tool's widths): issuers are multiplied, not only copies in flight.
//    Hopper's TMA has no row-gather mode, so per-row copies issued by one
//    thread are the counterpart of the TPU's per-row DMAs. On an NVIDIA
//    H100 80GB HBM3 at 700 W (tools/gather_probe.py): 2^16 rows in
//    0.019-0.022 ms at depths 1 and 8 (index_select 0.043; the first
//    design 0.93-0.99), 2^20 rows in 0.22-0.38 ms (0.63; 1.86-1.91), and
//    the ray stage's 2^22 rows of 352 B in 1.2173 ms at depth 8 (2.5246;
//    1.2761).
//
// The first two kernels are right and simple, not tuned; the last two were
// redesigned for this card (PERF.md). Each entry point returns the
// CUDA error of its launch (0 when it launched); the caller owns every
// buffer.

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

// 1-D bulk copy shared -> global, committed as one bulk group.
__device__ __forceinline__ void bulk_s2g(void* dst, uint32_t src,
                                         uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The same with an L2 policy for the lines written (from `createpolicy`).
__device__ __forceinline__ void bulk_s2g(void* dst, uint32_t src,
                                         uint32_t bytes, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint "
      "[%0], [%1], %2, %3;\n" ::"l"(dst),
      "r"(src), "r"(bytes), "l"(policy)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// An L2 policy that evicts the lines it covers first.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// Wait until at most one bulk group, the newest, still reads shared memory.
__device__ __forceinline__ void bulk_wait_read_all_but_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

// Wait until every bulk group has completed.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

constexpr int kCopyStages = 4;    // chunks in flight per block
constexpr int kBarBytes = 128;    // room for the mbarriers, ahead of the data

// Persistent blocks walk the (block, chunk) pairs p = blockIdx.x,
// blockIdx.x + gridDim.x, ...: pair p is bytes [c * chunk_bytes, ...) of
// out block b = p / chunks (c = p % chunks), from tab block perm[b] (or b).
// One thread keeps a ring of kCopyStages chunks in the dynamic shared memory
// [mbarriers | stages]: the loads run ahead of the stores, and a stage is
// refilled once the store that read it has finished reading.
__global__ void block_copy_tma_kernel(const char* __restrict__ src,
                                      char* __restrict__ dst,
                                      const int* __restrict__ perm,
                                      int64_t n_pairs, int64_t chunks,
                                      int64_t block_bytes, int chunk_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x != 0) return;
  const int64_t first = blockIdx.x;
  const int64_t step = gridDim.x;
  if (first >= n_pairs) return;
  const int64_t m = (n_pairs - 1 - first) / step + 1;  // this block's pairs
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const uint32_t stage0 = smem_u32(smem + kBarBytes);
  for (int s = 0; s < kCopyStages; ++s) mbar_init(smem_u32(bars + s), 1);
  fence_mbar_init();

  // pair k of this block: (out offset, tab offset, bytes)
  auto pair = [&](int64_t k, int64_t* to, int64_t* from) {
    const int64_t p = first + k * step;
    const int64_t b = p / chunks;
    const int64_t off = (p - b * chunks) * chunk_bytes;
    *to = b * block_bytes + off;
    *from = (perm ? static_cast<int64_t>(perm[b]) : b) * block_bytes + off;
    const int64_t left = block_bytes - off;
    return static_cast<uint32_t>(left < chunk_bytes ? left : chunk_bytes);
  };
  auto load = [&](int64_t k, int s) {
    int64_t to, from;
    const uint32_t n = pair(k, &to, &from);
    const uint32_t bar = smem_u32(bars + s);
    mbar_expect_tx(bar, n);
    bulk_g2s(stage0 + s * chunk_bytes, src + from, n, bar);
  };

  for (int k = 0; k < kCopyStages && k < m; ++k) load(k, k);
  int s = 0;
  uint32_t parity = 0;
  for (int64_t k = 0; k < m; ++k) {
    mbar_wait(smem_u32(bars + s), parity);
    int64_t to, from;
    const uint32_t n = pair(k, &to, &from);
    bulk_s2g(dst + to, stage0 + s * chunk_bytes, n);
    // refill the stage of chunk k - 1, whose store has been issued before
    // this one's
    if (k >= 1 && k - 1 + kCopyStages < m) {
      bulk_wait_read_all_but_one();
      load(k - 1 + kCopyStages, s == 0 ? kCopyStages - 1 : s - 1);
    }
    if (++s == kCopyStages) {
      s = 0;
      parity ^= 1;
    }
  }
  bulk_wait_all();
}

// -------------------------------------------------------- row_gather_tma

// Persistent blocks walk the tiles of tile_rows consecutive queries: tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... One thread issues, for row j of
// the block (its tiles' rows in order), one bulk copy straight to the row's
// place in a ring of ring_tiles tiles in the dynamic shared memory
// [mbarriers | ring]. Rows go in groups of `unroll`: group g completes on
// barrier g % (depth / unroll), and before issuing group g the thread waits
// for group g - depth / unroll (drain u rows, then issue u; with unroll 1,
// row j completes on barrier j % depth and row j - depth is waited for).
// When the last row of a tile has arrived, one bulk store writes the tile
// to out, where it is contiguous; a tile's place in the ring is refilled
// once that store has read it (ring_tiles = 2 + ceil((depth - 1) /
// tile_rows) makes that store one bulk group older than the newest). No
// thread reads a row, so no proxy fence runs. The loop keeps counters and
// divides nothing: the issuing thread's instructions per row bound a block
// (PERF.md), so the grid fills the card with blocks.
__global__ void row_gather_tma_kernel(const char* __restrict__ tab,
                                      const int* __restrict__ idx,
                                      char* __restrict__ out, int Q,
                                      int row_bytes, int depth, int unroll,
                                      int tile_rows, int ring_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x != 0) return;
  const int T = tile_rows;
  const int n_tiles = (Q + T - 1) / T;
  const int first = blockIdx.x;
  if (first >= n_tiles) return;
  const int my_tiles = (n_tiles - 1 - first) / gridDim.x + 1;
  const int last_q0 = (first + (my_tiles - 1) * gridDim.x) * T;
  const int n = (my_tiles - 1) * T + (Q - last_q0 < T ? Q - last_q0 : T);
  const int64_t tile_step = static_cast<int64_t>(gridDim.x) * T;
  const int n_bars = depth / unroll;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const uint32_t ring = smem_u32(smem + ((depth * 8 + 127) & ~127));
  const uint32_t ring_end = ring + ring_tiles * T * row_bytes;
  for (int b = 0; b < n_bars; ++b) mbar_init(smem_u32(bars + b), 1);
  fence_mbar_init();
  // the output is written once and never read here: its lines leave L2
  // first, so that table rows read again stay (PERF.md)
  const uint64_t out_policy = l2_evict_first();

  // issue state: barrier, row in tile, tiles begun, address, query
  int i_bar = 0, i_trow = 0, i_tiles = 0;
  uint32_t i_dst = ring;
  int64_t i_q = static_cast<int64_t>(first) * T;
  // retire state: barrier and parity, rows arrived in the current tile, the
  // tile's address, first query and rows, rows retired
  int r_bar = 0, r_trow = 0, retired = 0;
  uint32_t r_par = 0, r_tile = ring;
  int64_t r_q0 = i_q;
  int r_rows = Q - r_q0 < T ? static_cast<int>(Q - r_q0) : T;

  // wait for the oldest group in flight; store the tiles it completes
  auto retire_group = [&]() {
    mbar_wait(smem_u32(bars + r_bar), r_par);
    if (++r_bar == n_bars) {
      r_bar = 0;
      r_par ^= 1;
    }
    for (int r = 0; r < unroll && retired < n; ++r, ++retired) {
      if (++r_trow == r_rows) {
        bulk_s2g(out + r_q0 * row_bytes, r_tile,
                 static_cast<uint32_t>(r_rows) * row_bytes, out_policy);
        r_trow = 0;
        r_tile += T * row_bytes;
        if (r_tile == ring_end) r_tile = ring;
        r_q0 += tile_step;
        r_rows = Q - r_q0 < T ? static_cast<int>(Q - r_q0) : T;
      }
    }
  };

  for (int g0 = 0; g0 < n; g0 += unroll) {
    const int g1 = g0 + unroll < n ? g0 + unroll : n;
    if (g0 >= depth) retire_group();
    const uint32_t bar = smem_u32(bars + i_bar);
    mbar_expect_tx(bar, static_cast<uint32_t>(g1 - g0) * row_bytes);
    for (int j = g0; j < g1; ++j) {
      if (i_trow == 0) {
        if (i_tiles >= ring_tiles) bulk_wait_read_all_but_one();
        ++i_tiles;
      }
      bulk_g2s(i_dst, tab + static_cast<int64_t>(__ldg(idx + i_q)) * row_bytes,
               row_bytes, bar);
      i_dst += row_bytes;
      if (i_dst == ring_end) i_dst = ring;
      if (++i_trow == T) {
        i_trow = 0;
        i_q += tile_step - T + 1;
      } else {
        ++i_q;
      }
    }
    if (++i_bar == n_bars) i_bar = 0;
  }
  while (retired < n) retire_group();
  bulk_wait_all();
}

int launch_error() { return static_cast<int>(cudaGetLastError()); }

// Let `kernel` use `bytes` of dynamic shared memory, the SM's shared memory
// carved out at its largest. A refusal is returned and cleared, so that no
// later launch check of the process sees it.
template <typename K>
int allow_smem(K kernel, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return 0;
}

// The blocks of `threads` threads and `bytes` of dynamic shared memory that
// fit on one SM, or minus the CUDA error of the query.
template <typename K>
int blocks_per_sm(K kernel, int threads, int bytes) {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kernel, threads, bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(e);
  }
  return n;
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

// The bulk-copy kernels take the dynamic shared memory they are allowed
// (`*_allow_smem`, once per size, before the first launch) and a grid that
// fills the card (`*_blocks_per_sm` x SMs); ops/gather_probe.py plans both.
extern "C" int block_copy_tma_allow_smem(int bytes) {
  return allow_smem(block_copy_tma_kernel, bytes);
}

extern "C" int block_copy_tma_blocks_per_sm(int bytes) {
  return blocks_per_sm(block_copy_tma_kernel, 32, bytes);
}

extern "C" int block_copy_tma(const void* src, void* dst, const void* perm,
                              long long n_blocks, long long block_bytes,
                              int chunk_bytes, int smem_bytes, int blocks,
                              void* stream) {
  if (chunk_bytes < 16 || chunk_bytes % 16 != 0 || blocks < 1 ||
      kBarBytes + kCopyStages * chunk_bytes > smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t chunks = (block_bytes + chunk_bytes - 1) / chunk_bytes;
  block_copy_tma_kernel<<<static_cast<unsigned>(blocks), 32, smem_bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(src), static_cast<char*>(dst),
      static_cast<const int*>(perm), n_blocks * chunks, chunks, block_bytes,
      chunk_bytes);
  return launch_error();
}

extern "C" int row_gather_tma_allow_smem(int bytes) {
  return allow_smem(row_gather_tma_kernel, bytes);
}

extern "C" int row_gather_tma_blocks_per_sm(int bytes) {
  return blocks_per_sm(row_gather_tma_kernel, 32, bytes);
}

extern "C" int row_gather_tma(const void* tab, const void* idx, void* out,
                              long long Q, int row_bytes, int depth,
                              int unroll, int tile_rows, int ring_tiles,
                              int smem_bytes, int blocks, void* stream) {
  const long long need = ((depth * 8 + 127) & ~127) +
                         static_cast<long long>(ring_tiles) * tile_rows *
                             row_bytes;
  if (Q < 1 || Q >= (1LL << 31) || row_bytes % 16 != 0 || depth < 1 ||
      unroll < 1 || depth % unroll != 0 || tile_rows < 1 || blocks < 1 ||
      need > smem_bytes ||
      static_cast<long long>(ring_tiles - 1) * tile_rows < depth - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  row_gather_tma_kernel<<<static_cast<unsigned>(blocks), 32, smem_bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(tab), static_cast<const int*>(idx),
      static_cast<char*>(out), static_cast<int>(Q), row_bytes, depth, unroll,
      tile_rows, ring_tiles);
  return launch_error();
}
