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
//    3.35 TB/s. The TPU kernels held the table resident in VMEM; here the
//    vmem probes' 4-8 MB tables stay in the 50 MB L2, and the ray stage's
//    488 MB one is read from device memory. Design, rows: persistent warps
//    walk the flattened (query, 16-byte piece) pairs, so that no lane idles
//    at any row width (one warp a row left 10 of 32 lanes idle at 352 B);
//    each thread has kRgLoads = 4 loads in flight and stores with
//    streaming stores, so that the output leaves L2 before table rows do.
//    Per lane: a 2-D launch, 16 bytes of one query a thread (one or two
//    16-byte index loads, one 16-byte store), no division. On an NVIDIA
//    H100 80GB HBM3 at 700 W (tools/gather_probe.py, PERF.md): the vmem
//    probes' 2^20 rows of f32 W128 in 0.2084-0.2100 ms and of bf16
//    0.0922-0.0934 (one warp a row, as before: 0.2459-0.2463 and
//    0.1672-0.1677; index_select 0.634), per lane 0.3991 (0.6163-0.6179;
//    take_along_dim 1.377), and the ray stage's 2^22 random rows of 352 B
//    in 1.1336-1.1367 and of 512 B in 1.4958-1.4975 (1.3117-1.3127,
//    1.5851-1.5861; index_select 2.525).
//
// 2. onehot_gather_mma: out = sum_j onehot(idx - j*RB) @ bf16(tab_j) in fp32
//    on the tensor cores, which equals f32(bf16(tab))[idx]. Replaces
//    scripts/perf_vmem_gather.py:164 `gk_onehot`. Bound: the function needs
//    no arithmetic, so its bytes (output, table, indices at 3.35 TB/s;
//    0.163 ms at the script's shapes); the one-hot method's 2*Q*R*W
//    multiply-adds need 4.45 ms at 989 TFLOP/s bf16, the floor of this
//    design and not of the function. Design: `wgmma` m64n128k16 with the
//    one-hot A fragments built in registers (1.0 = 0x3F80 where the index
//    hits the k column) and B, 64-row tiles of the table, read MN-major
//    from shared memory. A producer warp keeps 2-D TMA loads of the tiles
//    (128 B swizzle; rows past R and columns past W fill with zeros) in
//    flight into a ring of 6 stages with a full and an empty mbarrier
//    each; two consumer warpgroups own 128 queries each, so a CTA of 256
//    queries reads the 4 MB table from L2 once for all of them. A consumer
//    waits for its products of a tile (no `wgmma` group left in flight)
//    before it builds the next tile's operand: with one group in flight,
//    results came out wrong on the card (A lives in registers, which the
//    next build may reuse while the products still read them). One product
//    per output value is nonzero, so the fp32 sum is exact; a table
//    holding inf or NaN poisons its column of every output through 0 * inf,
//    as the TPU kernel's full product does: no tile is skipped. The RB
//    chunks of the TPU kernel are its grid axis; here the walk over the
//    table is a loop in the CTA. On an NVIDIA H100 80GB HBM3 at 700 W
//    (tools/gather_probe.py, PERF.md), at the vmem probe's 2^20 queries of
//    a 16,384 x 128 table: 5.22-5.40 ms, 0.82-0.85 of the method's floor
//    (the first design, mma.sync with scalar B loads, 91.74). A 2-CTA
//    cluster multicasting each tile to both CTAs ran 11.6 ms and is not
//    kept.
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
// All four were redesigned for this card (PERF.md). Each entry point returns
// the CUDA error of its launch (0 when it launched); the caller owns every
// buffer.

#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked
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

constexpr int kRgThreads = 256;  // a block of the rows mode
constexpr int kRgLoads = 4;      // 16-byte loads in flight a thread

// Rows mode: pair e = q * pieces + c is the 16-byte piece c of out row q.
// Warp w of the grid takes the runs of 32 * kRgLoads consecutive pairs
// w, w + warps, ...; lane l pairs 32 u + l of a run (u < kRgLoads), so
// that the lanes of a warp cover consecutive pieces of consecutive rows and
// no lane idles at any row width. The thread's first pair is divided once;
// then (q, c) advance by additions: 32 pairs are (lane_q, lane_c), a run of
// every warp (step_q, step_c), both divided out by the host, as kernel
// arguments cost no registers (2,048 threads an SM need 32 at most). Each
// thread loads its kRgLoads indices, then its kRgLoads pieces, then stores
// them with streaming stores (`st.global.cs`), so that the output leaves L2
// first and table rows read again stay.
__global__ void __launch_bounds__(kRgThreads) row_gather_rows_kernel(
    const uint4* __restrict__ tab, const int* __restrict__ idx,
    uint4* __restrict__ out, int Q, int pieces, int lane_q, int lane_c,
    int step_q, int step_c) {
  const int64_t w = (static_cast<int64_t>(blockIdx.x) * kRgThreads +
                     threadIdx.x) >> 5;
  const int64_t e = w * 32 * kRgLoads + (threadIdx.x & 31);
  int q = static_cast<int>(e / pieces);
  int c = static_cast<int>(e - static_cast<int64_t>(q) * pieces);
  while (q < Q) {
    int qu[kRgLoads], cu[kRgLoads], r[kRgLoads];
    uint4 v[kRgLoads];
    int qq = q, cc = c;
#pragma unroll
    for (int u = 0; u < kRgLoads; ++u) {
      qu[u] = qq;
      cu[u] = cc;
      qq += lane_q;
      cc += lane_c;
      if (cc >= pieces) {
        cc -= pieces;
        ++qq;
      }
    }
#pragma unroll
    for (int u = 0; u < kRgLoads; ++u) r[u] = qu[u] < Q ? __ldg(idx + qu[u]) : 0;
#pragma unroll
    for (int u = 0; u < kRgLoads; ++u) {
      if (qu[u] < Q) v[u] = __ldg(tab + static_cast<int64_t>(r[u]) * pieces + cu[u]);
    }
#pragma unroll
    for (int u = 0; u < kRgLoads; ++u) {
      if (qu[u] < Q) __stcs(out + static_cast<int64_t>(qu[u]) * pieces + cu[u], v[u]);
    }
    q += step_q;
    c += step_c;
    if (c >= pieces) {
      c -= pieces;
      ++q;
    }
  }
}

// Lanes mode, a 2-D launch: thread (x, y) of block (bx, by) takes query
// blockIdx.x * by + y and the V elements from j = V * (blockIdx.y * bx + x):
// with V = 16 bytes of elements (W a multiple of V), one or two 16-byte
// index loads, V table loads and one 16-byte streaming store; with V = 1
// (any other W), one of each.
template <typename T, int V>
__global__ void row_gather_lanes_kernel(const T* __restrict__ tab,
                                        const int* __restrict__ idx,
                                        T* __restrict__ out, int Q, int W,
                                        int nv) {
  const int q = blockIdx.x * blockDim.y + threadIdx.y;
  const int jv = blockIdx.y * blockDim.x + threadIdx.x;
  if (q >= Q || jv >= nv) return;
  const int j0 = jv * V;
  const int64_t base = static_cast<int64_t>(q) * W + j0;
  if constexpr (V == 1) {
    __stcs(out + base, __ldg(tab + static_cast<int64_t>(__ldg(idx + base)) * W + j0));
  } else {
    int id[V];
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const int4 t = __ldg(reinterpret_cast<const int4*>(idx + base + i));
      id[i] = t.x;
      id[i + 1] = t.y;
      id[i + 2] = t.z;
      id[i + 3] = t.w;
    }
    union {
      uint4 u;
      T e[V];
    } val;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      val.e[i] = __ldg(tab + static_cast<int64_t>(id[i]) * W + j0 + i);
    }
    __stcs(reinterpret_cast<uint4*>(out + base), val.u);
  }
}

// ----------------------------------------------------- onehot_gather_mma

constexpr int kOhConsumers = 2;     // warpgroups of 128 queries each
constexpr int kOhStages = 6;        // ring of table tiles
constexpr int kOhRows = 64;         // table rows a tile
constexpr int kOhBoxBytes = 64 * 128;  // a TMA box: 64 rows x 64 bf16
constexpr int kOhStageBytes = 2 * kOhBoxBytes;  // a tile: N = 128 columns
constexpr int kOhThreads = 128 * (1 + kOhConsumers);

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// 2-D TMA load of the box at (column c0, row c1), completing on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The descriptor of a bf16 B operand in shared memory, MN-major with 128 B
// swizzle: 64 columns (128 B) a swizzled row, k rows 128 B apart; `lbo`
// is the step to the next 64 columns, 1 KB (8 rows) the step in k.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// D (64 x 128, fp32) += A (64 x 16 bf16, registers) * B (16 x 128 bf16,
// MN-major in shared memory, described by `desc`)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// the two bf16 one-hot values of columns k and k + 1 for index i
__device__ __forceinline__ uint32_t onehot2(int i, int k) {
  return (i == k ? 0x3F80u : 0u) | (i == k + 1 ? 0x3F800000u : 0u);
}

__device__ __forceinline__ void st_cs_f2(float* p, float a, float b) {
  asm volatile("st.global.cs.v2.f32 [%0], {%1, %2};\n" ::"l"(p), "f"(a),
               "f"(b)
               : "memory");
}

// A CTA serves 128 * kOhConsumers queries and walks the whole table in
// tiles of kOhRows rows, two TMA boxes of 64 columns each (N = 128).
// Warpgroup 0 is the producer: one thread keeps a ring of kOhStages tiles
// loading, each stage with a full and an empty mbarrier. Warpgroup 1 + i
// owns queries [128 i, 128 i + 128) of the CTA as two m64 tiles: per tile
// it builds the one-hot A fragments in registers, issues the four k16
// steps of both m64 tiles as wgmma with B read from the stage through a
// descriptor, waits for them and releases the stage. Rows past R and
// columns past W arrive as zeros from the TMA (at W <= 64 the whole second
// box); columns past W are not written.
__global__ void __launch_bounds__(kOhThreads, 1)
    onehot_gather_mma_kernel(const __grid_constant__ CUtensorMap tmap,
                             const int* __restrict__ idx,
                             float* __restrict__ out, int Q, int R, int W) {
  extern __shared__ unsigned char smem[];
  // a swizzled tile starts on 1 KB; the mbarriers follow the ring
  const uint32_t ring = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t full = ring + kOhStages * kOhStageBytes;
  const uint32_t empty = full + 8 * kOhStages;
  const int n_tiles = (R + kOhRows - 1) / kOhRows;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kOhStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kOhConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t parity = 0;
      for (int it = 0; it < n_tiles; ++it) {
        mbar_wait(empty + 8 * s, parity ^ 1);  // passes on a new barrier
        mbar_expect_tx(full + 8 * s, kOhStageBytes);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          tma_load_2d(ring + s * kOhStageBytes + c * kOhBoxBytes, &tmap, 64 * c,
                      it * kOhRows, full + 8 * s);
        }
        if (++s == kOhStages) {
          s = 0;
          parity ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tw = threadIdx.x & 127;
    const int warp = tw >> 5, lane = tw & 31;
    const int g = lane >> 2;  // fragment rows g and g + 8
    const int t = lane & 3;   // fragment columns 2t, 2t + 1 (and + 8)
    const int q0 = (blockIdx.x * kOhConsumers + wg - 1) * 128 + warp * 16 + g;
    // each m64 tile's two rows of this thread, less 2t, so that onehot2
    // compares them with the k16 step's first column; -1000 matches none
    int ia[2], ib[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int q = q0 + 64 * mt;
      ia[mt] = q < Q ? __ldg(idx + q) - 2 * t : -1000;
      ib[mt] = q + 8 < Q ? __ldg(idx + q + 8) - 2 * t : -1000;
    }
    float acc[2][64];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[mt][i] = 0.0f;
    }
    int s = 0;
    uint32_t parity = 0;
    for (int it = 0; it < n_tiles; ++it) {
      mbar_wait(full + 8 * s, parity);
      // A fragments: (row g, k 2t..2t+1), (row g + 8, the same), then
      // k + 8 for both
      uint32_t a[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int k = it * kOhRows + 16 * kk;
          a[mt][kk][0] = onehot2(ia[mt], k);
          a[mt][kk][1] = onehot2(ib[mt], k);
          a[mt][kk][2] = onehot2(ia[mt], k + 8);
          a[mt][kk][3] = onehot2(ib[mt], k + 8);
        }
      }
      const uint32_t stage = ring + s * kOhStageBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          // k16 step kk is 16 rows (2 KB) into the tile
          wgmma_m64n128k16(acc[mt], a[mt][kk],
                           smem_desc(stage + kk * 2048, kOhBoxBytes));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      if (tw == 0) mbar_arrive(empty + 8 * s);
      if (++s == kOhStages) {
        s = 0;
        parity ^= 1;
      }
    }
    // D fragment of n-tile i: (row g, columns 8i + 2t, + 1), (row g + 8,
    // the same)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int q = q0 + 64 * mt;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = 8 * i + 2 * t;
        if (col >= W) continue;
        if (q < Q) {
          st_cs_f2(out + static_cast<int64_t>(q) * W + col, acc[mt][4 * i],
                   acc[mt][4 * i + 1]);
        }
        if (q + 8 < Q) {
          st_cs_f2(out + static_cast<int64_t>(q + 8) * W + col,
                   acc[mt][4 * i + 2], acc[mt][4 * i + 3]);
        }
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

// cuTensorMapEncodeTiled, from the driver through the runtime, so that the
// library needs no link to libcuda; null if the driver has none.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    } else {
      cudaGetLastError();
    }
  }
  return fn;
}

// what onehot_gather_mma returns when the tensor map cannot be made:
// kEncodeFailed + the CUresult of the encoding, or kNoEncoder
constexpr int kEncodeFailed = 10000;
constexpr int kNoEncoder = 20000;

int launch_onehot(const void* tab, const void* idx, void* out, int Q, int R,
                  int W, int ctas, int smem_bytes, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoEncoder;
  // the (R, W) bf16 table in boxes of 64 rows x 64 columns, 128 B
  // swizzle; boxes past R or W are filled with zeros
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(R)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(W) * 2};
  const cuuint32_t box[2] = {64, kOhRows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(tab), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(r);
  auto kernel = onehot_gather_mma_kernel;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  kernel<<<ctas, kOhThreads, smem_bytes, stream>>>(
      map, static_cast<const int*>(idx), static_cast<float*>(out), Q, R, W);
  return launch_error();
}

}  // namespace

// Rows mode of row_gather: `blocks` blocks of kRgThreads walk the Q *
// (row_bytes / 16) pairs (ops/gather_probe.row_gather_plan). The walk holds
// query numbers in int and steps up to blocks * kRgThreads * kRgLoads past
// the last, so Q plus that step must stay below 2^31.
extern "C" int row_gather_rows(const void* tab, const void* idx, void* out,
                               int Q, int row_bytes, int blocks,
                               void* stream) {
  const int pieces = row_bytes / 16;
  const long long step = static_cast<long long>(blocks) * kRgThreads * kRgLoads;
  if (Q < 1 || row_bytes % 16 != 0 || pieces < 1 || blocks < 1 ||
      Q + step + 32 > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int lane_q = 32 / pieces, lane_c = 32 % pieces;
  const int step_q = static_cast<int>(step / pieces);
  const int step_c = static_cast<int>(step % pieces);
  row_gather_rows_kernel<<<static_cast<unsigned>(blocks), kRgThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(tab), static_cast<const int*>(idx),
      static_cast<uint4*>(out), Q, pieces, lane_q, lane_c, step_q, step_c);
  return launch_error();
}

// blocks of the rows mode that fit on one SM, or minus the CUDA error
extern "C" int row_gather_rows_blocks_per_sm() {
  return blocks_per_sm(row_gather_rows_kernel, kRgThreads, 0);
}

// Lanes mode of row_gather: blocks (bx, by) on a grid (gx, gy), `vec`
// elements a thread (16 bytes of them, or 1); W a multiple of vec
// (ops/gather_probe.row_gather_plan).
extern "C" int row_gather_lanes(const void* tab, const void* idx, void* out,
                                int Q, int W, int elem_bytes, int vec, int bx,
                                int by, int gx, int gy, void* stream) {
  if (Q < 1 || W < 1 || (elem_bytes != 2 && elem_bytes != 4) ||
      (vec != 1 && vec != 16 / elem_bytes) || W % vec != 0 || bx < 1 ||
      by < 1 || bx * by > 1024 || gx < 1 || gy < 1 || gy > 65535 ||
      static_cast<long long>(gx) * by < Q ||
      static_cast<long long>(gy) * bx * vec < W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(gx, gy), block(bx, by);
  const int nv = W / vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    auto* t = static_cast<const uint32_t*>(tab);
    auto* o = static_cast<uint32_t*>(out);
    if (vec == 1) {
      row_gather_lanes_kernel<uint32_t, 1><<<grid, block, 0, s>>>(
          t, static_cast<const int*>(idx), o, Q, W, nv);
    } else {
      row_gather_lanes_kernel<uint32_t, 4><<<grid, block, 0, s>>>(
          t, static_cast<const int*>(idx), o, Q, W, nv);
    }
  } else {
    auto* t = static_cast<const uint16_t*>(tab);
    auto* o = static_cast<uint16_t*>(out);
    if (vec == 1) {
      row_gather_lanes_kernel<uint16_t, 1><<<grid, block, 0, s>>>(
          t, static_cast<const int*>(idx), o, Q, W, nv);
    } else {
      row_gather_lanes_kernel<uint16_t, 8><<<grid, block, 0, s>>>(
          t, static_cast<const int*>(idx), o, Q, W, nv);
    }
  }
  return launch_error();
}

// `ctas` of 128 * kOhConsumers queries (query numbers are held in int);
// `smem_bytes` holds the ring after 1 KB of alignment and its mbarriers
// (ops/gather_probe.onehot_plan). Returns a CUDA error, or kEncodeFailed +
// the CUresult, or kNoEncoder.
extern "C" int onehot_gather_mma(const void* tab, const void* idx, void* out,
                                 int Q, int R, int W, int ctas,
                                 int smem_bytes, void* stream) {
  const long long need = 1024LL + kOhStages * (kOhStageBytes + 16);
  if (Q < 1 || R < 1 || W % 8 != 0 || W < 8 || W > 128 ||
      ctas < 1 || static_cast<long long>(ctas) * 128 * kOhConsumers < Q ||
      static_cast<long long>(ctas) * 128 * kOhConsumers > INT32_MAX ||
      smem_bytes < need ||
      reinterpret_cast<uintptr_t>(tab) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_onehot(tab, idx, out, Q, R, W, ctas, smem_bytes,
                       static_cast<cudaStream_t>(stream));
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
