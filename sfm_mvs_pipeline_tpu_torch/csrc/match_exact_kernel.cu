// K1x: exact-mode batched 2-NN on the tensor cores (Hopper, sm_90a).
//
// Replaces the TPU kernel _two_nn_kernel
// (sfm_mvs_pipeline_tpu/ops/pallas/match_kernel.py), which the JAX package
// runs for -Pmatch-precision=exact: one bf16 MXU pass over 3-term split
// operands of width 3D.
//
// The wrapper (ops/kernels/match_kernel.py::two_nn_exact_batch) compacts
// each shot's valid slots to its front (a stable sort, so they keep their
// slot order; count[s] of them). The launch then runs two kernels:
//   * exact_prep_kernel gathers the compacted rows and builds the operands:
//     A = -2 q and B = t, each split into its bf16 rounding (hi) and the
//     bf16 rounding of the remainder (lo), zero-padded to Dp (a multiple of
//     64) and laid out as 64-wide chunks [hi_0 | lo_0 | hi_1 | lo_1 | ...],
//     width 2 Dp, so the hi and lo values of one k arrive in one stage;
//   * two_nn_exact_kernel issues per k16 step the three products hi.hi,
//     lo.hi and hi.lo into one fp32 accumulator: the JAX kernel's
//     q2_hi.t_hi + q2_lo.t_hi + q2_hi.t_lo, each product exact in fp32
//     (8 x 8 significant bits), without storing q2_hi and t_hi twice. For
//     each row (q_shot, t_shot) of the pair table and each valid query of
//     q_shot it ranks the valid targets of t_shot by |t|^2 + dot and keeps
//     the best and second score and the best (compacted) index; |q|^2 is
//     added back after the ranking and clipped at 0.
// The wrapper maps the compacted outputs back to slot order.
//
// Why stopping at count is exact (K1's argument, csrc/match_kernel.cu): an
// invalid target scores BIG + dot, which rounds to BIG and never beats a best
// that starts at BIG, so skipping invalid targets changes no valid query's
// result, and the stable compaction keeps the lowest-slot tie rule. A query
// block wholly past count[q_shot] writes best = second = BIG, idx = 0.
//
// What bounds it on this card: tensor-core issue, 3 x 2 x count_q x count_t
// x Dp bf16 flops a pair (12 shots x 8192 slots x D = 128, all 66 pairs:
// 3.4 TFLOP, 3.4 ms at 989 TFLOP/s), then the top-2 epilogue's ALU work (a
// compare-and-select tree over 64 scores a thread a tile, against 24
// products a warpgroup a tile at D = 128), then operand traffic through L2
// (each target row is read once by every 128-query block of a pair). The
// design:
//   * a block owns 128 queries of one pair: two consumer warpgroups of 64
//     rows each and one producer warp (288 threads);
//   * the block's query operand rows (128 x 2 Dp bf16, 64 KB at D = 128)
//     are loaded once by TMA and stay resident in shared memory in the
//     128-byte-swizzled K-major layout that the wgmma descriptors read;
//   * the producer streams the target rows through a ring of 3-4 stages,
//     each the [hi | lo] slices of one 64-wide chunk of 128 targets (32 KB),
//     by TMA (tensor maps built on the host through
//     cudaGetDriverEntryPoint("cuTensorMapEncodeTiled"), so only cudart is
//     linked), with a full and an empty mbarrier a stage;
//   * each consumer warpgroup runs wgmma.mma_async m64n128k16 (bf16 in, fp32
//     accumulate) from shared memory, one commit group a chunk, releasing
//     a chunk's stage while the next chunk's products run;
//   * the top-2 is fused into each target tile's epilogue, reading the 64
//     accumulators a thread where the wgmma layout puts them (row
//     16 warp + g (+ 8), column 8 j + 2 tig (+ 1), as mma.sync's m16n8), so
//     the (F, F) score matrix never reaches device memory. The tile's target
//     norms are loaded while its last products run, and each row's 32
//     scores reduce by a branch-free tree (depth 5), not a chain of 32
//     dependent compares. The two warpgroups drift apart, so one's epilogue
//     runs under the other's products.
// Operand bytes through L2 at 12x8192x128 are ~18 GB at full capacity: 2
// D-wide operands, the query tile loaded once a block (3 D-wide operands
// with the query tile restaged for every target tile would move ~106 GB). Two accumulator sets (one tile's products under the
// previous tile's epilogue) were tried: at the 168 registers ptxas allows a
// 288-thread block here they spill, and ran 2.6x slower.
//
// Tie rule: the lowest global target index wins. A thread's targets are
// reduced in index order with ties kept on the left (lower index), and the
// four threads that share a query row merge by (value, index), as in K1. On
// integer-valued descriptors (0..255) the lo parts are 0 and every sum is an
// integer below 2^24 at D <= 128, so idx, best^2 and second^2 equal K1's and
// the plain version's bit for bit at every valid query.
#include <cuda.h>  // CUtensorMap and its enums (types only: the driver call goes through cudart)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;               // queries a block: two consumer warpgroups of 64 rows
constexpr int BT = 128;               // targets a tile (the wgmma N)
constexpr int BK = 64;                // values in one [hi] or [lo] chunk: 128 bytes, the swizzle span
constexpr int PART = 128 * BK * 2;    // bytes of one 128-row chunk slice (A and B alike): 16 KB
constexpr int STAGE = 2 * PART;       // a ring stage: the hi and lo slices of one chunk of BT targets
constexpr int CONSUMERS = 2;          // consumer warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32;  // and one producer warp
constexpr int MAX_STAGES = 4;
constexpr int MAX_D = 256;            // the resident query rows: 128 x 2 x 256 bf16 = 128 KB
constexpr int MAX_SMEM = 232448 - 128;  // a block's shared memory, less the static barriers
constexpr float BIG = 3.0e38f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the phase of parity `parity` of a barrier to complete. A wait
// that lasts 4 s traps, so a lost arrival faults the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try_wait(bar, parity))
    if (globaltimer() - t0 > 4000000000ull) __trap();
}

// one box of a 2-D tensor map (coordinates innermost first) into shared
// memory, completing `bytes` of the barrier's transaction count
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (the layout TMA writes
// with CU_TENSOR_MAP_SWIZZLE_128B); `addr` steps 32 bytes a k16 step
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF)   // start address
         | (static_cast<uint64_t>(1) << 16)            // leading offset (unused when swizzled)
         | (static_cast<uint64_t>(1024 >> 4) << 32)    // stride between 8-row groups
         | (static_cast<uint64_t>(1) << 62);           // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 128 fp32, 64 a thread) = A (64 x 16 bf16) . B (128 x 16 bf16)^T
// (+ d when scale_d != 0), both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// merge the top-2 summary (rb, rs, ri) of targets that all lie after those
// of (b, s, i) into it: a tie keeps the left, lower index
__device__ __forceinline__ void merge_right(float& b, float& s, int& i, float rb, float rs, int ri) {
  const bool right = rb < b;
  s = right ? fminf(b, rs) : fminf(s, rb);
  i = right ? ri : i;
  b = right ? rb : b;
}

// merge the top-2 summaries of two threads' targets (interleaved indices):
// by (value, index)
__device__ __forceinline__ void merge_top2(float& b, float& s, int& i,
                                           float ob, float os, int oi) {
  if (ob < b || (ob == b && oi < i)) {
    s = fminf(os, b);
    b = ob;
    i = oi;
  } else {
    s = fminf(s, ob);
  }
}

// the target norms of one tile at this thread's 32 columns, BIG past count,
// loaded while the tile's products run
__device__ __forceinline__ void load_tn(float* tnr, const float* tn, int t0, int cnt_t, int tig) {
  const bool whole = t0 + BT <= cnt_t;
#pragma unroll
  for (int j = 0; j < BT / 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int t = t0 + 8 * j + 2 * tig + c;
      tnr[2 * j + c] = (whole || t < cnt_t) ? __ldg(tn + t) : BIG;
    }
}

// Fused top-2 epilogue of one target tile. acc[4 j + 2 r + c] holds query
// row 16 warp + g + 8 r against target t0 + 8 j + 2 tig + c. A row's 32
// scores |t|^2 + dot (BIG past count, never taken) are reduced in index
// order by a tree of merge_right (depth 5, no branches), kept as a stack of
// complete subtrees so few registers are live, then merged after the row's
// running top-2, which holds only lower indices.
__device__ __forceinline__ void epilogue(const float* acc, const float* tnr, int t0, int tig,
                                         float* best, float* second, int* bidx) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sb[4], ss[4];  // subtree k covers 2^k column pairs
    int si[4];
    float b = 0.f, s = 0.f;
    int i = 0;
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      const float v0 = tnr[2 * j] + acc[4 * j + 2 * r];
      const float v1 = tnr[2 * j + 1] + acc[4 * j + 2 * r + 1];
      const bool right = v1 < v0;
      b = right ? v1 : v0;
      s = right ? v0 : v1;
      i = t0 + 8 * j + 2 * tig + (right ? 1 : 0);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (((j >> k) & 1) == 0) {  // a new subtree of 2^k pairs waits for its right half
          sb[k] = b;
          ss[k] = s;
          si[k] = i;
          break;
        }
        merge_right(sb[k], ss[k], si[k], b, s, i);
        b = sb[k];
        s = ss[k];
        i = si[k];
      }
    }
    merge_right(best[r], second[r], bidx[r], b, s, i);  // j = 15 closed the whole tree
  }
}

// Issue one target tile's products into acc: nc chunks from the ring, each
// the three products of its four k16 steps and its own commit group. Once a
// chunk's products are done the previous chunk's stage is released, so the
// next chunk's products are in flight meanwhile and a ring of fewer stages
// than chunks still flows. The tile's last stage is the caller's to release.
__device__ __forceinline__ void issue_tile(float* acc, uint32_t a_wg, uint32_t ring, int nc,
                                           int stages, int& st, uint32_t& phase, int& rel,
                                           uint64_t* full_bar, uint64_t* empty_bar, bool signal) {
  for (int c = 0; c < nc; ++c) {
    mbar_wait(smem_u32(&full_bar[st]), phase);
    const uint32_t ah = a_wg + 2 * c * PART, al = ah + PART;
    const uint32_t bh = ring + st * STAGE, bl = bh + PART;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dah = sw128_desc(ah + 32 * kk), dal = sw128_desc(al + 32 * kk);
      const uint64_t dbh = sw128_desc(bh + 32 * kk), dbl = sw128_desc(bl + 32 * kk);
      wgmma_m64n128k16(acc, dah, dbh, c > 0 || kk > 0);  // hi.hi (the tile's first zeroes acc)
      wgmma_m64n128k16(acc, dal, dbh, 1);                // lo.hi
      wgmma_m64n128k16(acc, dah, dbl, 1);                // hi.lo
    }
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();
    if (c > 0) {
      if (signal) mbar_arrive(smem_u32(&empty_bar[rel]));
      if (++rel == stages) rel = 0;
    }
    if (++st == stages) {
      st = 0;
      phase ^= 1;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
two_nn_exact_kernel(const __grid_constant__ CUtensorMap tm_a,  // (rows, 2 Dp) bf16 query operands
                    const __grid_constant__ CUtensorMap tm_b,  // (rows, 2 Dp) bf16 target operands
                    const float* __restrict__ norm,    // (S, F) |x|^2 of the compacted slots
                    const int* __restrict__ count,     // (S,) valid slots a shot
                    const int* __restrict__ pairs,     // (P, 2) (q_shot, t_shot)
                    int F, int nc, int stages,         // nc = Dp / BK chunks
                    int* __restrict__ out_idx,         // (P, F), compacted query and target order
                    float* __restrict__ out_best,
                    float* __restrict__ out_second) {
  __shared__ __align__(8) uint64_t full_bar[MAX_STAGES];
  __shared__ __align__(8) uint64_t empty_bar[MAX_STAGES];
  __shared__ __align__(8) uint64_t a_bar;
  extern __shared__ unsigned char smem_raw[];

  const int p = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int q_shot = pairs[2 * p];
  const int t_shot = pairs[2 * p + 1];
  const int cnt_q = count[q_shot];
  const int cnt_t = count[t_shot];
  const size_t orow = (size_t)p * F;
  if (q0 >= cnt_q) {  // no valid query in the block
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      const int q = q0 + r;
      if (q < F) {
        out_idx[orow + q] = 0;
        out_best[orow + q] = BIG;
        out_second[orow + q] = BIG;
      }
    }
    return;
  }
  const int ntiles = (cnt_t + BT - 1) / BT;
  const int steps = ntiles * nc;  // ring stages the block consumes

  // the swizzled tiles must start on 1024-byte boundaries
  const uint32_t a_base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // 2 nc slices of 128 query rows
  const uint32_t ring = a_base + nc * 2 * PART;                      // `stages` x STAGE

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), CONSUMERS);
    }
    mbar_init(smem_u32(&a_bar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  if (warp == CONSUMERS * 4) {
    // producer: the query rows once, then the target chunks through the ring
    if ((threadIdx.x & 31) == 0 && steps > 0) {
      const int trow = t_shot * F;
      const uint32_t ab = smem_u32(&a_bar);
      mbar_expect_tx(ab, nc * 2 * PART);
      for (int a = 0; a < 2 * nc; ++a) tma_load(a_base + a * PART, &tm_a, ab, a * BK, q_shot * F + q0);
      int st = 0;
      uint32_t phase = 0;
      for (int s = 0; s < steps; ++s) {
        const int tile = s / nc;
        const int c = s - tile * nc;
        mbar_wait(smem_u32(&empty_bar[st]), phase ^ 1);  // a fresh barrier passes at once
        const uint32_t fb = smem_u32(&full_bar[st]);
        mbar_expect_tx(fb, STAGE);
        const uint32_t dst = ring + st * STAGE;
        tma_load(dst, &tm_b, fb, 2 * c * BK, trow + tile * BT);
        tma_load(dst + PART, &tm_b, fb, (2 * c + 1) * BK, trow + tile * BT);
        if (++st == stages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;          // consumer warpgroup: query rows 64 wg .. 64 wg + 63
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;           // accumulator row group: rows g and g + 8 of the warp's 16
  const int tig = lane & 3;          // columns 2 tig, 2 tig + 1 of every 8
  const bool signal = (threadIdx.x & 127) == 0;  // releases stages for its warpgroup

  // running top-2 of query rows 16 warp + g (r = 0) and 16 warp + g + 8 (r = 1)
  float best[2] = {BIG, BIG}, second[2] = {BIG, BIG};
  int bidx[2] = {0, 0};
  if (steps > 0) {
    const float* tn = norm + (size_t)t_shot * F;
    const uint32_t a_wg = a_base + wg * 64 * 128;  // the group's 64 rows of each slice
    float acc[64], tnr[BT / 4];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    mbar_wait(smem_u32(&a_bar), 0);
    int st = 0, rel = 0;
    uint32_t phase = 0;
    for (int tile = 0; tile < ntiles; ++tile) {
      issue_tile(acc, a_wg, ring, nc, stages, st, phase, rel, full_bar, empty_bar, signal);
      load_tn(tnr, tn, tile * BT, cnt_t, tig);  // while the last chunk's products run
      wgmma_wait<0>();
      fence_acc(acc);
      if (signal) mbar_arrive(smem_u32(&empty_bar[rel]));  // the tile's last chunk
      if (++rel == stages) rel = 0;
      epilogue(acc, tnr, tile * BT, tig, best, second, bidx);
    }
  }

  // merge the four partial results of each row: lanes 4g .. 4g + 3
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[r], off);
      const float os = __shfl_xor_sync(0xffffffffu, second[r], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[r], off);
      merge_top2(best[r], second[r], bidx[r], ob, os, oi);
    }
  }
  if (tig == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + 16 * warp + g + 8 * r;
      if (q < F) {
        const bool ok = q < cnt_q;
        const float qn = ok ? norm[(size_t)q_shot * F + q] : 0.f;
        out_idx[orow + q] = ok ? bidx[r] : 0;
        out_best[orow + q] = ok ? fmaxf(best[r] + qn, 0.f) : BIG;
        out_second[orow + q] = ok ? fmaxf(second[r] + qn, 0.f) : BIG;
      }
    }
  }
}

// The operands of the compacted rows, one warp a row: row r < S F is slot
// perm[r] of shot s = r / F; it writes the row's [hi | lo] chunks of -2 x
// (A) and x (B), zero past D, and |x|^2. Rows past a shot's count (invalid
// slots) and from S F on are zero, so every target column a tile reads
// beyond count scores BIG + 0 = BIG whatever the invalid slots hold. Each
// value is rounded as ops/kernels/match_kernel.py::exact_operands rounds it
// (bf16 round-to-nearest-even of x, then of the exact fp32 remainder), so
// the valid rows equal its output bit for bit.
__global__ void __launch_bounds__(256)
exact_prep_kernel(const float* __restrict__ desc,     // (S, F, D) float32
                  const long long* __restrict__ perm,  // (S, F) slot of each compacted row
                  const int* __restrict__ count,       // (S,) valid slots a shot
                  int SF, int F, int D, int Dp, int rows,
                  __nv_bfloat16* __restrict__ A, __nv_bfloat16* __restrict__ B,
                  float* __restrict__ norm) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int shot = row / F;
  const float* src =
      row < SF && row - shot * F < count[shot] ? desc + ((size_t)shot * F + perm[row]) * D : nullptr;
  __nv_bfloat16* a = A + (size_t)row * 2 * Dp;
  __nv_bfloat16* b = B + (size_t)row * 2 * Dp;
  float sq = 0.f;
  for (int k = lane; k < Dp; k += 32) {
    const float x = (src != nullptr && k < D) ? src[k] : 0.f;
    sq += x * x;
    const int col = k / BK * 2 * BK + k % BK;  // chunk k / BK: hi at col, lo at col + BK
    const __nv_bfloat16 th = __float2bfloat16_rn(x);
    const __nv_bfloat16 qh = __float2bfloat16_rn(-2.f * x);
    b[col] = th;
    b[col + BK] = __float2bfloat16_rn(x - __bfloat162float(th));
    a[col] = qh;
    a[col + BK] = __float2bfloat16_rn(-2.f * x - __bfloat162float(qh));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  if (lane == 0 && row < SF) norm[row] = sq;
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime so
// the library links only cudart
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a (rows, cols) row-major bf16 operand read in 128-row x 64-column boxes,
// 128-byte swizzled
bool make_map(CUtensorMap* map, const void* base, int rows, int cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {BK, 128};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Shared memory a block takes at width Dp (0 for a width it does not take):
// 1 KB of alignment slack, the resident query rows and the ring.
extern "C" int two_nn_exact_smem(int Dp, int* stages) {
  if (Dp <= 0 || Dp % BK != 0 || Dp > MAX_D) return 0;
  const int a_bytes = Dp / BK * 2 * PART;
  int n = (MAX_SMEM - 1024 - a_bytes) / STAGE;
  n = n < MAX_STAGES ? n : MAX_STAGES;
  if (n < 2) return 0;
  if (stages != nullptr) *stages = n;
  return 1024 + a_bytes + n * STAGE;
}

// C entry point (loaded with ctypes): the operands of the compacted rows
// (exact_prep_kernel), then the 2-NN. desc (S, F, D) float32; perm (S, F)
// int64 and count (S,) int32 from compact_slots; A and B (rows, 2 Dp) bf16
// with rows = S F + 128 (every 128-row box lies inside them), norm (S F,)
// float32: scratch the wrapper allocates; Dp a multiple of 64, at most 256;
// pairs (P, 2) int32. Outputs (P, F) in compacted order. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() of the
// launches, or cudaErrorInvalidValue for a width or tensor map it cannot take.
extern "C" int two_nn_exact_launch(const float* desc, const long long* perm, const int* count,
                                   int S, int F, int D, int Dp, void* A, void* B, float* norm,
                                   const int* pairs, int P, int* out_idx, float* out_best,
                                   float* out_second, void* stream) {
  if (P <= 0 || F <= 0) return 0;
  int stages = 0;
  const int smem = two_nn_exact_smem(Dp, &stages);
  if (smem == 0 || D > Dp) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = S * F + BQ;
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, A, rows, 2 * Dp) || !make_map(&map_b, B, rows, 2 * Dp))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  exact_prep_kernel<<<(rows + 7) / 8, 256, 0, st>>>(desc, perm, count, S * F, F, D, Dp, rows,
                                                    static_cast<__nv_bfloat16*>(A),
                                                    static_cast<__nv_bfloat16*>(B), norm);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // the attribute is the current device's: the wrapper makes the inputs' card current
  e = cudaFuncSetAttribute(two_nn_exact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(P, (F + BQ - 1) / BQ);
  two_nn_exact_kernel<<<grid, THREADS, smem, st>>>(map_a, map_b, norm, count, pairs, F, Dp / BK,
                                                   stages, out_idx, out_best, out_second);
  return static_cast<int>(cudaGetLastError());
}
