// K1: batched brute-force 2-NN over a table of shot pairs (Hopper, sm_90a).
//
// Replaces the TPU kernel _two_nn_fused_kernel
// (sfm_mvs_pipeline_tpu/ops/pallas/match_kernel.py), which rides the MXU in
// bf16 with a lane-blocked running top-2.
//
// For every row (q_shot, t_shot) of the pair table and every query feature q
// of q_shot it finds the nearest and second-nearest target feature of t_shot
// by squared L2 distance |q|^2 + |t|^2 - 2 q.t. Outputs per (pair, query):
// idx of the nearest target, best^2 and second^2. Two routes, picked by the
// descriptors' type in the wrapper (ops/kernels/match_kernel.py):
//   * two_nn_f32_launch: float32 descriptors (SIFT), fp32 FMAs;
//   * two_nn_bf16_launch: bfloat16 descriptors (ORB's +-1 expansion, as the
//     JAX package passes it), bf16 mma.sync with fp32 accumulation.
//
// Valid extent. The wrapper passes ext[s] = 1 + the last valid slot of shot
// s (0 for a shot with none). The target sweep stops at ext[t_shot], and a
// block of queries that starts at or past ext[q_shot] writes best = second =
// BIG, idx = 0 and returns. Feature tables are padded to a fixed capacity
// (ORB at -Pfeature-limit=0 fills 6-12% of 65,536 slots), so padded slots
// would otherwise cost as much as real ones. Why skipping them is exact: an
// invalid target scores BIG - 2 q.t with |2 q.t| < 2^25, which rounds back to
// BIG (half an ulp of 3e38 is ~1e31), and `sc < best` with best starting at
// BIG never takes it. The contract, against the plain version
// (ops/matching.py::two_nn_batch):
//   * idx, best^2 and second^2 bit-equal at every valid query (and at every
//     query of a block that starts below the extent);
//   * best^2 = BIG at every invalid query;
//   * so the ratio-test masks (which require a valid query and best < BIG)
//     are equal everywhere. Only idx and second^2 of queries in blocks wholly
//     past the extent differ, and nothing reads them.
//
// fp32 route. What bounds it on this card: fp32 FMA issue (2 ext_q ext_t D
// flops a pair against ext D 4 bytes of operands a shot). A block owns 128
// queries of one pair and sweeps 128-target tiles; 256 threads each hold an
// 8 x 8 register tile of dot products, fed from k-major shared slices by
// four 16-byte loads a k (two for its 8 queries, two for its 8 targets):
// 64 bytes of shared reads per 64 FMAs. The wrapper hands the descriptors
// over k-major, (S, D, Fp), so 16-wide k slices of both operands arrive by
// 16-byte cp.async copies straight into the k-major shared layout, into a
// 3-stage ring: the next slices are in flight during the math.
// Each output's dot is one fmaf chain over k in increasing order, whatever
// the tiling, so the route returns the same bits on any input. The
// running top-2 of a thread's 8 query rows lives in shared memory (it is
// touched once per target tile), which keeps the main loop's registers to
// the 64 accumulators and their operands.
//
// bf16 route. What bounds it: tensor-core issue, and the L2 reads of the
// target slices behind it. A block of 8 warps owns 128 queries of one pair
// (a warp 16 rows); the queries' operand rows stay resident in shared memory
// for the whole sweep, and 64-target x 64-wide slices of the targets arrive
// by cp.async into a 3-stage ring. Fragments are read with ldmatrix, and
// each warp runs mma.sync.m16n8k16 (bf16 in, fp32 accumulate) on 16 queries
// x 64 targets, 32 accumulators a thread. The fragment layout and the
// (value, index) epilogue are K1x's (csrc/match_exact_kernel.cu). The
// product is q.t and the epilogue forms |t|^2 - 2 q.t, which is the JAX
// package's A = -2q operand to the bit (a power-of-two scale is exact). On
// +-1 descriptors every product and partial sum is an integer of at most
// 2 D, so the route equals the fp32 route and the plain version bit for bit.
//
// Tie rule (both routes): the lowest global target index wins. Each thread
// scans its own targets in increasing index order with a strict <, and the
// partial results of the threads sharing a query are merged
// lexicographically by (value, index). This gives idx bit-equal to the plain
// PyTorch version (argmin: first minimum), which is stricter than the TPU
// kernel's lowest-lane rule.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG = 3.0e38f;  // invalid-target norm and invalid-query best

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

__device__ __forceinline__ void push_top2(float sc, int t, float& b, float& s, int& i) {
  if (sc < b) {
    s = b;
    b = sc;
    i = t;
  } else if (sc < s) {
    s = sc;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// a query block wholly past its shot's valid extent
__device__ void write_empty(int q0, int nq, int F, size_t row, int* out_idx, float* out_best,
                            float* out_second) {
  for (int r = threadIdx.x; r < nq; r += blockDim.x) {
    const int q = q0 + r;
    if (q < F) {
      out_idx[row + q] = 0;
      out_best[row + q] = BIG;
      out_second[row + q] = BIG;
    }
  }
}

__device__ __forceinline__ void write_out(int p, int q, int q_shot, int F, float best,
                                          float second, int bidx, const float* qnorm,
                                          const unsigned char* valid, int* out_idx,
                                          float* out_best, float* out_second) {
  const size_t o = (size_t)p * F + q;
  const size_t sq = (size_t)q_shot * F + q;
  const float qn = qnorm[sq];
  // |q|^2 added back after the ranking, then clipped at 0
  out_best[o] = valid[sq] ? fmaxf(best + qn, 0.f) : BIG;
  out_second[o] = fmaxf(second + qn, 0.f);
  out_idx[o] = min(max(bidx, 0), F - 1);
}

// ---------------------------------------------------------------------------
// fp32 route

constexpr int F_BQ = 128;       // queries per block
constexpr int F_BT = 128;       // targets per tile
constexpr int F_BK = 16;        // descriptor dims per stage
constexpr int F_LD = F_BQ + 4;  // k-major rows of 128 queries (or targets)
constexpr int F_STAGES = 3;
constexpr int F_THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int F_SMEM = (F_STAGES * 2 * F_BK * F_LD + 3 * 8 * F_THREADS) * 4;

__global__ void __launch_bounds__(F_THREADS, 2)
two_nn_f32_kernel(const float* __restrict__ desc_t,    // (S, D, Fp) k-major, D % F_BK == 0,
                                                       // Fp % 4 == 0, Fp >= F
                  int Fp,
                  const float* __restrict__ qnorm,     // (S, F) |x|^2
                  const float* __restrict__ tnorm,     // (S, F) |x|^2, BIG if invalid
                  const unsigned char* __restrict__ valid,  // (S, F)
                  const int* __restrict__ ext,         // (S,) 1 + last valid slot
                  const int* __restrict__ pairs,       // (P, 2) (q_shot, t_shot)
                  int F, int D,
                  int* __restrict__ out_idx,           // (P, F)
                  float* __restrict__ out_best,        // (P, F)
                  float* __restrict__ out_second) {    // (P, F)
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                               // [STAGES][BK][LD], k-major
  float* Ts = Qs + F_STAGES * F_BK * F_LD;        // [STAGES][BK][LD], k-major
  float* st_b = Ts + F_STAGES * F_BK * F_LD;      // [8][THREADS] running top-2
  float* st_s = st_b + 8 * F_THREADS;
  int* st_i = reinterpret_cast<int*>(st_s + 8 * F_THREADS);

  const int p = blockIdx.x;
  const int q0 = blockIdx.y * F_BQ;
  const int q_shot = pairs[2 * p];
  const int t_shot = pairs[2 * p + 1];
  if (q0 >= ext[q_shot]) {
    write_empty(q0, F_BQ, F, (size_t)p * F, out_idx, out_best, out_second);
    return;
  }
  const int ext_t = ext[t_shot];
  const float* Q = desc_t + (size_t)q_shot * D * Fp;
  const float* T = desc_t + (size_t)t_shot * D * Fp;
  const float* tn = tnorm + (size_t)t_shot * F;

  const int tid = threadIdx.x;
  // a thread's rows are ty*4 + {0..3} and 64 + ty*4 + {0..3}, its targets
  // tx*4 + {0..3} and 64 + tx*4 + {0..3}: two 16-byte loads per operand and
  // k, and 8 consecutive lanes read 8 distinct 16-byte bank groups
  const int tx = tid & 15;
  const int ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    st_b[i * F_THREADS + tid] = BIG;
    st_s[i * F_THREADS + tid] = BIG;
    st_i[i * F_THREADS + tid] = 0;
  }

  const int nk = D / F_BK;
  const int steps = (ext_t + F_BT - 1) / F_BT * nk;  // (target tile, k slice) pairs

  // stage `step` into its ring slot: dims k0 .. k0 + 15 of 128 queries
  // and 128 targets, 4 consecutive features a 16-byte copy, consecutive
  // threads on consecutive pieces of a k row
  auto issue = [&](int step) {
    const int tile = step / nk;
    const int k0 = (step - tile * nk) * F_BK;
    float* qs = Qs + (step % F_STAGES) * F_BK * F_LD;
    float* ts = Ts + (step % F_STAGES) * F_BK * F_LD;
#pragma unroll
    for (int e = tid; e < F_BK * (F_BQ / 4); e += F_THREADS) {
      const int c = e >> 5;
      const int r = (e & 31) * 4;
      const int q = q0 + r;
      const int t = tile * F_BT + r;
      cp_async16(qs + c * F_LD + r, Q + (size_t)(k0 + c) * Fp + (q < Fp ? q : 0), q < Fp);
      cp_async16(ts + c * F_LD + r, T + (size_t)(k0 + c) * Fp + (t < ext_t ? t : 0), t < ext_t);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<F_STAGES - 2>();  // stage s has landed
    __syncthreads();                // ... for every thread; slot (s - 1) is free
    if (s + F_STAGES - 1 < steps) issue(s + F_STAGES - 1);
    cp_async_commit();
    const float* qs = Qs + (s % F_STAGES) * F_BK * F_LD + ty * 4;
    const float* ts = Ts + (s % F_STAGES) * F_BK * F_LD + tx * 4;
    // one fmaf chain per output over k in increasing order
#pragma unroll
    for (int k = 0; k < F_BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(qs + k * F_LD);
      const float4 a1 = *reinterpret_cast<const float4*>(qs + k * F_LD + 64);
      const float4 b0 = *reinterpret_cast<const float4*>(ts + k * F_LD);
      const float4 b1 = *reinterpret_cast<const float4*>(ts + k * F_LD + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    const int tile = s / nk;
    if (s - tile * nk == nk - 1) {
      // fused top-2 epilogue of the tile, each thread's targets in
      // increasing index order (j = 0..7)
      const int t0 = tile * F_BT + tx * 4;
      float tnv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = t0 + (j & 3) + (j >> 2) * 64;
        tnv[j] = t < ext_t ? __ldg(tn + t) : BIG;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float b = st_b[i * F_THREADS + tid], sc2 = st_s[i * F_THREADS + tid];
        int bi = st_i[i * F_THREADS + tid];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int t = t0 + (j & 3) + (j >> 2) * 64;
          if (t < ext_t) push_top2(tnv[j] - 2.f * acc[i][j], t, b, sc2, bi);
          acc[i][j] = 0.f;
        }
        st_b[i * F_THREADS + tid] = b;
        st_s[i * F_THREADS + tid] = sc2;
        st_i[i * F_THREADS + tid] = bi;
      }
    }
  }
  cp_async_wait<0>();

  // merge the 16 partial results of each query row; the 16 threads sharing
  // ty are 16 consecutive lanes of one warp
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float b = st_b[i * F_THREADS + tid], s = st_s[i * F_THREADS + tid];
    int bi = st_i[i * F_THREADS + tid];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, b, off);
      const float os = __shfl_xor_sync(0xffffffffu, s, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      merge_top2(b, s, bi, ob, os, oi);
    }
    const int q = q0 + (i & 3) + (i >> 2) * 64 + ty * 4;
    if (tx == 0 && q < F)
      write_out(p, q, q_shot, F, b, s, bi, qnorm, valid, out_idx, out_best, out_second);
  }
}

// ---------------------------------------------------------------------------
// bf16 route (tensor cores)

constexpr int B_BQ = 128;      // queries per block (8 warps x 16 rows)
constexpr int B_BT = 64;       // targets per tile (8 mma n-fragments of 8)
constexpr int B_BK = 64;       // operand width per stage (4 mma k-steps)
constexpr int B_PAD = 8;       // row pad: 8 rows of a ldmatrix hit 32 distinct banks
constexpr int B_LDT = B_BK + B_PAD;
constexpr int B_STAGES = 3;
constexpr int B_THREADS = 256;

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(B_THREADS)
two_nn_bf16_kernel(const uint16_t* __restrict__ desc,  // (S, F, D) bf16, D % B_BK == 0
                   const float* __restrict__ qnorm,
                   const float* __restrict__ tnorm,
                   const unsigned char* __restrict__ valid,
                   const int* __restrict__ ext,
                   const int* __restrict__ pairs,
                   int F, int D,
                   int* __restrict__ out_idx,
                   float* __restrict__ out_best,
                   float* __restrict__ out_second) {
  extern __shared__ __align__(16) uint16_t smem16[];
  const int lda = D + B_PAD;
  uint16_t* As = smem16;                 // [BQ][D + PAD], resident
  uint16_t* Bs = As + B_BQ * lda;        // [STAGES][BT][LDT]

  const int p = blockIdx.x;
  const int q0 = blockIdx.y * B_BQ;
  const int q_shot = pairs[2 * p];
  const int t_shot = pairs[2 * p + 1];
  if (q0 >= ext[q_shot]) {
    write_empty(q0, B_BQ, F, (size_t)p * F, out_idx, out_best, out_second);
    return;
  }
  const int ext_t = ext[t_shot];
  const uint16_t* Q = desc + (size_t)q_shot * F * D;
  const uint16_t* T = desc + (size_t)t_shot * F * D;
  const float* tn = tnorm + (size_t)t_shot * F;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row group: rows g and g + 8
  const int tig = lane & 3;  // thread in group: columns 2 tig, 2 tig + 1
  const int wr = warp * 16;  // the warp's first query row in the block

  const int nk = D / B_BK;
  const int steps = (ext_t + B_BT - 1) / B_BT * nk;

  // the block's query rows, once, in the first commit group
  {
    const int chunks = D / 8;  // 16-byte pieces a row
    for (int e = tid; e < B_BQ * chunks; e += B_THREADS) {
      const int r = e / chunks;
      const int c = (e - r * chunks) * 8;
      const int q = q0 + r;
      cp_async16(As + r * lda + c, Q + (size_t)(q < F ? q : 0) * D + c, q < F);
    }
  }
  auto issue = [&](int step) {
    const int tile = step / nk;
    const int k0 = (step - tile * nk) * B_BK;
    uint16_t* bs = Bs + (step % B_STAGES) * B_BT * B_LDT;
#pragma unroll
    for (int e = tid; e < B_BT * (B_BK / 8); e += B_THREADS) {
      const int r = e >> 3;
      const int c = (e & 7) * 8;
      const int t = tile * B_BT + r;
      cp_async16(bs + r * B_LDT + c, T + (size_t)(t < ext_t ? t : 0) * D + k0 + c, t < ext_t);
    }
  };

  // running top-2 of query rows wr + g (r = 0) and wr + g + 8 (r = 1)
  float best[2] = {BIG, BIG}, second[2] = {BIG, BIG};
  int bidx[2] = {0, 0};
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < B_STAGES - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<B_STAGES - 2>();
    __syncthreads();
    if (s + B_STAGES - 1 < steps) issue(s + B_STAGES - 1);
    cp_async_commit();
    const int tile = s / nk;
    const int k0 = (s - tile * nk) * B_BK;
    const uint16_t* bs = Bs + (s % B_STAGES) * B_BT * B_LDT;
#pragma unroll
    for (int kk = 0; kk < B_BK; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, As + (wr + (lane & 15)) * lda + k0 + kk + (lane >> 4) * 8);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t b[4];  // b0, b1 of n-fragments 2 jj and 2 jj + 1
        ldmatrix_x4(b, bs + ((2 * jj + (lane >> 4)) * 8 + (lane & 7)) * B_LDT + kk +
                           ((lane >> 3) & 1) * 8);
        mma_bf16_16816(acc[2 * jj], a, b[0], b[1]);
        mma_bf16_16816(acc[2 * jj + 1], a, b[2], b[3]);
      }
    }
    if (s - tile * nk == nk - 1) {
      // fused top-2 epilogue: acc[j][2 r + c] holds query row wr + g + 8 r
      // against target t0 + 8 j + 2 tig + c, visited in increasing t
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int t = tile * B_BT + j * 8 + tig * 2 + c;
          if (t < ext_t) {
            const float tnv = __ldg(tn + t);
#pragma unroll
            for (int r = 0; r < 2; ++r)
              push_top2(tnv - 2.f * acc[j][2 * r + c], t, best[r], second[r], bidx[r]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      }
    }
  }
  cp_async_wait<0>();

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
      const int q = q0 + wr + g + 8 * r;
      if (q < F)
        write_out(p, q, q_shot, F, best[r], second[r], bidx[r], qnorm, valid, out_idx,
                  out_best, out_second);
    }
  }
}

}  // namespace

// C entry points (loaded with ctypes). Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch (or
// cudaErrorInvalidValue for a width it does not take).

// float32 descriptors, k-major: desc_t (S, D, Fp) with D a multiple of 16
// and Fp >= F a multiple of 4 (the wrapper transposes and pads)
extern "C" int two_nn_f32_launch(const float* desc_t, int Fp, const float* qnorm,
                                 const float* tnorm, const unsigned char* valid, const int* ext,
                                 const int* pairs, int F, int D, int P, int* out_idx,
                                 float* out_best, float* out_second, void* stream) {
  if (P <= 0 || F <= 0) return 0;
  if (D <= 0 || D % F_BK != 0 || Fp < F || Fp % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the attribute is the current device's: the wrapper makes the inputs' card current
  cudaError_t e = cudaFuncSetAttribute(two_nn_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(P, (F + F_BQ - 1) / F_BQ);
  two_nn_f32_kernel<<<grid, F_THREADS, F_SMEM, static_cast<cudaStream_t>(stream)>>>(
      desc_t, Fp, qnorm, tnorm, valid, ext, pairs, F, D, out_idx, out_best, out_second);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16 descriptors (as raw 16-bit words); D a multiple of 64, at most 512
extern "C" int two_nn_bf16_launch(const void* desc, const float* qnorm, const float* tnorm,
                                  const unsigned char* valid, const int* ext, const int* pairs,
                                  int F, int D, int P, int* out_idx, float* out_best,
                                  float* out_second, void* stream) {
  if (P <= 0 || F <= 0) return 0;
  if (D <= 0 || D % B_BK != 0 || D > 512) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (B_BQ * (D + B_PAD) + B_STAGES * B_BT * B_LDT) * 2;
  // the attribute is the current device's: the wrapper makes the inputs' card current
  cudaError_t e = cudaFuncSetAttribute(two_nn_bf16_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(P, (F + B_BQ - 1) / B_BQ);
  two_nn_bf16_kernel<<<grid, B_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(desc), qnorm, tnorm, valid, ext, pairs, F, D, out_idx,
      out_best, out_second);
  return static_cast<int>(cudaGetLastError());
}
