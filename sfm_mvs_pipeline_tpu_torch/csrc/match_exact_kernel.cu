// K1x: exact-mode batched 2-NN on the tensor cores (Hopper, sm_90a).
//
// Replaces the TPU kernel _two_nn_kernel
// (sfm_mvs_pipeline_tpu/ops/pallas/match_kernel.py), which the JAX package
// runs for -Pmatch-precision=exact: one bf16 MXU pass over 3-term split
// operands of width 3D.
//
// The wrapper (ops/kernels/match_kernel.py::two_nn_exact_batch) builds the
// operands per shot: A = [q2_hi | q2_lo | q2_hi] with q2 = -2 q, and
// B = [t_hi | t_hi | t_lo], each part the bf16 rounding of the float value
// (hi) or of its remainder (lo), zero-padded to a width that is a multiple
// of 32. One product A.B^T of width 3D then gives
// q2_hi.t_hi + q2_lo.t_hi + q2_hi.t_lo: every product is exact in fp32
// (8 x 8 significant bits) and they accumulate in fp32. For each row
// (q_shot, t_shot) of the pair table and each query of q_shot it ranks the
// targets of t_shot by |t|^2 + dot (|t|^2 is BIG for an invalid target) and
// keeps the best and second score and the best index; |q|^2 is added back
// after the ranking and clipped at 0, an invalid query gets BIG.
//
// What bounds it on this card: tensor-core issue. One pair costs
// 3 * 2 * F^2 * D bf16 flops (F = 8192, D = 128: 51.5 GFLOP) against
// 2 * F * 3D * 2 bytes of operands per shot. The design: a block of four
// warps owns 64 queries of one pair and sweeps the targets in tiles of 64;
// 64 x 32 bf16 slices of A and B are staged in shared memory (rows padded
// by 8 so the fragment loads hit 32 distinct banks), and each warp runs
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate) on 16 queries x 64 targets,
// 32 accumulators a thread. The top-2 is fused into each target tile's
// epilogue, reading the accumulator fragments where the PTX layout puts
// them, so the (F, F) score matrix never reaches device memory. wgmma, TMA
// and a pipelined ring of tiles are later work.
//
// Tie rule: the lowest global target index wins. Each thread visits its
// targets in increasing index order with a strict <, and the four threads
// that share a query row merge by (value, index), as in K1. On
// integer-valued descriptors (the port's SIFT: 0..255) the lo parts are 0
// and every sum is an integer below 2^24, so idx, best^2 and second^2 equal
// K1's and the plain version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // queries per block (4 warps x 16 rows)
constexpr int BT = 64;        // targets per tile (8 mma n-fragments of 8)
constexpr int BK = 32;        // operand width per shared-memory slice (2 mma k-steps)
constexpr int PADK = 8;       // row pad: a row is 40 bf16 = 20 banks
constexpr int LDS = BK + PADK;
constexpr int THREADS = 128;
constexpr float BIG = 3.0e38f;

__device__ __forceinline__ void mma_bf16_16816(float* c, uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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

__global__ void __launch_bounds__(THREADS)
two_nn_exact_kernel(const uint16_t* __restrict__ A,     // (S, F, K3) bf16 query operands
                    const uint16_t* __restrict__ B,     // (S, F, K3) bf16 target operands
                    const float* __restrict__ qnorm,    // (S, F) |x|^2
                    const float* __restrict__ tnorm,    // (S, F) |x|^2, BIG if invalid
                    const unsigned char* __restrict__ valid,  // (S, F)
                    const int* __restrict__ pairs,      // (P, 2) (q_shot, t_shot)
                    int F, int K3,
                    int* __restrict__ out_idx,          // (P, F)
                    float* __restrict__ out_best,       // (P, F)
                    float* __restrict__ out_second) {   // (P, F)
  __shared__ __align__(16) uint16_t As[BQ][LDS];
  __shared__ __align__(16) uint16_t Bs[BT][LDS];

  const int p = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int q_shot = pairs[2 * p];
  const int t_shot = pairs[2 * p + 1];
  const uint16_t* Ap = A + (size_t)q_shot * F * K3;
  const uint16_t* Bp = B + (size_t)t_shot * F * K3;
  const float* tn = tnorm + (size_t)t_shot * F;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row group: rows g and g + 8
  const int tig = lane & 3;  // thread in group: columns 2 tig, 2 tig + 1
  const int wr = warp * 16;  // the warp's first query row in the block

  // running top-2 of query rows wr + g (r = 0) and wr + g + 8 (r = 1)
  float best[2] = {BIG, BIG}, second[2] = {BIG, BIG};
  int bidx[2] = {0, 0};

  for (int t0 = 0; t0 < F; t0 += BT) {
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    for (int k0 = 0; k0 < K3; k0 += BK) {
      // stage 64 rows x 32 bf16 of each operand: 4 x 16 bytes a row,
      // consecutive threads on consecutive 16-byte pieces
      for (int e = tid; e < BQ * (BK / 8); e += THREADS) {
        const int r = e >> 2;
        const int c = (e & 3) * 8;
        uint4 va = make_uint4(0, 0, 0, 0), vb = make_uint4(0, 0, 0, 0);
        if (q0 + r < F) va = *reinterpret_cast<const uint4*>(Ap + (size_t)(q0 + r) * K3 + k0 + c);
        if (t0 + r < F) vb = *reinterpret_cast<const uint4*>(Bp + (size_t)(t0 + r) * K3 + k0 + c);
        *reinterpret_cast<uint4*>(&As[r][c]) = va;
        *reinterpret_cast<uint4*>(&Bs[r][c]) = vb;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        const int kc = kk + tig * 2;
        const uint32_t a0 = ld32(&As[wr + g][kc]);
        const uint32_t a1 = ld32(&As[wr + g + 8][kc]);
        const uint32_t a2 = ld32(&As[wr + g][kc + 8]);
        const uint32_t a3 = ld32(&As[wr + g + 8][kc + 8]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t b0 = ld32(&Bs[j * 8 + g][kc]);
          const uint32_t b1 = ld32(&Bs[j * 8 + g][kc + 8]);
          mma_bf16_16816(acc[j], a0, a1, a2, a3, b0, b1);
        }
      }
      __syncthreads();
    }

    // fused top-2 epilogue: acc[j][2 r + c] holds query row wr + g + 8 r
    // against target t0 + 8 j + 2 tig + c, visited in increasing t
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int t = t0 + j * 8 + tig * 2 + c;
        if (t < F) {
          const float tnv = tn[t];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float sc = tnv + acc[j][2 * r + c];
            if (sc < best[r]) {
              second[r] = best[r];
              best[r] = sc;
              bidx[r] = t;
            } else if (sc < second[r]) {
              second[r] = sc;
            }
          }
        }
      }
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
      const int q = q0 + wr + g + 8 * r;
      if (q < F) {
        const size_t o = (size_t)p * F + q;
        const size_t sq = (size_t)q_shot * F + q;
        const float qn = qnorm[sq];
        const float b = fmaxf(best[r] + qn, 0.f);
        out_best[o] = valid[sq] ? b : BIG;
        out_second[o] = fmaxf(second[r] + qn, 0.f);
        out_idx[o] = min(max(bidx[r], 0), F - 1);
      }
    }
  }
}

}  // namespace

// C entry point (loaded with ctypes). K3 must be a multiple of 32. Launches
// on `stream`, does not synchronise, and returns cudaGetLastError() of the
// launch.
extern "C" int two_nn_exact_launch(const void* A, const void* B, const float* qnorm,
                                   const float* tnorm, const unsigned char* valid,
                                   const int* pairs, int F, int K3, int P,
                                   int* out_idx, float* out_best, float* out_second,
                                   void* stream) {
  if (P <= 0 || F <= 0) return 0;
  if (K3 <= 0 || K3 % BK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(P, (F + BQ - 1) / BQ);
  two_nn_exact_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(A), static_cast<const uint16_t*>(B), qnorm, tnorm,
      valid, pairs, F, K3, out_idx, out_best, out_second);
  return static_cast<int>(cudaGetLastError());
}
