// K2a and K2b: SGM aggregation along the axes of an (H, W, D) cost volume
// (Hopper, sm_90a).
//
// Replaces the TPU kernels of sfm_mvs_pipeline_tpu/ops/pallas/sgm_kernel.py:
//   K2a  sgm_bidir_launch    <- _sgm_kernel (bidirectional, one axis, summed)
//   K2b  sgm_hpair_launch    <- _sgm_dir_kernel, the staged route's two
//                               horizontal directions in one launch
//        sgm_dir_acc_launch  <- _sgm_dir_kernel (acc += L_r, one direction)
//
// The recurrence, per line and per step s along the scan axis, with
// prev = L_r(s-1, .) over the disparities d:
//   m    = min_d prev
//   best = min(min(prev[d], prev[d-1] + P1), min(prev[d+1] + P1, m + P2))
//   L_r(s, d) = c(s, d) + (best - m)
// with the TPU kernel's edge rule (d = 0 and d = D-1 use their own value in
// place of the missing neighbour) and its association c + (best - m).
// Every operation is a min, an add or a subtract: there is no multiply for
// the compiler to contract, so the kernels are bit-equal to their plain
// PyTorch versions (mvs/sgm.py), which keep the same order. The sums of
// directions are reordered only where IEEE arithmetic gives the same bits:
// a + b == b + a, and 0 + x == x by value.
//
// What bounds it on this card: the bytes. A line is a chain of dependent
// steps (each needs the previous step's min over d, a warp-wide reduction),
// but one step takes ~0.1-0.2 us and the lines run in parallel, so at
// (1080, 1920, 96) the chain is far shorter than the time the volume passes
// take at 3.35 TB/s: K2a moves 5 passes of the f32 volume per axis (the
// cost read by both directions, out written twice and read once), the
// staged route of K2b 10.5 (below). The card reaches its memory rate only
// with ~3 MB in flight (3.35 TB/s times ~1 us of latency). A line is one
// warp, and 1,080-1,920 lines give 8-15 warps an SM: with one row in flight
// a warp, and the read of a read-modify-write issued just before its add,
// every step would wait a full round trip (~1 TB/s).
//
// The design:
//   * a prefetch ring of RING = 4 rows a warp in shared memory, filled with
//     16-byte cp.async.cg copies: each step's cost row and, where the step
//     adds to a row of acc or out, that row too, issued RING - 1 steps
//     before its add (3-5 MB in flight at the 1080p shapes). Deeper rings
//     only lengthen the memory system's queues: at 8-16 rows both kernels
//     ran slower on the H100 (PERF.md, section 6). A row is
//     copied as the 16-byte aligned chunks that cover it, so every D (1, 37,
//     96, 256) and every row offset take the same path, and the reader
//     starts at the row's offset within its first chunk.
//   * lane l holds d = l + 32 k (k < NV = ceil(D / 32)): a warp's reads of a
//     ring row hit 32 distinct banks and its writes of a row are 128-byte
//     runs. m is a 5-step xor-shuffle min; each neighbour d -+ 1 is one
//     shuffle a k (lane 0 takes lane 31's previous k, lane 31 lane 0's
//     next). Lanes past D hold +inf, which never wins a min.
//   * both directions of a line at once, for K2a and K2b's horizontal pair:
//     a block is two warps, forward and backward. Each writes its own L over
//     the first half of the positions it visits; the block meets at a
//     barrier; each then adds its L to the other's over the second half
//     (its out or acc rows prefetched through the ring after the barrier).
//     The chain of a line is S steps, not 2S, and twice as many warps are in
//     flight.
//   * K2b's horizontal pair reads the f32 cost, rounds it with
//     __float2bfloat16_rn (as .to(torch.bfloat16) rounds) and scans the
//     rounded value. The first visitor of a position writes acc = L
//     (0 + L == L: no zero-filled accumulator) and the bf16 copy of the cost
//     that the vertical directions read (no separate rounding pass).
//   * the vertical directions keep ((acc + Lvf) + Lvb), so they run forward
//     then backward: two sgm_dir_acc launches (one warp running both in
//     turn, in one launch, measured no faster on the H100).
// Bytes of the staged route, in passes of the f32 volume: horizontal pair
// 2 (cost, both warps) + 0.5 (bf16 copy) + 1 (acc written) + 1 (read) + 1
// (written), vertical 2 x (0.5 + 1 + 1): 10.5.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RING = 4;   // rows in flight a warp
constexpr int WARPS = 2;  // warps a block: one line's two directions, or two lines
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// bytes of a ring slot for a row of D elements of E bytes: the 16-byte
// chunks that cover the row at any offset
__host__ __device__ __forceinline__ int slot_bytes(int D, int E) { return (D * E + 30) / 16 * 16; }

// dynamic shared memory of a block whose warps ring cost rows of E bytes an
// element and f32 rows of out or acc
__host__ __device__ __forceinline__ int block_smem(int D, int E) {
  return WARPS * RING * (slot_bytes(D, E) + slot_bytes(D, 4));
}

// Start copying the row [src, src + nbytes) into the slot at dst as the
// 16-byte aligned chunks that cover it; the row then starts at
// dst + (src & 15). Every chunk holds a byte of the row, so it lies in
// mapped memory.
__device__ __forceinline__ void copy_row(char* dst, const void* src, int nbytes, int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const char* base = reinterpret_cast<const char*>(a & ~uintptr_t(15));
  const int n16 = (static_cast<int>(a & 15) + nbytes + 15) >> 4;
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  for (int j = lane; j < n16; j += 32)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + 16 * j),
                 "l"(base + 16 * j)
                 : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// this thread's copies of all but the newest RING - 1 groups have landed
__device__ __forceinline__ void wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 1) : "memory");
}

template <typename T>
__device__ __forceinline__ const T* in_slot(const char* slot, const T* src) {
  return reinterpret_cast<const T*>(slot + (reinterpret_cast<uintptr_t>(src) & 15));
}

template <int NV>
__device__ __forceinline__ void sgm_step(float (&v)[NV], const float (&c)[NV], int lane, int D,
                                         float p1, float p2) {
  float m = v[0];
#pragma unroll
  for (int k = 1; k < NV; ++k) m = fminf(m, v[k]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(FULL, m, off));
  const float mp2 = m + p2;
  float nv[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    // d - 1: lane - 1 at this k, or lane 31 at k - 1 for lane 0
    const float left =
        __shfl_sync(FULL, (lane == 31 && k > 0) ? v[k > 0 ? k - 1 : 0] : v[k], (lane + 31) & 31);
    // d + 1: lane + 1 at this k, or lane 0 at k + 1 for lane 31
    const float right = __shfl_sync(
        FULL, (lane == 0 && k + 1 < NV) ? v[k + 1 < NV ? k + 1 : k] : v[k], (lane + 1) & 31);
    const int d = lane + 32 * k;
    if (d < D) {
      const float up = d == 0 ? v[k] : left;
      const float dn = d == D - 1 ? v[k] : right;
      const float best = fminf(fminf(v[k], up + p1), fminf(dn + p1, mp2));
      nv[k] = c[k] + (best - m);
    } else {
      nv[k] = pos_inf();
    }
  }
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = nv[k];
}

// One line scanned in one direction: step i visits position
// reverse ? S-1-i : i, whose row starts at element base + position * step.
struct Line {
  long long base, step;
  int S;
  bool reverse;
  __device__ __forceinline__ long long row(int i) const {
    return base + static_cast<long long>(reverse ? S - 1 - i : i) * step;
  }
};

// A warp's ring: RING cost slots of cs bytes, then RING out/acc slots of os.
struct Ring {
  char* cost;
  char* out;
  int cs, os;
};

// Steps i0 .. i1-1 of a line's scan through the prefetch ring; v carries L
// of the previous step in and out (step 0 starts it from the cost). ADD
// stores out = out + L, the row of out prefetched with the cost row;
// otherwise out = L. ROUND rounds the f32 cost to bf16 first and, without
// ADD, stores the rounded row to `copy`.
template <int NV, typename T, bool ROUND, bool ADD>
__device__ __forceinline__ void scan(const T* __restrict__ cost, float* __restrict__ out,
                                     __nv_bfloat16* __restrict__ copy, const Line& ln, int i0,
                                     int i1, int D, float p1, float p2, int lane, const Ring& ring,
                                     float (&v)[NV]) {
  auto issue = [&](int i) {
    if (i < i1) {
      const long long r = ln.row(i);
      copy_row(ring.cost + (i % RING) * ring.cs, cost + r, D * static_cast<int>(sizeof(T)), lane);
      if (ADD) copy_row(ring.out + (i % RING) * ring.os, out + r, D * 4, lane);
    }
    commit();  // one group a step, empty past the end, so wait_ring counts steps
  };
  for (int j = 0; j < RING - 1; ++j) issue(i0 + j);
  for (int i = i0; i < i1; ++i) {
    issue(i + RING - 1);
    wait_ring();
    __syncwarp();  // every lane's chunks of step i have landed
    const long long r = ln.row(i);
    const T* crow = in_slot(ring.cost + (i % RING) * ring.cs, cost + r);
    float c[NV], o[NV];
    __nv_bfloat16 cb[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int d = lane + 32 * k;
      if (ROUND) {
        cb[k] = __float2bfloat16_rn(d < D ? to_f32(crow[d]) : 0.f);
        c[k] = d < D ? __bfloat162float(cb[k]) : pos_inf();
      } else {
        c[k] = d < D ? to_f32(crow[d]) : pos_inf();
      }
    }
    if (ADD) {
      const float* orow = in_slot(ring.out + (i % RING) * ring.os, out + r);
#pragma unroll
      for (int k = 0; k < NV; ++k) o[k] = lane + 32 * k < D ? orow[lane + 32 * k] : 0.f;
    }
    __syncwarp();  // the next step's issue refills this slot
    if (i == 0) {
#pragma unroll
      for (int k = 0; k < NV; ++k) v[k] = c[k];
    } else {
      sgm_step<NV>(v, c, lane, D, p1, p2);
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int d = lane + 32 * k;
      if (d < D) {
        out[r + d] = ADD ? o[k] + v[k] : v[k];
        if (ROUND && !ADD) copy[r + d] = cb[k];
      }
    }
  }
}

// K2a (ROUND = false): out = L_forward + L_backward along the scan axis.
// K2b's horizontal pair (ROUND = true): acc = L_forward + L_backward over
// the bf16-rounded cost, and copy = that cost. One block a line: warp 0
// scans forward, warp 1 backward; they meet in the middle.
template <int NV, bool ROUND>
__global__ void __launch_bounds__(WARPS * 32)
sgm_pair_kernel(const float* __restrict__ cost, float* __restrict__ out,
                __nv_bfloat16* __restrict__ copy, int S, long long step, long long line_stride,
                int D, float p1, float p2) {
  extern __shared__ __align__(16) char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cs = slot_bytes(D, 4), os = slot_bytes(D, 4);
  const Ring ring{smem + warp * RING * (cs + os), smem + warp * RING * (cs + os) + RING * cs, cs,
                  os};
  const Line ln{static_cast<long long>(blockIdx.x) * line_stride, step, S, warp == 1};
  // positions before the middle: 0 .. S/2-1 forward, S-1 .. S/2 backward
  const int half = warp == 0 ? S / 2 : S - S / 2;
  float v[NV];
  scan<NV, float, ROUND, false>(cost, out, copy, ln, 0, half, D, p1, p2, lane, ring, v);
  __syncthreads();  // the other warp's L now covers the rest of the line
  scan<NV, float, ROUND, true>(cost, out, copy, ln, half, S, D, p1, p2, lane, ring, v);
}

// K2b: acc += L_r over the bf16 cost, in place; one warp a line.
template <int NV>
__global__ void __launch_bounds__(WARPS * 32)
sgm_dir_acc_kernel(const __nv_bfloat16* __restrict__ cost, float* __restrict__ acc, int S, int L,
                   long long step, long long line_stride, int D, float p1, float p2, int reverse) {
  extern __shared__ __align__(16) char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x * WARPS + warp;
  if (line >= L) return;  // whole warps leave together; there is no block barrier
  const int cs = slot_bytes(D, 2), os = slot_bytes(D, 4);
  const Ring ring{smem + warp * RING * (cs + os), smem + warp * RING * (cs + os) + RING * cs, cs,
                  os};
  const Line ln{static_cast<long long>(line) * line_stride, step, S, reverse != 0};
  float v[NV];
  scan<NV, __nv_bfloat16, false, true>(cost, acc, nullptr, ln, 0, S, D, p1, p2, lane, ring, v);
}

template <int NV>
int launch_pair(const float* cost, float* out, __nv_bfloat16* copy, int S, int L,
                long long step, long long line_stride, int D, float p1, float p2,
                cudaStream_t stream) {
  const int smem = block_smem(D, 4);
  if (copy != nullptr)
    sgm_pair_kernel<NV, true><<<L, WARPS * 32, smem, stream>>>(cost, out, copy, S, step,
                                                              line_stride, D, p1, p2);
  else
    sgm_pair_kernel<NV, false><<<L, WARPS * 32, smem, stream>>>(cost, out, nullptr, S, step,
                                                               line_stride, D, p1, p2);
  return static_cast<int>(cudaGetLastError());
}

template <int NV>
int launch_dir_acc(const __nv_bfloat16* cost, float* acc, int S, int L, long long step,
                   long long line_stride, int D, float p1, float p2, int reverse,
                   cudaStream_t stream) {
  const dim3 grid((L + WARPS - 1) / WARPS);
  sgm_dir_acc_kernel<NV><<<grid, WARPS * 32, block_smem(D, 2), stream>>>(
      cost, acc, S, L, step, line_stride, D, p1, p2, reverse);
  return static_cast<int>(cudaGetLastError());
}

#define SGM_DISPATCH(NVEXPR, CALL) \
  switch (NVEXPR) {                \
    case 1: return CALL(1);        \
    case 2: return CALL(2);        \
    case 3: return CALL(3);        \
    case 4: return CALL(4);        \
    case 5: return CALL(5);        \
    case 6: return CALL(6);        \
    case 7: return CALL(7);        \
    case 8: return CALL(8);        \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

}  // namespace

// C entry points (loaded with ctypes). A volume is indexed as
// line * line_stride + s * step + d, d < D <= 256, in elements. Each
// launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch.
extern "C" int sgm_bidir_launch(const float* cost, float* out, int S, int L, long long step,
                                long long line_stride, int D, float p1, float p2,
                                void* stream) {
  if (S <= 0 || L <= 0 || D <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(NV) launch_pair<NV>(cost, out, nullptr, S, L, step, line_stride, D, p1, p2, st)
  SGM_DISPATCH((D + 31) / 32, CALL)
#undef CALL
}

// acc = L_forward + L_backward over the f32 cost rounded to bf16, and
// copy_bf16 = that rounded cost; acc and copy share the cost's indexing.
extern "C" int sgm_hpair_launch(const float* cost, float* acc, void* copy_bf16, int S, int L,
                                long long step, long long line_stride, int D, float p1, float p2,
                                void* stream) {
  if (S <= 0 || L <= 0 || D <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* copy = static_cast<__nv_bfloat16*>(copy_bf16);
#define CALL(NV) launch_pair<NV>(cost, acc, copy, S, L, step, line_stride, D, p1, p2, st)
  SGM_DISPATCH((D + 31) / 32, CALL)
#undef CALL
}

// acc is updated in place: acc[i] = acc[i] + L_r[i].
extern "C" int sgm_dir_acc_launch(const void* cost_bf16, float* acc, int S, int L,
                                  long long step, long long line_stride, int D, float p1,
                                  float p2, int reverse, void* stream) {
  if (S <= 0 || L <= 0 || D <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* cost = static_cast<const __nv_bfloat16*>(cost_bf16);
#define CALL(NV) launch_dir_acc<NV>(cost, acc, S, L, step, line_stride, D, p1, p2, reverse, st)
  SGM_DISPATCH((D + 31) / 32, CALL)
#undef CALL
}
