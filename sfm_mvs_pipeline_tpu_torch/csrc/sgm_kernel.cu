// K2a and K2b: SGM aggregation along one axis of an (H, W, D) cost volume
// (Hopper, sm_90a).
//
// Replaces the TPU kernels of sfm_mvs_pipeline_tpu/ops/pallas/sgm_kernel.py:
//   K2a  sgm_bidir_launch    <- _sgm_kernel (bidirectional, one axis, summed)
//   K2b  sgm_dir_acc_launch  <- _sgm_dir_kernel (one direction, acc += L_r)
//
// The recurrence, per line and per step s along the scan axis, with
// prev = L_r(s-1, .) over the disparities d:
//   m    = min_d prev
//   best = min(min(prev[d], prev[d-1] + P1), min(prev[d+1] + P1, m + P2))
//   L_r(s, d) = c(s, d) + (best - m)
// with the TPU kernel's edge rule (d = 0 and d = D-1 use their own value in
// place of the missing neighbour) and its association c + (best - m).
// Every operation is a min, an add or a subtract: there is no multiply for
// the compiler to contract, so both kernels are bit-equal to their plain
// PyTorch versions (mvs/sgm.py), which keep the same order.
//
// What bounds it on this card: the dependence chain along the scan axis.
// Each step needs the previous step's min over d, a warp-wide reduction, so
// a line is a sequential chain of S steps of a few hundred cycles each; the
// bytes (K2a reads the cost twice and the output once and writes the output
// twice: 5 volume passes, ~4 GB at 1080x1920x96) are a second bound. The
// TPU design (scan axis as the sequential grid dimension, state in VMEM,
// L and D padded to (512, 128) tiles with 1e9) is not carried over: the
// volume is taken unpadded. The design here:
//   * one warp per line (a row for the W scan, a column for the H scan);
//     the lines run in parallel, 4 warps to a block;
//   * lane l holds d = l*NV .. l*NV+NV-1 (NV = ceil(D/32): 3 at D = 96);
//     lanes past D hold +inf, which never wins a min;
//   * the state prev stays in registers for the whole loop over the scan
//     axis inside the kernel; m comes from a 5-step xor-shuffle min, and
//     the two neighbours that cross a lane boundary from one shuffle up and
//     one shuffle down;
//   * the layout is (H, W, D) with d fastest, so every step reads one
//     contiguous D-row for both scan axes (no transposes); the next step's
//     row is loaded into registers before the current step is computed.
// Faster forms (cp.async ring of rows, several lines per warp) are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;  // lines per block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int NV, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int lane, int D,
                                         float (&c)[NV]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int d = lane * NV + k;
    c[k] = d < D ? to_f32(row[d]) : __int_as_float(0x7f800000);  // +inf pad
  }
}

template <int NV>
__device__ __forceinline__ void store_row(float* __restrict__ row, int lane, int D,
                                          const float (&v)[NV]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int d = lane * NV + k;
    if (d < D) row[d] = v[k];
  }
}

// row[d] = row[d] + v[d]: the sum of two directions (K2a) or the
// accumulation into acc (K2b)
template <int NV>
__device__ __forceinline__ void add_row(float* __restrict__ row, int lane, int D,
                                        const float (&v)[NV]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int d = lane * NV + k;
    if (d < D) row[d] = row[d] + v[k];
  }
}

template <int NV>
__device__ __forceinline__ void sgm_step(float (&v)[NV], const float (&c)[NV], int lane,
                                         int D, float p1, float p2) {
  float m = v[0];
#pragma unroll
  for (int k = 1; k < NV; ++k) m = fminf(m, v[k]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(FULL, m, off));
  const float left = __shfl_up_sync(FULL, v[NV - 1], 1);  // d = lane*NV - 1
  const float right = __shfl_down_sync(FULL, v[0], 1);    // d = lane*NV + NV
  const float mp2 = m + p2;
  float nv[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int d = lane * NV + k;
    if (d < D) {
      const float up = d == 0 ? v[k] : (k > 0 ? v[k - 1] : left);
      const float dn = d == D - 1 ? v[k] : (k < NV - 1 ? v[k + 1] : right);
      const float best = fminf(fminf(v[k], up + p1), fminf(dn + p1, mp2));
      nv[k] = c[k] + (best - m);
    } else {
      nv[k] = __int_as_float(0x7f800000);
    }
  }
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = nv[k];
}

// One direction along a line: L_r for steps s0, s0+ds, ..., with each
// result handed to `emit(row offset, values)`.
template <int NV, typename T, typename Emit>
__device__ __forceinline__ void sweep(const T* __restrict__ cost, long long base, int S,
                                      long long step, int lane, int D, float p1, float p2,
                                      bool reverse, Emit emit) {
  const long long ds = reverse ? -step : step;
  long long off = base + (reverse ? (long long)(S - 1) * step : 0);
  float v[NV], nxt[NV];
  load_row<NV>(cost + off, lane, D, v);
  emit(off, v);
  if (S > 1) load_row<NV>(cost + off + ds, lane, D, nxt);
  for (int i = 1; i < S; ++i) {
    off += ds;
    float c[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) c[k] = nxt[k];
    if (i + 1 < S) load_row<NV>(cost + off + ds, lane, D, nxt);  // prefetch
    sgm_step<NV>(v, c, lane, D, p1, p2);
    emit(off, v);
  }
}

// K2a: out = L_forward + L_backward along the scan axis.
template <int NV>
__global__ void __launch_bounds__(WARPS * 32)
sgm_bidir_kernel(const float* __restrict__ cost, float* __restrict__ out, int S, int L,
                 long long step, long long line_stride, int D, float p1, float p2) {
  const int line = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (line >= L) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const long long base = (long long)line * line_stride;
  sweep<NV>(cost, base, S, step, lane, D, p1, p2, false,
            [&](long long off, const float (&v)[NV]) { store_row<NV>(out + off, lane, D, v); });
  // the same thread wrote out[off] in the forward pass: no fence needed
  sweep<NV>(cost, base, S, step, lane, D, p1, p2, true,
            [&](long long off, const float (&v)[NV]) { add_row<NV>(out + off, lane, D, v); });
}

// K2b: acc += L_r for one direction, in place; the cost is bf16.
template <int NV>
__global__ void __launch_bounds__(WARPS * 32)
sgm_dir_acc_kernel(const __nv_bfloat16* __restrict__ cost, float* __restrict__ acc, int S,
                   int L, long long step, long long line_stride, int D, float p1, float p2,
                   int reverse) {
  const int line = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (line >= L) return;
  const int lane = threadIdx.x & 31;
  const long long base = (long long)line * line_stride;
  sweep<NV>(cost, base, S, step, lane, D, p1, p2, reverse != 0,
            [&](long long off, const float (&v)[NV]) { add_row<NV>(acc + off, lane, D, v); });
}

template <int NV>
int launch_bidir(const float* cost, float* out, int S, int L, long long step,
                 long long line_stride, int D, float p1, float p2, cudaStream_t stream) {
  const dim3 grid((L + WARPS - 1) / WARPS);
  sgm_bidir_kernel<NV><<<grid, WARPS * 32, 0, stream>>>(cost, out, S, L, step, line_stride,
                                                          D, p1, p2);
  return static_cast<int>(cudaGetLastError());
}

template <int NV>
int launch_dir_acc(const __nv_bfloat16* cost, float* acc, int S, int L, long long step,
                   long long line_stride, int D, float p1, float p2, int reverse,
                   cudaStream_t stream) {
  const dim3 grid((L + WARPS - 1) / WARPS);
  sgm_dir_acc_kernel<NV><<<grid, WARPS * 32, 0, stream>>>(cost, acc, S, L, step, line_stride,
                                                            D, p1, p2, reverse);
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

// C entry points (loaded with ctypes). The volume is indexed as
// line * line_stride + s * step + d, d < D <= 256, in elements. Each
// launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch.
extern "C" int sgm_bidir_launch(const float* cost, float* out, int S, int L, long long step,
                                long long line_stride, int D, float p1, float p2,
                                void* stream) {
  if (S <= 0 || L <= 0 || D <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(NV) launch_bidir<NV>(cost, out, S, L, step, line_stride, D, p1, p2, st)
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
