// K3: PatchMatch candidate scoring in the rectified frame (Hopper, sm_90a).
//
// Replaces the TPU kernel _pm_score_kernel of
// sfm_mvs_pipeline_tpu/ops/pallas/pm_kernel.py (launched by pm_score_rect).
// Plain version: mvs/patchmatch.py::pm_score_rect_plain.
//
// What it computes, per pixel (y, x) and candidate disparity
// d = di + frac (di = floor(d)) of C candidate maps:
//   for dy, o in [-r, r] (dy outer, o inner), y' = clamp(y + dy, 0, H-1):
//     s_o = (1 - frac) * n[y', x + o - di] + frac * n[y', x + o - di - 1]
//     sn += s_o;  snn += s_o * s_o;  srn += ref[y', x + o] * s_o
//   n is the neighbour with its invalid pixels zeroed; a neighbour or ref
//   column outside [0, W) reads 0. Then
//     n_mean = sn / A, n_var = max(snn / A - n_mean^2, 1e-8), A = (2r+1)^2
//     zncc = (srn / A - r_mean * n_mean) / sqrt(max(r_var, 1e-8) * n_var)
//     cost = (1 - clip(zncc, -1, 1)) * 0.5
//   and 1 where either centre tap of the neighbour, x - di or x - di - 1,
//   is invalid or outside the image.
//
// Bit-equality with the plain version: every multiply, add, divide and
// square root is written as its round-to-nearest intrinsic (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn), so nvcc cannot contract a*b + c into
// an FMA, and the sums run in the plain version's order. The plain version
// keeps torch from replacing x / A by x * (1/A) on the card.
//
// The TPU design is not carried over. Its 128-lane hi/lo decomposition of
// the source column, the select loop over source vregs and the
// floor-division bias exist because tpu.dynamic_gather spans one vreg; its
// x-strips bound the unrolled width. Here a thread reads n[y', x + o - di]
// directly, for any di and any width. The design:
//   * one thread per output pixel, 128 threads to a block on one row
//     segment; the block loops over the C candidates, so the ref window and
//     the neighbour rows it reads stay in L1 across candidates;
//   * the ref window ((2r+1)^2 values, 0 outside the image) and the ref
//     statistics are loaded once into registers and reused for every
//     candidate;
//   * the 2r+2 neighbour taps of a window row are shared by its 2r+1
//     bilinear samples; they are read through L1 (__ldg), with the validity
//     byte of each tap. Neighbouring threads have neighbouring x and
//     mostly equal di, so a warp's taps fall on one or two 128-byte lines.
// What bounds it at C = 6, r = 3: per candidate and pixel it issues ~115
// loads (56 taps, their 56 validity bytes, the centre-tap mask, the
// candidate) against ~400 FP32 operations (8 per window sample). An SM
// issues 32 load lanes a cycle against 128 FP32 lanes, so of the two
// throughput limits the loads (through L1, where the rows are reused) come
// first, ahead of FP32 issue; shared memory is not used. Measured at
// (6, 1080, 1920) on an H100 80GB HBM3 at 700 W: 1.22 ms with random
// candidates, 0.95 ms with a smooth field, which by those counts is ~14%
// of the L1 load lanes and ~12% of FP32 issue. So neither bounds it yet:
// ptxas gives 115 registers (the 49-value ref window is most of them), so
// 4 blocks, 16 warps, fit an SM, and the dependent validity-then-value
// loads leave it latency-bound.
// maxd is not needed: no span of the neighbour is staged, so the kernel is
// independent of the disparity range (up to the image width at 1080p).
// The kernel scores every pixel, although a half-iteration keeps the result
// of one checkerboard parity only (mvs/patchmatch.py::_pm_rect_pair);
// scoring only the active parity would halve the work, and is later work.
#include <cuda_runtime.h>

namespace {

constexpr int TX = 128;  // threads (pixels of one row) per block

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// torch.clamp(x, min=lo) on floats: NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return x != x ? x : fmaxf(x, lo); }

template <int R>
__global__ void __launch_bounds__(TX)
pm_score_kernel(const float* __restrict__ cands, const float* __restrict__ ref,
                const float* __restrict__ nbr, const unsigned char* __restrict__ in_n,
                const float* __restrict__ r_mean, const float* __restrict__ r_var,
                float* __restrict__ out, int C, int H, int W) {
  constexpr int K = 2 * R + 1;
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= W) return;
  const float area = static_cast<float>(K * K);
  const long long pix = static_cast<long long>(y) * W + x;
  const long long plane = static_cast<long long>(H) * W;

  float rw[K][K];  // ref window, 0 outside [0, W)
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    const long long row = static_cast<long long>(clampi(y + dy - R, 0, H - 1)) * W;
#pragma unroll
    for (int o = 0; o < K; ++o) {
      const int xx = x + o - R;
      rw[dy][o] = (xx >= 0 && xx < W) ? __ldg(ref + row + xx) : 0.f;
    }
  }
  const float rm = __ldg(r_mean + pix);
  const float rv = clamp_min(__ldg(r_var + pix), 1e-8f);
  const float big = static_cast<float>(W + K);  // |di| beyond this reads only zeros

#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    const float d = __ldg(cands + c * plane + pix);
    const float di = floorf(d);
    const float frac = __fsub_rn(d, di);
    const float omf = __fsub_rn(1.f, frac);
    // a clamped di reads the same zeros as the unclamped one, and keeps the
    // integer column arithmetic in range
    const int src0 = x - static_cast<int>(fminf(fmaxf(di, -big), big));  // column of offset 0
    float sn = 0.f, snn = 0.f, srn = 0.f;
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      const long long row = static_cast<long long>(clampi(y + dy - R, 0, H - 1)) * W;
      float t[K + 1];  // taps at offsets -R-1 .. R
#pragma unroll
      for (int k = 0; k <= K; ++k) {
        const int col = src0 + k - R - 1;
        t[k] = (col >= 0 && col < W && __ldg(in_n + row + col)) ? __ldg(nbr + row + col) : 0.f;
      }
#pragma unroll
      for (int o = 0; o < K; ++o) {
        const float s = __fadd_rn(__fmul_rn(omf, t[o + 1]), __fmul_rn(frac, t[o]));
        sn = __fadd_rn(sn, s);
        snn = __fadd_rn(snn, __fmul_rn(s, s));
        srn = __fadd_rn(srn, __fmul_rn(rw[dy][o], s));
      }
    }
    const long long crow = static_cast<long long>(y) * W;
    const bool m0 = src0 >= 0 && src0 < W && __ldg(in_n + crow + src0);
    const bool m1 = src0 >= 1 && src0 - 1 < W && __ldg(in_n + crow + src0 - 1);
    float cost = 1.f;
    if (m0 && m1) {
      const float n_mean = __fdiv_rn(sn, area);
      const float n_var = clamp_min(__fsub_rn(__fdiv_rn(snn, area), __fmul_rn(n_mean, n_mean)),
                                    1e-8f);
      const float cov = __fsub_rn(__fdiv_rn(srn, area), __fmul_rn(rm, n_mean));
      const float zncc = __fdiv_rn(cov, __fsqrt_rn(__fmul_rn(rv, n_var)));
      const float zc = zncc != zncc ? zncc : fminf(fmaxf(zncc, -1.f), 1.f);
      cost = __fmul_rn(__fsub_rn(1.f, zc), 0.5f);
    }
    out[c * plane + pix] = cost;
  }
}

template <int R>
int launch(const float* cands, const float* ref, const float* nbr, const unsigned char* in_n,
           const float* r_mean, const float* r_var, float* out, int C, int H, int W,
           cudaStream_t stream) {
  const dim3 grid((W + TX - 1) / TX, H);
  pm_score_kernel<R><<<grid, TX, 0, stream>>>(cands, ref, nbr, in_n, r_mean, r_var, out, C, H,
                                              W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (loaded with ctypes). cands and out are (C, H, W), the
// other operands (H, W), all contiguous; in_n is one byte (0 or 1) per
// pixel; 1 <= r <= 4. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() of the launch.
extern "C" int pm_score_rect_launch(const float* cands, const float* ref, const float* nbr,
                                    const void* in_n, const float* r_mean, const float* r_var,
                                    float* out, int C, int H, int W, int r, void* stream) {
  if (C <= 0 || H <= 0 || W <= 0) return 0;
  if (H > 65535) return static_cast<int>(cudaErrorInvalidValue);  // grid.y
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* m = static_cast<const unsigned char*>(in_n);
  switch (r) {
    case 1: return launch<1>(cands, ref, nbr, m, r_mean, r_var, out, C, H, W, st);
    case 2: return launch<2>(cands, ref, nbr, m, r_mean, r_var, out, C, H, W, st);
    case 3: return launch<3>(cands, ref, nbr, m, r_mean, r_var, out, C, H, W, st);
    case 4: return launch<4>(cands, ref, nbr, m, r_mean, r_var, out, C, H, W, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
