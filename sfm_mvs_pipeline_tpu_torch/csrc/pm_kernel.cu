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
//   n is the neighbour with its invalid pixels zeroed (the wrapper passes it
//   so); a neighbour or ref column outside [0, W) reads 0. Then
//     n_mean = sn / A, n_var = max(snn / A - n_mean^2, 1e-8), A = (2r+1)^2
//     zncc = (srn / A - r_mean * n_mean) / sqrt(max(r_var, 1e-8) * n_var)
//     cost = (1 - clip(zncc, -1, 1)) * 0.5
//   and 1 where either centre tap of the neighbour, x - di or x - di - 1,
//   is invalid or outside the image. With parity p in {0, 1}, only pixels
//   with (y + x) % 2 == p are scored; the others get cost 1 (a PatchMatch
//   half-iteration keeps the result of one checkerboard parity only,
//   mvs/patchmatch.py::_pm_rect_pair).
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
// for any di and any width.
//
// What bounds it on this card. Per pixel and candidate at r = 3: ~400
// FP32 operations (8 per window sample), and 56 neighbour taps plus 49 ref
// values to read. An SM issues 128 FP32 lanes a cycle but serves one warp's
// load a cycle, and a warp's taps at random disparities scatter over many
// cache lines, so the loads bound it. A thread per pixel with the 49-value
// ref window in registers and a validity byte then a value per tap through
// L1 runs latency-bound at 115 registers and 16 warps an SM. This design:
//   * a block of 256 threads owns a tile of 4 rows x 64 threads; with a
//     parity a thread owns the active pixel x = 2k + ((y + p) & 1) and
//     writes the cost 1 of its inactive partner x ^ 1, so no lane idles
//     and the tile spans 128 columns;
//   * the ref rows of the tile plus the 2r halo are staged once in shared
//     memory and read back per candidate (no register window);
//   * the block's neighbour taps are staged too: each thread's candidates
//     give its span of source columns, the block reduces them, and when the
//     span fits the staging buffer the 2r+4 neighbour rows over that span
//     and the tile's centre-tap masks go to shared memory, so every tap is
//     one shared load. The buffer is sized at launch for candidates in
//     [0, maxd] (the tile's columns + maxd + 2r + 2, at most NSPAN_MAX), so
//     random candidates over the whole disparity range are staged too. A
//     block whose candidates span more reads its taps from the zeroed
//     neighbour through L1, one load a tap (the validity byte is needed
//     only for the two centre taps). Both paths read the same values.
//   * shared rows are split by column parity (plane c & 1, index c >> 1,
//     planes 16 banks apart), so a warp's 32 lanes at stride 1 or 2 read
//     32 distinct banks at one disparity;
//   * __launch_bounds__(256, 4) caps registers at 64 (32 warps an SM);
//     at a 1,024 px disparity range the parity form's staging (~58 KB a
//     block) fits 3 blocks, 24 warps.
// maxd sizes the staging buffer only; the result does not depend on it.
#include <algorithm>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 64;          // threads along x
constexpr int TY = 4;           // rows a block
constexpr int THREADS = TX * TY;
constexpr int NSPAN_MAX = 2048;  // neighbour columns a block may stage

// words of one parity plane of a shared row of n columns, = 16 mod 32
__host__ __device__ constexpr int plane_words(int n) { return ((n + 1) / 2 + 15) / 32 * 32 + 16; }

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// shared index of local column c in a row split by column parity
__device__ __forceinline__ int sidx(int c, int half) { return (c & 1) * half + (c >> 1); }

// torch.clamp(x, min=lo) on floats: NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return x != x ? x : fmaxf(x, lo); }

// column of window offset 0 in the neighbour, x - di; a clamped di reads
// the same zeros as the unclamped one and keeps the arithmetic in range
__device__ __forceinline__ int src_col(int x, float di, float big) {
  return x - static_cast<int>(fminf(fmaxf(di, -big), big));
}

// nbr_s / msk_s rows are 2 nh wide (nh words a parity plane)
template <int R, bool STAGED, int REF_HALF>
__device__ __forceinline__ void score_pixel(
    const float* __restrict__ cands, const float* __restrict__ nbr,
    const unsigned char* __restrict__ in_n, const float (*ref_s)[2 * REF_HALF],
    const float* nbr_s, const unsigned char* msk_s, int nh,
    float* __restrict__ out, int C, int H, int W, int x, int y, int ly, int c0, int col_lo,
    float rm, float rv) {
  constexpr int K = 2 * R + 1;
  const float area = static_cast<float>(K * K);
  const float big = static_cast<float>(W + K);  // |di| beyond this reads only zeros
  const long long plane = static_cast<long long>(H) * W;
  const long long pix = static_cast<long long>(y) * W + x;
#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    const float d = __ldg(cands + c * plane + pix);
    const float di = floorf(d);
    const float frac = __fsub_rn(d, di);
    const float omf = __fsub_rn(1.f, frac);
    const int src0 = src_col(x, di, big);
    float sn = 0.f, snn = 0.f, srn = 0.f;
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      const long long row = static_cast<long long>(clampi(y + dy - R, 0, H - 1)) * W;
      float t[K + 1];  // taps at offsets -R-1 .. R
#pragma unroll
      for (int k = 0; k <= K; ++k) {
        const int col = src0 + k - R - 1;
        if (STAGED)
          t[k] = nbr_s[(ly + dy) * 2 * nh + sidx(col - col_lo, nh)];
        else
          t[k] = (col >= 0 && col < W) ? __ldg(nbr + row + col) : 0.f;
      }
#pragma unroll
      for (int o = 0; o < K; ++o) {
        const float s = __fadd_rn(__fmul_rn(omf, t[o + 1]), __fmul_rn(frac, t[o]));
        sn = __fadd_rn(sn, s);
        snn = __fadd_rn(snn, __fmul_rn(s, s));
        srn = __fadd_rn(srn, __fmul_rn(ref_s[ly + dy][sidx(c0 + o, REF_HALF)], s));
      }
    }
    bool m0, m1;
    if (STAGED) {
      m0 = msk_s[ly * 2 * nh + sidx(src0 - col_lo, nh)];
      m1 = msk_s[ly * 2 * nh + sidx(src0 - 1 - col_lo, nh)];
    } else {
      const long long crow = static_cast<long long>(y) * W;
      m0 = src0 >= 0 && src0 < W && __ldg(in_n + crow + src0);
      m1 = src0 >= 1 && src0 - 1 < W && __ldg(in_n + crow + src0 - 1);
    }
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

// PAR: score one checkerboard parity (`parity`), else every pixel. The
// dynamic shared memory holds (TY + 2R) neighbour rows and TY mask rows of
// nspan columns.
template <int R, bool PAR>
__global__ void __launch_bounds__(THREADS, 4)
pm_score_kernel(const float* __restrict__ cands, const float* __restrict__ ref,
                const float* __restrict__ nbr, const unsigned char* __restrict__ in_n,
                const float* __restrict__ r_mean, const float* __restrict__ r_var,
                float* __restrict__ out, int C, int H, int W, int parity, int nspan) {
  constexpr int K = 2 * R + 1;
  constexpr int ROWS = TY + 2 * R;
  constexpr int COLS = PAR ? 2 * TX : TX;  // image columns of the tile
  constexpr int REFW = COLS + 2 * R;
  constexpr int REF_HALF = plane_words(REFW);
  __shared__ float ref_s[ROWS][2 * REF_HALF];
  __shared__ int span[2];
  extern __shared__ float dyn[];
  const int nh = plane_words(nspan);
  float* nbr_s = dyn;                                                        // [ROWS][2 nh]
  unsigned char* msk_s = reinterpret_cast<unsigned char*>(dyn + ROWS * 2 * nh);  // [TY][2 nh]

  const int tid = threadIdx.x;
  const int lx = tid % TX;
  const int ly = tid / TX;
  const int x_base = blockIdx.x * COLS;
  const int y0 = blockIdx.y * TY;
  const int y = y0 + ly;
  const int x = x_base + (PAR ? 2 * lx + ((y + parity) & 1) : lx);
  const bool live = y < H && x < W;
  const long long plane = static_cast<long long>(H) * W;
  const long long pix = static_cast<long long>(y) * W + x;
  const float big = static_cast<float>(W + K);

  // the ref rows of the tile and its halo (rows clamped, 0 outside [0, W))
  for (int e = tid; e < ROWS * REFW; e += THREADS) {
    const int rr = e / REFW, c = e - rr * REFW;
    const int yy = clampi(y0 - R + rr, 0, H - 1), xx = x_base - R + c;
    ref_s[rr][sidx(c, REF_HALF)] = (xx >= 0 && xx < W) ? __ldg(ref + (long long)yy * W + xx) : 0.f;
  }
  // the block's span of window-centre source columns over all candidates
  if (tid == 0) {
    span[0] = INT_MAX;
    span[1] = INT_MIN;
  }
  __syncthreads();
  int lo = INT_MAX, hi = INT_MIN;
  if (live) {
    for (int c = 0; c < C; ++c) {
      const int s0 = src_col(x, floorf(__ldg(cands + c * plane + pix)), big);
      lo = min(lo, s0);
      hi = max(hi, s0);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if ((tid & 31) == 0) {
    atomicMin(&span[0], lo);
    atomicMax(&span[1], hi);
  }
  __syncthreads();
  const int col_lo = span[0] - R - 1;  // the taps reach offsets -R-1 .. R
  const bool any = span[0] <= span[1];
  const bool staged = any && static_cast<long long>(span[1]) - span[0] + 2 * R + 2 <= nspan;
  if (staged) {
    const int n = span[1] - span[0] + 2 * R + 2;
    for (int e = tid; e < ROWS * n; e += THREADS) {
      const int rr = e / n, c = e - rr * n;
      const int yy = clampi(y0 - R + rr, 0, H - 1), xx = col_lo + c;
      nbr_s[rr * 2 * nh + sidx(c, nh)] =
          (xx >= 0 && xx < W) ? __ldg(nbr + (long long)yy * W + xx) : 0.f;
    }
    for (int e = tid; e < TY * n; e += THREADS) {
      const int rr = e / n, c = e - rr * n;
      const int yy = y0 + rr, xx = col_lo + c;
      msk_s[rr * 2 * nh + sidx(c, nh)] =
          (yy < H && xx >= 0 && xx < W) ? __ldg(in_n + (long long)yy * W + xx) : 0;
    }
  }
  __syncthreads();

  if (PAR && y < H && (x ^ 1) < W) {  // the inactive partner
#pragma unroll 1
    for (int c = 0; c < C; ++c) out[c * plane + pix - x + (x ^ 1)] = 1.f;
  }
  if (!live) return;
  const float rm = __ldg(r_mean + pix);
  const float rv = clamp_min(__ldg(r_var + pix), 1e-8f);
  const int c0 = x - x_base;  // local ref column of window offset -R
  if (staged)
    score_pixel<R, true, REF_HALF>(cands, nbr, in_n, ref_s, nbr_s, msk_s, nh, out, C, H, W, x,
                                   y, ly, c0, col_lo, rm, rv);
  else
    score_pixel<R, false, REF_HALF>(cands, nbr, in_n, ref_s, nbr_s, msk_s, nh, out, C, H, W, x,
                                    y, ly, c0, col_lo, rm, rv);
}

template <int R, bool PAR>
int launch(const float* cands, const float* ref, const float* nbr, const unsigned char* in_n,
           const float* r_mean, const float* r_var, float* out, int C, int H, int W, int parity,
           int maxd, cudaStream_t stream) {
  constexpr int COLS = PAR ? 2 * TX : TX;
  // the span of candidates in [0, maxd]: the tile, the disparities, the taps
  const int nspan = static_cast<int>(
      std::min<long long>(static_cast<long long>(COLS) + maxd + 2 * R + 2, NSPAN_MAX));
  const int smem = (TY + 2 * R) * 2 * plane_words(nspan) * 4 + TY * 2 * plane_words(nspan);
  // the attribute is the current device's: the wrapper makes the inputs' card current
  const cudaError_t e = cudaFuncSetAttribute(
      pm_score_kernel<R, PAR>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((W + COLS - 1) / COLS, (H + TY - 1) / TY);
  pm_score_kernel<R, PAR><<<grid, THREADS, smem, stream>>>(cands, ref, nbr, in_n, r_mean, r_var,
                                                           out, C, H, W, parity, nspan);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_r(const float* cands, const float* ref, const float* nbr, const unsigned char* in_n,
             const float* r_mean, const float* r_var, float* out, int C, int H, int W,
             int parity, int maxd, cudaStream_t st) {
  if (parity < 0)
    return launch<R, false>(cands, ref, nbr, in_n, r_mean, r_var, out, C, H, W, 0, maxd, st);
  return launch<R, true>(cands, ref, nbr, in_n, r_mean, r_var, out, C, H, W, parity, maxd, st);
}

}  // namespace

// C entry point (loaded with ctypes). cands and out are (C, H, W), the
// other operands (H, W), all contiguous; nbr has its invalid pixels zeroed;
// in_n is one byte (0 or 1) per pixel; 1 <= r <= 4; parity -1 scores every
// pixel, 0 or 1 one checkerboard parity; maxd >= 0 sizes the staging.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch.
extern "C" int pm_score_rect_launch(const float* cands, const float* ref, const float* nbr,
                                    const void* in_n, const float* r_mean, const float* r_var,
                                    float* out, int C, int H, int W, int r, int parity, int maxd,
                                    void* stream) {
  if (C <= 0 || H <= 0 || W <= 0) return 0;
  if ((H + TY - 1) / TY > 65535 || parity < -1 || parity > 1 || maxd < 0)  // grid.y
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* m = static_cast<const unsigned char*>(in_n);
  switch (r) {
    case 1: return launch_r<1>(cands, ref, nbr, m, r_mean, r_var, out, C, H, W, parity, maxd, st);
    case 2: return launch_r<2>(cands, ref, nbr, m, r_mean, r_var, out, C, H, W, parity, maxd, st);
    case 3: return launch_r<3>(cands, ref, nbr, m, r_mean, r_var, out, C, H, W, parity, maxd, st);
    case 4: return launch_r<4>(cands, ref, nbr, m, r_mean, r_var, out, C, H, W, parity, maxd, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
