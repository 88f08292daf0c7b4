// K1: batched Lucas-Kanade refinement at one pyramid level, for Hopper.
//
// Replaces the Pallas TPU kernel `ctrlvio_tpu/ops/pallas/lk_kernel.py::_lk_kernel`
// (reached through `lk_refine` -> `_lk_refine_x32` -> `pl.pallas_call`).
// Semantics are those of `ctrlvio_tpu/frontend/klt.py::_track_level`, batched
// over features, and of its plain PyTorch version
// `ctrlvio_tpu_torch/ops/lk.py::lk_level_plain`:
//
//   per feature, a 21x21 bilinear template T of the previous image at `pts`,
//   central-difference gradients Ix, Iy on the previous image, the structure
//   tensor G and min_eig(G) / 441; then `iters` Gauss-Newton updates
//   g <- g - G^-1 * sum (I(g) - T) [Ix, Iy] on the current image from `guess`.
//   - bilinear sampling clamps the INDEX to [0, W-2] x [0, H-2], not the
//     weight (exactly `klt._bilinear`);
//   - G^-1 divides by where(|det| < 1e-12, 1e-12, det);
//   - the iteration count is fixed (no early exit);
//   - min_eig comes from the template (previous) image.
//
// Where the TPU kernel differs, and this one does not follow it:
//   - it zeroes the step when |det| < 1e-12 (`lk_kernel.py:205`);
//   - it clips patch origins inside its 48x256 DMA window
//     (`lk_kernel.py:218-221`), so a feature that drifts beyond the window
//     is sampled at the clipped place.
// The TPU layout (stacked bilinear-selection matmuls, tile-aligned windows,
// six features per program) existed because the TPU cannot gather; here
// every lane gathers its own pixels through L1/L2.
//
// What bounds it on an H100: at the main path's shapes (N = 150 features,
// 441 pixels each, 10 iterations) the patches touch ~0.6 MB and ~15 MFLOP,
// a fraction of a microsecond at the card's memory and f32 rates, so a
// launch is bound by launch latency and by the serial iteration chain of
// each warp (10 dependent gather -> reduce -> update rounds).
//
// Design: one warp per feature, WARPS features per block. Each lane owns
// pixels k = lane + 32 s (s < 14) of the 441 and keeps their T, Ix, Iy in
// registers; the sums for G and b are warp-shuffle butterflies, after which
// every lane holds bit-identical totals and updates g itself. Built with
// --fmad=false so each product rounds like the plain version's separate
// PyTorch ops; only the order of the 441-term sums differs.

#include <cuda_runtime.h>

namespace {

constexpr int HALF = 10;
constexpr int PATCH = 2 * HALF + 1;           // 21
constexpr int NPIX = PATCH * PATCH;           // 441
constexpr int PER_LANE = (NPIX + 31) / 32;    // 14
constexpr int WARPS = 4;                      // features per block

__device__ __forceinline__ float bilinear(const float* __restrict__ img,
                                          int H, int W, float y, float x) {
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float wx = x - x0;
  const float wy = y - y0;
  // index clamp only (fmaxf maps NaN to 0, like the plain version's clamp)
  const int xi = (int)fminf(fmaxf(x0, 0.0f), (float)(W - 2));
  const int yi = (int)fminf(fmaxf(y0, 0.0f), (float)(H - 2));
  const float* r0 = img + (size_t)yi * W + xi;
  const float* r1 = r0 + W;
  const float i00 = __ldg(r0);
  const float i01 = __ldg(r0 + 1);
  const float i10 = __ldg(r1);
  const float i11 = __ldg(r1 + 1);
  return i00 * (1.0f - wy) * (1.0f - wx) + i01 * (1.0f - wy) * wx
       + i10 * wy * (1.0f - wx) + i11 * wy * wx;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__global__ void __launch_bounds__(32 * WARPS)
lk_level_kernel(const float* __restrict__ prev, const float* __restrict__ cur,
                int H, int W, const float* __restrict__ pts,
                const float* __restrict__ guess, int N, int iters,
                float* __restrict__ out_pts, float* __restrict__ out_eig) {
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (f >= N) return;  // the whole warp leaves together

  const float px = pts[2 * f];
  const float py = pts[2 * f + 1];
  float T[PER_LANE], IX[PER_LANE], IY[PER_LANE];
  float sxx = 0.0f, sxy = 0.0f, syy = 0.0f;
#pragma unroll
  for (int s = 0; s < PER_LANE; ++s) {
    const int k = lane + 32 * s;
    T[s] = 0.0f;
    IX[s] = 0.0f;
    IY[s] = 0.0f;
    if (k < NPIX) {
      const float dy = (float)(k / PATCH - HALF);
      const float dx = (float)(k % PATCH - HALF);
      const float yy = py + dy;
      const float xx = px + dx;
      T[s] = bilinear(prev, H, W, yy, xx);
      IX[s] = 0.5f * (bilinear(prev, H, W, yy, xx + 1.0f)
                      - bilinear(prev, H, W, yy, xx - 1.0f));
      IY[s] = 0.5f * (bilinear(prev, H, W, yy + 1.0f, xx)
                      - bilinear(prev, H, W, yy - 1.0f, xx));
      sxx += IX[s] * IX[s];
      sxy += IX[s] * IY[s];
      syy += IY[s] * IY[s];
    }
  }
  const float gxx = warp_sum(sxx);
  const float gxy = warp_sum(sxy);
  const float gyy = warp_sum(syy);
  const float det = gxx * gyy - gxy * gxy;
  const float tr = gxx + gyy;
  const float min_eig =
      0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.0f * det, 0.0f))) / (float)NPIX;
  const float den = fabsf(det) < 1e-12f ? 1e-12f : det;
  const float a00 = gyy / den;
  const float a01 = -gxy / den;
  const float a11 = gxx / den;

  float gx = guess[2 * f];
  float gy = guess[2 * f + 1];
  for (int it = 0; it < iters; ++it) {
    float bx = 0.0f, by = 0.0f;
#pragma unroll
    for (int s = 0; s < PER_LANE; ++s) {
      const int k = lane + 32 * s;
      if (k < NPIX) {
        const float dy = (float)(k / PATCH - HALF);
        const float dx = (float)(k % PATCH - HALF);
        const float dI = bilinear(cur, H, W, gy + dy, gx + dx) - T[s];
        bx += dI * IX[s];
        by += dI * IY[s];
      }
    }
    bx = warp_sum(bx);
    by = warp_sum(by);
    const float nx = gx - (a00 * bx + a01 * by);
    const float ny = gy - (a01 * bx + a11 * by);
    gx = nx;
    gy = ny;
  }
  if (lane == 0) {
    out_pts[2 * f] = gx;
    out_pts[2 * f + 1] = gy;
    out_eig[f] = min_eig;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). All pointers are device pointers
// to contiguous float32 arrays: prev/cur (H, W), pts/guess/out_pts (N, 2),
// out_eig (N,). Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).
extern "C" int lk_level_f32(const float* prev, const float* cur, int H, int W,
                            const float* pts, const float* guess, int N,
                            int iters, float* out_pts, float* out_eig,
                            void* stream) {
  if (N <= 0) return 0;
  const dim3 block(32 * WARPS);
  const dim3 grid((N + WARPS - 1) / WARPS);
  lk_level_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      prev, cur, H, W, pts, guess, N, iters, out_pts, out_eig);
  return (int)cudaGetLastError();
}
