// K1: batched pyramidal Lucas-Kanade for Hopper. One launch does the whole
// forward-backward track of a frame (`lk_track_f32`); one pyramid level
// alone is the same kernel's L = 1, forward-only case (`lk_level_f32`).
//
// Replaces the Pallas TPU kernel `ctrlvio_tpu/ops/pallas/lk_kernel.py::_lk_kernel`
// (reached through `lk_refine` -> `_lk_refine_x32` -> `pl.pallas_call`), and
// the per-level Python loop and FB gate around it. Semantics are those of
// `ctrlvio_tpu/frontend/klt.py::track` (non-Pallas branch) and
// `_track_level`, batched over features, and of the plain PyTorch versions
// `ctrlvio_tpu_torch/ops/lk.py::lk_track_plain` and `lk_level_plain`:
//
//   one pass over L levels, coarse to fine: g = g0 / 2^(L-1); at each level
//   a 21x21 bilinear template T of image A at p0 / 2^lev, central-difference
//   gradients Ix, Iy on A, the structure tensor G and min_eig(G) / 441, then
//   `iters` Gauss-Newton updates g <- g - G^-1 * sum (I(g) - T) [Ix, Iy] on
//   image B; g *= 2 between levels. Forward: A = prev, B = cur, p0 = pts,
//   g0 = init. Backward: A = cur, B = prev, p0 = pts_cur, g0 = pts. Gate:
//   ok = |pts_back - pts| < fb_thresh & pts_cur in [1, W-1) x [1, H-1) of
//   level 0 & min_eig(level 0, forward) > min_eig.
//   - bilinear sampling clamps the INDEX to [0, W-2] x [0, H-2], not the
//     weight (exactly `klt._bilinear`);
//   - G^-1 divides by where(|det| < 1e-12, 1e-12, det);
//   - the iteration count is fixed (no early exit);
//   - the scalings by powers of two are exact in f32, written as the plain
//     version writes them (p / 2^lev, g * 2).
//
// Where the TPU kernel differs, and this one does not follow it:
//   - it zeroes the step when |det| < 1e-12 (`lk_kernel.py:205`);
//   - it clips patch origins inside its 48x256 DMA window
//     (`lk_kernel.py:218-221`), so a feature that drifts beyond the window
//     is sampled at the clipped place. Here staging is a cache, never a
//     clip: a tap whose clamped 2x2 corner lies outside the staged window
//     reads the image through __ldg and gets the same value, so results are
//     those of the unstaged arithmetic whatever the window size.
//
// What bounds it on an H100 (N = 150 features, 441 pixels, 10 iterations,
// L = 3, so 6 level-passes): ~6 x 20.6 M f32 operations, ~1.84 us at
// 67 TFLOP/s; the windows touched, ~6 x 0.64 MB, ~1.14 us at 3.35 TB/s.
// Neither is reachable: a track is 6 x (1 template + 10 Gauss-Newton)
// = 66 block-wide reductions that depend on each other, each a few hundred
// cycles (shared-memory taps, a 5-step shuffle, one __syncthreads), a
// latency floor of roughly 7-13 us. The kernel is built for that chain:
// each block runs one feature's chain, and what a round costs is the
// length of one warp's instruction stream through it.
//
// Design:
//   - one block of 4 warps per feature (150 blocks fill the 132 SMs in one
//     wave); thread t owns pixels k = t + 128 s (s < 4) of the 441 and keeps
//     their T, Ix, Iy in registers, so a round is 4 taps a thread, a warp
//     shuffle and a 4-entry exchange in shared memory with one
//     __syncthreads. Every thread then holds bit-identical sums and updates
//     g itself; the exchange slots alternate so no second barrier is needed.
//   - a round's 4 taps are independent chains (coordinates, floor, index
//     clamp, shared loads, bilinear weights) with no branch inside them, so
//     they overlap: the pixel a thread lacks (k >= 441) is a copy of pixel
//     440 whose terms are selected away. While g stays in the range over
//     which every tap lies in the staged window (`fast_span`, fixed per
//     level-pass, checked once a round), floor and the integer corner come
//     from one round-down add (`sample_fast`), bit-exact, with no
//     conversion and no per-tap test. Elsewhere `sample` tests each tap and
//     reads the misses from global memory behind one warp-uniform branch.
//   - the level-pass loop is not unrolled: unrolled, a track's code was
//     hundreds of KB, each pass's template code ran cold from the
//     instruction cache, and the template phase took several times longer.
//   - each level-pass stages two windows in shared memory with cp.async
//     (16 bytes a copy where the row pitch is a multiple of 4 floats and the
//     base 16-byte aligned, as on every level of the main path; else
//     4 bytes): the template window of A (28 rows x 32 columns: the patch,
//     the +-1 gradient taps, the bilinear neighbour, 2 px of margin and the
//     column alignment) and the search window of B (32 x 36: 22 + 2M with
//     M = 5 around the level's starting guess). At 1280x1024 a window is
//     3.5 or 4.5 KB against a 5 MB level. Origins are clamped into the
//     image, so index-clamped border taps fall inside. Static shared
//     memory holds L + 1 template and 3 search windows (31 KB at L = 4),
//     used in turn so that no copy lands in a window still being read.
//   - every copy is issued as soon as its origin is known or can be
//     guessed: at launch the forward templates of all levels and both
//     passes' coarsest search windows; after round SPEC of a level, the
//     next finer level's search window around 2 g (its start, up to the
//     rounds left) and, after round SPEC of the forward pass's last level,
//     the backward templates around g / 2^lev. So each copy overlaps the
//     remaining rounds of the level before it. A wrong guess costs only
//     global-memory taps, never a different result.
//   - one launch a frame, no device allocation beyond the outputs, level
//     pointers and shapes passed by value in the kernel's parameter struct:
//     the launch is capturable in a CUDA graph.
// Built with --fmad=false so each product rounds like the plain version's
// separate PyTorch ops; only the order of the 441-term sums differs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HALF = 10;
constexpr int PATCH = 2 * HALF + 1;                      // 21
constexpr int NPIX = PATCH * PATCH;                      // 441
constexpr int WARPS = 4;                                 // per feature
constexpr int THREADS = 32 * WARPS;                      // 128
constexpr int PER_THREAD = (NPIX + THREADS - 1) / THREADS;  // 4
constexpr int MAXL = 4;                                  // pyramid levels
constexpr int SPEC = 2;     // round after which the next windows are issued

// template window: taps span [floor(p) - 11, floor(p) + 12], plus margin
constexpr int T_MARGIN = 2;
constexpr int T_BACK = HALF + 1 + T_MARGIN;              // 13
constexpr int T_ROWS = 2 * HALF + 4 + 2 * T_MARGIN;      // 28
constexpr int T_PITCH = T_ROWS + 4;                      // 32: alignment slack
// search window: taps span [floor(g) - 10, floor(g) + 11], plus M each way
constexpr int M = 5;
constexpr int S_BACK = HALF + M;                         // 15
constexpr int S_ROWS = 2 * HALF + 2 + 2 * M;             // 32
constexpr int S_PITCH = S_ROWS + 4;                      // 36
constexpr int T_FLOATS = T_ROWS * T_PITCH;
constexpr int S_FLOATS = S_ROWS * S_PITCH;

struct Img {
  const float* p;
  int H, W;
  int vec;  // rows may be copied 16 bytes at a time
};

struct Args {
  Img prev[MAXL];
  Img cur[MAXL];
  const float* pts;
  const float* init;
  float* out_pts;
  float* out_eig;
  unsigned char* out_ok;
  int N, iters;
  float fb_thresh, min_eig;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Issue the copy of a ROWS x PITCH window of `im` whose desired origin is
// (floor(cx) - back, floor(cy) - back), clamped into the image, its column
// aligned down to 4. Thread 0 records the staged window (x, y, w, h).
template <int ROWS, int PITCH>
__device__ __forceinline__ void stage(float* dst, int4* meta, const Img im,
                                      float cx, float cy, int back) {
  const int w = min(PITCH, im.W);
  const int h = min(ROWS, im.H);
  // float clamps first: fmaxf maps NaN to 0, fminf caps +inf
  int ox = (int)fminf(fmaxf(floorf(cx) - (float)back, 0.0f),
                      (float)(im.W - w));
  if (im.vec) ox &= ~3;  // W % 4 == 0 here, so the window stays inside
  const int oy = (int)fminf(fmaxf(floorf(cy) - (float)back, 0.0f),
                            (float)(im.H - h));
  if (threadIdx.x == 0) *meta = make_int4(ox, oy, w, h);
  const float* src = im.p + (size_t)oy * im.W + ox;
  if (im.vec) {
    const int q = w >> 2;
    for (int i = threadIdx.x; i < h * q; i += THREADS) {
      const int r = i / q;
      const int c = (i - r * q) << 2;
      cp_async16(dst + r * PITCH + c, src + (size_t)r * im.W + c);
    }
  } else {
    for (int i = threadIdx.x; i < h * w; i += THREADS) {
      const int r = i / w;
      const int c = i - r * w;
      cp_async4(dst + r * PITCH + c, src + (size_t)r * im.W + c);
    }
  }
}

// klt._bilinear at K points (y[k], x[k]) of `im`, each from the staged
// window `win` (origin and extent `o`) where its clamped 2x2 corner lies
// inside it, else from the image: the same values either way. Every lane
// of the warp must call it.
template <int PITCH, int K>
__device__ __forceinline__ void sample(const Img& im, const float* win,
                                       int4 o, const float (&y)[K],
                                       const float (&x)[K], float (&out)[K]) {
  float wx[K], wy[K], i00[K], i01[K], i10[K], i11[K];
  int xi[K], yi[K];
  bool in[K];
  bool all_in = true;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    wx[k] = x[k] - floorf(x[k]);
    wy[k] = y[k] - floorf(y[k]);
    // index clamp only; the floor-conversion maps NaN to 0 and saturates
    // +-inf, as fmaxf/fminf on the floored float would
    xi[k] = min(max(__float2int_rd(x[k]), 0), im.W - 2);
    yi[k] = min(max(__float2int_rd(y[k]), 0), im.H - 2);
    in[k] = (unsigned)(xi[k] - o.x) < (unsigned)(o.z - 1)
         && (unsigned)(yi[k] - o.y) < (unsigned)(o.w - 1);
    all_in = all_in && in[k];
    const float* r0 = win + (in[k] ? (yi[k] - o.y) * PITCH + (xi[k] - o.x) : 0);
    i00[k] = r0[0];
    i01[k] = r0[1];
    i10[k] = r0[PITCH];
    i11[k] = r0[PITCH + 1];
  }
  if (__any_sync(0xffffffffu, !all_in)) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!in[k]) {
        const float* r0 = im.p + (size_t)yi[k] * im.W + xi[k];
        i00[k] = __ldg(r0);
        i01[k] = __ldg(r0 + 1);
        i10[k] = __ldg(r0 + im.W);
        i11[k] = __ldg(r0 + im.W + 1);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    out[k] = i00[k] * (1.0f - wy[k]) * (1.0f - wx[k])
           + i01[k] * (1.0f - wy[k]) * wx[k]
           + i10[k] * wy[k] * (1.0f - wx[k]) + i11[k] * wy[k] * wx[k];
}

// 1.5 * 2^23: for |x| < 2^22, x + MAGIC rounded down is floor(x) + MAGIC,
// exactly, and its bit pattern is MAGIC_BITS + floor(x)
constexpr float MAGIC = 12582912.0f;
constexpr int MAGIC_BITS = 0x4B400000;

// The same values as `sample`, for taps known to lie in the window (see
// `fast_span`): floor and the integer corner from one round-down add, no
// conversion, no per-tap window test. Where a tap does lie outside, the
// relative index is clamped into the buffer, so the read is harmless and
// the caller discards the value.
template <int ROWS, int PITCH, int K>
__device__ __forceinline__ void sample_fast(const Img& im, const float* win,
                                            int4 o, const float (&y)[K],
                                            const float (&x)[K],
                                            float (&out)[K]) {
  const int bx = MAGIC_BITS + o.x;
  const int by = MAGIC_BITS + o.y;
  const int hx = min(im.W - 2 - o.x, PITCH - 2);
  const int hy = min(im.H - 2 - o.y, ROWS - 2);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float tx = __fadd_rd(x[k], MAGIC);
    const float ty = __fadd_rd(y[k], MAGIC);
    const float wx = x[k] - (tx - MAGIC);
    const float wy = y[k] - (ty - MAGIC);
    const int cx = min(max(__float_as_int(tx) - bx, 0), hx);
    const int cy = min(max(__float_as_int(ty) - by, 0), hy);
    const float* r0 = win + cy * PITCH + cx;
    out[k] = r0[0] * (1.0f - wy) * (1.0f - wx) + r0[1] * (1.0f - wy) * wx
           + r0[PITCH] * wy * (1.0f - wx) + r0[PITCH + 1] * wy * wx;
  }
}

// The range of centres c = (x, y) over which every tap within `reach` px
// of c, with its bilinear neighbour and after the index clamp, lies in the
// window `o`, and |c| < 2^21 as `sample_fast` needs: x0 <= x < x1 and
// y0 <= y < y1 (false for NaN). With f = floor(x): the lowest corner
// clamp(f - reach) is >= o.x when o.x = 0 or f >= o.x + reach; the highest,
// clamp(f + reach) + 1, stays inside when the window reaches the image's
// last column or f <= o.x + o.z - 2 - reach.
struct Span {
  float x0, x1, y0, y1;
  __device__ __forceinline__ bool has(float x, float y) const {
    return x0 <= x && x < x1 && y0 <= y && y < y1;
  }
};

__device__ __forceinline__ Span fast_span(const Img& im, int4 o, int reach) {
  constexpr float LIM = 2097152.0f;
  Span sp;
  sp.x0 = o.x == 0 ? -LIM : (float)(o.x + reach);
  sp.y0 = o.y == 0 ? -LIM : (float)(o.y + reach);
  sp.x1 = o.x + o.z >= im.W ? LIM : fminf((float)(o.x + o.z - 1 - reach), LIM);
  sp.y1 = o.y + o.w >= im.H ? LIM : fminf((float)(o.y + o.w - 1 - reach), LIM);
  return sp;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Block-wide sums of K values: a butterfly in each warp (every lane gets
// the same total), then the four warps' totals added in a fixed order, so
// every thread ends with bit-identical sums. `red[par]` alternates, so a
// slot is rewritten only after the barrier that follows every read of it.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K],
                                          float (*red)[3][WARPS], int& par) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = warp_sum(v[j]);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) red[par][j][warp] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float r[WARPS];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) r[w] = red[par][j][w];
#pragma unroll
    for (int h = WARPS / 2; h > 0; h >>= 1)
#pragma unroll
      for (int w = 0; w < h; ++w) r[w] = r[w] + r[w + h];
    v[j] = r[0];
  }
  par ^= 1;
}

// Window buffers of level-pass s (s < L forward, coarse to fine; then the
// backward pass). Forward templates take 0..L-1 (all staged at launch); the
// backward ones, staged during level-pass L-1, take L and then the buffers
// of forward level-passes already done. Search windows alternate between 0
// and 1, except the backward pass's first, staged at launch, in 2.
__device__ __forceinline__ int tmpl_buf(int L, int s) {
  return s < L ? s : (s == L ? L : s - L - 1);
}
__device__ __forceinline__ int srch_buf(int L, int s) {
  return s < L ? (s & 1) : (s == L ? 2 : ((s - L) & 1));
}

// TRACK: the forward and backward passes and the gate (2L level-passes);
// else the forward pass alone (L level-passes), whose outputs are g and
// the last level's min_eig. The level-pass loop is not unrolled: one copy
// of its code stays in the instruction cache for all 2L passes.
template <bool TRACK, int L>
__global__ void __launch_bounds__(THREADS) lk_kernel(const Args a) {
  constexpr int STAGES = TRACK ? 2 * L : L;
  constexpr float TOP = (float)(1 << (L - 1));
  __shared__ __align__(16) float tbuf[TRACK ? L + 1 : L][T_FLOATS];
  __shared__ __align__(16) float sbuf[TRACK ? 3 : 2][S_FLOATS];
  __shared__ __align__(16) float red[2][3][WARPS];
  __shared__ int4 meta[STAGES][2];  // per level-pass: template, search window
  __shared__ Img img[2][L];         // prev, cur levels, indexed at run time
  const int f = blockIdx.x;
  const int tid = threadIdx.x;

  // this thread's pixels; where tid + THREADS * (PER_THREAD - 1) >= NPIX,
  // the last one repeats pixel 440 and its terms are selected away (`own`)
  float DX[PER_THREAD], DY[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int k = min(tid + THREADS * j, NPIX - 1);
    DY[j] = (float)(k / PATCH - HALF);
    DX[j] = (float)(k % PATCH - HALF);
  }
  const bool own = tid + THREADS * (PER_THREAD - 1) < NPIX;
  const float px = a.pts[2 * f];
  const float py = a.pts[2 * f + 1];
  float gx = a.init[2 * f] / TOP;
  float gy = a.init[2 * f + 1] / TOP;

  // at launch: the forward templates and both passes' coarsest searches
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const float sc = (float)(1 << l);
    stage<T_ROWS, T_PITCH>(tbuf[L - 1 - l], &meta[L - 1 - l][0], a.prev[l],
                           px / sc, py / sc, T_BACK);
    if (tid == 0) {
      img[0][l] = a.prev[l];
      img[1][l] = a.cur[l];
    }
  }
  stage<S_ROWS, S_PITCH>(sbuf[0], &meta[0][1], a.cur[L - 1], gx, gy, S_BACK);
  if (TRACK)
    stage<S_ROWS, S_PITCH>(sbuf[2], &meta[L][1], a.prev[L - 1], px / TOP,
                           py / TOP, S_BACK);
  cp_async_commit();

  int par = 0;
  float fx = 0.0f, fy = 0.0f, eig0 = 0.0f;
#pragma unroll 1
  for (int s = 0; s < STAGES; ++s) {
    const bool back = TRACK && s >= L;
    const int lev = back ? 2 * L - 1 - s : L - 1 - s;
    if (TRACK && s == L) {  // the backward pass starts from pts
      fx = gx;
      fy = gy;
      gx = px / TOP;
      gy = py / TOP;
    }
    const float sc = (float)(1 << lev);
    const float qx = (back ? fx : px) / sc;
    const float qy = (back ? fy : py) / sc;
    const float* tw = tbuf[tmpl_buf(L, s)];
    const float* sw = sbuf[srch_buf(L, s)];

    cp_async_wait_all();
    __syncthreads();
    const Img A = img[back ? 1 : 0][lev];
    const Img B = img[back ? 0 : 1][lev];
    const int4 ot = meta[s][0];
    const int4 os = meta[s][1];
    const Span tfast = fast_span(A, ot, 12);  // patch, +-1 and rounding
    const Span sfast = fast_span(B, os, 11);  // patch and rounding

    // template, gradients and G
    float v[PER_THREAD][5];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const float yy = qy + DY[j];
      const float xx = qx + DX[j];
      const float ys[5] = {yy, yy, yy, yy + 1.0f, yy - 1.0f};
      const float xs[5] = {xx, xx + 1.0f, xx - 1.0f, xx, xx};
      sample_fast<T_ROWS, T_PITCH, 5>(A, tw, ot, ys, xs, v[j]);
    }
    if (!tfast.has(qx, qy)) {
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) {
        const float yy = qy + DY[j];
        const float xx = qx + DX[j];
        const float ys[5] = {yy, yy, yy, yy + 1.0f, yy - 1.0f};
        const float xs[5] = {xx, xx + 1.0f, xx - 1.0f, xx, xx};
        sample<T_PITCH, 5>(A, tw, ot, ys, xs, v[j]);
      }
    }
    float T[PER_THREAD], IX[PER_THREAD], IY[PER_THREAD];
    float G[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const bool mine = j < PER_THREAD - 1 || own;
      T[j] = v[j][0];
      IX[j] = mine ? 0.5f * (v[j][1] - v[j][2]) : 0.0f;
      IY[j] = mine ? 0.5f * (v[j][3] - v[j][4]) : 0.0f;
      G[0] += mine ? IX[j] * IX[j] : 0.0f;
      G[1] += mine ? IX[j] * IY[j] : 0.0f;
      G[2] += mine ? IY[j] * IY[j] : 0.0f;
    }
    block_sum<3>(G, red, par);
    const float gxx = G[0], gxy = G[1], gyy = G[2];
    const float det = gxx * gyy - gxy * gxy;
    const float tr = gxx + gyy;
    const float eig =
        0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.0f * det, 0.0f))) / (float)NPIX;
    if (lev == 0 && !back) eig0 = eig;
    const float den = fabsf(det) < 1e-12f ? 1e-12f : det;
    const float a00 = gyy / den;
    const float a01 = -gxy / den;
    const float a11 = gxx / den;

    const int spec = min(SPEC, a.iters);
    for (int it = 0;; ++it) {
      if (it == spec) {
        if (TRACK && s == L - 1) {
          // the backward templates, around the forward result so far
          for (int l = 0; l < L; ++l) {
            const float bs = (float)(1 << l);
            stage<T_ROWS, T_PITCH>(tbuf[tmpl_buf(L, 2 * L - 1 - l)],
                                   &meta[2 * L - 1 - l][0], img[1][l],
                                   gx / bs, gy / bs, T_BACK);
          }
        } else if (s + 1 < STAGES) {
          // the next finer level of this pass starts near 2 g
          stage<S_ROWS, S_PITCH>(sbuf[srch_buf(L, s + 1)], &meta[s + 1][1],
                                 img[back ? 0 : 1][lev - 1], 2.0f * gx,
                                 2.0f * gy, S_BACK);
        }
        cp_async_commit();
      }
      if (it == a.iters) break;
      float ys[PER_THREAD], xs[PER_THREAD], I[PER_THREAD];
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) {
        ys[j] = gy + DY[j];
        xs[j] = gx + DX[j];
      }
      sample_fast<S_ROWS, S_PITCH, PER_THREAD>(B, sw, os, ys, xs, I);
      if (!sfast.has(gx, gy))
        sample<S_PITCH, PER_THREAD>(B, sw, os, ys, xs, I);
      float b[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) {
        const float dI = I[j] - T[j];
        const bool mine = j < PER_THREAD - 1 || own;
        b[0] += mine ? dI * IX[j] : 0.0f;
        b[1] += mine ? dI * IY[j] : 0.0f;
      }
      block_sum<2>(b, red, par);
      const float nx = gx - (a00 * b[0] + a01 * b[1]);
      const float ny = gy - (a01 * b[0] + a11 * b[1]);
      gx = nx;
      gy = ny;
    }
    if (lev > 0) {
      gx = gx * 2.0f;
      gy = gy * 2.0f;
    }
    if (!TRACK) eig0 = eig;
  }

  if (tid == 0) {
    if (TRACK) {
      a.out_pts[2 * f] = fx;
      a.out_pts[2 * f + 1] = fy;
      a.out_eig[f] = eig0;
      const float ex = gx - px;
      const float ey = gy - py;
      const float fb = sqrtf(ex * ex + ey * ey);
      const float W0 = (float)a.prev[0].W;
      const float H0 = (float)a.prev[0].H;
      const bool inb = fx >= 1.0f && fx < W0 - 1.0f && fy >= 1.0f
                    && fy < H0 - 1.0f;
      a.out_ok[f] = (fb < a.fb_thresh) && inb && (eig0 > a.min_eig);
    } else {
      a.out_pts[2 * f] = gx;
      a.out_pts[2 * f + 1] = gy;
      a.out_eig[f] = eig0;
    }
  }
}

Img make_img(const void* p, int H, int W) {
  const int vec = ((uintptr_t)p % 16 == 0) && (W % 4 == 0);
  return Img{(const float*)p, H, W, vec};
}

template <bool TRACK, int L>
int launch(const Args& a, void* stream) {
  lk_kernel<TRACK, L><<<a.N, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). All pointers are device
// pointers to contiguous float32 arrays unless said otherwise. Each
// launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).

// One pyramid level: prev/cur (H, W), pts/guess/out_pts (N, 2) in this
// level's coordinates, out_eig (N,).
extern "C" int lk_level_f32(const float* prev, const float* cur, int H, int W,
                            const float* pts, const float* guess, int N,
                            int iters, float* out_pts, float* out_eig,
                            void* stream) {
  if (N <= 0) return 0;
  Args a = {};
  a.prev[0] = make_img(prev, H, W);
  a.cur[0] = make_img(cur, H, W);
  a.pts = pts;
  a.init = guess;
  a.out_pts = out_pts;
  a.out_eig = out_eig;
  a.N = N;
  a.iters = iters;
  return launch<false, 1>(a, stream);
}

// The whole track: host arrays prev[L], cur[L] of device pointers to the
// levels (H[l], W[l]) of both pyramids, 1 <= L <= 4; pts/init/out_pts
// (N, 2) in level-0 coordinates; out_eig (N,) f32; out_ok (N,) bytes 0/1.
extern "C" int lk_track_f32(const void* const* prev, const void* const* cur,
                            const int* H, const int* W, int L,
                            const float* pts, const float* init, int N,
                            int iters, float fb_thresh, float min_eig,
                            float* out_pts, float* out_eig,
                            unsigned char* out_ok, void* stream) {
  if (L < 1 || L > MAXL) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  Args a = {};
  for (int l = 0; l < L; ++l) {
    a.prev[l] = make_img(prev[l], H[l], W[l]);
    a.cur[l] = make_img(cur[l], H[l], W[l]);
  }
  a.pts = pts;
  a.init = init;
  a.out_pts = out_pts;
  a.out_eig = out_eig;
  a.out_ok = out_ok;
  a.N = N;
  a.iters = iters;
  a.fb_thresh = fb_thresh;
  a.min_eig = min_eig;
  switch (L) {
    case 1: return launch<true, 1>(a, stream);
    case 2: return launch<true, 2>(a, stream);
    case 3: return launch<true, 3>(a, stream);
    default: return launch<true, 4>(a, stream);
  }
}
