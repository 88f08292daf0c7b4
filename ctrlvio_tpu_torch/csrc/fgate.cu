// K7: the front end's epipolar F-RANSAC gate for Hopper, one launch a step
// of the fused tracker (`ctrlvio_tpu_torch/frontend/fused.py`), inside its
// captured program.
//
// Replaces no TPU kernel: the JAX package runs this gate in numpy on the
// host after pulling each frame (`ctrlvio_tpu/frontend/fused.py`'s
// `_consume`, calling `ctrlvio_tpu/frontend/fransac.py::reject_with_f`), and
// so did the port, while the card waited on the host. K7 computes the same
// gate on the card from the step's own state, so nothing goes up or comes
// down for it. Its semantics are those of `reject_with_f` and of the plain
// PyTorch version `ctrlvio_tpu_torch/ops/fgate.py::fgate_plain`:
//
//   supp1 = suppress & ~refilled; same = tracked & prev_pub & ~supp1; the
//   n slots of `same` compacted in slot order. Fewer than 12: nothing is
//   rejected. Else a = prev_norm * 460, b = norm * 460 (virtual pixels),
//   each whitened the Hartley way (mean to 0, mean distance sqrt 2); 200
//   hypotheses, hypothesis h taking the 8 compacted points of the sample
//   table's row n (`np.argsort(default_rng(0).random((200, n)), 1)[:, :8]`,
//   the draw of `reject_with_f`, which depends on n alone); each its 8 x 9
//   system [x1 x0, x1 y0, x1, y1 x0, y1 y0, y1, x0, y0, 1] with unit rows,
//   its null vector as F~, F = T1^T F~ T0, and its inliers: the symmetric
//   epipolar distance max(|b^T F a| / |(F a)_xy|, |b^T F a| / |(F^T b)_xy|)
//   (each norm at least 1e-12) below `thresh`. The hypothesis with the most
//   inliers wins, the lowest index on ties; then up to two refits, each
//   stopping first if fewer than 8 are inliers: the right singular vector
//   of the least singular value of the inliers' system (rows not scaled)
//   as F~, and its inliers over all n. Out: bad = same & ~inlier,
//   suppress_out = supp1 | bad, prev_pub_out = live & ~suppress_out.
//
// What bounds it on an H100: ~2.7 M float64 operations at the image cell's
// 130 common tracks (200 SVDs of 8 x 9 and two of up to 130 x 9 counted as
// LAPACK's, 202 scorings of 130 tracks; `chip_smoke.py::fgate_operations`),
// 0.04 us at the card's 67 TFLOP/s of float64. Bytes are nothing (~10 KB of
// state and the table's 1.6 KB row). Neither is reachable: a Jacobi SVD is
// a chain of ~7 sweeps of 9 rounds, each round a reduction, a rotation (two
// divisions and two square roots) and a barrier that depend on each other,
// some hundreds of cycles; the gate is the hypotheses' chain, then the
// refits' two, each over the whole block. It takes 0.12-0.16 ms a launch
// (graph replay, 130 tracks). The design is built for that chain:
//   - one warp a hypothesis, 4 warps a block, so the 200 chains run at
//     once on 50 SMs;
//   - each null vector by one-sided (Hestenes) Jacobi on the system itself
//     in float64 (not the eigenvectors of A^T A, which would square the
//     condition number that the SVD of `reject_with_f` avoids): the 9
//     columns in round-robin order, 4 disjoint pairs a round on 4 groups of
//     8 lanes (one row a lane), each pair's three dot products by shuffles;
//     a pair rotates while |a_p . a_q| > TOL max(|a_p|^2, |a_q|^2), i.e.
//     while the rotation it would make is larger than TOL; the null vector
//     is the column of V whose column of A V has the least norm;
//   - every block compacts and whitens the tracks itself, in one fixed
//     order (warp 0, fixed reduction trees), so all blocks agree bit for
//     bit and no second launch is needed;
//   - the last block to arrive (a ticket, as in K5 and K6) finishes: the
//     argmax, the two refits by the same Jacobi over the whole block (a
//     pair a warp, the rows over its lanes), the outputs, and the ticket
//     set back to 0 for the next replay.
// Built with --fmad=false (`utils/cuda_build.py`), so a value computed twice
// rounds alike.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HYPS = 200;       // hypotheses (`reject_with_f`'s iters)
constexpr int SAMPLE = 8;       // points a hypothesis
constexpr int MIN_TRACKS = 12;  // fewer common tracks: nothing is rejected
constexpr int MIN_REFIT = 8;    // fewer inliers: no (more) refit
constexpr int REFITS = 2;
constexpr int WARPS = 4;        // warps a block, a hypothesis each
constexpr int THREADS = 32 * WARPS;
constexpr int BLOCKS = (HYPS + WARPS - 1) / WARPS;
constexpr int MAX_N = 256;      // slots K7 takes (sample positions are uint8)
constexpr int WORDS = MAX_N / 32;
constexpr int COLS = 9;
constexpr int MAX_SWEEPS = 30;
constexpr double FOCAL = 460.0;  // ops/fgate.py's VIRTUAL_FOCAL
constexpr double TOL = 256.0 * DBL_EPSILON;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* norm;       // (N, 2) this step's lifted points
  const float* prev_norm;  // (N, 2) the previous step's
  const unsigned char* tracked;
  const unsigned char* refilled;
  const unsigned char* live;
  const unsigned char* prev_pub;
  const unsigned char* suppress;
  const unsigned char* table;  // (N + 1, HYPS, SAMPLE)
  unsigned char* bad;
  unsigned char* suppress_out;
  unsigned char* pub_out;
  int* counts;        // (HYPS,) inliers of each hypothesis
  unsigned* masks;    // (HYPS, WORDS) their inlier bits
  unsigned* ticket;   // 0 at the launch, 0 again after it
  int N;
  double thresh;
};

struct Shared {
  double a[MAX_N][2], b[MAX_N][2];    // virtual px, compacted
  double an[MAX_N][2], bn[MAX_N][2];  // whitened
  double A[COLS][MAX_N];              // the refit's system, by column
  double hA[WARPS][COLS][SAMPLE];     // each warp's hypothesis, by column
  double V[WARPS][COLS][COLS];        // each warp's rotations, by column
  double nrm[WARPS][COLS];            // |column of A V|^2
  double white[2][3];                 // (s, mu_x, mu_y) of a, then of b
  short pos[MAX_N];                   // slot -> compacted index, or -1
  unsigned mask[WORDS];               // the finisher's inliers
  int n, last, best;
};

// NaN-propagating max, as np.maximum
__device__ __forceinline__ double nmax(double x, double y) {
  return (x != x || y != y) ? x + y : (x > y ? x : y);
}

// sum over the lanes that differ in the bits below `width` (a power of two
// up to 32), one xor tree: every lane of the group gets the same bits
template <int WIDTH>
__device__ __forceinline__ double group_sum(double v) {
#pragma unroll
  for (int o = 1; o < WIDTH; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// round k's i-th pair of the 9 columns (a circle of 10, the 10th idle)
__device__ __forceinline__ void pair_of(int k, int i, int* p, int* q) {
  *p = (k + i + 1) % COLS;
  *q = (k + COLS - 1 - i) % COLS;
}

// the Jacobi rotation (c, s) that makes columns p and q orthogonal, given
// alpha = |a_p|^2, beta = |a_q|^2, gamma = a_p . a_q; false where it would
// rotate by less than TOL (so |zeta| < 1 / (2 TOL) and zeta^2 is finite)
__device__ __forceinline__ bool rotation(double al, double be, double ga,
                                         double* c, double* s) {
  if (!(fabs(ga) > TOL * fmax(al, be))) return false;
  const double zeta = (be - al) / (2.0 * ga);
  const double t =
      (zeta >= 0.0 ? 1.0 : -1.0) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
  *c = rsqrt(1.0 + t * t);
  *s = *c * t;
  return true;
}

__device__ __forceinline__ void rotate(double c, double s, double* x,
                                       double* y) {
  const double u = *x, v = *y;
  *x = c * u - s * v;
  *y = s * u + c * v;
}

// one row of the 8-point system from whitened points (x0, y0) -> (x1, y1)
__device__ __forceinline__ void system_row(const double* p0, const double* p1,
                                           double* row) {
  const double x0 = p0[0], y0 = p0[1], x1 = p1[0], y1 = p1[1];
  row[0] = x1 * x0; row[1] = x1 * y0; row[2] = x1;
  row[3] = y1 * x0; row[4] = y1 * y0; row[5] = y1;
  row[6] = x0; row[7] = y0; row[8] = 1.0;
}

// F = T1^T F~ T0 for the null vector v (F~ row-major), T = [[s, 0, -s mu_x],
// [0, s, -s mu_y], [0, 0, 1]] of each whitening
__device__ void unnormalize(const double* v, const double (*white)[3],
                            double* F) {
  double T[2][3][3];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const double s = white[k][0];
    T[k][0][0] = s; T[k][0][1] = 0.0; T[k][0][2] = -s * white[k][1];
    T[k][1][0] = 0.0; T[k][1][1] = s; T[k][1][2] = -s * white[k][2];
    T[k][2][0] = 0.0; T[k][2][1] = 0.0; T[k][2][2] = 1.0;
  }
  double M[3][3];  // F~ T0
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int l = 0; l < 3; ++l)
      M[j][l] = v[3 * j] * T[0][0][l] + v[3 * j + 1] * T[0][1][l] +
                v[3 * j + 2] * T[0][2][l];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int l = 0; l < 3; ++l)
      F[3 * i + l] = T[1][0][i] * M[0][l] + T[1][1][i] * M[1][l] +
                     T[1][2][i] * M[2][l];
}

// the symmetric epipolar distance of a -> b under F (virtual px)
__device__ __forceinline__ double epi_dist(const double* F, const double* a,
                                           const double* b) {
  const double l1x = F[0] * a[0] + F[1] * a[1] + F[2];
  const double l1y = F[3] * a[0] + F[4] * a[1] + F[5];
  const double l1z = F[6] * a[0] + F[7] * a[1] + F[8];
  const double l0x = F[0] * b[0] + F[3] * b[1] + F[6];
  const double l0y = F[1] * b[0] + F[4] * b[1] + F[7];
  const double num = fabs(b[0] * l1x + b[1] * l1y + l1z);
  const double d1 = num / nmax(hypot(l1x, l1y), 1e-12);
  const double d0 = num / nmax(hypot(l0x, l0y), 1e-12);
  return nmax(d0, d1);
}

// the index of the least of 9 values, the lowest on ties
__device__ __forceinline__ int argmin9(const double* x) {
  int k = 0;
  for (int j = 1; j < COLS; ++j)
    if (x[j] < x[k]) k = j;
  return k;
}

// Phase 1, every block alike: compact `same` in slot order (warp 0, one
// ballot a 32 slots), then whiten both point sets (warp 0's fixed trees).
// Returns n.
__device__ int compact_and_whiten(const Args& g, Shared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp == 0) {
    int base = 0;
    for (int c = 0; c < g.N; c += 32) {
      const int t = c + lane;
      bool same = false;
      if (t < g.N) {
        const bool supp1 = g.suppress[t] && !g.refilled[t];
        same = g.tracked[t] && g.prev_pub[t] && !supp1;
      }
      const unsigned bal = __ballot_sync(FULL, same);
      const int k = base + __popc(bal & ((1u << lane) - 1u));
      if (t < g.N) sh.pos[t] = same ? short(k) : short(-1);
      if (same) {
        sh.a[k][0] = double(g.prev_norm[2 * t]) * FOCAL;
        sh.a[k][1] = double(g.prev_norm[2 * t + 1]) * FOCAL;
        sh.b[k][0] = double(g.norm[2 * t]) * FOCAL;
        sh.b[k][1] = double(g.norm[2 * t + 1]) * FOCAL;
      }
      base += __popc(bal);
    }
    __syncwarp();
    const int n = base;
    if (n >= MIN_TRACKS) {
      for (int set = 0; set < 2; ++set) {
        const double(*x)[2] = set ? sh.b : sh.a;
        double sx = 0.0, sy = 0.0;
        for (int k = lane; k < n; k += 32) {
          sx += x[k][0];
          sy += x[k][1];
        }
        const double mx = group_sum<32>(sx) / n, my = group_sum<32>(sy) / n;
        double sd = 0.0;
        for (int k = lane; k < n; k += 32) {
          const double dx = x[k][0] - mx, dy = x[k][1] - my;
          sd += sqrt(dx * dx + dy * dy);
        }
        const double s = sqrt(2.0) / nmax(group_sum<32>(sd) / n, 1e-9);
        if (lane == 0) {
          sh.white[set][0] = s;
          sh.white[set][1] = mx;
          sh.white[set][2] = my;
        }
      }
    }
    if (lane == 0) sh.n = n;
  }
  __syncthreads();
  const int n = sh.n;
  if (n >= MIN_TRACKS) {
    for (int k = tid; k < n; k += THREADS)
#pragma unroll
      for (int set = 0; set < 2; ++set) {
        const double(*x)[2] = set ? sh.b : sh.a;
        double(*xn)[2] = set ? sh.bn : sh.an;
        const double s = sh.white[set][0];
        xn[k][0] = (x[k][0] - sh.white[set][1]) * s;
        xn[k][1] = (x[k][1] - sh.white[set][2]) * s;
      }
    __syncthreads();
  }
  return n;
}

// Phase 2, one warp: hypothesis h's null vector, F and inliers
__device__ void hypothesis(const Args& g, Shared& sh, int n, int h) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 3, r = lane & 7;
  double(*A)[SAMPLE] = sh.hA[warp];
  double(*V)[COLS] = sh.V[warp];
  if (lane < SAMPLE) {
    const int k = g.table[(size_t(n) * HYPS + h) * SAMPLE + lane];
    double row[COLS];
    system_row(sh.an[k], sh.bn[k], row);
    double ss = 0.0;
#pragma unroll
    for (int j = 0; j < COLS; ++j) ss += row[j] * row[j];
    const double nr = nmax(sqrt(ss), 1e-12);
#pragma unroll
    for (int j = 0; j < COLS; ++j) A[j][lane] = row[j] / nr;
  }
  for (int e = lane; e < COLS * COLS; e += 32)
    V[e / COLS][e % COLS] = (e / COLS == e % COLS) ? 1.0 : 0.0;
  __syncwarp();
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    bool rotated = false;
    for (int k = 0; k < COLS; ++k) {
      int p, q;
      pair_of(k, grp, &p, &q);
      const double ap = A[p][r], aq = A[q][r];
      const double al = group_sum<8>(ap * ap);
      const double be = group_sum<8>(aq * aq);
      const double ga = group_sum<8>(ap * aq);
      double c, s;
      if (rotation(al, be, ga, &c, &s)) {
        double x = ap, y = aq;
        rotate(c, s, &x, &y);
        A[p][r] = x;
        A[q][r] = y;
        for (int i = r; i < COLS; i += SAMPLE)
          rotate(c, s, &V[p][i], &V[q][i]);
        rotated = true;
      }
      __syncwarp();
    }
    if (!__any_sync(FULL, rotated)) break;
  }
  for (int j0 = 0; j0 < COLS; j0 += 4) {
    const int j = j0 + grp;
    const double x = j < COLS ? A[j][r] : 0.0;
    const double v = group_sum<8>(x * x);
    if (r == 0 && j < COLS) sh.nrm[warp][j] = v;
  }
  __syncwarp();
  double F[9];
  unnormalize(V[argmin9(sh.nrm[warp])], sh.white, F);
  int count = 0;
  for (int base = 0; base < n; base += 32) {
    const int k = base + lane;
    const bool in = k < n && epi_dist(F, sh.a[k], sh.b[k]) < g.thresh;
    const unsigned bal = __ballot_sync(FULL, in);
    if (lane == 0) g.masks[h * WORDS + base / 32] = bal;
    count += __popc(bal);
  }
  if (lane == 0) g.counts[h] = count;
}

// The finisher's refit: the least right singular vector of the m inliers'
// system (sh.A), by the Jacobi of `hypothesis` over the whole block, then
// the inliers of its F over all n tracks into sh.mask
__device__ void refit(const Args& g, Shared& sh, int n, int m) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double(*V)[COLS] = sh.V[0];
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    bool rotated = false;
    for (int k = 0; k < COLS; ++k) {
      int p, q;
      pair_of(k, warp, &p, &q);
      double al = 0.0, be = 0.0, ga = 0.0;
      for (int i = lane; i < m; i += 32) {
        const double x = sh.A[p][i], y = sh.A[q][i];
        al += x * x;
        be += y * y;
        ga += x * y;
      }
      al = group_sum<32>(al);
      be = group_sum<32>(be);
      ga = group_sum<32>(ga);
      double c, s;
      if (rotation(al, be, ga, &c, &s)) {
        for (int i = lane; i < m; i += 32)
          rotate(c, s, &sh.A[p][i], &sh.A[q][i]);
        if (lane < COLS) rotate(c, s, &V[p][lane], &V[q][lane]);
        rotated = true;
      }
      __syncthreads();
    }
    if (!__syncthreads_or(rotated)) break;
  }
  for (int j0 = 0; j0 < COLS; j0 += WARPS) {
    const int j = j0 + warp;
    double v = 0.0;
    if (j < COLS)
      for (int i = lane; i < m; i += 32) v += sh.A[j][i] * sh.A[j][i];
    v = group_sum<32>(v);
    if (lane == 0 && j < COLS) sh.nrm[0][j] = v;
  }
  __syncthreads();
  double F[9];
  unnormalize(V[argmin9(sh.nrm[0])], sh.white, F);
  for (int base = 0; base < n; base += THREADS) {
    const int k = base + tid;
    const bool in = k < n && epi_dist(F, sh.a[k], sh.b[k]) < g.thresh;
    const unsigned bal = __ballot_sync(FULL, in);
    if (lane == 0) sh.mask[(base >> 5) + warp] = bal;
  }
  __syncthreads();
}

// the inliers' system (rows in compacted order, not scaled) into sh.A and
// V = I; returns m, the inliers
__device__ int refit_system(Shared& sh, int n) {
  const int tid = threadIdx.x;
  const int words = (n + 31) / 32;
  int m = 0;
  for (int w = 0; w < words; ++w) m += __popc(sh.mask[w]);
  if (m < MIN_REFIT) return m;
  for (int k = tid; k < n; k += THREADS) {
    const unsigned wd = sh.mask[k >> 5];
    const unsigned below = wd & ((1u << (k & 31)) - 1u);
    if (!((wd >> (k & 31)) & 1u)) continue;
    int row = __popc(below);
    for (int w = 0; w < (k >> 5); ++w) row += __popc(sh.mask[w]);
    double r[COLS];
    system_row(sh.an[k], sh.bn[k], r);
#pragma unroll
    for (int j = 0; j < COLS; ++j) sh.A[j][row] = r[j];
  }
  for (int e = tid; e < COLS * COLS; e += THREADS)
    sh.V[0][e / COLS][e % COLS] = (e / COLS == e % COLS) ? 1.0 : 0.0;
  __syncthreads();
  return m;
}

__device__ void write_out(const Args& g, const Shared& sh, bool gated) {
  for (int t = threadIdx.x; t < g.N; t += THREADS) {
    const bool supp1 = g.suppress[t] && !g.refilled[t];
    const int k = sh.pos[t];
    const bool bad = gated && k >= 0 && !((sh.mask[k >> 5] >> (k & 31)) & 1u);
    const bool supp = supp1 || bad;
    g.bad[t] = bad;
    g.suppress_out[t] = supp;
    g.pub_out[t] = g.live[t] && !supp;
  }
}

__global__ void __launch_bounds__(THREADS) fgate_kernel(const Args g) {
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = compact_and_whiten(g, sh);
  if (n < MIN_TRACKS) {
    if (blockIdx.x == 0) write_out(g, sh, false);
    return;
  }
  const int h = blockIdx.x * WARPS + warp;
  if (h < HYPS) hypothesis(g, sh, n, h);
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // this block's counts and masks before its ticket
    sh.last = atomicAdd(g.ticket, 1u) == gridDim.x - 1;
    __threadfence();  // and the last block reads the others' after
  }
  __syncthreads();
  if (!sh.last) return;

  if (warp == 0) {
    int bc = -1, bh = 0;
    for (int k = lane; k < HYPS; k += 32) {
      const int c = __ldcg(g.counts + k);
      if (c > bc) {
        bc = c;
        bh = k;
      }
    }
    for (int o = 1; o < 32; o <<= 1) {
      const int oc = __shfl_xor_sync(FULL, bc, o);
      const int oh = __shfl_xor_sync(FULL, bh, o);
      if (oc > bc || (oc == bc && oh < bh)) {
        bc = oc;
        bh = oh;
      }
    }
    if (lane == 0) sh.best = bh;
  }
  __syncthreads();
  const int words = (n + 31) / 32;
  if (tid < WORDS)
    sh.mask[tid] = tid < words ? __ldcg(g.masks + sh.best * WORDS + tid) : 0u;
  __syncthreads();
  for (int it = 0; it < REFITS; ++it) {
    const int m = refit_system(sh, n);
    if (m < MIN_REFIT) break;
    refit(g, sh, n, m);
  }
  write_out(g, sh, true);
  if (tid == 0) *g.ticket = 0u;
}

}  // namespace

extern "C" {

// K7 over N slots: the inputs as the wrapper holds them (bools one byte
// each), `thresh` in virtual px; `counts` (HYPS,) and `masks` (HYPS, WORDS)
// scratch, `ticket` one counter, zero at the launch (zero again after it).
// Returns the launch's cudaError (0 on success); -1 for N out of range.
int fgate(const void* norm, const void* prev_norm, const void* tracked,
          const void* refilled, const void* live, const void* prev_pub,
          const void* suppress, const void* table, int N, double thresh,
          void* bad, void* suppress_out, void* pub_out, void* counts,
          void* masks, void* ticket, void* stream) {
  if (N < 1 || N > MAX_N) return -1;
  Args g;
  g.norm = static_cast<const float*>(norm);
  g.prev_norm = static_cast<const float*>(prev_norm);
  g.tracked = static_cast<const unsigned char*>(tracked);
  g.refilled = static_cast<const unsigned char*>(refilled);
  g.live = static_cast<const unsigned char*>(live);
  g.prev_pub = static_cast<const unsigned char*>(prev_pub);
  g.suppress = static_cast<const unsigned char*>(suppress);
  g.table = static_cast<const unsigned char*>(table);
  g.bad = static_cast<unsigned char*>(bad);
  g.suppress_out = static_cast<unsigned char*>(suppress_out);
  g.pub_out = static_cast<unsigned char*>(pub_out);
  g.counts = static_cast<int*>(counts);
  g.masks = static_cast<unsigned*>(masks);
  g.ticket = static_cast<unsigned*>(ticket);
  g.N = N;
  g.thresh = thresh;
  fgate_kernel<<<BLOCKS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(g);
  return int(cudaGetLastError());
}

// The constants the wrapper must agree with: HYPS, SAMPLE, MIN_TRACKS,
// MAX_N, WORDS, BLOCKS, THREADS.
void fgate_geometry(int* out) {
  out[0] = HYPS;
  out[1] = SAMPLE;
  out[2] = MIN_TRACKS;
  out[3] = MAX_N;
  out[4] = WORDS;
  out[5] = BLOCKS;
  out[6] = THREADS;
}

// registers a thread, local (spill) bytes a thread, static shared bytes a
// block, the most threads a block it can launch with. Returns the cudaError.
int fgate_attributes(long long* out) {
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncGetAttributes(&at, fgate_kernel);
  if (err != cudaSuccess) return int(err);
  out[0] = at.numRegs;
  out[1] = (long long)at.localSizeBytes;
  out[2] = (long long)at.sharedSizeBytes;
  out[3] = at.maxThreadsPerBlock;
  return 0;
}

}  // extern "C"
