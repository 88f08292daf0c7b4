// K6: the square-root marginalization's Q-less QR, for Hopper.
//
// `solver/marginalize.py::build_prior_sqrt` stacks the marginalized factor
// rows, the landmark columns and the old prior's rows into one tall
// [A | b] over the columns [landmarks | window coordinates (dropped first)
// | b], with eps rows eps I under every column, and keeps the rows of its R
// that belong to the kept window coordinates. It replaces no Pallas
// kernel: the JAX package leaves the QR to XLA
// (`ctrlvio_tpu/solver/marginalize.py:287`, `jnp.linalg.qr(A, mode="r")`);
// the port called cuSOLVER's unblocked geqr2 there, one rank-1 update of
// the whole matrix in device memory a column. K6 computes the same R
// (up to row signs, which the prior's J^T J and J^T r0 do not see) without
// the landmark columns or the eps rows ever being built, in two stages
// (the plain version beside the wrapper,
// `ctrlvio_tpu_torch/ops/qr_prior.py::qr_prior_r_plain`, is the same
// mathematics). Its input U is the window part of [A | b]: J scaled by
// its columns' norms, in the window's column order, and r (the wrapper's
// one gather).
//   1. Landmark columns, one landmark at a time. Landmark j's column has
//      non-zeros only in its own observation rows (l_i, scaled by the
//      column's norm) and its own eps row. One Householder reflection with
//      its pivot on the eps row (alpha = eps, beta = -|l|, |l|^2 = eps^2 +
//      sum l_i^2) zeroes the column; the pivot row is the landmark's R row,
//      which the prior never reads, and each observation row's window part
//      becomes u_i - l_i s_j with s_j = (sum_i l_i u_i) / (|l| (|l| +
//      eps)). So stage 1 is a sum over each landmark's rows, made while a
//      block loads them (square-root landmark marginalization, Demmel et
//      al., ICCV 2021).
//   2. The window columns. Every remaining row (the landmark-reduced image
//      rows, the live IMU and bias rows, the old prior's rows) is absorbed
//      into an upper-trapezoidal R (C rows over C + 1 columns) that starts
//      as the window's eps rows, eps I. The rows are cut into batches of
//      ROWS; block k of the lane holds batch k in registers, one column a
//      thread, and streams R through it row by row: at step j it takes row
//      j of the R that block k - 1 wrote, reflects [R_jj; B[:, j]] (LAPACK's
//      dlarfg: beta = -sign(alpha) |(alpha, x)|, tau = (beta - alpha) /
//      beta, v = (1, x / (alpha - beta))), applies the reflection to the
//      columns after j of R's row j and of its batch, and writes the
//      finished row j for block k + 1. Step j touches only row j of R, so
//      the blocks form a pipeline (a flat TSQR tree run as a systolic
//      chain): block k works on row j while block k - 1 works on row j + 1
//      or later. The last block of the chain writes the prior: its rows at
//      and after `keep_from`, scaled back by the columns' norms, in the
//      window's own column order; the others are zero.
//
// What bounds it (the cell's window: 4,674 x 516 assembled, C = 259, f32
// on an H100): the dense QR's 2.4 GFLOP take 36 us at 67 TFLOP/s, and the
// structure leaves ~0.45 GFLOP (3,200 live rows x 260 columns) for stage
// 2, ~7 us. Neither is reachable: each of the C steps is a reduction over
// a batch column followed by an update, a chain of dependent work, so the
// floor is C steps of one block plus the chain's fill, one hop a block.
// The design keeps both short:
//   - a batch's column lives in one thread's registers (no shuffles, no
//     shared-memory traffic for the batch); the next pivot's owner
//     publishes its column with the reflector it makes, so each step has
//     one barrier;
//   - each compute thread reads its own column of block k - 1's rows
//     straight from L2, a row ahead of the step that uses it, so no step
//     waits on device memory; one thread polls block k - 1's
//     progress and another publishes this block's, so no compute warp
//     waits on another block's fence;
//   - the load phase's loads are coalesced rows of U, issued in batches
//     before the arithmetic that uses them.
//
// Chain positions are tickets taken with an atomic as blocks start, so a
// block only ever waits on blocks that started before it: the chain makes
// progress however the card schedules the grid (grid y is the lane; each
// lane has its own chain). A block whose ticket is past the rows exits.
// Every output entry is written; the lane's counters (tickets, progress)
// are zeroed by the wrapper before each launch.
//
// The phases are host-and-device functions: the host build
// (tests/torch_qr_prior_host.cpp) runs a lane's blocks one after another
// in ticket order, each whole, through the same phases and steps.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#include <cmath>
#define HD inline
#endif
#include <stdint.h>

namespace {

HD float fma_(float a, float b, float c) { return fmaf(a, b, c); }
HD double fma_(double a, double b, double c) { return fma(a, b, c); }
HD float sqrt_(float x) { return sqrtf(x); }
HD double sqrt_(double x) { return sqrt(x); }
HD float copysign_(float a, float b) { return copysignf(a, b); }
HD double copysign_(double a, double b) { return copysign(a, b); }

// a shared-memory count (its order shows nowhere) and a read of another
// block's row from L2 (the L1 is not coherent across blocks)
HD void count_add(int* p) {
#ifdef __CUDA_ARCH__
  atomicAdd(p, 1);
#else
  ++*p;
#endif
}
template <typename T>
HD T load_l2(const T* p) {
#ifdef __CUDA_ARCH__
  return __ldcg(p);
#else
  return *p;
#endif
}

// four consecutive values of shared memory (16-byte aligned) in one or two
// vector accesses
template <typename T>
HD void load4(const T* p, T* v) {
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const double2 q0 = *reinterpret_cast<const double2*>(p);
    const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
    v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
  }
#else
  for (int i = 0; i < 4; ++i) v[i] = p[i];
#endif
}
template <typename T>
HD void store4(T* p, const T* v) {
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
    *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
  }
#else
  for (int i = 0; i < 4; ++i) p[i] = v[i];
#endif
}

// rows of a batch (a column of them in each compute thread's registers)
// and the most threads a block: the narrow instance for windows of up to
// 318 columns (C + 2 <= 320), the wide one, half the rows and so fewer
// registers a thread, for up to 574
template <typename T, bool WIDE>
struct Geometry {
  static constexpr int ROWS = (sizeof(T) == 4 ? 64 : 32) / (WIDE ? 2 : 1);
  static constexpr int MAX_THREADS = WIDE ? 640 : 384;
};
constexpr int LM_BATCH = 8;  // a landmark's obs loaded at a time
constexpr int COMM = 64;     // the polling warp and the publishing warp

struct QrArgs {
  // inputs, lane 0, and their lane strides in elements (0: shared)
  const void* U;            // (R, C + 1): [J / cs_c (window order) | r]
  const void* J_lm;         // (MOBS, 2)
  const int64_t* new_idx;   // (MOBS,) compact landmark slot of each obs
  const uint8_t* live_img;  // (MOBS,)
  const uint8_t* live_imu;  // (MIMU,)
  const uint8_t* live_bias; // (NBM1,)
  const void* cs_c;         // (C,) column norms of J
  const int64_t* order;     // (C,) window columns, dropped first
  const int64_t* keep;      // (,) first kept row, or null: keep_i
  const int64_t* perm;      // (MOBS,) obs sorted by live landmark slot
  long long sU, sJlm, snew, slimg, slimu, slbias, scs, sorder, skeep, sperm;
  // outputs (L, C, C) and (L, C); scratch (L, NPOS, C, NCOLP) rows of R
  // between chain positions; counters (L, 1 + NPOS): ticket, progress
  void* J_out;
  void* r_out;
  void* buf;
  unsigned int* counters;
  int L, MOBS, MIMU, NBM1, C, MLM, NPOS, NCOLP;
  long long keep_i;
  double eps;
};

// a block's scalars
struct QrShared {
  int ticket, n_obs, n_imu, n_bias, n_rows, n_pos, q0, q1, s_lo, s_hi, n_lm,
      n_lm_obs;
  volatile int known;  // rows block k - 1 has published
  volatile int done;   // steps the compute threads finished
};

// the block's dynamic shared memory
template <typename T>
struct Smem {
  T* xbuf;     // 2 x ROWS: the next pivot column
  T* piv;      // 2 x 4: the reflector's beta, tau and scale
  T* s_lm;     // (ROWS / 2 + 1) x NCOLP: each landmark's s
  T* lm_cs;    // ROWS / 2 + 1: each landmark's column norm
  T* lm_den;   // ROWS / 2 + 1: |l| (|l| + eps)
  T* lm_jl;    // 2 MOBS: the J_lm of each landmark's obs
  T* desc_l;   // ROWS: each batch row's landmark entry l
  int* cnt;    // MLM: live obs a landmark
  int* start;  // MLM + 1
  int* live_flags;  // MIMU + NBM1: the live IMU slots' and bias pairs'
  int* imu_list;
  int* bias_list;
  int* obs_o;   // ROWS / 2: the batch's obs
  int* obs_j;   // their landmark slots
  int* obs_lm;  // their local landmark
  int* lm_j;    // ROWS / 2 + 1: local landmark -> slot
  int* lm_off;  // ROWS / 2 + 2: its first entry in lm_obs
  int* lm_obs;  // MOBS: every obs of the batch's landmarks, by landmark
  int* desc_row;  // ROWS: the batch row's row of U, -1 for none
  int* desc_lm;   // ROWS: its local landmark, -1 for none
};

HD size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// the layout of Smem from `base` (null: only the size); returns the bytes
template <typename T, int ROWS>
HD size_t smem_layout(unsigned char* base, const QrArgs& a, Smem<T>* s) {
  const int NL = ROWS / 2 + 1;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base ? base + off : nullptr;
    off += align16(bytes);
    return p;
  };
  Smem<T> m;
  m.xbuf = (T*)take(sizeof(T) * 2 * ROWS);
  m.piv = (T*)take(sizeof(T) * 8);
  m.s_lm = (T*)take(sizeof(T) * NL * a.NCOLP);
  m.lm_cs = (T*)take(sizeof(T) * NL);
  m.lm_den = (T*)take(sizeof(T) * NL);
  m.lm_jl = (T*)take(sizeof(T) * 2 * a.MOBS);
  m.desc_l = (T*)take(sizeof(T) * ROWS);
  m.cnt = (int*)take(sizeof(int) * a.MLM);
  m.start = (int*)take(sizeof(int) * (a.MLM + 1));
  m.live_flags = (int*)take(sizeof(int) * (a.MIMU + a.NBM1 + 1));
  m.imu_list = (int*)take(sizeof(int) * (a.MIMU > 0 ? a.MIMU : 1));
  m.bias_list = (int*)take(sizeof(int) * (a.NBM1 > 0 ? a.NBM1 : 1));
  m.obs_o = (int*)take(sizeof(int) * (ROWS / 2));
  m.obs_j = (int*)take(sizeof(int) * (ROWS / 2));
  m.obs_lm = (int*)take(sizeof(int) * (ROWS / 2));
  m.lm_j = (int*)take(sizeof(int) * NL);
  m.lm_off = (int*)take(sizeof(int) * (NL + 1));
  m.lm_obs = (int*)take(sizeof(int) * a.MOBS);
  m.desc_row = (int*)take(sizeof(int) * ROWS);
  m.desc_lm = (int*)take(sizeof(int) * ROWS);
  if (s) *s = m;
  return off;
}

template <typename X>
HD const X* at(const void* p, long long stride, long long lane) {
  return static_cast<const X*>(p) + stride * lane;
}

// ---------------------------------------------------------------------------
// the load: a block's plan, its landmarks' stage 1, its batch
// ---------------------------------------------------------------------------

template <typename T>
HD void phase_zero(const QrArgs& a, const Smem<T>& m, int tid, int nthr) {
  for (int j = tid; j < a.MLM; j += nthr) m.cnt[j] = 0;
}

// live obs a landmark slot (the count is order-free: no atomics' order
// shows), and the IMU slots' and bias pairs' live flags
template <typename T>
HD void phase_count(const QrArgs& a, const Smem<T>& m, long long lane,
                    int tid, int nthr) {
  const uint8_t* live = at<uint8_t>(a.live_img, a.slimg, lane);
  const int64_t* nidx = at<int64_t>(a.new_idx, a.snew, lane);
  for (int o = tid; o < a.MOBS; o += nthr) {
    const int64_t j = nidx[o];
    if (live[o] && j >= 0 && j < a.MLM) count_add(m.cnt + j);
  }
  const uint8_t* limu = at<uint8_t>(a.live_imu, a.slimu, lane);
  const uint8_t* lbias = at<uint8_t>(a.live_bias, a.slbias, lane);
  for (int s = tid; s < a.MIMU + a.NBM1; s += nthr)
    m.live_flags[s] = s < a.MIMU ? limu[s] : lbias[s - a.MIMU];
}

// each slot's start in the sorted obs, and each live IMU slot's and bias
// pair's place in its list: one entry a thread, each a sum of the counts
// before it
template <typename T>
HD void phase_starts(const QrArgs& a, const Smem<T>& m, int tid, int nthr) {
  for (int j = tid; j <= a.MLM; j += nthr) {
    int n = 0;
    for (int i = 0; i < j; ++i) n += m.cnt[i];
    m.start[j] = n;
  }
  for (int s = tid; s < a.MIMU + a.NBM1; s += nthr) {
    if (!m.live_flags[s]) continue;
    const bool imu = s < a.MIMU;
    int n = 0;
    for (int i = imu ? 0 : a.MIMU; i < s; ++i) n += m.live_flags[i];
    if (imu)
      m.imu_list[n] = s;
    else
      m.bias_list[n] = s - a.MIMU;
  }
}

// thread 0: the rows and the block's share of them
template <typename T, int ROWS>
HD void phase_plan(const QrArgs& a, const Smem<T>& m, QrShared& sh) {
  int n_imu = 0, n_bias = 0;
  for (int s = 0; s < a.MIMU; ++s) n_imu += m.live_flags[s];
  for (int s = 0; s < a.NBM1; ++s) n_bias += m.live_flags[a.MIMU + s];
  sh.n_obs = m.start[a.MLM];
  sh.n_imu = n_imu;
  sh.n_bias = n_bias;
  sh.n_rows = 2 * sh.n_obs + 6 * n_imu + 6 * n_bias + a.C;
  sh.n_pos = (sh.n_rows + ROWS - 1) / ROWS;
  sh.q0 = sh.ticket * ROWS;
  sh.q1 = sh.q0 + ROWS < sh.n_rows ? sh.q0 + ROWS : sh.n_rows;
  const int img = 2 * sh.n_obs;
  sh.s_lo = (sh.q0 < img ? sh.q0 : img) / 2;
  sh.s_hi = (sh.q1 < img ? sh.q1 : img) / 2;
}

// the batch's obs, in landmark order
template <typename T>
HD void phase_obs(const QrArgs& a, const Smem<T>& m, const QrShared& sh,
                  long long lane, int tid) {
  if (tid >= sh.s_hi - sh.s_lo) return;
  const int o = int(at<int64_t>(a.perm, a.sperm, lane)[sh.s_lo + tid]);
  m.obs_o[tid] = o;
  m.obs_j[tid] = int(at<int64_t>(a.new_idx, a.snew, lane)[o]);
}

// the batch's landmarks in order (an obs a thread: its landmark's place
// is the number of landmark changes before it)
template <typename T>
HD void phase_landmark_list(const Smem<T>& m, const QrShared& sh, int tid) {
  const int n = sh.s_hi - sh.s_lo;
  if (tid >= n) return;
  int q = 0;
  for (int t = 1; t <= tid; ++t) q += m.obs_j[t] != m.obs_j[t - 1];
  m.obs_lm[tid] = q;
  if (tid == 0 || m.obs_j[tid] != m.obs_j[tid - 1]) m.lm_j[q] = m.obs_j[tid];
}

// each batch row's row of U and landmark (a row a thread), each
// landmark's first entry in lm_obs (a landmark a thread), and the
// landmarks' counts
template <typename T, int ROWS>
HD void phase_rows(const QrArgs& a, const Smem<T>& m, QrShared& sh,
                   int tid) {
  const int n = sh.s_hi - sh.s_lo;
  const int n_lm = n > 0 ? m.obs_lm[n - 1] + 1 : 0;
  if (tid <= n_lm) {
    int off = 0;
    for (int q = 0; q < tid; ++q) off += m.cnt[m.lm_j[q]];
    m.lm_off[tid] = off;
    if (tid == n_lm) {
      sh.n_lm = n_lm;
      sh.n_lm_obs = off;
    }
  }
  if (tid >= ROWS) return;
  const int img = 2 * sh.n_obs;
  const int imu0 = 2 * a.MOBS, bias0 = imu0 + 6 * a.MIMU,
            prior0 = bias0 + 6 * a.NBM1;
  const int q = sh.q0 + tid;
  int row = -1, lm = -1;
  if (q < sh.q1) {
    if (q < img) {
      const int t = q / 2 - sh.s_lo;
      row = 2 * m.obs_o[t] + (q & 1);
      lm = m.obs_lm[t];
    } else {
      int e = q - img;
      if (e < 6 * sh.n_imu) {
        row = imu0 + 6 * m.imu_list[e / 6] + e % 6;
      } else if ((e -= 6 * sh.n_imu) < 6 * sh.n_bias) {
        row = bias0 + 6 * m.bias_list[e / 6] + e % 6;
      } else {
        row = prior0 + e - 6 * sh.n_bias;
      }
    }
  }
  m.desc_row[tid] = row;
  m.desc_lm[tid] = lm;
}

// every obs of the batch's landmarks (landmarks whose rows other blocks
// hold too included) and their J_lm, landmark by landmark
template <typename T>
HD void phase_lm_obs(const QrArgs& a, const Smem<T>& m, const QrShared& sh,
                     long long lane, int tid, int nthr) {
  const int64_t* perm = at<int64_t>(a.perm, a.sperm, lane);
  const T* jlm = at<T>(a.J_lm, a.sJlm, lane);
  for (int t = tid; t < sh.n_lm_obs; t += nthr) {
    int q = 0;
    while (m.lm_off[q + 1] <= t) ++q;
    const int o = int(perm[m.start[m.lm_j[q]] + t - m.lm_off[q]]);
    m.lm_obs[t] = o;
    m.lm_jl[2 * t] = jlm[2 * o];
    m.lm_jl[2 * t + 1] = jlm[2 * o + 1];
  }
}

// thread q: landmark q's column norm and the denominator of its s
template <typename T>
HD void phase_lm_scalars(const QrArgs& a, const Smem<T>& m,
                         const QrShared& sh, int q) {
  if (q >= sh.n_lm) return;
  const T eps = T(a.eps);
  const int t0 = m.lm_off[q], t1 = m.lm_off[q + 1];
  T cs2 = 0;
  for (int t = t0; t < t1; ++t) {
    cs2 = fma_(m.lm_jl[2 * t], m.lm_jl[2 * t], cs2);
    cs2 = fma_(m.lm_jl[2 * t + 1], m.lm_jl[2 * t + 1], cs2);
  }
  T cs = sqrt_(cs2);
  if (!(cs > T(1e-12))) cs = T(1);
  T ll = 0;
  for (int t = t0; t < t1; ++t) {
    const T l0 = m.lm_jl[2 * t] / cs, l1 = m.lm_jl[2 * t + 1] / cs;
    ll = fma_(l0, l0, ll);
    ll = fma_(l1, l1, ll);
  }
  const T nl = sqrt_(fma_(eps, eps, ll));
  m.lm_cs[q] = cs;
  m.lm_den[q] = nl * (nl + eps);
}

// column c of row `row` of U (0 past its columns)
template <typename T>
HD T u_at(const QrArgs& a, long long lane, int c, int row) {
  return c <= a.C
             ? at<T>(a.U, a.sU, lane)[(long long)row * (a.C + 1) + c]
             : T(0);
}

// stage 1 for the batch's landmarks, column c a thread: each one's s,
// its obs' loads LM_BATCH at a time
template <typename T>
HD void phase_landmarks(const QrArgs& a, const Smem<T>& m, const QrShared& sh,
                        long long lane, int c) {
  for (int q = 0; q < sh.n_lm; ++q) {
    const T cs = m.lm_cs[q];
    const int t1 = m.lm_off[q + 1];
    T g = 0;
    for (int t0 = m.lm_off[q]; t0 < t1; t0 += LM_BATCH) {
      T u[2 * LM_BATCH];
#pragma unroll
      for (int b = 0; b < LM_BATCH; ++b) {
        const int o = t0 + b < t1 ? m.lm_obs[t0 + b] : 0;
        u[2 * b] = t0 + b < t1 ? u_at<T>(a, lane, c, 2 * o) : T(0);
        u[2 * b + 1] = t0 + b < t1 ? u_at<T>(a, lane, c, 2 * o + 1) : T(0);
      }
#pragma unroll
      for (int b = 0; b < LM_BATCH; ++b) {
        if (t0 + b >= t1) break;
        const int t = t0 + b;
        g = fma_(m.lm_jl[2 * t] / cs, u[2 * b], g);
        g = fma_(m.lm_jl[2 * t + 1] / cs, u[2 * b + 1], g);
      }
    }
    m.s_lm[q * a.NCOLP + c] = g / m.lm_den[q];
  }
}

// each batch row's landmark entry l (0 for a row with none)
template <typename T, int ROWS>
HD void phase_row_l(const QrArgs& a, const Smem<T>& m, long long lane,
                    int tid) {
  if (tid >= ROWS) return;
  const int lm = m.desc_lm[tid];
  m.desc_l[tid] = lm < 0 ? T(0)
                         : at<T>(a.J_lm, a.sJlm, lane)[m.desc_row[tid]] /
                               m.lm_cs[lm];
}

// the thread's column of the batch: u - l s for an image row
template <typename T, int ROWS>
HD void load_batch(const QrArgs& a, const Smem<T>& m, long long lane, int c,
                   T* B) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = m.desc_row[i];
    B[i] = row >= 0 ? u_at<T>(a, lane, c, row) : T(0);
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int lm = m.desc_lm[i];
    if (lm >= 0) B[i] = fma_(-m.desc_l[i], m.s_lm[lm * a.NCOLP + c], B[i]);
  }
}

// ---------------------------------------------------------------------------
// the chain: steps of the compute threads
// ---------------------------------------------------------------------------

// the reflection that zeroes x below alpha (LAPACK's dlarfg; the identity
// where x is 0): beta, tau and the scale of x in v
template <typename T>
HD void reflector(T alpha, T n2, T* piv) {
  T beta = alpha, tau = 0, scale = 0;
  if (n2 != T(0)) {
    beta = -copysign_(sqrt_(fma_(alpha, alpha, n2)), alpha);
    tau = (beta - alpha) / beta;
    scale = T(1) / (alpha - beta);
  }
  piv[0] = beta;
  piv[1] = tau;
  piv[2] = scale;
}

// the thread's column as the next pivot: its values, and the reflector
// that meets it with `alpha`, the pivot entry of its row
template <typename T, int ROWS>
HD void publish_pivot(const T* B, T alpha, T* x, T* piv) {
  T n[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < ROWS; i += 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) n[k] = fma_(B[i + k], B[i + k], n[k]);
    store4(x + i, B + i);
  }
  reflector(alpha, (n[0] + n[1]) + (n[2] + n[3]), piv);
}

template <typename T>
HD T* lane_buf(const QrArgs& a, long long lane, int k) {
  return static_cast<T*>(a.buf) +
         ((long long)lane * a.NPOS + k) * (long long)a.C * a.NCOLP;
}

// a compute thread's column c of R's rows: where its entry of row j comes
// from (block k - 1's rows in the scratch, in[j NCOLP]; the first block's
// eps e_j) and goes (out[j stride]: this block's scratch for block k + 1;
// the last block's, the prior, every row written, the window column's
// entries scaled back by its norm, the rows before `keep` zero). Worked
// out once, so that a step spends no instructions on addresses
template <typename T>
struct Column {
  int c;
  const T* in;
  T* out;
  int stride;
  T scale;
  bool last;
  long long keep;
};

template <typename T>
HD Column<T> column(const QrArgs& a, const QrShared& sh, long long lane,
                    int c) {
  Column<T> col{c, nullptr, nullptr, a.NCOLP, T(1), false, 0};
  if (c > a.C) return col;
  const int k = sh.ticket;
  if (k > 0) col.in = lane_buf<T>(a, lane, k - 1) + c;
  col.last = k == sh.n_pos - 1;
  col.keep = a.keep ? at<int64_t>(a.keep, a.skeep, lane)[0] : a.keep_i;
  if (!col.last) {
    col.out = lane_buf<T>(a, lane, k) + c;
  } else if (c < a.C) {
    const int ord = int(at<int64_t>(a.order, a.sorder, lane)[c]);
    col.out = static_cast<T*>(a.J_out) + lane * (long long)a.C * a.C + ord;
    col.stride = a.C;
    col.scale = at<T>(a.cs_c, a.scs, lane)[ord];
  } else {
    col.out = static_cast<T*>(a.r_out) + lane * (long long)a.C;
    col.stride = 1;
  }
  return col;
}

// row j's entry in the thread's column, into R's row j
template <typename T>
HD void put(const Column<T>& col, int j, T v) {
  if (!col.out) return;
  if (col.last)
    col.out[(long long)j * col.stride] =
        j >= col.keep && col.c >= j ? v * col.scale : T(0);
  else if (col.c >= j)
    col.out[(long long)j * col.stride] = v;
}

// row j of block k's input, the thread's column
template <typename T>
HD T input_at(const Column<T>& col, const QrArgs& a, int j) {
  if (j >= a.C || col.c > a.C) return T(0);
  if (!col.in) return col.c == j ? T(a.eps) : T(0);
  return load_l2(col.in + (long long)j * a.NCOLP);
}

// step j of a compute thread: the reflection of [alpha; x] (x the pivot
// column; piv its reflector with alpha, row j's entry in column j) applied
// to column c (`rin`: row j's entry in it); the owner of column j + 1
// publishes it as the next pivot, with `rnext`, row j + 1's entry in it,
// into (x_next, piv_next)
template <typename T, int ROWS>
HD void step(const QrArgs& a, const Column<T>& col, T* B, int j, T rin,
             const T* x, const T* piv, T rnext, T* x_next, T* piv_next) {
  const int c = col.c;
  if (c > a.C) return;
  if (c <= j) {
    put(col, j, c == j ? piv[0] : T(0));
    return;
  }
  const T tau = piv[1], scale = piv[2];
  T d[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < ROWS; i += 4) {
    T v[4];
    load4(x + i, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) d[k] = fma_(v[k], B[i + k], d[k]);
  }
  const T w = tau * fma_(scale, (d[0] + d[1]) + (d[2] + d[3]), rin);
  const T f = -(w * scale);
#pragma unroll
  for (int i = 0; i < ROWS; i += 4) {
    T v[4];
    load4(x + i, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) B[i + k] = fma_(f, v[k], B[i + k]);
  }
  put(col, j, rin - w);
  if (c == j + 1 && j + 1 < a.C)
    publish_pivot<T, ROWS>(B, rnext, x_next, piv_next);
}

// the entry point's arguments: the inputs' lane-0 pointers (U, J_lm,
// new_idx, live_img, live_imu, live_bias, cs_c, order, keep or null, perm)
// and their lane strides
inline QrArgs qr_pack(const void* const* ptr, const long long* stride,
                      void* J_out, void* r_out, void* buf, void* counters,
                      int L, int MOBS, int MIMU, int NBM1, int C, int MLM,
                      int NPOS, int NCOLP, long long keep_i, double eps) {
  QrArgs a;
  a.U = ptr[0];
  a.J_lm = ptr[1];
  a.new_idx = static_cast<const int64_t*>(ptr[2]);
  a.live_img = static_cast<const uint8_t*>(ptr[3]);
  a.live_imu = static_cast<const uint8_t*>(ptr[4]);
  a.live_bias = static_cast<const uint8_t*>(ptr[5]);
  a.cs_c = ptr[6];
  a.order = static_cast<const int64_t*>(ptr[7]);
  a.keep = static_cast<const int64_t*>(ptr[8]);
  a.perm = static_cast<const int64_t*>(ptr[9]);
  long long* s[10] = {&a.sU, &a.sJlm, &a.snew, &a.slimg, &a.slimu,
                      &a.slbias, &a.scs, &a.sorder, &a.skeep, &a.sperm};
  for (int k = 0; k < 10; ++k) *s[k] = stride[k];
  a.J_out = J_out;
  a.r_out = r_out;
  a.buf = buf;
  a.counters = static_cast<unsigned int*>(counters);
  a.L = L;
  a.MOBS = MOBS;
  a.MIMU = MIMU;
  a.NBM1 = NBM1;
  a.C = C;
  a.MLM = MLM;
  a.NPOS = NPOS;
  a.NCOLP = NCOLP;
  a.keep_i = keep_i;
  a.eps = eps;
  return a;
}

// the instance a block of C window columns padded to NCOLP (one thread
// past them at least) takes: 0 the narrow, 1 the wide, -1 none
inline int qr_instance(int C, int NCOLP) {
  if (NCOLP % 32 != 0 || NCOLP < C + 2) return -1;
  if (NCOLP + COMM <= Geometry<float, false>::MAX_THREADS) return 0;
  if (NCOLP + COMM <= Geometry<float, true>::MAX_THREADS) return 1;
  return -1;
}

}  // namespace

#ifdef __CUDACC__

namespace {

__device__ __forceinline__ unsigned int ld_acquire_gpu(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release_gpu(unsigned int* p,
                                               unsigned int v) {
  asm volatile("st.release.gpu.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ int ld_acquire_cta(const volatile int* p) {
  int v;
  asm volatile("ld.acquire.cta.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release_cta(volatile int* p, int v) {
  asm volatile("st.release.cta.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void compute_barrier(int n) {
  asm volatile("bar.sync 1, %0;" :: "r"(n) : "memory");
}

// the compute threads: the batch, then a step a row of R. Each thread reads
// its column of the next input row from L2 (once block k - 1 has published
// it) while it works on the current one
template <typename T, int ROWS>
__device__ void compute_role(const QrArgs& a, const Smem<T>& m, QrShared& sh,
                             long long lane, int c) {
  T B[ROWS];
  load_batch<T, ROWS>(a, m, lane, c, B);
  const Column<T> col = column<T>(a, sh, lane, c);
  int known = col.in ? 0 : a.C;
  auto fetch = [&](int j) {
    while (known <= j && j < a.C) known = ld_acquire_cta(&sh.known);
    return input_at(col, a, j);
  };
  T rin = fetch(0);
  if (c == 0) publish_pivot<T, ROWS>(B, rin, m.xbuf, m.piv);
  compute_barrier(a.NCOLP);
  for (int j = 0; j < a.C; ++j) {
    const T rnext = fetch(j + 1);
    const int p = j & 1;
    step<T, ROWS>(a, col, B, j, rin, m.xbuf + p * ROWS, m.piv + 4 * p,
                  rnext, m.xbuf + (p ^ 1) * ROWS, m.piv + 4 * (p ^ 1));
    compute_barrier(a.NCOLP);
    // a thread past the columns (no loads, no stores of its own to wait
    // for) tells the publishing thread
    if (c == a.NCOLP - 1) st_release_cta(&sh.done, j + 1);
    rin = rnext;
  }
}

// the polling thread: block k - 1's progress into `known`
__device__ void poll_role(const QrArgs& a, QrShared& sh, long long lane) {
  const unsigned int* up = a.counters + lane * (a.NPOS + 1) + sh.ticket;
  int known = 0;
  while (known < a.C) {
    const int v = int(ld_acquire_gpu(up));
    if (v > known) {
      known = v;
      st_release_cta(&sh.known, v);
    } else {
      __nanosleep(32);
    }
  }
}

// the publishing thread: the compute threads' finished rows made visible
// to block k + 1, as often as a release store allows (none for the last
// block, whose rows are the prior)
__device__ void publish_role(const QrArgs& a, QrShared& sh, long long lane) {
  unsigned int* prog = a.counters + lane * (a.NPOS + 1) + 1 + sh.ticket;
  int published = 0;
  while (published < a.C) {
    const int d = ld_acquire_cta(&sh.done);
    if (d > published) {
      st_release_gpu(prog, unsigned(d));
      published = d;
    } else {
      __nanosleep(32);
    }
  }
}

template <typename T, bool WIDE>
__global__ void __launch_bounds__(Geometry<T, WIDE>::MAX_THREADS)
    qr_prior_kernel(const QrArgs a) {
  constexpr int ROWS = Geometry<T, WIDE>::ROWS;
  extern __shared__ __align__(16) unsigned char qr_smem[];
  __shared__ QrShared sh;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const long long lane = blockIdx.y;
  Smem<T> m;
  smem_layout<T, ROWS>(qr_smem, a, &m);
  if (tid == 0) {
    sh.ticket = int(atomicAdd(a.counters + lane * (a.NPOS + 1), 1u));
    sh.known = 0;
    sh.done = 0;
  }
  phase_zero(a, m, tid, nthr);
  __syncthreads();
  phase_count(a, m, lane, tid, nthr);
  __syncthreads();
  phase_starts(a, m, tid, nthr);
  __syncthreads();
  if (tid == 0) phase_plan<T, ROWS>(a, m, sh);
  __syncthreads();
  if (sh.ticket >= sh.n_pos) return;
  phase_obs(a, m, sh, lane, tid);
  __syncthreads();
  phase_landmark_list(m, sh, tid);
  __syncthreads();
  phase_rows<T, ROWS>(a, m, sh, tid);
  __syncthreads();
  phase_lm_obs(a, m, sh, lane, tid, nthr);
  __syncthreads();
  phase_lm_scalars(a, m, sh, tid);
  __syncthreads();
  if (tid < a.NCOLP) phase_landmarks(a, m, sh, lane, tid);
  __syncthreads();
  phase_row_l<T, ROWS>(a, m, lane, tid);
  __syncthreads();
  if (tid < a.NCOLP)
    compute_role<T, ROWS>(a, m, sh, lane, tid);
  else if (tid == a.NCOLP && sh.ticket > 0)
    poll_role(a, sh, lane);
  else if (tid == a.NCOLP + 32 && sh.ticket < sh.n_pos - 1)
    publish_role(a, sh, lane);
}

template <typename T, bool WIDE>
int launch(const QrArgs& a, void* stream) {
  const size_t bytes =
      smem_layout<T, Geometry<T, WIDE>::ROWS>(nullptr, a, nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      qr_prior_kernel<T, WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  dim3 grid(a.NPOS, a.L);
  qr_prior_kernel<T, WIDE><<<grid, a.NCOLP + COMM, bytes,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

template <typename T, bool WIDE>
int attributes(long long* out) {
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncGetAttributes(&at, qr_prior_kernel<T, WIDE>);
  if (err != cudaSuccess) return int(err);
  out[0] = at.numRegs;
  out[1] = (long long)at.localSizeBytes;
  out[2] = (long long)at.sharedSizeBytes;
  out[3] = at.maxThreadsPerBlock;
  return 0;
}

}  // namespace

extern "C" {

// K6 over L lanes: `ptr` the inputs' lane-0 pointers (U, J_lm, new_idx,
// live_img, live_imu, live_bias, cs_c, order, keep or null, perm) with
// their lane strides `stride`; J_out (L, C, C), r_out (L, C); `buf`
// L x NPOS x C x NCOLP values of scratch; `counters` L x (1 + NPOS), zero
// at the launch. dtype 0 float32, 1 float64. Returns the launch's
// cudaError (0 on success); -1 for a code or shape it does not take.
int qr_prior_r(int dtype, const void* const* ptr, const long long* stride,
               void* J_out, void* r_out, void* buf, void* counters, int L,
               int MOBS, int MIMU, int NBM1, int C, int MLM, int NPOS,
               int NCOLP, long long keep_i, double eps, void* stream) {
  if (L < 1) return 0;
  const int wide = qr_instance(C, NCOLP);
  if (wide < 0 || dtype < 0 || dtype > 1) return -1;
  const QrArgs a = qr_pack(ptr, stride, J_out, r_out, buf, counters, L, MOBS,
                           MIMU, NBM1, C, MLM, NPOS, NCOLP, keep_i, eps);
  if (dtype == 0)
    return wide ? launch<float, true>(a, stream)
                : launch<float, false>(a, stream);
  return wide ? launch<double, true>(a, stream)
              : launch<double, false>(a, stream);
}

// each instance's resources, 4 values a row (f32 narrow, f32 wide, f64
// narrow, f64 wide): registers a thread, local (spill) bytes a thread,
// static shared bytes a block, the most threads a block it can launch with
int qr_prior_attributes(long long* out) {
  int err = attributes<float, false>(out);
  if (err == 0) err = attributes<float, true>(out + 4);
  if (err == 0) err = attributes<double, false>(out + 8);
  if (err == 0) err = attributes<double, true>(out + 12);
  return err;
}

}  // extern "C"

#endif  // __CUDACC__

extern "C" {

// the rows a block of `dtype`'s instance holds for C window columns padded
// to NCOLP, -1 where no instance takes them
int qr_prior_rows(int dtype, int C, int NCOLP) {
  const int wide = qr_instance(C, NCOLP);
  if (wide < 0) return -1;
  if (dtype == 0)
    return wide ? Geometry<float, true>::ROWS : Geometry<float, false>::ROWS;
  return wide ? Geometry<double, true>::ROWS : Geometry<double, false>::ROWS;
}

}  // extern "C"
