// K2 and K3: the window solve's factor linearization, and K5: the streamed
// frame's residual summary, for Hopper.
//
// K2 (`image_factor_rows`) evaluates every rolling-shutter image factor of
// a window in one launch: the row-shifted segments, the 4-knot gathers at
// both observation times, the clamped inverse depth, the spline values and
// per-knot right-tangent Jacobians, the residual with its closed-form
// Jacobian blocks (line delay included), the Cauchy weight and cost, and
// the factor's two dense robust-weighted rows over the camera system.
// K3 (`imu_factor_rows`) does the same for every IMU factor: the 6-dim
// residual, its blocks with respect to the 4 rotation knots, the 4
// position knots and the two biases, and the factor's six masked rows.
//
// Neither replaces a Pallas kernel. They port what XLA compiles from the
// JAX package's vmapped factor evaluations,
// `ctrlvio_tpu/solver/assemble.py::_image_blocks` (:49, the closed forms of
// `ops/reproj_analytic.py`) and `_imu_blocks` (:84, `jax.jacfwd` of
// `ops/factors.py::imu_residual_tangent`), with the one-hot expansion into
// dense rows (`_image_rows`, `_imu_rows`). Their semantics are those of
// the plain PyTorch versions beside the wrappers
// (`ctrlvio_tpu_torch/ops/factor_kernels.py::image_factor_rows_plain`,
// `imu_factor_rows_plain`), operation by operation where that is cheap:
// the same small-angle branches and thresholds as `ops/so3.py` (eps 1e-6
// in f32, 1e-10 in f64; 1e-6 on theta^2 for the inverse Jacobians), the
// same order of sums, no fused multiply-add (`--fmad=false`).
//   - K2 writes rows[q, r, :] = [(rot_i + rot_j) w, (pos_i + pos_j) w,
//     0 (biases), J_ld w], the knot blocks of i and j summed where they
//     overlap (i first); rw = r w, jl = J_dinv w, cost = rho(|r|^2) m with
//     w = m / sqrt(1 + |r|^2 / c^2), rho(s) = c^2 log1p(s / c^2), m the
//     active mask;
//   - K3 writes rows[m, a, :] = [rot, pos, bg, ba, 0] m, r m and
//     sum_a (r_a m)^2. Its rotation blocks are forward-mode derivatives:
//     the residual in dual numbers, once for each of the 12 knot tangent
//     directions, through the same operations as jacfwd (the perturbed
//     knot q exp(phi) normalized, its `where` branches taken on values).
//     Its position blocks are linear, info_a * (R^T lam''_k e_d)_a, and its
//     bias blocks info_a on their own rows.
// Non-finite blocks stay in their own columns here, where the plain
// version's one-hot products spread them over the row.
//
// K5 (`residual_summary`, below K2 and K3) is the streamed frame's whole
// residual summary in one launch: the port's counterpart of XLA's one
// fusion of the JAX package's `residual_rms` (`ctrlvio_tpu/solver/
// assemble.py:419`, once a streamed frame) and `total_cost` (:481). It
// evaluates every image, IMU and bias factor's raw residual (sqrt-info
// applied, no robust weight) through the plain route's operations
// (`factors.reproj_residual`, `factors.imu_residual`: the spline's value
// by quaternion products, the point moved by quaternion rotations; not
// K2's closed forms), the prior's r0 + J (x [-] x0) and J's nonzero rows,
// masks and reduces them, and writes the five numbers the summary reads:
// [rms_img, rms_imu, rms_bias, rms_prior, cost]. See its section below.
//
// What bounds them on an H100 at the e2e window (Q = 768 image and M = 256
// IMU slots, C = 6 KW + 6 NB + 1 = 259, f32): each writes 1.59 MB of rows
// (768 x 2 x 259 and 256 x 6 x 259 values), ~0.47 us at 3.35 TB/s; the
// arithmetic, a few thousand operations a slot (K3's 12 dual passes ~25k),
// is under 0.1 us at 67 TFLOP/s. Neither is reachable at this size: a
// launch is a few microseconds, and a slot's chain of transcendentals and
// 3x3 products is thousands of dependent instructions.
//
// Design: a kernel is a sequence of phases that a block's threads run
// between barriers, exchanging values only through the block's shared
// struct (no shuffles, no votes; every barrier in block-uniform flow).
//   - K3: IMU_GROUP = 16 threads a slot, IMU_SLOTS = 8 slots a block of
//     128. Phase 1: thread p < 12 of a slot runs dual pass p (the residual
//     along rotation tangent direction p) and the position column p, and
//     writes its columns; thread 0 also the residual, mask, segment and
//     bias index (every pass computes the same values: no value reads a
//     tangent). Phase 2: the block writes its residuals, costs and rows.
//   - K2: IMAGE_GROUP = 4 threads a slot, IMAGE_SLOTS = 16 slots a block
//     of 64. Phase 1: thread o < 2 of a slot evaluates observation time o
//     (segment, spline rotation and per-knot Jacobians, position,
//     velocity, angular velocity). Phase 2: thread r < 2 computes the
//     residual, its weight and cost, and row r's Jacobian blocks. Phase 3:
//     the block writes its rows.
//   - Rows: outputs are contiguous (L, n, rows, C), so a block's rows are
//     one span. ROW_LANES = 32 consecutive threads write consecutive
//     columns of a row, the block's groups of 32 taking its rows in turn;
//     a knot column reads its block from shared memory at index c - 3 s.
//     Every entry is written, zeros included: no memset, no atomics, so
//     every run and every graph replay gives the same bits, and a batch
//     equals its lanes launched one by one.
//   - The split changes no operation: each value comes from the
//     operations, in the order, that one thread running the whole slot
//     would use, so the outputs do not depend on the geometry.
// What holds them now is one thread's chain: a dual pass (K3) or an
// observation time (K2). At the e2e window K3's 256 slots are 32 blocks
// and K2's 768 are 48, one warp a scheduler, so the chain's latency is
// most of a launch's time; more blocks a launch (vmapped lanes) share the
// SMs' issue slots.
//
// Each input comes with a lane stride (0 for a constant every lane
// shares), so B windows under torch.func.vmap are one launch over B x n
// slots without copying the shared inputs. The math and the phases are
// host-and-device functions: only the launch code needs nvcc, and a host
// build can run the phases block by block (tests/torch_factors_host.cpp).

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#include <cmath>
#define HD inline
#endif
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// scalars: T (float or double) and forward-mode duals over T
// ---------------------------------------------------------------------------

HD float fsqrt(float x) { return sqrtf(x); }
HD double fsqrt(double x) { return sqrt(x); }
HD float fsin(float x) { return sinf(x); }
HD double fsin(double x) { return sin(x); }
HD float fcos(float x) { return cosf(x); }
HD double fcos(double x) { return cos(x); }
HD float fatan2(float y, float x) { return atan2f(y, x); }
HD double fatan2(double y, double x) { return atan2(y, x); }
HD float flog1p(float x) { return log1pf(x); }
HD double flog1p(double x) { return log1p(x); }
HD float ffloor(float x) { return floorf(x); }
HD double ffloor(double x) { return floor(x); }

template <typename T>
struct Eps;  // ops/so3.py::_EPS
template <>
struct Eps<float> {
  static constexpr double v = 1e-6;
};
template <>
struct Eps<double> {
  static constexpr double v = 1e-10;
};

template <typename T>
struct Dual {
  T v, d;
  HD Dual() : v(0), d(0) {}
  HD Dual(T v_) : v(v_), d(0) {}
  HD Dual(T v_, T d_) : v(v_), d(d_) {}
};

template <typename T>
HD Dual<T> operator+(Dual<T> a, Dual<T> b) { return {a.v + b.v, a.d + b.d}; }
template <typename T>
HD Dual<T> operator-(Dual<T> a, Dual<T> b) { return {a.v - b.v, a.d - b.d}; }
template <typename T>
HD Dual<T> operator-(Dual<T> a) { return {-a.v, -a.d}; }
template <typename T>
HD Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <typename T>
HD Dual<T> operator*(T a, Dual<T> b) { return {a * b.v, a * b.d}; }
template <typename T>
HD Dual<T> operator*(Dual<T> a, T b) { return {a.v * b, a.d * b}; }
template <typename T>
HD Dual<T> operator/(Dual<T> a, Dual<T> b) {
  T q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
template <typename T>
HD Dual<T> operator/(T a, Dual<T> b) { return Dual<T>(a) / b; }
template <typename T>
HD Dual<T> operator/(Dual<T> a, T b) { return {a.v / b, a.d / b}; }
template <typename T>
HD Dual<T> operator-(T a, Dual<T> b) { return {a - b.v, -b.d}; }
template <typename T>
HD Dual<T> operator-(Dual<T> a, T b) { return {a.v - b, a.d}; }

template <typename T>
HD Dual<T> fsqrt(Dual<T> a) {
  T s = fsqrt(a.v);
  return {s, a.d / (T(2) * s)};
}
template <typename T>
HD Dual<T> fsin(Dual<T> a) { return {fsin(a.v), fcos(a.v) * a.d}; }
template <typename T>
HD Dual<T> fcos(Dual<T> a) { return {fcos(a.v), -fsin(a.v) * a.d}; }
template <typename T>
HD Dual<T> fatan2(Dual<T> y, Dual<T> x) {
  T den = x.v * x.v + y.v * y.v;
  return {fatan2(y.v, x.v), (x.v * y.d - y.v * x.d) / den};
}

template <typename T>
HD T val(T x) { return x; }
template <typename T>
HD T val(Dual<T> x) { return x.v; }

// ---------------------------------------------------------------------------
// SO(3) on wxyz quaternions (ops/so3.py), S = T or Dual<T>
// ---------------------------------------------------------------------------

template <typename S>
HD void quat_mul(const S a[4], const S b[4], S o[4]) {
  S w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  S x = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  S y = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  S z = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
  o[0] = w; o[1] = x; o[2] = y; o[3] = z;
}

template <typename S>
HD void quat_conj(const S q[4], S o[4]) {
  o[0] = q[0]; o[1] = -q[1]; o[2] = -q[2]; o[3] = -q[3];
}

template <typename S>
HD void quat_normalize(S q[4]) {
  S n = fsqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
}

template <typename T, typename S>
HD void quat_exp(const S phi[3], S o[4]) {
  S t2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  S k, w;
  if (val(t2) < T(Eps<T>::v * Eps<T>::v)) {
    k = T(0.5) - t2 / T(48.0);
    w = T(1.0) - t2 / T(8.0);
  } else {
    S th = fsqrt(t2);
    S half = T(0.5) * th;
    k = fsin(half) / th;
    w = fcos(half);
  }
  o[0] = w; o[1] = k * phi[0]; o[2] = k * phi[1]; o[3] = k * phi[2];
}

template <typename T, typename S>
HD void quat_log(const S q[4], S o[3]) {
  T sign = val(q[0]) < T(0) ? T(-1) : T(1);
  S w = q[0] * sign;
  S v[3] = {q[1] * sign, q[2] * sign, q[3] * sign};
  S v2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  S k;
  if (val(v2) < T(Eps<T>::v * Eps<T>::v)) {
    S ws = val(w) >= T(1e-3) ? w : S(T(1e-3));
    k = T(2.0) / ws * (T(1.0) - v2 / (T(3.0) * ws * ws));
  } else {
    S vn = fsqrt(v2);
    k = T(2.0) * fatan2(vn, w) / vn;
  }
  for (int i = 0; i < 3; ++i) o[i] = k * v[i];
}

template <typename S>
HD void cross(const S a[3], const S b[3], S o[3]) {
  S x = a[1] * b[2] - a[2] * b[1];
  S y = a[2] * b[0] - a[0] * b[2];
  S z = a[0] * b[1] - a[1] * b[0];
  o[0] = x; o[1] = y; o[2] = z;
}

// v + w t + qv x t, t = 2 qv x v (so3.quat_rotate)
template <typename T, typename S, typename V>
HD void quat_rotate(const S q[4], const V v[3], S o[3]) {
  S qv[3] = {q[1], q[2], q[3]};
  S vs[3] = {S(v[0]), S(v[1]), S(v[2])};
  S c[3], t[3], c2[3];
  cross(qv, vs, c);
  for (int i = 0; i < 3; ++i) t[i] = T(2.0) * c[i];
  cross(qv, t, c2);
  for (int i = 0; i < 3; ++i) o[i] = vs[i] + q[0] * t[i] + c2[i];
}

template <typename T, typename S, typename V>
HD void quat_rotate_inv(const S q[4], const V v[3], S o[3]) {
  S qc[4];
  quat_conj(q, qc);
  quat_rotate<T>(qc, v, o);
}

template <typename T>
HD void quat_to_matrix(const T q[4], T R[3][3]) {
  T w = q[0], x = q[1], y = q[2], z = q[3];
  T xx = x * x, yy = y * y, zz = z * z;
  T wx = w * x, wy = w * y, wz = w * z;
  T xy = x * y, xz = x * z, yz = y * z;
  R[0][0] = T(1) - T(2) * (yy + zz);
  R[0][1] = T(2) * (xy - wz);
  R[0][2] = T(2) * (xz + wy);
  R[1][0] = T(2) * (xy + wz);
  R[1][1] = T(1) - T(2) * (xx + zz);
  R[1][2] = T(2) * (yz - wx);
  R[2][0] = T(2) * (xz - wy);
  R[2][1] = T(2) * (yz + wx);
  R[2][2] = T(1) - T(2) * (xx + yy);
}

template <typename T>
HD void hat(const T v[3], T H[3][3]) {
  H[0][0] = T(0); H[0][1] = -v[2]; H[0][2] = v[1];
  H[1][0] = v[2]; H[1][1] = T(0); H[1][2] = -v[0];
  H[2][0] = -v[1]; H[2][1] = v[0]; H[2][2] = T(0);
}

template <typename T>
HD void matmul3(const T A[3][3], const T B[3][3], T C[3][3]) {
  T out[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out[i][j] = A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) C[i][j] = out[i][j];
}

template <typename T>
HD void transpose3(const T A[3][3], T B[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) B[i][j] = A[j][i];
}

template <typename T>
HD void matvec3(const T A[3][3], const T v[3], T o[3]) {
  T out[3];
  for (int i = 0; i < 3; ++i)
    out[i] = A[i][0] * v[0] + A[i][1] * v[1] + A[i][2] * v[2];
  for (int i = 0; i < 3; ++i) o[i] = out[i];
}

// J_r(phi) = I - A hat + B hat^2 (so3._jac_coeffs, so3.right_jacobian)
template <typename T>
HD void right_jacobian(const T phi[3], T J[3][3]) {
  T t2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  T A, B;
  if (t2 < T(Eps<T>::v * Eps<T>::v)) {
    A = T(0.5) - t2 / T(24.0);
    B = T(1.0 / 6.0) - t2 / T(120.0);
  } else {
    T t = fsqrt(t2);
    A = (T(1.0) - fcos(t)) / t2;
    B = (t - fsin(t)) / (t2 * t);
  }
  T P[3][3], PP[3][3];
  hat(phi, P);
  matmul3(P, P, PP);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      J[i][j] = (T(i == j) - A * P[i][j]) + B * PP[i][j];
}

// J_l^-1 (sign -1) and J_r^-1 (sign +1): I + sign/2 hat + C hat^2
// (so3._inv_jac_coeff)
template <typename T>
HD void jacobian_inv(const T phi[3], T sign, T J[3][3]) {
  T t2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  T C;
  if (t2 < T(1e-6)) {
    C = T(1.0 / 12.0) + t2 / T(720.0);
  } else {
    T t = fsqrt(t2);
    C = T(1.0) / t2 - (T(1.0) + fcos(t)) / (T(2.0) * t * fsin(t));
  }
  T P[3][3], PP[3][3];
  hat(phi, P);
  matmul3(P, P, PP);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      J[i][j] = (T(i == j) + (sign * T(0.5)) * P[i][j]) + C * PP[i][j];
}

// ---------------------------------------------------------------------------
// the cubic B-spline over 4 local knots (ops/spline.py)
// ---------------------------------------------------------------------------

// p . (m0, m1, m2, m3) / 6: one row of a blending matrix, whose entries
// are sixths (spline._blending_matrix)
template <typename T>
HD T row6(const T p[4], double m0, double m1, double m2, double m3) {
  return p[0] * T(m0 / 6.0) + p[1] * T(m1 / 6.0) + p[2] * T(m2 / 6.0) +
         p[3] * T(m3 / 6.0);
}

// lam_k = sum_j d^deriv/du^deriv(u^j) M[k][j] (spline.blend_coeffs, without
// the 1/dt^deriv)
template <typename T>
HD void blend(T u, int deriv, bool cumulative, T lam[4]) {
  T p[4];
  // spline._u_powers
  if (deriv == 0) {
    p[0] = T(1); p[1] = u; p[2] = u * u; p[3] = u * u * u;
  } else if (deriv == 1) {
    p[0] = T(0); p[1] = T(1); p[2] = T(2) * u; p[3] = T(3) * (u * u);
  } else {
    p[0] = T(0); p[1] = T(0); p[2] = T(2); p[3] = T(6) * u;
  }
  if (cumulative) {
    lam[0] = row6(p, 6, 0, 0, 0);
    lam[1] = row6(p, 5, 3, -3, 1);
    lam[2] = row6(p, 1, 3, 3, -2);
    lam[3] = row6(p, 0, 0, 0, 1);
  } else {
    lam[0] = row6(p, 1, -3, 3, -1);
    lam[1] = row6(p, 4, 0, -6, 3);
    lam[2] = row6(p, 1, 3, 3, -3);
    lam[3] = row6(p, 0, 0, 0, 1);
  }
}

// sum_k lam_k p4[k] (spline.rd_eval, the blending already scaled)
template <typename T>
HD void rd_eval(const T p4[4][3], const T lam[4], T o[3]) {
  for (int d = 0; d < 3; ++d)
    o[d] = lam[0] * p4[0][d] + lam[1] * p4[1][d] + lam[2] * p4[2][d] +
           lam[3] * p4[3][d];
}

// d_i = log(q_i^-1 q_{i+1}) (spline.so3_deltas)
template <typename T, typename S>
HD void so3_deltas(const S q4[4][4], S d[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    S c[4], m[4];
    quat_conj(q4[i], c);
    quat_mul(c, q4[i + 1], m);
    quat_log<T>(m, d[i]);
  }
}

// q0 prod exp(lam_{i+1} d_i), normalized (spline.so3_eval)
template <typename T, typename S>
HD void so3_eval(const S q4[4][4], const T lam[4], const S d[3][3], S q[4]) {
  for (int c = 0; c < 4; ++c) q[c] = q4[0][c];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    S kd[3] = {lam[i + 1] * d[i][0], lam[i + 1] * d[i][1],
               lam[i + 1] * d[i][2]};
    S e[4], m[4];
    quat_exp<T>(kd, e);
    quat_mul(q, e, m);
    for (int c = 0; c < 4; ++c) q[c] = m[c];
  }
  quat_normalize(q);
}

// body angular velocity (spline.so3_vel_body); dlam scaled by 1/dt
template <typename T, typename S>
HD void so3_vel_body(const T lam[4], const T dlam[4], const S d[3][3],
                     S w[3]) {
  for (int c = 0; c < 3; ++c) w[c] = S(T(0));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    S nkd[3] = {-(lam[i + 1] * d[i][0]), -(lam[i + 1] * d[i][1]),
                -(lam[i + 1] * d[i][2])};
    S e[4], rw[3];
    quat_exp<T>(nkd, e);
    quat_rotate<T>(e, w, rw);
    for (int c = 0; c < 3; ++c) w[c] = rw[c] + dlam[i + 1] * d[i][c];
  }
}

// the spline's rotation and its per-knot right-tangent Jacobians
// (ops/reproj_analytic.py::so3_value_knot_jac), from lam and the deltas
template <typename T>
HD void so3_value_knot_jac(const T q4[4][4], const T lam[4], const T d[3][3],
                           T q[4], T Jk[4][3][3]) {
  T A[3][4], phi[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    for (int c = 0; c < 3; ++c) phi[i][c] = lam[i + 1] * d[i][c];
    quat_exp<T>(phi[i], A[i]);
  }
  T P[4][3][3], Ra[3][3];
  quat_to_matrix(A[2], P[2]);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) P[3][i][j] = T(i == j);
  quat_to_matrix(A[1], Ra);
  matmul3(Ra, P[2], P[1]);
  quat_to_matrix(A[0], Ra);
  matmul3(Ra, P[1], P[0]);

  for (int c = 0; c < 4; ++c) q[c] = q4[0][c];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T m[4];
    quat_mul(q, A[i], m);
    for (int c = 0; c < 4; ++c) q[c] = m[c];
  }
  quat_normalize(q);

  // X_i^r = ((lam_{i+1} P_{i+1}^T) Jr(lam_{i+1} d_i)) Jr^-1(d_i), X_i^l the
  // same with Jl^-1(d_i): knot k gets X_{k-1}^r (k >= 1) - X_k^l (k <= 2)
  T Xr[3][3][3], Xl[3][3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T Pt[3][3], LP[3][3], Jr[3][3], Jinv[3][3], M[3][3];
    transpose3(P[i + 1], Pt);
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) LP[a][b] = lam[i + 1] * Pt[a][b];
    right_jacobian(phi[i], Jr);
    matmul3(LP, Jr, M);
    jacobian_inv(d[i], T(1), Jinv);
    matmul3(M, Jinv, Xr[i]);
    jacobian_inv(d[i], T(-1), Jinv);
    matmul3(M, Jinv, Xl[i]);
  }
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      Jk[0][a][b] = P[0][b][a] - Xl[0][a][b];
      Jk[1][a][b] = Xr[0][a][b] - Xl[1][a][b];
      Jk[2][a][b] = Xr[1][a][b] - Xl[2][a][b];
      Jk[3][a][b] = Xr[2][a][b];
    }
}

// ---------------------------------------------------------------------------
// arguments
// ---------------------------------------------------------------------------

// image inputs, in the wrappers' order; each (L, ...) with a lane stride
enum {
  I_KQ, I_KP, I_DINV, I_LD, I_I0I, I_FI, I_ROWI, I_PTI, I_I0J, I_FJ,
  I_ROWJ, I_PTJ, I_LMIDX, I_ACTIVE, I_QC, I_PC, I_SQRTINFO, N_IMAGE_IN
};
// IMU inputs
enum {
  M_KQ, M_KP, M_BG, M_BA, M_I0, M_U, M_GYRO, M_ACCEL, M_BIDX, M_ACTIVE,
  M_GRAVITY, M_INFO, N_IMU_IN
};

template <int N_IN, int N_OUT>
struct Args {
  const void* in[N_IN];
  long long stride[N_IN];  // elements between lanes; 0: shared
  void* out[N_OUT];        // contiguous (L, n, ...)
  int L, n, KW, NB, LM;
  double dt, cauchy_c;
};

using ImageArgs = Args<N_IMAGE_IN, 4>;
using ImuArgs = Args<N_IMU_IN, 3>;

template <typename X, typename A>
HD const X* at(const A& a, int i, long long lane) {
  return static_cast<const X*>(a.in[i]) + lane * a.stride[i];
}

template <typename I>
HD int clampi(I x, int lo, int hi) {
  return x < I(lo) ? lo : (x > I(hi) ? hi : int(x));
}

template <typename T>
HD void gather4(const T* knots_q, const T* knots_p, int s, T q4[4][4],
                T p4[4][3]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    for (int c = 0; c < 4; ++c) q4[k][c] = knots_q[(s + k) * 4 + c];
    for (int c = 0; c < 3; ++c) p4[k][c] = knots_p[(s + k) * 3 + c];
  }
}

// the launch geometry, shared by the kernels and by a host run of their
// phases. K3: IMU_GROUP threads a slot, of which 12 run one dual pass each;
// K2: IMAGE_GROUP threads a slot, of which 2 run one observation time each
// and then one row each. Every thread of a block writes rows.
constexpr int IMU_GROUP = 16;
constexpr int IMU_SLOTS = 8;
constexpr int IMAGE_GROUP = 4;
constexpr int IMAGE_SLOTS = 16;

// the slots a block holds (the last block's may be fewer)
HD int block_slots(long long block, int per_block, long long total) {
  long long left = total - block * per_block;
  return left < per_block ? int(left) : per_block;
}

// consecutive threads write consecutive columns of a row: a block's rows
// are one span, ROW_LANES threads a row, the block's groups of ROW_LANES
// taking its rows in turn
constexpr int ROW_LANES = 32;
static_assert((IMU_GROUP * IMU_SLOTS) % ROW_LANES == 0 &&
                  (IMAGE_GROUP * IMAGE_SLOTS) % ROW_LANES == 0,
              "a block is whole groups of ROW_LANES threads");

// ---------------------------------------------------------------------------
// K2: the image factors, two of a slot's threads in the first two phases
// ---------------------------------------------------------------------------

// one observation time of a slot: the segment, the spline's rotation and
// per-knot Jacobians, position, velocity, body angular velocity and the
// position blending
template <typename T>
struct ImageObs {
  T qv[4], Jk[4][3][3], pos[3], vel[3], w[3], lam_p[4];
  int s;
};

template <typename T>
struct ImageBlock {
  ImageObs<T> obs[IMAGE_SLOTS][2];
  // each row's knot blocks: rot at i, rot at j, pos at i, pos at j, each
  // 12 columns (3 k + e)
  T J[IMAGE_SLOTS][2][48];
  T Jl[IMAGE_SLOTS][2];
  T wt[IMAGE_SLOTS];
};

// phase 1, thread o < 2 of a slot: observation time o
template <typename T, typename I>
HD void image_observation(const ImageArgs& a, ImageBlock<T>& sh,
                          long long block, int t) {
  const int j = t / IMAGE_GROUP, o = t % IMAGE_GROUP;
  const long long g = block * IMAGE_SLOTS + j;
  if (o >= 2 || g >= (long long)a.L * a.n) return;
  const long long lane = g / a.n;
  const int q = int(g % a.n);
  const int KW = a.KW;
  const T inv_dt = T(1.0 / a.dt);
  const T ld = at<T>(a, I_LD, lane)[0];
  const T row = o ? at<T>(a, I_ROWJ, lane)[q] : at<T>(a, I_ROWI, lane)[q];
  const T f = o ? at<T>(a, I_FJ, lane)[q] : at<T>(a, I_FI, lane)[q];
  const I i0 = o ? at<I>(a, I_I0J, lane)[q] : at<I>(a, I_I0I, lane)[q];

  // the segment (assemble._segments), knots, spline values, Jacobians,
  // velocities
  T tot = f + row * ld * inv_dt;
  T shift = ffloor(tot);
  const int s = clampi(i0 + I(shift), 0, KW - 4);
  T u = tot - shift;
  T q4[4][4], p4[4][3], lam[4], dlam[4], d[3][3], lam1[4];
  T qv[4], Jk[4][3][3], lam_p[4], pos[3], vel[3], w[3];
  gather4(at<T>(a, I_KQ, lane), at<T>(a, I_KP, lane), s, q4, p4);
  blend(u, 0, true, lam);
  blend(u, 1, true, dlam);
  for (int k = 0; k < 4; ++k) dlam[k] = dlam[k] * inv_dt;
  so3_deltas<T>(q4, d);
  so3_value_knot_jac(q4, lam, d, qv, Jk);
  blend(u, 0, false, lam_p);
  rd_eval(p4, lam_p, pos);
  blend(u, 1, false, lam1);
  for (int k = 0; k < 4; ++k) lam1[k] = lam1[k] * inv_dt;
  rd_eval(p4, lam1, vel);
  so3_vel_body<T>(lam, dlam, d, w);

  ImageObs<T>& ob = sh.obs[j][o];
  ob.s = s;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    ob.qv[c] = qv[c];
    ob.lam_p[c] = lam_p[c];
  }
  for (int k = 0; k < 4; ++k)
    for (int b = 0; b < 3; ++b)
      for (int e = 0; e < 3; ++e) ob.Jk[k][b][e] = Jk[k][b][e];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ob.pos[c] = pos[c];
    ob.vel[c] = vel[c];
    ob.w[c] = w[c];
  }
}

// (Jv A) Jk of one residual row for each knot: the einsum "ab,bc,kcd->akd"
// at a, left to right
template <typename T>
HD void jv_a_jk(const T Jv[3], const T A[3][3], const T Jk[4][3][3],
                T out[12]) {
  T JA[3];
  for (int c = 0; c < 3; ++c)
    JA[c] = Jv[0] * A[0][c] + Jv[1] * A[1][c] + Jv[2] * A[2][c];
  for (int k = 0; k < 4; ++k)
    for (int e = 0; e < 3; ++e)
      out[3 * k + e] = JA[0] * Jk[k][0][e] + JA[1] * Jk[k][1][e] +
                       JA[2] * Jk[k][2][e];
}

// phase 2, thread r2 < 2 of a slot: the residual, its weight and cost
// (both threads), and row r2's Jacobians (reproj_analytic.reproj_analytic)
template <typename T, typename I>
HD void image_residual(const ImageArgs& a, ImageBlock<T>& sh,
                       long long block, int t) {
  const int j = t / IMAGE_GROUP, r2 = t % IMAGE_GROUP;
  const long long g = block * IMAGE_SLOTS + j;
  if (r2 >= 2 || g >= (long long)a.L * a.n) return;
  const long long lane = g / a.n;
  const int q = int(g % a.n);
  const T sqrt_info = at<T>(a, I_SQRTINFO, lane)[0];
  const T* qc = at<T>(a, I_QC, lane);
  const T* pc = at<T>(a, I_PC, lane);
  const T row[2] = {at<T>(a, I_ROWI, lane)[q], at<T>(a, I_ROWJ, lane)[q]};
  const T* pti = at<T>(a, I_PTI, lane) + 3 * q;
  const T* ptj = at<T>(a, I_PTJ, lane) + 3 * q;
  const int lm = clampi(at<I>(a, I_LMIDX, lane)[q], 0, a.LM - 1);
  const T m = at<unsigned char>(a, I_ACTIVE, lane)[q] ? T(1) : T(0);
  const ImageObs<T>* ob = sh.obs[j];

  T Rc[3][3], Rct[3][3], Ri[3][3], Rj[3][3], Rjt[3][3];
  quat_to_matrix(qc, Rc);
  transpose3(Rc, Rct);
  quat_to_matrix(ob[0].qv, Ri);
  quat_to_matrix(ob[1].qv, Rj);
  transpose3(Rj, Rjt);
  T dinv = at<T>(a, I_DINV, lane)[lm];
  if ((dinv < T(0) ? -dinv : dinv) < T(1e-5))
    dinv = dinv < T(0) ? T(-1e-5) : T(1e-5);
  T x_ci[3], p_Ii[3], p_G[3], y[3], Rjt_y[3], x_j[3], t3[3];
  for (int c = 0; c < 3; ++c) x_ci[c] = pti[c] / dinv;
  matvec3(Rc, x_ci, t3);
  for (int c = 0; c < 3; ++c) p_Ii[c] = t3[c] + pc[c];
  matvec3(Ri, p_Ii, t3);
  for (int c = 0; c < 3; ++c) p_G[c] = t3[c] + ob[0].pos[c];
  for (int c = 0; c < 3; ++c) y[c] = p_G[c] - ob[1].pos[c];
  matvec3(Rjt, y, Rjt_y);
  for (int c = 0; c < 3; ++c) t3[c] = Rjt_y[c] - pc[c];
  matvec3(Rct, t3, x_j);
  T z = x_j[2];
  T zs = z;
  if ((z < T(0) ? -z : z) < T(1e-6)) {
    T sg = z > T(0) ? T(1) : (z < T(0) ? T(-1) : T(0));
    zs = sg * T(1e-6) + (z == T(0) ? T(1) : T(0)) * T(1e-6);
  }
  T r[2];
  for (int c = 0; c < 2; ++c) r[c] = sqrt_info * (x_j[c] / zs - ptj[c]);
  T Jv[3];
  {
    T iz = T(1.0) / zs, z2 = zs * zs;
    Jv[0] = sqrt_info * (r2 == 0 ? iz : T(0));
    Jv[1] = sqrt_info * (r2 == 0 ? T(0) : iz);
    Jv[2] = sqrt_info * (-(r2 == 0 ? x_j[0] : x_j[1]) / z2);
  }
  T M[3][3], MRi[3][3], H[3][3], Ai[3][3], Aj[3][3];
  matmul3(Rct, Rjt, M);
  matmul3(M, Ri, MRi);
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) MRi[i][k] = -MRi[i][k];
  hat(p_Ii, H);
  matmul3(MRi, H, Ai);
  hat(Rjt_y, H);
  matmul3(Rct, H, Aj);
  // J_r = (Jv A) Jk, per knot; J_p: +-JvM lam_k
  T* J = sh.J[j][r2];
  jv_a_jk(Jv, Ai, ob[0].Jk, J);
  jv_a_jk(Jv, Aj, ob[1].Jk, J + 12);
  T JvM[3];
  for (int c = 0; c < 3; ++c)
    JvM[c] = Jv[0] * M[0][c] + Jv[1] * M[1][c] + Jv[2] * M[2][c];
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      J[24 + 3 * k + e] = JvM[e] * ob[0].lam_p[k];
      J[36 + 3 * k + e] = (-JvM[e]) * ob[1].lam_p[k];
    }
  // J_dinv = Jv (-(M Ri Rc) x_ci / dinv)
  T Jd;
  {
    T MRiRc[3][3], vd[3];
    matmul3(M, Ri, H);
    matmul3(H, Rc, MRiRc);
    for (int i = 0; i < 3; ++i)
      for (int k = 0; k < 3; ++k) MRiRc[i][k] = -MRiRc[i][k];
    matvec3(MRiRc, x_ci, vd);
    for (int c = 0; c < 3; ++c) vd[c] = vd[c] / dinv;
    Jd = Jv[0] * vd[0] + Jv[1] * vd[1] + Jv[2] * vd[2];
  }
  // J_ld = Jv (row_i dx/dt_i + row_j dx/dt_j)
  T Jl;
  {
    T dti[3], dtj[3], v1[3], v2[3], v3[3], sv[3];
    hat(ob[0].w, H);
    matvec3(H, p_Ii, v1);
    matvec3(Ri, v1, v2);
    for (int c = 0; c < 3; ++c) v2[c] = v2[c] + ob[0].vel[c];
    matvec3(M, v2, dti);
    hat(ob[1].w, H);
    matvec3(H, Rjt_y, v1);
    matvec3(Rct, v1, v2);
    matvec3(M, ob[1].vel, v3);
    for (int c = 0; c < 3; ++c) dtj[c] = -v2[c] - v3[c];
    for (int c = 0; c < 3; ++c) sv[c] = row[0] * dti[c] + row[1] * dtj[c];
    Jl = Jv[0] * sv[0] + Jv[1] * sv[1] + Jv[2] * sv[2];
  }

  // the Cauchy weight and cost (assemble._cauchy_weight_and_cost)
  const T b = T(a.cauchy_c * a.cauchy_c);
  const T x = (r[0] * r[0] + r[1] * r[1]) / b;
  const T wt = T(1.0) / fsqrt(T(1.0) + x) * m;
  static_cast<T*>(a.out[1])[2 * g + r2] = (r2 == 0 ? r[0] : r[1]) * wt;
  static_cast<T*>(a.out[2])[2 * g + r2] = Jd * wt;
  sh.Jl[j][r2] = Jl;
  if (r2 == 0) {
    static_cast<T*>(a.out[3])[g] = b * flog1p(x) * m;
    sh.wt[j] = wt;
  }
}

// phase 3, every thread: the block's dense rows (assemble._image_rows),
// rows[q, r, :] = [(rot_i + rot_j) w, (pos_i + pos_j) w, 0, J_ld w]
template <typename T>
HD void image_store(const ImageArgs& a, const ImageBlock<T>& sh,
                    long long block, int t) {
  const long long g0 = block * IMAGE_SLOTS;
  const int ns = block_slots(block, IMAGE_SLOTS, (long long)a.L * a.n);
  const int KW = a.KW, C = 6 * KW + 6 * a.NB + 1;
  T* rows = static_cast<T*>(a.out[0]) + g0 * 2 * C;
  const int groups = IMAGE_GROUP * IMAGE_SLOTS / ROW_LANES;
  for (int row = t / ROW_LANES; row < 2 * ns; row += groups) {
    const int j = row >> 1, r2 = row & 1;
    const T wt = sh.wt[j];
    const T* J = sh.J[j][r2];
    const int si = 3 * sh.obs[j][0].s, sj = 3 * sh.obs[j][1].s;
    const T last = sh.Jl[j][r2] * wt;
    T* out = rows + row * C;
    for (int c = t % ROW_LANES; c < C; c += ROW_LANES) {
      T v;
      if (c < 6 * KW) {
        // knot kn = c' / 3 of knot block k = kn - s: column 3 k + e
        const int pos = c >= 3 * KW ? 1 : 0;
        const int cc = c - 3 * KW * pos;
        const int ki = cc - si, kj = cc - sj;
        const T vi = (ki >= 0 && ki < 12) ? J[24 * pos + ki] : T(0);
        const T vj = (kj >= 0 && kj < 12) ? J[24 * pos + 12 + kj] : T(0);
        v = (vi + vj) * wt;
      } else {
        v = c < C - 1 ? T(0) : last;
      }
      out[c] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// K3: the IMU factors, IMU_GROUP threads a slot, one dual pass each
// ---------------------------------------------------------------------------

template <typename T>
struct ImuBlock {
  // each residual row's knot blocks: rot, then pos, 12 columns (3 k + e)
  T J[IMU_SLOTS][6][24];
  T r[IMU_SLOTS][6], info[IMU_SLOTS][6], m[IMU_SLOTS];
  int s[IMU_SLOTS], bi[IMU_SLOTS];
};

// phase 1, thread p < 12 of a slot: the residual under q_k exp(phi) in
// dual numbers along rotation tangent direction p = 3 k + e of the 12
// (factors.imu_residual_tangent at phi = 0, one column of jacfwd), and the
// position column p, info_a (R^T (lam''_k e_e))_a, R from this pass's
// values (every pass's values are the same: they never read a tangent)
template <typename T, typename I>
HD void imu_pass(const ImuArgs& a, ImuBlock<T>& sh, long long block, int t) {
  const int j = t / IMU_GROUP, p = t % IMU_GROUP;
  const long long g = block * IMU_SLOTS + j;
  if (p >= 12 || g >= (long long)a.L * a.n) return;
  const long long lane = g / a.n;
  const int q = int(g % a.n);
  const int KW = a.KW, NB = a.NB;
  const T inv_dt = T(1.0 / a.dt);
  const T inv_dt2 = T((1.0 / a.dt) * (1.0 / a.dt));
  const int s = clampi(at<I>(a, M_I0, lane)[q], 0, KW - 4);
  const int bi = clampi(at<I>(a, M_BIDX, lane)[q], 0, NB - 1);
  const T u = at<T>(a, M_U, lane)[q];
  const T* info = at<T>(a, M_INFO, lane);
  const T* grav = at<T>(a, M_GRAVITY, lane);
  const T* gyro = at<T>(a, M_GYRO, lane) + 3 * q;
  const T* accel = at<T>(a, M_ACCEL, lane) + 3 * q;
  const T* bg = at<T>(a, M_BG, lane) + 3 * bi;
  const T* ba = at<T>(a, M_BA, lane) + 3 * bi;
  T q4[4][4], p4[4][3];
  gather4(at<T>(a, M_KQ, lane), at<T>(a, M_KP, lane), s, q4, p4);

  T lam[4], dlam[4], lam2[4], ag[3], gm[3], am[3];
  blend(u, 0, true, lam);
  blend(u, 1, true, dlam);
  for (int k = 0; k < 4; ++k) dlam[k] = dlam[k] * inv_dt;
  blend(u, 2, false, lam2);
  for (int k = 0; k < 4; ++k) lam2[k] = lam2[k] * inv_dt2;
  rd_eval(p4, lam2, ag);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ag[c] = ag[c] + grav[c];
    gm[c] = gyro[c] - bg[c];
    am[c] = accel[c] - ba[c];
  }

  typedef Dual<T> D;
  D qd[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    D phi[3], e4[4], qk[4];
    for (int c = 0; c < 3; ++c) phi[c] = D(T(0), T(p == 3 * k + c));
    for (int c = 0; c < 4; ++c) qk[c] = D(q4[k][c]);
    quat_exp<T>(phi, e4);
    quat_mul(qk, e4, qd[k]);
    quat_normalize(qd[k]);
  }
  D d[3][3], w[3], qs[4], ab[3];
  so3_deltas<T>(qd, d);
  so3_vel_body<T>(lam, dlam, d, w);
  so3_eval<T>(qd, lam, d, qs);
  quat_rotate_inv<T>(qs, ag, ab);
  D res[6];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    res[c] = info[c] * (w[c] - gm[c]);
    res[3 + c] = info[3 + c] * (ab[c] - am[c]);
  }
  for (int i = 0; i < 6; ++i) sh.J[j][i][p] = res[i].d;

  const int k = p / 3, e = p % 3;
  const T qval[4] = {qs[0].v, qs[1].v, qs[2].v, qs[3].v};
  const T l2 = k == 0 ? lam2[0] : k == 1 ? lam2[1] : k == 2 ? lam2[2] : lam2[3];
  T v[3] = {T(0), T(0), T(0)}, o[3];
  for (int c = 0; c < 3; ++c)
    if (c == e) v[c] = l2;
  quat_rotate_inv<T>(qval, v, o);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    sh.J[j][c][12 + p] = info[c] * T(0);
    sh.J[j][3 + c][12 + p] = info[3 + c] * o[c];
  }
  if (p == 0) {
    for (int i = 0; i < 6; ++i) {
      sh.r[j][i] = res[i].v;
      sh.info[j][i] = info[i];
    }
    sh.m[j] = at<unsigned char>(a, M_ACTIVE, lane)[q] ? T(1) : T(0);
    sh.s[j] = s;
    sh.bi[j] = bi;
  }
}

// phase 2, every thread: the block's masked residuals, costs and dense rows
// (assemble._imu_rows), rows[m, a, :] = [rot, pos, bg, ba, 0] m
template <typename T>
HD void imu_store(const ImuArgs& a, const ImuBlock<T>& sh, long long block,
                  int t) {
  const long long g0 = block * IMU_SLOTS;
  const int ns = block_slots(block, IMU_SLOTS, (long long)a.L * a.n);
  const int KW = a.KW, NB = a.NB, C = 6 * KW + 6 * NB + 1;
  if (t < 6 * ns) {
    const int j = t / 6, i = t % 6;
    static_cast<T*>(a.out[1])[6 * g0 + t] = sh.r[j][i] * sh.m[j];
  }
  if (t < ns) {
    T cost = T(0);
    for (int i = 0; i < 6; ++i) {
      const T rm = sh.r[t][i] * sh.m[t];
      cost = cost + rm * rm;
    }
    static_cast<T*>(a.out[2])[g0 + t] = cost;
  }
  T* rows = static_cast<T*>(a.out[0]) + g0 * 6 * C;
  const int groups = IMU_GROUP * IMU_SLOTS / ROW_LANES;
  for (int row = t / ROW_LANES; row < 6 * ns; row += groups) {
    const int j = row / 6, i = row % 6;
    const T m = sh.m[j], info = sh.info[j][i];
    const T* J = sh.J[j][i];
    const int s3 = 3 * sh.s[j], bi = sh.bi[j];
    T* out = rows + row * C;
    for (int c = t % ROW_LANES; c < C; c += ROW_LANES) {
      T v;
      if (c < 6 * KW) {
        // knot kn = c' / 3 of knot block k = kn - s: column 3 k + e
        const int pos = c >= 3 * KW ? 1 : 0;
        const int k = c - 3 * KW * pos - s3;
        v = (k >= 0 && k < 12) ? J[12 * pos + k] : T(0);
      } else if (c < C - 1) {
        int cb = c - 6 * KW;
        const int acc = cb >= 3 * NB ? 1 : 0;
        cb -= 3 * NB * acc;
        const int b = cb / 3, e = cb % 3;
        v = (b == bi && i == 3 * acc + e) ? info : T(0);
      } else {
        v = T(0);
      }
      out[c] = v * m;
    }
  }
}

// each kernel as its phases: a block runs phase 0 on every thread, waits at
// a barrier, runs phase 1, and so on; threads share only the block struct
template <typename T, typename I>
struct ImageKernel {
  typedef ImageArgs Args;
  typedef ImageBlock<T> Shared;
  static constexpr int SLOTS = IMAGE_SLOTS, THREADS = IMAGE_GROUP * IMAGE_SLOTS,
                       PHASES = 3;
  static HD void phase(int ph, const Args& a, Shared& sh, long long block,
                       int t) {
    if (ph == 0) image_observation<T, I>(a, sh, block, t);
    else if (ph == 1) image_residual<T, I>(a, sh, block, t);
    else image_store<T>(a, sh, block, t);
  }
};

template <typename T, typename I>
struct ImuKernel {
  typedef ImuArgs Args;
  typedef ImuBlock<T> Shared;
  static constexpr int SLOTS = IMU_SLOTS, THREADS = IMU_GROUP * IMU_SLOTS,
                       PHASES = 2;
  static HD void phase(int ph, const Args& a, Shared& sh, long long block,
                       int t) {
    if (ph == 0) imu_pass<T, I>(a, sh, block, t);
    else imu_store<T>(a, sh, block, t);
  }
};

// ---------------------------------------------------------------------------
// K5: the streamed frame's residual summary, one launch a call
// ---------------------------------------------------------------------------
//
// What it computes, for each lane (window) of the launch, as
// `ops/factor_kernels.py::residual_summary_plain` (the solver's former
// `residual_rms` and `total_cost`) does with torch operations:
//   image: S_img = sum m |r|^2 (per entry), N_img = sum m, S_rho = sum m
//          rho(|r|^2), rho(s) = c^2 log1p(s / c^2);
//   IMU:   S_imu = sum m |r|^2, N_imu = sum m;
//   bias:  S_bias = sum m |r_b|^2 (per entry), N_bias = sum m;
//   prior: S_prior = sum r_p^2 with r_p = r0 + J (x [-] x0), N_prior = the
//          rows of J with a nonzero norm;
// and from them out = [sqrt(S_img / max(2 N_img, 1)), sqrt(S_imu / max(6
// N_imu, 1)), sqrt(S_bias / max(6 N_bias, 1)), sqrt(S_prior / max(N_prior,
// 1)), ((S_rho / 2 + S_imu / 2) + S_bias / 2) + S_prior / 2]. Every term is
// multiplied by its mask, as the plain version does (a masked NaN stays
// NaN); with every mask off the clamps give 0.
//
// What bounds it on an H100 at the e2e window (Q = 768, M = 256, C = 259,
// f32): it reads ~0.33 MB, mostly J's 268 KB, ~0.10 us at 3.35 TB/s, and
// does ~1.3 M operations, under 0.02 us at 67 TFLOP/s. Neither is reachable:
// an image slot's chain (two spline evaluations, a transfer through four
// rotations) is a few thousand dependent cycles, and the sums need one
// step across blocks. So the design cuts launches and round trips: one
// launch for the whole summary, whose only output is five numbers a
// lane.
//
// Design: grid y is the lane, grid x a lane's blocks, each with one role,
// SUM_THREADS threads, running phases between barriers that exchange
// values only through the block's shared struct (no shuffles, no votes):
//   - image blocks, SUM_IMAGE_SLOTS slots each, 2 threads a slot: phase 0
//     thread o evaluates observation time o (the segment, the spline's
//     rotation and position); phase 1 both threads move the point from
//     frame i to frame j, thread r2 takes residual entry r2's term, thread
//     0 the mask and the Cauchy cost;
//   - IMU blocks, SUM_IMU_SLOTS slots each, 2 threads a slot: phase 0
//     thread 0 the gyro residual (the body rate), thread 1 the
//     accelerometer's (the rotation, the acceleration); phase 1 thread 0
//     |r|^2 and the mask;
//   - one bias block: a thread an entry of the bias pairs' residuals;
//   - prior blocks, SUM_PRIOR_ROWS rows of J each: every prior block first
//     computes all of x [-] x0 into shared memory itself (a thread an
//     entry: the knots' quaternion logs of so3.boxminus, the linear
//     differences), then ROW_LANES consecutive threads walk a row's
//     consecutive columns (coalesced), each keeping its share of the row's
//     product with x [-] x0 and of its squared norm, one pass over J, a
//     thread's loads for PRIOR_ROWS_THREAD rows and PRIOR_COLS_WAVE
//     columns issued together; a tree over the shares gives each row's
//     sums.
// Then each block sums its threads' terms in a fixed tree (a phase a
// level), and thread 0 writes the block's N_SUMS partial sums to the
// call's scratch. The lane's last block to arrive (an arrival counter a
// lane, zeroed by the wrapper; that block resets it) stages the lane's
// partials in shared memory (its threads, one coalesced load each), adds
// them in block order (thread k sum k) and writes its five outputs. No
// atomic touches a sum, so every run, every graph replay, and a batch of
// lanes against its lanes launched one by one give the same bits. A
// slot's terms come from the plain route's operations in its order (an
// image slot's two observation times and an IMU slot's two residual
// halves on two threads, each as one thread would run it), so they do
// not depend on the geometry; the sums differ from torch's only in their
// order.

constexpr int SUM_THREADS = 128;
constexpr int SUM_IMAGE_SLOTS = SUM_THREADS / 2;
constexpr int SUM_IMU_SLOTS = SUM_THREADS / 2;
constexpr int SUM_PRIOR_ROWS = 16;
// a prior block's threads: PRIOR_GROUPS groups of ROW_LANES, a group's
// thread taking PRIOR_ROWS_THREAD rows at once and PRIOR_COLS_WAVE of
// each row's columns a step (its loads of a step in flight together)
constexpr int PRIOR_GROUPS = SUM_THREADS / ROW_LANES;
constexpr int PRIOR_ROWS_THREAD = SUM_PRIOR_ROWS / PRIOR_GROUPS;
constexpr int PRIOR_COLS_WAVE = 3;
static_assert(SUM_THREADS % ROW_LANES == 0 &&
                  SUM_PRIOR_ROWS % PRIOR_GROUPS == 0 &&
                  SUM_PRIOR_ROWS <= SUM_THREADS,
              "a prior block is whole groups of ROW_LANES threads, its rows "
              "whole rows a group, a row's sums on one thread");

// the lane's sums, in the scratch's order
enum {
  SUM_IMG_SQ, SUM_IMG_N, SUM_IMG_RHO, SUM_IMU_SQ, SUM_IMU_N, SUM_BIAS_SQ,
  SUM_BIAS_N, SUM_PRIOR_SQ, SUM_PRIOR_N, N_SUMS
};
constexpr int N_SUMMARY_OUT = 5;
// the partials the lane's last block stages in shared memory at a time
constexpr int SUM_FINISH_BLOCKS = 64;

// K5's inputs, in the wrapper's order: the image factors' as K2 takes them
// (I_* above, the mask their valid flags), the IMU factors' but the knots,
// the bias pairs', the prior's
enum {
  S_BG = N_IMAGE_IN, S_BA, S_I0, S_U, S_GYRO, S_ACCEL, S_BIDX, S_IMU_VALID,
  S_GRAVITY, S_INFO, S_BIAS_SI, S_BIAS_VALID, S_J, S_R0, S_KQ0, S_KP0, S_BG0,
  S_BA0, S_LD0, N_SUMMARY_IN
};

struct SummaryArgs {
  const void* in[N_SUMMARY_IN];
  long long stride[N_SUMMARY_IN];  // elements between lanes; 0: shared
  void* out;                       // (L, N_SUMMARY_OUT)
  void* partial;                   // (L, blocks, N_SUMS), the call's own
  unsigned int* arrive;            // (L,), zero at the launch
  int L, Q, M, KW, NB, LM;
  // a lane's blocks: image, then IMU, then one bias block, then prior
  int image_blocks, imu_blocks, prior_blocks, blocks;
  double dt, cauchy_c;
};

// a lane's blocks by role for Q image slots, M IMU slots and C columns
HD void summary_layout(SummaryArgs& a) {
  const int C = 6 * a.KW + 6 * a.NB + 1;
  a.image_blocks = (a.Q + SUM_IMAGE_SLOTS - 1) / SUM_IMAGE_SLOTS;
  a.imu_blocks = (a.M + SUM_IMU_SLOTS - 1) / SUM_IMU_SLOTS;
  a.prior_blocks = (C + SUM_PRIOR_ROWS - 1) / SUM_PRIOR_ROWS;
  a.blocks = a.image_blocks + a.imu_blocks + 1 + a.prior_blocks;
}

template <typename T>
struct SummaryBlock {
  struct Image {
    T q[SUM_IMAGE_SLOTS][2][4], p[SUM_IMAGE_SLOTS][2][3];
  };
  struct Imu {
    T r[SUM_IMU_SLOTS][6];
  };
  struct Prior {
    T dot[SUM_PRIOR_ROWS][ROW_LANES], sq[SUM_PRIOR_ROWS][ROW_LANES];
  };
  struct Finish {
    T part[SUM_FINISH_BLOCKS][N_SUMS], sum[N_SUMS];
  };
  union {
    Image img;
    Imu imu;
    Prior prior;
    Finish fin;
  } u;
  T red[N_SUMS][SUM_THREADS];  // each thread's terms, then the block tree
  int last;                    // whether this block is the lane's last
};

template <typename T>
HD void clear_terms(SummaryBlock<T>& sh, int t) {
  for (int k = 0; k < N_SUMS; ++k) sh.red[k][t] = T(0);
}

// image phase 0, thread (j, o): observation time o of slot j (the segment,
// spline.so3_eval, spline.rd_eval)
template <typename T, typename I>
HD void summary_image_observation(const SummaryArgs& a, SummaryBlock<T>& sh,
                                  long long lane, int blk, int t) {
  const int j = t / 2, o = t % 2;
  const int q = blk * SUM_IMAGE_SLOTS + j;
  if (q >= a.Q) return;
  const T inv_dt = T(1.0 / a.dt);
  const T ld = at<T>(a, I_LD, lane)[0];
  const T row = o ? at<T>(a, I_ROWJ, lane)[q] : at<T>(a, I_ROWI, lane)[q];
  const T f = o ? at<T>(a, I_FJ, lane)[q] : at<T>(a, I_FI, lane)[q];
  const I i0 = o ? at<I>(a, I_I0J, lane)[q] : at<I>(a, I_I0I, lane)[q];
  T tot = f + row * ld * inv_dt;
  T shift = ffloor(tot);
  const int s = clampi(i0 + I(shift), 0, a.KW - 4);
  T u = tot - shift;
  T q4[4][4], p4[4][3], lam[4], d[3][3];
  gather4(at<T>(a, I_KQ, lane), at<T>(a, I_KP, lane), s, q4, p4);
  blend(u, 0, true, lam);
  so3_deltas<T>(q4, d);
  so3_eval<T>(q4, lam, d, sh.u.img.q[j][o]);
  blend(u, 0, false, lam);
  rd_eval(p4, lam, sh.u.img.p[j][o]);
}

// image phase 1, thread (j, r2): the point's transfer from frame i to frame
// j (factors.reproj_residual; both threads), the term of residual entry
// r2, and on thread 0 the mask and the Cauchy cost
template <typename T, typename I>
HD void summary_image_terms(const SummaryArgs& a, SummaryBlock<T>& sh,
                            long long lane, int blk, int t) {
  clear_terms(sh, t);
  const int j = t / 2, r2 = t % 2;
  const int q = blk * SUM_IMAGE_SLOTS + j;
  if (q >= a.Q) return;
  const T sqrt_info = at<T>(a, I_SQRTINFO, lane)[0];
  const T* qc = at<T>(a, I_QC, lane);
  const T* pc = at<T>(a, I_PC, lane);
  const T* pti = at<T>(a, I_PTI, lane) + 3 * q;
  const T* ptj = at<T>(a, I_PTJ, lane) + 3 * q;
  const int lm = clampi(at<I>(a, I_LMIDX, lane)[q], 0, a.LM - 1);
  const T m = at<unsigned char>(a, I_ACTIVE, lane)[q] ? T(1) : T(0);
  T dinv = at<T>(a, I_DINV, lane)[lm];
  if ((dinv < T(0) ? -dinv : dinv) < T(1e-5))
    dinv = dinv < T(0) ? T(-1e-5) : T(1e-5);
  T x_ci[3], v[3], w[3], x_j[3];
  for (int c = 0; c < 3; ++c) x_ci[c] = pti[c] / dinv;
  quat_rotate<T>(qc, x_ci, v);
  for (int c = 0; c < 3; ++c) v[c] = v[c] + pc[c];
  quat_rotate<T>(sh.u.img.q[j][0], v, w);
  for (int c = 0; c < 3; ++c)
    w[c] = (w[c] + sh.u.img.p[j][0][c]) - sh.u.img.p[j][1][c];
  quat_rotate_inv<T>(sh.u.img.q[j][1], w, v);
  for (int c = 0; c < 3; ++c) v[c] = v[c] - pc[c];
  quat_rotate_inv<T>(qc, v, x_j);
  T z = x_j[2];
  T zs = z;
  if ((z < T(0) ? -z : z) < T(1e-6)) {
    T sg = z > T(0) ? T(1) : (z < T(0) ? T(-1) : T(0));
    zs = sg * T(1e-6) + (z == T(0) ? T(1) : T(0)) * T(1e-6);
  }
  T r[2];
  for (int c = 0; c < 2; ++c) r[c] = sqrt_info * (x_j[c] / zs - ptj[c]);
  const T rr = r2 == 0 ? r[0] : r[1];
  sh.red[SUM_IMG_SQ][t] = rr * rr * m;
  if (r2 == 0) {
    const T b = T(a.cauchy_c * a.cauchy_c);
    sh.red[SUM_IMG_N][t] = m;
    sh.red[SUM_IMG_RHO][t] = b * flog1p((r[0] * r[0] + r[1] * r[1]) / b) * m;
  }
}

// IMU phase 0, thread (j, h): half h of slot j's residual
// (factors.imu_residual): h = 0 the gyro's, info (w - (gyro - bg)) with w
// the spline's body rate; h = 1 the accelerometer's, info (R^T (a + g) -
// (accel - ba)) with R the spline's rotation
template <typename T, typename I>
HD void summary_imu_residual(const SummaryArgs& a, SummaryBlock<T>& sh,
                             long long lane, int blk, int t) {
  const int j = t / 2, h = t % 2;
  const int q = blk * SUM_IMU_SLOTS + j;
  if (q >= a.M) return;
  const T inv_dt = T(1.0 / a.dt);
  const T inv_dt2 = T((1.0 / a.dt) * (1.0 / a.dt));
  const int s = clampi(at<I>(a, S_I0, lane)[q], 0, a.KW - 4);
  const int bi = clampi(at<I>(a, S_BIDX, lane)[q], 0, a.NB - 1);
  const T u = at<T>(a, S_U, lane)[q];
  const T* info = at<T>(a, S_INFO, lane);
  T q4[4][4], p4[4][3], lam[4], dlam[4], d[3][3], w[3];
  gather4(at<T>(a, I_KQ, lane), at<T>(a, I_KP, lane), s, q4, p4);
  blend(u, 0, true, lam);
  so3_deltas<T>(q4, d);
  T* r = sh.u.imu.r[j];
  if (h == 0) {
    const T* gyro = at<T>(a, S_GYRO, lane) + 3 * q;
    const T* bg = at<T>(a, S_BG, lane) + 3 * bi;
    blend(u, 1, true, dlam);
    for (int k = 0; k < 4; ++k) dlam[k] = dlam[k] * inv_dt;
    so3_vel_body<T>(lam, dlam, d, w);
    for (int c = 0; c < 3; ++c) r[c] = info[c] * (w[c] - (gyro[c] - bg[c]));
  } else {
    const T* grav = at<T>(a, S_GRAVITY, lane);
    const T* accel = at<T>(a, S_ACCEL, lane) + 3 * q;
    const T* ba = at<T>(a, S_BA, lane) + 3 * bi;
    T qs[4], ag[3], ab[3];
    so3_eval<T>(q4, lam, d, qs);
    blend(u, 2, false, dlam);
    for (int k = 0; k < 4; ++k) dlam[k] = dlam[k] * inv_dt2;
    rd_eval(p4, dlam, ag);
    for (int c = 0; c < 3; ++c) ag[c] = ag[c] + grav[c];
    quat_rotate_inv<T>(qs, ag, ab);
    for (int c = 0; c < 3; ++c)
      r[3 + c] = info[3 + c] * (ab[c] - (accel[c] - ba[c]));
  }
}

// IMU phase 1, thread (j, 0): slot j's |r|^2 and mask
template <typename T>
HD void summary_imu_terms(const SummaryArgs& a, SummaryBlock<T>& sh,
                          long long lane, int blk, int t) {
  clear_terms(sh, t);
  const int j = t / 2;
  const int q = blk * SUM_IMU_SLOTS + j;
  if (t % 2 != 0 || q >= a.M) return;
  const T* r = sh.u.imu.r[j];
  T sq = T(0);
  for (int i = 0; i < 6; ++i) sq = sq + r[i] * r[i];
  const T m = at<unsigned char>(a, S_IMU_VALID, lane)[q] ? T(1) : T(0);
  sh.red[SUM_IMU_SQ][t] = sq * m;
  sh.red[SUM_IMU_N][t] = m;
}

// the bias block, thread t: its entries of the bias pairs' residuals
// (factors.bias_residual: sqrt_info * [bg_j - bg_i, ba_j - ba_i]) and its
// pairs' masks
template <typename T>
HD void summary_bias_terms(const SummaryArgs& a, SummaryBlock<T>& sh,
                           long long lane, int t) {
  const int pairs = a.NB - 1;
  const T* si = at<T>(a, S_BIAS_SI, lane);
  const unsigned char* valid = at<unsigned char>(a, S_BIAS_VALID, lane);
  const T* bg = at<T>(a, S_BG, lane);
  const T* ba = at<T>(a, S_BA, lane);
  T sq = T(0), n = T(0);
  for (int e = t; e < 6 * pairs; e += SUM_THREADS) {
    const int p = e / 6, c = e % 6;
    const T d = c < 3 ? bg[3 * (p + 1) + c] - bg[3 * p + c]
                      : ba[3 * (p + 1) + c - 3] - ba[3 * p + c - 3];
    const T r = si[6 * p + c] * d;
    sq = sq + r * r * (valid[p] ? T(1) : T(0));
  }
  for (int p = t; p < pairs; p += SUM_THREADS)
    n = n + (valid[p] ? T(1) : T(0));
  clear_terms(sh, t);
  sh.red[SUM_BIAS_SQ][t] = sq;
  sh.red[SUM_BIAS_N][t] = n;
}

// prior phase 0, thread t: its entries of x [-] x0 (layout.boxminus_full:
// so3.boxminus of each knot, then the positions', biases' and line
// delay's differences)
template <typename T>
HD void summary_prior_dx(const SummaryArgs& a, T* dx, long long lane, int t) {
  const int KW = a.KW, NB = a.NB, C = 6 * KW + 6 * NB + 1;
  const T* kq = at<T>(a, I_KQ, lane);
  const T* kq0 = at<T>(a, S_KQ0, lane);
  for (int e = t; e < C; e += SUM_THREADS) {
    T v;
    if (e < 3 * KW) {
      const int k = e / 3;
      T c[4], m[4], l[3];
      quat_conj(kq0 + 4 * k, c);
      quat_mul(c, kq + 4 * k, m);
      quat_log<T>(m, l);
      v = e % 3 == 0 ? l[0] : (e % 3 == 1 ? l[1] : l[2]);
    } else if (e < 6 * KW) {
      v = at<T>(a, I_KP, lane)[e - 3 * KW] - at<T>(a, S_KP0, lane)[e - 3 * KW];
    } else if (e < 6 * KW + 3 * NB) {
      const int i = e - 6 * KW;
      v = at<T>(a, S_BG, lane)[i] - at<T>(a, S_BG0, lane)[i];
    } else if (e < C - 1) {
      const int i = e - 6 * KW - 3 * NB;
      v = at<T>(a, S_BA, lane)[i] - at<T>(a, S_BA0, lane)[i];
    } else {
      v = at<T>(a, I_LD, lane)[0] - at<T>(a, S_LD0, lane)[0];
    }
    dx[e] = v;
  }
}

// prior phase 1, thread (g, l): rows g, g + PRIOR_GROUPS, ... of the
// block's, columns l, l + ROW_LANES, ...: its shares of J_row . dx and of
// |J_row|^2, each row's in column order; a step loads PRIOR_COLS_WAVE
// columns of each of its rows before it adds any
template <typename T>
HD void summary_prior_rows(const SummaryArgs& a, SummaryBlock<T>& sh,
                           const T* dx, long long lane, int pblk, int t) {
  const int C = 6 * a.KW + 6 * a.NB + 1;
  const T* J = at<T>(a, S_J, lane);
  const int g = t / ROW_LANES, l = t % ROW_LANES;
  const T* Jr[PRIOR_ROWS_THREAD];
  T dot[PRIOR_ROWS_THREAD], sq[PRIOR_ROWS_THREAD];
#pragma unroll
  for (int i = 0; i < PRIOR_ROWS_THREAD; ++i) {
    const int row = pblk * SUM_PRIOR_ROWS + g + i * PRIOR_GROUPS;
    Jr[i] = row < C ? J + (long long)row * C : nullptr;
    dot[i] = T(0);
    sq[i] = T(0);
  }
  for (int c0 = l; c0 < C; c0 += ROW_LANES * PRIOR_COLS_WAVE) {
    T x[PRIOR_COLS_WAVE], v[PRIOR_COLS_WAVE][PRIOR_ROWS_THREAD];
#pragma unroll
    for (int w = 0; w < PRIOR_COLS_WAVE; ++w) {
      const int c = c0 + w * ROW_LANES;
      x[w] = c < C ? dx[c] : T(0);
#pragma unroll
      for (int i = 0; i < PRIOR_ROWS_THREAD; ++i)
        v[w][i] = (c < C && Jr[i] != nullptr) ? Jr[i][c] : T(0);
    }
#pragma unroll
    for (int w = 0; w < PRIOR_COLS_WAVE; ++w) {
      if (c0 + w * ROW_LANES >= C) break;
#pragma unroll
      for (int i = 0; i < PRIOR_ROWS_THREAD; ++i) {
        dot[i] = dot[i] + v[w][i] * x[w];
        sq[i] = sq[i] + v[w][i] * v[w][i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PRIOR_ROWS_THREAD; ++i) {
    sh.u.prior.dot[g + i * PRIOR_GROUPS][l] = dot[i];
    sh.u.prior.sq[g + i * PRIOR_GROUPS][l] = sq[i];
  }
}

// prior phases 2.., a level of the tree over a row's ROW_LANES shares:
// share l += share l + half
template <typename T>
HD void summary_prior_fold(SummaryBlock<T>& sh, int half, int t) {
  for (int p = t; p < SUM_PRIOR_ROWS * half; p += SUM_THREADS) {
    const int rho = p / half, l = p % half;
    sh.u.prior.dot[rho][l] = sh.u.prior.dot[rho][l] + sh.u.prior.dot[rho][l + half];
    sh.u.prior.sq[rho][l] = sh.u.prior.sq[rho][l] + sh.u.prior.sq[rho][l + half];
  }
}

// the prior's last phase, thread t: row t's residual r0 + J_row . dx, its
// square, and whether the row's norm is nonzero
template <typename T>
HD void summary_prior_terms(const SummaryArgs& a, SummaryBlock<T>& sh,
                            long long lane, int pblk, int t) {
  clear_terms(sh, t);
  const int C = 6 * a.KW + 6 * a.NB + 1;
  const int row = pblk * SUM_PRIOR_ROWS + t;
  if (t >= SUM_PRIOR_ROWS || row >= C) return;
  const T r = at<T>(a, S_R0, lane)[row] + sh.u.prior.dot[t][0];
  sh.red[SUM_PRIOR_SQ][t] = r * r;
  sh.red[SUM_PRIOR_N][t] = sh.u.prior.sq[t][0] > T(0) ? T(1) : T(0);
}

// a level of the block's tree over its threads' terms: t += t + half
template <typename T>
HD void summary_fold(SummaryBlock<T>& sh, int half, int t) {
  if (t >= half) return;
  for (int k = 0; k < N_SUMS; ++k) sh.red[k][t] = sh.red[k][t] + sh.red[k][t + half];
}

constexpr int log2i(int n) { return n <= 1 ? 0 : 1 + log2i(n / 2); }
static_assert((1 << log2i(ROW_LANES)) == ROW_LANES &&
                  (1 << log2i(SUM_THREADS)) == SUM_THREADS,
              "the trees halve powers of two");
constexpr int ROW_FOLDS = log2i(ROW_LANES);
constexpr int BLOCK_FOLDS = log2i(SUM_THREADS);

// a partial sum as the lane's last block reads it: past L1 on the card
// (another SM wrote it), a plain load on the host
template <typename T>
HD T load_partial(const T* p) {
#if defined(__CUDA_ARCH__)
  return __ldcg(p);
#else
  return *p;
#endif
}

template <typename T>
HD T at_least_one(T x) { return x < T(1) ? T(1) : x; }  // NaN stays NaN

// the lane's last block, its finish: a step loads the partials of blocks
// b0 .. b0 + SUM_FINISH_BLOCKS - 1 into shared memory (thread t entries
// t, t + SUM_THREADS, ...), the next adds them (thread k < N_SUMS sum k,
// in block order, on from the sums of the steps before); then the outputs
template <typename T>
HD void summary_finish_load(const SummaryArgs& a, SummaryBlock<T>& sh,
                            long long lane, int b0, int t) {
  const int n = (a.blocks - b0 < SUM_FINISH_BLOCKS ? a.blocks - b0
                                                   : SUM_FINISH_BLOCKS);
  const T* part = static_cast<const T*>(a.partial) +
                  (lane * a.blocks + b0) * N_SUMS;
  T* stage = &sh.u.fin.part[0][0];
  for (int e = t; e < n * N_SUMS; e += SUM_THREADS)
    stage[e] = load_partial(part + e);
}

template <typename T>
HD void summary_finish_add(const SummaryArgs& a, SummaryBlock<T>& sh,
                           int b0, int t) {
  if (t >= N_SUMS) return;
  const int n = (a.blocks - b0 < SUM_FINISH_BLOCKS ? a.blocks - b0
                                                   : SUM_FINISH_BLOCKS);
  T s = b0 == 0 ? T(0) : sh.u.fin.sum[t];
  for (int b = 0; b < n; ++b) s = s + sh.u.fin.part[b][t];
  sh.u.fin.sum[t] = s;
}

// thread 0: the lane's five outputs from its sums
template <typename T>
HD void summary_finish_store(const SummaryArgs& a, const SummaryBlock<T>& sh,
                             long long lane, int t) {
  if (t != 0) return;
  const T* s = sh.u.fin.sum;
  T* out = static_cast<T*>(a.out) + lane * N_SUMMARY_OUT;
  out[0] = fsqrt(s[SUM_IMG_SQ] / at_least_one(T(2.0) * s[SUM_IMG_N]));
  out[1] = fsqrt(s[SUM_IMU_SQ] / at_least_one(T(6.0) * s[SUM_IMU_N]));
  out[2] = fsqrt(s[SUM_BIAS_SQ] / at_least_one(T(6.0) * s[SUM_BIAS_N]));
  out[3] = fsqrt(s[SUM_PRIOR_SQ] / at_least_one(s[SUM_PRIOR_N]));
  T cost = T(0.5) * s[SUM_IMG_RHO];
  cost = cost + T(0.5) * s[SUM_IMU_SQ];
  cost = cost + T(0.5) * s[SUM_BIAS_SQ];
  out[4] = cost + T(0.5) * s[SUM_PRIOR_SQ];
}

// thread 0 of a block after its phases: the block arrives (`arrive` adds
// one to the lane's counter and returns the count before: an atomic on
// the card, with fences around it); whether it is the lane's last, which
// resets the counter and finishes the lane
template <typename Arrive>
HD bool summary_arrive(const SummaryArgs& a, long long lane, Arrive arrive) {
  const unsigned int prev = arrive(a.arrive + lane);
  if (prev != unsigned(a.blocks - 1)) return false;
  a.arrive[lane] = 0u;
  return true;
}

// K5 as its phases: a block runs phase 0 on every thread, waits at a
// barrier, runs phase 1, and so on; threads share only the block struct
// and x [-] x0 (`dx`, C values in dynamic shared memory). The last phase
// writes the block's partials; the arrival follows it, and in the lane's
// last block the finish's steps.
template <typename T, typename I>
struct SummaryKernel {
  typedef SummaryArgs Args;
  typedef SummaryBlock<T> Shared;
  typedef T Real;
  static constexpr int THREADS = SUM_THREADS;
  // role work (2), the row tree, the row terms, the block tree, the store
  static constexpr int PHASES = 2 + ROW_FOLDS + 1 + BLOCK_FOLDS + 1;
  static HD void phase(int ph, const Args& a, Shared& sh, T* dx,
                       long long lane, int b, int t) {
    const int imu0 = a.image_blocks, bias0 = imu0 + a.imu_blocks;
    const int prior0 = bias0 + 1;
    if (ph < 2) {
      if (b < imu0) {
        if (ph == 0) summary_image_observation<T, I>(a, sh, lane, b, t);
        else summary_image_terms<T, I>(a, sh, lane, b, t);
      } else if (b < bias0) {
        if (ph == 0) summary_imu_residual<T, I>(a, sh, lane, b - imu0, t);
        else summary_imu_terms<T>(a, sh, lane, b - imu0, t);
      } else if (b == bias0) {
        if (ph == 0) summary_bias_terms<T>(a, sh, lane, t);
      } else {
        if (ph == 0) summary_prior_dx<T>(a, dx, lane, t);
        else summary_prior_rows<T>(a, sh, dx, lane, b - prior0, t);
      }
    } else if (ph < 2 + ROW_FOLDS) {
      if (b >= prior0) summary_prior_fold(sh, ROW_LANES >> (ph - 1), t);
    } else if (ph == 2 + ROW_FOLDS) {
      if (b >= prior0) summary_prior_terms<T>(a, sh, lane, b - prior0, t);
    } else if (ph < PHASES - 1) {
      summary_fold(sh, SUM_THREADS >> (ph - 2 - ROW_FOLDS), t);
    } else if (t == 0) {
      T* part = static_cast<T*>(a.partial) +
                (lane * a.blocks + b) * N_SUMS;
      for (int k = 0; k < N_SUMS; ++k) part[k] = sh.red[k][0];
    }
  }
};

template <typename A>
A pack(const void* const* in, const long long* stride, void* const* out,
       int n_in, int n_out, int L, int n, int KW, int NB, int LM, double dt,
       double cauchy_c) {
  A a;
  for (int i = 0; i < n_in; ++i) {
    a.in[i] = in[i];
    a.stride[i] = stride[i];
  }
  for (int i = 0; i < n_out; ++i) a.out[i] = out[i];
  a.L = L; a.n = n; a.KW = KW; a.NB = NB; a.LM = LM;
  a.dt = dt; a.cauchy_c = cauchy_c;
  return a;
}

// K5's parameter struct from its entry point's arguments
inline SummaryArgs summary_pack(const void* const* in, const long long* stride,
                                void* out, void* partial, void* arrive, int L,
                                int Q, int M, int KW, int NB, int LM,
                                double dt, double cauchy_c) {
  SummaryArgs a;
  for (int i = 0; i < N_SUMMARY_IN; ++i) {
    a.in[i] = in[i];
    a.stride[i] = stride[i];
  }
  a.out = out;
  a.partial = partial;
  a.arrive = static_cast<unsigned int*>(arrive);
  a.L = L; a.Q = Q; a.M = M; a.KW = KW; a.NB = NB; a.LM = LM;
  a.dt = dt; a.cauchy_c = cauchy_c;
  summary_layout(a);
  return a;
}

// run(K<float or double, int32_t or int64_t>()) for the entry points'
// dtype (0 float32, 1 float64) and index (0 int32, 1 int64) codes; -1 for
// a code it does not take
template <template <typename, typename> class K, typename F>
int dispatch(int dtype, int index, F run) {
  if (dtype == 0 && index == 0) return run(K<float, int32_t>());
  if (dtype == 0 && index == 1) return run(K<float, int64_t>());
  if (dtype == 1 && index == 0) return run(K<double, int32_t>());
  if (dtype == 1 && index == 1) return run(K<double, int64_t>());
  return -1;
}

}  // namespace

#ifdef __CUDACC__

namespace {

// a kernel's phases, the barriers between them
template <typename K>
__device__ __forceinline__ void run_phases(const typename K::Args& a) {
  __shared__ typename K::Shared sh;
#pragma unroll
  for (int ph = 0; ph < K::PHASES; ++ph) {
    if (ph > 0) __syncthreads();
    K::phase(ph, a, sh, blockIdx.x, threadIdx.x);
  }
}

template <typename T, typename I>
__global__ void __launch_bounds__(ImageKernel<T, I>::THREADS)
    image_rows_kernel(const ImageArgs a) {
  run_phases<ImageKernel<T, I>>(a);
}

template <typename T, typename I>
__global__ void __launch_bounds__(ImuKernel<T, I>::THREADS)
    imu_rows_kernel(const ImuArgs a) {
  run_phases<ImuKernel<T, I>>(a);
}

// K5: a lane's blocks on grid x, the lanes on grid y; after its phases
// the block arrives, and the lane's last block writes the lane's outputs
template <typename T, typename I>
__global__ void __launch_bounds__(SUM_THREADS)
    residual_summary_kernel(const SummaryArgs a) {
  typedef SummaryKernel<T, I> K;
  __shared__ typename K::Shared sh;
  extern __shared__ __align__(16) unsigned char summary_dx[];
  T* dx = reinterpret_cast<T*>(summary_dx);
  const long long lane = blockIdx.y;
#pragma unroll
  for (int ph = 0; ph < K::PHASES; ++ph) {
    if (ph > 0) __syncthreads();
    K::phase(ph, a, sh, dx, lane, blockIdx.x, threadIdx.x);
  }
  if (threadIdx.x == 0)
    sh.last = summary_arrive(a, lane, [](unsigned int* count) {
      __threadfence();  // the block's partials are written before it arrives
      const unsigned int prev = atomicAdd(count, 1u);
      __threadfence();  // and the last block reads the others' after
      return prev;
    });
  __syncthreads();
  if (!sh.last) return;
  for (int b0 = 0; b0 < a.blocks; b0 += SUM_FINISH_BLOCKS) {
    summary_finish_load<T>(a, sh, lane, b0, threadIdx.x);
    __syncthreads();
    summary_finish_add<T>(a, sh, b0, threadIdx.x);
    __syncthreads();
  }
  summary_finish_store<T>(a, sh, lane, threadIdx.x);
}

template <typename T, typename I>
auto entry(ImageKernel<T, I>) { return image_rows_kernel<T, I>; }
template <typename T, typename I>
auto entry(ImuKernel<T, I>) { return imu_rows_kernel<T, I>; }
template <typename T, typename I>
auto entry(SummaryKernel<T, I>) { return residual_summary_kernel<T, I>; }

// dynamic shared bytes of a K5 launch: x [-] x0, C values
template <typename T>
size_t summary_dynamic_bytes(const SummaryArgs& a) {
  return sizeof(T) * size_t(6 * a.KW + 6 * a.NB + 1);
}

template <typename K>
int launch(K k, const typename K::Args& a, void* stream) {
  long long slots = (long long)a.L * a.n;
  if (slots == 0) return 0;
  int blocks = int((slots + K::SLOTS - 1) / K::SLOTS);
  entry(k)<<<blocks, K::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

template <typename K>
int attributes(K k, long long* out) {
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncGetAttributes(&at, entry(k));
  if (err != cudaSuccess) return int(err);
  out[0] = at.numRegs;
  out[1] = (long long)at.localSizeBytes;
  out[2] = (long long)at.sharedSizeBytes;
  out[3] = at.maxThreadsPerBlock;
  out[4] = K::THREADS;
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64; index: 0 int32, 1 int64. Returns the
// launch's cudaError (0 on success); -1 for a code it does not take.
int image_factor_rows(int dtype, int index, const void* const* in,
                      const long long* stride, void* const* out, int L, int Q,
                      int KW, int NB, int LM, double dt, double cauchy_c,
                      void* stream) {
  ImageArgs a = pack<ImageArgs>(in, stride, out, N_IMAGE_IN, 4, L, Q, KW, NB,
                                LM, dt, cauchy_c);
  return dispatch<ImageKernel>(dtype, index,
                               [&](auto k) { return launch(k, a, stream); });
}

int imu_factor_rows(int dtype, int index, const void* const* in,
                    const long long* stride, void* const* out, int L, int M,
                    int KW, int NB, double dt, void* stream) {
  ImuArgs a = pack<ImuArgs>(in, stride, out, N_IMU_IN, 3, L, M, KW, NB, 0,
                            dt, 0.0);
  return dispatch<ImuKernel>(dtype, index,
                             [&](auto k) { return launch(k, a, stream); });
}

// K5 over L lanes of Q image slots, M IMU slots and C = 6 KW + 6 NB + 1
// columns: `in` the inputs' lane-0 pointers in the wrapper's order, with
// their lane strides `stride`; `out` (L, 5); `partial` a scratch of L x
// residual_summary_blocks(Q, M, KW, NB) x residual_summary_sums() values;
// `arrive` L counters, zero at the launch (zero again after it).
int residual_summary(int dtype, int index, const void* const* in,
                     const long long* stride, void* out, void* partial,
                     void* arrive, int L, int Q, int M, int KW, int NB,
                     int LM, double dt, double cauchy_c, void* stream) {
  if (L < 1) return 0;
  SummaryArgs a = summary_pack(in, stride, out, partial, arrive, L, Q, M, KW,
                               NB, LM, dt, cauchy_c);
  return dispatch<SummaryKernel>(dtype, index, [&](auto k) {
    using K = decltype(k);
    dim3 grid(a.blocks, L);
    entry(k)<<<grid, K::THREADS,
               summary_dynamic_bytes<typename K::Real>(a),
               static_cast<cudaStream_t>(stream)>>>(a);
    return int(cudaGetLastError());
  });
}

// Each instance's resources, 5 values a row in the order K2 (f32 int32,
// f32 int64, f64 int32, f64 int64), then K3 and K5 likewise: registers a
// thread, local (spill) bytes a thread, static shared bytes a block, the
// most threads a block it can launch with, and the threads a block it
// launches with. Returns the first cudaError (0 on success).
int factor_kernel_attributes(long long* out) {
  int err = 0;
  int row = 0;
  auto put = [&](auto k) {
    if (err == 0) err = attributes(k, out + 5 * row++);
    return 0;
  };
  for (int dtype = 0; dtype < 2; ++dtype)
    for (int index = 0; index < 2; ++index)
      dispatch<ImageKernel>(dtype, index, put);
  for (int dtype = 0; dtype < 2; ++dtype)
    for (int index = 0; index < 2; ++index)
      dispatch<ImuKernel>(dtype, index, put);
  for (int dtype = 0; dtype < 2; ++dtype)
    for (int index = 0; index < 2; ++index)
      dispatch<SummaryKernel>(dtype, index, put);
  return err;
}

}  // extern "C"

#endif  // __CUDACC__

extern "C" {

// K5's blocks a lane, and the partial sums a block writes to the scratch
int residual_summary_blocks(int Q, int M, int KW, int NB) {
  SummaryArgs a;
  a.Q = Q; a.M = M; a.KW = KW; a.NB = NB;
  summary_layout(a);
  return a.blocks;
}

int residual_summary_sums() { return N_SUMS; }

}  // extern "C"
