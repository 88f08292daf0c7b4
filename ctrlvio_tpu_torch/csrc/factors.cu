// K2 and K3: the window solve's factor linearization, for Hopper.
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
// What bounds them on an H100 at the e2e window (Q = 768 image and M = 256
// IMU slots, C = 6 KW + 6 NB + 1 = 259, f32): each writes 1.59 MB of rows
// (768 x 2 x 259 and 256 x 6 x 259 values), ~0.47 us at 3.35 TB/s; the
// arithmetic, a few thousand operations a slot (K3's 12 dual passes ~25k),
// is under 0.1 us at 67 TFLOP/s. Neither is reachable at this size: a
// launch is a few microseconds, and one slot's chain of transcendentals
// and 3x3 products is thousands of dependent instructions.
//
// Design: one thread a factor slot and lane, blocks of 128. A thread keeps
// its slot's blocks in registers and writes its own rows in full, zeros
// included: no memset, no atomics, so every run and every graph replay
// gives the same bits, and a batch equals its lanes launched one by one.
// The row loops select a knot's block by unrolled comparisons, so no
// block is indexed at run time. Each input comes with a lane stride (0
// for a constant every lane shares), so B windows under torch.func.vmap
// are one launch over B x Q threads without copying the shared inputs.
// The math is written as host-and-device functions.

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
  for (int i = 0; i < 3; ++i) {
    T m[4];
    quat_mul(q, A[i], m);
    for (int c = 0; c < 4; ++c) q[c] = m[c];
  }
  quat_normalize(q);

  // X_i^r = ((lam_{i+1} P_{i+1}^T) Jr(lam_{i+1} d_i)) Jr^-1(d_i), X_i^l the
  // same with Jl^-1(d_i): knot k gets X_{k-1}^r (k >= 1) - X_k^l (k <= 2)
  T Xr[3][3][3], Xl[3][3][3];
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
  for (int k = 0; k < 4; ++k) {
    for (int c = 0; c < 4; ++c) q4[k][c] = knots_q[(s + k) * 4 + c];
    for (int c = 0; c < 3; ++c) p4[k][c] = knots_p[(s + k) * 3 + c];
  }
}

// the value of block[k] at knot kn (s <= kn < s + 4), else 0, with k
// selected by unrolled comparisons (no run-time index into registers)
template <typename T>
HD T knot_entry(const T blk[4][3], int kn, int s, int d) {
  T v = T(0);
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int e = 0; e < 3; ++e)
      if (kn - s == k && d == e) v = blk[k][e];
  return v;
}

// ---------------------------------------------------------------------------
// K2: one image factor slot
// ---------------------------------------------------------------------------

// (Jv A) Jk for each knot: the einsum "ab,bc,kcd->akd", left to right
template <typename T>
HD void jv_a_jk(const T Jv[2][3], const T A[3][3], const T Jk[4][3][3],
                T out[2][4][3]) {
  T JA[2][3];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      JA[r][c] = Jv[r][0] * A[0][c] + Jv[r][1] * A[1][c] + Jv[r][2] * A[2][c];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int e = 0; e < 3; ++e)
        out[r][k][e] = JA[r][0] * Jk[k][0][e] + JA[r][1] * Jk[k][1][e] +
                       JA[r][2] * Jk[k][2][e];
}

template <typename T, typename I>
HD void image_slot(const ImageArgs& a, long long lane, int q) {
  const int KW = a.KW, NB = a.NB, C = 6 * KW + 6 * NB + 1;
  const T inv_dt = T(1.0 / a.dt);
  const T* kq = at<T>(a, I_KQ, lane);
  const T* kp = at<T>(a, I_KP, lane);
  const T ld = at<T>(a, I_LD, lane)[0];
  const T sqrt_info = at<T>(a, I_SQRTINFO, lane)[0];
  const T* qc = at<T>(a, I_QC, lane);
  const T* pc = at<T>(a, I_PC, lane);
  const T row[2] = {at<T>(a, I_ROWI, lane)[q], at<T>(a, I_ROWJ, lane)[q]};
  const T f[2] = {at<T>(a, I_FI, lane)[q], at<T>(a, I_FJ, lane)[q]};
  const I i0[2] = {at<I>(a, I_I0I, lane)[q], at<I>(a, I_I0J, lane)[q]};
  const T* pti = at<T>(a, I_PTI, lane) + 3 * q;
  const T* ptj = at<T>(a, I_PTJ, lane) + 3 * q;
  const int lm = clampi(at<I>(a, I_LMIDX, lane)[q], 0, a.LM - 1);
  const T m = at<unsigned char>(a, I_ACTIVE, lane)[q] ? T(1) : T(0);

  // the two observation times: segments (assemble._segments), knots,
  // spline values, Jacobians, velocities
  int s[2];
  T u[2], qv[2][4], Jk[2][4][3][3], pos[2][3], vel[2][3], w[2][3],
      lam_p[2][4];
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    T tot = f[o] + row[o] * ld * inv_dt;
    T shift = ffloor(tot);
    s[o] = clampi(i0[o] + I(shift), 0, KW - 4);
    u[o] = tot - shift;
    T q4[4][4], p4[4][3], lam[4], dlam[4], d[3][3], lam1[4];
    gather4(kq, kp, s[o], q4, p4);
    blend(u[o], 0, true, lam);
    blend(u[o], 1, true, dlam);
    for (int k = 0; k < 4; ++k) dlam[k] = dlam[k] * inv_dt;
    so3_deltas<T>(q4, d);
    so3_value_knot_jac(q4, lam, d, qv[o], Jk[o]);
    blend(u[o], 0, false, lam_p[o]);
    rd_eval(p4, lam_p[o], pos[o]);
    blend(u[o], 1, false, lam1);
    for (int k = 0; k < 4; ++k) lam1[k] = lam1[k] * inv_dt;
    rd_eval(p4, lam1, vel[o]);
    so3_vel_body<T>(lam, dlam, d, w[o]);
  }

  // residual and Jacobians (reproj_analytic.reproj_analytic)
  T Rc[3][3], Rct[3][3], Ri[3][3], Rj[3][3], Rjt[3][3];
  quat_to_matrix(qc, Rc);
  transpose3(Rc, Rct);
  quat_to_matrix(qv[0], Ri);
  quat_to_matrix(qv[1], Rj);
  transpose3(Rj, Rjt);
  T dinv = at<T>(a, I_DINV, lane)[lm];
  if ((dinv < T(0) ? -dinv : dinv) < T(1e-5))
    dinv = dinv < T(0) ? T(-1e-5) : T(1e-5);
  T x_ci[3], p_Ii[3], p_G[3], y[3], Rjt_y[3], x_j[3], t3[3];
  for (int c = 0; c < 3; ++c) x_ci[c] = pti[c] / dinv;
  matvec3(Rc, x_ci, t3);
  for (int c = 0; c < 3; ++c) p_Ii[c] = t3[c] + pc[c];
  matvec3(Ri, p_Ii, t3);
  for (int c = 0; c < 3; ++c) p_G[c] = t3[c] + pos[0][c];
  for (int c = 0; c < 3; ++c) y[c] = p_G[c] - pos[1][c];
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
  T Jv[2][3];
  {
    T iz = T(1.0) / zs, z2 = zs * zs;
    Jv[0][0] = sqrt_info * iz;
    Jv[0][1] = sqrt_info * T(0);
    Jv[0][2] = sqrt_info * (-x_j[0] / z2);
    Jv[1][0] = sqrt_info * T(0);
    Jv[1][1] = sqrt_info * iz;
    Jv[1][2] = sqrt_info * (-x_j[1] / z2);
  }
  T M[3][3], MRi[3][3], H[3][3], Ai[3][3], Aj[3][3];
  matmul3(Rct, Rjt, M);
  matmul3(M, Ri, MRi);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) MRi[i][j] = -MRi[i][j];
  hat(p_Ii, H);
  matmul3(MRi, H, Ai);
  hat(Rjt_y, H);
  matmul3(Rct, H, Aj);
  // J_r = (Jv A) Jk, per knot
  T Jr[2][2][4][3];
  jv_a_jk(Jv, Ai, Jk[0], Jr[0]);
  jv_a_jk(Jv, Aj, Jk[1], Jr[1]);
  T JvM[2][3];
  for (int r2 = 0; r2 < 2; ++r2)
    for (int c = 0; c < 3; ++c)
      JvM[r2][c] = Jv[r2][0] * M[0][c] + Jv[r2][1] * M[1][c] +
                   Jv[r2][2] * M[2][c];
  // J_p: +-JvM lam_k
  T Jp[2][2][4][3];
  for (int r2 = 0; r2 < 2; ++r2)
    for (int k = 0; k < 4; ++k)
      for (int e = 0; e < 3; ++e) {
        Jp[0][r2][k][e] = JvM[r2][e] * lam_p[0][k];
        Jp[1][r2][k][e] = (-JvM[r2][e]) * lam_p[1][k];
      }
  // J_dinv = Jv (-(M Ri Rc) x_ci / dinv)
  T Jd[2];
  {
    T MRiRc[3][3], vd[3];
    matmul3(M, Ri, H);
    matmul3(H, Rc, MRiRc);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) MRiRc[i][j] = -MRiRc[i][j];
    matvec3(MRiRc, x_ci, vd);
    for (int c = 0; c < 3; ++c) vd[c] = vd[c] / dinv;
    for (int r2 = 0; r2 < 2; ++r2)
      Jd[r2] = Jv[r2][0] * vd[0] + Jv[r2][1] * vd[1] + Jv[r2][2] * vd[2];
  }
  // J_ld = Jv (row_i dx/dt_i + row_j dx/dt_j)
  T Jl[2];
  {
    T dti[3], dtj[3], v1[3], v2[3], v3[3], sv[3];
    hat(w[0], H);
    matvec3(H, p_Ii, v1);
    matvec3(Ri, v1, v2);
    for (int c = 0; c < 3; ++c) v2[c] = v2[c] + vel[0][c];
    matvec3(M, v2, dti);
    hat(w[1], H);
    matvec3(H, Rjt_y, v1);
    matvec3(Rct, v1, v2);
    matvec3(M, vel[1], v3);
    for (int c = 0; c < 3; ++c) dtj[c] = -v2[c] - v3[c];
    for (int c = 0; c < 3; ++c) sv[c] = row[0] * dti[c] + row[1] * dtj[c];
    for (int r2 = 0; r2 < 2; ++r2)
      Jl[r2] = Jv[r2][0] * sv[0] + Jv[r2][1] * sv[1] + Jv[r2][2] * sv[2];
  }

  // the Cauchy weight and cost (assemble._cauchy_weight_and_cost)
  const T b = T(a.cauchy_c * a.cauchy_c);
  const T x = (r[0] * r[0] + r[1] * r[1]) / b;
  const T wt = T(1.0) / fsqrt(T(1.0) + x) * m;
  const long long slot = lane * a.n + q;
  T* rw = static_cast<T*>(a.out[1]) + 2 * slot;
  T* jl = static_cast<T*>(a.out[2]) + 2 * slot;
  static_cast<T*>(a.out[3])[slot] = b * flog1p(x) * m;
  for (int r2 = 0; r2 < 2; ++r2) {
    rw[r2] = r[r2] * wt;
    jl[r2] = Jd[r2] * wt;
  }

  // the dense rows (assemble._image_rows)
  T* rows = static_cast<T*>(a.out[0]) + slot * 2 * C;
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    T* out = rows + r2 * C;
    for (int kn = 0; kn < KW; ++kn)
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        out[3 * kn + e] = (knot_entry(Jr[0][r2], kn, s[0], e) +
                           knot_entry(Jr[1][r2], kn, s[1], e)) * wt;
        out[3 * KW + 3 * kn + e] = (knot_entry(Jp[0][r2], kn, s[0], e) +
                                    knot_entry(Jp[1][r2], kn, s[1], e)) * wt;
      }
    for (int c = 6 * KW; c < C - 1; ++c) out[c] = T(0);
    out[C - 1] = Jl[r2] * wt;
  }
}

// ---------------------------------------------------------------------------
// K3: one IMU factor slot
// ---------------------------------------------------------------------------

template <typename T, typename I>
HD void imu_slot(const ImuArgs& a, long long lane, int q) {
  const int KW = a.KW, NB = a.NB, C = 6 * KW + 6 * NB + 1;
  const T inv_dt = T(1.0 / a.dt);
  const T inv_dt2 = T((1.0 / a.dt) * (1.0 / a.dt));
  const int s = clampi(at<I>(a, M_I0, lane)[q], 0, KW - 4);
  const int bi = clampi(at<I>(a, M_BIDX, lane)[q], 0, NB - 1);
  const T u = at<T>(a, M_U, lane)[q];
  const T m = at<unsigned char>(a, M_ACTIVE, lane)[q] ? T(1) : T(0);
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
  for (int c = 0; c < 3; ++c) {
    ag[c] = ag[c] + grav[c];
    gm[c] = gyro[c] - bg[c];
    am[c] = accel[c] - ba[c];
  }

  // the residual under q_k exp(phi), one pass a rotation tangent direction
  // p = 3 k + e of the 12 (factors.imu_residual_tangent at phi = 0)
  typedef Dual<T> D;
  T r[6] = {}, Jr[6][4][3], qval[4] = {};
#pragma unroll 1
  for (int p = 0; p < 12; ++p) {
    D qd[4][4];
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
    for (int c = 0; c < 3; ++c) {
      res[c] = info[c] * (w[c] - gm[c]);
      res[3 + c] = info[3 + c] * (ab[c] - am[c]);
    }
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < 3; ++e)
          if (p == 3 * k + e) Jr[i][k][e] = res[i].d;
    if (p == 0) {
      for (int i = 0; i < 6; ++i) r[i] = res[i].v;
      for (int c = 0; c < 4; ++c) qval[c] = qs[c].v;
    }
  }
  // position blocks: info_a (R^T (lam''_k e_d))_a on the accel rows
  T Jp[6][4][3];
  for (int k = 0; k < 4; ++k)
    for (int e = 0; e < 3; ++e) {
      T v[3] = {T(0), T(0), T(0)}, o[3];
      for (int c = 0; c < 3; ++c)
        if (c == e) v[c] = lam2[k];
      quat_rotate_inv<T>(qval, v, o);
      for (int c = 0; c < 3; ++c) {
        Jp[c][k][e] = info[c] * T(0);
        Jp[3 + c][k][e] = info[3 + c] * o[c];
      }
    }

  const long long slot = lane * a.n + q;
  T* rm = static_cast<T*>(a.out[1]) + 6 * slot;
  T cost = T(0);
  for (int i = 0; i < 6; ++i) {
    rm[i] = r[i] * m;
    cost = cost + rm[i] * rm[i];
  }
  static_cast<T*>(a.out[2])[slot] = cost;

  // the dense rows (assemble._imu_rows)
  T* rows = static_cast<T*>(a.out[0]) + slot * 6 * C;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T* out = rows + i * C;
    for (int kn = 0; kn < KW; ++kn)
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        out[3 * kn + e] = knot_entry(Jr[i], kn, s, e) * m;
        out[3 * KW + 3 * kn + e] = knot_entry(Jp[i], kn, s, e) * m;
      }
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        T g = (b == bi && i == e) ? info[i] : T(0);
        T acc = (b == bi && i == 3 + e) ? info[i] : T(0);
        out[6 * KW + 3 * b + e] = g * m;
        out[6 * KW + 3 * NB + 3 * b + e] = acc * m;
      }
    out[C - 1] = T(0) * m;
  }
}

}  // namespace

#ifdef __CUDACC__

namespace {

constexpr int THREADS = 128;

template <typename T, typename I>
__global__ void __launch_bounds__(THREADS) image_rows_kernel(const ImageArgs a) {
  long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx < (long long)a.L * a.n) image_slot<T, I>(a, idx / a.n, int(idx % a.n));
}

template <typename T, typename I>
__global__ void __launch_bounds__(THREADS) imu_rows_kernel(const ImuArgs a) {
  long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx < (long long)a.L * a.n) imu_slot<T, I>(a, idx / a.n, int(idx % a.n));
}

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

template <typename A, typename K>
int launch(K kernel, const A& a, void* stream) {
  long long threads = (long long)a.L * a.n;
  if (threads == 0) return 0;
  int blocks = int((threads + THREADS - 1) / THREADS);
  kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
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
  if (dtype == 0 && index == 0)
    return launch(image_rows_kernel<float, int32_t>, a, stream);
  if (dtype == 0 && index == 1)
    return launch(image_rows_kernel<float, int64_t>, a, stream);
  if (dtype == 1 && index == 0)
    return launch(image_rows_kernel<double, int32_t>, a, stream);
  if (dtype == 1 && index == 1)
    return launch(image_rows_kernel<double, int64_t>, a, stream);
  return -1;
}

int imu_factor_rows(int dtype, int index, const void* const* in,
                    const long long* stride, void* const* out, int L, int M,
                    int KW, int NB, double dt, void* stream) {
  ImuArgs a = pack<ImuArgs>(in, stride, out, N_IMU_IN, 3, L, M, KW, NB, 0,
                            dt, 0.0);
  if (dtype == 0 && index == 0)
    return launch(imu_rows_kernel<float, int32_t>, a, stream);
  if (dtype == 0 && index == 1)
    return launch(imu_rows_kernel<float, int64_t>, a, stream);
  if (dtype == 1 && index == 0)
    return launch(imu_rows_kernel<double, int32_t>, a, stream);
  if (dtype == 1 && index == 1)
    return launch(imu_rows_kernel<double, int64_t>, a, stream);
  return -1;
}

}  // extern "C"

#endif  // __CUDACC__
