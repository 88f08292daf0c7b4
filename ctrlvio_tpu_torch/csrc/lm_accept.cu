// K4: the Levenberg-Marquardt iteration's accept step and its exit, for
// Hopper.
//
// One launch does what follows an LM trial (`ctrlvio_tpu_torch/solver/
// lm.py`), for every lane (window) of the launch:
//   accept = cost_t < cost && isfinite(cost_t) && !done;
//   each of the state's leaves (knots_q, knots_p, bg, ba, dinv, ld, H, g,
//   h_ll, g_l, H_cl) becomes the trial's where accept, else stays;
//   rel_dec = (cost - cost_t) / clamp(cost, 1e-30);
//   lam  <- done ? lam : clamp(accept ? lam * down : lam * up, 1e-10, 1e8);
//   cost <- accept ? cost_t : cost;  n_acc <- n_acc + accept;
//   done <- done || (accept && rel_dec < tol);  iters <- iters + !done;
// and, given the handle of a CUDA-graph conditional node, sets the node's
// condition to !done && iters < max_iters.
//
// Not a Pallas kernel: it ports what XLA fuses from the JAX package's LM
// loop, the `body`'s accept test and `tree_map(jnp.where)` selects and the
// `cond` of `ctrlvio_tpu/solver/lm.py:225-252` (`lax.while_loop`). Its
// semantics are those of the plain PyTorch version,
// `ctrlvio_tpu_torch/ops/lm_kernels.py::accept_step_plain`, bit for bit:
//   - the constants are rounded to the solve's type first, as PyTorch does
//     with a Python number against a float32 tensor;
//   - sub and div are IEEE round-to-nearest (`--fmad=false`, no fast math);
//   - the clamps return NaN for NaN, as torch.clamp does (fmax would not);
//   - n_acc and iters are int64, done a bool.
//
// Two instances:
//   - functional: writes accept ? trial : state into fresh outputs (the
//     vmapped solves, the reduced solve, and each captured solve's first
//     iteration). Block 0 of a lane writes the lane's scalars: its outputs
//     are not its inputs, so no block can read a scalar it wrote.
//   - in place: copies the trial over the state only where accept, and
//     writes nothing of the leaves on a rejection (each captured solve's
//     later iterations, inside the conditional node's body). Every block
//     reads the old cost and done, so the scalars are written by the
//     lane's last block to arrive (an arrival counter, zero at rest, that
//     block resets it), after every other block has read them.
//
// What bounds it on an H100 at the e2e window (KW = 32, NB = 11, LM = 256,
// C = 259, f32): 134,707 values, 0.54 MB read and 0.54 MB written on an
// accept, ~0.32 us at 3.35 TB/s (f64 twice that); on a rejection the in-
// place instance moves a few scalars. No arithmetic to speak of. A launch
// costs more than that: the point is to replace the ~50 small operations
// an iteration the accept step was, and the one-byte kernel that set the
// exit's condition, by one launch that also decides the condition.
//
// Design: the leaves' elements are one space of work items, one item 16
// bytes (4 floats or 2 doubles) where the state's, the trial's and the
// output's bases are 16-byte aligned in every lane, one element otherwise
// (and for a leaf's tail). A block of THREADS threads walks the items with
// a grid stride; grid y is the lane. Consecutive threads take consecutive
// items, so a warp's accesses are 512 contiguous bytes. Leaf pointers,
// sizes and lane strides go by value in the parameter struct, so the
// launch captures into a CUDA graph as it is. The per-lane logic is
// host-and-device code: a host build runs it block by block
// (tests/torch_lm_accept_host.cpp).

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#include <cmath>
#include <cstring>
#define HD inline
#endif
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int N_LEAVES = 11;  // knots_q, knots_p, bg, ba, dinv, ld, H, g,
                              // h_ll, g_l, H_cl
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 264;  // blocks a lane, at most (2 a SM)

// the scalars' inputs, in the entry point's order, and the outputs
enum { S_COST, S_COST_T, S_LAM, S_N_ACC, S_DONE, S_ITERS, N_SCALAR_IN };
enum { O_COST, O_LAM, O_N_ACC, O_DONE, O_ITERS, N_SCALAR_OUT };

// a 16-byte item's bits
#ifdef __CUDACC__
using Bits16 = uint4;
#else
struct alignas(16) Bits16 {
  uint32_t w[4];
};
#endif

struct Args {
  const void* state[N_LEAVES];
  const void* trial[N_LEAVES];
  void* out[N_LEAVES];
  // lane strides in elements of the state, the trial and the output
  long long s_stride[N_LEAVES], t_stride[N_LEAVES], o_stride[N_LEAVES];
  long long n_vec[N_LEAVES];      // each leaf's 16-byte items in a lane
                                  // (0 where unaligned)
  long long begin[N_LEAVES + 1];  // its first work item; the last, the total
  const void* s_in[N_SCALAR_IN];
  long long s_in_stride[N_SCALAR_IN];
  void* s_out[N_SCALAR_OUT];  // contiguous over the lanes
  double down, up, tol;
  long long max_iters;
  unsigned long long handle;
  int has_handle;
  unsigned int* arrive;  // one counter a lane (the in-place instance)
  int L;
  int blocks;  // blocks a lane
};

template <typename T>
struct Scalars {
  T cost, lam;
  long long n_acc, iters;
  bool done;
};

template <typename T>
HD bool is_nan(T x) { return x != x; }

// torch.clamp: NaN stays NaN, else max then min
template <typename T>
HD T clamp_nan(T x, T lo, T hi) {
  if (is_nan(x)) return x;
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// torch.clamp(x, min=lo): NaN stays NaN
template <typename T>
HD T clamp_min_nan(T x, T lo) {
  return is_nan(x) ? x : x < lo ? lo : x;
}

template <typename T>
HD bool is_finite(T x) {
  return !is_nan(x) && x - x == T(0);
}

template <typename T>
HD const T* lane_ptr(const void* base, long long stride, long long lane) {
  return static_cast<const T*>(base) + stride * lane;
}

// the lane's accept, from its cost, trial cost and done
template <typename T>
HD bool lane_accept(const Args& a, long long lane) {
  T cost = *lane_ptr<T>(a.s_in[S_COST], a.s_in_stride[S_COST], lane);
  T cost_t = *lane_ptr<T>(a.s_in[S_COST_T], a.s_in_stride[S_COST_T], lane);
  bool done = *lane_ptr<bool>(a.s_in[S_DONE], a.s_in_stride[S_DONE], lane);
  return cost_t < cost && is_finite(cost_t) && !done;
}

// the lane's new scalars (the accept test again: the same bits as
// lane_accept's)
template <typename T>
HD Scalars<T> lane_scalars(const Args& a, long long lane) {
  auto in = [&](int k) { return a.s_in[k]; };
  auto st = [&](int k) { return a.s_in_stride[k]; };
  T cost = *lane_ptr<T>(in(S_COST), st(S_COST), lane);
  T cost_t = *lane_ptr<T>(in(S_COST_T), st(S_COST_T), lane);
  T lam = *lane_ptr<T>(in(S_LAM), st(S_LAM), lane);
  long long n_acc = *lane_ptr<long long>(in(S_N_ACC), st(S_N_ACC), lane);
  bool done = *lane_ptr<bool>(in(S_DONE), st(S_DONE), lane);
  long long iters = *lane_ptr<long long>(in(S_ITERS), st(S_ITERS), lane);
  bool accept = cost_t < cost && is_finite(cost_t) && !done;
  T rel_dec = (cost - cost_t) / clamp_min_nan(cost, T(1e-30));
  T lam_next = clamp_nan(accept ? lam * T(a.down) : lam * T(a.up), T(1e-10),
                         T(1e8));
  Scalars<T> s;
  s.cost = accept ? cost_t : cost;
  s.lam = done ? lam : lam_next;
  s.n_acc = n_acc + (accept ? 1 : 0);
  s.done = done || (accept && rel_dec < T(a.tol));
  s.iters = iters + (done ? 0 : 1);
  return s;
}

template <typename T>
HD void store_scalars(const Args& a, long long lane, const Scalars<T>& s) {
  static_cast<T*>(a.s_out[O_COST])[lane] = s.cost;
  static_cast<T*>(a.s_out[O_LAM])[lane] = s.lam;
  static_cast<long long*>(a.s_out[O_N_ACC])[lane] = s.n_acc;
  static_cast<bool*>(a.s_out[O_DONE])[lane] = s.done;
  static_cast<long long*>(a.s_out[O_ITERS])[lane] = s.iters;
}

// the condition the exit's node gets: another iteration is due
template <typename T>
HD unsigned int lane_condition(const Args& a, const Scalars<T>& s) {
  return (!s.done && s.iters < a.max_iters) ? 1u : 0u;
}

// the leaf that holds work item w of a lane
HD int item_leaf(const Args& a, long long w) {
  int i = 0;
  while (i < N_LEAVES - 1 && w >= a.begin[i + 1]) ++i;
  return i;
}

// copy work item w of `lane`: out = accept ? trial : state (in place, out
// is the state, and this runs only where accept)
template <typename T>
HD void copy_item(const Args& a, long long lane, bool accept, long long w) {
  constexpr long long VEC = 16 / sizeof(T);
  int i = item_leaf(a, w);
  long long j = w - a.begin[i];
  const T* src = accept ? lane_ptr<T>(a.trial[i], a.t_stride[i], lane)
                        : lane_ptr<T>(a.state[i], a.s_stride[i], lane);
  T* dst = static_cast<T*>(a.out[i]) + a.o_stride[i] * lane;
  if (j < a.n_vec[i]) {
    *reinterpret_cast<Bits16*>(dst + j * VEC) =
        *reinterpret_cast<const Bits16*>(src + j * VEC);
  } else {
    long long e = a.n_vec[i] * VEC + (j - a.n_vec[i]);
    dst[e] = src[e];
  }
}

// what thread `t` of block `b` of `lane` copies: items b*THREADS + t,
// then a grid stride
template <typename T, bool IN_PLACE>
HD void copy_share(const Args& a, long long lane, bool accept, int b, int t) {
  if (IN_PLACE && !accept) return;
  const long long total = a.begin[N_LEAVES];
  const long long step = (long long)a.blocks * THREADS;
  for (long long w = (long long)b * THREADS + t; w < total; w += step)
    copy_item<T>(a, lane, accept, w);
}

}  // namespace

#ifdef __CUDACC__

namespace {

template <typename T, bool IN_PLACE>
__global__ void __launch_bounds__(THREADS) lm_accept_kernel(const Args a) {
  const long long lane = blockIdx.y;
  __shared__ bool accept_sh;
  if (threadIdx.x == 0) accept_sh = lane_accept<T>(a, lane);
  __syncthreads();
  copy_share<T, IN_PLACE>(a, lane, accept_sh, blockIdx.x, threadIdx.x);
  if (threadIdx.x != 0) return;
  if (IN_PLACE) {
    // every block of the lane has read the old scalars before it arrives
    __threadfence();
    unsigned int prev = atomicAdd(a.arrive + lane, 1u);
    if (prev != unsigned(a.blocks - 1)) return;
    __threadfence();
    a.arrive[lane] = 0u;
  } else if (blockIdx.x != 0) {
    return;
  }
  Scalars<T> s = lane_scalars<T>(a, lane);
  store_scalars<T>(a, lane, s);
  if (a.has_handle)
    cudaGraphSetConditional(a.handle, lane_condition<T>(a, s));
}

template <typename T, bool IN_PLACE>
auto entry() { return lm_accept_kernel<T, IN_PLACE>; }

}  // namespace

#endif  // __CUDACC__

namespace {

// the parameter struct from the entry point's arguments: the work items'
// layout, 16-byte items where every lane's three bases are aligned
inline int pack(int elem, const void* const* state, const void* const* trial,
                void* const* out, const long long* n, const long long* strides,
                const void* const* s_in, const long long* s_in_stride,
                void* const* s_out, double down, double up, double tol,
                long long max_iters, int has_handle,
                unsigned long long handle, void* arrive, int L, Args* a) {
  const long long vec = 16 / elem;
  long long total = 0;
  for (int i = 0; i < N_LEAVES; ++i) {
    a->state[i] = state[i];
    a->trial[i] = trial[i];
    a->out[i] = out[i];
    a->s_stride[i] = strides[i];
    a->t_stride[i] = strides[N_LEAVES + i];
    a->o_stride[i] = strides[2 * N_LEAVES + i];
    bool aligned = true;
    const void* bases[3] = {state[i], trial[i], out[i]};
    const long long lane_bytes[3] = {a->s_stride[i] * elem,
                                     a->t_stride[i] * elem,
                                     a->o_stride[i] * elem};
    for (int k = 0; k < 3; ++k)
      aligned = aligned && reinterpret_cast<uintptr_t>(bases[k]) % 16 == 0 &&
                (L == 1 || lane_bytes[k] % 16 == 0);
    a->n_vec[i] = aligned ? n[i] / vec : 0;
    a->begin[i] = total;
    total += a->n_vec[i] + (n[i] - a->n_vec[i] * vec);
  }
  a->begin[N_LEAVES] = total;
  for (int k = 0; k < N_SCALAR_IN; ++k) {
    a->s_in[k] = s_in[k];
    a->s_in_stride[k] = s_in_stride[k];
  }
  for (int k = 0; k < N_SCALAR_OUT; ++k) a->s_out[k] = s_out[k];
  a->down = down;
  a->up = up;
  a->tol = tol;
  a->max_iters = max_iters;
  a->has_handle = has_handle;
  a->handle = handle;
  a->arrive = static_cast<unsigned int*>(arrive);
  a->L = L;
  long long blocks = (total + THREADS - 1) / THREADS;
  a->blocks = int(blocks < 1 ? 1 : blocks > MAX_BLOCKS ? MAX_BLOCKS : blocks);
  return 0;
}

// run(T, IN_PLACE) for the entry point's dtype (0 float32, 1 float64) and
// instance codes; -1 for a code it does not take
template <typename F>
int dispatch(int dtype, int in_place, F run) {
  if (dtype == 0 && !in_place) return run(float(), std::false_type());
  if (dtype == 0 && in_place) return run(float(), std::true_type());
  if (dtype == 1 && !in_place) return run(double(), std::false_type());
  if (dtype == 1 && in_place) return run(double(), std::true_type());
  return -1;
}

}  // namespace

#ifdef __CUDACC__

extern "C" {

// One launch of K4 over `L` lanes on `stream`. dtype: 0 float32, 1 float64;
// in_place: 0 the functional instance (outputs `out`, `s_out`), 1 the in-
// place one (`out` and `s_out` are the state's own leaves and scalars).
// `state`, `trial`, `out`: the 11 leaves' lane-0 pointers; `n`: their
// elements a lane; `strides`: their lane strides (state's, trial's,
// output's, 11 each); `s_in`: cost, cost_t, lam, n_acc, done, iters, with
// their lane strides `s_in_stride`; `s_out`: cost, lam, n_acc, done,
// iters. `arrive`: L zeroed counters (in place). With `has_handle`, the
// last writer of each lane sets the conditional node `handle` (L = 1).
// Returns the launch's cudaError (0 on success); -1 for a code it does
// not take.
int lm_accept(int dtype, int in_place, const void* const* state,
              const void* const* trial, void* const* out, const long long* n,
              const long long* strides, const void* const* s_in,
              const long long* s_in_stride, void* const* s_out, double down,
              double up, double tol, long long max_iters, int has_handle,
              unsigned long long handle, void* arrive, int L, void* stream) {
  if (L < 1) return 0;
  Args a;
  pack(dtype == 1 ? 8 : 4, state, trial, out, n, strides, s_in, s_in_stride,
       s_out, down, up, tol, max_iters, has_handle, handle, arrive, L, &a);
  return dispatch(dtype, in_place, [&](auto t, auto ip) {
    using T = decltype(t);
    dim3 grid(a.blocks, L);
    entry<T, decltype(ip)::value>()<<<grid, THREADS, 0,
                                     static_cast<cudaStream_t>(stream)>>>(a);
    return int(cudaGetLastError());
  });
}

// Each instance's resources, 5 values a row in the order f32 functional,
// f32 in place, f64 functional, f64 in place: registers a thread, local
// (spill) bytes a thread, static shared bytes a block, the most threads a
// block it can launch with, and the threads a block it launches with.
// Returns the first cudaError (0 on success).
int lm_accept_attributes(long long* out) {
  int err = 0, row = 0;
  for (int dtype = 0; dtype < 2; ++dtype)
    for (int in_place = 0; in_place < 2; ++in_place)
      dispatch(dtype, in_place, [&](auto t, auto ip) {
        using T = decltype(t);
        cudaFuncAttributes at;
        if (err == 0)
          err = int(cudaFuncGetAttributes(&at, entry<T, decltype(ip)::value>()));
        if (err == 0) {
          long long* o = out + 5 * row;
          o[0] = at.numRegs;
          o[1] = (long long)at.localSizeBytes;
          o[2] = (long long)at.sharedSizeBytes;
          o[3] = at.maxThreadsPerBlock;
          o[4] = THREADS;
        }
        ++row;
        return 0;
      });
  return err;
}

}  // extern "C"

#endif  // __CUDACC__
