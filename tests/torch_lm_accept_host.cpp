// K4 (ctrlvio_tpu_torch/csrc/lm_accept.cu) run on the host, block by
// block and thread by thread in the kernel's own geometry, through the CUDA
// library's entry point (the stream is ignored), so the same ctypes call
// drives either. Each lane's blocks run one after another, each whole:
// read the lane's accept, copy its share, arrive. So the block that
// writes the lane's scalars in place must be the last to arrive, as on the
// card, or a later block reads the new cost and done. A conditional
// handle cannot be set here: the condition each lane's writer would set is
// kept (`lm_accept_host_conditions`). Built by tests/test_torch_lm_accept.py
// with g++ -x c++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC.

#include <vector>

#include "../ctrlvio_tpu_torch/csrc/lm_accept.cu"

namespace {

std::vector<int> conditions;  // the last call's, a lane each; -1 for none

template <typename T, bool IN_PLACE>
int run_blocks(const Args& a) {
  conditions.assign(a.L, -1);
  for (long long lane = 0; lane < a.L; ++lane) {
    for (int b = 0; b < a.blocks; ++b) {
      const bool accept = lane_accept<T>(a, lane);
      for (int t = 0; t < THREADS; ++t)
        copy_share<T, IN_PLACE>(a, lane, accept, b, t);
      bool writer;
      if (IN_PLACE) {
        unsigned int prev = a.arrive[lane]++;
        writer = prev == unsigned(a.blocks - 1);
        if (writer) a.arrive[lane] = 0u;
      } else {
        writer = b == 0;
      }
      if (!writer) continue;
      Scalars<T> s = lane_scalars<T>(a, lane);
      store_scalars<T>(a, lane, s);
      if (a.has_handle) conditions[lane] = int(lane_condition<T>(a, s));
    }
  }
  return 0;
}

}  // namespace

extern "C" {

int lm_accept(int dtype, int in_place, const void* const* state,
              const void* const* trial, void* const* out, const long long* n,
              const long long* strides, const void* const* s_in,
              const long long* s_in_stride, void* const* s_out, double down,
              double up, double tol, long long max_iters, int has_handle,
              unsigned long long handle, void* arrive, int L, void*) {
  if (L < 1) return 0;
  Args a;
  pack(dtype == 1 ? 8 : 4, state, trial, out, n, strides, s_in, s_in_stride,
       s_out, down, up, tol, max_iters, has_handle, handle, arrive, L, &a);
  return dispatch(dtype, in_place, [&](auto t, auto ip) {
    return run_blocks<decltype(t), decltype(ip)::value>(a);
  });
}

// the condition each lane's writer set in the last call (-1: no handle)
void lm_accept_host_conditions(int* out) {
  for (size_t k = 0; k < conditions.size(); ++k) out[k] = conditions[k];
}

// blocks a lane for `items` work items
int lm_accept_host_blocks(long long items) {
  long long b = (items + THREADS - 1) / THREADS;
  return int(b < 1 ? 1 : b > MAX_BLOCKS ? MAX_BLOCKS : b);
}

}  // extern "C"
