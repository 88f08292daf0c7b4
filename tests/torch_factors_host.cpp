// K2 and K3 (ctrlvio_tpu_torch/csrc/factors.cu), and their residual-only
// instances, run on the host, block by block, phase by phase, thread by
// thread, in the kernels' own geometry:
// what a block's threads do between two barriers runs for every thread
// before the next phase starts, which is all that __syncthreads promises.
// Each block's shared struct starts as NaN bytes (-1 for its integers), so
// a read of an entry that no thread wrote shows in the outputs. The entry
// points take the CUDA library's arguments (the stream is ignored), so the
// same ctypes call drives either. Built by tests/test_torch_factors_host.py
// with g++ -x c++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC.

#include <cstring>
#include <memory>

#include "../ctrlvio_tpu_torch/csrc/factors.cu"

namespace {

template <typename K>
int run_blocks(const typename K::Args& a) {
  const long long slots = (long long)a.L * a.n;
  auto sh = std::make_unique<typename K::Shared>();
  for (long long block = 0; block * K::SLOTS < slots; ++block) {
    std::memset(static_cast<void*>(sh.get()), 0xff, sizeof(*sh));
    for (int ph = 0; ph < K::PHASES; ++ph)
      for (int t = 0; t < K::THREADS; ++t) K::phase(ph, a, *sh, block, t);
  }
  return 0;
}

}  // namespace

extern "C" {

int image_factor_rows(int dtype, int index, const void* const* in,
                      const long long* stride, void* const* out, int L, int Q,
                      int KW, int NB, int LM, double dt, double cauchy_c,
                      void*) {
  ImageArgs a = pack<ImageArgs>(in, stride, out, N_IMAGE_IN, 4, L, Q, KW, NB,
                                LM, dt, cauchy_c);
  return dispatch<ImageKernel>(dtype, index, [&](auto k) {
    return run_blocks<decltype(k)>(a);
  });
}

int imu_factor_rows(int dtype, int index, const void* const* in,
                    const long long* stride, void* const* out, int L, int M,
                    int KW, int NB, double dt, void*) {
  ImuArgs a = pack<ImuArgs>(in, stride, out, N_IMU_IN, 3, L, M, KW, NB, 0,
                            dt, 0.0);
  return dispatch<ImuKernel>(dtype, index, [&](auto k) {
    return run_blocks<decltype(k)>(a);
  });
}

int image_factor_residuals(int dtype, int index, const void* const* in,
                           const long long* stride, void* const* out, int L,
                           int Q, int KW, int NB, int LM, double dt,
                           double cauchy_c, void*) {
  ImageArgs a = pack<ImageArgs>(in, stride, out, N_IMAGE_IN, 2, L, Q, KW, NB,
                                LM, dt, cauchy_c);
  return dispatch<ImageResKernel>(dtype, index, [&](auto k) {
    return run_blocks<decltype(k)>(a);
  });
}

int imu_factor_residuals(int dtype, int index, const void* const* in,
                         const long long* stride, void* const* out, int L,
                         int M, int KW, int NB, double dt, void*) {
  ImuArgs a = pack<ImuArgs>(in, stride, out, N_IMU_IN, 2, L, M, KW, NB, 0,
                            dt, 0.0);
  return dispatch<ImuResKernel>(dtype, index, [&](auto k) {
    return run_blocks<decltype(k)>(a);
  });
}

// the geometry: slots a block and threads a block of K2, of K3, of K2's
// residual instance and of K3's
void factor_geometry(int* out) {
  out[0] = ImageKernel<float, int32_t>::SLOTS;
  out[1] = ImageKernel<float, int32_t>::THREADS;
  out[2] = ImuKernel<float, int32_t>::SLOTS;
  out[3] = ImuKernel<float, int32_t>::THREADS;
  out[4] = ImageResKernel<float, int32_t>::SLOTS;
  out[5] = ImageResKernel<float, int32_t>::THREADS;
  out[6] = ImuResKernel<float, int32_t>::SLOTS;
  out[7] = ImuResKernel<float, int32_t>::THREADS;
}

}  // extern "C"
