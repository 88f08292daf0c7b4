// K2, K3 and K5 (ctrlvio_tpu_torch/csrc/factors.cu) run on the host, block
// by block, phase by phase, thread by thread, in the kernels' own geometry:
// what a block's threads do between two barriers runs for every thread
// before the next phase starts, which is all that __syncthreads promises.
// Each block's shared struct starts as NaN bytes (-1 for its integers), so
// a read of an entry that no thread wrote shows in the outputs. The entry
// points take the CUDA library's arguments (the stream is ignored), so the
// same ctypes call drives either. K5's blocks run one after another, each
// whole, then arrive: the block that finds itself the lane's last writes
// the lane's outputs, as on the card. The order of the blocks, across the
// lanes too, is `residual_summary_host_order`'s. The arrival is the
// kernel's own `summary_arrive`, its atomic a plain increment here; the
// last block's finish runs its steps thread by thread. Built by
// tests/test_torch_factors_host.py with g++ -x c++ -std=c++17 -O2
// -ffp-contract=off -shared -fPIC.

#include <algorithm>
#include <cstring>
#include <memory>
#include <random>
#include <utility>
#include <vector>

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

// K5's blocks: 0 each lane's in order, lane by lane; 1 each lane's in
// reverse order; otherwise every (lane, block) pair shuffled from that seed
int summary_order = 0;
std::vector<int> summary_finishes;  // the last call's, a lane each

template <typename K>
int run_summary(const SummaryArgs& a) {
  std::vector<std::pair<long long, int>> order;
  for (long long lane = 0; lane < a.L; ++lane)
    for (int b = 0; b < a.blocks; ++b)
      order.emplace_back(lane, summary_order == 1 ? a.blocks - 1 - b : b);
  if (summary_order > 1)
    std::shuffle(order.begin(), order.end(), std::mt19937(summary_order));
  auto sh = std::make_unique<typename K::Shared>();
  std::vector<typename K::Real> dx(6 * a.KW + 6 * a.NB + 1);
  summary_finishes.assign(a.L, 0);
  for (const auto& [lane, b] : order) {
    std::memset(static_cast<void*>(sh.get()), 0xff, sizeof(*sh));
    std::memset(static_cast<void*>(dx.data()), 0xff,
                dx.size() * sizeof(dx[0]));
    for (int ph = 0; ph < K::PHASES; ++ph)
      for (int t = 0; t < K::THREADS; ++t)
        K::phase(ph, a, *sh, dx.data(), lane, b, t);
    using T = typename K::Real;
    if (!summary_arrive(a, lane,
                        [](unsigned int* count) { return (*count)++; }))
      continue;
    ++summary_finishes[lane];
    for (int b0 = 0; b0 < a.blocks; b0 += SUM_FINISH_BLOCKS) {
      for (int t = 0; t < K::THREADS; ++t)
        summary_finish_load<T>(a, *sh, lane, b0, t);
      for (int t = 0; t < K::THREADS; ++t)
        summary_finish_add<T>(a, *sh, b0, t);
    }
    for (int t = 0; t < K::THREADS; ++t)
      summary_finish_store<T>(a, *sh, lane, t);
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

int residual_summary(int dtype, int index, const void* const* in,
                     const long long* stride, void* out, void* partial,
                     void* arrive, int L, int Q, int M, int KW, int NB,
                     int LM, double dt, double cauchy_c, void*) {
  if (L < 1) return 0;
  SummaryArgs a = summary_pack(in, stride, out, partial, arrive, L, Q, M, KW,
                               NB, LM, dt, cauchy_c);
  return dispatch<SummaryKernel>(dtype, index, [&](auto k) {
    return run_summary<decltype(k)>(a);
  });
}

// the order K5's blocks run in from now on (see `summary_order`)
void residual_summary_host_order(int order) { summary_order = order; }

// how many of its blocks finished each lane in the last call (one each)
void residual_summary_host_finishes(int* out) {
  for (size_t k = 0; k < summary_finishes.size(); ++k)
    out[k] = summary_finishes[k];
}

// the geometry: slots a block and threads a block of K2 and of K3; K5's
// image slots, IMU slots and prior rows a block, its threads a block and
// the blocks its finish stages at a time
void factor_geometry(int* out) {
  out[0] = ImageKernel<float, int32_t>::SLOTS;
  out[1] = ImageKernel<float, int32_t>::THREADS;
  out[2] = ImuKernel<float, int32_t>::SLOTS;
  out[3] = ImuKernel<float, int32_t>::THREADS;
  out[4] = SUM_IMAGE_SLOTS;
  out[5] = SUM_IMU_SLOTS;
  out[6] = SUM_PRIOR_ROWS;
  out[7] = SummaryKernel<float, int32_t>::THREADS;
  out[8] = SUM_FINISH_BLOCKS;
}

}  // extern "C"
