// K6 (ctrlvio_tpu_torch/csrc/qr_prior.cu) runs on the host, a lane's blocks
// one after another in ticket order, each whole: its load phases thread by
// thread between the barriers, then its chain of steps, each thread reading
// its column of the input rows as it needs them. A block therefore finds
// its upstream block's rows all written, which on the card it waits for. Each
// block's shared memory starts as NaN bytes (-1 for its integers), so a read
// of an entry that no thread wrote shows in the outputs. The entry point
// takes the CUDA library's arguments (the stream is ignored), so the same
// ctypes call drives either. Built by tests/test_torch_qr_prior_host.py
// with g++ -x c++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC.

#include <array>
#include <cstring>
#include <vector>

#include "../ctrlvio_tpu_torch/csrc/qr_prior.cu"

namespace {

template <typename T, bool WIDE>
int run_lane(const QrArgs& a, long long lane) {
  constexpr int ROWS = Geometry<T, WIDE>::ROWS;
  const int nthr = a.NCOLP + COMM;
  std::vector<unsigned char> bytes(
      smem_layout<T, ROWS>(nullptr, a, nullptr));
  unsigned int* counters = a.counters + lane * (a.NPOS + 1);
  for (int k = 0; k < a.NPOS; ++k) {
    std::memset(bytes.data(), 0xff, bytes.size());
    Smem<T> m;
    smem_layout<T, ROWS>(bytes.data(), a, &m);
    QrShared sh;
    std::memset(static_cast<void*>(&sh), 0xff, sizeof(sh));
    sh.ticket = int(counters[0]++);
    sh.known = 0;
    sh.done = 0;
    for (int t = 0; t < nthr; ++t) phase_zero(a, m, t, nthr);
    for (int t = 0; t < nthr; ++t) phase_count(a, m, lane, t, nthr);
    for (int t = 0; t < nthr; ++t) phase_starts(a, m, t, nthr);
    phase_plan<T, ROWS>(a, m, sh);
    if (sh.ticket >= sh.n_pos) continue;
    for (int t = 0; t < nthr; ++t) phase_obs(a, m, sh, lane, t);
    for (int t = 0; t < nthr; ++t) phase_landmark_list(m, sh, t);
    for (int t = 0; t < nthr; ++t) phase_rows<T, ROWS>(a, m, sh, t);
    for (int t = 0; t < nthr; ++t) phase_lm_obs(a, m, sh, lane, t, nthr);
    for (int t = 0; t < nthr; ++t) phase_lm_scalars(a, m, sh, t);
    for (int t = 0; t < a.NCOLP; ++t) phase_landmarks(a, m, sh, lane, t);
    for (int t = 0; t < nthr; ++t) phase_row_l<T, ROWS>(a, m, lane, t);
    std::vector<Column<T>> cols;
    std::vector<std::array<T, ROWS>> B(a.NCOLP);
    for (int t = 0; t < a.NCOLP; ++t) {
      cols.push_back(column<T>(a, sh, lane, t));
      load_batch<T, ROWS>(a, m, lane, t, B[t].data());
    }
    const int kk = sh.ticket;
    publish_pivot<T, ROWS>(B[0].data(), input_at(cols[0], a, 0), m.xbuf,
                           m.piv);
    for (int j = 0; j < a.C; ++j) {
      const int p = j & 1;
      for (int t = 0; t < a.NCOLP; ++t)
        step<T, ROWS>(a, cols[t], B[t].data(), j, input_at(cols[t], a, j),
                      m.xbuf + p * ROWS, m.piv + 4 * p,
                      input_at(cols[t], a, j + 1), m.xbuf + (p ^ 1) * ROWS,
                      m.piv + 4 * (p ^ 1));
    }
    counters[1 + kk] = unsigned(a.C);
  }
  return 0;
}

}  // namespace

extern "C" {

int qr_prior_r(int dtype, const void* const* ptr, const long long* stride,
               void* J_out, void* r_out, void* buf, void* counters, int L,
               int MOBS, int MIMU, int NBM1, int C, int MLM, int NPOS,
               int NCOLP, long long keep_i, double eps, void* stream) {
  (void)stream;
  const int wide = qr_instance(C, NCOLP);
  if (wide < 0 || dtype < 0 || dtype > 1) return -1;
  const QrArgs a = qr_pack(ptr, stride, J_out, r_out, buf, counters, L, MOBS,
                           MIMU, NBM1, C, MLM, NPOS, NCOLP, keep_i, eps);
  for (long long lane = 0; lane < L; ++lane) {
    if (dtype == 0)
      wide ? run_lane<float, true>(a, lane) : run_lane<float, false>(a, lane);
    else
      wide ? run_lane<double, true>(a, lane)
           : run_lane<double, false>(a, lane);
  }
  return 0;
}

}  // extern "C"
