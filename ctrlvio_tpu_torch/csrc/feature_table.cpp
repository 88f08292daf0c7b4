// Native sliding-window feature table + factor packing (the port's copy of
// csrc/feature_table.cpp, same C ABI).
//
// The host data path around the window solver: per-frame track lifecycle,
// parallax keyframe decision, DLT triangulation, window slides, and packing
// of the static-shape reprojection factor arrays. This is the C++
// counterpart of the reference's host-side components FeatureManager /
// VisualOdometry bookkeeping (visual_odometry/feature_manager.cpp,
// visual_odometry.cpp) re-designed for the packed array interface the
// solver consumes (see ctrlvio_tpu_torch/estimator/packing.py and
// features.py, the python implementation it is held to).
//
// Exposed as a C ABI for ctypes; one opaque handle per estimator instance.
// Built at first use by ctrlvio_tpu_torch/estimator/native.py:
//   g++ -O2 -std=c++17 -shared -fPIC feature_table.cpp -o libfeature_table-<hash>.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <list>
#include <vector>

namespace {

struct Obs {
  double x, y, row;
};

struct Track {
  int64_t id;
  int start_frame;
  double depth = -1.0;
  bool solve_ok = false;
  std::vector<Obs> obs;
  int end_frame() const { return start_frame + (int)obs.size() - 1; }
};

struct Mat3 {
  double m[9];
  // y = M^T x
  void mulT(const double* x, double* y) const {
    y[0] = m[0] * x[0] + m[3] * x[1] + m[6] * x[2];
    y[1] = m[1] * x[0] + m[4] * x[1] + m[7] * x[2];
    y[2] = m[2] * x[0] + m[5] * x[1] + m[8] * x[2];
  }
  void mul(const double* x, double* y) const {
    y[0] = m[0] * x[0] + m[1] * x[1] + m[2] * x[2];
    y[1] = m[3] * x[0] + m[4] * x[1] + m[5] * x[2];
    y[2] = m[6] * x[0] + m[7] * x[1] + m[8] * x[2];
  }
};

// Smallest right-singular vector of A (n x 4) via Jacobi eigendecomposition
// of B = A^T A (4x4 symmetric).
void min_singular_vec4(const std::vector<double>& A, int n, double* v_out) {
  double B[16] = {0};
  for (int r = 0; r < n; ++r) {
    const double* a = &A[4 * r];
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) B[4 * i + j] += a[i] * a[j];
  }
  double V[16] = {1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1};
  for (int sweep = 0; sweep < 30; ++sweep) {
    double off = 0;
    for (int p = 0; p < 4; ++p)
      for (int q = p + 1; q < 4; ++q) off += B[4 * p + q] * B[4 * p + q];
    if (off < 1e-24) break;
    for (int p = 0; p < 4; ++p) {
      for (int q = p + 1; q < 4; ++q) {
        double apq = B[4 * p + q];
        if (std::fabs(apq) < 1e-30) continue;
        double app = B[4 * p + p], aqq = B[4 * q + q];
        double theta = 0.5 * (aqq - app) / apq;
        double t = (theta >= 0 ? 1.0 : -1.0) /
                   (std::fabs(theta) + std::sqrt(1.0 + theta * theta));
        double c = 1.0 / std::sqrt(1.0 + t * t), s = t * c;
        for (int k = 0; k < 4; ++k) {
          double bkp = B[4 * k + p], bkq = B[4 * k + q];
          B[4 * k + p] = c * bkp - s * bkq;
          B[4 * k + q] = s * bkp + c * bkq;
        }
        for (int k = 0; k < 4; ++k) {
          double bpk = B[4 * p + k], bqk = B[4 * q + k];
          B[4 * p + k] = c * bpk - s * bqk;
          B[4 * q + k] = s * bpk + c * bqk;
        }
        for (int k = 0; k < 4; ++k) {
          double vkp = V[4 * k + p], vkq = V[4 * k + q];
          V[4 * k + p] = c * vkp - s * vkq;
          V[4 * k + q] = s * vkp + c * vkq;
        }
      }
    }
  }
  int best = 0;
  double bmin = B[0];
  for (int i = 1; i < 4; ++i)
    if (B[4 * i + i] < bmin) { bmin = B[4 * i + i]; best = i; }
  for (int k = 0; k < 4; ++k) v_out[k] = V[4 * k + best];
}

struct FeatureTable {
  int window_size;  // WINDOW_SIZE (frames - 1)
  double min_parallax;
  double init_depth = 5.0;
  // insertion-ordered track store (≙ the reference's std::list semantics)
  std::list<Track> track_list;
  std::unordered_map<int64_t, std::list<Track>::iterator> index;
  int last_track_num = 0;
  std::vector<Track*> last_candidates;

  bool add_frame(int frame_count, int n, const int64_t* ids,
                 const double* pts, const double* rows) {
    last_track_num = 0;
    for (int k = 0; k < n; ++k) {
      auto it = index.find(ids[k]);
      if (it == index.end()) {
        Track t;
        t.id = ids[k];
        t.start_frame = frame_count;
        t.obs.push_back({pts[2 * k], pts[2 * k + 1], rows[k]});
        track_list.push_back(std::move(t));
        index.emplace(ids[k], std::prev(track_list.end()));
      } else if (it->second->end_frame() == frame_count - 1) {
        it->second->obs.push_back({pts[2 * k], pts[2 * k + 1], rows[k]});
        last_track_num++;
      }  // non-contiguous re-observation: dropped (tracker ids never resume)
    }
    if (frame_count < 2 || last_track_num < 20) return true;
    double psum = 0;
    int pnum = 0;
    for (auto& t : track_list) {
      if (t.start_frame <= frame_count - 2 && t.end_frame() >= frame_count - 1) {
        const Obs& a = t.obs[frame_count - 2 - t.start_frame];
        const Obs& b = t.obs[frame_count - 1 - t.start_frame];
        psum += std::hypot(a.x - b.x, a.y - b.y);
        pnum++;
      }
    }
    if (pnum == 0) return true;
    return psum / pnum >= min_parallax;
  }

  bool is_candidate(const Track& t) const {
    return (int)t.obs.size() >= 2 && t.start_frame < window_size - 2;
  }

  // Pack reprojection pair factors (mirrors packing.pack_image_factors).
  // Returns number of factors written; fills dinv (LM) and slot count.
  int pack(const int64_t* kf_t_ns, int64_t dt_ns, int64_t win_knot0, int OBS,
           int LM, int32_t* i0_i, float* f_i, float* row_i, float* pt_i,
           int32_t* i0_j, float* f_j, float* row_j, float* pt_j,
           int32_t* lm_idx, uint8_t* valid, uint8_t* marg_drop, float* dinv,
           int* n_candidates) {
    last_candidates.clear();
    for (auto& t : track_list)
      if (is_candidate(t)) last_candidates.push_back(&t);
    // report the UNtruncated count via *n_candidates so the caller can
    // fail loudly on landmark-capacity overflow (the reference holds
    // NUM_OF_F = 2000 slots, parameters.h:10); only LM slots are packed.
    *n_candidates = (int)last_candidates.size();
    if ((int)last_candidates.size() > LM) last_candidates.resize(LM);

    std::memset(valid, 0, OBS);
    std::memset(marg_drop, 0, OBS);
    int nfac = 0;
    for (int slot = 0; slot < (int)last_candidates.size(); ++slot) {
      Track& t = *last_candidates[slot];
      dinv[slot] = t.depth > 0 ? (float)(1.0 / t.depth) : 0.2f;
      bool marg = (t.start_frame == 0 && t.depth > 0);
      int fi = t.start_frame;
      int64_t ti = kf_t_ns[fi];
      int32_t gi = (int32_t)(ti / dt_ns - win_knot0);
      float ffi = (float)((double)(ti % dt_ns) / (double)dt_ns);
      for (size_t k = 1; k < t.obs.size(); ++k) {
        if (nfac >= OBS) return nfac;
        int j = fi + (int)k;
        int64_t tj = kf_t_ns[j];
        i0_i[nfac] = gi;
        f_i[nfac] = ffi;
        row_i[nfac] = (float)t.obs[0].row;
        pt_i[3 * nfac] = (float)t.obs[0].x;
        pt_i[3 * nfac + 1] = (float)t.obs[0].y;
        pt_i[3 * nfac + 2] = 1.0f;
        i0_j[nfac] = (int32_t)(tj / dt_ns - win_knot0);
        f_j[nfac] = (float)((double)(tj % dt_ns) / (double)dt_ns);
        row_j[nfac] = (float)t.obs[k].row;
        pt_j[3 * nfac] = (float)t.obs[k].x;
        pt_j[3 * nfac + 1] = (float)t.obs[k].y;
        pt_j[3 * nfac + 2] = 1.0f;
        lm_idx[nfac] = slot;
        valid[nfac] = 1;
        marg_drop[nfac] = marg ? 1 : 0;
        nfac++;
      }
    }
    return nfac;
  }

  void set_depths(const float* dinv) {
    for (int slot = 0; slot < (int)last_candidates.size(); ++slot) {
      Track& t = *last_candidates[slot];
      double d = dinv[slot] != 0 ? 1.0 / dinv[slot] : -1.0;
      t.depth = d;
      t.solve_ok = d > 0;
    }
  }

  // Current candidate ids in pack slot order, recomputed fresh (the cached
  // last_candidates pointers can dangle after slides). Used by the
  // streaming pipeline to key lagged depth write-backs by feature id.
  int slot_fids(int64_t* out, int cap) {
    int n = 0;
    for (auto& t : track_list) {
      if (!is_candidate(t)) continue;
      if (n >= cap) break;
      out[n++] = t.id;
    }
    return n;
  }

  // Fid-keyed depth write-back (≙ set_depths but safe against slot
  // reordering between the solve dispatch and the lagged consumption).
  void set_depths_by_id(int n, const int64_t* ids, const float* dinv) {
    for (int k = 0; k < n; ++k) {
      auto it = index.find(ids[k]);
      if (it == index.end()) continue;
      double d = dinv[k] != 0 ? 1.0 / dinv[k] : -1.0;
      it->second->depth = d;
      it->second->solve_ok = d > 0;
    }
  }

  // Multi-view DLT for candidate tracks without depth; cam_R: (F, 9) row
  // major world rotations (camera-to-world), cam_p: (F, 3).
  void triangulate(int F, const double* cam_R, const double* cam_p) {
    std::vector<double> A;
    for (auto& t : track_list) {
      if (!is_candidate(t) || t.depth > 0) continue;
      int i = t.start_frame;
      Mat3 R0;
      std::memcpy(R0.m, &cam_R[9 * i], sizeof(R0.m));
      const double* t0 = &cam_p[3 * i];
      A.clear();
      for (size_t k = 0; k < t.obs.size(); ++k) {
        int j = i + (int)k;
        if (j >= F) break;
        Mat3 Rj;
        std::memcpy(Rj.m, &cam_R[9 * j], sizeof(Rj.m));
        const double* tj = &cam_p[3 * j];
        // R = R0^T Rj, tt = R0^T (tj - t0); P = [R^T | -R^T tt]
        double d[3] = {tj[0] - t0[0], tj[1] - t0[1], tj[2] - t0[2]};
        double tt[3];
        R0.mulT(d, tt);
        double R[9];  // R0^T * Rj
        for (int r = 0; r < 3; ++r)
          for (int c = 0; c < 3; ++c)
            R[3 * r + c] = R0.m[r] * Rj.m[c] + R0.m[3 + r] * Rj.m[3 + c] +
                           R0.m[6 + r] * Rj.m[6 + c];
        // P rows: P[r][c] = R^T[r][c] = R[c][r]; P[r][3] = -(R^T tt)[r]
        double Pt[3];
        Pt[0] = -(R[0] * tt[0] + R[3] * tt[1] + R[6] * tt[2]);
        Pt[1] = -(R[1] * tt[0] + R[4] * tt[1] + R[7] * tt[2]);
        Pt[2] = -(R[2] * tt[0] + R[5] * tt[1] + R[8] * tt[2]);
        double f[3] = {t.obs[k].x, t.obs[k].y, 1.0};
        double fn = std::sqrt(f[0] * f[0] + f[1] * f[1] + 1.0);
        f[0] /= fn; f[1] /= fn; f[2] = 1.0 / fn;
        // rows: f0*P2 - f2*P0 ; f1*P2 - f2*P1   (P0 row r=0 ...)
        double P0[4] = {R[0], R[3], R[6], Pt[0]};
        double P1[4] = {R[1], R[4], R[7], Pt[1]};
        double P2[4] = {R[2], R[5], R[8], Pt[2]};
        for (int c = 0; c < 4; ++c) A.push_back(f[0] * P2[c] - f[2] * P0[c]);
        for (int c = 0; c < 4; ++c) A.push_back(f[1] * P2[c] - f[2] * P1[c]);
      }
      int nrows = (int)A.size() / 4;
      if (nrows < 4) continue;
      double v[4];
      min_singular_vec4(A, nrows, v);
      double depth = (std::fabs(v[3]) > 1e-12) ? v[2] / v[3] : -1.0;
      t.depth = depth >= 0.1 ? depth : init_depth;
    }
  }

  void slide_old(const double* marg_R, const double* marg_p,
                 const double* new_R, const double* new_p) {
    Mat3 Rm, Rn;
    std::memcpy(Rm.m, marg_R, sizeof(Rm.m));
    std::memcpy(Rn.m, new_R, sizeof(Rn.m));
    for (auto it = track_list.begin(); it != track_list.end();) {
      Track& t = *it;
      if (t.start_frame != 0) {
        t.start_frame--;
        ++it;
        continue;
      }
      Obs uv = t.obs.front();
      t.obs.erase(t.obs.begin());
      if ((int)t.obs.size() < 2) {
        index.erase(t.id);
        it = track_list.erase(it);
        continue;
      }
      if (t.depth > 0) {
        double pc[3] = {uv.x * t.depth, uv.y * t.depth, t.depth};
        double w[3], wp[3], rel[3], pj[3];
        Rm.mul(pc, w);
        wp[0] = w[0] + marg_p[0]; wp[1] = w[1] + marg_p[1]; wp[2] = w[2] + marg_p[2];
        rel[0] = wp[0] - new_p[0]; rel[1] = wp[1] - new_p[1]; rel[2] = wp[2] - new_p[2];
        Rn.mulT(rel, pj);
        t.depth = pj[2] > 0 ? pj[2] : init_depth;
      }
      ++it;
    }
  }

  void slide_second_new(int frame_count) {
    for (auto it = track_list.begin(); it != track_list.end();) {
      Track& t = *it;
      if (t.start_frame == frame_count) {
        t.start_frame--;
        ++it;
        continue;
      }
      if (t.end_frame() < frame_count - 1) {
        ++it;
        continue;
      }
      int j = frame_count - 1 - t.start_frame;
      t.obs.erase(t.obs.begin() + j);
      if (t.obs.empty()) { index.erase(t.id); it = track_list.erase(it); }
      else ++it;
    }
  }

  void remove_failures() {
    for (auto it = track_list.begin(); it != track_list.end();) {
      Track& t = *it;
      if (is_candidate(t) && t.depth < 0 && !t.solve_ok) {
        index.erase(t.id);
        it = track_list.erase(it);
      } else {
        ++it;
      }
    }
  }
};

}  // namespace

extern "C" {

void* ft_create(int window_size, double min_parallax) {
  auto* ft = new FeatureTable();
  ft->window_size = window_size;
  ft->min_parallax = min_parallax;
  return ft;
}

void ft_destroy(void* h) { delete (FeatureTable*)h; }

int ft_add_frame(void* h, int frame_count, int n, const int64_t* ids,
                 const double* pts, const double* rows) {
  return ((FeatureTable*)h)->add_frame(frame_count, n, ids, pts, rows) ? 1 : 0;
}

int ft_pack(void* h, const int64_t* kf_t_ns, int64_t dt_ns, int64_t win_knot0,
            int OBS, int LM, int32_t* i0_i, float* f_i, float* row_i,
            float* pt_i, int32_t* i0_j, float* f_j, float* row_j, float* pt_j,
            int32_t* lm_idx, uint8_t* valid, uint8_t* marg_drop, float* dinv,
            int* n_candidates) {
  return ((FeatureTable*)h)
      ->pack(kf_t_ns, dt_ns, win_knot0, OBS, LM, i0_i, f_i, row_i, pt_i, i0_j,
             f_j, row_j, pt_j, lm_idx, valid, marg_drop, dinv, n_candidates);
}

void ft_set_depths(void* h, const float* dinv) {
  ((FeatureTable*)h)->set_depths(dinv);
}

void ft_triangulate(void* h, int F, const double* cam_R, const double* cam_p) {
  ((FeatureTable*)h)->triangulate(F, cam_R, cam_p);
}

void ft_slide_old(void* h, const double* marg_R, const double* marg_p,
                  const double* new_R, const double* new_p) {
  ((FeatureTable*)h)->slide_old(marg_R, marg_p, new_R, new_p);
}

void ft_slide_second_new(void* h, int frame_count) {
  ((FeatureTable*)h)->slide_second_new(frame_count);
}

void ft_remove_failures(void* h) { ((FeatureTable*)h)->remove_failures(); }

int ft_slot_fids(void* h, int64_t* out, int cap) {
  return ((FeatureTable*)h)->slot_fids(out, cap);
}

void ft_set_depths_by_id(void* h, int n, const int64_t* ids,
                         const float* dinv) {
  ((FeatureTable*)h)->set_depths_by_id(n, ids, dinv);
}

int ft_num_tracks(void* h) { return (int)((FeatureTable*)h)->track_list.size(); }

int ft_last_track_num(void* h) { return ((FeatureTable*)h)->last_track_num; }

}  // extern "C"
