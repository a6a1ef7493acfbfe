// Native median-split / binned-SAH BVH builder + octant threading links.
//
// A copy of the JAX package's runtime/bvh_builder.cpp, unchanged below
// this comment. The NumPy builder in ops/bvh.py is the semantic
// reference; this is the default builder of build_bvh and Scene.build
// where g++ is found (native=False opts out), loaded through ctypes by
// runtime/native.py. Built without FMA contraction, its median and
// binned-SAH builds produce arrays identical to the NumPy builder's
// (tests/test_torch_native.py).
//
// Algorithm parity with ops/bvh.py build_bvh():
//   * split axis cycles with depth (axis = depth % 3)
//   * split position = exact median of centroids (odd: middle element;
//     even: mean of the two middle)
//   * stable partition (keeps leaf contents deterministic)
//   * degenerate split -> forced stable-sort halving (leaf size bound)
//   * per-octant entry/skip threading links, near child first
//
// Build (runtime/native.py does it at first use):
//   g++ -O3 -std=c++17 -fPIC -shared -ffp-contract=off bvh_builder.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct Builder {
  std::vector<double> cxs, cys, czs;  // centroid storage, SoA per axis
  const double* cx;
  const double* cy;
  const double* cz;
  const double* tmin;  // [T*3] per-tri AABB min
  const double* tmax;  // [T*3]
  std::vector<double> tmin_store, tmax_store;
  int64_t T;
  int leaf_size;

  std::vector<int64_t> order;
  std::vector<double> bbmin, bbmax;   // [N*3]
  std::vector<int64_t> left, first, count, axis;
  int64_t nodes_used = 0;

  const double* cen(int ax) const { return ax == 0 ? cx : (ax == 1 ? cy : cz); }

  void node_bounds(int64_t n) {
    double mn[3] = {1e300, 1e300, 1e300};
    double mx[3] = {-1e300, -1e300, -1e300};
    for (int64_t i = first[n]; i < first[n] + count[n]; ++i) {
      const int64_t t = order[i];
      for (int k = 0; k < 3; ++k) {
        mn[k] = std::min(mn[k], tmin[t * 3 + k]);
        mx[k] = std::max(mx[k], tmax[t * 3 + k]);
      }
    }
    for (int k = 0; k < 3; ++k) {
      bbmin[n * 3 + k] = mn[k];
      bbmax[n * 3 + k] = mx[k];
    }
  }

  double median_of(std::vector<double>& a) {
    const size_t n = a.size();
    const size_t mid = n / 2;
    if (n % 2 == 1) {
      std::nth_element(a.begin(), a.begin() + mid, a.end());
      return a[mid];
    }
    std::nth_element(a.begin(), a.begin() + mid, a.end());
    const double hi = a[mid];
    std::nth_element(a.begin(), a.begin() + (mid - 1), a.begin() + mid);
    const double lo = a[mid - 1];
    return 0.5 * (lo + hi);
  }

  // Binned SAH split (16 bins, all axes). Mirrors ops/bvh.py _sah_split:
  // returns true + fills (axis, per-tri left flag via bin threshold) when
  // a split beats the leaf cost.
  bool use_sah = false;

  bool sah_split(int64_t lo, int64_t cnt, int& out_axis,
                 std::vector<uint8_t>& left_flag) {
    constexpr int NB = 16;
    double best_cost = static_cast<double>(cnt);
    int best_axis = -1;
    int best_bin = -1;
    double best_clo = 0, best_scale = 0;

    double nmn[3] = {1e300, 1e300, 1e300};
    double nmx[3] = {-1e300, -1e300, -1e300};
    for (int64_t i = lo; i < lo + cnt; ++i) {
      const int64_t t = order[i];
      for (int k = 0; k < 3; ++k) {
        nmn[k] = std::min(nmn[k], tmin[t * 3 + k]);
        nmx[k] = std::max(nmx[k], tmax[t * 3 + k]);
      }
    }
    const double ex = nmx[0] - nmn[0], ey = nmx[1] - nmn[1],
                 ez = nmx[2] - nmn[2];
    const double node_sa = 2.0 * (ex * ey + ey * ez + ez * ex);
    if (node_sa <= 0) return false;

    for (int ax = 0; ax < 3; ++ax) {
      const double* cp = cen(ax);
      double clo = 1e300, chi = -1e300;
      for (int64_t i = lo; i < lo + cnt; ++i) {
        clo = std::min(clo, cp[order[i]]);
        chi = std::max(chi, cp[order[i]]);
      }
      if (chi - clo < 1e-12) continue;
      const double scale = NB * (1.0 - 1e-7) / (chi - clo);

      int64_t counts[NB] = {0};
      double bmn[NB][3], bmx[NB][3];
      for (int b = 0; b < NB; ++b)
        for (int k = 0; k < 3; ++k) {
          bmn[b][k] = 1e300;
          bmx[b][k] = -1e300;
        }
      for (int64_t i = lo; i < lo + cnt; ++i) {
        const int64_t t = order[i];
        int b = static_cast<int>((cp[t] - clo) * scale);
        b = std::min(b, NB - 1);
        counts[b]++;
        for (int k = 0; k < 3; ++k) {
          bmn[b][k] = std::min(bmn[b][k], tmin[t * 3 + k]);
          bmx[b][k] = std::max(bmx[b][k], tmax[t * 3 + k]);
        }
      }
      double sa_l[NB], sa_r[NB];
      int64_t cnt_l[NB], cnt_r[NB];
      double rmn[3] = {1e300, 1e300, 1e300}, rmx[3] = {-1e300, -1e300, -1e300};
      int64_t run = 0;
      for (int b = 0; b < NB; ++b) {
        for (int k = 0; k < 3; ++k) {
          rmn[k] = std::min(rmn[k], bmn[b][k]);
          rmx[k] = std::max(rmx[k], bmx[b][k]);
        }
        run += counts[b];
        const double dx = std::max(rmx[0] - rmn[0], 0.0),
                     dy = std::max(rmx[1] - rmn[1], 0.0),
                     dz = std::max(rmx[2] - rmn[2], 0.0);
        sa_l[b] = 2.0 * (dx * dy + dy * dz + dz * dx);
        cnt_l[b] = run;
      }
      for (int k = 0; k < 3; ++k) {
        rmn[k] = 1e300;
        rmx[k] = -1e300;
      }
      run = 0;
      for (int b = NB - 1; b >= 0; --b) {
        for (int k = 0; k < 3; ++k) {
          rmn[k] = std::min(rmn[k], bmn[b][k]);
          rmx[k] = std::max(rmx[k], bmx[b][k]);
        }
        run += counts[b];
        const double dx = std::max(rmx[0] - rmn[0], 0.0),
                     dy = std::max(rmx[1] - rmn[1], 0.0),
                     dz = std::max(rmx[2] - rmn[2], 0.0);
        sa_r[b] = 2.0 * (dx * dy + dy * dz + dz * dx);
        cnt_r[b] = run;
      }
      for (int b = 0; b < NB - 1; ++b) {
        if (cnt_l[b] == 0 || cnt_r[b + 1] == 0) continue;
        const double cost =
            0.125 + (sa_l[b] * cnt_l[b] + sa_r[b + 1] * cnt_r[b + 1]) / node_sa;
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = ax;
          best_bin = b;
          best_clo = clo;
          best_scale = scale;
        }
      }
    }
    if (best_axis < 0) return false;
    const double* cp = cen(best_axis);
    left_flag.resize(cnt);
    for (int64_t i = 0; i < cnt; ++i) {
      int b = static_cast<int>((cp[order[lo + i]] - best_clo) * best_scale);
      b = std::min(b, 15);
      left_flag[i] = b <= best_bin ? 1 : 0;
    }
    out_axis = best_axis;
    return true;
  }

  void build() {
    order.resize(T);
    std::iota(order.begin(), order.end(), 0);
    const int64_t max_nodes = T > 1 ? 2 * T - 1 : 1;
    bbmin.assign(max_nodes * 3, 0.0);
    bbmax.assign(max_nodes * 3, 0.0);
    left.assign(max_nodes, -1);
    first.assign(max_nodes, 0);
    count.assign(max_nodes, 0);
    axis.assign(max_nodes, 0);

    nodes_used = 1;
    first[0] = 0;
    count[0] = T;
    node_bounds(0);

    std::vector<std::pair<int64_t, int64_t>> stack;  // (node, depth)
    stack.emplace_back(0, 1);
    std::vector<double> pts;
    std::vector<int64_t> lo_buf, hi_buf;

    std::vector<uint8_t> left_flag;
    while (!stack.empty()) {
      auto [n, depth] = stack.back();
      stack.pop_back();
      const int64_t cnt = count[n];
      if (cnt <= leaf_size) continue;

      int ax = static_cast<int>(depth % 3);
      const int64_t lo = first[n], hi = lo + cnt;

      bool have_mask = false;
      if (use_sah) {
        have_mask = sah_split(lo, cnt, ax, left_flag);
      }

      lo_buf.clear();
      hi_buf.clear();
      if (have_mask) {
        for (int64_t i = 0; i < cnt; ++i) {
          if (left_flag[i]) lo_buf.push_back(order[lo + i]);
          else hi_buf.push_back(order[lo + i]);
        }
      } else {
        const double* cp = cen(ax);
        pts.resize(cnt);
        for (int64_t i = 0; i < cnt; ++i) pts[i] = cp[order[lo + i]];
        const double split = median_of(pts);
        for (int64_t i = lo; i < hi; ++i) {
          if (cp[order[i]] < split) lo_buf.push_back(order[i]);
          else hi_buf.push_back(order[i]);
        }
      }
      int64_t n_left = static_cast<int64_t>(lo_buf.size());
      if (n_left == 0 || n_left == cnt) {
        // degenerate: stable sort by centroid, halve
        const double* cp = cen(ax);
        n_left = cnt / 2;
        std::stable_sort(order.begin() + lo, order.begin() + hi,
                         [cp](int64_t a, int64_t b) { return cp[a] < cp[b]; });
      } else {
        std::copy(lo_buf.begin(), lo_buf.end(), order.begin() + lo);
        std::copy(hi_buf.begin(), hi_buf.end(), order.begin() + lo + n_left);
      }

      const int64_t lc = nodes_used;
      const int64_t rc = lc + 1;
      nodes_used += 2;
      first[lc] = lo;
      count[lc] = n_left;
      first[rc] = lo + n_left;
      count[rc] = cnt - n_left;
      left[n] = lc;
      count[n] = 0;
      axis[n] = ax;
      node_bounds(lc);
      node_bounds(rc);
      stack.emplace_back(rc, depth + 1);
      stack.emplace_back(lc, depth + 1);
    }
  }

  void thread_links(int32_t* entry, int32_t* skip) const {
    const int64_t N = nodes_used;
    std::vector<std::pair<int64_t, int32_t>> stack;
    for (int o = 0; o < 8; ++o) {
      const bool neg[3] = {(o & 1) != 0, (o & 2) != 0, (o & 4) != 0};
      int32_t* e = entry + o * N;
      int32_t* s = skip + o * N;
      std::fill(e, e + N, -1);
      stack.clear();
      stack.emplace_back(0, -1);
      while (!stack.empty()) {
        auto [n, skip_target] = stack.back();
        stack.pop_back();
        s[n] = skip_target;
        const int64_t lc = left[n];
        if (lc < 0) continue;
        const int64_t rc = lc + 1;
        int64_t near = lc, far = rc;
        if (neg[axis[n]]) std::swap(near, far);
        e[n] = static_cast<int32_t>(near);
        stack.emplace_back(far, skip_target);
        stack.emplace_back(near, static_cast<int32_t>(far));
      }
    }
  }
};

}  // namespace

extern "C" {

// Phase 1: build; returns number of nodes (call before allocating outputs).
// Handle-based: one builder at a time per handle slot (simple, renders are
// host-sequential).
void* mrt_bvh_build(const double* centroids,  // [T,3] row-major
                    const double* tri_min,    // [T,3]
                    const double* tri_max,    // [T,3]
                    int64_t T, int32_t leaf_size, int32_t use_sah,
                    int64_t* n_nodes_out) {
  auto* b = new Builder();
  b->cxs.resize(T); b->cys.resize(T); b->czs.resize(T);
  for (int64_t i = 0; i < T; ++i) {
    b->cxs[i] = centroids[i * 3 + 0];
    b->cys[i] = centroids[i * 3 + 1];
    b->czs[i] = centroids[i * 3 + 2];
  }
  b->cx = b->cxs.data();
  b->cy = b->cys.data();
  b->cz = b->czs.data();
  // copy: caller buffers may be freed between build and export
  b->tmin_store.assign(tri_min, tri_min + T * 3);
  b->tmax_store.assign(tri_max, tri_max + T * 3);
  b->tmin = b->tmin_store.data();
  b->tmax = b->tmax_store.data();
  b->T = T;
  b->leaf_size = leaf_size;
  b->use_sah = use_sah != 0;
  b->build();
  *n_nodes_out = b->nodes_used;
  return b;
}

// Phase 2: export arrays into caller-allocated buffers, free the builder.
void mrt_bvh_export(void* handle, float* bbmin, float* bbmax, int32_t* left,
                    int32_t* first, int32_t* count, int32_t* axis,
                    int32_t* entry, int32_t* skip, int32_t* order,
                    int32_t* max_leaf_out) {
  auto* b = static_cast<Builder*>(handle);
  const int64_t N = b->nodes_used;
  for (int64_t i = 0; i < N * 3; ++i) {
    bbmin[i] = static_cast<float>(b->bbmin[i]);
    bbmax[i] = static_cast<float>(b->bbmax[i]);
  }
  int64_t ml = 0;
  for (int64_t i = 0; i < N; ++i) {
    left[i] = static_cast<int32_t>(b->left[i]);
    first[i] = static_cast<int32_t>(b->first[i]);
    count[i] = static_cast<int32_t>(b->count[i]);
    axis[i] = static_cast<int32_t>(b->axis[i]);
    ml = std::max(ml, b->count[i]);
  }
  for (int64_t i = 0; i < b->T; ++i) order[i] = static_cast<int32_t>(b->order[i]);
  b->thread_links(entry, skip);
  *max_leaf_out = static_cast<int32_t>(ml > 0 ? ml : 1);
  delete b;
}

}  // extern "C"
