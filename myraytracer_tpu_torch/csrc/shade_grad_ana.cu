// K10 (forward) and K11 (hand-derived reverse) of the differentiable shade
// segment on sphere and plane hits.
//
// Replaces no TPU kernel: the JAX package's fused segment
// (myraytracer_tpu/ops/shade_grad.py, K5/K6 here) takes triangle-only
// scenes, and a scene of spheres and planes replays resolve_hit and
// lighting_from_mask through autodiff. In the port that autograd replay
// gathered small tables by per-ray ids (sphere_center[si], plane_normal[pi],
// mat16[mat_id], ...), so every ray's cotangent went back into a few rows
// through PyTorch's sort-based index backward: 55 of a molecule fit step's
// 58 ms. K10/K11 run one Whitted segment of that replay per thread
// instead, with the semantics and operand order of ops/shade_grad_ana.py's
// plain versions (and so of shade.resolve_hit + tracer.lighting_from_mask):
// the sphere re-solve (disc > 1e-12, t0 > EPS_HIT or else t1) with the
// normal normalize(o + t d - c), the plane re-solve under EPS_PARALLEL with
// the normal n_p, the fp32 re-projection of the point, the material row
// mat16[ana16[row, 8]], Phong under the recorded shadow mask, the Whitted
// blend and the mirror bounce. Each thread reads its ray's ana16 row
// (spheres, then planes) and mat16 row by id.
//
// K11 recomputes the forward in registers and runs the reverse in the
// plain _bwd_core's order. Its table and environment cotangents are sums
// over the rays, taken in a fixed order with no float atomics, so two runs
// (captured or eager) give the same bits. Within a block of 128 rays (in
// 32x32 pixel order they hit few spheres and materials): the environment
// by warp shuffles in lane order, then the warps in order; a table's rows
// by __match_any_sync groups of the lanes that share a row, summed in lane
// order, then the warps in order. Across the blocks:
//   - dense: the environment, and a table whose cotangent columns fit
//     kDenseMax floats (mat16 on every scene the benchmark runs), are
//     one partial a block; the last block of each group of kGroup blocks
//     to finish (an integer counter after a __threadfence) sums its
//     group's partials in block order, and the last group to finish sums
//     the groups' in group order and writes the cotangents whole;
//   - lists: a larger table's block writes a compact list of (row, sum),
//     at most one entry a ray, and that last block streams the lists in
//     block order in windows of 128 entries, the next window's loads in
//     flight, grouping each window per warp in entry order and adding the
//     groups warp by warp.
// A table or environment cotangent that autograd does not ask for is a
// null pointer, and K11 computes none of it.
//
// Bound on the H100: memory latency. K10 reads about 50 B a ray (ray,
// weight, ids, masks) plus its two rows from L2 and writes 40; K11 reads
// those and the 40 B of cotangents and writes up to 28 plus its partials.
// At 250,000 rays that is about 25 MB each way, under 0.01 ms at 3.35
// TB/s; the reduction adds two short rounds of L2 latency (the group and
// the last sums) where its sums are dense, and a few per 128 list
// entries where they are lists.
//
// Built without FMA contraction (kernels/_build.py NO_FMA) and without
// fast math, every expression in the plain version's operand order
// (PyTorch's `0.5 / a` is reciprocal(a) * 0.5), so kernel and plain
// version agree to the bit ray by ray; the sums differ from the plain
// version's index_add_ and sum() only in their order.
#include "common.cuh"

namespace {

constexpr int KIND_SPHERE = 1;
constexpr int KIND_PLANE = 2;
constexpr int KIND_MISS = 0;

constexpr int kThreads = 256;   // K10's block
constexpr int kBwd = 128;       // K11's block: 128 rays, 4 warps
constexpr int kWarps = kBwd / 32;
constexpr int kAnaCols = 7;     // ana16 columns with a cotangent
constexpr int kMatCols = 11;    // mat16 columns with a cotangent
constexpr int kTab = 2048;      // floats of the last block's table pass
constexpr int kLists = 1024;    // lists the last block scans at a time
constexpr int kDenseMax = 1024; // a table's floats a block sums densely
constexpr int kGroup = 32;      // blocks whose dense partials one sums
constexpr float kDiscEps = 1e-12f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float dotv(const float* a, const float* b) {
  return dot3(a[0], a[1], a[2], b[0], b[1], b[2]);
}

// vecmath.normalize's guard and op order: 1 / sqrt(max(n2, eps))
__device__ __forceinline__ float inv_norm(float n2, bool* ok) {
  *ok = n2 > MRT_EPS_NORMALIZE;
  return *ok ? 1.0f / sqrtf(fmaxf(n2, MRT_EPS_NORMALIZE)) : 0.0f;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Forward state of one ray, everything the reverse reads.
struct Seg {
  float o[3], d[3], w;
  bool is_s, is_p, valid, h, miss;
  int arow, mid;
  float c[3], nx[3], rad;
  // sphere
  float oc[3], b, a, cq, sq, inv2a, t, v[3], invv;
  bool pos, use0, okv;
  // plane
  float den, num, q[3], dd;
  bool okp;
  float nrm[3], point[3];
  float kd[3], ka[3], ks[3], shin, mirror;
  float col[3], wf, dn;
};

// One light's forward terms at a shading point.
struct LightTerms {
  float lv[3], invl, ld[3], diff, ln, m[3], invm, r[3], cos_rv, base, spec;
  bool okl, okm, gate;
};

__device__ __forceinline__ void light_terms(const Seg& s, const float* lp,
                                            LightTerms& t) {
#pragma unroll
  for (int i = 0; i < 3; ++i) t.lv[i] = __ldg(lp + i) - s.point[i];
  t.invl = inv_norm(dotv(t.lv, t.lv), &t.okl);
#pragma unroll
  for (int i = 0; i < 3; ++i) t.ld[i] = t.lv[i] * t.invl;
  t.diff = nmax(dotv(s.nrm, t.ld), 0.0f);
  t.ln = dotv(t.ld, s.nrm);
#pragma unroll
  for (int i = 0; i < 3; ++i) t.m[i] = 2.0f * t.ln * s.nrm[i] - t.ld[i];
  t.invm = inv_norm(dotv(t.m, t.m), &t.okm);
#pragma unroll
  for (int i = 0; i < 3; ++i) t.r[i] = t.m[i] * t.invm;
  t.cos_rv = nmax(dot3(t.r[0], t.r[1], t.r[2], -s.d[0], -s.d[1], -s.d[2]),
                  0.0f);
  t.gate = (t.diff > 0.0f) && (t.cos_rv > 0.0f);
  t.base = t.gate ? t.cos_rv : 1.0f;
  t.spec = t.gate ? powf(t.base, s.shin) : 0.0f;
}

// Loads ray r with its rows and runs the forward (_fwd_core) up to the
// blend; the outputs follow from the returned state.
__device__ __forceinline__ void seg_forward(
    int r, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ w, const float* __restrict__ ana16,
    const float* __restrict__ mat16, const int* __restrict__ kind,
    const int* __restrict__ idx, const bool* __restrict__ h,
    const bool* __restrict__ miss, const bool* __restrict__ shadow,
    const float* __restrict__ lp, const float* __restrict__ lc,
    const float* __restrict__ amb, int S, int P, int L, int R, Seg& s) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.o[i] = o[3 * r + i];
    s.d[i] = d[3 * r + i];
  }
  s.w = w[r];
  const int k = kind[r];
  s.is_s = k == KIND_SPHERE;
  s.is_p = k == KIND_PLANE;
  s.valid = k != KIND_MISS;
  s.h = h[r];
  s.miss = miss[r];
  const int ix = idx[r];
  s.arow = (s.is_s && S > 0) ? clampi(ix, 0, S - 1)
           : (s.is_p && P > 0) ? S + clampi(ix, 0, P - 1) : 0;
  const float* ar = ana16 + static_cast<long>(s.arow) * 16;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.c[i] = ar[i];
    s.nx[i] = ar[3 + i];
  }
  s.rad = ar[6];
  s.mid = s.valid ? static_cast<int>(ar[8]) : 0;

  if (s.is_s) {
    // shade.ray_t_sphere, then normalize(o + t d - c)
#pragma unroll
    for (int i = 0; i < 3; ++i) s.oc[i] = s.o[i] - s.c[i];
    s.b = 2.0f * dotv(s.oc, s.d);
    s.a = dotv(s.d, s.d);
    s.cq = dotv(s.oc, s.oc) - s.rad * s.rad;
    const float disc = s.b * s.b - 4.0f * s.a * s.cq;
    s.pos = disc > kDiscEps;
    s.sq = s.pos ? sqrtf(disc) : 0.0f;
    s.inv2a = (1.0f / s.a) * 0.5f;
    const float t0 = (-s.b - s.sq) * s.inv2a;
    const float t1 = (-s.b + s.sq) * s.inv2a;
    s.use0 = t0 > MRT_EPS_HIT;
    s.t = s.use0 ? t0 : t1;
#pragma unroll
    for (int i = 0; i < 3; ++i) s.v[i] = s.o[i] + s.t * s.d[i] - s.c[i];
    s.invv = inv_norm(dotv(s.v, s.v), &s.okv);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s.nrm[i] = s.v[i] * s.invv;
      s.point[i] = s.c[i] + s.rad * s.nrm[i];
    }
  } else if (s.is_p) {
    const float den0 = dotv(s.nx, s.d);
    s.okp = fabsf(den0) > MRT_EPS_PARALLEL;
    s.den = s.okp ? den0 : 1.0f;
    s.num = dotv(s.nx, s.c) - dotv(s.nx, s.o);
    s.t = s.num / s.den;
    float Pp[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      Pp[i] = s.o[i] + s.t * s.d[i];
      s.q[i] = Pp[i] - s.c[i];
    }
    s.dd = dotv(s.nx, s.q);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s.point[i] = Pp[i] - s.dd * s.nx[i];
      s.nrm[i] = s.nx[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s.nrm[i] = 0.0f;
      s.point[i] = s.o[i];
    }
  }

  const float* mr = mat16 + static_cast<long>(s.mid) * 16;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.kd[i] = mr[i];
    s.ka[i] = mr[3 + i];
    s.ks[i] = mr[6 + i];
  }
  s.shin = mr[9];
  s.mirror = s.valid ? mr[10] : 0.0f;

  // Phong with the fixed shadow mask (tracer.lighting_from_mask): the
  // ambient term plus the sum of the lights' terms
  float lsum[3] = {0.0f, 0.0f, 0.0f};
  for (int li = 0; li < L; ++li) {
    LightTerms t;
    light_terms(s, lp + 3 * li, t);
    const float lit = shadow[static_cast<long>(li) * R + r] ? 0.0f : 1.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float term = __ldg(lc + 3 * li + i) * lit *
                         (s.kd[i] * t.diff + s.ks[i] * t.spec);
      lsum[i] = li == 0 ? term : lsum[i] + term;
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) s.col[i] = __ldg(amb + i) * s.ka[i] + lsum[i];
  s.wf = s.w * (1.0f - s.mirror);
  s.dn = dotv(s.d, s.nrm);
}

__global__ void seg_ana_fwd_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ w, const float* __restrict__ ana16,
    const float* __restrict__ mat16, const int* __restrict__ kind,
    const int* __restrict__ idx, const bool* __restrict__ h,
    const bool* __restrict__ miss, const bool* __restrict__ shadow,
    const float* __restrict__ lp, const float* __restrict__ lc,
    const float* __restrict__ amb, const float* __restrict__ bg, int S,
    int P, int L, int R, float* __restrict__ add, float* __restrict__ o2,
    float* __restrict__ d2, float* __restrict__ w2) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  Seg s;
  seg_forward(r, o, d, w, ana16, mat16, kind, idx, h, miss, shadow, lp, lc,
              amb, S, P, L, R, s);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float refl = s.d[i] - 2.0f * s.dn * s.nrm[i];
    add[3 * r + i] = (s.h ? s.wf * s.col[i] : 0.0f) +
                     (s.miss ? s.w * __ldg(bg + i) : 0.0f);
    o2[3 * r + i] = s.h ? s.point[i] + MRT_EPS_OFFSET * refl : s.o[i];
    d2[3 * r + i] = s.h ? refl : s.d[i];
  }
  w2[r] = s.h ? s.w * s.mirror : 0.0f;
}

// The sum over the warp, in a fixed tree (lane 0 holds it). Every lane of
// the warp must call it.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(kFull, v, off);
  return v;
}

// Adds v, summed over the warp, to this warp's slot s_env[warp * n + k]
// (shared memory; the block's warps are summed in order later). Every lane
// must call it.
__device__ __forceinline__ void warp_put(float* s_env, int n, int k,
                                         float v) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) {
    float* slot = s_env + (threadIdx.x >> 5) * n + k;
    *slot = *slot + v;
  }
}

// Sums each group of lanes with the same key >= 0 (the lanes of `peers`)
// into the row of the group's first lane, column by column in lane order.
// rows: the warp's rows of C floats in shared memory. Every lane must call
// it; returns whether this lane leads its group.
template <int C>
__device__ __forceinline__ bool warp_groups(float* rows, int key) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  const unsigned peers = __match_any_sync(kFull, key);
  const bool lead = key >= 0 && lane == __ffs(peers) - 1;
  unsigned leaders = __ballot_sync(kFull, lead);
  while (leaders) {
    const int ld = __ffs(leaders) - 1;
    leaders &= leaders - 1;
    const unsigned grp = __shfl_sync(kFull, peers, ld);
    if (lane < C && (grp & (grp - 1))) {
      float sum = rows[(__ffs(grp) - 1) * C + lane];
      for (unsigned m = grp & (grp - 1); m; m &= m - 1)
        sum = sum + rows[(__ffs(m) - 1) * C + lane];
      rows[ld * C + lane] = sum;
    }
    __syncwarp();
  }
  return lead;
}

// The block exclusive scan of x; *total gets the block's sum. Every thread
// must call it. s_small: kWarps ints of shared memory.
__device__ __forceinline__ int block_scan(int x, int* s_small, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) s_small[warp] = inc;
  __syncthreads();
  int base = 0, sum = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    base += k < warp ? s_small[k] : 0;
    sum += s_small[k];
  }
  __syncthreads();
  *total = sum;
  return base + inc - x;
}

// The block's compact list of one table's row cotangents: each key >= 0
// (a row) once, with the sum of the rows of the block's rays that carry
// it (in lane order within a warp, then in warp order), at slot `slot` of
// block b (cnt[b] entries). Every thread must call it.
template <int C>
__device__ void block_list(int key, const float* val, float* s_rows,
                           int* s_key, int* s_small, int b,
                           int* __restrict__ cnt, int* __restrict__ ids,
                           float* __restrict__ vals) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int c = 0; c < C; ++c) s_rows[tid * C + c] = val[c];
  s_key[tid] = key;
  const bool wlead = warp_groups<C>(s_rows + (tid - lane) * C, key);
  __syncthreads();
  // a warp's leader leads the block's entry of its key unless an earlier
  // warp holds the key; the entry adds the later warps' sums in order
  bool blead = wlead;
  for (int j = 0; blead && j < warp * 32; ++j) blead = s_key[j] != key;
  float sum[C];
  if (blead) {
#pragma unroll
    for (int c = 0; c < C; ++c) sum[c] = s_rows[tid * C + c];
    for (int w2 = warp + 1; w2 < kWarps; ++w2) {
      for (int l = 0; l < 32; ++l) {
        const int j = w2 * 32 + l;
        if (s_key[j] == key) {
#pragma unroll
          for (int c = 0; c < C; ++c) sum[c] = sum[c] + s_rows[j * C + c];
          break;
        }
      }
    }
  }
  int n;
  const int slot = block_scan(blead ? 1 : 0, s_small, &n);
  if (blead) {
    const long at = static_cast<long>(b) * kBwd + slot;
    ids[at] = key;
#pragma unroll
    for (int c = 0; c < C; ++c) vals[at * C + c] = sum[c];
  }
  if (tid == 0) cnt[b] = n;
  __syncthreads();
}

// One entry of a list: its row (-1 past the lists' end) and its values.
template <int C>
struct Entry {
  int id;
  float v[C];
};

// Entry f of the lists whose offsets (exclusive, in list order) s_off
// holds for the lists b0.. of the chunk, total entries in all.
template <int C>
__device__ __forceinline__ Entry<C> load_entry(
    int f, int total, int b0, const int* s_off, const int* ids,
    const float* vals) {
  Entry<C> e;
  e.id = -1;
#pragma unroll
  for (int c = 0; c < C; ++c) e.v[c] = 0.0f;
  if (f < total) {
    // the last list whose offset is <= f holds entry f
    int lo = 0, hi = kLists - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_off[mid] <= f) lo = mid; else hi = mid - 1;
    }
    const long at = static_cast<long>(b0 + lo) * kBwd + (f - s_off[lo]);
    e.id = __ldcg(ids + at);
#pragma unroll
    for (int c = 0; c < C; ++c) e.v[c] = __ldcg(vals + at * C + c);
  }
  return e;
}

// The last block's sum of one table over the blocks' lists (cnt[b]
// entries, b < nb, in block order), written whole into out [N, 16]
// (columns C.. and rows no list names are zero). Rows are taken kTab / C
// at a time through shared memory (s_tab); for each, the lists of kLists
// blocks at a time are scanned into offsets (s_off) and streamed in
// windows of 128 entries, one a thread, the next window's loads in flight
// while one is summed: each window's entries are grouped per warp in
// entry order (warp_groups) and added to s_tab warp by warp, so each row's
// sum takes its entries in block order.
template <int C>
__device__ void final_table(const int* cnt, const int* ids,
                            const float* vals, int nb, int N,
                            float* __restrict__ out, float* s_rows,
                            int* s_small, int* s_off, float* s_tab) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kRows = kTab / C;
  constexpr int kPer = kLists / kBwd;
  for (int row0 = 0; row0 < N; row0 += kRows) {
    const int nrow = min(kRows, N - row0);
    for (int i = tid; i < nrow * C; i += kBwd) s_tab[i] = 0.0f;
    for (int b0 = 0; b0 < nb; b0 += kLists) {
      int cb[kPer], mine = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int bb = b0 + tid * kPer + j;
        cb[j] = bb < nb ? __ldcg(cnt + bb) : 0;
        mine += cb[j];
      }
      int total;
      int off = block_scan(mine, s_small, &total);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        s_off[tid * kPer + j] = off;
        off += cb[j];
      }
      __syncthreads();
      Entry<C> next = load_entry<C>(tid, total, b0, s_off, ids, vals);
      for (int f0 = 0; f0 < total; f0 += kBwd) {
        const Entry<C> e = next;
        next = load_entry<C>(f0 + kBwd + tid, total, b0, s_off, ids, vals);
        const int key =
            e.id >= row0 && e.id < row0 + nrow ? e.id - row0 : -1;
#pragma unroll
        for (int c = 0; c < C; ++c) s_rows[tid * C + c] = e.v[c];
        const bool lead = warp_groups<C>(s_rows + (tid - lane) * C, key);
        for (int w2 = 0; w2 < kWarps; ++w2) {
          if (warp == w2 && lead) {
#pragma unroll
            for (int c = 0; c < C; ++c)
              s_tab[key * C + c] = s_tab[key * C + c] + s_rows[tid * C + c];
          }
          __syncthreads();
        }
      }
      __syncthreads();
    }
    for (int i = tid; i < nrow * 16; i += kBwd) {
      const int rr = i >> 4, c = i & 15;
      out[static_cast<long>(row0 + rr) * 16 + c] =
          c < C ? s_tab[rr * C + c] : 0.0f;
    }
    __syncthreads();
  }
}

// Adds the block's rows (s_rows, C floats a thread; key the row, -1 for
// none) into the dense table s_tab [rows][C] (shared memory): each warp's
// rays of one row summed in lane order (warp_groups), then the warps in
// order. Every thread must call it.
template <int C>
__device__ void block_dense(int key, const float* val, float* s_rows,
                            float* s_tab) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int c = 0; c < C; ++c) s_rows[tid * C + c] = val[c];
  const bool lead = warp_groups<C>(s_rows + (tid - lane) * C, key);
  for (int w2 = 0; w2 < kWarps; ++w2) {
    if (warp == w2 && lead) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        s_tab[key * C + c] = s_tab[key * C + c] + s_rows[tid * C + c];
    }
    __syncthreads();
  }
}

// Which sums K11 takes densely, a partial of every one of its values per
// block (the environment, and a table whose cotangent columns fit
// kDenseMax floats), and where each lies in a block's partial; a larger
// table goes through lists.
struct Dense {
  bool mat, ana;
  int n_env, mat_at, ana_at, width;
};

__host__ __device__ inline Dense dense_layout(int L, int M, int A, bool env,
                                              bool mat, bool ana) {
  Dense dn;
  dn.n_env = env ? 6 * L + 6 : 0;
  dn.mat = mat && static_cast<long>(M) * kMatCols <= kDenseMax;
  dn.ana = ana && static_cast<long>(A) * kAnaCols <= kDenseMax;
  dn.mat_at = dn.n_env;
  dn.ana_at = dn.mat_at + (dn.mat ? M * kMatCols : 0);
  dn.width = dn.ana_at + (dn.ana ? A * kAnaCols : 0);
  return dn;
}

// Where each part of K11's workspace starts, in 4-byte words from its
// base (-1: not used), and its size: the blocks' dense partials, the
// groups' sums of them, and the mat16 and ana16 lists that are not dense
// (up to 128 rows a block).
struct Work {
  long part, group, mat_cnt, mat_ids, mat_vals, ana_cnt, ana_ids, ana_vals,
      words;
};

// The next part of n words at *at if it is used, else -1.
__host__ __device__ inline long take(long* at, bool use, long n) {
  const long start = use ? *at : -1;
  if (use) *at += n;
  return start;
}

__host__ __device__ inline int groups_of(int nb) {
  return (nb + kGroup - 1) / kGroup;
}

__host__ __device__ inline Work work_layout(int nb, const Dense& dn,
                                            bool mat, bool ana) {
  Work wk;
  long at = 0;
  const long cap = static_cast<long>(nb) * kBwd;
  const bool lmat = mat && !dn.mat, lana = ana && !dn.ana;
  wk.part = take(&at, dn.width > 0, static_cast<long>(nb) * dn.width);
  wk.group = take(&at, dn.width > 0,
                  static_cast<long>(groups_of(nb)) * dn.width);
  wk.mat_cnt = take(&at, lmat, nb);
  wk.mat_ids = take(&at, lmat, cap);
  wk.mat_vals = take(&at, lmat, cap * kMatCols);
  wk.ana_cnt = take(&at, lana, nb);
  wk.ana_ids = take(&at, lana, cap);
  wk.ana_vals = take(&at, lana, cap * kAnaCols);
  wk.words = at;
  return wk;
}

// Dynamic shared memory (words): the rays' rows, their keys, kWarps ints,
// then in the main pass the warps' environment slots and the block's
// dense partial, in the last block's pass the offsets and the table of
// the list sums.
__host__ __device__ inline long smem_words(const Dense& dn) {
  const long main = kWarps * static_cast<long>(dn.n_env) + dn.width;
  const long tail = main > kLists + kTab ? main : kLists + kTab;
  return static_cast<long>(kBwd) * kMatCols + kBwd + kWarps + tail;
}

// Sums the dense partials `src` [n][width] over n (in order) into dst
// [width]: the elements spread over the block's threads, each a chain of
// independent loads.
__device__ __forceinline__ void sum_rows(const float* src, int n, int width,
                                         float* dst) {
  for (int e = threadIdx.x; e < width; e += kBwd) {
    float v = __ldcg(src + e);
#pragma unroll 8
    for (int j = 1; j < n; ++j)
      v = v + __ldcg(src + static_cast<long>(j) * width + e);
    dst[e] = v;
  }
}

__global__ void __launch_bounds__(kBwd) seg_ana_bwd_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ w, const float* __restrict__ ana16,
    const float* __restrict__ mat16, const int* __restrict__ kind,
    const int* __restrict__ idx, const bool* __restrict__ h,
    const bool* __restrict__ miss, const bool* __restrict__ shadow,
    const float* __restrict__ lp, const float* __restrict__ lc,
    const float* __restrict__ amb, const float* __restrict__ bg,
    const float* __restrict__ g_add_in, const float* __restrict__ g_o2_in,
    const float* __restrict__ g_d2_in, const float* __restrict__ g_w2_in,
    int S, int P, int A, int M, int L, int R, float* __restrict__ g_o_out,
    float* __restrict__ g_d_out, float* __restrict__ g_w_out,
    float* __restrict__ g_ana_out, float* __restrict__ g_mat_out,
    float* __restrict__ g_env_out, int* __restrict__ work,
    int* __restrict__ done) {
  extern __shared__ float smem[];
  float* s_rows = smem;
  int* s_key = reinterpret_cast<int*>(smem + kBwd * kMatCols);
  int* s_small = s_key + kBwd;
  const bool env = g_env_out != nullptr;
  const Dense dn = dense_layout(L, M, A, env, g_mat_out != nullptr,
                                g_ana_out != nullptr);
  float* s_env = reinterpret_cast<float*>(s_small + kWarps);
  float* s_dense = s_env + kWarps * dn.n_env;
  int* s_off = s_small + kWarps;
  float* s_tab = reinterpret_cast<float*>(s_off + kLists);
  __shared__ int s_flag;

  const int tid = threadIdx.x;
  const int n_env = 6 * L + 6;
  const int nb = gridDim.x;
  const Work wk = work_layout(nb, dn, g_mat_out != nullptr,
                              g_ana_out != nullptr);
  for (int k = tid; k < kWarps * dn.n_env + dn.width; k += kBwd)
    s_env[k] = 0.0f;
  __syncthreads();

  // threads past the end recompute the last ray and add nothing to the
  // sums: every lane takes part in the shuffles and matches
  const int r_in = blockIdx.x * kBwd + tid;
  const bool in = r_in < R;
  const int r = in ? r_in : R - 1;
  Seg s;
  seg_forward(r, o, d, w, ana16, mat16, kind, idx, h, miss, shadow, lp, lc,
              amb, S, P, L, R, s);
  const bool hh = s.h, mf = s.miss;
  float g_add[3], g_o2[3], g_d2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g_add[i] = g_add_in ? g_add_in[3 * r + i] : 0.0f;
    g_o2[i] = g_o2_in ? g_o2_in[3 * r + i] : 0.0f;
    g_d2[i] = g_d2_in ? g_d2_in[3 * r + i] : 0.0f;
  }
  const float g_w2 = g_w2_in ? g_w2_in[r] : 0.0f;

  // bounce reverse
  float g_refl[3], g_point[3], g_o[3], g_d[3], g_nrm[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g_refl[i] = hh ? MRT_EPS_OFFSET * g_o2[i] + g_d2[i] : 0.0f;
    g_point[i] = hh ? g_o2[i] : 0.0f;
    g_o[i] = hh ? 0.0f : g_o2[i];
    g_d[i] = hh ? 0.0f : g_d2[i];
  }
  float g_w = hh ? s.mirror * g_w2 : 0.0f;
  float g_mirror = hh ? s.w * g_w2 : 0.0f;
  const float ngr = dotv(s.nrm, g_refl);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    g_d[i] = g_d[i] + (g_refl[i] - 2.0f * s.nrm[i] * ngr);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    g_nrm[i] = -2.0f * (s.d[i] * ngr + s.dn * g_refl[i]);

  // blend reverse
  float g_col[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) g_col[i] = hh ? s.wf * g_add[i] : 0.0f;
  const float gdotc =
      g_add[0] * s.col[0] + g_add[1] * s.col[1] + g_add[2] * s.col[2];
  g_w = g_w + (hh ? (1.0f - s.mirror) * gdotc : 0.0f);
  g_mirror = g_mirror + (hh ? -s.w * gdotc : 0.0f);
  g_w = g_w + (mf ? g_add[0] * __ldg(bg) + g_add[1] * __ldg(bg + 1) +
                        g_add[2] * __ldg(bg + 2)
                  : 0.0f);
  if (env) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      warp_put(s_env, n_env, 6 * L + 3 + i,
               in && mf ? s.w * g_add[i] : 0.0f);
      warp_put(s_env, n_env, 6 * L + i, in ? g_col[i] * s.ka[i] : 0.0f);
    }
  }

  // lighting reverse
  float g_mat[kMatCols];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g_mat[i] = 0.0f;                                       // kd
    g_mat[3 + i] = g_col[i] * __ldg(amb + i);              // ka
    g_mat[6 + i] = 0.0f;                                   // ks
  }
  float g_shin = 0.0f;
  for (int li = 0; li < L; ++li) {
    LightTerms t;
    light_terms(s, lp + 3 * li, t);
    const float lit = shadow[static_cast<long>(li) * R + r] ? 0.0f : 1.0f;
    float lcv[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) lcv[i] = __ldg(lc + 3 * li + i);
    float g_diff = 0.0f, g_spec = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (env)
        warp_put(s_env, n_env, 3 * L + 3 * li + i,
                 in ? g_col[i] * lit * (s.kd[i] * t.diff + s.ks[i] * t.spec)
                    : 0.0f);
      g_mat[i] = g_mat[i] + g_col[i] * lcv[i] * lit * t.diff;
      g_mat[6 + i] = g_mat[6 + i] + g_col[i] * lcv[i] * lit * t.spec;
      g_diff = g_diff + g_col[i] * lcv[i] * lit * s.kd[i];
      g_spec = g_spec + g_col[i] * lcv[i] * lit * s.ks[i];
    }
    // off the gate base = 1, so pow and log stay finite there; both are
    // also selected away, never multiplied by 0
    const float g_base =
        t.gate ? s.shin * powf(t.base, s.shin - 1.0f) * g_spec : 0.0f;
    g_shin = g_shin + (t.gate ? t.spec * logf(t.base) * g_spec : 0.0f);
    const float rvg = (t.cos_rv > 0.0f && t.gate) ? g_base : 0.0f;
    float g_r[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g_r[i] = rvg * (-s.d[i]);
      g_d[i] = g_d[i] + -rvg * t.r[i];
    }
    // r = normalize(m)
    const float g_invm = g_r[0] * t.m[0] + g_r[1] * t.m[1] + g_r[2] * t.m[2];
    const float g_n2m =
        t.okm ? -0.5f * t.invm * t.invm * t.invm * g_invm : 0.0f;
    float g_m[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      g_m[i] = g_r[i] * t.invm + t.m[i] * (2.0f * g_n2m);
    // m = 2 (ld.n) n - ld
    const float ngm = dotv(s.nrm, g_m);
    float g_ld[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g_ld[i] = 2.0f * ngm * s.nrm[i] - g_m[i];
      g_nrm[i] = g_nrm[i] + 2.0f * (ngm * t.ld[i] + t.ln * g_m[i]);
    }
    // diff = max(0, n.ld)
    const float gd = t.diff > 0.0f ? g_diff : 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g_nrm[i] = g_nrm[i] + gd * t.ld[i];
      g_ld[i] = g_ld[i] + gd * s.nrm[i];
    }
    // ld = normalize(lv), lv = lp - point
    const float g_invl =
        g_ld[0] * t.lv[0] + g_ld[1] * t.lv[1] + g_ld[2] * t.lv[2];
    const float g_n2l =
        t.okl ? -0.5f * t.invl * t.invl * t.invl * g_invl : 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float g_lv = g_ld[i] * t.invl + t.lv[i] * (2.0f * g_n2l);
      g_point[i] = g_point[i] + -g_lv;
      if (env) warp_put(s_env, n_env, 3 * li + i, in ? g_lv : 0.0f);
    }
  }
  g_mat[9] = g_shin;
  g_mat[10] = s.valid ? g_mirror : 0.0f;
  if (!s.valid) {
#pragma unroll
    for (int k = 0; k < 10; ++k) g_mat[k] = 0.0f;
  }

  // geometry reverse, by kind
  float g_ana[kAnaCols];
#pragma unroll
  for (int k = 0; k < kAnaCols; ++k) g_ana[k] = 0.0f;
  float g_og[3], g_dg[3];
  if (s.is_s) {
    // point = c + rad n, n = normalize(v), v = o + t d - c
    float g_ns[3], g_v[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) g_ns[i] = g_nrm[i] + s.rad * g_point[i];
    float g_rad = dotv(s.nrm, g_point);
    const float g_invv = g_ns[0] * s.v[0] + g_ns[1] * s.v[1] + g_ns[2] * s.v[2];
    const float g_n2v =
        s.okv ? -0.5f * s.invv * s.invv * s.invv * g_invv : 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g_v[i] = g_ns[i] * s.invv + s.v[i] * (2.0f * g_n2v);
      g_og[i] = g_v[i];
      g_dg[i] = s.t * g_v[i];
      g_ana[i] = g_point[i] - g_v[i];
    }
    const float g_ts = dotv(s.d, g_v);
    // t = (-b -+ sq) * inv2a
    const float g_nm = g_ts * s.inv2a;
    float g_b = -g_nm;
    const float g_sq = s.use0 ? -g_nm : g_nm;
    const float g_inv2a = g_ts * (s.use0 ? -s.b - s.sq : -s.b + s.sq);
    // inv2a = 0.5 / a
    float g_a = -(g_inv2a * s.inv2a) / s.a;
    // sq = sqrt(disc) where disc > 1e-12, else 0
    const float g_disc = s.pos ? g_sq * 0.5f / s.sq : 0.0f;
    // disc = b b - 4 a cq
    g_b = g_b + 2.0f * s.b * g_disc;
    g_a = g_a + -4.0f * s.cq * g_disc;
    const float g_cq = -4.0f * s.a * g_disc;
    // cq = oc.oc - rad rad; b = 2 oc.d; a = d.d
    g_rad = g_rad + -2.0f * s.rad * g_cq;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float g_oc = 2.0f * g_cq * s.oc[i] + 2.0f * g_b * s.d[i];
      g_dg[i] = g_dg[i] + 2.0f * g_b * s.oc[i] + 2.0f * g_a * s.d[i];
      g_og[i] = g_og[i] + g_oc;
      g_ana[i] = g_ana[i] - g_oc;
    }
    g_ana[6] = g_rad;
  } else if (s.is_p) {
    // point = P - dd nx, dd = nx.(P - c), P = o + t d,
    // t = (nx.c - nx.o) / den, den = nx.d where |nx.d| > EPS_PARALLEL
    const float g_dd = -dotv(g_point, s.nx);
    float g_nx[3], g_P[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g_nx[i] = g_nrm[i] - s.dd * g_point[i] + g_dd * s.q[i];
      g_P[i] = g_point[i] + g_dd * s.nx[i];
      g_ana[i] = -(g_dd * s.nx[i]);
      g_og[i] = g_P[i];
      g_dg[i] = s.t * g_P[i];
    }
    const float g_tp = dotv(s.d, g_P);
    const float g_num = g_tp / s.den;
    const float g_den = s.okp ? -(g_tp * s.t) / s.den : 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g_nx[i] = g_nx[i] + g_den * s.d[i] + g_num * s.c[i] - g_num * s.o[i];
      g_dg[i] = g_dg[i] + g_den * s.nx[i];
      g_ana[i] = g_ana[i] + g_num * s.nx[i];
      g_og[i] = g_og[i] - g_num * s.nx[i];
      g_ana[3 + i] = g_nx[i];
    }
  } else {
    // a miss keeps point = o
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g_og[i] = g_point[i];
      g_dg[i] = 0.0f;
    }
  }
  if (in) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (g_o_out) g_o_out[3 * r + i] = g_o[i] + g_og[i];
      if (g_d_out) g_d_out[3 * r + i] = g_d[i] + g_dg[i];
    }
    if (g_w_out) g_w_out[r] = g_w;
  }

  // the block's sums: dense partials (the environment, small tables),
  // lists (large tables)
  const int b = blockIdx.x;
  float* wf = reinterpret_cast<float*>(work);
  __syncthreads();
  for (int k = tid; k < dn.n_env; k += kBwd) {
    float v = s_env[k];
#pragma unroll
    for (int w2 = 1; w2 < kWarps; ++w2) v = v + s_env[w2 * n_env + k];
    s_dense[k] = v;
  }
  if (dn.mat)
    block_dense<kMatCols>(in && s.valid ? s.mid : -1, g_mat, s_rows,
                          s_dense + dn.mat_at);
  else if (g_mat_out)
    block_list<kMatCols>(in && s.valid ? s.mid : -1, g_mat, s_rows, s_key,
                         s_small, b, work + wk.mat_cnt, work + wk.mat_ids,
                         wf + wk.mat_vals);
  if (dn.ana)
    block_dense<kAnaCols>(in && s.valid ? s.arow : -1, g_ana, s_rows,
                          s_dense + dn.ana_at);
  else if (g_ana_out)
    block_list<kAnaCols>(in && s.valid ? s.arow : -1, g_ana, s_rows, s_key,
                         s_small, b, work + wk.ana_cnt, work + wk.ana_ids,
                         wf + wk.ana_vals);
  if (!env && !g_mat_out && !g_ana_out) return;
  __syncthreads();
  for (int k = tid; k < dn.width; k += kBwd)
    wf[wk.part + static_cast<long>(b) * dn.width + k] = s_dense[k];

  // the last block of each group of kGroup sums the group's dense
  // partials in block order; the last of those sums the groups' in group
  // order and the lists (counters: integers, after a __threadfence)
  const int g = b / kGroup, n_groups = groups_of(nb);
  const int in_group = min(kGroup, nb - g * kGroup);
  __threadfence();
  __syncthreads();
  if (tid == 0) s_flag = atomicAdd(done + g, 1) == in_group - 1;
  __syncthreads();
  if (!s_flag) return;
  __threadfence();
  sum_rows(wf + wk.part + static_cast<long>(g) * kGroup * dn.width,
           in_group, dn.width,
           wf + wk.group + static_cast<long>(g) * dn.width);
  __threadfence();
  __syncthreads();
  if (tid == 0) s_flag = atomicAdd(done + n_groups, 1) == n_groups - 1;
  __syncthreads();
  if (!s_flag) return;
  __threadfence();
  sum_rows(wf + wk.group, n_groups, dn.width, s_dense);
  __syncthreads();
  for (int k = tid; k < dn.n_env; k += kBwd) g_env_out[k] = s_dense[k];
  if (dn.mat)
    for (int i = tid; i < M * 16; i += kBwd) {
      const int c = i & 15;
      g_mat_out[i] =
          c < kMatCols ? s_dense[dn.mat_at + (i >> 4) * kMatCols + c] : 0.0f;
    }
  if (dn.ana)
    for (int i = tid; i < A * 16; i += kBwd) {
      const int c = i & 15;
      g_ana_out[i] =
          c < kAnaCols ? s_dense[dn.ana_at + (i >> 4) * kAnaCols + c] : 0.0f;
    }
  __syncthreads();
  if (g_mat_out && !dn.mat)
    final_table<kMatCols>(work + wk.mat_cnt, work + wk.mat_ids,
                          wf + wk.mat_vals, nb, M, g_mat_out, s_rows,
                          s_small, s_off, s_tab);
  if (g_ana_out && !dn.ana)
    final_table<kAnaCols>(work + wk.ana_cnt, work + wk.ana_ids,
                          wf + wk.ana_vals, nb, A, g_ana_out, s_rows,
                          s_small, s_off, s_tab);
}

}  // namespace

// o, d [R, 3]; w [R]; ana16 [A, 16]; mat16 [M, 16]; kind, idx [R] int32;
// h, miss [R] bool; shadow [L, R] bool; lp, lc [L, 3]; amb, bg [3]; S, P:
// ana16's sphere and plane rows (spheres first). Outputs: add, o2, d2
// [R, 3]; w2 [R].
extern "C" int mrt_seg_ana_fwd(const void* o, const void* d, const void* w,
                               const void* ana16, const void* mat16,
                               const void* kind, const void* idx,
                               const void* h, const void* miss,
                               const void* shadow, const void* lp,
                               const void* lc, const void* amb,
                               const void* bg, int S, int P, int L, int R,
                               void* add, void* o2, void* d2, void* w2,
                               void* stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (R + kThreads - 1) / kThreads;
  seg_ana_fwd_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(w), static_cast<const float*>(ana16),
      static_cast<const float*>(mat16), static_cast<const int*>(kind),
      static_cast<const int*>(idx), static_cast<const bool*>(h),
      static_cast<const bool*>(miss), static_cast<const bool*>(shadow),
      static_cast<const float*>(lp), static_cast<const float*>(lc),
      static_cast<const float*>(amb), static_cast<const float*>(bg), S, P, L,
      R, static_cast<float*>(add), static_cast<float*>(o2),
      static_cast<float*>(d2), static_cast<float*>(w2));
  return static_cast<int>(cudaGetLastError());
}

namespace {

// K11's blocks for R rays.
int bwd_blocks(int R) { return (R + kBwd - 1) / kBwd; }

}  // namespace

// Words (4 bytes) of K11's workspace for R rays, L lights, M mat16 rows
// and A ana16 rows, with the ana16, mat16 and environment sums each asked
// for or not.
extern "C" long long mrt_seg_ana_bwd_workspace(int R, int L, int M, int A,
                                               int ana, int mat, int env) {
  const Dense dn = dense_layout(L, M, A, env != 0, mat != 0, ana != 0);
  return work_layout(bwd_blocks(R), dn, mat != 0, ana != 0).words;
}

// K11's counters (ints, zero at its launch) for R rays.
extern "C" int mrt_seg_ana_bwd_counters(int R) {
  return groups_of(bwd_blocks(R)) + 1;
}

// K11's dynamic shared memory per block, in bytes (arguments as
// mrt_seg_ana_bwd_workspace's but R).
extern "C" size_t mrt_seg_ana_bwd_smem(int L, int M, int A, int ana, int mat,
                                       int env) {
  const Dense dn = dense_layout(L, M, A, env != 0, mat != 0, ana != 0);
  return sizeof(float) * static_cast<size_t>(smem_words(dn));
}

// Inputs as mrt_seg_ana_fwd plus the output cotangents g_add, g_o2, g_d2
// [R, 3] and g_w2 [R] (each may be null: zero). Outputs, each null when
// not asked for: g_o, g_d [R, 3]; g_w [R]; g_ana [A, 16] and g_mat [M, 16],
// the table cotangents (written whole); g_env [6L + 6] (light pos, light
// colour, ambience, background). work: mrt_seg_ana_bwd_workspace words;
// done: mrt_seg_ana_bwd_counters ints, zero at the launch.
extern "C" int mrt_seg_ana_bwd(
    const void* o, const void* d, const void* w, const void* ana16,
    const void* mat16, const void* kind, const void* idx, const void* h,
    const void* miss, const void* shadow, const void* lp, const void* lc,
    const void* amb, const void* bg, const void* g_add, const void* g_o2,
    const void* g_d2, const void* g_w2, int S, int P, int A, int M, int L,
    int R, void* g_o, void* g_d, void* g_w, void* g_ana, void* g_mat,
    void* g_env, void* work, void* done, void* stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  const int blocks = bwd_blocks(R);
  const size_t smem = mrt_seg_ana_bwd_smem(L, M, A, g_ana != nullptr,
                                           g_mat != nullptr,
                                           g_env != nullptr);
  const cudaError_t err = allow_smem(seg_ana_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_ana_bwd_kernel<<<blocks, kBwd, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(w), static_cast<const float*>(ana16),
      static_cast<const float*>(mat16), static_cast<const int*>(kind),
      static_cast<const int*>(idx), static_cast<const bool*>(h),
      static_cast<const bool*>(miss), static_cast<const bool*>(shadow),
      static_cast<const float*>(lp), static_cast<const float*>(lc),
      static_cast<const float*>(amb), static_cast<const float*>(bg),
      static_cast<const float*>(g_add), static_cast<const float*>(g_o2),
      static_cast<const float*>(g_d2), static_cast<const float*>(g_w2), S, P,
      A, M, L, R, static_cast<float*>(g_o), static_cast<float*>(g_d),
      static_cast<float*>(g_w), static_cast<float*>(g_ana),
      static_cast<float*>(g_mat), static_cast<float*>(g_env),
      static_cast<int*>(work), static_cast<int*>(done));
  return static_cast<int>(cudaGetLastError());
}
