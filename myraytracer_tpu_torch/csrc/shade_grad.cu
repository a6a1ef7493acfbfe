// K5 (forward) and K6 (hand-derived reverse) of the differentiable shade
// segment.
//
// K5 replaces myraytracer_tpu/ops/shade_grad.py:_seg_fwd_kernel over
// _fwd_core; K6 replaces _seg_bwd_kernel over _bwd_core together with the
// .at[ti].add that sums its per-ray rows into the tri_pack cotangent. One
// thread per ray. Each thread reads its recorded triangle's 48-float
// tri_pack row by id itself (the Pallas kernels took 30 pre-split per-ray
// columns, a Mosaic layout rule), then runs the segment: Cramer re-solve
// in the det3 form, flat or Phong normal, plane re-projection, Phong under
// the fixed lit mask, Whitted blend, mirror bounce. K6 recomputes that
// forward in registers, then runs the reverse in _bwd_core's order. The
// light and env cotangents are summed in the kernel: warp shuffles,
// shared-memory atomics per warp, then one global atomicAdd per value and
// block. The row cotangents are summed per triangle in the warp and added
// into tri_pack's cotangent with one atomicAdd per (triangle, column).
//
// The normalize reverses form v * (2 g) rather than the reference's
// (2 v) * g: equal bit for bit, but 2 v overflows for a hit that fails
// the re-solve (ops/shade_grad.py, _bwd_core).
//
// Expressions keep the plain PyTorch versions' operand order (and the
// file is built without FMA contraction, kernels/_build.py), so kernel
// and plain version agree to the last bits; the atomics sum the light
// and env cotangents and the rows of a triangle in a run-dependent order.
//
// Bound on the H100: memory. K5 reads about 60 floats per ray (ray, row,
// masks, lit) and writes 10; K6 reads about 80 B a ray and writes 28 plus
// the [T, 48] tri_pack cotangent. Both keep every intermediate in
// registers (one pass each way instead of the hundreds of elementwise
// launches of the plain versions) and read the light and env tables
// through the read-only cache. K6's limit is its live state: the forward
// and the reverse of a ray at once. It keeps occupancy up by holding less:
// the row cotangent accumulates in shared memory, not in 29 registers;
// the material columns are read again where the reverse needs them; the
// geometry (re-solve, normals, point) is recomputed after the lighting
// reverse from the origin and the row read again, so none of it stays
// live across the lighting: 80 registers, no spills, six 128-thread
// blocks an SM. Its rows never reach device memory: the lanes of a warp
// that share a triangle (__match_any_sync) sum their rows through shared
// memory, and one lane per column adds the sum into the tri_pack
// cotangent, one atomic per (triangle, column) and warp.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// K6's block, launched with __launch_bounds__(kBwdThreads, 6): at 128
// threads six blocks fit an SM's registers (80 a thread)
constexpr int kBwdThreads = 128;

__device__ __forceinline__ float dotv(const float* a, const float* b) {
  return dot3(a[0], a[1], a[2], b[0], b[1], b[2]);
}

__device__ __forceinline__ void crossv(const float* a, const float* b,
                                       float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// det of the columns (a, b, c) as a . (b x c)
__device__ __forceinline__ float det3v(const float* a, const float* b,
                                       const float* c) {
  float x[3];
  crossv(b, c, x);
  return dotv(a, x);
}

// vecmath.normalize's guard and op order: 1 / sqrt(max(n2, eps))
__device__ __forceinline__ float inv_norm(float n2, bool* ok) {
  *ok = n2 > MRT_EPS_NORMALIZE;
  return *ok ? 1.0f / sqrtf(fmaxf(n2, MRT_EPS_NORMALIZE)) : 0.0f;
}

// A ray's hit geometry on its recorded triangle: the Cramer re-solve,
// the flat and the chosen normal, the plane re-projection.
struct Geo {
  float c1[3], c2[3], c3[3], c4[3];
  float Dt, Da, Db, inv_s, alpha, beta, gamma, t_use;
  bool ok_s, valid;
  float e1[3], e2[3], cr[3], invf, nf[3];
  bool okf;
  float nrm[3], q[3], dd, point[3];
};

// Forward state of one ray, everything the reverse reads.
struct Seg {
  float o[3], d[3], w;
  bool is_t, h, miss, phong;
  float kd[3], ka[3], ks[3], shin, mirror;
  Geo g;
  float col[3], wf, dn, refl[3];
};

// One light's forward terms at a shading point.
struct LightTerms {
  float lv[3], invl, ld[3], diff, ln, m[3], invm, r[3], cos_rv, base, spec;
  bool okl, okm, gate;
};

__device__ __forceinline__ void light_terms(const Seg& s, const float* lp,
                                            LightTerms& t) {
#pragma unroll
  for (int i = 0; i < 3; ++i) t.lv[i] = __ldg(lp + i) - s.g.point[i];
  t.invl = inv_norm(dotv(t.lv, t.lv), &t.okl);
#pragma unroll
  for (int i = 0; i < 3; ++i) t.ld[i] = t.lv[i] * t.invl;
  t.diff = nmax(dotv(s.g.nrm, t.ld), 0.0f);
  t.ln = dotv(t.ld, s.g.nrm);
#pragma unroll
  for (int i = 0; i < 3; ++i) t.m[i] = 2.0f * t.ln * s.g.nrm[i] - t.ld[i];
  t.invm = inv_norm(dotv(t.m, t.m), &t.okm);
#pragma unroll
  for (int i = 0; i < 3; ++i) t.r[i] = t.m[i] * t.invm;
  t.cos_rv = nmax(dot3(t.r[0], t.r[1], t.r[2], -s.d[0], -s.d[1], -s.d[2]),
                  0.0f);
  t.gate = (t.diff > 0.0f) && (t.cos_rv > 0.0f);
  t.base = t.gate ? t.cos_rv : 1.0f;
  t.spec = t.gate ? powf(t.base, s.shin) : 0.0f;
}

// The geometry of ray (o, d) on the triangle with corners pv (p0 p1 p2)
// and normals nv (n0 n1 n2), as _fwd_core computes it.
__device__ __forceinline__ void seg_geometry(const float* o, const float* d,
                                             bool is_t, bool phong,
                                             const float* pv, const float* nv,
                                             Geo& g) {
  const float* p0 = pv;
  const float* p1 = pv + 3;
  const float* p2 = pv + 6;
  // Cramer solve (intersect.ray_triangle)
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g.c1[i] = p0[i] - p2[i];
    g.c2[i] = p1[i] - p2[i];
    g.c3[i] = -d[i];
    g.c4[i] = o[i] - p2[i];
  }
  const float sdet = det3v(g.c1, g.c2, g.c3);
  g.Dt = det3v(g.c1, g.c2, g.c4);
  g.Da = det3v(g.c4, g.c2, g.c3);
  g.Db = det3v(g.c1, g.c4, g.c3);
  g.ok_s = fabsf(sdet) > MRT_EPS_DET;
  g.inv_s = g.ok_s ? 1.0f / sdet : 0.0f;
  const float t_raw = g.Dt * g.inv_s;
  g.alpha = g.Da * g.inv_s;
  g.beta = g.Db * g.inv_s;
  g.gamma = 1.0f - g.alpha - g.beta;
  const bool inside = g.alpha >= 0.0f && g.alpha <= 1.0f && g.beta >= 0.0f &&
                      g.beta <= 1.0f && g.gamma >= 0.0f && g.gamma <= 1.0f;
  g.valid = g.ok_s && t_raw > MRT_EPS_HIT && inside;
  const float t_inf = g.valid ? t_raw : MRT_INF;
  g.t_use = is_t ? t_inf : 0.0f;

  // normals
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g.e1[i] = p1[i] - p0[i];
    g.e2[i] = p2[i] - p0[i];
  }
  crossv(g.e1, g.e2, g.cr);
  g.invf = inv_norm(dotv(g.cr, g.cr), &g.okf);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g.nf[i] = g.cr[i] * g.invf;
    const float nph = g.alpha * nv[i] + g.beta * nv[3 + i] + g.gamma * nv[6 + i];
    const float nsel = phong ? nph : g.nf[i];
    g.nrm[i] = is_t ? nsel : 0.0f;
  }

  // hit point and plane re-projection (shade.resolve_hit)
  float P[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    P[i] = o[i] + g.t_use * d[i];
    g.q[i] = P[i] - p2[i];
  }
  g.dd = dotv(g.nf, g.q);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    g.point[i] = is_t ? P[i] - g.dd * g.nf[i] : P[i];
}

// Loads ray r and its row, and runs the forward (_fwd_core) up to the
// blend; the outputs follow from the returned state. Inlined, so the
// state lives in registers and what a kernel does not read is dropped.
__device__ __forceinline__ void seg_forward(
    int r, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ w, const int* __restrict__ tri_idx,
    const float* __restrict__ tri_pack, int pack_w,
    const bool* __restrict__ is_t, const bool* __restrict__ h,
    const bool* __restrict__ miss, const float* __restrict__ lit,
    const float* __restrict__ lp, const float* __restrict__ lc,
    const float* __restrict__ amb, int L, int R, Seg& s) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.o[i] = o[3 * r + i];
    s.d[i] = d[3 * r + i];
  }
  s.w = w[r];
  s.is_t = is_t[r];
  s.h = h[r];
  s.miss = miss[r];
  const float* row = tri_pack + static_cast<long>(tri_idx[r]) * pack_w;
  float pv[9], nv[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    pv[i] = row[i];
    nv[i] = row[16 + i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.kd[i] = row[32 + i];
    s.ka[i] = row[35 + i];
    s.ks[i] = row[38 + i];
  }
  s.phong = row[25] > 0.5f;
  s.shin = row[41];
  s.mirror = s.is_t ? row[42] : 0.0f;
  seg_geometry(s.o, s.d, s.is_t, s.phong, pv, nv, s.g);

  // Phong with the fixed shadow mask (tracer.lighting_from_mask)
#pragma unroll
  for (int i = 0; i < 3; ++i) s.col[i] = __ldg(amb + i) * s.ka[i];
  for (int li = 0; li < L; ++li) {
    LightTerms t;
    light_terms(s, lp + 3 * li, t);
    const float lit_r = lit[static_cast<long>(li) * R + r];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      s.col[i] = s.col[i] + __ldg(lc + 3 * li + i) * lit_r *
                                (s.kd[i] * t.diff + s.ks[i] * t.spec);
  }
  s.wf = s.w * (1.0f - s.mirror);
  s.dn = dot3(s.d[0], s.d[1], s.d[2], s.g.nrm[0], s.g.nrm[1], s.g.nrm[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) s.refl[i] = s.d[i] - 2.0f * s.dn * s.g.nrm[i];
}

__global__ void seg_fwd_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ w, const int* __restrict__ tri_idx,
    const float* __restrict__ tri_pack, int pack_w,
    const bool* __restrict__ is_t, const bool* __restrict__ h,
    const bool* __restrict__ miss, const float* __restrict__ lit,
    const float* __restrict__ lp, const float* __restrict__ lc,
    const float* __restrict__ amb, const float* __restrict__ bg, int L, int R,
    float* __restrict__ add, float* __restrict__ o2, float* __restrict__ d2,
    float* __restrict__ w2) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  Seg s;
  seg_forward(r, o, d, w, tri_idx, tri_pack, pack_w, is_t, h, miss, lit, lp,
              lc, amb, L, R, s);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    add[3 * r + i] = (s.h ? s.wf * s.col[i] : 0.0f) +
                     (s.miss ? s.w * __ldg(bg + i) : 0.0f);
    o2[3 * r + i] = s.h ? s.g.point[i] + MRT_EPS_OFFSET * s.refl[i] : s.o[i];
    d2[3 * r + i] = s.h ? s.refl[i] : s.d[i];
  }
  w2[r] = s.h ? s.w * s.mirror : 0.0f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Adds v, summed over the warp, into acc (shared memory). Every lane of
// the warp must call it.
__device__ __forceinline__ void warp_add(float* acc, float v) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) atomicAdd(acc, v);
}

// Adds gv * d det(a, b, c) = gv * (b x c, c x a, a x b) into (ga, gb, gc).
__device__ __forceinline__ void acc_det(float gv, float* ga, float* gb,
                                        float* gcc, const float* a,
                                        const float* b, const float* c) {
  float bxc[3], cxa[3], axb[3];
  crossv(b, c, bxc);
  crossv(c, a, cxa);
  crossv(a, b, axb);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    ga[i] = ga[i] + gv * bxc[i];
    gb[i] = gb[i] + gv * cxa[i];
    gcc[i] = gcc[i] + gv * axb[i];
  }
}

// row-cotangent slot of tri_pack column c (_GRAD_COLS order), and back
__host__ __device__ constexpr int gslot(int c) {
  return c < 9 ? c : (c < 25 ? c - 7 : c - 14);
}
__device__ __forceinline__ int gcol(int k) {
  return k < 9 ? k : (k < 18 ? k + 7 : k + 14);
}
constexpr int kGradCols = 29;

// A fresh read of n floats of an input the kernel does not write: an asm
// volatile load is never merged with the forward's read of the same
// address, so the values need not stay in registers from the forward to
// the reverse.
__device__ __forceinline__ void reload(const float* p, int n, float* out) {
#pragma unroll
  for (int i = 0; i < n; ++i)
    asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(out[i]) : "l"(p + i));
}

// Dynamic shared memory: the block's row cotangents (kBwdThreads x 29
// floats, each thread's row at threadIdx.x * 29: an odd stride, so the
// lanes of a warp hit distinct banks), then 6L + 6 floats (light pos,
// light color, ambience, background cotangents of the block).
__global__ void __launch_bounds__(kBwdThreads, 6) seg_bwd_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ w, const int* __restrict__ tri_idx,
    const float* __restrict__ tri_pack, int pack_w,
    const bool* __restrict__ is_t, const bool* __restrict__ h,
    const bool* __restrict__ miss, const float* __restrict__ lit,
    const float* __restrict__ lp, const float* __restrict__ lc,
    const float* __restrict__ amb, const float* __restrict__ bg,
    const float* __restrict__ g_add_in, const float* __restrict__ g_o2_in,
    const float* __restrict__ g_d2_in, const float* __restrict__ g_w2_in,
    int L, int R, float* __restrict__ g_o_out, float* __restrict__ g_d_out,
    float* __restrict__ g_w_out, float* __restrict__ g_pack,
    float* __restrict__ g_env) {
  extern __shared__ float smem[];
  float* s_env = smem + kBwdThreads * kGradCols;
  const int n_env = 6 * L + 6;
  for (int k = threadIdx.x; k < n_env; k += blockDim.x) s_env[k] = 0.0f;
  // this ray's row cotangent, summed in _bwd_core's order
  float* gc = smem + threadIdx.x * kGradCols;
#pragma unroll
  for (int k = 0; k < kGradCols; ++k) gc[k] = 0.0f;
  __syncthreads();

  // threads past the end recompute the last ray and contribute 0 to the
  // block sums: every lane takes part in the warp shuffles and matches
  const int r_in = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = r_in < R;
  const int r = in ? r_in : R - 1;
  Seg s;
  seg_forward(r, o, d, w, tri_idx, tri_pack, pack_w, is_t, h, miss, lit, lp,
              lc, amb, L, R, s);
  const int tri = tri_idx[r];
  const float* row = tri_pack + static_cast<long>(tri) * pack_w;
  const bool hh = s.h, mf = s.miss;
  float g_add[3], g_o2[3], g_d2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g_add[i] = g_add_in[3 * r + i];
    g_o2[i] = g_o2_in[3 * r + i];
    g_d2[i] = g_d2_in[3 * r + i];
  }
  const float g_w2 = g_w2_in[r];

  float g_d[3] = {0.0f, 0.0f, 0.0f};
  float g_point[3] = {0.0f, 0.0f, 0.0f}, g_nrm[3] = {0.0f, 0.0f, 0.0f};
  float g_nf[3] = {0.0f, 0.0f, 0.0f};
  float g_w = 0.0f, g_t = 0.0f, g_alpha = 0.0f, g_beta = 0.0f,
        g_mirror = 0.0f;

  // bounce reverse
  float g_refl[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g_refl[i] = hh ? MRT_EPS_OFFSET * g_o2[i] + g_d2[i] : 0.0f;
    g_point[i] = g_point[i] + (hh ? g_o2[i] : 0.0f);
    g_d[i] = g_d[i] + (hh ? 0.0f : g_d2[i]);
  }
  g_w = g_w + (hh ? s.mirror * g_w2 : 0.0f);
  g_mirror = g_mirror + (hh ? s.w * g_w2 : 0.0f);
  const float ngr = dotv(s.g.nrm, g_refl);
#pragma unroll
  for (int i = 0; i < 3; ++i) g_d[i] = g_d[i] + (g_refl[i] - 2.0f * s.g.nrm[i] * ngr);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    g_nrm[i] = g_nrm[i] + -2.0f * (s.d[i] * ngr + s.dn * g_refl[i]);

  // blend reverse
  float g_col[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) g_col[i] = hh ? s.wf * g_add[i] : 0.0f;
  const float gdotc = g_add[0] * s.col[0] + g_add[1] * s.col[1] + g_add[2] * s.col[2];
  g_w = g_w + (hh ? (1.0f - s.mirror) * gdotc : 0.0f);
  g_mirror = g_mirror + (hh ? -s.w * gdotc : 0.0f);
  // the block sums take each ray's env cotangents as soon as they are
  // final, so they do not stay live
#pragma unroll
  for (int i = 0; i < 3; ++i)
    warp_add(s_env + 6 * L + 3 + i, in && mf ? s.w * g_add[i] : 0.0f);
  g_w = g_w + (mf ? g_add[0] * __ldg(bg) + g_add[1] * __ldg(bg + 1) +
                        g_add[2] * __ldg(bg + 2)
                  : 0.0f);
  if (in) g_w_out[r] = g_w;
  // mirror leaf
  gc[gslot(42)] = gc[gslot(42)] + (s.is_t ? g_mirror : 0.0f);

  // lighting reverse (ka, kd, ks read again where they are used)
  float ka[3];
  reload(row + 35, 3, ka);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    warp_add(s_env + 6 * L + i, in ? g_col[i] * ka[i] : 0.0f);
    gc[gslot(35 + i)] = gc[gslot(35 + i)] + g_col[i] * __ldg(amb + i);
  }
  for (int li = 0; li < L; ++li) {
    float kd[3], ks[3];
    reload(row + 32, 3, kd);
    reload(row + 38, 3, ks);
    LightTerms t;
    light_terms(s, lp + 3 * li, t);
    const float lit_r = lit[static_cast<long>(li) * R + r];
    float lcv[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) lcv[i] = __ldg(lc + 3 * li + i);
    float g_lc[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      g_lc[i] = g_col[i] * lit_r * (kd[i] * t.diff + ks[i] * t.spec);
    float g_diff = 0.0f, g_spec = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      gc[gslot(32 + i)] = gc[gslot(32 + i)] + g_col[i] * lcv[i] * lit_r * t.diff;
      gc[gslot(38 + i)] = gc[gslot(38 + i)] + g_col[i] * lcv[i] * lit_r * t.spec;
      g_diff = g_diff + g_col[i] * lcv[i] * lit_r * kd[i];
      g_spec = g_spec + g_col[i] * lcv[i] * lit_r * ks[i];
    }
    // off the gate base = 1, so pow and log stay finite there; both are
    // also selected away, never multiplied by 0
    const float g_base =
        t.gate ? s.shin * powf(t.base, s.shin - 1.0f) * g_spec : 0.0f;
    gc[gslot(41)] = gc[gslot(41)] + (t.gate ? t.spec * logf(t.base) * g_spec : 0.0f);
    // rv = r . (-d)
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
    for (int i = 0; i < 3; ++i) g_m[i] = g_r[i] * t.invm + t.m[i] * (2.0f * g_n2m);
    // m = 2 (ld.n) n - ld
    const float ngm = dotv(s.g.nrm, g_m);
    float g_ld[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g_ld[i] = 2.0f * ngm * s.g.nrm[i] - g_m[i];
      g_nrm[i] = g_nrm[i] + 2.0f * (ngm * t.ld[i] + t.ln * g_m[i]);
    }
    // diff = max(0, n.ld)
    const float gd = t.diff > 0.0f ? g_diff : 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g_nrm[i] = g_nrm[i] + gd * t.ld[i];
      g_ld[i] = g_ld[i] + gd * s.g.nrm[i];
    }
    // ld = normalize(lv)
    const float g_invl = g_ld[0] * t.lv[0] + g_ld[1] * t.lv[1] + g_ld[2] * t.lv[2];
    const float g_n2l =
        t.okl ? -0.5f * t.invl * t.invl * t.invl * g_invl : 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float g_lv = g_ld[i] * t.invl + t.lv[i] * (2.0f * g_n2l);
      g_point[i] = g_point[i] + -g_lv;
      warp_add(s_env + 3 * li + i, in ? g_lv : 0.0f);
      warp_add(s_env + 3 * L + 3 * li + i, in ? g_lc[i] : 0.0f);
    }
  }

  // The rest of the reverse reads the geometry, recomputed here from
  // the ray's origin and the row's corners and normals read again (the
  // same expressions give the same bits): nothing of it stays live
  // across the lighting reverse.
  float ov[3], pv[9], nv[9], g_o[3];
  reload(o + 3 * r, 3, ov);
  // g_o's first term, the bounce's (g_o2 read again)
  reload(g_o2_in + 3 * r, 3, g_o);
#pragma unroll
  for (int i = 0; i < 3; ++i) g_o[i] = 0.0f + (hh ? 0.0f : g_o[i]);
  reload(row, 9, pv);
  reload(row + 16, 9, nv);
  Geo g;
  seg_geometry(ov, s.d, s.is_t, s.phong, pv, nv, g);

  // point / re-projection reverse
  float g_pr[3], g_P[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g_pr[i] = s.is_t ? g_point[i] : 0.0f;
    g_P[i] = s.is_t ? 0.0f : g_point[i];
  }
  const float nfg = dotv(g.nf, g_pr);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g_P[i] = g_P[i] + (g_pr[i] - g.nf[i] * nfg);
    gc[gslot(6 + i)] = gc[gslot(6 + i)] + g.nf[i] * nfg;
    g_nf[i] = g_nf[i] + -(g.q[i] * nfg + g.dd * g_pr[i]);
  }
  // P = o + t d
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g_o[i] = g_o[i] + g_P[i];
    g_d[i] = g_d[i] + g.t_use * g_P[i];
    g_t = g_t + s.d[i] * g_P[i];
  }

  // normal select reverse
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float g_nsel = s.is_t ? g_nrm[i] : 0.0f;
    const float g_nph = s.phong ? g_nsel : 0.0f;
    const float g_nf2 = s.phong ? 0.0f : g_nsel;
    g_nf[i] = g_nf[i] + g_nf2;
    gc[gslot(16 + i)] = gc[gslot(16 + i)] + g.alpha * g_nph;
    gc[gslot(19 + i)] = gc[gslot(19 + i)] + g.beta * g_nph;
    gc[gslot(22 + i)] = gc[gslot(22 + i)] + g.gamma * g_nph;
    g_alpha = g_alpha + g_nph * (nv[i] - nv[6 + i]);
    g_beta = g_beta + g_nph * (nv[3 + i] - nv[6 + i]);
  }

  // flat normal reverse
  const float g_invf =
      g_nf[0] * g.cr[0] + g_nf[1] * g.cr[1] + g_nf[2] * g.cr[2];
  const float g_n2f = g.okf ? -0.5f * g.invf * g.invf * g.invf * g_invf : 0.0f;
  float g_cr[3], g_e1[3], g_e2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    g_cr[i] = g_nf[i] * g.invf + g.cr[i] * (2.0f * g_n2f);
  crossv(g.e2, g_cr, g_e1);
  crossv(g_cr, g.e1, g_e2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    gc[gslot(3 + i)] = gc[gslot(3 + i)] + g_e1[i];
    gc[gslot(6 + i)] = gc[gslot(6 + i)] + g_e2[i];
    gc[gslot(0 + i)] = gc[gslot(0 + i)] + (-g_e1[i] - g_e2[i]);
  }

  // Cramer reverse; inv_s = 0 off ok_s, and g_s is selected there
  const float g_t_raw = (s.is_t && g.valid) ? g_t : 0.0f;
  const float g_Dt = g_t_raw * g.inv_s;
  const float g_Da = g_alpha * g.inv_s;
  const float g_Db = g_beta * g.inv_s;
  const float g_inv_s = g_t_raw * g.Dt + g_alpha * g.Da + g_beta * g.Db;
  const float g_s = g.ok_s ? -g.inv_s * g.inv_s * g_inv_s : 0.0f;
  float g_c1[3] = {0.0f, 0.0f, 0.0f}, g_c2[3] = {0.0f, 0.0f, 0.0f};
  float g_c3[3] = {0.0f, 0.0f, 0.0f}, g_c4[3] = {0.0f, 0.0f, 0.0f};
  acc_det(g_s, g_c1, g_c2, g_c3, g.c1, g.c2, g.c3);
  acc_det(g_Dt, g_c1, g_c2, g_c4, g.c1, g.c2, g.c4);
  acc_det(g_Da, g_c4, g_c2, g_c3, g.c4, g.c2, g.c3);
  acc_det(g_Db, g_c1, g_c4, g_c3, g.c1, g.c4, g.c3);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    gc[gslot(0 + i)] = gc[gslot(0 + i)] + g_c1[i];
    gc[gslot(3 + i)] = gc[gslot(3 + i)] + g_c2[i];
    gc[gslot(6 + i)] = gc[gslot(6 + i)] + (-g_c1[i] - g_c2[i] - g_c4[i]);
    g_o[i] = g_o[i] + g_c4[i];
    g_d[i] = g_d[i] + -g_c3[i];
  }

  if (in) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g_o_out[3 * r + i] = g_o[i];
      g_d_out[3 * r + i] = g_d[i];
    }
  }

  // The reference's .at[ti].add, summed in the warp first: the lanes
  // that share a triangle form a group (__match_any_sync), and for each
  // group the lanes k < 29 sum column k over its members (shared memory,
  // member order) and add it into g_pack with one atomic. A lane whose
  // row is all zero (by value) adds nothing and is left out.
  __syncwarp();
  bool nz = false;
#pragma unroll
  for (int k = 0; k < kGradCols; ++k) nz = nz || gc[k] != 0.0f;
  const int key = (in && nz) ? tri : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int lane = threadIdx.x & 31;
  unsigned leaders =
      __ballot_sync(0xffffffffu, key >= 0 && lane == __ffs(peers) - 1);
  const float* wrows = smem + (threadIdx.x - lane) * kGradCols;
  while (leaders) {
    const int lead = __ffs(leaders) - 1;
    leaders &= leaders - 1;
    const unsigned grp = __shfl_sync(0xffffffffu, peers, lead);
    const int t = __shfl_sync(0xffffffffu, key, lead);
    if (lane < kGradCols) {
      float sum = 0.0f;
      for (unsigned m = grp; m; m &= m - 1)
        sum = sum + wrows[(__ffs(m) - 1) * kGradCols + lane];
      atomicAdd(g_pack + static_cast<long>(t) * pack_w + gcol(lane), sum);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_env; k += blockDim.x)
    atomicAdd(g_env + k, s_env[k]);
}

}  // namespace

// o, d [R, 3]; w [R]; tri_idx [R]; tri_pack [T, pack_w]; is_t, h, miss [R]
// bool; lit [L, R]; lp, lc [L, 3]; amb, bg [3].
// Outputs: add, o2, d2 [R, 3]; w2 [R].
extern "C" int mrt_seg_fwd(const void* o, const void* d, const void* w,
                           const void* tri_idx, const void* tri_pack,
                           int pack_w, const void* is_t, const void* h,
                           const void* miss, const void* lit, const void* lp,
                           const void* lc, const void* amb, const void* bg,
                           int L, int R, void* add, void* o2, void* d2,
                           void* w2, void* stream) {
  const int blocks = (R + kThreads - 1) / kThreads;
  seg_fwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(w), static_cast<const int*>(tri_idx),
      static_cast<const float*>(tri_pack), pack_w,
      static_cast<const bool*>(is_t), static_cast<const bool*>(h),
      static_cast<const bool*>(miss), static_cast<const float*>(lit),
      static_cast<const float*>(lp), static_cast<const float*>(lc),
      static_cast<const float*>(amb), static_cast<const float*>(bg), L, R,
      static_cast<float*>(add), static_cast<float*>(o2),
      static_cast<float*>(d2), static_cast<float*>(w2));
  return static_cast<int>(cudaGetLastError());
}

// Inputs as mrt_seg_fwd plus the cotangents g_add, g_o2, g_d2 [R, 3] and
// g_w2 [R]. Outputs: g_o, g_d [R, 3]; g_w [R]; g_pack [T, pack_w], the
// tri_pack cotangent (columns _GRAD_COLS), and g_env [6L + 6] (light pos,
// light color, ambience, background), both of which must be zeroed: the
// kernel adds into them.
// K6's dynamic shared memory per block, in bytes, at L lights.
extern "C" size_t mrt_seg_bwd_smem(int L) {
  return sizeof(float) *
         (kBwdThreads * kGradCols + 6 * static_cast<size_t>(L) + 6);
}

extern "C" int mrt_seg_bwd(const void* o, const void* d, const void* w,
                           const void* tri_idx, const void* tri_pack,
                           int pack_w, const void* is_t, const void* h,
                           const void* miss, const void* lit, const void* lp,
                           const void* lc, const void* amb, const void* bg,
                           const void* g_add, const void* g_o2,
                           const void* g_d2, const void* g_w2, int L, int R,
                           void* g_o, void* g_d, void* g_w, void* g_pack,
                           void* g_env, void* stream) {
  const int blocks = (R + kBwdThreads - 1) / kBwdThreads;
  const size_t smem = mrt_seg_bwd_smem(L);
  const cudaError_t err = allow_smem(seg_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_bwd_kernel<<<blocks, kBwdThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(w), static_cast<const int*>(tri_idx),
      static_cast<const float*>(tri_pack), pack_w,
      static_cast<const bool*>(is_t), static_cast<const bool*>(h),
      static_cast<const bool*>(miss), static_cast<const float*>(lit),
      static_cast<const float*>(lp), static_cast<const float*>(lc),
      static_cast<const float*>(amb), static_cast<const float*>(bg),
      static_cast<const float*>(g_add), static_cast<const float*>(g_o2),
      static_cast<const float*>(g_d2), static_cast<const float*>(g_w2), L, R,
      static_cast<float*>(g_o), static_cast<float*>(g_d),
      static_cast<float*>(g_w), static_cast<float*>(g_pack),
      static_cast<float*>(g_env));
  return static_cast<int>(cudaGetLastError());
}
