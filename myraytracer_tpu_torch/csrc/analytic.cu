// K8: the dense analytic tests (spheres, planes, cylinders), closest hit
// and any hit.
//
// Replaces no TPU kernel: the JAX package leaves these tests to XLA
// (myraytracer_tpu/ops/tracer.py:193 _closest_analytic and its
// _analytic_occlusion). The port's plain form (ops/tracer.py) runs them
// as PyTorch ops over [rays, primitives, 3] temporaries; on the card each
// of those writes and re-reads its intermediate, some 400 bytes of HBM
// traffic per ray-primitive pair, and a molecule frame (800 spheres, 3
// planes, 1.9e9 pairs) spent 99% of its device time there. K8 is added to
// do the same tests in registers.
//
// Closest mode: one thread per ray walks spheres 0..S-1, then planes, then
// cylinders, in ShadeGeom.ana16 row order, and keeps the best t with a
// strict <. That one ordered scan equals the plain form's per-kind
// first-index min followed by its strict-< merge: kind, the index within
// the kind, the ana16 row and t; KIND_MISS, 0, 0 and INF on a miss.
// Any-hit mode: a shadow ray whose cast flag is false answers false at
// once; any other stops at the first primitive whose t (INF on a miss) is
// below its distance. That equals the plain form's dense occlusion ANDed
// with cast.
//
// Bound on the H100: fp32 operations. A miss costs about 20 operations
// (the sphere's discriminant), a square root and a divide only where the
// discriminant is not negative, and the rows are the same for every ray.
// Design: each thread keeps its ray, its precomputed ray terms (d.d, 4 d.d,
// 0.5 / d.d) and its best hit in registers; the block stages the rows
// through shared memory in chunks, loaded cooperatively and converted to
// the terms the tests read per row (a sphere's r*r, a plane's n.c, a
// cylinder's r*r and height/2, each the value the plain form computes per
// pair), so every lane of a warp reads the same row: a broadcast, no bank
// conflict. A thread takes the rows kGroup at a time: it first computes
// each sphere's discriminant, with no branch between rows (independent
// work the scheduler can interleave), and then runs the whole test of the
// few rows whose discriminant is not negative, in row order. The row
// counts come from the arguments: one design for 3 spheres or 800. In
// any-hit mode each block first moves its casting rays, in call order,
// into its first threads (ballots and one barrier, as K7 does), so they
// fill whole warps, and it stops staging once none of its rays is still
// looking (__syncthreads_or). It launches on the caller's stream,
// allocates nothing and never synchronises, so it can be captured in a
// CUDA graph and in an IF node's body.
//
// Built without FMA contraction (kernels/_build.py NO_FMA) and without
// fast math: IEEE sqrtf and division, and every expression in the
// operand order of ops/intersect.py's ray_sphere, ray_plane and
// ray_cylinder as PyTorch evaluates them on the card (tdot), so t equals
// the plain form's to the bit.
//
// ptxas (sm_90a, CUDA 12.8): 64 registers in either mode, no spills;
// 8,192 B of shared memory a block (8,720 B in any-hit mode, with its
// compaction); 8 blocks of 128 threads an SM. On o_04's pass-1 rays,
// against 72 registers and 7 blocks, any hit is 6% faster and closest
// hit the same.
#include "common.cuh"

namespace {

constexpr int KIND_SPHERE = 1;
constexpr int KIND_PLANE = 2;
constexpr int KIND_CYL = 4;

constexpr int kThreads = 128;
// blocks an SM holds: ptxas keeps a thread to 64 registers for them
constexpr int kBlocksPerSM = 8;
// float4 slots of the block's row chunk (8 KB): a sphere or a plane takes
// one, a cylinder two
constexpr int kChunk = 512;
// rows whose candidates a thread finds before it tests any of them
constexpr int kGroup = 16;

// torch.sum(a * b, dim=-1) over a last axis of three on the card: the
// reduction splits the axis over two lanes (elements 0 and 2 on one, 1 on
// the other) and adds the lanes, so (x + z) + y
__device__ __forceinline__ float tdot(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  const float x = ax * bx, y = ay * by, z = az * bz;
  return (x + z) + y;
}

// The ray's registers: origin, direction, and the sphere's per-ray terms
// of ray_sphere (a = d.d; 4.0 * a; 0.5 / a, which PyTorch computes as
// reciprocal(a) * 0.5)
struct Ray {
  float ox, oy, oz, dx, dy, dz, a4, inv2a;
};

// ray_sphere's b and discriminant b*b - 4ac for the row (cx, cy, cz,
// r*r): the ray misses where the discriminant is negative (or NaN)
__device__ __forceinline__ float sphere_disc(const Ray& r, float4 s,
                                             float& b) {
  const float ocx = r.ox - s.x, ocy = r.oy - s.y, ocz = r.oz - s.z;
  b = 2.0f * tdot(ocx, ocy, ocz, r.dx, r.dy, r.dz);
  const float c = tdot(ocx, ocy, ocz, ocx, ocy, ocz) - s.w;
  return b * b - r.a4 * c;
}

// ray_sphere's t for the row; INF on a miss
__device__ __forceinline__ float sphere_t(const Ray& r, float4 s) {
  float b;
  const float disc = sphere_disc(r, s, b);
  if (!(disc >= 0.0f)) return MRT_INF;
  const float sq = sqrtf(disc);
  const float t0 = (-b - sq) * r.inv2a;
  const float t1 = (-b + sq) * r.inv2a;
  const float t = t0 > MRT_EPS_HIT ? t0 : t1;
  return t > MRT_EPS_HIT ? t : MRT_INF;
}

// ray_plane's t for the row (nx, ny, nz, n.c); INF on a miss or for a
// parallel ray
__device__ __forceinline__ float plane_t(const Ray& r, float4 p) {
  const float cosv = tdot(p.x, p.y, p.z, r.dx, r.dy, r.dz);
  if (fabsf(cosv) < MRT_EPS_PARALLEL) return MRT_INF;
  const float t = (p.w - tdot(p.x, p.y, p.z, r.ox, r.oy, r.oz)) / cosv;
  return t > MRT_EPS_HIT ? t : MRT_INF;
}

// ray_cylinder's t for the rows (cx, cy, cz, ax) (ay, az, r*r, height/2);
// INF on a miss or for a ray parallel to the axis
__device__ __forceinline__ float cylinder_t(const Ray& r, float4 q0,
                                            float4 q1) {
  const float ax = q0.w, ay = q1.x, az = q1.y;
  const float ocx = r.ox - q0.x, ocy = r.oy - q0.y, ocz = r.oz - q0.z;
  const float d_par = tdot(r.dx, r.dy, r.dz, ax, ay, az);
  const float oc_par = tdot(ocx, ocy, ocz, ax, ay, az);
  const float avx = r.dx - d_par * ax, avy = r.dy - d_par * ay,
              avz = r.dz - d_par * az;
  const float bvx = ocx - oc_par * ax, bvy = ocy - oc_par * ay,
              bvz = ocz - oc_par * az;
  const float a = tdot(avx, avy, avz, avx, avy, avz);
  const float b = 2.0f * tdot(avx, avy, avz, bvx, bvy, bvz);
  const float c = tdot(bvx, bvy, bvz, bvx, bvy, bvz) - q1.z;
  if (a < MRT_EPS_AXIS) return MRT_INF;
  const float disc = b * b - (4.0f * a) * c;
  if (!(disc >= 0.0f)) return MRT_INF;
  const float sq = disc > 0.0f ? sqrtf(disc) : 0.0f;
  const float inv2a = (1.0f / a) * 0.5f;
  const float t0 = (-b - sq) * inv2a;
  const float t1 = (-b + sq) * inv2a;
  const float half = q1.w;
  if (t0 > MRT_EPS_HIT && fabsf(oc_par + t0 * d_par) <= half) return t0;
  if (t1 > MRT_EPS_HIT && fabsf(oc_par + t1 * d_par) <= half) return t1;
  return MRT_INF;
}

// Stages rows [first, first + m) of ana16, of kind K (0 spheres, 1
// planes, 2 cylinders), into the chunk.
template <int K>
__device__ __forceinline__ void stage(float4* __restrict__ rows,
                                      const float* __restrict__ ana16,
                                      long first, int m) {
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const float* a = ana16 + (first + j) * 16;
    const float cx = __ldg(a), cy = __ldg(a + 1), cz = __ldg(a + 2);
    if (K == 0) {
      const float rad = __ldg(a + 6);
      rows[j] = make_float4(cx, cy, cz, rad * rad);
    } else if (K == 1) {
      const float ux = __ldg(a + 3), uy = __ldg(a + 4), uz = __ldg(a + 5);
      rows[j] = make_float4(ux, uy, uz, tdot(ux, uy, uz, cx, cy, cz));
    } else {
      const float rad = __ldg(a + 6);
      rows[2 * j] = make_float4(cx, cy, cz, __ldg(a + 3));
      rows[2 * j + 1] = make_float4(__ldg(a + 4), __ldg(a + 5), rad * rad,
                                    __ldg(a + 7) * 0.5f);
    }
  }
}

// t of the ray against staged row j of kind K
template <int K>
__device__ __forceinline__ float row_t(const Ray& r,
                                       const float4* __restrict__ rows,
                                       int j) {
  if (K == 0) return sphere_t(r, rows[j]);
  if (K == 1) return plane_t(r, rows[j]);
  return cylinder_t(r, rows[2 * j], rows[2 * j + 1]);
}

// A thread's query: its ray, the any-hit distance, whether it still
// looks, and the best hit (closest) or the occlusion (any hit) so far
struct Query {
  Ray r;
  float lim;
  bool looking;
  float best;
  int kind, idx;
  bool occ;
};

// Tests the query against the n rows of kind K that start at ana16 row
// first, a chunk at a time. Every thread of the block calls it (the
// chunks are staged together); in any-hit mode the block stops once no
// thread looks any more.
template <bool kAnyHit, int K>
__device__ __forceinline__ void scan(Query& q, float4* __restrict__ rows,
                                     const float* __restrict__ ana16,
                                     long first, int n) {
  constexpr int kind = K == 0 ? KIND_SPHERE : K == 1 ? KIND_PLANE : KIND_CYL;
  constexpr int per = K == 2 ? kChunk / 2 : kChunk;
  for (int base = 0; base < n; base += per) {
    const int m = min(per, n - base);
    if (kAnyHit) {
      if (!__syncthreads_or(q.looking)) return;
    } else {
      __syncthreads();
    }
    stage<K>(rows, ana16, first + base, m);
    __syncthreads();
    if (!q.looking) continue;
    // kGroup rows at a time: first the candidates, the rows whose test can
    // give a t below the bound; then each candidate's whole test, in row
    // order, so the first minimum wins as in the plain form. A sphere is
    // a candidate where its discriminant is not negative (ray_sphere's
    // miss test, for the group before any of their roots); every row of
    // the other kinds is, and in any-hit mode every row for a ray whose
    // distance exceeds INF, which a miss occludes as in the plain form.
    const bool every = K != 0 || (kAnyHit && MRT_INF < q.lim);
    for (int j0 = 0; j0 < m; j0 += kGroup) {
      unsigned cand = 0;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        float b;
        if (j0 + u < m &&
            (every || sphere_disc(q.r, rows[j0 + u], b) >= 0.0f)) {
          cand |= 1u << u;
        }
      }
      for (; cand != 0; cand &= cand - 1) {
        const int j = j0 + __ffs(cand) - 1;
        const float t = row_t<K>(q.r, rows, j);
        if (kAnyHit && t < q.lim) {
          q.occ = true;
          q.looking = false;
          break;
        }
        if (!kAnyHit && t < q.best) {
          q.best = t;
          q.kind = kind;
          q.idx = base + j;
        }
      }
      if (!q.looking) break;
    }
  }
}

// One launch: closest hit (kAnyHit false) or any hit over rays [0, R).
// o, d rows of ws floats (xyz first); ana16 rows: S spheres, P planes,
// C cylinders. Any hit reads dist and cast (nullptr: every ray casts) and
// writes occ; closest hit writes kind, idx, aidx, t.
template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) analytic_kernel(
    const float* __restrict__ o, const float* __restrict__ d, int ws,
    const float* __restrict__ dist, const bool* __restrict__ cast,
    const float* __restrict__ ana16, int S, int P, int C, int R,
    int* __restrict__ kind_out, int* __restrict__ idx_out,
    int* __restrict__ aidx_out, float* __restrict__ t_out,
    bool* __restrict__ occ_out) {
  __shared__ float4 rows[kChunk];
  long i = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  Query q{};
  q.looking = i < R;
  if (kAnyHit) {
    // the block's casting rays, in call order, go to its first threads,
    // so they fill whole warps; a ray that does not cast answers false
    __shared__ int s_ray[kThreads];
    __shared__ int s_warp[kThreads / 32];
    const bool casts = q.looking && (cast == nullptr || cast[i]);
    if (q.looking && !casts) occ_out[i] = false;
    const unsigned m = __ballot_sync(0xffffffffu, casts);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) s_warp[warp] = __popc(m);
    __syncthreads();
    int base = 0, n = 0;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) {
      base += k < warp ? s_warp[k] : 0;
      n += s_warp[k];
    }
    if (casts) s_ray[base + __popc(m & ((1u << lane) - 1u))] = i;
    __syncthreads();
    q.looking = static_cast<int>(threadIdx.x) < n;
    i = q.looking ? s_ray[threadIdx.x] : R;
  }
  q.lim = MRT_INF;
  q.best = MRT_INF;
  if (q.looking) {
    Ray& r = q.r;
    r.ox = o[i * ws], r.oy = o[i * ws + 1], r.oz = o[i * ws + 2];
    r.dx = d[i * ws], r.dy = d[i * ws + 1], r.dz = d[i * ws + 2];
    const float a = tdot(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
    r.a4 = 4.0f * a;
    r.inv2a = (1.0f / a) * 0.5f;
    if (kAnyHit) q.lim = dist[i];
  }
  scan<kAnyHit, 0>(q, rows, ana16, 0, S);
  scan<kAnyHit, 1>(q, rows, ana16, S, P);
  scan<kAnyHit, 2>(q, rows, ana16, static_cast<long>(S) + P, C);
  if (i >= R) return;
  if (kAnyHit) {
    occ_out[i] = q.occ;
  } else {
    kind_out[i] = q.kind;
    idx_out[i] = q.idx;
    aidx_out[i] = q.idx + (q.kind == KIND_PLANE ? S
                           : q.kind == KIND_CYL ? S + P
                                                : 0);
    t_out[i] = q.best;
  }
}

}  // namespace

// o, d [R, ws] (ws = 3 or 4; xyz first); ana16 [S + P + C, 16].
// Closest hit (any_hit = 0): kind, idx, aidx [R] i32 and t [R] f32 out.
// Any hit: dist [R] f32 and cast [R] bool (or null) in, occ [R] bool out.
extern "C" int mrt_analytic(const void* o, const void* d, const void* dist,
                            const void* cast, const void* ana16, void* kind,
                            void* idx, void* aidx, void* t, void* occ, int R,
                            int ws, int S, int P, int C, int any_hit,
                            void* stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (R + kThreads - 1) / kThreads;
  auto kernel = any_hit ? analytic_kernel<true> : analytic_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d), ws,
      static_cast<const float*>(dist), static_cast<const bool*>(cast),
      static_cast<const float*>(ana16), S, P, C, R, static_cast<int*>(kind),
      static_cast<int*>(idx), static_cast<int*>(aidx), static_cast<float*>(t),
      static_cast<bool*>(occ));
  return static_cast<int>(cudaGetLastError());
}
