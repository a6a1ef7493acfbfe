// K7: the threaded-BVH walk, closest-hit and any-hit.
//
// Replaces tools/studies/pallas_traverse.py:_kernel (called from
// traverse_bvh_pallas), which computes what the JAX package's lockstep
// walk myraytracer_tpu/ops/traverse.py:traverse_bvh computes. Each ray
// carries one node pointer over the octant-threaded BVH (ops/bvh.py):
// a step reads the node's box, culls it unless the slab test hits with
// tmin <= the ray's best t, solves the leaf's triangles in slot order with
// a strict <, and follows links[octant * N + p]: the entry link into a hit
// internal node, the skip link otherwise; -1 ends the walk. Any-hit mode
// ends a ray after the step that found its first hit below t_max (the
// leaf's remaining slots are still solved, as in the lockstep walk).
//
// Bound on the H100: latency. The tables (nodes [N, 8] f32, links [8N, 2]
// i32, corner rows [T, 16] f32; 2.35 MB for office tess 10) stay resident
// in the 50 MB L2, so the walk moves few HBM bytes and does little
// arithmetic per step; its time is the chain of dependent loads of each
// ray and the instructions of each step. Design: one thread per ray and a
// stackless walk, per-ray state in registers, every table read through
// the read-only path (__ldg) as 16-byte rows: a node is two float4 loads,
// a triangle three. A step issues its node and link loads together (both
// depend on the pointer alone), so it waits for one load, not two. A ray
// with finite o and finite nonzero 1/d tests a box whose corners are
// ordered (lo <= hi, so no NaN) with plain FMNMX: no product can be NaN
// there, and fminf/fmaxf then equal nmin/nmax up to the sign of a zero,
// which the comparisons that read tmin and tmax do not see. Every other
// ray or box takes the NaN-propagating slab(). In the any-hit launch each
// block first compacts its active rays, in call order, into its first
// threads (ballots and one barrier; ops/traverse.py compact_active is the
// plain form), so they fill whole warps and the rest of the block exits.
//
// Built without FMA contraction (kernels/_build.py NO_FMA) and without
// fast math: the slab test keeps torch.minimum's NaN propagation (nmin,
// nmax), 1/d is an IEEE division (1/-0 = -inf), and the Cramer solve keeps
// the operand order of utils/vecmath.det3, so t and the hit ids equal
// the plain version's (ops/traverse.traverse_bvh_plain) to the bit.
#include "common.cuh"

namespace {

// 3x3 determinant of the columns a, b, c by cofactor expansion along the
// first row, in vecmath.det3's operand order
__device__ __forceinline__ float det3(float ax, float ay, float az, float bx,
                                      float by, float bz, float cx, float cy,
                                      float cz) {
  return ax * (by * cz - cy * bz) - bx * (ay * cz - cy * az) +
         cx * (ay * bz - by * az);
}

// ray_triangle's t (ops/intersect.py): Cramer's rule on the columns
// [p0-p2, p1-p2, -d | o-p2]; INF on a miss
__device__ __forceinline__ float tri_t(float ox, float oy, float oz, float dx,
                                       float dy, float dz, float4 q0,
                                       float4 q1, float4 q2) {
  // q0 = p0x p0y p0z p1x, q1 = p1y p1z p2x p2y, q2 = p2z pad
  const float p2x = q1.z, p2y = q1.w, p2z = q2.x;
  const float c1x = q0.x - p2x, c1y = q0.y - p2y, c1z = q0.z - p2z;
  const float c2x = q0.w - p2x, c2y = q1.x - p2y, c2z = q1.y - p2z;
  const float c3x = -dx, c3y = -dy, c3z = -dz;
  const float c4x = ox - p2x, c4y = oy - p2y, c4z = oz - p2z;
  const float s = det3(c1x, c1y, c1z, c2x, c2y, c2z, c3x, c3y, c3z);
  const bool ok = fabsf(s) > MRT_EPS_DET;
  const float inv_s = ok ? 1.0f / s : 0.0f;
  const float t = det3(c1x, c1y, c1z, c2x, c2y, c2z, c4x, c4y, c4z) * inv_s;
  const float alpha = det3(c4x, c4y, c4z, c2x, c2y, c2z, c3x, c3y, c3z) * inv_s;
  const float beta = det3(c1x, c1y, c1z, c4x, c4y, c4z, c3x, c3y, c3z) * inv_s;
  const float gamma = 1.0f - alpha - beta;
  const bool inside = (alpha >= 0.0f) && (alpha <= 1.0f) && (beta >= 0.0f) &&
                      (beta <= 1.0f) && (gamma >= 0.0f) && (gamma <= 1.0f);
  return (ok && (t > MRT_EPS_HIT) && inside) ? t : MRT_INF;
}

constexpr int kWalkThreads = 128;

__device__ __forceinline__ bool finite3(float a, float b, float c) {
  return isfinite(a) && isfinite(b) && isfinite(c);
}

// kAnyHit: ends a ray after the step that found its first hit, and
// walks the block's active rays compacted into its first threads (an
// inactive ray gets its miss written at once).
template <bool kAnyHit>
__global__ void __launch_bounds__(kWalkThreads) bvh_walk_kernel(
    const float* __restrict__ o, const float* __restrict__ d, int ws,
    const float* __restrict__ t0, const int* __restrict__ act,
    const float4* __restrict__ nodes, const int2* __restrict__ links,
    const float4* __restrict__ tris, float* __restrict__ t_out,
    int* __restrict__ idx_out, int R, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  long r = i;
  int ptr;
  if (kAnyHit) {
    __shared__ int s_ray[kWalkThreads];
    __shared__ int s_warp[kWalkThreads / 32];
    const bool live = i < R && act[i] > 0;
    if (i < R && !live) {
      t_out[i] = MRT_INF;
      idx_out[i] = -1;
    }
    const unsigned m = __ballot_sync(0xffffffffu, live);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) s_warp[warp] = __popc(m);
    __syncthreads();
    int base = 0, n = 0;
#pragma unroll
    for (int k = 0; k < kWalkThreads / 32; ++k) {
      base += k < warp ? s_warp[k] : 0;
      n += s_warp[k];
    }
    if (live) s_ray[base + __popc(m & ((1u << lane) - 1u))] = i;
    __syncthreads();
    if (static_cast<int>(threadIdx.x) >= n) return;
    r = s_ray[threadIdx.x];
    ptr = 0;
  } else {
    if (i >= R) return;
    ptr = act[r] > 0 ? 0 : -1;
  }
  const float ox = o[r * ws], oy = o[r * ws + 1], oz = o[r * ws + 2];
  const float dx = d[r * ws], dy = d[r * ws + 1], dz = d[r * ws + 2];
  const float ivx = 1.0f / dx, ivy = 1.0f / dy, ivz = 1.0f / dz;
  const int octant = (dx < 0.0f) + 2 * (dy < 0.0f) + 4 * (dz < 0.0f);
  const int2* lk = links + static_cast<long>(octant) * N;
  const bool clean = finite3(ox, oy, oz) && finite3(ivx, ivy, ivz) &&
                     ivx != 0.0f && ivy != 0.0f && ivz != 0.0f;

  float tb = t0[r];
  int ib = -1;
  while (ptr >= 0) {
    const float4 a = __ldg(nodes + 2 * static_cast<long>(ptr));
    const float4 b = __ldg(nodes + 2 * static_cast<long>(ptr) + 1);
    const int2 l = __ldg(lk + ptr);
    // a = lo.x lo.y lo.z hi.x, b = hi.y hi.z first count
    float tmin;
    bool hit;
    if (clean && a.x <= a.w && a.y <= b.x && a.z <= b.y) {
      const float x0 = (a.x - ox) * ivx, x1 = (a.w - ox) * ivx;
      const float y0 = (a.y - oy) * ivy, y1 = (b.x - oy) * ivy;
      const float z0 = (a.z - oz) * ivz, z1 = (b.y - oz) * ivz;
      tmin = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1));
      const float tmax =
          fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
      hit = (tmax >= tmin) && (tmax > MRT_EPS_HIT);
    } else {
      const float bb[6] = {a.x, a.y, a.z, a.w, b.x, b.y};
      hit = slab(ox, oy, oz, ivx, ivy, ivz, bb, &tmin);
    }
    const bool box = hit && (tmin <= tb);
    const int first = __float_as_int(b.z);
    const int count = __float_as_int(b.w);
    if (box && count > 0) {
      for (int k = 0; k < count; ++k) {
        const float4* row = tris + 4 * static_cast<long>(first + k);
        const float tt = tri_t(ox, oy, oz, dx, dy, dz, __ldg(row),
                               __ldg(row + 1), __ldg(row + 2));
        if (tt < tb) {
          tb = tt;
          ib = first + k;
        }
      }
    }
    ptr = (box && count == 0) ? l.x : l.y;
    if (kAnyHit && ib >= 0) break;
  }
  t_out[r] = ib >= 0 ? tb : MRT_INF;
  idx_out[r] = ib;
}

}  // namespace

// o, d [R, ws] (ws = 3 or 4; xyz first); t0 [R]; act [R] i32; nodes [N, 8];
// links [8N, 2] i32; tris [T, 16]; t_out, idx_out [R] (outputs).
extern "C" int mrt_bvh_walk(const void* o, const void* d, const void* t0,
                            const void* act, const void* nodes,
                            const void* links, const void* tris, void* t_out,
                            void* idx_out, int R, int ws, int N, int any_hit,
                            void* stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (R + kWalkThreads - 1) / kWalkThreads;
  auto kernel = any_hit ? bvh_walk_kernel<true> : bvh_walk_kernel<false>;
  kernel<<<blocks, kWalkThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d), ws,
      static_cast<const float*>(t0), static_cast<const int*>(act),
      static_cast<const float4*>(nodes), static_cast<const int2*>(links),
      static_cast<const float4*>(tris), static_cast<float*>(t_out),
      static_cast<int*>(idx_out), R, N);
  return static_cast<int>(cudaGetLastError());
}

// K7's block size, which ops/traverse.py WALK_BLOCK must equal
extern "C" int mrt_bvh_walk_threads() { return kWalkThreads; }
