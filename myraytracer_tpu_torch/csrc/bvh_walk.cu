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
// The launches of a bounce segment (ops/tracer.py: every segment after the
// first) walk a list of their live rays alone. walk_list_kernel writes
// the dead rays' misses and lists the live ones; the walk then lays the
// list's n rays over the warps the card holds at once, k = ceil(n /
// warps) of them a warp (at most 32), consecutive in the list. Measured
// on the H100 against the launch over the whole batch, on the rings'
// reflected rays: a few thousand live rays packed 32 a warp sit on a few
// SMs, whose load units then serve every divergent step (up to 28%
// slower), while one ray a warp over every SM is up to 32% faster; a
// long list packed in call order keeps neighbouring rays, whose walks
// run alike, in one warp. Warps that refill their lanes from the list
// (one atomicAdd a run of ids) lost 25 to 30% to this layout at every
// refill threshold (PERF.md).
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
// the list kernel's block and its rounds: each thread reads kListRounds
// rays kListThreads apart, and one warp scans the 32 (round, warp) counts
constexpr int kListThreads = 256;
constexpr int kListRounds = 4;
static_assert(kListRounds * kListThreads / 32 == 32, "one warp scans");
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool finite3(float a, float b, float c) {
  return isfinite(a) && isfinite(b) && isfinite(c);
}

// One ray's walk state: origin, direction, 1/d, its octant's links, the
// FMNMX path's condition, the best t and its triangle.
struct Ray {
  float ox, oy, oz, dx, dy, dz, ivx, ivy, ivz;
  const int2* lk;
  bool clean;
  float tb;
  int ib;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int ws,
                                        const float* __restrict__ t0, long r,
                                        const int2* __restrict__ links,
                                        int N) {
  Ray y;
  y.ox = o[r * ws], y.oy = o[r * ws + 1], y.oz = o[r * ws + 2];
  y.dx = d[r * ws], y.dy = d[r * ws + 1], y.dz = d[r * ws + 2];
  y.ivx = 1.0f / y.dx, y.ivy = 1.0f / y.dy, y.ivz = 1.0f / y.dz;
  const int octant = (y.dx < 0.0f) + 2 * (y.dy < 0.0f) + 4 * (y.dz < 0.0f);
  y.lk = links + static_cast<long>(octant) * N;
  y.clean = finite3(y.ox, y.oy, y.oz) && finite3(y.ivx, y.ivy, y.ivz) &&
            y.ivx != 0.0f && y.ivy != 0.0f && y.ivz != 0.0f;
  y.tb = t0[r];
  y.ib = -1;
  return y;
}

// One node step of a ray at node ptr -> the next node, -1 where the walk
// ends (in any-hit mode also after the step that found a hit).
template <bool kAnyHit>
__device__ __forceinline__ int walk_step(Ray& y, int ptr,
                                         const float4* __restrict__ nodes,
                                         const float4* __restrict__ tris) {
  const float4 a = __ldg(nodes + 2 * static_cast<long>(ptr));
  const float4 b = __ldg(nodes + 2 * static_cast<long>(ptr) + 1);
  const int2 l = __ldg(y.lk + ptr);
  // a = lo.x lo.y lo.z hi.x, b = hi.y hi.z first count
  float tmin;
  bool hit;
  if (y.clean && a.x <= a.w && a.y <= b.x && a.z <= b.y) {
    const float x0 = (a.x - y.ox) * y.ivx, x1 = (a.w - y.ox) * y.ivx;
    const float y0 = (a.y - y.oy) * y.ivy, y1 = (b.x - y.oy) * y.ivy;
    const float z0 = (a.z - y.oz) * y.ivz, z1 = (b.y - y.oz) * y.ivz;
    tmin = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1));
    const float tmax =
        fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
    hit = (tmax >= tmin) && (tmax > MRT_EPS_HIT);
  } else {
    const float bb[6] = {a.x, a.y, a.z, a.w, b.x, b.y};
    hit = slab(y.ox, y.oy, y.oz, y.ivx, y.ivy, y.ivz, bb, &tmin);
  }
  const bool box = hit && (tmin <= y.tb);
  const int first = __float_as_int(b.z);
  const int count = __float_as_int(b.w);
  if (box && count > 0) {
    for (int k = 0; k < count; ++k) {
      const float4* row = tris + 4 * static_cast<long>(first + k);
      const float tt = tri_t(y.ox, y.oy, y.oz, y.dx, y.dy, y.dz, __ldg(row),
                             __ldg(row + 1), __ldg(row + 2));
      if (tt < y.tb) {
        y.tb = tt;
        y.ib = first + k;
      }
    }
  }
  if (kAnyHit && y.ib >= 0) return -1;
  return (box && count == 0) ? l.x : l.y;
}

// kAnyHit: ends a ray after the step that found its first hit, and
// walks the block's active rays compacted into its first threads (an
// inactive ray gets its miss written at once). With a list (a bounce
// segment's query, made by walk_list_kernel): the listed rays alone, one
// a thread, whatever kAnyHit (the same walk_step).
template <bool kAnyHit>
__global__ void __launch_bounds__(kWalkThreads) bvh_walk_kernel(
    const float* __restrict__ o, const float* __restrict__ d, int ws,
    const float* __restrict__ t0, const int* __restrict__ act,
    const int* __restrict__ list, const int* __restrict__ n_list, int warps,
    const float4* __restrict__ nodes, const int2* __restrict__ links,
    const float4* __restrict__ tris, float* __restrict__ t_out,
    int* __restrict__ idx_out, int R, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  long r = i;
  int ptr;
  if (list != nullptr) {
    // The list walk: the list's n rays over the grid's first warps, as
    // many as the card holds at once, k = ceil(n / warps) consecutive
    // rays a warp, at most 32. A short list spreads one ray a warp over
    // every SM; a long one fills the lanes with neighbouring rays, and
    // what the resident warps cannot hold goes to later blocks, which
    // start as earlier ones end. The rest of the grid exits.
    const int n = *n_list;
    const int k = min(32, max(1, (n + warps - 1) / warps));
    const int lane = threadIdx.x & 31;
    const long p = static_cast<long>(i >> 5) * k + lane;
    if (lane >= k || p >= n) return;
    r = list[p];
    ptr = 0;
  } else if (kAnyHit) {
    __shared__ int s_ray[kWalkThreads];
    __shared__ int s_warp[kWalkThreads / 32];
    const bool live = i < R && act[i] > 0;
    if (i < R && !live) {
      t_out[i] = MRT_INF;
      idx_out[i] = -1;
    }
    const unsigned m = __ballot_sync(kFull, live);
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
  Ray y = load_ray(o, d, ws, t0, r, links, N);
  while (ptr >= 0) ptr = walk_step<kAnyHit>(y, ptr, nodes, tris);
  t_out[r] = y.ib >= 0 ? y.tb : MRT_INF;
  idx_out[r] = y.ib;
}

// The list of a bounce segment's query: each dead ray's miss written into
// K7's outputs, the live rays' ids into list, in call order within each
// block of kListThreads * kListRounds rays (the blocks' places by an
// atomic ticket, in the order they count), and, by the last block done,
// their number into n_list and, where it listed any, the counters
// {listed rays, rays} added to. work {places taken, blocks done} is the
// caller's (ops/traverse.py list_workspace): 0 before the launch, and the
// last block sets it to 0 again, so two launches that share it must not
// overlap. A place at R or beyond, which only such an overlap hands out,
// is not written, and n_list never exceeds R.
__global__ void __launch_bounds__(kListThreads) walk_list_kernel(
    const unsigned char* __restrict__ act, float* __restrict__ t_out,
    int* __restrict__ idx_out, int* __restrict__ list,
    int* __restrict__ n_list, unsigned long long* __restrict__ counts,
    unsigned* __restrict__ work, int R) {
  constexpr int kWarps = kListThreads / 32;
  // the block's live rays per (round, warp), then their first places
  __shared__ int s_place[kListRounds * kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = blockIdx.x * kListThreads * kListRounds + threadIdx.x;
  unsigned m[kListRounds];
#pragma unroll
  for (int k = 0; k < kListRounds; ++k) {
    const int i = first + k * kListThreads;
    const bool live = i < R && act[i] != 0;
    if (i < R && !live) {
      t_out[i] = MRT_INF;
      idx_out[i] = -1;
    }
    m[k] = __ballot_sync(kFull, live);
    if (lane == 0) s_place[k * kWarps + warp] = __popc(m[k]);
  }
  __syncthreads();
  if (warp == 0) {
    const int c = s_place[lane];
    int v = c;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const int u = __shfl_up_sync(kFull, v, k);
      if (lane >= k) v += u;
    }
    const int total = __shfl_sync(kFull, v, 31);
    int base = 0;
    if (lane == 0 && total > 0)
      base = static_cast<int>(atomicAdd(work, static_cast<unsigned>(total)));
    s_place[lane] = __shfl_sync(kFull, base, 0) + v - c;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kListRounds; ++k) {
    const int p = s_place[k * kWarps + warp] + __popc(m[k] & below);
    if (((m[k] >> lane) & 1u) && p < R) list[p] = first + k * kListThreads;
  }
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(work + 1, 1u) == gridDim.x - 1) {
      const int n = min(static_cast<int>(atomicExch(work, 0u)), R);
      atomicExch(work + 1, 0u);
      *n_list = n;
      if (counts != nullptr && n > 0) {
        counts[0] += static_cast<unsigned long long>(n);
        counts[1] += static_cast<unsigned long long>(R);
      }
    }
  }
}

// The warps the card holds at once of K7 (SMs times the resident blocks
// of 128, from the occupancy API), once per kernel and device.
int resident_warps(bool any_hit) {
  constexpr int kDevices = 64;
  static int held[2][kDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  int& w = held[any_hit][dev % kDevices];
  if (w == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, any_hit ? bvh_walk_kernel<true> : bvh_walk_kernel<false>,
        kWalkThreads, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    w = per_sm * sms > 0 ? per_sm * sms * (kWalkThreads / 32) : 1;
  }
  return w;
}

}  // namespace

// o, d [R, ws] (ws = 3 or 4; xyz first); t0 [R]; act [R] i32; list [R] i32
// and n_list [1] i32 from mrt_bvh_walk_list (act null), or both null (the
// launch over every ray); nodes [N, 8]; links [8N, 2] i32; tris [T, 16];
// t_out, idx_out [R] (outputs; with a list, the listed rays' alone).
extern "C" int mrt_bvh_walk(const void* o, const void* d, const void* t0,
                            const void* act, const void* list,
                            const void* n_list, const void* nodes,
                            const void* links, const void* tris, void* t_out,
                            void* idx_out, int R, int ws, int N, int any_hit,
                            void* stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (R + kWalkThreads - 1) / kWalkThreads;
  // the list walk's warps: those the card holds at once, within the grid
  const int warps =
      list == nullptr ? 0
                      : min(resident_warps(any_hit != 0),
                            blocks * (kWalkThreads / 32));
  auto kernel = any_hit ? bvh_walk_kernel<true> : bvh_walk_kernel<false>;
  kernel<<<blocks, kWalkThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d), ws,
      static_cast<const float*>(t0), static_cast<const int*>(act),
      static_cast<const int*>(list), static_cast<const int*>(n_list), warps,
      static_cast<const float4*>(nodes), static_cast<const int2*>(links),
      static_cast<const float4*>(tris), static_cast<float*>(t_out),
      static_cast<int*>(idx_out), R, N);
  return static_cast<int>(cudaGetLastError());
}

// act [R] bool; t_out, idx_out [R] (the dead rays' misses); list [R] i32,
// n_list [1] i32 (outputs); counts int64 [2] or null; work i32 [2], zero
// (and left zero).
extern "C" int mrt_bvh_walk_list(const void* act, void* t_out, void* idx_out,
                                 void* list, void* n_list, void* counts,
                                 void* work, int R, void* stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  const int rays = kListThreads * kListRounds;
  const int blocks = (R + rays - 1) / rays;
  walk_list_kernel<<<blocks, kListThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(act), static_cast<float*>(t_out),
      static_cast<int*>(idx_out), static_cast<int*>(list),
      static_cast<int*>(n_list), static_cast<unsigned long long*>(counts),
      static_cast<unsigned*>(work), R);
  return static_cast<int>(cudaGetLastError());
}

// K7's block size, which ops/traverse.py WALK_BLOCK must equal
extern "C" int mrt_bvh_walk_threads() { return kWalkThreads; }
