// K2: exact per-subgroup phase-1 compaction of the cluster scan.
//
// Replaces myraytracer_tpu/ops/pallas_cluster.py:_phase1_exact_kernel
// (with its wrapper _phase1_exact_pallas). For subgroup s (SUB consecutive
// rays) and cluster k:
//   key[s, k] = min over active rays that touch box k, with entry
//               tmin <= t0, of max(tmin, 0); INF when no ray touches.
//
// Bound on the H100: all [R, K] slab tests would be ~20 FLOP each and
// bound the kernel by issue rate; the warp cull below leaves a few a ray,
// and then reading the rays (32 B each) bounds it. The output is S*K
// floats. Design: one CTA per subgroup, one ray per thread held in
// registers, the K boxes staged once in shared memory as two float4s each
// (bbmin, pad / bbmax, pad: two 128-bit broadcast loads a test), and as
// few slots as possible outside the slab arithmetic:
//   - a warp culls first: each lane tests one box of 32 against the bounds
//     of the warp's 32 rays (origins, 1/d, t0). The extremes of the rays'
//     own rounded plane distances lie at the bounds' corners, so a box the
//     bundle cannot touch no ray touches, and only the boxes a ballot
//     keeps (a few of office's 366 per warp) get the per-ray tests. Where
//     the warp's directions lie in one octant (nearly every warp of a
//     coherent bundle) the near and far plane of each axis are known, and
//     both the cull and the per-ray test drop the FMNMX that order each
//     pair; a warp that straddles an axis (on a camera's centre column,
//     or of incoherent bounce rays) culls on both planes' corners;
//   - a cluster's value is max(tmin, 0) or INF = 3e38, never negative, so
//     its float bits order as unsigned integers do and one
//     redux.sync.min.u32 (__reduce_min_sync) is the exact warp minimum,
//     folded into a [K] shared minimum with atomicMin; the key row is
//     written once after one block barrier at the end;
//   - fminf/fmaxf (one FMNMX each) equal slab()'s NaN-propagating
//     nmin/nmax whenever no operand is NaN. A NaN needs a non-finite o or
//     1/d, a 1/d of 0 (d infinite) times an overflowed bb - o, or a NaN
//     box. A warp whose active rays are all clear of that, against boxes
//     with lo <= hi, culls and tests the kept boxes with FMNMX; any other
//     warp tests every box with nmin/nmax. Every form keeps slab()'s
//     operand order, so the keys equal the plain version's;
//   - a warp whose rays are all inactive skips the loop (its rays add
//     nothing to any minimum).
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// A warp's three forms. kOct 0-7: every active ray of the warp has 1/d
// in octant kOct (bit a set where 1/d_a < 0), and every box has lo <= hi:
// rounding is monotonic, so (lo_a - o_a) / d_a is the smaller of the two
// plane distances on axis a where 1/d_a > 0 and the larger where it is
// < 0, and the six FMNMX of the pairs drop out (their results differ at
// most in the sign of a zero, which no comparison below sees). kMixed:
// finite rays in more than one octant, culled on both planes' corners and
// tested with FMNMX on every pair (no operand is NaN). kNaNSafe: slab()'s
// nmin/nmax on every box.
constexpr int kMixed = 8, kNaNSafe = 9;

template <int kForm>
__device__ __forceinline__ bool slab4(float ox, float oy, float oz, float ivx,
                                      float ivy, float ivz, float4 lo,
                                      float4 hi, float* tmin_out) {
  const float x0 = (lo.x - ox) * ivx, x1 = (hi.x - ox) * ivx;
  const float y0 = (lo.y - oy) * ivy, y1 = (hi.y - oy) * ivy;
  const float z0 = (lo.z - oz) * ivz, z1 = (hi.z - oz) * ivz;
  float tmin, tmax;
  if (kForm < kMixed) {
    const float xn = (kForm & 1) ? x1 : x0, xf = (kForm & 1) ? x0 : x1;
    const float yn = (kForm & 2) ? y1 : y0, yf = (kForm & 2) ? y0 : y1;
    const float zn = (kForm & 4) ? z1 : z0, zf = (kForm & 4) ? z0 : z1;
    tmin = fmaxf(fmaxf(xn, yn), zn);
    tmax = fminf(fminf(xf, yf), zf);
  } else if (kForm == kMixed) {
    tmin = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1));
    tmax = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
  } else {
    tmin = nmax(nmax(nmin(x0, x1), nmin(y0, y1)), nmin(z0, z1));
    tmax = nmin(nmin(nmax(x0, x1), nmax(y0, y1)), nmax(z0, z1));
  }
  *tmin_out = tmin;
  return (tmax >= tmin) && (tmax > MRT_EPS_HIT);
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// The extremes, over a warp's rays, of one axis's plane distance
// (p - o) * iv as each ray rounds it, for o in [o_lo, o_hi] and iv in
// [iv_lo, iv_hi] (one sign): the rounded difference and product are
// monotonic in each argument, so the extremes lie at the corners, and the
// warp's octant says which o end: the caller passes it as o_e.
__device__ __forceinline__ float corner_min(float p, float o_e, float iv_lo,
                                            float iv_hi) {
  const float a = p - o_e;
  return fminf(a * iv_lo, a * iv_hi);
}
__device__ __forceinline__ float corner_max(float p, float o_e, float iv_lo,
                                            float iv_hi) {
  const float a = p - o_e;
  return fmaxf(a * iv_lo, a * iv_hi);
}

// One axis of a warp that straddles it: each ray's nearer and farther
// plane distance lie between the extremes of both planes' corners.
__device__ __forceinline__ void both_planes(float lo, float hi, float ol, float oh,
                                            float il, float ih, float* lb, float* ub) {
  const float a0 = lo - ol, a1 = lo - oh, a2 = hi - ol, a3 = hi - oh;
  const float p0 = a0 * il, p1 = a0 * ih, p2 = a1 * il, p3 = a1 * ih;
  const float p4 = a2 * il, p5 = a2 * ih, p6 = a3 * il, p7 = a3 * ih;
  *lb = fminf(fminf(fminf(p0, p1), fminf(p2, p3)), fminf(fminf(p4, p5), fminf(p6, p7)));
  *ub = fmaxf(fmaxf(fmaxf(p0, p1), fmaxf(p2, p3)), fmaxf(fmaxf(p4, p5), fmaxf(p6, p7)));
}

// One warp's rays against every box: the warp minimum of each cluster's
// value into kmin[k] (float bits as unsigned). tr is NaN for an inactive
// ray, so that no box passes its tmin <= tr.
template <int kForm>
__device__ __noinline__ void scan_boxes(const float4* sbox, unsigned* kmin, int K,
                                        float ox, float oy, float oz, float ivx,
                                        float ivy, float ivz, float tr, int lane) {
  const unsigned inf_bits = __float_as_uint(MRT_INF);
  // max(tmin, 0) on the bits: a tmin <= 0 (-0 included, whose bits would
  // order above every positive value as unsigned) gives +0; tmin is not
  // NaN where the box is hit
  const auto value = [&](int k) {
    float tmin;
    const bool hit = slab4<kForm>(ox, oy, oz, ivx, ivy, ivz, sbox[2 * k],
                                  sbox[2 * k + 1], &tmin);
    return (hit && tmin <= tr) ? static_cast<unsigned>(max(__float_as_int(tmin), 0))
                               : inf_bits;
  };
  if (kForm < kNaNSafe) {
    // The warp's bundle: its active rays' origins and 1/d per axis, and
    // their largest t0. A box no ray of the bundle can touch (its lowest
    // entry above the highest exit, the highest exit <= EPS_HIT, or the
    // lowest entry above every t0) is skipped whole: each lane tests one
    // box of 32 against the bundle, and only the boxes a ballot keeps get
    // the rays' exact tests. The bounds are the rays' own rounded
    // distances' extremes, so the skip is exact.
    const bool act = tr == tr;
    const float big = __int_as_float(0x7f800000);
    const float oxl = warp_min(act ? ox : big), oxh = warp_max(act ? ox : -big);
    const float oyl = warp_min(act ? oy : big), oyh = warp_max(act ? oy : -big);
    const float ozl = warp_min(act ? oz : big), ozh = warp_max(act ? oz : -big);
    const float ixl = warp_min(act ? ivx : big), ixh = warp_max(act ? ivx : -big);
    const float iyl = warp_min(act ? ivy : big), iyh = warp_max(act ? ivy : -big);
    const float izl = warp_min(act ? ivz : big), izh = warp_max(act ? ivz : -big);
    const float tr_max = warp_max(tr);  // fmaxf drops the NaN of inactive rays
    constexpr bool nx = kForm & 1, ny = kForm & 2, nz = kForm & 4;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      bool may = false;
      if (k < K) {
        const float4 lo = sbox[2 * k], hi = sbox[2 * k + 1];
        float lb, ub;
        if (kForm == kMixed) {
          float lx, ux, ly, uy, lz, uz;
          both_planes(lo.x, hi.x, oxl, oxh, ixl, ixh, &lx, &ux);
          both_planes(lo.y, hi.y, oyl, oyh, iyl, iyh, &ly, &uy);
          both_planes(lo.z, hi.z, ozl, ozh, izl, izh, &lz, &uz);
          lb = fmaxf(fmaxf(lx, ly), lz);
          ub = fminf(fminf(ux, uy), uz);
        } else {
          lb = fmaxf(fmaxf(corner_min(nx ? hi.x : lo.x, nx ? oxl : oxh, ixl, ixh),
                           corner_min(ny ? hi.y : lo.y, ny ? oyl : oyh, iyl, iyh)),
                     corner_min(nz ? hi.z : lo.z, nz ? ozl : ozh, izl, izh));
          ub = fminf(fminf(corner_max(nx ? lo.x : hi.x, nx ? oxh : oxl, ixl, ixh),
                           corner_max(ny ? lo.y : hi.y, ny ? oyh : oyl, iyl, iyh)),
                     corner_max(nz ? lo.z : hi.z, nz ? ozh : ozl, izl, izh));
        }
        may = (ub >= lb) && (ub > MRT_EPS_HIT) && (lb <= tr_max);
      }
      for (unsigned mask = __ballot_sync(kFull, may); mask; mask &= mask - 1) {
        const int c = __ffs(mask) - 1;
        const unsigned m = __reduce_min_sync(kFull, value(k0 + c));
        if (lane == 0 && m != inf_bits) atomicMin(kmin + k0 + c, m);
      }
    }
    return;
  }
  // Clusters 32 at a time: lane c keeps the minimum of cluster k0 + c in
  // a register and folds it into kmin once per 32 (the last K % 32 go one
  // by one).
  int k0 = 0;
  for (; k0 + 32 <= K; k0 += 32) {
    unsigned mine = inf_bits;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const unsigned m = __reduce_min_sync(kFull, value(k0 + c));
      mine = lane == c ? m : mine;
    }
    if (mine != inf_bits) atomicMin(kmin + k0 + lane, mine);
  }
  for (int k = k0; k < K; ++k) {
    const unsigned m = __reduce_min_sync(kFull, value(k));
    if (lane == 0 && m != inf_bits) atomicMin(kmin + k, m);
  }
}

__device__ __forceinline__ bool finite3(float a, float b, float c) {
  return isfinite(a) && isfinite(b) && isfinite(c);
}

__global__ void __launch_bounds__(512, 3)
phase1_exact_kernel(const float4* __restrict__ o4, const float4* __restrict__ d4,
                    const float* __restrict__ t0, const int* __restrict__ act,
                    const float* __restrict__ bb, float* __restrict__ key,
                    int K, int sub) {
  extern __shared__ float4 sbox[];  // [K, 2] boxes (bbmin, 0), (bbmax, 0)
  unsigned* kmin = reinterpret_cast<unsigned*>(sbox + 2 * K);  // [K]
  const int s = blockIdx.x;
  const int tid = threadIdx.x;

  bool unordered = false;  // a box with a NaN or with lo > hi
  for (int i = tid; i < K; i += blockDim.x) {
    const float* b = bb + 6 * i;
    sbox[2 * i] = make_float4(b[0], b[1], b[2], 0.0f);
    sbox[2 * i + 1] = make_float4(b[3], b[4], b[5], 0.0f);
    for (int c = 0; c < 3; ++c) unordered |= !(b[c] <= b[c + 3]);
    kmin[i] = __float_as_uint(MRT_INF);
  }

  const long r = static_cast<long>(s) * sub + tid;
  const float4 o = o4[r];
  const float4 d = d4[r];
  const float ivx = 1.0f / d.x, ivy = 1.0f / d.y, ivz = 1.0f / d.z;
  const bool active = act[r] > 0;
  const float tr = active ? t0[r] : __int_as_float(0x7fffffff);  // NaN
  const bool boxes_ordered = !__syncthreads_or(unordered);

  const unsigned live = __ballot_sync(kFull, active);
  if (live) {
    // an inactive ray's value is INF whatever its slab test gives: only
    // the active rays decide the form
    const bool clear = !active || (finite3(o.x, o.y, o.z) && finite3(ivx, ivy, ivz) &&
                                   ivx != 0.0f && ivy != 0.0f && ivz != 0.0f);
    const int oct = (ivx < 0.0f) | ((ivy < 0.0f) << 1) | ((ivz < 0.0f) << 2);
    const int oct0 = __shfl_sync(kFull, oct, __ffs(live) - 1);
#define MRT_SCAN(form) \
  scan_boxes<form>(sbox, kmin, K, o.x, o.y, o.z, ivx, ivy, ivz, tr, tid & 31)
    if (!boxes_ordered || !__all_sync(kFull, clear)) {
      MRT_SCAN(kNaNSafe);
    } else if (!__all_sync(kFull, !active || oct == oct0)) {
      MRT_SCAN(kMixed);
    } else {
      switch (oct0) {
        case 0: MRT_SCAN(0); break;
        case 1: MRT_SCAN(1); break;
        case 2: MRT_SCAN(2); break;
        case 3: MRT_SCAN(3); break;
        case 4: MRT_SCAN(4); break;
        case 5: MRT_SCAN(5); break;
        case 6: MRT_SCAN(6); break;
        default: MRT_SCAN(7); break;
      }
    }
#undef MRT_SCAN
  }
  __syncthreads();
  for (int i = tid; i < K; i += blockDim.x)
    key[static_cast<long>(s) * K + i] = __uint_as_float(kmin[i]);
}

}  // namespace

// Dynamic shared memory of one K2 block: two float4 boxes and one key a
// cluster.
extern "C" size_t mrt_phase1_exact_smem(int K) {
  return (2 * sizeof(float4) + sizeof(unsigned)) * static_cast<size_t>(K);
}

// o4, d4 [S*sub, 4]; t0, act [S*sub]; bb [K, 6]; key [S, K] (output).
extern "C" int mrt_phase1_exact(const void* o4, const void* d4, const void* t0,
                                const void* act, const void* bb, void* key,
                                int S, int K, int sub, void* stream) {
  const size_t smem = mrt_phase1_exact_smem(K);
  cudaError_t err = allow_smem(phase1_exact_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  phase1_exact_kernel<<<S, sub, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(o4), static_cast<const float4*>(d4),
      static_cast<const float*>(t0), static_cast<const int*>(act),
      static_cast<const float*>(bb), static_cast<float*>(key), K, sub);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mrt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
