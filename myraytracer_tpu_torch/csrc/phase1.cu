// K2: exact per-subgroup phase-1 compaction of the cluster scan.
//
// Replaces myraytracer_tpu/ops/pallas_cluster.py:_phase1_exact_kernel
// (with its wrapper _phase1_exact_pallas). For subgroup s (SUB consecutive
// rays) and cluster k:
//   key[s, k] = min over active rays that touch box k, with entry
//               tmin <= t0, of max(tmin, 0); INF when no ray touches.
//
// Bound on the H100: the [R, K] slab tests are ~20 FLOP each and read
// nothing but the box table, so the kernel is bound by issue rate, not by
// memory; the output is S*K floats. Design: one CTA per subgroup, one ray
// per thread held in registers, the K boxes staged once in shared memory
// (every thread reads the same box at the same time: a broadcast). The
// min over the subgroup runs 32 clusters at a time: a warp-shuffle min per
// cluster, then one shared-memory pass across the warps, so the block
// synchronises twice per 32 clusters instead of per cluster.
#include "common.cuh"

namespace {

__global__ void phase1_exact_kernel(const float4* __restrict__ o4,
                                    const float4* __restrict__ d4,
                                    const float* __restrict__ t0,
                                    const int* __restrict__ act,
                                    const float* __restrict__ bb,
                                    float* __restrict__ key, int K, int sub) {
  extern __shared__ float smem[];
  float* sbb = smem;              // [K, 6] boxes
  float* red = smem + 6 * K;      // [n_warps, 32] partial minima
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int i = tid; i < 6 * K; i += blockDim.x) sbb[i] = bb[i];

  const long r = static_cast<long>(s) * sub + tid;
  const float4 o = o4[r];
  const float4 d = d4[r];
  const float ivx = 1.0f / d.x, ivy = 1.0f / d.y, ivz = 1.0f / d.z;
  const float tr = t0[r];
  const bool active = act[r] > 0;
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += 32) {
    float mine = MRT_INF;
    for (int c = 0; c < 32; ++c) {
      const int k = k0 + c;
      float v = MRT_INF;
      if (k < K) {
        float tmin;
        const bool hit = slab(o.x, o.y, o.z, ivx, ivy, ivz, sbb + 6 * k, &tmin);
        if (hit && active && tmin <= tr) v = nmax(tmin, 0.0f);
      }
      for (int off = 16; off > 0; off >>= 1)
        v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == c) mine = v;
    }
    red[warp * 32 + lane] = mine;
    __syncthreads();
    if (warp == 0) {
      float m = red[lane];
      for (int w = 1; w < n_warps; ++w) m = fminf(m, red[w * 32 + lane]);
      if (k0 + lane < K) key[static_cast<long>(s) * K + k0 + lane] = m;
    }
    __syncthreads();
  }
}

}  // namespace

// o4, d4 [S*sub, 4]; t0, act [S*sub]; bb [K, 6]; key [S, K] (output).
extern "C" int mrt_phase1_exact(const void* o4, const void* d4, const void* t0,
                                const void* act, const void* bb, void* key,
                                int S, int K, int sub, void* stream) {
  const size_t smem = sizeof(float) * (6 * static_cast<size_t>(K) + 32 * (sub / 32));
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
