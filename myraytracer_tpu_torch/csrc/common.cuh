// Shared constants and helpers of the port's kernels.
//
// The constants equal the Python ones (ops/intersect.py, ops/shade.py,
// utils/vecmath.py) rounded to float32, the way PyTorch compares a float32
// tensor with a Python scalar. Expressions keep the operand order of the
// plain PyTorch versions; kernels/_build.py says which sources are built
// without FMA contraction.
#pragma once

#include <cuda_runtime.h>

#define MRT_INF 3.0e38f
#define MRT_EPS_HIT 1e-5f
#define MRT_EPS_DET 1e-10f
#define MRT_EPS_OFFSET 1e-4f
#define MRT_EPS_NORMALIZE 1e-20f
#define MRT_EPS_PARALLEL 1e-9f
// ray_cylinder's guard for a ray parallel to the axis
#define MRT_EPS_AXIS 1e-12f

// NaN-propagating min/max, the semantics of torch.minimum/torch.maximum
// (fminf/fmaxf would drop a NaN operand instead).
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// (ax*bx + ay*by) + az*bz, the evaluation order of the Python expression
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// vecmath.normalize's guard: near-zero vectors normalize to 0
__device__ __forceinline__ float safe_rsqrt(float n2) {
  return n2 > MRT_EPS_NORMALIZE ? rsqrtf(fmaxf(n2, MRT_EPS_NORMALIZE)) : 0.0f;
}

// Slab test of one ray against one box: entry distance and hit flag,
// ray_aabb's math (ops/intersect.py).
__device__ __forceinline__ bool slab(float ox, float oy, float oz, float ivx,
                                     float ivy, float ivz, const float* bb,
                                     float* tmin_out) {
  const float x0 = (bb[0] - ox) * ivx, x1 = (bb[3] - ox) * ivx;
  const float y0 = (bb[1] - oy) * ivy, y1 = (bb[4] - oy) * ivy;
  const float z0 = (bb[2] - oz) * ivz, z1 = (bb[5] - oz) * ivz;
  const float tmin = nmax(nmax(nmin(x0, x1), nmin(y0, y1)), nmin(z0, z1));
  const float tmax = nmin(nmin(nmax(x0, x1), nmax(y0, y1)), nmax(z0, z1));
  *tmin_out = tmin;
  return (tmax >= tmin) && (tmax > MRT_EPS_HIT);
}

// Launch helper: raise the block's dynamic shared memory limit past the
// 48 KB default when a launch needs it.
template <typename Kernel>
__host__ inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
