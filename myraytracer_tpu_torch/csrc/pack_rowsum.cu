// K12: the backward of the shade pack's material gather, mat16[tri_mat]
// (ops/shade.pack_shade_geom, ops/row_sum.py): the cotangent of the
// gathered rows, g [T, 16], summed into g_mat [M, 16] by material id.
//
// Replaces no TPU kernel: the JAX package leaves that scatter-add to XLA.
// In the port PyTorch's backward of the gather (index_put_ with
// accumulation) sorts the T ids on every step and walks each run of equal
// ids serially; on the office (18,664 triangles, about 20 materials, so
// about 900 rows a material) that took 0.77 ms for 1.2 MB.
//
// K12 sums in a fixed order that depends only on T, M and the launch
// shape, with no float atomics and no sort, so a captured graph and an
// eager call give the same bits, and so does ops/row_sum.row_sum_plain:
//   pass 1, rowsum_part_kernel, grid (ranges of kChunk rows, M): block
//     (r, m) reads the ids of rows r * kChunk .. + kChunk; thread j adds,
//     in the order k = 0 .. kPer - 1, row r * kChunk + k * kThreads + j
//     where its id is m into 16 registers (four 16-byte loads); then the
//     lanes of each warp by a shuffle tree (v[i] += v[i + o], o = 16, 8,
//     4, 2, 1), then the warps' sums (w0 + w2, w1 + w3, then those two)
//     into part [ranges, M, 16];
//   pass 2, rowsum_final_kernel: one thread per (m, column) adds the
//     ranges' partials in range order.
// Every block of pass 1 reads its range's ids again, once a material, and
// only its own material's rows, so the traffic is about 4 B x T x M of ids
// (mostly from L2) plus each row once: on the office 1.5 MB + 1.2 MB, with
// 19 x 20 blocks to fill the card.
//
// Bound on the H100: memory latency (two short passes of a few loads
// each); by bytes, T x 64 B of rows and T x 4 B of ids read once and M x
// 64 B written, under 1 us at 3.35 TB/s.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;            // pass 1's block: 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                  // rows a thread visits in a range
constexpr int kChunk = kThreads * kPer;  // rows of a range
constexpr int kCols = 16;
constexpr int kFinal = 256;              // pass 2's block
constexpr unsigned kFull = 0xffffffffu;

int ranges_of(int T) { return (T + kChunk - 1) / kChunk; }

__global__ void __launch_bounds__(kThreads)
    rowsum_part_kernel(const float* __restrict__ g, int ld,
                       const int* __restrict__ ids, int T, int M,
                       float* __restrict__ part) {
  const int r = blockIdx.x, m = blockIdx.y, j = threadIdx.x;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
  const int first = r * kChunk + j;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int t = first + k * kThreads;
    if (t < T && __ldg(ids + t) == m) {
      const float4* row =
          reinterpret_cast<const float4*>(g + static_cast<long long>(t) * ld);
#pragma unroll
      for (int q = 0; q < kCols / 4; ++q) {
        const float4 v = __ldg(row + q);
        acc[4 * q] += v.x;
        acc[4 * q + 1] += v.y;
        acc[4 * q + 2] += v.z;
        acc[4 * q + 3] += v.w;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      acc[c] += __shfl_down_sync(kFull, acc[c], o);
  }
  __shared__ float s_warp[kWarps][kCols];
  if ((j & 31) == 0) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) s_warp[j >> 5][c] = acc[c];
  }
  __syncthreads();
  if (j < kCols) {
    const float a = s_warp[0][j] + s_warp[2][j];
    const float b = s_warp[1][j] + s_warp[3][j];
    part[(static_cast<long long>(r) * M + m) * kCols + j] = a + b;
  }
}

__global__ void __launch_bounds__(kFinal)
    rowsum_final_kernel(const float* __restrict__ part, int ranges, int M,
                        float* __restrict__ out) {
  const int i = blockIdx.x * kFinal + threadIdx.x;  // m * 16 + column
  if (i >= M * kCols) return;
  float s = 0.0f;
  for (int r = 0; r < ranges; ++r)
    s += __ldg(part + static_cast<long long>(r) * M * kCols + i);
  out[i] = s;
}

}  // namespace

// K12's partials, in floats, for T rows and M materials.
extern "C" long long mrt_pack_rowsum_workspace(int T, int M) {
  return static_cast<long long>(ranges_of(T)) * M * kCols;
}

// g: [T] rows of 16 floats, row stride ld floats (a multiple of 4, g
// 16-byte aligned); ids [T] int32 in [0, M); part:
// mrt_pack_rowsum_workspace floats; out [M, 16] f32, written whole.
extern "C" int mrt_pack_rowsum(const void* g, int ld, const void* ids, int T,
                               int M, void* part, void* out, void* stream) {
  if (M == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ranges = ranges_of(T);
  if (ranges > 0) {
    rowsum_part_kernel<<<dim3(ranges, M), kThreads, 0, s>>>(
        static_cast<const float*>(g), ld, static_cast<const int*>(ids), T, M,
        static_cast<float*>(part));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rowsum_final_kernel<<<(M * kCols + kFinal - 1) / kFinal, kFinal, 0, s>>>(
      static_cast<const float*>(part), ranges, M, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
