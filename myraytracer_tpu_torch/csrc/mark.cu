// Device phase marks (utils/profiling.mark): one empty kernel per phase of
// utils/profiling.PHASES, mrt_mark<P> for PHASES[P]. A mark is launched on
// the caller's stream, so a graph capture records it as a kernel node and
// a profile of a replay shows it under its own name on the device clock:
// the phase it opens lasts until the next mark. A mark inside an IF node's
// body runs only when the body runs.
#include <cuda_runtime.h>

#include <utility>

// the number of phases, len(utils/profiling.PHASES)
#define MRT_N_PHASES 18

template <int P>
__global__ void mrt_mark() {}

namespace {

// mrt_mark<phase> for 0 <= phase < MRT_N_PHASES
template <int... P>
const void* mark_kernel(int phase, std::integer_sequence<int, P...>) {
  static const void* const table[] = {
      reinterpret_cast<const void*>(&mrt_mark<P>)...};
  return table[phase];
}

}  // namespace

// The number of phases the library holds a kernel for.
extern "C" int mrt_mark_phases() { return MRT_N_PHASES; }

// Launches mrt_mark<phase> (one thread, no work) on `stream`.
extern "C" int mrt_mark(int phase, void* stream) {
  if (phase < 0 || phase >= MRT_N_PHASES) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaLaunchKernel(
      mark_kernel(phase, std::make_integer_sequence<int, MRT_N_PHASES>()),
      dim3(1), dim3(1), nullptr, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
