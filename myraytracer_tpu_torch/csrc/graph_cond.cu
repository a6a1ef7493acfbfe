// CUDA-graph IF nodes for a stream capture in progress: the port's
// counterpart of lax.cond inside a captured entry point (ops/graphs.py,
// if_node). CUDA 12.4 or later.
//
// mrt_if_node_begin, on a stream that is capturing a graph:
//   1. creates a conditional handle in the graph being captured, reset to
//      0 at every launch of the graph;
//   2. captures a one-thread kernel that sets the handle from the 0-d
//      bool tensor `pred` on the device;
//   3. adds an IF node after it and makes it the capturing stream's only
//      dependency, so that everything captured later runs after the node;
//   4. starts capturing `body_stream` into the node's body graph.
// What the caller launches on `body_stream` until mrt_if_node_end runs in
// a replay only where `pred` held when the node was reached.
#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" int mrt_if_node_begin(const void* pred, void* stream,
                                 void* body_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                             &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) {
    return static_cast<int>(cudaErrorIllegalState);
  }
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_condition_kernel<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the dependencies now end at the kernel just captured
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraph_t body = params.conditional.phGraph_out[0];
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), body, nullptr, nullptr, 0,
      cudaStreamCaptureModeThreadLocal));
}

// The nodes of the graph that `stream` is capturing, so far, into *n (an
// IF node counts as one; its body is a graph of its own).
extern "C" int mrt_capture_nodes(void* stream, size_t* n) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t err = cudaStreamGetCaptureInfo(
      static_cast<cudaStream_t>(stream), &status, nullptr, &graph, nullptr,
      nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) {
    return static_cast<int>(cudaErrorIllegalState);
  }
  return static_cast<int>(cudaGraphGetNodes(graph, nullptr, n));
}

// Ends the body's capture that mrt_if_node_begin started on body_stream.
extern "C" int mrt_if_node_end(void* body_stream) {
  cudaGraph_t body;
  return static_cast<int>(
      cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body));
}
