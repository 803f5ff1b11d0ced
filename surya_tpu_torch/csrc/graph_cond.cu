// The IF node of a captured AR loop: the counterpart of the `cond` of the
// JAX package's jax.lax.while_loop (surya_tpu/models/foundation.py
// decode_chunk, layout_model.py and table_rec_model.py generate), for the
// loops that surya_tpu_torch/common/graphs.py captures as CUDA graphs.
//
// A loop step is captured inside a conditional (IF) node whose condition a
// one-thread kernel sets from a device bool, the JAX cond computed by the
// step before. When every row is done the condition is 0 and the card skips
// the remaining steps' bodies without a visit from the host, as the
// while_loop exits on the device.
//
// PyTorch 2.11 has no binding for conditional nodes, so the node is built
// here through the CUDA runtime (12.4 and later): the stream's capture
// graph and its current dependencies (cudaStreamGetCaptureInfo), a
// conditional handle (cudaGraphConditionalHandleCreate), the set-condition
// kernel captured on the stream, the IF node added after it
// (cudaGraphAddNode), the stream's dependencies moved past the node
// (cudaStreamUpdateCaptureDependencies), and the node's body graph captured
// from a second stream (cudaStreamBeginCaptureToGraph) until
// surya_graph_if_end. The cost on the card is one launch of one thread per
// step, and one node's scheduling.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

// Begin an IF node on `stream`, which must be capturing: its body runs when
// the device bool at `pred` is true at that point of the graph. The work
// that `body_stream` takes from here to surya_graph_if_end is the body.
extern "C" int surya_graph_if_begin(void* stream, const void* pred, void* body_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  set_condition<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0],
                                            nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

// End the body that surya_graph_if_begin started on `body_stream`.
extern "C" int surya_graph_if_end(void* body_stream) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
}
