// The conditional nodes of a captured program: the counterpart of the
// `cond` of the JAX package's jax.lax.while_loop, for the programs that
// surya_tpu_torch/common/graphs.py captures as CUDA graphs.
//
// IF node: a step of an AR loop (surya_tpu/models/foundation.py
// decode_chunk, layout_model.py and table_rec_model.py generate) is captured
// inside an IF node whose condition a one-thread kernel sets from a device
// bool, the JAX cond computed by the step before. When every row is done the
// condition is 0 and the card skips the remaining steps' bodies without a
// visit from the host, as the while_loop exits on the device.
//
// WHILE node: a loop of unknown trip count (detection's connected-component
// flood, surya_tpu/ops/connected_components.py label_components) is one
// WHILE node. A one-thread kernel sets its condition from a device bool
// before the node, and the body's last kernel sets it again from the bool
// the body wrote, so the card reads the cond when the node starts and after
// each run of the body, as the while_loop does.
//
// PyTorch has no binding for conditional nodes, so a node is built here
// through the CUDA runtime (12.4 and later): the stream's capture graph and
// its current dependencies (cudaStreamGetCaptureInfo), a conditional handle
// (cudaGraphConditionalHandleCreate), the set-condition kernel captured on
// the stream, the node added after it (cudaGraphAddNode), the stream's
// dependencies moved past the node (cudaStreamUpdateCaptureDependencies),
// and the node's body graph captured from a second stream
// (cudaStreamBeginCaptureToGraph) until surya_graph_if_end or
// surya_graph_while_end. The cost on the card is one launch of one thread
// per node (and per run of a WHILE body), and one node's scheduling.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

// Add a conditional node of `type` after the work captured so far on
// `stream`, its condition set from the device bool at `pred` just before
// it, and start capturing its body on `body_stream`. Returns the node's
// handle in *handle_out.
static int cond_begin(void* stream, const void* pred, void* body_stream, cudaGraphConditionalNodeType type,
                      cudaGraphConditionalHandle* handle_out) {
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
  params.conditional.type = type;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  *handle_out = handle;
  return (int)cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0],
                                            nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

// Begin an IF node on `stream`, which must be capturing: its body runs when
// the device bool at `pred` is true at that point of the graph. The work
// that `body_stream` takes from here to surya_graph_if_end is the body.
extern "C" int surya_graph_if_begin(void* stream, const void* pred, void* body_stream) {
  cudaGraphConditionalHandle handle;
  return cond_begin(stream, pred, body_stream, cudaGraphCondTypeIf, &handle);
}

// End the body that surya_graph_if_begin started on `body_stream`.
extern "C" int surya_graph_if_end(void* body_stream) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
}

// Begin a WHILE node on `stream`, which must be capturing: its body runs
// while the device bool at `pred` is true, read when the node starts and
// after each run of the body, which must write it. The work that
// `body_stream` takes from here to surya_graph_while_end is the body; the
// node's handle goes to *handle_out, for surya_graph_while_end.
extern "C" int surya_graph_while_begin(void* stream, const void* pred, void* body_stream,
                                       unsigned long long* handle_out) {
  cudaGraphConditionalHandle handle;
  int err = cond_begin(stream, pred, body_stream, cudaGraphCondTypeWhile, &handle);
  *handle_out = (unsigned long long)handle;
  return err;
}

// End the body that surya_graph_while_begin started on `body_stream`: its
// last kernel sets the node's condition from the device bool at `pred`.
extern "C" int surya_graph_while_end(void* body_stream, const void* pred, unsigned long long handle) {
  cudaStream_t b = static_cast<cudaStream_t>(body_stream);
  set_condition<<<1, 1, 0, b>>>((cudaGraphConditionalHandle)handle, static_cast<const bool*>(pred));
  cudaError_t launched = cudaGetLastError();
  cudaGraph_t body;
  cudaError_t ended = cudaStreamEndCapture(b, &body);
  return (int)(launched != cudaSuccess ? launched : ended);
}
