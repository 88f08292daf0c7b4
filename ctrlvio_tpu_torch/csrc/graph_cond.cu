// CUDA-graph IF nodes for captured programs (`utils/graphs.py::run_if`).
//
// Not a kernel port: the JAX package leaves its LM loop with
// `lax.while_loop` (ctrlvio_tpu/solver/lm.py:225-252), which XLA compiles
// into a device-side loop. A captured CUDA graph holds the same exit as a
// conditional node: while a stream is captured, `if_begin` adds to its graph
// a one-thread kernel that copies a device bool into a new conditional
// handle, then an IF node on that handle after it (so the stream's later
// work depends on the node), and starts capturing a second stream into a
// graph of its own. `if_end` ends that capture and, if it succeeded, puts
// the captured graph into the node's body as a child graph. (Capturing
// straight into the node's body would leave a failed capture, one that met
// a host read, destroying a graph the node owns.) A replay runs the body
// only where the bool was true when the kernel ran. Needs CUDA 12.4 or
// later (conditional nodes added through `cudaGraphAddNode`).
//
// Bound: one byte read a node; the kernel's launch is the whole cost.
//
// Plain C interface for ctypes; every function returns a cudaError_t.

#include <cuda_runtime.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" {

// A non-blocking stream of the current device, for bodies to be captured on
// (never one that takes part in another capture).
int if_stream_create(void** out) {
  cudaStream_t s = nullptr;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = s;
  return err;
}

// `stream` is being captured: append the set kernel reading `pred` (a device
// bool) and an IF node after it to the captured graph, make the node the
// stream's only dependency, return the node's body graph in `*body`, and
// begin capturing `body_stream`.
int if_begin(void* stream, const void* pred, void* body_stream,
             void** body) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(st, &status, &id, &graph);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return err;
  set_if_kernel<<<1, 1, 0, st>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaStreamGetCaptureInfo(st, &status, &id, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(st, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  *body = params.conditional.phGraph_out[0];
  return cudaStreamBeginCapture(static_cast<cudaStream_t>(body_stream),
                                cudaStreamCaptureModeGlobal);
}

// End the capture begun by `if_begin` on `body_stream`; if it succeeded,
// add what it captured to the node's `body` graph as a child graph.
int if_end(void* body_stream, void* body) {
  cudaGraph_t captured = nullptr;
  cudaError_t err =
      cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &captured);
  if (err != cudaSuccess) return err;
  cudaGraphNode_t child;
  err = cudaGraphAddChildGraphNode(&child, static_cast<cudaGraph_t>(body),
                                   nullptr, 0, captured);
  cudaError_t err2 = cudaGraphDestroy(captured);
  return err != cudaSuccess ? err : err2;
}

const char* if_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
