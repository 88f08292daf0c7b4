// CUDA-graph WHILE nodes for captured programs (`utils/graphs.py::
// run_while`).
//
// Not a kernel port: the JAX package runs its LM loop as `lax.while_loop`
// (ctrlvio_tpu/solver/lm.py:225-252), which XLA compiles into a device-side
// loop. A captured CUDA graph holds the same loop as a conditional node of
// type WHILE: while a stream is captured, `cond_handle_create` makes a
// conditional handle on the captured graph (default 1, assigned at each
// launch of the graph), which a kernel captured before the node sets (the
// LM's first accept step, K4 in `lm_accept.cu`); `while_begin` adds the
// WHILE node on that handle after the stream's work (so the stream's later
// work depends on the node), and starts capturing a second stream into a
// graph of its own; `while_end` ends that capture and, if it succeeded,
// puts the captured graph into the node's body as a child graph. A kernel
// of the body (the next accept step) sets the handle again: the node runs
// its body while the handle is non-zero, testing it before each trip.
// (Capturing straight into the node's body would leave a failed capture,
// one that met a host read, destroying a graph the node owns. A kernel in
// the child graph can set the node's handle: probed on an H100 with the
// CUDA 12.9 runtime.) Needs CUDA 12.4 or later.
//
// There is no kernel here: the condition's writer is K4, which decides it.
//
// Plain C interface for ctypes; every function returns a cudaError_t.

#include <cuda_runtime.h>

extern "C" {

// A non-blocking stream of the current device, for bodies to be captured on
// (never one that takes part in another capture).
int cond_stream_create(void** out) {
  cudaStream_t s = nullptr;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = s;
  return err;
}

// `stream` is being captured: a conditional handle on its graph, 1 at each
// launch of the graph until a kernel sets it.
int cond_handle_create(void* stream, unsigned long long* handle) {
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream),
                                             &status, &id, &graph);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle h;
  err = cudaGraphConditionalHandleCreate(&h, graph, 1,
                                         cudaGraphCondAssignDefault);
  *handle = h;
  return err;
}

// `stream` is being captured: append a WHILE node on `handle` to the
// captured graph after the stream's work, make the node the stream's only
// dependency, return the node's body graph in `*body`, and begin capturing
// `body_stream`.
int while_begin(void* stream, unsigned long long handle, void* body_stream,
                void** body) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err =
      cudaStreamGetCaptureInfo(st, &status, &id, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
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

// End the capture begun by `while_begin` on `body_stream`; if it succeeded,
// add what it captured to the node's `body` graph as a child graph.
int while_end(void* body_stream, void* body) {
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

const char* cond_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
