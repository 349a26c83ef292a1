// graph_cond: a conditional IF node with an ELSE body inside a CUDA graph
// that is being captured, for Hopper (sm_90a).
//
// Replaces no TPU kernel. It is the counterpart of XLA's `conditional`,
// which `lax.cond(pred, branch, identity, state)` lowers to under
// `jax.jit` outside `vmap`: genparticlefilters_tpu/smc/algorithms.py:65 and
// :112, models/object_motion.py:107. Only the taken branch runs, and the
// predicate never leaves the device. Its plain version is
// genparticlefilters_tpu_torch/smc/capture.py `_select`, which runs both
// sides and picks with `torch.where`.
//
// Contract. graph_cond_begin(pred, bodies, stream) is called while
// `stream` captures a graph G. It
//   1. reads G and the stream's dependencies (cudaStreamGetCaptureInfo);
//   2. creates a conditional handle on G (default 0, reset at every launch);
//   3. captures a one-thread kernel that sets the handle from the byte at
//      `pred` (a bool on the card), so the predicate is read at replay;
//   4. adds an IF node with two bodies, THEN and ELSE (CUDA 12.8 and
//      later, in the toolkit and the driver), that depends on that kernel,
//      and makes the node the stream's only dependency: what the stream
//      captures next runs after the whole node;
//   5. returns the two body graphs in `bodies`. The node owns them.
// graph_cond_body_begin(body, mode, stream) and graph_cond_body_end(stream)
// capture the work queued on another `stream` into one body
// (cudaStreamBeginCaptureToGraph). A body may hold kernels, memsets,
// device-to-device copies, child graphs and conditional nodes; an event
// record or wait, or a host node, fails the capture.
//
// What bounds it: latency, not bytes or operations. At replay the shim
// adds one kernel of one thread that reads one byte and the node's launch
// of the taken body; the untaken body's kernels never launch. The design
// is the documented capture pattern for conditional nodes; the only
// device code is the handle's setter.

#include <cuda_runtime.h>

#if CUDART_VERSION < 12080
#error "graph_cond needs CUDA 12.8 or later: an IF node with an ELSE body"
#endif

// error codes of the shim's own, below CUDA's
#define GRAPH_COND_NOT_CAPTURING -1
#define GRAPH_COND_OLD_DRIVER -2

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle,
                                       const unsigned char* pred) {
  cudaGraphSetConditional(handle, pred[0] != 0 ? 1u : 0u);
}

// CUDA 13 passes edge data beside the dependencies (the 13.x branches
// below are not yet built on the card, whose toolkit is 12.9)
static cudaError_t capture_info(cudaStream_t stream,
                                cudaStreamCaptureStatus* status,
                                cudaGraph_t* graph,
                                const cudaGraphNode_t** deps, size_t* n) {
#if CUDART_VERSION >= 13000
  const cudaGraphEdgeData* edges = nullptr;
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps,
                                  &edges, n);
#else
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps, n);
#endif
}

// The CUDA runtime the library was built against and the driver's.
extern "C" int graph_cond_versions(int* runtime, int* driver) {
  cudaError_t err = cudaRuntimeGetVersion(runtime);
  if (err == cudaSuccess) err = cudaDriverGetVersion(driver);
  return (int)err;
}

extern "C" const char* graph_cond_error(int err) {
  if (err == GRAPH_COND_NOT_CAPTURING) {
    return "the stream is not capturing a graph";
  }
  if (err == GRAPH_COND_OLD_DRIVER) {
    return "an ELSE body needs a driver for CUDA 12.8 or later";
  }
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int graph_cond_begin(const void* pred, void** bodies,
                                void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  int driver = 0;
  cudaError_t err = cudaDriverGetVersion(&driver);
  if (err != cudaSuccess) return (int)err;
  if (driver < 12080) return GRAPH_COND_OLD_DRIVER;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  err = capture_info(stream, &status, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) {
    return GRAPH_COND_NOT_CAPTURING;
  }
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return (int)err;
  set_conditional_kernel<<<1, 1, 0, stream>>>(
      handle, (const unsigned char*)pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the setter kernel is now the stream's dependency
  err = capture_info(stream, &status, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  // aggregate initialisation: every other field zero, as the API asks
  cudaGraphNodeParams params = {cudaGraphNodeTypeConditional};
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 2;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
  if (err != cudaSuccess) return (int)err;
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(stream, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  bodies[0] = (void*)params.conditional.phGraph_out[0];
  bodies[1] = (void*)params.conditional.phGraph_out[1];
  return 0;
}

extern "C" int graph_cond_body_begin(void* body, int mode, void* stream) {
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)stream, (cudaGraph_t)body, nullptr, nullptr, 0,
      (cudaStreamCaptureMode)mode);
}

extern "C" int graph_cond_body_end(void* stream) {
  cudaGraph_t body = nullptr;
  return (int)cudaStreamEndCapture((cudaStream_t)stream, &body);
}
