// graph_cond: a conditional IF node inside a CUDA graph that is being
// captured, and the one kernel its bodies copy leaves with, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel. It is the counterpart of XLA's `conditional`,
// which `lax.cond(pred, branch, identity, state)` lowers to under
// `jax.jit` outside `vmap`: genparticlefilters_tpu/smc/algorithms.py:65 and
// :112, models/object_motion.py:107. Only the taken branch runs, and the
// predicate never leaves the device. Its plain version is
// genparticlefilters_tpu_torch/smc/capture.py `_select`, which runs both
// sides and picks with `torch.where`.
//
// Contract. graph_cond_begin(pred, bodies, n, stream) is called while
// `stream` captures a graph G. It
//   1. reads G and the stream's dependencies (cudaStreamGetCaptureInfo);
//   2. creates a conditional handle on G (default 0, reset at every launch);
//   3. captures a one-thread kernel that sets the handle from the byte at
//      `pred` (a bool on the card), so the predicate is read at replay;
//   4. adds an IF node with n bodies: n = 1 a THEN body only, n = 2 a THEN
//      and an ELSE body (CUDA 12.8 and later, in the toolkit and the
//      driver; the shim asks 12.8 of both for either form), that depends
//      on that kernel, and makes the node the stream's only dependency:
//      what the stream captures next runs after the whole node;
//   5. returns the n body graphs in `bodies`. The node owns them.
// graph_cond_body_begin(body, mode, stream) and graph_cond_body_end(stream)
// capture the work queued on another `stream` into one body
// (cudaStreamBeginCaptureToGraph). A body may hold kernels, memsets,
// device-to-device copies, child graphs and conditional nodes; an event
// record or wait, or a host node, fails the capture.
//
// What bounds the node: latency, not bytes or operations. At replay it
// adds one kernel of one thread that reads one byte and the node's launch
// of the taken body; an untaken body's kernels never launch. The design
// is the documented capture pattern for conditional nodes; the setter is
// its only device code.
//
// copy_leaves(dst, src, bytes, n, stream) copies n (dst, src, bytes)
// triples in one launch of copy_leaves_kernel. It replaces the per-leaf
// `Tensor.copy_` that a body made for every leaf a branch replaced (one
// kernel per leaf, up to 8 per ESS check on the headline filter). What
// bounds it: bytes, each source read once and each destination written
// once, 2 x bytes over 3.35 TB/s. Its design: the triples go by value in
// one parameter struct (under the 4 KB a kernel takes; a caller with
// more triples launches again), each leaf cut into 16 KiB chunks and the
// chunks of all leaves spread over up to 8 blocks of 256 threads per SM,
// each thread moving 4 units at a time, loads before stores. A unit is
// 16 bytes where both pointers are 16-byte aligned, else the widest of
// 8, 4, 2 and 1 that both allow; the bytes past the last whole unit go
// one by one. The source and destination of one triple must not overlap.
// Each launch adds one to a counter on the card (copy_leaves_runs_read),
// which counts the executions inside a graph's replays too.

#include <cuda_runtime.h>

#if CUDART_VERSION < 12080
#error "graph_cond needs CUDA 12.8 or later: an IF node with an ELSE body"
#endif

// error codes of the shim's own, below CUDA's
#define GRAPH_COND_NOT_CAPTURING -1
#define GRAPH_COND_OLD_DRIVER -2
#define GRAPH_COND_BAD_ARGUMENT -3

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
  if (err == GRAPH_COND_BAD_ARGUMENT) {
    return "an IF node has 1 or 2 bodies, and copy_leaves takes 1 to "
           "copy_leaves_max() triples of sizes 0 to 2^31 chunks";
  }
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int graph_cond_begin(const void* pred, void** bodies, int n,
                                void* stream_) {
  if (n != 1 && n != 2) return GRAPH_COND_BAD_ARGUMENT;
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
  params.conditional.size = (unsigned int)n;
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
  for (int i = 0; i < n; ++i) {
    bodies[i] = (void*)params.conditional.phGraph_out[i];
  }
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

// ---------------------------------------------------------------------------
// copy_leaves
// ---------------------------------------------------------------------------

#define COPY_LEAVES_MAX 112       // triples per launch
constexpr int kThreads = 256;
constexpr int kUnroll = 4;        // units in flight per thread
constexpr long long kChunk = (long long)kThreads * kUnroll * 16;  // 16 KiB
constexpr int kBlocksPerSM = 8;   // 2,048 threads: a full SM

struct CopyLeavesParams {
  char* dst[COPY_LEAVES_MAX];
  const char* src[COPY_LEAVES_MAX];
  long long bytes[COPY_LEAVES_MAX];
  int chunk_start[COPY_LEAVES_MAX + 1];  // leaf i: chunks [start[i], start[i+1])
  unsigned char unit[COPY_LEAVES_MAX];   // bytes per unit: 16, 8, 4, 2 or 1
  int n;
};
static_assert(sizeof(CopyLeavesParams) <= 4096,
              "a kernel's parameters stay under 4 KB");

// copy_leaves_kernel executions since the last reset, one per launch: a
// replay's launches read on the card, where a profiler may drop the
// records of kernels inside conditional bodies
__device__ unsigned long long copy_leaves_runs = 0;

// bytes [lo, hi) of one leaf in units of T (lo and hi multiples of
// sizeof(T)); kUnroll loads in flight before their stores
template <typename T>
__device__ __forceinline__ void copy_units(char* __restrict__ dst,
                                           const char* __restrict__ src,
                                           long long lo, long long hi) {
  const long long step = (long long)kThreads * sizeof(T);
  for (long long base = lo + threadIdx.x * (long long)sizeof(T); base < hi;
       base += kUnroll * step) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      long long off = base + u * step;
      if (off < hi) v[u] = *reinterpret_cast<const T*>(src + off);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      long long off = base + u * step;
      if (off < hi) *reinterpret_cast<T*>(dst + off) = v[u];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
copy_leaves_kernel(const CopyLeavesParams p) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&copy_leaves_runs, 1ULL);
  const int total = p.chunk_start[p.n];
  int i = 0;
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    while (c >= p.chunk_start[i + 1]) ++i;  // c only grows: i only grows
    const long long bytes = p.bytes[i];
    const long long lo = (long long)(c - p.chunk_start[i]) * kChunk;
    const long long hi = lo + kChunk < bytes ? lo + kChunk : bytes;
    const int unit = p.unit[i];
    const long long whole = bytes / unit * unit;  // end of the whole units
    const long long vhi = hi < whole ? hi : whole;
    char* dst = p.dst[i];
    const char* src = p.src[i];
    switch (unit) {
      case 16: copy_units<int4>(dst, src, lo, vhi); break;
      case 8: copy_units<long long>(dst, src, lo, vhi); break;
      case 4: copy_units<int>(dst, src, lo, vhi); break;
      case 2: copy_units<short>(dst, src, lo, vhi); break;
      default: copy_units<char>(dst, src, lo, vhi); break;
    }
    // fewer than `unit` bytes past the last whole unit, in the last chunk
    const long long tail = (lo > whole ? lo : whole) + threadIdx.x;
    if (tail < hi) dst[tail] = src[tail];
  }
}

extern "C" int copy_leaves_max() { return COPY_LEAVES_MAX; }

// the counter's value into `runs`, then 0 into the counter if `reset`
extern "C" int copy_leaves_runs_read(unsigned long long* runs, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(runs, copy_leaves_runs,
                                         sizeof(*runs));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    err = cudaMemcpyToSymbol(copy_leaves_runs, &zero, sizeof(zero));
  }
  return (int)err;
}

extern "C" int copy_leaves(void* const* dst, const void* const* src,
                           const long long* bytes, int n, void* stream) {
  if (n < 1 || n > COPY_LEAVES_MAX) return GRAPH_COND_BAD_ARGUMENT;
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    }
    if (err != cudaSuccess) return (int)err;
  }
  CopyLeavesParams p;
  p.n = n;
  p.chunk_start[0] = 0;
  for (int i = 0; i < n; ++i) {
    if (bytes[i] < 0) return GRAPH_COND_BAD_ARGUMENT;
    p.dst[i] = (char*)dst[i];
    p.src[i] = (const char*)src[i];
    p.bytes[i] = bytes[i];
    unsigned long long both = (unsigned long long)dst[i] |
                              (unsigned long long)src[i];
    int unit = 16;
    while (unit > 1 && both % unit != 0) unit /= 2;
    p.unit[i] = (unsigned char)unit;
    long long chunks = (bytes[i] + kChunk - 1) / kChunk;
    if (p.chunk_start[i] + chunks > 0x7fffffffLL) {
      return GRAPH_COND_BAD_ARGUMENT;
    }
    p.chunk_start[i + 1] = p.chunk_start[i] + (int)chunks;
  }
  const int total = p.chunk_start[n];
  if (total == 0) return 0;
  const int cap = sms * kBlocksPerSM;
  const int blocks = total < cap ? total : cap;
  copy_leaves_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
