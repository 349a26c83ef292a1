// span_log: device-side span markers that survive CUDA-graph capture, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel. A `torch.profiler` span is a host annotation: in
// a captured filter run it fires once, while the graph is recorded, and
// never at a replay. genparticlefilters_tpu_torch/utils/spans.py `span`
// adds, where a graph is captured under a running profiler, one launch of
// span_mark_kernel at the span's entry and one at its exit, so each
// replay writes its phases' times on the card, IF bodies included (a body
// that does not run writes nothing).
//
// Contract. span_log_mark(tag, stream) launches span_mark_kernel on
// `stream` (captured there as a kernel node when the stream captures). The
// kernel, one thread, appends one record to the log that lives on the
// card: the tag (span id << 1 | 1 at exit, 0 at entry) and the card's
// %globaltimer in ns. The log holds SPAN_LOG_CAPACITY records of 16 bytes
// (2^20, 16 MiB); an atomic index hands out the slots, and a record past
// the capacity is counted and dropped: span_log_count gives the records
// attempted since the last reset, so count - capacity were dropped.
// span_log_copy copies the first n records to the host, span_log_reset
// sets the index to 0; both act through the default stream, so the
// caller synchronizes first. span_log_ready loads the module (and its
// log) now, so that no module load falls inside a capture.
//
// span_log_graph_nodes(bodies, n, counts, stream) walks the graph that
// `stream` is capturing and the n body graphs given (the IF nodes' bodies,
// which the caller holds), child graphs included, and counts its nodes,
// kernel nodes, span_mark_kernel nodes and conditional nodes: the check
// that a capture made without the profiler holds no marker.
//
// What bounds a marker: latency. It is one kernel node of one thread that
// reads a clock and writes 16 bytes, ~2-3 us of a graph's node latency on
// the H100 at replay.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstring>

#if CUDART_VERSION < 12050
#error "span_log's graph walk needs CUDA 12.5 or later (cudaGetDriverEntryPointByVersion)"
#endif

#define SPAN_LOG_CAPACITY (1ULL << 20)

struct SpanRecord {
  unsigned int tag;  // span id << 1, | 1 at the span's exit
  unsigned int pad;
  unsigned long long ns;  // %globaltimer
};
static_assert(sizeof(SpanRecord) == 16, "a record is 16 bytes");

__device__ SpanRecord span_log[SPAN_LOG_CAPACITY];
// records attempted since the last reset, dropped ones included
__device__ unsigned long long span_log_next = 0;

__global__ void span_mark_kernel(unsigned int tag) {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  const unsigned long long i = atomicAdd(&span_log_next, 1ULL);
  if (i < SPAN_LOG_CAPACITY) {
    span_log[i].tag = tag;
    span_log[i].pad = 0;
    span_log[i].ns = ns;
  }
}

extern "C" unsigned long long span_log_capacity() { return SPAN_LOG_CAPACITY; }

extern "C" const char* span_log_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int span_log_ready() {
  void* ptr = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&ptr, span_log_next);
  if (err == cudaSuccess) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, span_mark_kernel);
  }
  return (int)err;
}

extern "C" int span_log_mark(unsigned int tag, void* stream) {
  span_mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(tag);
  return (int)cudaGetLastError();
}

extern "C" int span_log_count(unsigned long long* next) {
  return (int)cudaMemcpyFromSymbol(next, span_log_next, sizeof(*next));
}

extern "C" int span_log_copy(void* out, unsigned long long n) {
  if (n > SPAN_LOG_CAPACITY) n = SPAN_LOG_CAPACITY;
  if (n == 0) return 0;
  return (int)cudaMemcpyFromSymbol(out, span_log, n * sizeof(SpanRecord));
}

extern "C" int span_log_reset() {
  const unsigned long long zero = 0;
  return (int)cudaMemcpyToSymbol(span_log_next, &zero, sizeof(zero));
}

// ---------------------------------------------------------------------------
// the node walk
// ---------------------------------------------------------------------------

// CUDA 13 passes edge data beside the dependencies
static cudaError_t capturing_graph(cudaStream_t stream, cudaGraph_t* graph) {
  cudaStreamCaptureStatus status;
  const cudaGraphNode_t* deps = nullptr;
  size_t n = 0;
#if CUDART_VERSION >= 13000
  const cudaGraphEdgeData* edges = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             &deps, &edges, &n);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             &deps, &n);
#endif
  if (err == cudaSuccess && status != cudaStreamCaptureStatusActive) {
    return cudaErrorStreamCaptureInvalidated;
  }
  return err;
}

// The walk goes through the driver API, reached through the runtime
// (cudaGetDriverEntryPointByVersion, no -lcuda): the runtime's own
// cudaGraphNodeGetType fails on a conditional node, and its
// cudaGraphKernelNodeGetParams on a kernel launched through another
// runtime (PyTorch's, or another shim's). A marker is a kernel node whose
// function is named span_mark_kernel.
typedef CUresult (*GetNodesFn)(CUgraph, CUgraphNode*, size_t*);
typedef CUresult (*GetTypeFn)(CUgraphNode, CUgraphNodeType*);
typedef CUresult (*GetKernelFn)(CUgraphNode, CUDA_KERNEL_NODE_PARAMS*);
typedef CUresult (*GetChildFn)(CUgraphNode, CUgraph*);
typedef CUresult (*GetNameFn)(const char**, CUfunction);

struct Driver {
  GetNodesFn nodes;
  GetTypeFn type;
  GetKernelFn kernel;
  GetChildFn child;
  GetNameFn name;
};

static cudaError_t entry(const char* symbol, int version, void** fn) {
  cudaDriverEntryPointQueryResult found;
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      symbol, fn, version, cudaEnableDefault, &found);
  if (err == cudaSuccess && found != cudaDriverEntryPointSuccess) {
    return cudaErrorSymbolNotFound;
  }
  return err;
}

static cudaError_t driver(Driver* d) {
  cudaError_t err = entry("cuGraphGetNodes", 10000, (void**)&d->nodes);
  if (err == cudaSuccess) {
    err = entry("cuGraphNodeGetType", 10000, (void**)&d->type);
  }
  if (err == cudaSuccess) {
    err = entry("cuGraphKernelNodeGetParams", 12000, (void**)&d->kernel);
  }
  if (err == cudaSuccess) {
    err = entry("cuGraphChildGraphNodeGetGraph", 10000, (void**)&d->child);
  }
  if (err == cudaSuccess) {
    err = entry("cuFuncGetName", 12030, (void**)&d->name);
  }
  return err;
}

// counts: [0] nodes, [1] kernel nodes, [2] span_mark_kernel nodes,
// [3] conditional nodes; a driver error comes back as cudaErrorUnknown
static cudaError_t walk(const Driver& d, CUgraph graph, long long* counts,
                        int depth) {
  if (depth > 8) return cudaErrorInvalidValue;
  size_t n = 0;
  if (d.nodes(graph, nullptr, &n) != CUDA_SUCCESS) return cudaErrorUnknown;
  if (n == 0) return cudaSuccess;
  CUgraphNode* nodes = new CUgraphNode[n];
  cudaError_t err = cudaSuccess;
  if (d.nodes(graph, nodes, &n) != CUDA_SUCCESS) err = cudaErrorUnknown;
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    CUgraphNodeType type;
    if (d.type(nodes[i], &type) != CUDA_SUCCESS) {
      err = cudaErrorUnknown;
      break;
    }
    counts[0] += 1;
    if (type == CU_GRAPH_NODE_TYPE_KERNEL) {
      counts[1] += 1;
      CUDA_KERNEL_NODE_PARAMS p = {};
      const char* name = nullptr;
      if (d.kernel(nodes[i], &p) != CUDA_SUCCESS) {
        err = cudaErrorUnknown;
      } else if (p.func != nullptr &&
                 d.name(&name, p.func) == CUDA_SUCCESS && name != nullptr &&
                 strcmp(name, "_Z16span_mark_kernelj") == 0) {
        counts[2] += 1;
      }
    } else if (type == CU_GRAPH_NODE_TYPE_CONDITIONAL) {
      counts[3] += 1;
    } else if (type == CU_GRAPH_NODE_TYPE_GRAPH) {
      CUgraph child = nullptr;
      err = d.child(nodes[i], &child) == CUDA_SUCCESS
                ? walk(d, child, counts, depth + 1)
                : cudaErrorUnknown;
    }
  }
  delete[] nodes;
  return err;
}

extern "C" int span_log_graph_nodes(void* const* bodies, int n_bodies,
                                    long long* counts, void* stream) {
  for (int k = 0; k < 4; ++k) counts[k] = 0;
  Driver d;
  cudaError_t err = driver(&d);
  cudaGraph_t graph = nullptr;
  if (err == cudaSuccess) err = capturing_graph((cudaStream_t)stream, &graph);
  if (err == cudaSuccess) err = walk(d, (CUgraph)graph, counts, 0);
  for (int i = 0; err == cudaSuccess && i < n_bodies; ++i) {
    err = walk(d, (CUgraph)bodies[i], counts, 1);
  }
  return (int)err;
}
