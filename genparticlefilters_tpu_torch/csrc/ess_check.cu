// The ESS check as one kernel for Hopper (sm_90a): the resample predicate
// ESS < threshold from a float32 vector of log weights, in one pass.
//
// Replaces the chain that smc/algorithms.py _ess_low ran on an unsharded
// state: utils/weights.py ess_from_log_weights (lognorm, 2 * lw, a second
// logsumexp, neg, exp) and the compare with the threshold. On the card
// each torch.logsumexp is its own chain (amax, an infinity mask, sub,
// exp, sum, log, add), so a check was about 20 kernels, four of them
// multi-block reductions, to reduce one vector. The JAX package's
// counterpart is not a Pallas kernel: genparticlefilters_tpu/utils/
// weights.py:56 ess_from_log_weights, which XLA fuses under jit.
//
// Contract. x: n float32 log weights, contiguous; thr: the threshold,
// already rounded to float32 (as a tensor-vs-scalar compare rounds it).
// With m = max x, s1 = sum exp(x - m) and s2 = sum exp(2 (x - m)),
// ESS = s1^2 / s2, which is 1 / sum(w_hat^2) as the chain computes it;
// the last step forms it in float32 with the chain's own roundings
// (exp(-(log s2 + 2 (m - (log s1 + m))))), so that the ESS lies within
// ulps of the chain's wherever the sums agree, and is the chain's to the
// bit on equal weights.
// `out` (one byte) gets ESS < thr. Where the chain's ESS is NaN the
// predicate is false and the ESS written is NaN: a NaN weight, a +inf
// weight, every weight -inf, an empty vector. If `ess` is not null it
// gets the ESS as a float32.
//
// What bounds it: one read of 4n bytes (0.12 us at 100K, 1.2 us at 1M
// against 3.35 TB/s), one byte written, and the latency of one launch.
//
// What the design does about it: one kernel node and one pass, with as
// few steps as possible on the path from the first load to the byte.
// `blocks` blocks of 512 threads (1 <= blocks <= 1024, chosen by the
// wrapper from n alone, never from the card: ceil(n / 4096), so 8 weights
// a thread up to 4.2M). Each thread folds its share of the vector into
// (m, s1, s2) with an online maximum: the vector is read as float4s in a
// grid-stride loop with up to four loads in flight; the scalar head
// before the first 16-byte boundary and the tail after the last whole
// float4 go to thread 0. s2 is summed as e * e for e = exp(x - m). A
// block then takes its maximum first (shuffles, no exp), brings each
// thread's sums to it with one exp, and adds them by shuffles in a fixed
// tree, so the block's reduction costs one exp a thread. Thread 0 stores
// the block's partial, fences, and takes a ticket; the block that takes
// the last ticket folds every partial in block order the same way, writes
// the predicate and puts the ticket back to 0 for the next launch. The
// partials and the ticket are the card's own (__device__), so the check
// adds no scratch buffer, memset or second node to a graph; two checks
// must not run at once on two streams of one card (the port queues
// every kernel on one stream). Every fold order is fixed by n and the
// vector's alignment, whichever block finishes last, so a replay gives
// the same bits every time. (A design with one thread-block cluster and
// distributed shared memory instead of the ticket ran 7.1 us at 100K and
// 13.3 us at 1M per check in a graph on the H100, against 4.3 and 5.5 us
// for this one: 16 blocks at most, and an exp at every step of its
// reductions.)
//
// Each launch adds one to a counter on the card (ess_check_runs_read), so
// that a graph replay's checks can be counted.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define EC_THREADS 512
#define EC_WARPS (EC_THREADS / 32)
#define EC_MAX_BLOCKS 1024

// ess_check_kernel executions since the last reset, one per launch
__device__ unsigned long long ess_check_runs = 0;

// (m, s1, s2) of a stretch of the vector; `bad` is set by a NaN or +inf
struct Part {
  float m, s1, s2;
  int bad;
};

// each block's partial, and the tickets taken in the current launch (0
// between launches: the last block puts it back)
__device__ Part ess_check_parts[EC_MAX_BLOCKS];
__device__ unsigned int ess_check_ticket = 0;

__device__ __forceinline__ Part empty_part() {
  return Part{-INFINITY, 0.0f, 0.0f, 0};
}

// p's sums brought to the maximum c >= p.m (0 where p.m is -inf)
__device__ __forceinline__ void rescale(Part& p, float c) {
  if (c == -INFINITY || p.m == c) return;
  const float r = expf(p.m - c);
  p.s1 *= r;
  p.s2 *= r * r;
  p.m = c;
}

__device__ __forceinline__ void add(Part& p, float x) {
  const float e = expf(x - p.m);
  p.s1 += e;
  p.s2 += e * e;
}

__device__ __forceinline__ void fold1(Part& p, float x) {
  p.bad |= !(x < INFINITY);  // NaN or +inf
  if (x > p.m) rescale(p, x);
  if (p.m > -INFINITY) add(p, x);
}

__device__ __forceinline__ void fold4(Part& p, float4 a) {
  p.bad |= !(a.x < INFINITY) | !(a.y < INFINITY) | !(a.z < INFINITY) |
           !(a.w < INFINITY);
  const float c = fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w));
  if (c > p.m) rescale(p, c);
  if (p.m > -INFINITY) {
    add(p, a.x);
    add(p, a.y);
    add(p, a.z);
    add(p, a.w);
  }
}

// p, then q after it
__device__ __forceinline__ Part combine(Part p, Part q) {
  const float m = fmaxf(p.m, q.m);
  rescale(p, m);
  rescale(q, m);
  return Part{m, p.s1 + q.s1, p.s2 + q.s2, p.bad | q.bad};
}

// The block's fold of every thread's part, in thread 0 (the other
// threads' results are not meaningful): the maximum first, each part
// brought to it, then the sums added in a fixed tree, warps in order.
__device__ __forceinline__ Part block_fold(Part p, float* s_m, float* s_1,
                                           float* s_2, int* s_bad) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float m = p.m;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  if (lane == 0) s_m[warp] = m;
  __syncthreads();
  m = s_m[0];
#pragma unroll
  for (int w = 1; w < EC_WARPS; ++w) m = fmaxf(m, s_m[w]);
  rescale(p, m);
  float a = p.s1, b = p.s2;
  int bad = p.bad;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
    bad |= __shfl_down_sync(0xffffffffu, bad, o);
  }
  if (lane == 0) {
    s_1[warp] = a;
    s_2[warp] = b;
    s_bad[warp] = bad;
  }
  __syncthreads();
  Part r{m, 0.0f, 0.0f, 0};
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < EC_WARPS; ++w) {
      r.s1 += s_1[w];
      r.s2 += s_2[w];
      r.bad |= s_bad[w];
    }
  }
  return r;
}

__global__ void __launch_bounds__(EC_THREADS)
    ess_check_kernel(const float* __restrict__ x, int64_t n, int64_t head,
                     float thr, bool* __restrict__ out,
                     float* __restrict__ ess) {
  __shared__ float s_m[EC_WARPS], s_1[EC_WARPS], s_2[EC_WARPS];
  __shared__ int s_bad[EC_WARPS];
  __shared__ bool s_last;
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&ess_check_runs, 1ULL);

  Part p = empty_part();
  const int64_t g = (int64_t)blockIdx.x * EC_THREADS + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * EC_THREADS;
  if (g == 0) {
    for (int64_t i = 0; i < head; ++i) fold1(p, x[i]);
  }
  const int64_t nv = (n - head) / 4;
  const float4* __restrict__ v = reinterpret_cast<const float4*>(x + head);
  int64_t j = g;
  for (; j + 3 * stride < nv; j += 4 * stride) {
    const float4 a = __ldg(v + j), b = __ldg(v + j + stride),
                 c = __ldg(v + j + 2 * stride), d = __ldg(v + j + 3 * stride);
    fold4(p, a);
    fold4(p, b);
    fold4(p, c);
    fold4(p, d);
  }
  if (j + stride < nv) {  // two of the at most three left, both in flight
    const float4 a = __ldg(v + j), b = __ldg(v + j + stride);
    fold4(p, a);
    fold4(p, b);
    j += 2 * stride;
  }
  if (j < nv) fold4(p, __ldg(v + j));
  if (g == 0) {
    for (int64_t i = head + 4 * nv; i < n; ++i) fold1(p, x[i]);
  }

  p = block_fold(p, s_m, s_1, s_2, s_bad);
  if (threadIdx.x == 0) {
    ess_check_parts[blockIdx.x] = p;
    __threadfence();  // the partial is seen before the ticket
    s_last = atomicAdd(&ess_check_ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // the last block: partial b goes to thread b % EC_THREADS, in order of b
  __threadfence();
  Part q = empty_part();
  for (unsigned b = threadIdx.x; b < gridDim.x; b += EC_THREADS) {
    const volatile Part* vp = ess_check_parts + b;
    q = combine(q, Part{vp->m, vp->s1, vp->s2, vp->bad});
  }
  q = block_fold(q, s_m, s_1, s_2, s_bad);
  if (threadIdx.x == 0) {
    const bool ok = !q.bad && q.m > -INFINITY;
    // the ESS formed in float32 as the chain forms it: torch.logsumexp is
    // log(sum) + max, so lse = log s1 + m, the normalized maximum m - lse,
    // and the second logsumexp log s2 + 2 (m - lse); ESS = exp(-that).
    // The roundings of lse and of the normalized maximum are the chain's
    // own (on equal weights the ESS is the chain's to the bit), so the
    // predicate follows the chain's at ess_frac 1 too.
    const float lse = logf(q.s1) + q.m;
    const float e = ok ? expf(-(logf(q.s2) + 2.0f * (q.m - lse))) : NAN;
    *out = ok && e < thr;
    if (ess != nullptr) *ess = e;
    ess_check_ticket = 0;
  }
}

// Plain C entry point (bound with ctypes). out = (ESS of the n float32 log
// weights at x) < thr, one byte; ess, if not null, the ESS. `blocks`
// (1..1024) is the wrapper's choice from n. Returns cudaGetLastError()'s
// code (0 on success).
extern "C" int ess_check(const void* x, long long n, float thr, int blocks,
                         void* out, void* ess, void* stream) {
  if (n < 0 || blocks < 1 || blocks > EC_MAX_BLOCKS || out == nullptr ||
      (n > 0 && x == nullptr) || (reinterpret_cast<uintptr_t>(x) & 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  long long head = (long long)(((16 - (addr & 15)) & 15) / 4);
  if (head > n) head = n;
  ess_check_kernel<<<(unsigned)blocks, EC_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (int64_t)n, (int64_t)head, thr, (bool*)out,
      (float*)ess);
  return (int)cudaGetLastError();
}

// the counter's value into `runs`, then 0 into the counter if `reset`
extern "C" int ess_check_runs_read(unsigned long long* runs, int reset) {
  cudaError_t err =
      cudaMemcpyFromSymbol(runs, ess_check_runs, sizeof(*runs));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    err = cudaMemcpyToSymbol(ess_check_runs, &zero, sizeof(zero));
  }
  return (int)err;
}
