// G4: merge count of two sorted float sequences for Hopper (sm_90a).
//
// Replaces genparticlefilters_tpu/ops/merge_count.py: _kernel, reached
// through bitonic_merge_sorted from smc/resample.py:_merge_count (the
// sort-free multinomial and residual hit counts of multinomial_F and
// residual_F, and through them the sub-state resampling path and
// sample_unweighted_traces).
//
// Contract. Inputs: c, float32 [n], ascending and non-negative; u, float32
// [m], ascending, every value below 2.0 (callers pad unused draws with 1.5
// and 1.75). Output: F[i] = #{j : u_j <= c_i}, int32 [n]. Ties u_j == c_i
// count (side='right'). The TPU formulation packs each value as an int32
// key, (bits(x) << 1) | tag with tag 1 for c and 0 for u, and sorts the
// bitonic sequence [c_asc | pad | u_desc]; on non-negative float32 below
// 2.0 the bit pattern orders exactly as the float does and the shift does
// not overflow, and the low tag puts u before an equal c. So the float
// compare u_j <= c_i below is that order bit for bit, and the counts agree
// exactly.
//
// What bounds it: the search latency, not bandwidth. The call reads c and
// writes F once (8 bytes per c_i) and the searches read u, 400 KB at
// m=100K and 4 MB at m=1M, which stays resident in the 50 MB L2; each
// thread makes log2(m) + 1 dependent loads.
//
// What the design does about it: one thread per c_i with an upper-bound
// binary search in u. Consecutive threads hold ascending c, so their
// search paths share most cache lines. The TPU kernel's log2(M)-stage
// bitonic network in VMEM worked around a chip with no cheap indexed load
// and a compile limit of 2^19 elements; an indexed load is the cheap
// operation here, so there is no network and no size cap.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void merge_count_kernel(const float* __restrict__ c, int64_t n,
                                   const float* __restrict__ u, int64_t m,
                                   int32_t* __restrict__ F) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = __ldg(c + i);
  // upper bound: the first j with u[j] > x, i.e. #{j : u_j <= x}
  int64_t lo = 0, hi = m;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(u + mid) <= x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  F[i] = (int32_t)lo;
}

// Plain C entry point (bound with ctypes). Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int merge_count(const void* c, long long n, const void* u,
                           long long m, void* F, void* stream) {
  if (n < 0 || m < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  merge_count_kernel<<<(unsigned int)blocks, threads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)c, (int64_t)n, (const float*)u, (int64_t)m,
      (int32_t*)F);
  return (int)cudaGetLastError();
}
