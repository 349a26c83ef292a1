// G4: merge count of two sorted float sequences for Hopper (sm_90a).
//
// Replaces genparticlefilters_tpu/ops/merge_count.py: _kernel, reached
// through bitonic_merge_sorted from smc/resample.py:_merge_count (the
// sort-free multinomial and residual hit counts of multinomial_F and
// residual_F, and through them the sub-state resampling path, blockwise
// resampling and sample_unweighted_traces).
//
// Contract. Inputs: c, float32 [n], ascending and non-negative; u, float32
// [m], ascending, every value below 2.0 (callers pad unused draws with 1.5
// and 1.75); n and m independent. Output: F[i] = #{j : u_j <= c_i}, int32
// [n]. The TPU formulation packs each value as an int32 key, (bits(x) << 1)
// | tag with tag 1 for c and 0 for u, and sorts the bitonic sequence
// [c_asc | pad | u_desc]; on non-negative float32 below 2.0 the bit pattern
// orders exactly as the float does and the low tag puts u before an equal
// c. So the float compares below are that order bit for bit.
//
// The tie rule, once: in the merged sequence u_j goes before c_i iff
// u_j <= c_i. A u equal to a c lands on the u side, so it counts in F_i
// (side='right'). Both the diagonal search and the serial merge use exactly
// this compare: "c[i-1] < u[j]" keeps c[i-1] before u[j], and "u[j] <= c[i]"
// takes u[j] first.
//
// What bounds it: bytes. A call reads c and u once and writes F once, 12
// bytes per element at n = m, against 3.35 TB/s. The earlier design (one
// thread per c_i, an upper-bound binary search of u in global memory) made
// log2(m) + 1 dependent loads per thread and was bound by that latency, and
// its cost rose with skew: with degenerate weights every thread walks the
// same path (PERF.md holds its times).
//
// What the design does about it: a merge path. The merged sequence of
// length n + m is cut into tiles of G4_THREADS * items elements (items = 8,
// or 16 past G4_LARGE merged elements, where fewer tiles mean fewer split
// searches), one per block. A tile's start and end are diagonal splits
// (i, d - i): i = #{c_i among the first d merged elements}, the largest i
// with c[i-1] < u[d-i]. Warp 0 finds the start and warp 1 the end by a
// 32-ary search: each lane probes one point, a ballot counts the probes
// that hold (they form a prefix, the predicate being monotone), and the
// range shrinks 32x per round: 4 dependent rounds at n = m = 1M, not 21
// loads. (More probes per lane cut a round but cost more than they save:
// every probe is a scattered load.) The block then stages c[i0:i1) and
// u[j0:j1) into shared memory with 16-byte loads (scalar at the ragged
// ends, or where a pointer is not 16-byte aligned), each thread finds its
// own split of `items` merge positions in shared memory, merges them
// serially and branch-free (one shared load per step, an exhausted side
// reading a sentinel above every value), writing F_i = j0 + (u taken
// before c_i) into shared memory, and the block stores its F coalesced.
// Shared memory holds one pad word in 32, so that a warp's strided reads
// (every thread's merge positions lie `items` apart) do not conflict.
// Every tile holds the same number of merged elements, so the work per
// block does not depend on the data: degenerate weights, long equal runs
// of c and all-equal u cost what uniform weights cost. What remains is
// latency: every block runs search, staging, merge and store in turn, and
// at these sizes all blocks fit on the card at once, so the phases of
// different blocks overlap little (PERF.md holds the times).

#include <cuda_runtime.h>
#include <stdint.h>

#define G4_THREADS 256
// merge positions per thread (a tile is G4_THREADS * items merged
// elements): 8 up to G4_LARGE merged elements, 16 above
#define G4_LARGE (1LL << 20)

// Shared-memory slot of logical index i: one pad word per 32, so that the
// lanes of a warp reading every ITEMS-th value (a thread's merge
// positions, the lift's chunks) hit distinct banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// The split of diagonal d: the largest i in [max(0, d - m), min(d, n)] with
// i == 0, or d - i >= m, or c[i-1] < u[d-i]. Called by a whole warp; every
// lane returns it.
__device__ int64_t split_warp(const float* __restrict__ c, int64_t n,
                              const float* __restrict__ u, int64_t m,
                              int64_t d) {
  const int lane = threadIdx.x & 31;
  int64_t lo = d > m ? d - m : 0;  // the predicate holds at lo
  int64_t hi = d < n ? d : n;
  while (hi > lo) {  // warp-uniform
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = lo + (int64_t)(lane + 1) * step;
    const int64_t j = d - p;
    const bool q = p <= hi && (j >= m || __ldg(c + p - 1) < __ldg(u + j));
    lo += (int64_t)__popc(__ballot_sync(0xffffffffu, q)) * step;
    if (lo + step - 1 < hi) hi = lo + step - 1;
  }
  return lo;
}

// How one segment g[lo:hi) is staged: whole 16-byte vectors from
// base = lo & ~3 while they lie inside g (none if g is not 16-byte
// aligned), then single values from `scalar_from` to hi.
struct Segment {
  const float* g;
  int64_t base, scalar_from, hi;
  int vectors;
};

__device__ __forceinline__ Segment plan(const float* __restrict__ g,
                                        int64_t len_g, int64_t lo,
                                        int64_t hi) {
  Segment s;
  s.g = g;
  s.base = lo & ~(int64_t)3;
  s.hi = hi;
  s.scalar_from = lo;
  s.vectors = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const int64_t v_cap = len_g & ~(int64_t)3;  // whole vectors inside g
    int64_t v_end = (hi + 3) & ~(int64_t)3;
    if (v_end > v_cap) v_end = v_cap;
    if (v_end > s.base) {
      s.vectors = (int)((v_end - s.base) >> 2);
      if (v_end > lo) s.scalar_from = v_end;
    }
  }
  return s;
}

// Stage both segments into s: logical slot a_at + k holds segment a's
// g[base + k], and b_at + k segment b's (a_at and b_at multiples of 4).
// Every thread issues all of its vector loads before its first
// shared-memory store.
template <int TILE>
__device__ __forceinline__ void stage(float* s, const Segment& a, int a_at,
                                      const Segment& b, int b_at) {
  constexpr int kPerThread = (TILE / 4 + 4 + G4_THREADS - 1) / G4_THREADS;
  const float4* __restrict__ av = reinterpret_cast<const float4*>(a.g + a.base);
  const float4* __restrict__ bv = reinterpret_cast<const float4*>(b.g + b.base);
  const int total = a.vectors + b.vectors;
  float4 r[kPerThread];
#pragma unroll
  for (int t = 0; t < kPerThread; ++t) {
    const int v = threadIdx.x + t * G4_THREADS;
    if (v < a.vectors) {
      r[t] = __ldg(av + v);
    } else if (v < total) {
      r[t] = __ldg(bv + (v - a.vectors));
    }
  }
#pragma unroll
  for (int t = 0; t < kPerThread; ++t) {
    const int v = threadIdx.x + t * G4_THREADS;
    if (v < total) {
      const int at = v < a.vectors ? a_at + 4 * v
                                   : b_at + 4 * (v - a.vectors);
      s[pad(at)] = r[t].x;
      s[pad(at + 1)] = r[t].y;
      s[pad(at + 2)] = r[t].z;
      s[pad(at + 3)] = r[t].w;
    }
  }
  for (int64_t k = a.scalar_from + threadIdx.x; k < a.hi; k += G4_THREADS) {
    s[pad(a_at + (int)(k - a.base))] = __ldg(a.g + k);
  }
  for (int64_t k = b.scalar_from + threadIdx.x; k < b.hi; k += G4_THREADS) {
    s[pad(b_at + (int)(k - b.base))] = __ldg(b.g + k);
  }
}

// The tile's c as its running maximum, c[k] = max(seed, c[0..k]) with
// seed = the c just before the tile, in place in shared memory; on a
// non-decreasing c (the contract) nothing changes and only the check
// runs. A float32 cumsum on the card can dip by an ulp where its scan
// blocks meet, and a merge across a dip would leave some c unmerged: so
// the kernel counts for the running maximum of c, which is what the
// callers' cummax of F (smc/resample.py _pinned_F) makes of the plain
// per-element count. Thread t owns c[t * ITEMS ...].
template <int ITEMS>
__device__ __forceinline__ void lift_dips(float* s, int c_off, int nc,
                                          float seed) {
  __shared__ float s_warp[G4_THREADS / 32];
  const int k0 = threadIdx.x * ITEMS;
  float run[ITEMS];
  float prev = k0 == 0 ? seed : k0 < nc ? s[pad(c_off + k0 - 1)] : -1.0f;
  float top = k0 == 0 ? seed : -1.0f;  // every c is >= 0
  bool dip = false;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const float v = k0 + k < nc ? s[pad(c_off + k0 + k)] : top;
    dip |= v < prev;
    prev = v;
    top = fmaxf(top, v);
    run[k] = top;
  }
  if (!__syncthreads_or(dip)) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float incl = top;  // the warp's inclusive max-scan of the thread tops
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = fmaxf(incl, y);
  }
  float below = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) below = -1.0f;  // thread 0's top holds the seed
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) below = fmaxf(below, s_warp[w]);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (k0 + k < nc) s[pad(c_off + k0 + k)] = fmaxf(below, run[k]);
  }
  __syncthreads();
}

template <int ITEMS>
__global__ void __launch_bounds__(G4_THREADS)
    merge_count_kernel(const float* __restrict__ c, int64_t n,
                       const float* __restrict__ u, int64_t m,
                       int32_t* __restrict__ F) {
  constexpr int TILE = G4_THREADS * ITEMS;  // merged elements per block
  constexpr int SENTINEL = TILE + 16;       // s_val slot above every value
  // the c segment, then the u segment from a multiple of 4; each may carry
  // up to 3 values before it and 3 after (logical slots, see pad)
  __shared__ float s_val[(TILE + 17) * 33 / 32 + 1];
  __shared__ int32_t s_F[TILE * 33 / 32];
  __shared__ int64_t s_split[2];
  if (threadIdx.x == 0) s_val[pad(SENTINEL)] = 3.0f;  // all values are < 2
  const int64_t d0 = (int64_t)blockIdx.x * TILE;
  const int64_t d1 = d0 + TILE < n + m ? d0 + TILE : n + m;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int64_t i = split_warp(c, n, u, m, warp ? d1 : d0);
    if ((threadIdx.x & 31) == 0) s_split[warp] = i;
  }
  __syncthreads();
  const int64_t i0 = s_split[0], i1 = s_split[1];
  const int64_t j0 = d0 - i0, j1 = d1 - i1;
  // (clamped only so that a c far outside the contract cannot send a
  // block outside its tile)
  const int nc = (int)(i1 - i0 < 0 ? 0 : i1 - i0 > TILE ? TILE : i1 - i0);
  const int nu = (int)(j1 - j0 < 0 ? 0 : j1 - j0 > TILE - nc ? TILE - nc
                                                            : j1 - j0);
  const float seed = i0 > 0 ? __ldg(c + i0 - 1) : -1.0f;
  const int c_off = (int)(i0 & 3);           // c[i0 + k] at slot c_off + k
  const int u_base = (c_off + nc + 3) & ~3;  // a multiple of 4
  const int u_off = u_base + (int)(j0 & 3);  // u[j0 + k] at slot u_off + k
  stage<TILE>(s_val, plan(c, n, i0, i1), 0, plan(u, m, j0, j1), u_base);
  __syncthreads();
  lift_dips<ITEMS>(s_val, c_off, nc, seed);
  const int dd = threadIdx.x * ITEMS;  // this thread's local diagonal
  const int len = nc + nu;
  if (dd < len) {
    int lo = dd > nu ? dd - nu : 0;
    int hi = dd < nc ? dd : nc;
    while (lo < hi) {  // the same split, inside the tile
      const int mid = (lo + hi + 1) >> 1;
      if (s_val[pad(c_off + mid - 1)] < s_val[pad(u_off + dd - mid)]) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    // the serial merge, branch-free: one shared load per step, an
    // exhausted side reading the sentinel
    int ii = lo, jj = dd - lo;
    float cv = s_val[pad(ii < nc ? c_off + ii : SENTINEL)];
    float uv = s_val[pad(jj < nu ? u_off + jj : SENTINEL)];
    const int steps = len - dd < ITEMS ? len - dd : ITEMS;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (k < steps) {
        const bool take_u = uv <= cv;  // the tie rule
        if (!take_u) s_F[pad(ii)] = (int32_t)(j0 + jj);
        ii += !take_u;
        jj += take_u;
        const float x = s_val[pad(take_u ? (jj < nu ? u_off + jj : SENTINEL)
                                         : (ii < nc ? c_off + ii : SENTINEL))];
        uv = take_u ? x : uv;
        cv = take_u ? cv : x;
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nc; k += G4_THREADS) F[i0 + k] = s_F[pad(k)];
}

template <int ITEMS>
static int launch(const float* c, long long n, const float* u, long long m,
                  int32_t* F, cudaStream_t stream) {
  const long long tile = (long long)G4_THREADS * ITEMS;
  const long long blocks = (n + m + tile - 1) / tile;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  merge_count_kernel<ITEMS><<<(unsigned int)blocks, G4_THREADS, 0, stream>>>(
      c, (int64_t)n, u, (int64_t)m, F);
  return (int)cudaGetLastError();
}

// Plain C entry point (bound with ctypes). Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int merge_count(const void* c, long long n, const void* u,
                           long long m, void* F, void* stream) {
  if (n < 0 || m < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const float* cf = (const float*)c;
  const float* uf = (const float*)u;
  return n + m > G4_LARGE
             ? launch<16>(cf, n, uf, m, (int32_t*)F, (cudaStream_t)stream)
             : launch<8>(cf, n, uf, m, (int32_t*)F, (cudaStream_t)stream);
}
