// G2: float-bracket staircase resampling gather for Hopper (sm_90a).
//
// Replaces genparticlefilters_tpu/ops/fused_gather.py:
// _make_stairs_slab_kernel(is_float=True), reached through
// resample_gather_split_u (the multinomial and unsorted stratified
// resampling gather at n >= 1024), and _kernel_stairs_lanes_u, reached
// through resample_gather_rows_u (the same gather at n < 1024, and, with
// zero data rows and the roles of brackets and queries swapped, the
// residual remainder count G of residual_F_fused).
//
// Contract. Inputs: P pieces (0 <= P <= 32), piece k an int32 [w_k, n]
// row-major matrix (row stride n); c, a float32 [n] vector of bracket
// edges, nondecreasing; u, a float32 [m] vector of queries, nondecreasing.
// Output slot j takes the parent p_j = #{s < n-1 : c[s] < max(u_j, 1e-37)},
// i.e. the unique s with c_prev[s] < u_j <= c_row[s], c_prev[0] = 0 and
// the last upper edge widened to 2.0 as a catch-all (a query above c[n-2]
// lands in bracket n-1 even when roundoff leaves c[n-1] < u_j). Outputs:
// parents[j] = p_j (int32 [m]) and per piece out_k[:, j] = piece_k[:, p_j]
// ([w_k, m], row stride m). With P = 0 only the parents are written. Only
// float32 compares and int32 moves happen, so the result is bit-equal to
// any other correct evaluation of the same formula.
//
// What bounds it: memory traffic, as for G1. A call reads and writes every
// row once, 2 * (sum_k w_k) * 4 * m bytes (34 MB for the object-motion
// trace at N=100K) against 3.35 TB/s of HBM; the bracket search reads c,
// 400 KB at N=100K, which stays resident in the 50 MB L2.
//
// What the design does about it: one thread per output slot j, as in G1. A
// lower-bound binary search of max(u_j, 1e-37) over c[0 : n-1] finds the
// parent (log2 n dependent L2 loads); consecutive threads hold ascending
// queries, so their search paths share most cache lines. Then the row
// loop writes out_k[r, j] coalesced across the warp and reads
// piece_k[r, p_j] nearly coalesced, since parents are nondecreasing. All
// pieces move in one launch through a by-value pointer table. The TPU
// kernel's in-kernel one-hot compare against bracket rows, slab DMAs and
// host-computed sweep bounds have no counterpart: an indexed load is the
// cheap operation on this card.

#include <cuda_runtime.h>
#include <stdint.h>

#define STAIRS_U_MAX_PIECES 32

struct PieceTableU {
  const int32_t* src[STAIRS_U_MAX_PIECES];
  int32_t* dst[STAIRS_U_MAX_PIECES];
  int32_t rows[STAIRS_U_MAX_PIECES];
};

__global__ void stairs_gather_u_kernel(PieceTableU tab, int n_pieces,
                                       const float* __restrict__ c,
                                       int64_t n,
                                       const float* __restrict__ u,
                                       int64_t m,
                                       int32_t* __restrict__ parents) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  // an exact-zero query would match no bracket (c_prev < u is strict)
  const float q = fmaxf(__ldg(u + j), 1e-37f);
  // lower bound over c[0 : n-1]: the number of s < n-1 with c[s] < q
  int64_t lo = 0, hi = n - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(c + mid) < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  parents[j] = (int32_t)lo;
  for (int k = 0; k < n_pieces; ++k) {
    const int32_t* __restrict__ s = tab.src[k] + lo;
    int32_t* __restrict__ d = tab.dst[k] + j;
    const int w = tab.rows[k];
#pragma unroll 8
    for (int r = 0; r < w; ++r) {
      d[(int64_t)r * m] = __ldg(s + (int64_t)r * n);
    }
  }
}

// Plain C entry point (bound with ctypes). src/dst are host arrays of
// n_pieces device pointers, rows the host array of piece widths (all three
// may be null when n_pieces is 0). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int stairs_gather_u(const void* const* src, void* const* dst,
                               const int32_t* rows, int n_pieces,
                               const void* c, long long n, const void* u,
                               long long m, void* parents, void* stream) {
  if (n_pieces < 0 || n_pieces > STAIRS_U_MAX_PIECES || n <= 0 || m < 0) {
    return (int)cudaErrorInvalidValue;
  }
  PieceTableU tab;
  for (int k = 0; k < STAIRS_U_MAX_PIECES; ++k) {
    tab.src[k] = k < n_pieces ? (const int32_t*)src[k] : nullptr;
    tab.dst[k] = k < n_pieces ? (int32_t*)dst[k] : nullptr;
    tab.rows[k] = k < n_pieces ? rows[k] : 0;
  }
  if (m == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (m + threads - 1) / threads;
  stairs_gather_u_kernel<<<(unsigned int)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      tab, n_pieces, (const float*)c, (int64_t)n, (const float*)u,
      (int64_t)m, (int32_t*)parents);
  return (int)cudaGetLastError();
}

extern "C" int stairs_gather_u_max_pieces(void) {
  return STAIRS_U_MAX_PIECES;
}
