// G1: int-bracket staircase resampling gather for Hopper (sm_90a).
//
// Replaces genparticlefilters_tpu/ops/fused_gather.py:
// _make_stairs_slab_kernel(is_float=False), reached through
// resample_gather_split (the TPU Pallas kernel of the systematic
// resampling path).
//
// Contract. Inputs: P pieces, piece k an int32 [w_k, n] row-major matrix
// (row stride n); F, an int32 [n] vector, nondecreasing with F[n-1] == m.
// Outputs: parents[j] = #{i : F[i] <= j} for j < m, and per piece
// out_k[:, j] = piece_k[:, parents[j]] ([w_k, m], row stride m). The data
// is moved as exact int32 bit patterns, so the result is bit-equal to any
// other correct gather.
//
// What bounds it: memory traffic. Each call reads and writes every row
// once, about 2 * (sum_k w_k) * 4 * n bytes — 2 x 43 rows x 4 B x 100K =
// 34 MB on the object-motion filter at N=100K — against 3.35 TB/s of HBM.
// The search over F is latency, not bandwidth: F is 400 KB at N=100K and
// stays resident in the 50 MB L2.
//
// What the design does about it: one thread per output slot j. The thread
// finds its parent by an upper-bound binary search of j in F (L2 hits),
// then copies each row: the write out_k[r, j] is coalesced across the warp
// (consecutive j), and the read piece_k[r, p_j] is nearly coalesced
// because parents are nondecreasing, so a warp's 32 reads fall into one or
// a few 128-byte lines. All pieces are gathered with the same parents in
// one launch; their pointers and widths ride in a struct passed by value.
// The TPU kernel's one-hot MXU select, slab DMAs and sweep bounds have no
// counterpart: on this card a direct indexed load is the cheap operation.

#include <cuda_runtime.h>
#include <stdint.h>

#define STAIRS_MAX_PIECES 32

struct PieceTable {
  const int32_t* src[STAIRS_MAX_PIECES];
  int32_t* dst[STAIRS_MAX_PIECES];
  int32_t rows[STAIRS_MAX_PIECES];
};

__global__ void stairs_gather_kernel(PieceTable tab, int n_pieces,
                                     const int32_t* __restrict__ F,
                                     int64_t n, int64_t m,
                                     int32_t* __restrict__ parents) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  // upper bound: the first i with F[i] > j, i.e. #{i : F[i] <= j}
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if ((int64_t)__ldg(F + mid) <= j) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  // F[n-1] == m > j keeps lo < n; the clamp only guards memory on input
  // that breaks the contract
  const int64_t p = lo < n ? lo : n - 1;
  parents[j] = (int32_t)p;
  for (int k = 0; k < n_pieces; ++k) {
    const int32_t* __restrict__ s = tab.src[k] + p;
    int32_t* __restrict__ d = tab.dst[k] + j;
    const int w = tab.rows[k];
#pragma unroll 8
    for (int r = 0; r < w; ++r) {
      d[(int64_t)r * m] = __ldg(s + (int64_t)r * n);
    }
  }
}

// Plain C entry point (bound with ctypes). src/dst are host arrays of
// n_pieces device pointers, rows the host array of piece widths. Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int stairs_gather(const void* const* src, void* const* dst,
                             const int32_t* rows, int n_pieces,
                             const void* F, long long n, long long m,
                             void* parents, void* stream) {
  if (n_pieces < 0 || n_pieces > STAIRS_MAX_PIECES || n <= 0 || m < 0) {
    return (int)cudaErrorInvalidValue;
  }
  PieceTable tab;
  for (int k = 0; k < STAIRS_MAX_PIECES; ++k) {
    tab.src[k] = k < n_pieces ? (const int32_t*)src[k] : nullptr;
    tab.dst[k] = k < n_pieces ? (int32_t*)dst[k] : nullptr;
    tab.rows[k] = k < n_pieces ? rows[k] : 0;
  }
  if (m == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (m + threads - 1) / threads;
  stairs_gather_kernel<<<(unsigned int)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      tab, n_pieces, (const int32_t*)F, (int64_t)n, (int64_t)m,
      (int32_t*)parents);
  return (int)cudaGetLastError();
}

extern "C" int stairs_gather_max_pieces(void) { return STAIRS_MAX_PIECES; }
