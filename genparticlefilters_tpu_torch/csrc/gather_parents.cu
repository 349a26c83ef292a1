// G3: explicit-parents ancestry gather for Hopper (sm_90a).
//
// Replaces four TPU Pallas kernels of genparticlefilters_tpu/ops/:
// - fused_gather.py gather_rows_clustered -> _kernel_clustered_lanes (the
//   in-lane clustered gather of a [D, N] packed matrix, D <= 1022);
// - fused_gather.py gather_transposed_clustered -> _kernel (the same gather
//   past the 1022-row VMEM cap, from the transposed [N, D] matrix);
// - gather.py gather_rows_pallas -> _gather_kernel (a DMA-ring row gather
//   of an [N, D] matrix for arbitrary parents);
// - sorted_gather.py gather_rows_clustered -> _kernel (a byte-plane MXU
//   row gather of an [N, D] matrix for clustered parents).
// The first two are this file's column mode, the last two its row mode.
//
// Contract. Inputs: P pieces (0 <= P <= 32) and parents, an int32 [m]
// vector of indices in [0, n), in any order, with m unrelated to n.
// - gather_cols: piece k is an int32 [w_k, n] row-major matrix (row stride
//   n, particles last, the port's packed layout); out_k is [w_k, m] with
//   out_k[r, j] = piece_k[r, parents[j]].
// - gather_rows: piece k is an int32 [n, w_k] row-major matrix (particles
//   first); out_k is [m, w_k] with out_k[j, :] = piece_k[parents[j], :].
// Only int32 values move, so the result is bit-equal to any other correct
// gather; float32 leaves cross as bit patterns. Parents are not bounds
// checked here (that would need a host sync): the caller passes indices in
// range.
//
// What bounds it: memory traffic. A call reads and writes every gathered
// element once, 2 * (sum_k w_k) * 4 * m bytes plus 4 * m bytes of parents:
// 1.3 GB for the config-5 trace (161 rows) at N = 1M, and 68 bytes per
// particle for one [N, 8] row-mode leaf, against 3.35 TB/s.
//
// What the design does about it:
// - Column mode puts consecutive output slots j on consecutive threads, so
//   every store out_k[r, j] coalesces; the load piece_k[r, parents[j]]
//   coalesces whenever neighbouring parents are close, which is the
//   resampling case (clustered parents). Each thread reads its parent once
//   and then walks a chunk of rows; blockIdx.y splits the rows of all
//   pieces into chunks of G3_ROW_CHUNK, so a 1026-row pack at N = 100K
//   still fills the card. The TPU kernels' ranged slab DMAs and exact
//   one-hot MXU selects have no counterpart: an indexed load is the cheap
//   operation on this card.
// - Row mode moves whole rows, not elements. The earlier design gave each
//   4-byte element its own thread, through a 64-bit division by the width
//   and a reload of its parent per element, with 4 bytes in flight per
//   thread: too little to cover DRAM latency on a gather of random rows
//   (PERF.md holds its times). Now each piece is copied in units of V
//   values, V = 4 (16-byte int4 loads and stores) when its width is a
//   multiple of 4 and both of its pointers are 16-byte aligned, else V = 1
//   (a view with a storage offset takes this path); the wrapper decides V
//   per piece and passes it in the table. A row of L = w_k / V units gets
//   the next power of two >= L lanes (at most 32, which then stride across
//   a wider row), the other bits of the thread index count rows, so no
//   division is left and the lanes of a row load its parent from one
//   broadcast address. Each thread carries G3R_ROWS_VEC (or
//   G3R_ROWS_SCALAR) rows, spaced a block's pass apart so that every store
//   still coalesces, and issues their loads before any store: 32 (or 16)
//   bytes of independent loads in flight per thread, besides the other
//   resident threads' (more rows per thread measured no faster).
// All pieces of a call move in one launch; their pointers and widths ride
// in a struct passed by value (the same table as G1).

#include <cuda_runtime.h>
#include <stdint.h>

#define G3_MAX_PIECES 32
#define G3_THREADS 256
#define G3_ROW_CHUNK 64
#define G3R_ROWS_VEC 2      // rows per thread, 16-byte units
#define G3R_ROWS_SCALAR 4   // rows per thread, 4-byte units

struct PieceTable {
  const int32_t* src[G3_MAX_PIECES];
  int32_t* dst[G3_MAX_PIECES];
  int32_t width[G3_MAX_PIECES];  // rows (column mode) or columns (row mode)
};

// Column mode. Grid: x over output slots, y over chunks of G3_ROW_CHUNK
// rows of the pieces laid end to end (piece 0's rows first).
__global__ void gather_cols_kernel(PieceTable tab, int n_pieces,
                                   const int32_t* __restrict__ parents,
                                   int64_t n, int64_t m) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int64_t p = (int64_t)__ldg(parents + j);
  const int r_lo = (int)blockIdx.y * G3_ROW_CHUNK;
  const int r_hi = r_lo + G3_ROW_CHUNK;
  int base = 0;  // first global row of piece k
  for (int k = 0; k < n_pieces && base < r_hi; ++k) {
    const int w = tab.width[k];
    const int lo = r_lo > base ? r_lo - base : 0;
    const int hi = r_hi - base < w ? r_hi - base : w;
    const int32_t* __restrict__ s = tab.src[k] + p;
    int32_t* __restrict__ d = tab.dst[k] + j;
#pragma unroll 8
    for (int r = lo; r < hi; ++r) {
      d[(int64_t)r * m] = __ldg(s + (int64_t)r * n);
    }
    base += w;
  }
}

// Row mode's table: the column mode's, plus each piece's unit V.
struct RowTable {
  const int32_t* src[G3_MAX_PIECES];
  int32_t* dst[G3_MAX_PIECES];
  int32_t width[G3_MAX_PIECES];  // columns w_k
  int32_t vec[G3_MAX_PIECES];    // V: 4 (int4) or 1 (int32)
};

// log2 of the lanes given to a row of `units` units: the next power of two
// >= units, at most 32.
__host__ __device__ inline int row_lanes_log2(int units) {
  int s = 0;
  while (s < 5 && (1 << s) < units) ++s;
  return s;
}

// Rows row0 + r * stride (r < R) of one piece, `units` units of type T per
// row, lane `lane` of `lanes`: R parents, then R loads, then R stores.
template <typename T, int R>
__device__ __forceinline__ void copy_rows(const T* __restrict__ src,
                                          T* __restrict__ dst,
                                          const int32_t* __restrict__ parents,
                                          int64_t m, int units, int lane,
                                          int lanes, int64_t row0,
                                          int stride) {
  int64_t p[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t j = row0 + (int64_t)r * stride;
    p[r] = j < m ? (int64_t)__ldg(parents + j) : 0;
  }
  for (int v = lane; v < units; v += lanes) {
    T x[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row0 + (int64_t)r * stride < m) x[r] = __ldg(src + p[r] * units + v);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t j = row0 + (int64_t)r * stride;
      if (j < m) dst[j * units + v] = x[r];
    }
  }
}

// Row mode. Grid: x over groups of rows (a block covers
// (G3_THREADS / lanes) * R rows of a piece), y over pieces.
__global__ void __launch_bounds__(G3_THREADS)
    gather_rows_kernel(RowTable tab, const int32_t* __restrict__ parents,
                       int64_t m) {
  const int k = blockIdx.y;
  const int w = tab.width[k];
  if (w == 0) return;
  const bool vec = tab.vec[k] == 4;
  const int units = vec ? w >> 2 : w;
  const int shift = row_lanes_log2(units);
  const int lane = threadIdx.x & ((1 << shift) - 1);
  const int stride = G3_THREADS >> shift;  // rows per pass of the block
  const int64_t q = threadIdx.x >> shift;
  if (vec) {
    const int64_t first = (int64_t)blockIdx.x * stride * G3R_ROWS_VEC;
    if (first >= m) return;
    copy_rows<int4, G3R_ROWS_VEC>(
        reinterpret_cast<const int4*>(tab.src[k]),
        reinterpret_cast<int4*>(tab.dst[k]), parents, m, units, lane,
        1 << shift, first + q, stride);
  } else {
    const int64_t first = (int64_t)blockIdx.x * stride * G3R_ROWS_SCALAR;
    if (first >= m) return;
    copy_rows<int32_t, G3R_ROWS_SCALAR>(tab.src[k], tab.dst[k], parents, m,
                                        units, lane, 1 << shift, first + q,
                                        stride);
  }
}

static int fill_table(PieceTable* tab, const void* const* src,
                      void* const* dst, const int32_t* width, int n_pieces,
                      long long* total, long long* widest) {
  if (n_pieces < 0 || n_pieces > G3_MAX_PIECES) return 0;
  *total = 0;
  *widest = 0;
  for (int k = 0; k < G3_MAX_PIECES; ++k) {
    const bool on = k < n_pieces;
    tab->src[k] = on ? (const int32_t*)src[k] : nullptr;
    tab->dst[k] = on ? (int32_t*)dst[k] : nullptr;
    tab->width[k] = on ? width[k] : 0;
    if (on && width[k] < 0) return 0;
    if (on) {
      *total += width[k];
      if (width[k] > *widest) *widest = width[k];
    }
  }
  return 1;
}

// Plain C entry points (bound with ctypes). src/dst are host arrays of
// n_pieces device pointers, width the host array of piece widths. Each
// launches once on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int gather_cols(const void* const* src, void* const* dst,
                           const int32_t* rows, int n_pieces,
                           const void* parents, long long n, long long m,
                           void* stream) {
  PieceTable tab;
  long long total, widest;
  if (n <= 0 || m < 0 ||
      !fill_table(&tab, src, dst, rows, n_pieces, &total, &widest)) {
    return (int)cudaErrorInvalidValue;
  }
  if (m == 0 || total == 0) return (int)cudaSuccess;
  const long long chunks = (total + G3_ROW_CHUNK - 1) / G3_ROW_CHUNK;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)((m + G3_THREADS - 1) / G3_THREADS),
                  (unsigned int)chunks);
  gather_cols_kernel<<<grid, G3_THREADS, 0, (cudaStream_t)stream>>>(
      tab, n_pieces, (const int32_t*)parents, (int64_t)n, (int64_t)m);
  return (int)cudaGetLastError();
}

extern "C" int gather_rows(const void* const* src, void* const* dst,
                           const int32_t* cols, const int32_t* vec,
                           int n_pieces, const void* parents, long long n,
                           long long m, void* stream) {
  PieceTable cols_tab;
  long long total, widest;
  if (n <= 0 || m < 0 ||
      !fill_table(&cols_tab, src, dst, cols, n_pieces, &total, &widest)) {
    return (int)cudaErrorInvalidValue;
  }
  if (m == 0 || total == 0) return (int)cudaSuccess;
  RowTable tab;
  long long blocks = 0;
  for (int k = 0; k < G3_MAX_PIECES; ++k) {
    tab.src[k] = cols_tab.src[k];
    tab.dst[k] = cols_tab.dst[k];
    tab.width[k] = cols_tab.width[k];
    tab.vec[k] = k < n_pieces ? vec[k] : 1;
    if (k >= n_pieces || cols_tab.width[k] == 0) continue;
    const int v = tab.vec[k];
    if (v == 4) {  // whole 16-byte units, aligned at both ends
      if (cols_tab.width[k] % 4 != 0 || ((uintptr_t)src[k] & 15) != 0 ||
          ((uintptr_t)dst[k] & 15) != 0) {
        return (int)cudaErrorInvalidValue;
      }
    } else if (v != 1) {
      return (int)cudaErrorInvalidValue;
    }
    const int units = cols_tab.width[k] / v;
    const long long rows = (long long)(G3_THREADS >> row_lanes_log2(units)) *
                           (v == 4 ? G3R_ROWS_VEC : G3R_ROWS_SCALAR);
    const long long b = (m + rows - 1) / rows;
    if (b > blocks) blocks = b;
  }
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)blocks, (unsigned int)n_pieces);
  gather_rows_kernel<<<grid, G3_THREADS, 0, (cudaStream_t)stream>>>(
      tab, (const int32_t*)parents, (int64_t)m);
  return (int)cudaGetLastError();
}

extern "C" int gather_parents_max_pieces(void) { return G3_MAX_PIECES; }
