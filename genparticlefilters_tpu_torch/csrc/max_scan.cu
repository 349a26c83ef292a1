// G5: inclusive max-scan along the last axis for Hopper (sm_90a), int32
// and float32.
//
// Replaces torch.cummax(x, -1).values wherever the port keeps a running
// maximum: the monotone lifts of smc/resample.py (_pinned_F, _brackets,
// the blockwise spacings, the CPU sorted uniforms), counts_to_parents'
// forward fill and smc/resize.py's pinned hit counts. The JAX package's
// counterpart is not a Pallas kernel: genparticlefilters_tpu/smc/
// resample.py _cummax1, a blocked cummax that XLA lowers.
//
// Contract. x: rows of length L, contiguous (a 1-D tensor is one row);
// y: the same shape, y[r, i] = x[r, 0] . x[r, 1] . ... . x[r, i] with
// a . b (a before b) = b if b is NaN, else a if a is NaN, else b if
// b >= a, else a. That is torch.cummax's rule: a NaN sticks once seen (a
// later NaN's bits replace it), and on a tie, +0.0 against -0.0
// included, the later element wins. The op is associative with identity
// -inf (INT32_MIN for int32), so every tiling below gives torch's bits.
//
// What bounds it: bytes. A call reads x once and writes y once, 8 bytes
// per element: 2.4 us at 1M against 3.35 TB/s. PyTorch's innermost-dim
// scan gives each row one block, so one block walks a 1M-element row
// (~2.4 ms a call on the H100).
//
// What the design does about it: a single pass with decoupled look-back.
// A row is cut into tiles, one per block: a warp's 512 elements for a
// row that fits, else 8 warps' 4,096 (the wrapper's choice). A warp owns
// 512 consecutive elements of its tile, read and written as 16-byte
// vectors where the row allows it (each load of a warp covers 512
// contiguous bytes). Each lane scans its 4 values, the warp scans the
// lanes' totals by shuffles, and a carry runs over the warp's 4 chunks;
// the warps' totals go through shared memory. A row of one tile is done
// there. A longer row takes its tiles in the order the blocks start
// (tickets from an atomic counter), so that a tile only ever waits on
// tiles that are already running: a tile publishes its total, then
// its first warp reads the status words of the 32 tiles before it at
// once, folds them in order back to the nearest tile that has published
// its inclusive prefix, and publishes its own. A status word holds a
// flag and the value's bits in one 64-bit store, so a reader never sees
// one without the other. The counter and the status words lie in a
// scratch buffer that the wrapper allocates and this entry point zeroes
// with cudaMemsetAsync before the launch: under stream capture that is
// a memset node, so every replay of a graph starts from zeroed words and
// nothing is carried from one run to the next.
//
// Each launch adds one to a counter on the card (max_scan_runs_read), so
// that a graph replay's runs can be counted.

#include <cuda_runtime.h>
#include <stdint.h>

#define MS_ITEMS 16               // values per lane in a tile
#define MS_WARP_SPAN (32 * MS_ITEMS)  // elements per warp in a tile

// max_scan_kernel executions since the last reset, one per launch
__device__ unsigned long long max_scan_runs = 0;

// tile status: flag in the high 32 bits, the value's bits in the low 32
enum : uint32_t { kEmpty = 0, kAggregate = 1, kPrefix = 2 };

struct IntMax {
  typedef int32_t T;
  static __device__ __forceinline__ T identity() { return INT32_MIN; }
  static __device__ __forceinline__ T op(T a, T b) { return b >= a ? b : a; }
  static __device__ __forceinline__ uint32_t bits(T v) { return (uint32_t)v; }
  static __device__ __forceinline__ T value(uint32_t b) { return (T)b; }
};

struct FloatMax {
  typedef float T;
  static __device__ __forceinline__ T identity() {
    return __uint_as_float(0xff800000u);  // -inf
  }
  // a NaN b takes b; a NaN a fails b >= a and keeps a; a tie takes b
  static __device__ __forceinline__ T op(T a, T b) {
    return (b >= a || b != b) ? b : a;
  }
  static __device__ __forceinline__ uint32_t bits(T v) {
    return __float_as_uint(v);
  }
  static __device__ __forceinline__ T value(uint32_t b) {
    return __uint_as_float(b);
  }
};

template <class Op>
__device__ __forceinline__ void publish(unsigned long long* word,
                                        uint32_t flag, typename Op::T v) {
  *reinterpret_cast<volatile unsigned long long*>(word) =
      ((unsigned long long)flag << 32) | Op::bits(v);
}

// The fold of every tile of the row before tile j (j >= 1), by the
// calling warp; every lane returns it. `st` holds the row's status words.
template <class Op>
__device__ typename Op::T look_back(const unsigned long long* st,
                                    int64_t j) {
  typedef typename Op::T T;
  const int lane = threadIdx.x & 31;
  T run = Op::identity();  // the tiles after the window, folded
  for (int64_t newest = j - 1;; newest -= 32) {
    const int64_t i = newest - lane;  // lane 0 reads the newest tile
    // before tile 0 there is nothing: an empty prefix (never reached,
    // tile 0 publishing its prefix at once)
    unsigned long long w =
        ((unsigned long long)kPrefix << 32) | Op::bits(Op::identity());
    uint32_t flag;
    for (;;) {
      if (i >= 0) w = *reinterpret_cast<const volatile unsigned long long*>(
                      st + i);
      flag = (uint32_t)(w >> 32);
      if (!__any_sync(0xffffffffu, flag == kEmpty)) break;
      __nanosleep(20);
    }
    const unsigned prefixes = __ballot_sync(0xffffffffu, flag == kPrefix);
    const int last = prefixes ? __ffs(prefixes) - 1 : 31;
    T v = lane <= last ? Op::value((uint32_t)w) : Op::identity();
    // in tile order: lane + o holds tiles before lane's
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T before = __shfl_down_sync(0xffffffffu, v, o);
      if (lane + o < 32) v = Op::op(before, v);
    }
    run = Op::op(__shfl_sync(0xffffffffu, v, 0), run);
    if (prefixes) return run;
  }
}

template <class Op, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    max_scan_kernel(const typename Op::T* __restrict__ x,
                    typename Op::T* __restrict__ y, int64_t L,
                    int64_t tiles_per_row,
                    unsigned long long* __restrict__ scratch, bool vec) {
  typedef typename Op::T T;
  constexpr int kTile = WARPS * MS_WARP_SPAN;
  __shared__ T s_warp[WARPS];
  __shared__ T s_before;
  __shared__ unsigned long long s_ticket;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&max_scan_runs, 1ULL);
  int64_t t = blockIdx.x;
  if (tiles_per_row > 1) {
    if (threadIdx.x == 0) s_ticket = atomicAdd(scratch, 1ULL);
    __syncthreads();
    t = (int64_t)s_ticket;
  }
  const int64_t row = t / tiles_per_row, j = t - row * tiles_per_row;
  const T* __restrict__ xr = x + row * L;
  T* __restrict__ yr = y + row * L;
  const int64_t seg = j * kTile + (int64_t)warp * MS_WARP_SPAN;

  // lane owns values [4 * lane, 4 * lane + 4) of each 128-element chunk
  T v[MS_ITEMS];
#pragma unroll
  for (int k = 0; k < MS_ITEMS / 4; ++k) {
    const int64_t off = seg + k * 128 + lane * 4;
    if (vec && off + 4 <= L) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(xr + off));
      v[4 * k] = Op::value(q.x);
      v[4 * k + 1] = Op::value(q.y);
      v[4 * k + 2] = Op::value(q.z);
      v[4 * k + 3] = Op::value(q.w);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[4 * k + e] = off + e < L ? xr[off + e] : Op::identity();
      }
    }
  }

  T carry = Op::identity();  // the warp's chunks before chunk k, folded
#pragma unroll
  for (int k = 0; k < MS_ITEMS / 4; ++k) {
    T* c = v + 4 * k;
    c[1] = Op::op(c[0], c[1]);
    c[2] = Op::op(c[1], c[2]);
    c[3] = Op::op(c[2], c[3]);
    T incl = c[3];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl = Op::op(up, incl);
    }
    T before = __shfl_up_sync(0xffffffffu, incl, 1);
    before = Op::op(carry, lane == 0 ? Op::identity() : before);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = Op::op(before, c[e]);
    carry = Op::op(carry, __shfl_sync(0xffffffffu, incl, 31));
  }

  if (lane == 0) s_warp[warp] = carry;
  __syncthreads();
  T before = Op::identity();  // the tile's warps before this one
  for (int w = 0; w < warp; ++w) before = Op::op(before, s_warp[w]);
  if (tiles_per_row > 1) {
    if (warp == 0) {
      T total = Op::identity();
      for (int w = 0; w < WARPS; ++w) total = Op::op(total, s_warp[w]);
      unsigned long long* st = scratch + 1 + row * tiles_per_row;
      T prior = Op::identity();
      if (j == 0) {
        if (lane == 0) publish<Op>(st, kPrefix, total);
      } else {
        if (lane == 0) publish<Op>(st + j, kAggregate, total);
        prior = look_back<Op>(st, j);
        if (lane == 0) publish<Op>(st + j, kPrefix, Op::op(prior, total));
      }
      if (lane == 0) s_before = prior;
    }
    __syncthreads();
    before = Op::op(s_before, before);
  }

#pragma unroll
  for (int k = 0; k < MS_ITEMS / 4; ++k) {
    const int64_t off = seg + k * 128 + lane * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) v[4 * k + e] = Op::op(before, v[4 * k + e]);
    if (vec && off + 4 <= L) {
      *reinterpret_cast<uint4*>(yr + off) =
          make_uint4(Op::bits(v[4 * k]), Op::bits(v[4 * k + 1]),
                     Op::bits(v[4 * k + 2]), Op::bits(v[4 * k + 3]));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (off + e < L) yr[off + e] = v[4 * k + e];
      }
    }
  }
}

template <class Op, int WARPS>
static int launch(const void* x, void* y, long long blocks, long long L,
                  long long tiles_per_row, unsigned long long* scratch,
                  bool vec, cudaStream_t stream) {
  typedef typename Op::T T;
  max_scan_kernel<Op, WARPS><<<(unsigned int)blocks, WARPS * 32, 0, stream>>>(
      (const T*)x, (T*)y, (int64_t)L, (int64_t)tiles_per_row, scratch, vec);
  return (int)cudaGetLastError();
}

template <class Op>
static int launch_tile(int warps, const void* x, void* y, long long blocks,
                       long long L, long long tiles_per_row,
                       unsigned long long* scratch, bool vec,
                       cudaStream_t stream) {
  return warps == 1 ? launch<Op, 1>(x, y, blocks, L, tiles_per_row, scratch,
                                    vec, stream)
                    : launch<Op, 8>(x, y, blocks, L, tiles_per_row, scratch,
                                    vec, stream);
}

// Plain C entry point (bound with ctypes). y = the running maximum of x
// along rows of length L; `tile` (512 or 4096 elements) is the
// wrapper's choice. A row longer than one tile needs `scratch`, at
// least rows * ceil(L / tile) + 1 zeroable 8-byte words; this zeroes them
// on `stream` before the launch. Returns cudaGetLastError() (0 on
// success).
extern "C" int max_scan(const void* x, void* y, long long rows, long long L,
                        int is_float, int tile, void* scratch,
                        long long scratch_words, void* stream) {
  const int warps = tile / MS_WARP_SPAN;
  if (rows < 0 || L < 0 || tile != warps * MS_WARP_SPAN ||
      (warps != 1 && warps != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0 || L == 0) return (int)cudaSuccess;
  const long long tiles_per_row = (L + tile - 1) / tile;
  if (tiles_per_row > 2147483647LL / rows) return (int)cudaErrorInvalidValue;
  const long long blocks = rows * tiles_per_row;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* words = (unsigned long long*)scratch;
  if (tiles_per_row > 1) {
    if (words == nullptr || scratch_words < blocks + 1) {
      return (int)cudaErrorInvalidValue;
    }
    const cudaError_t err = cudaMemsetAsync(
        words, 0, (size_t)(blocks + 1) * sizeof(unsigned long long), s);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(y)) & 15) == 0 &&
                   (rows == 1 || L % 4 == 0);
  return is_float
             ? launch_tile<FloatMax>(warps, x, y, blocks, L, tiles_per_row,
                                     words, vec, s)
             : launch_tile<IntMax>(warps, x, y, blocks, L, tiles_per_row,
                                   words, vec, s);
}

// the counter's value into `runs`, then 0 into the counter if `reset`
extern "C" int max_scan_runs_read(unsigned long long* runs, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(runs, max_scan_runs, sizeof(*runs));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    err = cudaMemcpyToSymbol(max_scan_runs, &zero, sizeof(zero));
  }
  return (int)err;
}
