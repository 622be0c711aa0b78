// FTRL state kernels for Hopper (sm_90a): the state gather, the
// deterministic scatter-add and the chained-correction matvec of the sparse
// online FTRL steps.
//
// What they replace:
//   ftrl_gather_kernel       <- alink_tpu/kernels/ftrl.py::_gather_call
//                               (gather_rows; and gather_pair, the same
//                               gather of z and n in one launch)
//   ftrl_scatter_add_kernel  <- alink_tpu/kernels/ftrl.py::_scatter_call
//                               (scatter_add_rows)
//   ftrl_chained_corr_kernel <- alink_tpu/kernels/ftrl.py::chained_corr
// Each is instantiated for float and double; gather and scatter-add for
// C = 1 (z or n alone) and C = 2 (z and n stacked as (S, 2)).
//
// Contracts (the JAX package's, pinned bitwise against its XLA ops):
//   gather      out[m, c] = state[idx[m], c]; the pair form
//               out[m] = (z[idx[m]], n[idx[m]]), what stacking two
//               gathers gives.
//   scatter-add state[idx[m], c] += upd[m, c] for m = 0..M-1 IN ORDER:
//               duplicate slots accumulate in update order, each add
//               rounded on its own (__fadd_rn / __dadd_rn); a slot that no
//               update names is never written, so a stored -0.0 survives.
//               No atomics: atomicAdd's order changes from run to run.
//   chained     out[a, c] = sum_{j<k} sum_b Mk[j, a, b] * D[j, b, c], one
//               chain per output in the order j, then b, from a zero
//               accumulator; every product rounded on its own (no FMA,
//               no TF32, no tensor cores).
// Built with --fmad=false as well, so nothing else contracts either.
//
// What bounds them: the launch. At the shapes of the FTRL steps (M = 160 to
// 1280 touched slots of a 2^20 state, K = 16 chained rows of width 40) each
// kernel moves a few kilobytes to a few hundred kilobytes, microseconds or
// less at the card's memory rate, so a launch's fixed cost dominates. For
// the gather it is all there is: its body runs at the launch floor, and
// what a call costs is the host's issue of it (the wrapper's checks, the
// allocation of the output, the ctypes call), which the design below and
// kernels/ftrl.py keep short; the pair form issues one launch where
// stacking two gathers issued three. The
// state itself is touched only at the M named slots; the rest of the 2^20
// slots are never read. Past the launch, the scatter-add's time goes to
// its sort (a few passes over M positions on one SM) and to its longest
// run of one slot, a chain of dependent adds.
//
// Design:
//   gather   - one thread per slot m: it reads idx[m] once and moves the
//              slot's C values (or z's and n's) as one 8- or 16-byte
//              word where the addresses allow, element by element where
//              a view leaves them unaligned.
//   scatter  - ONE block, a sorted run walk. Position m's key is
//              (slot << 32) | m, unique, so any sort of the keys is stable
//              and leaves each slot's positions contiguous and ascending.
//              The block sorts them in shared memory (dynamic, opted in
//              above 48 KB) by an LSD radix sort on the slot's bytes, one
//              pass a byte up to the state's size (3 passes for 2^20 + 1
//              slots): the positions start in order and each pass is
//              stable (per-warp digit counts turned into cursors, lanes
//              ranked by __match_any_sync), so the position bits need no
//              pass and no atomic decides a position. Each thread then
//              takes its sorted keys into registers, and the same shared
//              memory is refilled with the updates in sorted order (read
//              from global memory once, by the whole block) and a bitmap
//              of the positions that start a run. A run's head thread
//              reads state[slot] once, adds the run's updates in position
//              order from shared memory and writes once. O(M) work a pass,
//              where a search of the earlier positions for each slot's
//              owner would cost O(M^2).
//              Padded positions (slot 0, update 0.0) are added like any
//              other, as the JAX package adds them (-0.0 + 0.0 turns into
//              +0.0 there).
//   chained  - ONE block, one thread per output (a, c), each walking its
//              chain of k * w products.
// An index outside [0, S) fails a device-side assert, as PyTorch's own
// CUDA indexing does: the launch's stream then reports cudaErrorAssert at
// its next synchronize, where the plain version raises IndexError at once.
// The clamp behind the assert only keeps a build without asserts (NDEBUG)
// inside the state.
//
// Interface: plain C, loaded with ctypes. A launch goes on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <cassert>

namespace {

constexpr int kGatherThreads = 256;
constexpr int kScatterThreads = 1024;
constexpr int kCorrThreads = 256;
// the scatter block sorts with 12 bytes a position plus 8 KB of digit
// tables, then reuses that memory for the sorted updates and a bitmap of run
// heads (at most 11264 * 16 + 1540 bytes), inside the 227 KB a block can opt
// in to
constexpr int kScatterMaxM = 11264;
constexpr int kScatterPerThread = 11;  // sorted positions a thread holds: 11264 / 1024
constexpr int kSortWarps = 8;          // the warps that sort, one digit table each
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

__device__ __forceinline__ int checked_slot(int32_t s, int S) {
  assert(s >= 0 && s < S);
  return min(max(static_cast<int>(s), 0), S - 1);
}

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

// One thread per slot m. C = 1: out[m] = a[slot]. C = 2, pair = false:
// out[m, :] = a[slot, :] (a is (S, 2)). C = 2, pair = true: out[m, :] =
// (a[slot], b[slot]) (a and b are (S,)). `vec`: a (S, 2) row and out's
// rows are read and written as one 2-element word.
template <typename T, int C, bool kPair>
__global__ void __launch_bounds__(kGatherThreads)
ftrl_gather_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const int32_t* __restrict__ idx, T* __restrict__ out, int M, int S,
                   bool vec) {
  using V = typename Vec2<T>::type;
  const int m = blockIdx.x * kGatherThreads + threadIdx.x;
  if (m >= M) return;
  const size_t slot = static_cast<size_t>(checked_slot(idx[m], S));
  if (C == 1) {
    out[m] = a[slot];
  } else if (kPair) {
    const T lo = a[slot], hi = b[slot];
    if (vec) {
      reinterpret_cast<V*>(out)[m] = V{lo, hi};
    } else {
      out[2 * m] = lo;
      out[2 * m + 1] = hi;
    }
  } else if (vec) {
    reinterpret_cast<V*>(out)[m] = reinterpret_cast<const V*>(a)[slot];
  } else {
    out[2 * m] = a[2 * slot];
    out[2 * m + 1] = a[2 * slot + 1];
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kScatterThreads)
ftrl_scatter_add_kernel(T* __restrict__ state, const int32_t* __restrict__ idx,
                        const T* __restrict__ upd, int M, int S, int passes) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the keys (slot << 32) | m are sorted by an LSD radix sort on the slot's
  // bytes: the positions start in order and every pass is stable, so the
  // position bits never need a pass. Sorting warp w (of kSortWarps) takes
  // the w-th run of `chunk` positions of the current order, counts their
  // digits into its own table, and the tables turn into cursors (the
  // digit's offset plus the earlier warps' counts); then the warp walks its
  // positions in 32-wide steps in order, __match_any_sync ranking the lanes
  // of each digit, so no atomic decides a position
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* slot = reinterpret_cast<int*>(smem);
  int* ord0 = slot + M;                          // the two orders, in turns
  int* ord1 = slot + 2 * M;
  int* hist = slot + 3 * M;                       // kSortWarps tables of 256 digits
  __shared__ int wsum[256 / 32];
  for (int i = threadIdx.x; i < M; i += blockDim.x) slot[i] = checked_slot(idx[i], S);
  const int chunk = (M + kSortWarps * 32 - 1) / (kSortWarps * 32) * 32;
  const int lo = warp < kSortWarps ? min(M, warp * chunk) : M;
  const int hi = min(M, lo + chunk);
  const unsigned lt = (1u << lane) - 1u;
  for (int p = 0; p < passes; ++p) {
    const int* in = p & 1 ? ord0 : ord1;
    int* out = p & 1 ? ord1 : ord0;
    const int shift = 8 * p;
    for (int k = threadIdx.x; k < kSortWarps * 256; k += blockDim.x) hist[k] = 0;
    __syncthreads();
    int* cur = hist + min(warp, kSortWarps - 1) * 256;
    for (int i = lo + lane; i < hi; i += 32)
      atomicAdd(&cur[(slot[p ? in[i] : i] >> shift) & 255], 1);
    __syncthreads();
    // digit t's cursor for warp w: the counts of smaller digits, then of
    // digit t in the earlier warps (threads 0..255, one digit each)
    int total = 0, incl = 0;
    if (threadIdx.x < 256) {
      for (int w = 0; w < kSortWarps; ++w) total += hist[w * 256 + threadIdx.x];
      incl = total;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      if (lane == 31) wsum[warp] = incl;
    }
    __syncthreads();
    if (threadIdx.x < 256) {
      int c = incl - total;
      for (int w = 0; w < warp; ++w) c += wsum[w];
      for (int w = 0; w < kSortWarps; ++w) {
        const int n = hist[w * 256 + threadIdx.x];
        hist[w * 256 + threadIdx.x] = c;
        c += n;
      }
    }
    __syncthreads();
    for (int i0 = lo; i0 < hi; i0 += 32) {
      const int i = i0 + lane;
      const int m = i < hi ? (p ? in[i] : i) : 0;
      const int d = i < hi ? (slot[m] >> shift) & 255 : 256;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      const int rank = __popc(peers & lt);
      const int pos = i < hi ? cur[d] + rank : 0;
      __syncwarp();
      if (i < hi && rank == 0) cur[d] = pos + __popc(peers);
      __syncwarp();
      if (i < hi) out[pos] = m;
    }
    __syncthreads();
  }
  const int* sorted = passes & 1 ? ord0 : ord1;
  // this thread's sorted positions i = threadIdx.x + r * blockDim.x, into
  // registers as (slot << 32) | m; a position starts a run when its slot
  // differs from the one before it
  const int per = (M + blockDim.x - 1) / blockDim.x;
  unsigned long long key[kScatterPerThread];
  bool head[kScatterPerThread];
#pragma unroll
  for (int r = 0; r < kScatterPerThread; ++r) {
    const int i = threadIdx.x + r * blockDim.x;
    const bool live = r < per && i < M;
    const int m = live ? sorted[i] : 0;
    key[r] = live ? (static_cast<unsigned long long>(slot[m]) << 32) | m : ~0ull;
    head[r] = live && (i == 0 || slot[sorted[i - 1]] != slot[m]);
  }
  __syncthreads();
  // the keys' memory now holds the updates in sorted order and a bitmap
  // of the run heads
  T* su = reinterpret_cast<T*>(smem);
  unsigned* heads = reinterpret_cast<unsigned*>(su + static_cast<size_t>(M) * C);
#pragma unroll
  for (int r = 0; r < kScatterPerThread; ++r) {
    if (r >= per) break;
    const int i = threadIdx.x + r * blockDim.x;
    if (i < M) {
      const T* src = upd + static_cast<size_t>(key[r] & 0xffffffffu) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) su[i * C + c] = src[c];
    }
    const unsigned word = __ballot_sync(0xffffffffu, head[r]);
    if (threadIdx.x % 32 == 0) heads[i / 32] = word;
  }
  __syncthreads();
  // one thread per run: read state[slot] once, add the run's updates in
  // position order, write once
#pragma unroll
  for (int r = 0; r < kScatterPerThread; ++r) {
    if (!head[r]) continue;
    const int i = threadIdx.x + r * blockDim.x;
    int end = M;
    for (int j = i + 1; j < M; j = (j | 31) + 1) {
      const unsigned w = heads[j / 32] & (~0u << (j % 32));
      if (w) {
        end = (j & ~31) + __ffs(w) - 1;
        break;
      }
    }
    T* dst = state + static_cast<size_t>(key[r] >> 32) * C;
    T acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = dst[c];
#pragma unroll 8
    for (int j = i; j < end; ++j)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = add_rn(acc[c], su[j * C + c]);
#pragma unroll
    for (int c = 0; c < C; ++c) dst[c] = acc[c];
  }
}

template <typename T>
__global__ void __launch_bounds__(kCorrThreads)
ftrl_chained_corr_kernel(const T* __restrict__ Mk, const T* __restrict__ D,
                         T* __restrict__ out, int k, int w, int C) {
  for (int t = threadIdx.x; t < w * C; t += blockDim.x) {
    const int a = t / C;
    const int c = t - a * C;
    T acc = 0;
    for (int j = 0; j < k; ++j) {
      const T* mrow = Mk + (static_cast<size_t>(j) * w + a) * w;
      const T* dj = D + static_cast<size_t>(j) * w * C + c;
      for (int b = 0; b < w; ++b) acc = add_rn(acc, mul_rn(mrow[b], dj[b * C]));
    }
    out[t] = acc;
  }
}

// C = 1 or 2 gathers rows of a; pair gathers a and b (C = 2)
template <typename T>
int gather(const void* a, const void* b, const void* idx, void* out, int M, int S, int C,
           bool pair, cudaStream_t s) {
  const int blocks = (M + kGatherThreads - 1) / kGatherThreads;
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  T* o = static_cast<T*>(out);
  const uintptr_t words = reinterpret_cast<uintptr_t>(out) | (pair ? 0 : reinterpret_cast<uintptr_t>(a));
  const bool vec = (words & (2 * sizeof(T) - 1)) == 0;
  if (pair) {
    ftrl_gather_kernel<T, 2, true><<<blocks, kGatherThreads, 0, s>>>(pa, pb, ix, o, M, S, vec);
  } else if (C == 1) {
    ftrl_gather_kernel<T, 1, false><<<blocks, kGatherThreads, 0, s>>>(pa, pb, ix, o, M, S, vec);
  } else if (C == 2) {
    ftrl_gather_kernel<T, 2, false><<<blocks, kGatherThreads, 0, s>>>(pa, pb, ix, o, M, S, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C>
int launch_scatter(T* st, const int32_t* ix, const T* u, int M, int S, cudaStream_t s) {
  const int threads = M > 4 * 256 ? kScatterThreads : 256;
  int bits = 0;
  while (bits < 31 && ((S - 1) >> bits) != 0) ++bits;
  const int passes = bits > 8 ? (bits + 7) / 8 : 1;
  // the sort's slots, two orders and the warps' digit tables; then the
  // sorted updates and the run-head bitmap
  const size_t sort = (3 * static_cast<size_t>(M) + kSortWarps * 256) * sizeof(int);
  const size_t walk = static_cast<size_t>(M) * C * sizeof(T) + (M + threads + 31) / 32 * 4;
  const size_t smem = sort > walk ? sort : walk;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(ftrl_scatter_add_kernel<T, C>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ftrl_scatter_add_kernel<T, C><<<1, threads, smem, s>>>(st, ix, u, M, S, passes);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int scatter_add(void* state, const void* idx, const void* upd, int M, int S, int C,
                cudaStream_t s) {
  T* st = static_cast<T*>(state);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const T* u = static_cast<const T*>(upd);
  if (C == 1) return launch_scatter<T, 1>(st, ix, u, M, S, s);
  if (C == 2) return launch_scatter<T, 2>(st, ix, u, M, S, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int chained_corr(const void* Mk, const void* D, void* out, int k, int w, int C,
                 cudaStream_t s) {
  const int threads = w * C < kCorrThreads ? ((w * C + 31) / 32) * 32 : kCorrThreads;
  ftrl_chained_corr_kernel<T><<<1, threads, 0, s>>>(
      static_cast<const T*>(Mk), static_cast<const T*>(D), static_cast<T*>(out), k, w,
      C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float, 1 = double. C: 1 or 2.
extern "C" int alink_ftrl_gather(int dtype, const void* state, const void* idx, void* out,
                                 int M, int S, int C, void* stream) {
  if (M <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return gather<float>(state, nullptr, idx, out, M, S, C, false, s);
  if (dtype == 1) return gather<double>(state, nullptr, idx, out, M, S, C, false, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out (M, 2) = (z[idx], n[idx]); z and n (S,) of one dtype.
extern "C" int alink_ftrl_gather_pair(int dtype, const void* z, const void* n,
                                      const void* idx, void* out, int M, int S,
                                      void* stream) {
  if (M <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return gather<float>(z, n, idx, out, M, S, 2, true, s);
  if (dtype == 1) return gather<double>(z, n, idx, out, M, S, 2, true, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int alink_ftrl_scatter_add(int dtype, void* state, const void* idx,
                                      const void* upd, int M, int S, int C, void* stream) {
  if (M <= 0 || S <= 0 || M > kScatterMaxM) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return scatter_add<float>(state, idx, upd, M, S, C, s);
  if (dtype == 1) return scatter_add<double>(state, idx, upd, M, S, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int alink_ftrl_chained_corr(int dtype, const void* Mk, const void* D, void* out,
                                       int k, int w, int C, void* stream) {
  if (k <= 0 || w <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return chained_corr<float>(Mk, D, out, k, w, C, s);
  if (dtype == 1) return chained_corr<double>(Mk, D, out, k, w, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* alink_ftrl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
