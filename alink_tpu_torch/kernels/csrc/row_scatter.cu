// The ordered row scatter-add for Hopper (sm_90a), "P3".
//
// What it replaces: no TPU kernel. It is the JAX package's XLA scatter-add
// of wide rows, which on the card has no deterministic PyTorch counterpart
// (index_add_ adds with atomics, in an order that changes from run to run):
//   Word2Vec's  e["in"].at[c].add(-lr * d_v) and e["out"].at[pt].add(
//               -lr * d_u)  (alink_tpu/operator/common/nlp/word2vec.py:160)
//   FM's sparse gradient   gw, gV and sq_c (alink_tpu/operator/common/fm/
//               fm.py:69-72), one call of C = k + 2 columns
//   LDA's       jax.ops.segment_sum of the sufficient statistics
//               (alink_tpu/operator/common/clustering/lda.py:99, :261)
//
// Contract: state[keys[m], c] += terms[m, c] for m = 0..M-1 IN ORDER, in
// place, each add rounded on its own (__fadd_rn / __dadd_rn); a row that no
// key names is never written, so its bits (a -0.0 too) survive. state is
// (S, C) row-major, terms (M, C), any C >= 1, float or double. Each column's
// chain is independent of the others', so C columns in one call give the
// bits of C separate scatters. Built with --fmad=false as well.
//
// What bounds it. The bytes: every term read once, every touched row read
// and written once; and each run of equal keys is one dependent chain of
// adds a column, so the longest run sets a floor (LDA's padding positions,
// all at key 0, make a run of a quarter million at 20 Newsgroups' shape).
// At Word2Vec's batch (256 rows into `in`, 256 x L into `out`, D = 100) the
// work is a few hundred kilobytes, so one launch's fixed cost and the sort's
// barriers dominate; the Huffman root is on every path, so its run is at
// least 256 long a batch.
//
// Design (simple first):
//   small — M <= kSmallMaxM: ONE block of 1024 threads. A stable LSD radix
//           sort of the positions by key in shared memory (8-bit digits,
//           every warp counts its chunk of the current order into its own
//           digit table, then walks it in 32-wide steps ranking equal
//           digits with __match_any_sync, so no atomic decides a place),
//           the run heads compacted by a block scan, then each warp takes
//           runs in turn: its lanes over the columns, each lane the whole
//           chain of its columns in position order, from the stored row,
//           8 positions' terms loaded ahead of their adds (walk_run; 32 in
//           the walk below).
//   walk  — larger M: the run plan of csrc/run_plan.cu (kernels/linear.py::
//           run_plan: the positions stably sorted by key, each run's start
//           and key, the runs longest first) and a grid of warps over the
//           runs in the plan's order, a run a warp, lanes over the columns
//           as above. The run count is read from the plan on the card, so
//           the host waits for nothing; the grid is an upper bound.
// A key outside [0, S) fails a device-side assert (the stream reports it at
// its next synchronize); the clamp behind it only keeps an NDEBUG build
// inside the state.
//
// Interface: plain C, loaded with ctypes. A launch goes on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <cassert>

namespace {

constexpr int kSmallThreads = 1024;
constexpr int kSmallWarps = kSmallThreads / 32;
// the small block's shared memory: the keys and two orders (12 bytes a
// position) and the warps' digit tables (32 KB), inside the 227 KB a block
// can opt in to
constexpr int kSmallMaxM = 11264;
constexpr int kWalkThreads = 256;
// positions a warp loads ahead of their adds: fewer in the 1024-thread block
// (64 registers a thread)
constexpr int kSmallChunk = 8;
constexpr int kWalkChunk = 32;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

__device__ __forceinline__ int checked_key(int32_t k, int S) {
  assert(k >= 0 && k < S);
  return min(max(static_cast<int>(k), 0), S - 1);
}

// one run, rows `sorted[a..b)` of terms into state row `key`: the warp's
// lanes over the columns, each lane its columns' chains in position order.
// Whole chunks of kChunk positions first: one coalesced load of their rows,
// broadcast lane by lane, and the kChunk terms loaded into registers before
// they are added, so a long run waits on a load once a chunk, not once a
// term; then the tail one position at a time. Every lane runs every step
// (the shuffles need the whole warp).
template <int kChunk, typename T>
__device__ __forceinline__ void walk_run(T* __restrict__ state, const T* __restrict__ terms,
                                         const int* sorted, int a, int b, int key, int C,
                                         int lane) {
  T* row = state + static_cast<size_t>(key) * C;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    const bool on = c < C;
    T acc = on ? row[c] : T(0);
    int j = a;
    for (; j + kChunk <= b; j += kChunk) {
      const int mine = sorted[j + lane % kChunk];
      T v[kChunk];
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        const int m = __shfl_sync(0xffffffffu, mine, t);
        v[t] = on ? terms[static_cast<size_t>(m) * C + c] : T(0);
      }
#pragma unroll
      for (int t = 0; t < kChunk; ++t) acc = add_rn(acc, v[t]);
    }
    for (; j < b; ++j)
      if (on) acc = add_rn(acc, terms[static_cast<size_t>(sorted[j]) * C + c]);
    if (on) row[c] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kSmallThreads)
row_scatter_small_kernel(T* __restrict__ state, const int32_t* __restrict__ keys,
                         const T* __restrict__ terms, int M, int S, int C, int passes) {
  extern __shared__ __align__(16) int smem[];
  int* key = smem;                        // each position's key
  int* ord0 = key + M;                    // the two orders, in turns
  int* ord1 = key + 2 * M;
  int* hist = key + 3 * M;                // kSmallWarps tables of 256 digits
  __shared__ int wsum[kSmallWarps];
  __shared__ int n_runs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned lt = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < M; i += blockDim.x) key[i] = checked_key(keys[i], S);
  const int chunk = (M + kSmallWarps * 32 - 1) / (kSmallWarps * 32) * 32;
  const int lo = min(M, warp * chunk), hi = min(M, lo + chunk);
  int* cur = hist + warp * 256;
  for (int p = 0; p < passes; ++p) {
    const int* in = p & 1 ? ord0 : ord1;
    int* out = p & 1 ? ord1 : ord0;
    const int shift = 8 * p;
    for (int t = threadIdx.x; t < kSmallWarps * 256; t += blockDim.x) hist[t] = 0;
    __syncthreads();
    for (int i = lo + lane; i < hi; i += 32)
      atomicAdd(&cur[(key[p ? in[i] : i] >> shift) & 255], 1);
    __syncthreads();
    // digit t's cursor for warp w: the counts of the smaller digits, then of
    // digit t in the earlier warps (threads 0..255, one digit each)
    int total = 0, incl = 0;
    if (threadIdx.x < 256) {
      for (int w = 0; w < kSmallWarps; ++w) total += hist[w * 256 + threadIdx.x];
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
      for (int w = 0; w < kSmallWarps; ++w) {
        const int n = hist[w * 256 + threadIdx.x];
        hist[w * 256 + threadIdx.x] = c;
        c += n;
      }
    }
    __syncthreads();
    for (int i0 = lo; i0 < hi; i0 += 32) {
      const int i = i0 + lane;
      const int m = i < hi ? (p ? in[i] : i) : 0;
      const int d = i < hi ? (key[m] >> shift) & 255 : 256;
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
  int* starts = passes & 1 ? ord1 : ord0;   // the free order: the runs' starts
  // the run heads of this thread's range of sorted positions, counted, then
  // placed by a block scan of the counts
  const int per = (M + kSmallThreads - 1) / kSmallThreads;
  const int a = min(M, static_cast<int>(threadIdx.x) * per), b = min(M, a + per);
  int count = 0;
  for (int i = a; i < b; ++i)
    count += i == 0 || key[sorted[i]] != key[sorted[i - 1]];
  int incl = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  __syncthreads();                         // wsum's last use above is done
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int base = incl - count;
  for (int w = 0; w < warp; ++w) base += wsum[w];
  if (threadIdx.x == kSmallThreads - 1) n_runs = base + count;
  for (int i = a; i < b; ++i)
    if (i == 0 || key[sorted[i]] != key[sorted[i - 1]]) starts[base++] = i;
  __syncthreads();
  const int R = n_runs;
  for (int r = warp; r < R; r += kSmallWarps) {
    const int s0 = starts[r], s1 = r + 1 < R ? starts[r + 1] : M;
    walk_run<kSmallChunk>(state, terms, sorted, s0, s1, key[sorted[s0]], C, lane);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWalkThreads)
row_scatter_walk_kernel(T* __restrict__ state, const int32_t* __restrict__ perm,
                        const int32_t* __restrict__ starts, const int32_t* __restrict__ order,
                        const int32_t* __restrict__ slots, const int32_t* __restrict__ counts,
                        const T* __restrict__ terms, int S, int C) {
  const int lane = threadIdx.x % 32;
  const int warps = gridDim.x * (kWalkThreads / 32);
  const int runs = counts[0];
  for (int k = blockIdx.x * (kWalkThreads / 32) + threadIdx.x / 32; k < runs; k += warps) {
    const int r = order[k];
    walk_run<kWalkChunk>(state, terms, perm, starts[r], starts[r + 1],
                         checked_key(slots[r], S), C, lane);
  }
}

template <typename T>
int launch_small(void* state, const void* keys, const void* terms, int M, int S, int C,
                 int passes, cudaStream_t s) {
  const size_t smem = (3 * static_cast<size_t>(M) + kSmallWarps * 256) * sizeof(int);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(row_scatter_small_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  row_scatter_small_kernel<T><<<1, kSmallThreads, smem, s>>>(
      static_cast<T*>(state), static_cast<const int32_t*>(keys), static_cast<const T*>(terms),
      M, S, C, passes);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_walk(void* state, const void* perm, const void* starts, const void* order,
                const void* slots, const void* counts, const void* terms, int S, int C,
                int blocks, cudaStream_t s) {
  row_scatter_walk_kernel<T><<<blocks, kWalkThreads, 0, s>>>(
      static_cast<T*>(state), static_cast<const int32_t*>(perm),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(slots), static_cast<const int32_t*>(counts),
      static_cast<const T*>(terms), S, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// one block: sort, runs and walk; M in [1, kSmallMaxM], `passes` 8-bit digit
// passes cover the keys' bits
extern "C" int alink_row_scatter_small(int dtype, void* state, const void* keys,
                                       const void* terms, int M, int S, int C, int passes,
                                       void* stream) {
  if (M <= 0 || M > kSmallMaxM || S <= 0 || C <= 0 || passes < 1 || passes > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_small<float>(state, keys, terms, M, S, C, passes, s);
  if (dtype == 1) return launch_small<double>(state, keys, terms, M, S, C, passes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the walk of a run plan (kernels/linear.py::RunPlan) over `blocks` blocks
extern "C" int alink_row_scatter_walk(int dtype, void* state, const void* perm,
                                      const void* starts, const void* order, const void* slots,
                                      const void* counts, const void* terms, int S, int C,
                                      int blocks, void* stream) {
  if (S <= 0 || C <= 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_walk<float>(state, perm, starts, order, slots, counts, terms, S, C, blocks, s);
  if (dtype == 1)
    return launch_walk<double>(state, perm, starts, order, slots, counts, terms, S, C, blocks,
                               s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* alink_row_scatter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
