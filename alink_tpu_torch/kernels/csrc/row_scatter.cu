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
// and written once. And the chains: each run of equal keys is one dependent
// chain of adds a column, so the longest run times the add latency is a
// floor. At Word2Vec's `out` scatter (3,840 x 100 terms, 256 Huffman paths
// padded to 15 with inner node 0) key 0's run is 1,300-1,740 long a batch
// and the root's 256; the bytes are 1.5 MB, all in L2 after the op that
// made them, so the chain and the latency of the loads that feed it set
// the time. FM's gradient (3.9 M x 12 over 65,536 rows, runs of about 60)
// and LDA's statistics (1.09 M x 20 over 30,000 words, runs up to 1,074)
// read their term rows at random from device memory.
//
// Design. Every walk is a warp of Q groups of 32 / Q lanes (Q = 1 for C >
// 16, else 2: FM's 12 columns take two runs a warp, 5 % faster than one
// on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md), each group a task: one
// run and one group of at most 32 columns (C = 100: four groups of 25).
// A group walks its run in chunks of K positions: the chunk's positions
// (K / (32 / Q) a lane, broadcast by shuffles), then all K term loads,
// then the K adds in position order; the next chunk's loads go out
// before this chunk's adds, and a chunk's tail is masked, not walked a
// load at a time.
//   small — M <= kSmallMaxM over at most 2^18 rows (kernels/rows.py::
//           SMALL_MAX_ROWS): ONE launch, no plan, no host read: a grid of
//           G x ncg blocks, block b walking column group b % ncg of the
//           keys k with k % G == b / ncg (the hot keys of a Huffman tree
//           are neighbours, so they land on different SMs, and so do the
//           column groups of one run: the loads in flight of one SM bound
//           a long run's walk). Each block reads all M keys into shared
//           memory and sorts its own positions by local key k / G with a
//           stable counting sort over each warp's chunk of positions
//           (count, scan, place), then its warps walk its runs, chunks of
//           256 bytes a lane.
//   walk  — the rest: the run plan of csrc/run_plan.cu (kernels/linear.py::
//           run_plan: the positions stably sorted by key, each run's start
//           and key, the runs longest first) and a grid of warps over its
//           tasks in the plan's order, chunks of 128 bytes a lane. The run
//           count is read from the plan on the card, so the host waits for
//           nothing; the grid is an upper bound.
// Both replace an earlier design, which walked each run on one warp with
// its lanes over 32 columns, 8 or 32 positions a chunk and a run's tail a
// load at a time: at FM's 12 columns 20 lanes idled, and below kSmallMaxM
// one block of 1,024 threads sorted, found the runs and walked them on one
// SM. At Word2Vec's `out` scatter its walk took 97 % of 0.50 ms, its sort
// 1.3 %; this design takes 0.029-0.031 ms of device time there, LDA's
// statistics 0.063 against 0.099 and FM's walk 0.163 against 0.177 (an
// NVIDIA H100 80GB HBM3 at 700 W, PERF.md). A long run still costs about
// 29 cycles a position a warp, not the chain's 4.2 (PERF.md).
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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmallMaxM = 11264;
// a small block's local keys at most (the grid grows with S to keep them
// so): its shared memory is 2 M + 10 R + 1 ints, 131 KB at the most
constexpr int kMaxLocalKeys = 1024;
// term bytes a lane has in flight in each of its two chunk buffers
constexpr int kSmallBytes = 256;
constexpr int kWalkBytes = 128;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

__device__ __forceinline__ int checked_key(int32_t k, int S) {
  assert(k >= 0 && k < S);
  return min(max(static_cast<int>(k), 0), S - 1);
}

// positions a chunk: kBytes of terms a lane, but at least one and at most
// 8 for each lane of a group (the lanes hold the chunk's positions)
template <typename T, int Q, int kBytes>
__host__ __device__ constexpr int chunk_positions() {
  return static_cast<int>(kBytes / sizeof(T)) < 32 / Q   ? 32 / Q
         : static_cast<int>(kBytes / sizeof(T)) > 8 * (32 / Q) ? 8 * (32 / Q)
                                                             : static_cast<int>(kBytes / sizeof(T));
}

// chunk j0's positions, kRegs a lane (lane l of its group the positions
// l, l + kSpan, ...), clamped to the run's last
template <int kSpan, int kRegs>
__device__ __forceinline__ void load_positions(int (&ix)[kRegs], const int* idx, int a, int j0,
                                               int l, int last) {
#pragma unroll
  for (int i = 0; i < kRegs; ++i) ix[i] = idx[a + min(j0 + l + kSpan * i, last)];
}

// a chunk's K terms of this lane's column, each position broadcast from
// the group lane that holds it
template <typename T, int kSpan, int kRegs, int K>
__device__ __forceinline__ void load_terms(T (&v)[K], const int (&ix)[kRegs], const T* col,
                                           int C, int g) {
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const int m = __shfl_sync(0xffffffffu, ix[t / kSpan], g * kSpan + t % kSpan);
    v[t] = col[static_cast<size_t>(m) * C];
  }
}

// One round of a warp: group g of Q (lanes g * 32 / Q ..) walks positions
// idx[a .. a + n) into state row `key`, each lane column c (`on`: a real
// column of a real task) from the stored value, in position order. Every
// lane runs every step (the shuffles and the max need the whole warp).
// Every load is made, past a run's end at its last position and by a lane
// that is not on at column 0, and only the adds are masked: with no branch
// between them a chunk's K loads go out together. Two chunk buffers: the
// next chunk's loads are in flight while this chunk's adds run.
template <typename T, int Q, int K>
__device__ __forceinline__ void walk_task(T* __restrict__ state, const T* __restrict__ terms,
                                          const int* idx, int a, int n, int key, int c,
                                          bool on, int C) {
  constexpr int kSpan = 32 / Q;
  constexpr int kRegs = K / kSpan;
  static_assert(K % kSpan == 0, "whole chunks");
  const int lane = threadIdx.x % 32;
  const int g = lane / kSpan, l = lane % kSpan;
  const int nmax = __reduce_max_sync(0xffffffffu, n);
  if (nmax == 0) return;
  const int last = max(n - 1, 0);
  const T* col = terms + (on ? c : 0);
  T* row = state + static_cast<size_t>(key) * C + c;
  T acc = on && n > 0 ? *row : T(0);
  int ix[kRegs];
  T v[K], w[K];
  load_positions<kSpan>(ix, idx, a, 0, l, last);
  load_terms<T, kSpan>(v, ix, col, C, g);
  load_positions<kSpan>(ix, idx, a, K, l, last);
  for (int j0 = 0; j0 < nmax; j0 += K) {
    const bool more = j0 + K < nmax;
    if (more) {
      load_terms<T, kSpan>(w, ix, col, C, g);
      load_positions<kSpan>(ix, idx, a, j0 + 2 * K, l, last);
    }
#pragma unroll
    for (int t = 0; t < K; ++t)
      if (on && j0 + t < n) acc = add_rn(acc, v[t]);
    if (more) {
#pragma unroll
      for (int t = 0; t < K; ++t) v[t] = w[t];
    }
  }
  if (on && n > 0) *row = acc;
}

// a key's local key k / G in key set b (k % G == b), else -1
__device__ __forceinline__ int local_key(int32_t k, int S, int G, int b) {
  const int key = checked_key(k, S);
  return key % G == b ? key / G : -1;
}

// every position's local key into shared memory (16 bytes of keys a load
// when they are aligned so)
__device__ __forceinline__ void load_local_keys(int* __restrict__ lkey,
                                                const int32_t* __restrict__ keys, int M, int S,
                                                int G, int b) {
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(keys) & 15) == 0) {
    head = M / 4 * 4;
    const int4* k4 = reinterpret_cast<const int4*>(keys);
#pragma unroll 4
    for (int i = threadIdx.x; i < M / 4; i += kThreads) {
      const int4 q = k4[i];
      reinterpret_cast<int4*>(lkey)[i] =
          make_int4(local_key(q.x, S, G, b), local_key(q.y, S, G, b), local_key(q.z, S, G, b),
                    local_key(q.w, S, G, b));
    }
  }
  for (int i = head + threadIdx.x; i < M; i += kThreads) lkey[i] = local_key(keys[i], S, G, b);
}

template <typename T, int Q>
__global__ void __launch_bounds__(kThreads)
row_scatter_small_kernel(T* __restrict__ state, const int32_t* __restrict__ keys,
                         const T* __restrict__ terms, int M, int S, int C, int ncg, int cw) {
  extern __shared__ __align__(16) int smem[];
  // block i walks column group i % ncg of key set b = i / ncg: the keys k
  // with k % G == b
  const int G = gridDim.x / ncg, b = blockIdx.x / ncg, cg = blockIdx.x % ncg;
  const int R = (S + G - 1) / G;          // local keys k / G
  int* lkey = smem;                       // M: each position's local key, or -1
  int* sorted = lkey + M;                 // this block's positions by run, each
                                          // run in position order
  int* cur = sorted + M;                  // kWarps x R: a warp's count of each
                                          // local key, then its cursor
  int* run_lk = cur + kWarps * R;         // R: the runs' local keys
  int* run_start = run_lk + R;            // R + 1: their starts in sorted
  __shared__ int wsum[kWarps], wruns[kWarps], n_runs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned lt = (1u << lane) - 1u;
  load_local_keys(lkey, keys, M, S, G, b);
  for (int i = threadIdx.x; i < kWarps * R; i += kThreads) cur[i] = 0;
  __syncthreads();
  // a stable counting sort of this block's positions by local key, in
  // two passes over each warp's chunk of positions: equal keys of a step
  // counted, and then placed, by __match_any_sync ranks, so no atomic
  // decides a count or a place
  const int chunk = (M + kThreads - 1) / kThreads * 32;
  const int lo = min(M, warp * chunk), hi = min(M, lo + chunk);
  int* mine = cur + warp * R;
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane;
    const int lk = i < hi ? lkey[i] : -1;
    const bool own = lk >= 0;
    const unsigned peers = __match_any_sync(0xffffffffu, lk);
    if (own && (peers & lt) == 0) mine[lk] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // the runs: the local keys with a position, in key order, each at the
  // sum of the counts before it (a block scan of each thread's slice of
  // the keys); a warp's cursor of a key: its run's start and the earlier
  // warps' counts of it
  const int per = (R + kThreads - 1) / kThreads;
  const int s0 = min(R, static_cast<int>(threadIdx.x) * per), s1 = min(R, s0 + per);
  int sum = 0, nz = 0;
  for (int k = s0; k < s1; ++k) {
    int n = 0;
    for (int w = 0; w < kWarps; ++w) n += cur[w * R + k];
    sum += n;
    nz += n > 0;
  }
  int isum = sum, inz = nz;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int ys = __shfl_up_sync(0xffffffffu, isum, d);
    const int yn = __shfl_up_sync(0xffffffffu, inz, d);
    if (lane >= d) {
      isum += ys;
      inz += yn;
    }
  }
  if (lane == 31) {
    wsum[warp] = isum;
    wruns[warp] = inz;
  }
  __syncthreads();
  int pb = isum - sum, rb = inz - nz;
  for (int w = 0; w < warp; ++w) {
    pb += wsum[w];
    rb += wruns[w];
  }
  for (int k = s0; k < s1; ++k) {
    int at = pb;
    for (int w = 0; w < kWarps; ++w) {
      const int x = cur[w * R + k];
      cur[w * R + k] = at;
      at += x;
    }
    if (at > pb) {
      run_lk[rb] = k;
      run_start[rb++] = pb;
    }
    pb = at;
  }
  if (threadIdx.x == kThreads - 1) {
    n_runs = rb;
    run_start[rb] = pb;
  }
  __syncthreads();
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane;
    const int lk = i < hi ? lkey[i] : -1;
    const bool own = lk >= 0;
    const unsigned peers = __match_any_sync(0xffffffffu, lk);
    const int at = own ? mine[lk] : 0;
    __syncwarp();
    if (own) {
      sorted[at + __popc(peers & lt)] = i;
      if ((peers & lt) == 0) mine[lk] = at + __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
  constexpr int kSpan = 32 / Q;
  const int g = lane / kSpan, l = lane % kSpan;
  const int c = cg * cw + l;
  for (int r0 = warp * Q; r0 < n_runs; r0 += kWarps * Q) {
    const int r = r0 + g;
    const bool have = r < n_runs;
    const int a = run_start[have ? r : 0], n = have ? run_start[r + 1] - a : 0;
    walk_task<T, Q, chunk_positions<T, Q, kSmallBytes>()>(
        state, terms, sorted, a, n, run_lk[have ? r : 0] * G + b, c, have && l < cw && c < C,
        C);
  }
}

template <typename T, int Q>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
row_scatter_walk_kernel(T* __restrict__ state, const int32_t* __restrict__ perm,
                        const int32_t* __restrict__ starts, const int32_t* __restrict__ order,
                        const int32_t* __restrict__ slots, const int32_t* __restrict__ counts,
                        const T* __restrict__ terms, int S, int C, int ncg, int cw) {
  constexpr int kSpan = 32 / Q;
  const int lane = threadIdx.x % 32;
  const int g = lane / kSpan, l = lane % kSpan;
  const int warps = gridDim.x * kWarps;
  const int tasks = counts[0] * ncg;
  for (int t0 = (blockIdx.x * kWarps + static_cast<int>(threadIdx.x) / 32) * Q; t0 < tasks;
       t0 += warps * Q) {
    const int task = t0 + g;
    const bool have = task < tasks;
    const int r = have ? order[task / ncg] : 0, cg = have ? task % ncg : 0;
    const int a = have ? starts[r] : 0, n = have ? starts[r + 1] - a : 0;
    const int c = cg * cw + l;
    walk_task<T, Q, chunk_positions<T, Q, kWalkBytes>()>(
        state, terms, perm, a, n, have ? checked_key(slots[r], S) : 0, c,
        have && l < cw && c < C, C);
  }
}

template <typename T, int Q>
int launch_small(void* state, const void* keys, const void* terms, int M, int S, int C,
                 int ncg, int cw, int blocks, cudaStream_t s) {
  const int R = (S + blocks / ncg - 1) / (blocks / ncg);
  const size_t smem =
      (2 * static_cast<size_t>(M) + (kWarps + 2) * static_cast<size_t>(R) + 1) * sizeof(int);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(row_scatter_small_kernel<T, Q>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  row_scatter_small_kernel<T, Q><<<blocks, kThreads, smem, s>>>(
      static_cast<T*>(state), static_cast<const int32_t*>(keys), static_cast<const T*>(terms),
      M, S, C, ncg, cw);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int Q>
int launch_walk(void* state, const void* perm, const void* starts, const void* order,
                const void* slots, const void* counts, const void* terms, int S, int C,
                int ncg, int cw, int blocks, cudaStream_t s) {
  row_scatter_walk_kernel<T, Q><<<blocks, kThreads, 0, s>>>(
      static_cast<T*>(state), static_cast<const int32_t*>(perm),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(slots), static_cast<const int32_t*>(counts),
      static_cast<const T*>(terms), S, C, ncg, cw);
  return static_cast<int>(cudaGetLastError());
}

// the lane split of C columns: q groups a warp of at most 32 / q lanes,
// ncg groups of cw columns a run
bool valid_split(int C, int q, int ncg, int cw) {
  return (q == 1 || q == 2) && cw >= 1 && cw <= 32 / q && ncg >= 1 &&
         static_cast<long long>(ncg) * cw >= C && static_cast<long long>(ncg - 1) * cw < C;
}

template <typename T>
int small_by_q(void* state, const void* keys, const void* terms, int M, int S, int C, int q,
               int ncg, int cw, int blocks, cudaStream_t s) {
  return q == 1 ? launch_small<T, 1>(state, keys, terms, M, S, C, ncg, cw, blocks, s)
                : launch_small<T, 2>(state, keys, terms, M, S, C, ncg, cw, blocks, s);
}

template <typename T>
int walk_by_q(void* state, const void* perm, const void* starts, const void* order,
              const void* slots, const void* counts, const void* terms, int S, int C, int q,
              int ncg, int cw, int blocks, cudaStream_t s) {
  return q == 1 ? launch_walk<T, 1>(state, perm, starts, order, slots, counts, terms, S, C, ncg,
                                    cw, blocks, s)
                : launch_walk<T, 2>(state, perm, starts, order, slots, counts, terms, S, C, ncg,
                                    cw, blocks, s);
}

}  // namespace

// the small path: M in [1, kSmallMaxM] over `blocks` blocks, ncg a key
// set (one a column group), each set at most kMaxLocalKeys of the S keys
extern "C" int alink_row_scatter_small(int dtype, void* state, const void* keys,
                                       const void* terms, int M, int S, int C, int q, int ncg,
                                       int cw, int blocks, void* stream) {
  if (M <= 0 || M > kSmallMaxM || S <= 0 || C <= 0 || !valid_split(C, q, ncg, cw) ||
      blocks < ncg || blocks % ncg != 0 || (S + blocks / ncg - 1) / (blocks / ncg) > kMaxLocalKeys)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return small_by_q<float>(state, keys, terms, M, S, C, q, ncg, cw, blocks, s);
  if (dtype == 1) return small_by_q<double>(state, keys, terms, M, S, C, q, ncg, cw, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the walk of a run plan (kernels/linear.py::RunPlan) over `blocks` blocks
extern "C" int alink_row_scatter_walk(int dtype, void* state, const void* perm,
                                      const void* starts, const void* order, const void* slots,
                                      const void* counts, const void* terms, int S, int C, int q,
                                      int ncg, int cw, int blocks, void* stream) {
  if (S <= 0 || C <= 0 || blocks <= 0 || !valid_split(C, q, ncg, cw))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return walk_by_q<float>(state, perm, starts, order, slots, counts, terms, S, C, q, ncg, cw,
                            blocks, s);
  if (dtype == 1)
    return walk_by_q<double>(state, perm, starts, order, slots, counts, terms, S, C, q, ncg, cw,
                             blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* alink_row_scatter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
