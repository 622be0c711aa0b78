// The run plan of the ordered keyed sums (kernels/linear.py::run_plan),
// built on the card, for Hopper (sm_90a).
//
// What it replaces: no TPU kernel. It is the plan that the port's own
// ordered kernels walk (csrc/linear_grad.cu: P1, the sparse gradient, and
// P2, FTRL's batch scatter-add); kernels/linear.py::run_plan_plain builds
// the same arrays with torch ops (two sorts) and one host read.
//
// Input: the flat keys (M int32, in [0, size)). Output, each run r a
// distinct key in key order:
//  * perm (M int32): the positions stably sorted by key, so each run's are
//    in ascending order;
//  * starts (runs + 1): run r is perm[starts[r] .. starts[r + 1]);
//  * slots (runs): run r's key;
//  * order (runs): the runs of more than kShortMax terms by length, longest
//    first, ties by run; then the short runs by run;
//  * counts (4): runs, heavy runs (at least kHeavyMin terms), medium runs
//    (the other runs of more than kShortMax), short runs.
// Nothing is read back by the host: the walk reads counts from device
// memory. A key outside [0, size) fails a device-side assert, which the
// stream reports at its next synchronize (the FTRL state kernels' contract).
//
// What bounds it: a few passes over M keys, microseconds of device time at
// micro-batch size, so the host's issue (one call, 2 launches a sort pass
// and 3 more) and the launches' latency. Design:
//  * the sort: a stable LSD radix sort of (key, position) over the bits of
//    size - 1, in passes of at most 9 bits (kernels/linear.py::
//    sort_digits), each pass two launches over chunks of positions:
//    sort_count (each chunk's digit counts; the first pass also checks
//    every key) and sort_place (a chunk's digit starts after every chunk's
//    smaller digits and the earlier chunks' same digit, summed from the
//    counts by the chunk itself; each of its 16 warps takes a contiguous
//    part of it, counts its digits into its own table, turns them into
//    cursors, then places its lanes 32 at a time, ranked by
//    __match_any_sync, so the order within a digit is the input order and
//    no atomic decides a position);
//  * plan_count, one block a chunk: the chunk's heads (a position whose
//    key differs from the one before it), long heads and heavy heads. A
//    run's class needs no search: the keys are sorted, so the run from
//    head p has at least L terms iff sk[p + L - 1] == sk[p];
//  * plan_runs, the same chunks: each block's offsets are the counts of
//    the blocks before it (at most kMaxBlocks of them, read by every
//    block); a block scan of each tile's heads gives each head its run id
//    r, and of its long heads the long runs' rank l, so long runs are
//    compacted in run order (into `lng`) and a short run goes straight to
//    order[n_long + r - l];
//  * plan_order, one block: the long runs (at most M / 33) stably sorted
//    by their length, longest first, into order[0 .. n_long): an LSD radix
//    sort, 8 bits a pass, of maxlen - length over the bits that can vary
//    (one run: none), the 32 warps ranking lanes as sort_place does; and
//    the counts.
// Integer atomics only count (shared-memory histograms), so no result
// depends on the order in which threads run.
#include <cuda_runtime.h>

#include <cassert>
#include <cstdint>

namespace {

constexpr int kHeavyMin = 2048;  // kernels/linear.py::HEAVY_MIN
constexpr int kShortMax = 32;    // kernels/linear.py::SHORT_MAX
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;  // kernels/linear.py::plan_blocks
constexpr int kSortThreads = 512;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kMaxDigitBits = 9;  // kernels/linear.py::sort_digits
constexpr int kMaxDigits = 1 << kMaxDigitBits;

// the block's sum of v over all threads (every thread gets it)
__device__ __forceinline__ int block_sum(int v, int* red) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kWarps ? red[lane] : 0;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// the block's exclusive prefix sum of v in thread order (W warps), and its
// total
template <int W>
__device__ __forceinline__ int block_scan(int v, int* red, int* total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  __syncthreads();
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  int w = lane < W ? red[lane] : 0;
  int wincl = w;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, wincl, d);
    if (lane >= d) wincl += y;
  }
  *total = __shfl_sync(0xffffffffu, wincl, 31);
  const int before = __shfl_sync(0xffffffffu, wincl - w, warp);
  return before + incl - v;
}

// the run from head p (key k) has more than kShortMax terms; at least
// kHeavyMin
__device__ __forceinline__ bool is_long(const int* sk, int p, int M, int k) {
  return p < M - kShortMax && sk[p + kShortMax] == k;
}
__device__ __forceinline__ bool is_heavy(const int* sk, int p, int M, int k) {
  return p <= M - kHeavyMin && sk[p + kHeavyMin - 1] == k;
}

// -- the sort ---------------------------------------------------------------

// each chunk's count of each digit, into hist[chunk * 2^dbits + digit];
// the first pass checks every key
__global__ void __launch_bounds__(kSortThreads)
sort_count(const int* __restrict__ keys, int M, int size, int chunk, int shift, int dbits,
           int check, int* __restrict__ hist) {
  __shared__ int cnt[kMaxDigits];
  const int D = 1 << dbits;
  for (int t = threadIdx.x; t < D; t += kSortThreads) cnt[t] = 0;
  __syncthreads();
  const int lo = blockIdx.x * chunk;
  const int hi = min(M, lo + chunk);
  for (int p = lo + threadIdx.x; p < hi; p += kSortThreads) {
    const int k = keys[p];
    if (check) assert(k >= 0 && k < size);
    atomicAdd(&cnt[(k >> shift) & (D - 1)], 1);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < D; t += kSortThreads) hist[blockIdx.x * D + t] = cnt[t];
}

// each chunk's (key, position) pairs placed at their digit's cursors: pos
// of the pass's input (nullptr: the identity) goes with its key
__global__ void __launch_bounds__(kSortThreads)
sort_place(const int* __restrict__ kin, const int* __restrict__ pin, int M, int chunk,
           int shift, int dbits, const int* __restrict__ hist, int* __restrict__ kout,
           int* __restrict__ pout) {
  __shared__ int tab[kSortWarps * kMaxDigits];  // a digit table a warp
  __shared__ int red[kSortWarps];
  const int D = 1 << dbits;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lo = blockIdx.x * chunk;
  const int hi = min(M, lo + chunk);
  const int part = (chunk + kSortWarps * 32 - 1) / (kSortWarps * 32) * 32;
  const int wlo = min(hi, lo + warp * part);
  const int whi = min(hi, wlo + part);
  int* cur = tab + warp * D;
  for (int t = threadIdx.x; t < kSortWarps * D; t += kSortThreads) tab[t] = 0;
  // digit t's start in this chunk: every chunk's smaller digits, then the
  // earlier chunks' digit t (a thread a digit: D <= kSortThreads)
  const int t = threadIdx.x;
  int total = 0, before = 0;
  if (t < D) {
#pragma unroll 8
    for (int b = 0; b < static_cast<int>(gridDim.x); ++b) {
      const int v = hist[b * D + t];
      total += v;
      before += b < static_cast<int>(blockIdx.x) ? v : 0;
    }
  }
  int all;
  const int start = block_scan<kSortWarps>(total, red, &all) + before;
  __syncthreads();
  for (int i = wlo + lane; i < whi; i += 32) atomicAdd(&cur[(kin[i] >> shift) & (D - 1)], 1);
  __syncthreads();
  // digit t's cursor for warp w: its start, then the counts of digit t in
  // the earlier warps
  if (t < D) {
    int c = start;
    for (int w = 0; w < kSortWarps; ++w) {
      const int n = tab[w * D + t];
      tab[w * D + t] = c;
      c += n;
    }
  }
  __syncthreads();
  const unsigned lt = (1u << lane) - 1u;
  for (int i0 = wlo; i0 < whi; i0 += 32) {
    const int i = i0 + lane;
    const bool live = i < whi;
    const int k = live ? kin[i] : 0;
    const int d = live ? (k >> shift) & (D - 1) : D;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & lt);
    const int pos = live ? cur[d] + rank : 0;
    __syncwarp();
    if (live && rank == 0) cur[d] = pos + __popc(peers);
    __syncwarp();
    if (live) {
      kout[pos] = k;
      pout[pos] = pin ? pin[i] : i;
    }
  }
}

// -- the plan ---------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
plan_count(const int* __restrict__ sk, int M, int chunk, int* __restrict__ blk) {
  __shared__ int red[kWarps];
  const int lo = blockIdx.x * chunk;
  const int hi = min(M, lo + chunk);
  int heads = 0, longs = 0, heavy = 0;
  for (int p = lo + threadIdx.x; p < hi; p += kThreads) {
    const int k = sk[p];
    if (p == 0 || sk[p - 1] != k) {
      ++heads;
      if (is_long(sk, p, M, k)) {
        ++longs;
        heavy += is_heavy(sk, p, M, k);
      }
    }
  }
  heads = block_sum(heads, red);
  longs = block_sum(longs, red);
  heavy = block_sum(heavy, red);
  if (threadIdx.x == 0) {
    blk[3 * blockIdx.x] = heads;
    blk[3 * blockIdx.x + 1] = longs;
    blk[3 * blockIdx.x + 2] = heavy;
  }
}

__global__ void __launch_bounds__(kThreads)
plan_runs(const int* __restrict__ sk, int M, int chunk, const int* __restrict__ blk,
          int* __restrict__ starts, int* __restrict__ slots, int* __restrict__ order,
          int* __restrict__ lng) {
  __shared__ int red[kWarps];
  const int b = blockIdx.x, blocks = gridDim.x;
  int h_before = 0, l_before = 0, runs = 0, n_long = 0;
  for (int i = threadIdx.x; i < blocks; i += kThreads) {
    const int h = blk[3 * i], l = blk[3 * i + 1];
    runs += h;
    n_long += l;
    if (i < b) {
      h_before += h;
      l_before += l;
    }
  }
  h_before = block_sum(h_before, red);
  l_before = block_sum(l_before, red);
  runs = block_sum(runs, red);
  n_long = block_sum(n_long, red);
  const int lo = b * chunk;
  const int hi = min(M, lo + chunk);
  // each tile's heads (low 16 bits) and long heads (high 16) at once: a
  // tile holds at most kThreads of either
  for (int base = lo; base < hi; base += kThreads) {
    const int p = base + threadIdx.x;
    int k = 0, flags = 0;
    if (p < hi) {
      k = sk[p];
      if (p == 0 || sk[p - 1] != k) flags = 1 | (is_long(sk, p, M, k) ? 1 << 16 : 0);
    }
    int tot;
    const int excl = block_scan<kWarps>(flags, red, &tot);
    if (flags) {
      const int r = h_before + (excl & 0xffff);
      const int l = l_before + (excl >> 16);
      starts[r] = p;
      slots[r] = k;
      if (flags >> 16)
        lng[l] = r;
      else
        order[n_long + r - l] = r;
    }
    h_before += tot & 0xffff;
    l_before += tot >> 16;
  }
  if (b == blocks - 1 && threadIdx.x == 0) starts[runs] = M;
}

__global__ void __launch_bounds__(kThreads)
plan_order(const int* __restrict__ starts, const int* __restrict__ blk, int blocks,
           int* __restrict__ lng, int* __restrict__ tmp, int* __restrict__ order,
           int* __restrict__ counts) {
  __shared__ int red[kWarps];
  __shared__ int hist[kWarps * 256];  // a digit table a warp
  __shared__ int wsum[256 / 32];
  int runs = 0, n_long = 0, n_heavy = 0;
  for (int i = threadIdx.x; i < blocks; i += kThreads) {
    runs += blk[3 * i];
    n_long += blk[3 * i + 1];
    n_heavy += blk[3 * i + 2];
  }
  runs = block_sum(runs, red);
  n_long = block_sum(n_long, red);
  n_heavy = block_sum(n_heavy, red);
  if (threadIdx.x == 0) {
    counts[0] = runs;
    counts[1] = n_heavy;
    counts[2] = n_long - n_heavy;
    counts[3] = runs - n_long;
  }
  int maxlen = 0;
  for (int i = threadIdx.x; i < n_long; i += kThreads) {
    const int r = lng[i];
    maxlen = max(maxlen, starts[r + 1] - starts[r]);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) maxlen = max(maxlen, __shfl_xor_sync(0xffffffffu, maxlen, d));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = maxlen;
  __syncthreads();
  maxlen = 0;
  for (int w = 0; w < kWarps; ++w) maxlen = max(maxlen, red[w]);
  // the key maxlen - length of a long run is below 2^bits, bits those of
  // maxlen - (kShortMax + 1); one run needs no pass
  int passes = 0;
  if (n_long > 1)
    for (int v = maxlen - (kShortMax + 1); v > 0; v >>= 8) ++passes;
  if (passes == 0) {
    for (int i = threadIdx.x; i < n_long; i += kThreads) order[i] = lng[i];
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int part = (n_long + kWarps * 32 - 1) / (kWarps * 32) * 32;
  const int lo = min(n_long, warp * part);
  const int hi = min(n_long, lo + part);
  const unsigned lt = (1u << lane) - 1u;
  int* cur = hist + warp * 256;
  for (int pass = 0; pass < passes; ++pass) {
    const int* in = pass & 1 ? tmp : lng;
    int* out = pass == passes - 1 ? order : (pass & 1 ? lng : tmp);
    const int shift = 8 * pass;
    for (int k = threadIdx.x; k < kWarps * 256; k += kThreads) hist[k] = 0;
    __syncthreads();
    for (int i = lo + lane; i < hi; i += 32) {
      const int r = in[i];
      atomicAdd(&cur[((maxlen - (starts[r + 1] - starts[r])) >> shift) & 255], 1);
    }
    __syncthreads();
    // digit t's cursor for warp w: the counts of smaller digits, then of
    // digit t in the earlier warps (threads 0..255, one digit each)
    int total = 0, incl = 0;
    if (threadIdx.x < 256) {
      for (int w = 0; w < kWarps; ++w) total += hist[w * 256 + threadIdx.x];
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
      for (int w = 0; w < kWarps; ++w) {
        const int n = hist[w * 256 + threadIdx.x];
        hist[w * 256 + threadIdx.x] = c;
        c += n;
      }
    }
    __syncthreads();
    for (int i0 = lo; i0 < hi; i0 += 32) {
      const int i = i0 + lane;
      const int r = i < hi ? in[i] : 0;
      const int d = i < hi ? ((maxlen - (starts[r + 1] - starts[r])) >> shift) & 255 : 256;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      const int rank = __popc(peers & lt);
      const int pos = i < hi ? cur[d] + rank : 0;
      __syncwarp();
      if (i < hi && rank == 0) cur[d] = pos + __popc(peers);
      __syncwarp();
      if (i < hi) out[pos] = r;
    }
    __syncthreads();
  }
}

}  // namespace

// keys (M) int32 in [0, size); perm (M), starts (M + 1), slots (M), order
// (M), counts (4) int32, the plan. The chunks: blocks of chunk positions
// (a multiple of 1024), blocks <= kMaxBlocks, (blocks - 1) * chunk < M <=
// blocks * chunk. The sort: passes of dbits bits (at most kMaxDigitBits)
// that cover the bits of size - 1. scratch: scratch_ints int32, at least
// 4 * M + (2^dbits + 3) * blocks + 2 * (M / (kShortMax + 1) + 1).
extern "C" int alink_run_plan(const void* keys, int M, int size, int chunk, int blocks,
                              int passes, int dbits, void* perm, void* starts, void* slots,
                              void* order, void* counts, void* scratch, long long scratch_ints,
                              void* stream) {
  const int bits = size > 1 ? 32 - __builtin_clz(static_cast<unsigned>(size - 1)) : 0;
  const long long cap = M / (kShortMax + 1) + 1;
  if (M <= 0 || size <= 0 || chunk <= 0 || chunk % kThreads || blocks <= 0 ||
      blocks > kMaxBlocks || static_cast<long long>(blocks - 1) * chunk >= M ||
      static_cast<long long>(blocks) * chunk < M || passes < 1 || dbits < 1 ||
      dbits > kMaxDigitBits || passes * dbits < bits ||
      scratch_ints < 4LL * M + ((1LL << dbits) + 3) * blocks + 2 * cap)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* kbuf[2] = {static_cast<int*>(scratch), static_cast<int*>(scratch) + M};
  int* pbuf[2] = {kbuf[1] + M, kbuf[1] + 2LL * M};
  int* hist = kbuf[1] + 3LL * M;
  int* blk = hist + (static_cast<long long>(blocks) << dbits);
  int* lng = blk + 3 * blocks;
  int* tmp = lng + cap;
  const int* kin = static_cast<const int*>(keys);
  const int* pin = nullptr;
  for (int p = 0; p < passes; ++p) {
    int* kout = kbuf[p & 1];
    int* pout = p == passes - 1 ? static_cast<int*>(perm) : pbuf[p & 1];
    sort_count<<<blocks, kSortThreads, 0, s>>>(kin, M, size, chunk, p * dbits, dbits, p == 0,
                                               hist);
    sort_place<<<blocks, kSortThreads, 0, s>>>(kin, pin, M, chunk, p * dbits, dbits, hist, kout,
                                               pout);
    kin = kout;
    pin = pout;
  }
  plan_count<<<blocks, kThreads, 0, s>>>(kin, M, chunk, blk);
  plan_runs<<<blocks, kThreads, 0, s>>>(kin, M, chunk, blk, static_cast<int*>(starts),
                                        static_cast<int*>(slots), static_cast<int*>(order), lng);
  plan_order<<<1, kThreads, 0, s>>>(static_cast<const int*>(starts), blk, blocks, lng, tmp,
                                    static_cast<int*>(order), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* alink_run_plan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
