// The run plan of the ordered keyed sums (kernels/linear.py::run_plan),
// built on the card, for Hopper (sm_90a).
//
// What it replaces: no TPU kernel. It is the plan that the port's own
// ordered kernels walk (csrc/linear_grad.cu: P1, the sparse gradient, and
// P2, FTRL's batch scatter-add; csrc/row_scatter.cu: P3's plan path);
// kernels/linear.py::run_plan_plain builds the same arrays with torch ops
// (two sorts) and one host read.
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
// Nothing is read back by the host: the walks read counts from device
// memory. A key outside [0, size) fails a device-side assert, which the
// stream reports at its next synchronize (the FTRL state kernels' contract).
//
// What bounds it: a few passes over M keys (8 M + 12 runs bytes at the
// least), microseconds at micro-batch size, so the launches, the host's
// issue and the latency of each phase's dependent reads and barriers.
// Design: one cooperative launch of at most one block an SM (512 threads,
// each with 16 loads in flight), its phases separated by a grid barrier
// (cooperative_groups' grid sync; a block barrier when the grid is one
// block):
//  * the sort: a stable LSD radix sort of (key, position) over the bits of
//    size - 1, in passes of at most 9 bits (kernels/linear.py::
//    sort_digits). A pass is three phases over the blocks' chunks of
//    positions (kernels/linear.py::plan_grid): count (the block's digits,
//    each warp counting its part into its own column; the first pass also
//    checks every key), scan (a warp a digit: the exclusive sum of that
//    digit's counts over the blocks, and the digit's total; each entry of
//    the digit-major histogram is read once, so the scan is linear in
//    blocks x digits; one block skips it), place (a block's cursor of a
//    digit is the exclusive sum of the totals plus its own entry; a tile
//    of 8192 pairs at a time, each warp ranking its 512 by digit
//    (__match_any_sync, so the order within a digit is the input order
//    and no atomic decides a position), one scan of the (digit, warp)
//    counts placing each pair in the tile in shared memory, and the
//    placed tile written out, each digit's pairs to consecutive places);
//  * heads: each block's heads (a position whose key differs from the one
//    before it), long heads, heavy heads and first head. A run's class
//    needs no search: the keys are sorted, so the run from head p has at
//    least L terms iff sk[p + L - 1] == sk[p];
//  * runs: each block's run and long-run offsets are the sums of the
//    blocks' head counts before it (one value a block); a block scan a
//    tile of 8 positions a thread gives each head its run r and each long
//    head its rank l among the long runs, so starts and slots are written,
//    the long runs compacted in run order with their lengths (the next
//    head's position less theirs; the block's last run ends at the next
//    block's first head) and a short run goes straight to
//    order[n_long + r - l];
//  * order: the long runs (at most M / 33) by length, longest first, ties
//    by run: up to kRankMax of them one block places each at the count of
//    the longer runs and of the runs of its length before it; more are
//    sorted by maxlen - length over all the blocks, by the sort's passes
//    of 8 bits over the bits that can vary (one length: none).
// A grid of one block (M <= kernels/linear.py::PLAN_MIN_CHUNK on the H100)
// keeps its intermediate keys, positions, sorted keys and long runs in
// shared memory.
// Integer atomics only count (shared-memory histograms), so no result
// depends on the order in which threads run.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cassert>
#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kHeavyMin = 2048;  // kernels/linear.py::HEAVY_MIN
constexpr int kShortMax = 32;    // kernels/linear.py::SHORT_MAX
constexpr int kThreads = 512;    // kernels/linear.py::_PLAN_THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDigitBits = 9;  // kernels/linear.py::sort_digits
constexpr int kMaxDigits = 1 << kMaxDigitBits;
static_assert(kThreads >= kMaxDigits, "a thread a digit");
constexpr int kOrderBits = 8;     // the long runs' sort
constexpr int kUnroll = 16;       // loads a lane keeps in flight; pairs it
                                  // ranks in a tile
constexpr int kPlace = kThreads * kUnroll;  // pairs a block places at once
constexpr int kPad = kWarps + 1;  // a digit's row of the warps' counts
// the shared memory every block takes (ints): the warps' counts of each
// digit, a tile's keys and values as placed, the block's digit counts and
// cursors
constexpr int kSmemInts = kMaxDigits * kPad + 2 * kPlace + 2 * kMaxDigits;
constexpr int kRankMax = 1024;    // long runs one block orders by rank
constexpr int kE = 8;             // positions a thread in the runs' tiles
constexpr int kTile = kThreads * kE;
constexpr int kBlk = 5;           // values a block: heads, long heads, heavy
                                  // heads, first head, longest long run
constexpr int kMaxDevices = 64;

struct Args {
  const int* keys;
  int M, size, chunk, passes, dbits;
  int local;  // one block, its data in shared memory
  int* perm;
  int* starts;
  int* slots;
  int* order;
  int* counts;
  int* sk;    // M: the sorted keys
  int* lng;   // cap: the long runs in run order
  int* llen;  // cap: their lengths
  int* hist;  // kMaxDigits x blocks, digit-major
  int* tot;   // kMaxDigits: each digit's total
  int* blk;   // kBlk x blocks
};

__device__ __forceinline__ void grid_sync() {
  if (gridDim.x == 1)
    __syncthreads();
  else
    cg::this_grid().sync();
}

// the block's sums of v[0 .. N - 1] over all threads, or maxima where bit
// i of maxs is set (of values >= 0), or minima where bit i of mins is set
// (every thread gets them); red holds kWarps x N ints
template <int N>
__device__ __forceinline__ void block_reduce(int (&v)[N], unsigned mins, unsigned maxs, int* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto op = [&](int i, int a, int b) {
    return mins >> i & 1 ? min(a, b) : maxs >> i & 1 ? max(a, b) : a + b;
  };
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v[i] = op(i, v[i], __shfl_xor_sync(0xffffffffu, v[i], d));
  __syncthreads();
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) red[i * kWarps + warp] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = lane < kWarps ? red[i * kWarps + lane] : mins >> i & 1 ? INT_MAX : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v[i] = op(i, v[i], __shfl_xor_sync(0xffffffffu, v[i], d));
  }
}

// a warp's inclusive prefix sum of v in lane order
__device__ __forceinline__ int warp_incl(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

// the block's exclusive prefix sum of v in thread order, and its total
__device__ __forceinline__ int block_scan(int v, int* red, int* total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int incl = warp_incl(v);
  __syncthreads();
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  const int w = lane < kWarps ? red[lane] : 0;
  const int wincl = warp_incl(w);
  *total = __shfl_sync(0xffffffffu, wincl, 31);
  const int before = __shfl_sync(0xffffffffu, wincl - w, warp);
  return before + incl - v;
}

// One stable LSD pass over n (key, value) pairs by the digit (key' >>
// shift) & (2^dbits - 1), key' = flip - key when flip, else key; block b
// takes positions [b * chunk, (b + 1) * chunk). kout (if any) gets key',
// vout the value (vin's, or the position when vin is null). check: assert
// each key is in [0, check). In a grid of more than one block the pass
// syncs the grid twice; the caller syncs it before anything reads kout or
// vout.
__device__ void radix_pass(const int* kin, const int* vin, int n, int chunk, int shift,
                           int dbits, int flip, int check, int* kout, int* vout, int* hist,
                           int* tot, int* tab, int* red) {
  const int D = 1 << dbits;
  const int B = gridDim.x, b = blockIdx.x, t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int lo = static_cast<int>(min(static_cast<long long>(n), static_cast<long long>(b) * chunk));
  const int hi = static_cast<int>(min(static_cast<long long>(n), static_cast<long long>(lo) + chunk));
  int* out_k = tab + kMaxDigits * kPad;  // a tile as placed
  int* out_v = out_k + kPlace;
  int* cnt = out_v + kPlace;             // the block's count of each digit
  int* cursor = cnt + kMaxDigits;        // each digit's next place
  const unsigned lt = (1u << lane) - 1u;
  // count: each warp its contiguous part into its column of tab[d][w]
  for (int j = t; j < D * kPad; j += kThreads) tab[j] = 0;
  __syncthreads();
  {
    const int part = (chunk + kThreads - 1) / kThreads * 32;
    const int wlo = static_cast<int>(min(static_cast<long long>(hi),
                                         lo + static_cast<long long>(warp) * part));
    const int whi = static_cast<int>(min(static_cast<long long>(hi),
                                         static_cast<long long>(wlo) + part));
    for (int i0 = wlo; i0 < whi; i0 += 32 * kUnroll) {
      int k[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) k[u] = kin[min(i0 + 32 * u + lane, whi - 1)];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i0 + 32 * u + lane < whi) {
          if (check) assert(k[u] >= 0 && k[u] < check);
          const int key = flip ? flip - k[u] : k[u];
          atomicAdd(&tab[((key >> shift) & (D - 1)) * kPad + warp], 1);
        }
      }
    }
  }
  __syncthreads();
  if (t < D) {
    int c = 0;
    for (int w = 0; w < kWarps; ++w) c += tab[t * kPad + w];
    cnt[t] = c;
  }
  __syncthreads();
  if (B == 1) {
    // one block: its digit starts are the exclusive sum of its counts
    int all;
    const int start = block_scan(t < D ? cnt[t] : 0, red, &all);
    if (t < D) cursor[t] = start;
  } else {
    if (t < D) hist[t * B + b] = cnt[t];
    grid_sync();
    // scan: a warp a digit, its counts over the blocks in block order
    const int per = (B + 31) / 32;
    for (int d = b * kWarps + warp; d < D; d += B * kWarps) {
      int* col = hist + d * B;
      const int j0 = min(B, lane * per), j1 = min(B, j0 + per);
      int s = 0;
      for (int j = j0; j < j1; ++j) s += col[j];
      const int incl = warp_incl(s);
      int c = incl - s;
      for (int j = j0; j < j1; ++j) {
        const int m = col[j];
        col[j] = c;
        c += m;
      }
      if (lane == 31) tot[d] = incl;
    }
    grid_sync();
    // digit d's start in this block: the totals of the smaller digits and
    // the earlier blocks' d
    int all;
    const int start = block_scan(t < D ? tot[t] : 0, red, &all);
    if (t < D) cursor[t] = start + hist[t * B + b];
  }
  // place, a tile of kPlace pairs at a time: warp w ranks the tile's w-th
  // 32 x kUnroll pairs (u, then lane) by digit into its column of tab[d][w]
  // (__match_any_sync); one exclusive scan of tab in (digit, warp) order
  // gives each warp's start of each digit in the tile, where its pairs are
  // placed in shared memory; the placed tile is written out in order, each
  // digit's pairs to consecutive places after the digit's cursor (the
  // earlier blocks' and digits' counts from the scan, then this block's
  // earlier tiles)
  const int per = D * kWarps > kThreads ? D * kWarps / kThreads : 1;  // the scan's entries a thread
  for (int base = lo; base < hi; base += kPlace) {
    const int n_tile = min(kPlace, hi - base);
    for (int j = t; j < D * kPad; j += kThreads) tab[j] = 0;
    __syncthreads();
    const int w0 = base + warp * 32 * kUnroll + lane;
    int k[kUnroll], v[kUnroll], rank[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = min(w0 + 32 * u, hi - 1);
      k[u] = kin[i];
      v[u] = vin ? vin[i] : i;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = w0 + 32 * u < hi;
      k[u] = flip ? flip - k[u] : k[u];
      const int d = live ? (k[u] >> shift) & (D - 1) : D;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      const int below = __popc(peers & lt);
      int* c = tab + d * kPad + warp;
      rank[u] = live ? *c + below : 0;
      __syncwarp();
      if (live && below == 0) *c += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    {
      // entries [t * per, (t + 1) * per) in (digit, warp) order: their sum,
      // the block's exclusive scan, then each its exclusive sum
      const int L0 = min(t * per, D * kWarps), L1 = min(L0 + per, D * kWarps);
      int s = 0;
      for (int L = L0; L < L1; ++L) s += tab[(L / kWarps) * kPad + L % kWarps];
      int all;
      int c = block_scan(s, red, &all);
      for (int L = L0; L < L1; ++L) {
        int* e = tab + (L / kWarps) * kPad + L % kWarps;
        const int m = *e;
        *e = c;
        c += m;
      }
    }
    __syncthreads();
    // tab[d][0] is digit d's start in the tile
    const int n_d = t < D ? (t + 1 < D ? tab[(t + 1) * kPad] : n_tile) - tab[t * kPad] : 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (w0 + 32 * u < hi) {
        const int tp = tab[((k[u] >> shift) & (D - 1)) * kPad + warp] + rank[u];
        out_k[tp] = k[u];
        out_v[tp] = v[u];
      }
    }
    __syncthreads();
    for (int j = t; j < n_tile; j += kThreads) {
      const int key = out_k[j];
      const int d = (key >> shift) & (D - 1);
      const int pos = cursor[d] + j - tab[d * kPad];
      if (kout) kout[pos] = key;
      vout[pos] = out_v[j];
    }
    __syncthreads();
    if (t < D) cursor[t] += n_d;
  }
}

// the heads among a thread's kE positions p0 .. p0 + kE - 1 (below hi) of
// the sorted keys: bit j of *head, *lng, *heavy for position p0 + j; key[j]
// its key
__device__ __forceinline__ void tile_heads(const int* sk, int M, int hi, int p0, int* key,
                                           unsigned* head, unsigned* lng, unsigned* heavy) {
  int prev = p0 > 0 && p0 < hi ? sk[p0 - 1] : 0;
#pragma unroll
  for (int j = 0; j < kE; ++j) key[j] = p0 + j < hi ? sk[p0 + j] : 0;
  unsigned h = 0, l = 0, hv = 0;
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    const int p = p0 + j;
    if (p < hi && (p == 0 || key[j] != prev)) {
      h |= 1u << j;
      if (p < M - kShortMax && sk[p + kShortMax] == key[j]) {
        l |= 1u << j;
        if (p <= M - kHeavyMin && sk[p + kHeavyMin - 1] == key[j]) hv |= 1u << j;
      }
    }
    prev = key[j];
  }
  *head = h;
  *lng = l;
  *heavy = hv;
}

__global__ void __launch_bounds__(kThreads, 1) run_plan_kernel(const Args a) {
  extern __shared__ int smem[];
  __shared__ int red[kWarps * 6];
  const int B = gridDim.x, b = blockIdx.x, t = threadIdx.x;
  const int M = a.M;
  int* tab = smem;
  // where the sort's passes and the runs keep their data: one block keeps
  // its intermediate keys and positions, the sorted keys and the long runs
  // in shared memory
  const int cap = M / (kShortMax + 1) + 1;
  int *sk = a.sk, *ka = a.slots, *va = a.order, *lng = a.lng, *llen = a.llen;
  int *hist = a.hist, *tot = a.tot, *blk = a.blk;
  if (a.local) {
    sk = smem + kSmemInts;
    ka = sk + M;
    va = ka + M;
    lng = va + M;
    llen = lng + cap;
    blk = llen + cap;
  }
  // -- the sort: the last pass into (sk, perm), the others alternating
  // between (ka, va) and (sk, perm)
  const int* kin = a.keys;
  const int* vin = nullptr;
  for (int p = 0; p < a.passes; ++p) {
    const bool fin = ((a.passes - 1 - p) & 1) == 0;
    int* kout = fin ? sk : ka;
    int* vout = fin ? a.perm : va;
    radix_pass(kin, vin, M, a.chunk, p * a.dbits, a.dbits, 0, p == 0 ? a.size : 0, kout, vout,
               hist, tot, tab, red);
    grid_sync();
    kin = kout;
    vin = vout;
  }
  // -- heads: each block's heads, long heads, heavy heads, first head
  const int lo = static_cast<int>(min(static_cast<long long>(M), static_cast<long long>(b) * a.chunk));
  const int hi = static_cast<int>(min(static_cast<long long>(M), static_cast<long long>(lo) + a.chunk));
  {
    int v[4] = {0, 0, 0, INT_MAX};
    for (int base = lo; base < hi; base += kTile) {
      int key[kE];
      unsigned h, l, hv;
      tile_heads(sk, M, hi, base + t * kE, key, &h, &l, &hv);
      v[0] += __popc(h);
      v[1] += __popc(l);
      v[2] += __popc(hv);
      if (h) v[3] = min(v[3], base + t * kE + __ffs(h) - 1);
    }
    block_reduce(v, 1u << 3, 0u, red);
    if (t == 0) {
      blk[kBlk * b] = v[0];
      blk[kBlk * b + 1] = v[1];
      blk[kBlk * b + 2] = v[2];
      blk[kBlk * b + 3] = v[3];
    }
  }
  grid_sync();
  // -- runs: this block's offsets from the blocks before it (one value a
  // block), the totals, and the first head after its chunk
  int h_before, l_before, n_long, next;
  {
    int v[6] = {0, 0, 0, 0, 0, INT_MAX};
    for (int i = t; i < B; i += kThreads) {
      const int h = blk[kBlk * i], l = blk[kBlk * i + 1];
      v[2] += h;
      v[3] += l;
      v[4] += blk[kBlk * i + 2];
      if (i < b) {
        v[0] += h;
        v[1] += l;
      }
      if (i > b) v[5] = min(v[5], blk[kBlk * i + 3]);
    }
    block_reduce(v, 1u << 5, 0u, red);
    h_before = v[0];
    l_before = v[1];
    n_long = v[3];
    next = min(v[5], M);
    if (b == 0 && t == 0) {
      a.counts[0] = v[2];
      a.counts[1] = v[4];
      a.counts[2] = v[3] - v[4];
      a.counts[3] = v[2] - v[3];
    }
    if (b == B - 1 && t == 0) a.starts[v[2]] = M;
  }
  const int l0 = l_before;
  for (int base = lo; base < hi; base += kTile) {
    const int p0 = base + t * kE;
    int key[kE];
    unsigned h, l, hv;
    tile_heads(sk, M, hi, p0, key, &h, &l, &hv);
    int tot2;
    const int excl = block_scan(__popc(h) | __popc(l) << 16, red, &tot2);
    int r = h_before + (excl & 0xffff), q = l_before + (excl >> 16);
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      if (h >> j & 1) {
        a.starts[r] = p0 + j;
        a.slots[r] = key[j];
        if (l >> j & 1) {
          // one long run is the order's head; more are ordered below
          if (n_long > 1)
            lng[q] = r;
          else
            a.order[q] = r;
          ++q;
        } else {
          a.order[n_long + r - q] = r;
        }
        ++r;
      }
    }
    h_before += tot2 & 0xffff;
    l_before += tot2 >> 16;
  }
  if (n_long <= 1) return;
  // the lengths of this block's long runs (its own starts, the last one
  // ending at the next block's first head) and the longest
  __syncthreads();
  {
    int v[1] = {0};
    for (int q = l0 + t; q < l_before; q += kThreads) {
      const int r = lng[q];
      const int end = r + 1 < h_before ? a.starts[r + 1] : next;
      const int len = end - a.starts[r];
      llen[q] = len;
      v[0] = max(v[0], len);
    }
    block_reduce(v, 0u, 1u, red);
    if (t == 0) blk[kBlk * b + 4] = v[0];
  }
  grid_sync();
  // -- order: the long runs by length, longest first, ties by run
  if (n_long <= kRankMax) {
    // few: block 0 places each at the count of the longer runs and of the
    // runs of its length before it
    if (b != 0) return;
    int* len = tab + kMaxDigits * kPad;  // the tile's room, free now
    for (int i = t; i < n_long; i += kThreads) len[i] = llen[i];
    __syncthreads();
    for (int i = t; i < n_long; i += kThreads) {
      const int mine = len[i];
      int rank = 0;
      for (int j = 0; j < n_long; ++j) {
        const int other = len[j];
        rank += other > mine || (other == mine && j < i);
      }
      a.order[rank] = lng[i];
    }
    return;
  }
  // many: sorted by maxlen - length over the blocks; the key lies in [0,
  // maxlen - (kShortMax + 1)]
  int maxlen[1] = {0};
  for (int i = t; i < B; i += kThreads) maxlen[0] = max(maxlen[0], blk[kBlk * i + 4]);
  block_reduce(maxlen, 0u, 1u, red);
  int passes = 0;
  for (int v = maxlen[0] - (kShortMax + 1); v > 0; v >>= kOrderBits) ++passes;
  if (passes == 0) {  // one length: run order
    for (int i = b * kThreads + t; i < n_long; i += B * kThreads) a.order[i] = lng[i];
    return;
  }
  // the passes' buffers: the sorted keys' room, free now (4 n_long <= M)
  const int chunk = (n_long + B - 1) / B;
  const int* okin = llen;
  const int* ovin = lng;
  for (int p = 0; p < passes; ++p) {
    const bool last = p == passes - 1;
    int* kout = last ? nullptr : sk + (p & 1) * n_long;
    int* vout = last ? a.order : sk + (2 + (p & 1)) * n_long;
    radix_pass(okin, ovin, n_long, chunk, p * kOrderBits, kOrderBits, p == 0 ? maxlen[0] : 0, 0,
               kout, vout, hist, tot, tab, red);
    if (last) break;
    grid_sync();
    okin = kout;
    ovin = vout;
  }
}

// the shared memory a block takes, and when local its data
long long smem_bytes(int M, bool local) {
  long long ints = kSmemInts;
  if (local) ints += 3LL * M + 2LL * (M / (kShortMax + 1) + 1) + kBlk;
  return ints * 4;
}

}  // namespace

// keys (M) int32 in [0, size); buf: buf_ints int32, the plan and its
// scratch one after the other: perm (M), starts (M + 1), slots (M), order
// (M), counts (4), then the sorted keys (M), the long runs and their
// lengths (M / (kShortMax + 1) + 1 each), the histogram (kMaxDigits x
// blocks), the digit totals (kMaxDigits) and kBlk values a block. The
// grid: blocks of chunk positions (a multiple of kThreads), (blocks - 1) *
// chunk < M <= blocks * chunk, blocks at most one an SM. The sort:
// passes of dbits bits (at most kMaxDigitBits) that cover the bits of
// size - 1.
extern "C" int alink_run_plan(const void* keys, int M, int size, int chunk, int blocks, int passes,
                              int dbits, void* buf, long long buf_ints, void* stream) {
  const int bits = size > 1 ? 32 - __builtin_clz(static_cast<unsigned>(size - 1)) : 0;
  const long long cap = M / (kShortMax + 1) + 1;
  const long long need = 5LL * M + 5 + 2 * cap + static_cast<long long>(kMaxDigits + kBlk) * blocks +
                         kMaxDigits;
  if (M <= 0 || size <= 0 || chunk <= 0 || chunk % kThreads || blocks <= 0 ||
      static_cast<long long>(blocks - 1) * chunk >= M ||
      static_cast<long long>(blocks) * chunk < M || passes < 1 || dbits < 1 ||
      dbits > kMaxDigitBits || passes * dbits < bits || buf_ints < need)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the most dynamic shared memory a block may take (the opt-in maximum
  // less the kernel's static shared memory), set once a device
  static int optin[kMaxDevices];
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!optin[dev]) {
    int bytes = 0;
    cudaFuncAttributes fa;
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, run_plan_kernel);
    if (err == cudaSuccess) {
      bytes -= static_cast<int>(fa.sharedSizeBytes);
      err = cudaFuncSetAttribute(run_plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    optin[dev] = bytes;
  }
  Args a;
  int* p = static_cast<int*>(buf);
  a.keys = static_cast<const int*>(keys);
  a.M = M;
  a.size = size;
  a.chunk = chunk;
  a.passes = passes;
  a.dbits = dbits;
  a.local = blocks == 1 && smem_bytes(M, true) <= optin[dev];
  a.perm = p;
  a.starts = a.perm + M;
  a.slots = a.starts + M + 1;
  a.order = a.slots + M;
  a.counts = a.order + M;
  a.sk = a.counts + 4;
  a.lng = a.sk + M;
  a.llen = a.lng + cap;
  a.hist = a.llen + cap;
  a.tot = a.hist + static_cast<long long>(kMaxDigits) * blocks;
  a.blk = a.tot + kMaxDigits;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(run_plan_kernel), blocks, kThreads,
                                    args, static_cast<size_t>(smem_bytes(M, a.local)),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* alink_run_plan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
