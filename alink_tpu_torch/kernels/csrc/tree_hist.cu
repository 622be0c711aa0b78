// The level histogram of tree growing, for Hopper (sm_90a).
//
// What it replaces:
//   alink_tree_hist (four passes) <- alink_tpu/operator/common/tree/hist.py::_pallas_level_hist
//
// Contract:
//   out[node, f, bin, c] = sum of stats[i, c] over the rows i with
//   node_id[i] == node and binned[i, f] == bin, each (node, f, bin, c) slot
//   adding its rows in ASCENDING ROW ORDER from +0.0, one rounded float add
//   each (__fadd_rn). That is the order the JAX package's CPU default (an
//   XLA scatter-add) sums in, bitwise. Every output slot is written exactly
//   once, by one thread, and no float is ever added by an atomic, so a run
//   on the card is reproducible bit for bit. Rows whose stats are zero add
//   nothing (an accumulator that starts at +0.0 never turns -0.0 under
//   round to nearest), which is how padding and bagging stay inert. A bin
//   outside [0, n_bins) or a node outside [0, n_nodes) fails a device-side
//   assert, as PyTorch's own CUDA indexing does; the clamp behind it only
//   keeps a build without asserts (NDEBUG) in bounds.
//
// What bounds it: bytes. At the main path's deepest level (48,842 rows,
// 14 features, 32 nodes x 64 bins, 3 stats) the function must read the
// keys, node ids and stats and write the histogram, about 3.9 MB: 1.15 us
// at the card's 3.35 TB/s. Past that, the longest slot's chain of
// dependent adds is a floor no order-keeping design can cut (a bin of an
// integer-code column holds about 4,000 rows at the first level).
//
// Design: a stable counting sort of each feature's rows by the key
// q = node * n_bins + bin (Q = n_nodes * n_bins keys), then one ordered walk
// per slot. The passes read each row's key three times in all, so a level
// costs O(n * F) row visits where one thread per bucket scanning every row
// would cost O(n * F * Q / 128). The four passes go on the caller's stream
// in order:
//   1. count  - grid (row tile, feature, key chunk), 8 warps a block: the
//               block counts its tile's keys into shared-memory int counters
//               (integer atomics: a count is exact whatever the order) and
//               writes counts[f, q, tile], q major.
//   2. scan   - one block per feature: an exclusive scan over (q, tile)
//               turns the counts into each (q, tile)'s first position in
//               the feature's sorted order; offs[f, q, 0] is slot q's start.
//   3. place  - same grid, W warps a block (8, or fewer when W tables of Q
//               ints would pass 192 KB): warp w takes the w-th R / W rows of
//               the tile and counts them into its own table; the tables turn
//               into cursors (the tile's offset plus the earlier warps'
//               counts), and each warp walks its rows in 32-row steps in row
//               order. __match_any_sync groups a step's lanes by key, a
//               lane's rank is __popc(peers & lanemask_lt), and the group's
//               lowest lane moves the key's cursor. So each row id lands at
//               its STABLE position: no atomic decides a position.
//   4. walk   - one warp per (f, q) slot, stats in chunks of 4 columns:
//               the warp gathers the run's stats 128 rows at a time into
//               shared memory, one column a row of it, the next batch's
//               loads in flight while lanes 0..3 add the current one in row
//               order, each reading its column four floats at a time;
//               written once, +0.0 for an empty slot.
// Tile rows R are a power of two, at least 1024, at least 2 * Q and at
// least n / 32, so the counts table (F * Q * ceil(n / R) ints) is at most
// half the keys' bytes plus one int per (feature, key), and the scan of a
// feature takes at most 32 tiles a key. A block holds at most kKeyChunk
// keys' counters (64 KB, opted in above 48 KB); a larger Q splits the keys
// into chunks, each block counting and placing only its chunk's rows.
// binned is read through its strides, so the caller may keep a column-major
// (F, n) copy and pass its transpose (each warp then reads one contiguous
// column), and a stride of 0 serves the leaf histogram's all-zero column.
//
// Interface: plain C, loaded with ctypes. The caller allocates the scratch
// (counts: F * Q * tiles int32, perm: F * n int32) and the output; a call
// allocates nothing and returns the first launch error, or 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cassert>

namespace {

constexpr int kWarp = 32;
constexpr int kMinTileRows = 1024;
constexpr int kMaxTiles = 32;           // row tiles per feature, at most
constexpr int kKeyChunk = 16384;        // keys a block counts or places
constexpr int kUnroll = 8;              // 32-row steps whose keys load together
constexpr int kBatch = kUnroll * kWarp;
constexpr int kCountWarps = 8;
constexpr int kPlaceWarps = 8;          // at most; fewer when Q is large
constexpr size_t kPlaceSmem = 192 * 1024;
constexpr int kScanThreads = 1024;
constexpr int kScanPerThread = 8;
constexpr int kWalkWarps = 4;
constexpr int kWalkBatch = 128;         // rows a walking warp stages at a time
constexpr int kWalkMC = 4;              // stat columns a walking warp adds
constexpr size_t kDefaultSmem = 48 * 1024;

struct Keys {
  const int32_t* binned;
  long long sr, sf;
  const int32_t* node_id;
  int n_nodes, n_bins;

  __device__ __forceinline__ int operator()(long long row, int f) const {
    const int b = binned[row * sr + f * sf];
    const int nd = node_id[row];
    assert(b >= 0 && b < n_bins && nd >= 0 && nd < n_nodes);
    return min(max(nd, 0), n_nodes - 1) * n_bins + min(max(b, 0), n_bins - 1);
  }
};

// the keys of rows base + 32 * u + lane, u < kUnroll, relative to the block's
// key chunk [k0, k0 + kq); -1 at or past end, or outside the chunk
__device__ __forceinline__ void load_keys(const Keys& keys, int f, long long base,
                                          long long end, int k0, int kq, int lane,
                                          int (&q)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long row = base + u * kWarp + lane;
    int k = -1;
    if (row < end) {
      k = keys(row, f) - k0;
      if (k < 0 || k >= kq) k = -1;
    }
    q[u] = k;
  }
}

// counts[f, q, tile] for the keys of one key chunk, all warps of the block
// counting the tile's rows into one table
__global__ void __launch_bounds__(kCountWarps * kWarp)
hist_count_kernel(Keys keys, int* __restrict__ counts, int n, int Q, int R, int T) {
  extern __shared__ int h[];
  const int tile = blockIdx.x, f = blockIdx.y;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int k0 = blockIdx.z * kKeyChunk;
  const int kq = min(kKeyChunk, Q - k0);
  for (int k = threadIdx.x; k < kq; k += blockDim.x) h[k] = 0;
  __syncthreads();
  const long long r0 = static_cast<long long>(tile) * R;
  const long long r1 = min(static_cast<long long>(n), r0 + R);
  for (long long base = r0 + warp * kBatch; base < r1; base += kCountWarps * kBatch) {
    int q[kUnroll];
    load_keys(keys, f, base, r1, k0, kq, lane, q);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (q[u] >= 0) atomicAdd(&h[q[u]], 1);
  }
  __syncthreads();
  int* dst = counts + (static_cast<long long>(f) * Q + k0) * T + tile;
  for (int k = threadIdx.x; k < kq; k += blockDim.x) dst[static_cast<long long>(k) * T] = h[k];
}

// exclusive scan of counts[f, 0:L] in place, one block per feature; the
// next chunk's loads are in flight while this one is scanned
__global__ void __launch_bounds__(kScanThreads)
hist_scan_kernel(int* __restrict__ counts, long long L) {
  constexpr int kChunk = kScanThreads * kScanPerThread;
  __shared__ int s[kChunk];
  __shared__ int wsum[kScanThreads / kWarp];
  int* c = counts + static_cast<long long>(blockIdx.x) * L;
  const int t = threadIdx.x, lane = t % kWarp, warp = t / kWarp;
  int nxt[kScanPerThread];
#pragma unroll
  for (int j = 0; j < kScanPerThread; ++j) {
    const long long i = j * kScanThreads + t;
    nxt[j] = i < L ? c[i] : 0;
  }
  int carry = 0;
  for (long long base = 0; base < L; base += kChunk) {
#pragma unroll
    for (int j = 0; j < kScanPerThread; ++j) s[j * kScanThreads + t] = nxt[j];
#pragma unroll
    for (int j = 0; j < kScanPerThread; ++j) {
      const long long i = base + kChunk + j * kScanThreads + t;
      nxt[j] = i < L ? c[i] : 0;
    }
    __syncthreads();
    int v[kScanPerThread];
    int run = 0;
#pragma unroll
    for (int j = 0; j < kScanPerThread; ++j) {
      v[j] = run;
      run += s[t * kScanPerThread + j];
    }
    int incl = run;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == kWarp - 1) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = wsum[lane];
#pragma unroll
      for (int d = 1; d < kWarp; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      wsum[lane] = w;
    }
    __syncthreads();
    const int before = carry + (warp ? wsum[warp - 1] : 0) + incl - run;
#pragma unroll
    for (int j = 0; j < kScanPerThread; ++j) s[t * kScanPerThread + j] = before + v[j];
    carry += wsum[kScanThreads / kWarp - 1];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kScanPerThread; ++j) {
      const long long i = base + j * kScanThreads + t;
      if (i < L) c[i] = s[j * kScanThreads + t];
    }
    __syncthreads();
  }
}

// perm[f, pos] = row at each row's stable position. Warp w of the block's
// W takes the w-th R / W rows of the tile: it counts them by key into its
// own table, the tables turn into cursors (the tile's offset plus the
// counts of the warps before), and the warp walks its rows in order.
__global__ void __launch_bounds__(kPlaceWarps * kWarp)
hist_place_kernel(Keys keys, const int* __restrict__ offs, int* __restrict__ perm, int n,
                  int Q, int R, int T) {
  extern __shared__ int h[];
  const int tile = blockIdx.x, f = blockIdx.y;
  const int W = blockDim.x / kWarp;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int k0 = blockIdx.z * kKeyChunk;
  const int kq = min(kKeyChunk, Q - k0);
  for (int k = threadIdx.x; k < W * kq; k += blockDim.x) h[k] = 0;
  __syncthreads();
  const long long r1 = min(static_cast<long long>(n), static_cast<long long>(tile + 1) * R);
  const long long s0 = static_cast<long long>(tile) * R + static_cast<long long>(warp) * (R / W);
  const long long s1 = min(r1, s0 + R / W);
  int* cur = h + warp * kq;
  for (long long base = s0; base < s1; base += kBatch) {
    int q[kUnroll];
    load_keys(keys, f, base, s1, k0, kq, lane, q);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (q[u] >= 0) atomicAdd(&cur[q[u]], 1);
  }
  __syncthreads();
  const int* src = offs + (static_cast<long long>(f) * Q + k0) * T + tile;
  for (int k = threadIdx.x; k < kq; k += blockDim.x) {
    int c = src[static_cast<long long>(k) * T];
    for (int w = 0; w < W; ++w) {
      const int cnt = h[w * kq + k];
      h[w * kq + k] = c;
      c += cnt;
    }
  }
  __syncthreads();
  const unsigned lt = (1u << lane) - 1u;
  int* dst = perm + static_cast<long long>(f) * n;
  int q[kUnroll], qn[kUnroll];
  load_keys(keys, f, s0, s1, k0, kq, lane, q);
  for (long long base = s0; base < s1; base += kBatch) {
    load_keys(keys, f, base + kBatch, s1, k0, kq, lane, qn);  // in flight
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned peers = __match_any_sync(0xffffffffu, q[u]);
      const int rank = __popc(peers & lt);
      const int pos = q[u] >= 0 ? cur[q[u]] + rank : 0;
      __syncwarp();
      if (q[u] >= 0 && rank == 0) cur[q[u]] = pos + __popc(peers);
      __syncwarp();
      if (q[u] >= 0) dst[pos] = static_cast<int>(base + u * kWarp + lane);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) q[u] = qn[u];
  }
}

// out[node, f, bin, c0:c0+4] from the run of slot (f, q) in perm[f]. The
// batch is staged column by column, so a chain lane reads its column four
// floats at a time
__global__ void __launch_bounds__(kWalkWarps * kWarp)
hist_walk_kernel(const int* __restrict__ offs, const int* __restrict__ perm,
                 const float* __restrict__ stats, int m, float* __restrict__ out, int n, int F,
                 int Q, int T, int n_bins) {
  __shared__ __align__(16) float buf[kWalkWarps][kWalkMC][kWalkBatch];
  constexpr int kPer = kWalkBatch / kWarp;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long slot = static_cast<long long>(blockIdx.x) * kWalkWarps + warp;
  if (slot >= static_cast<long long>(F) * Q) return;
  const int f = static_cast<int>(slot / Q);
  const int q = static_cast<int>(slot - static_cast<long long>(f) * Q);
  const int c0 = blockIdx.y * kWalkMC;
  const int mc = min(kWalkMC, m - c0);
  const long long start = offs[slot * T];
  const long long end = q + 1 < Q ? offs[(slot + 1) * T] : n;
  const int* p = perm + static_cast<long long>(f) * n;

  int ids[kPer];
  float v[kPer][kWalkMC];
  auto load_ids = [&](long long b0) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const long long r = b0 + u * kWarp + lane;
      ids[u] = r < end ? p[r] : -1;
    }
  };
  auto gather = [&]() {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const float* s = stats + static_cast<long long>(ids[u]) * m + c0;
#pragma unroll
      for (int c = 0; c < kWalkMC; ++c) v[u][c] = (ids[u] >= 0 && c < mc) ? s[c] : 0.0f;
    }
  };
  float acc = 0.0f;
  const float* col = buf[warp][lane < kWalkMC ? lane : 0];
  load_ids(start);
  gather();
  load_ids(start + kWalkBatch);
  for (long long b0 = start; b0 < end; b0 += kWalkBatch) {
    __syncwarp();  // the previous batch is added
#pragma unroll
    for (int u = 0; u < kPer; ++u)
#pragma unroll
      for (int c = 0; c < kWalkMC; ++c) buf[warp][c][u * kWarp + lane] = v[u][c];
    __syncwarp();
    gather();                           // the next batch, in flight
    load_ids(b0 + 2 * kWalkBatch);      // the one after
    if (lane < mc) {
      if (end - b0 >= kWalkBatch) {
        const float4* col4 = reinterpret_cast<const float4*>(col);
#pragma unroll
        for (int g = 0; g < kWalkBatch / 4; ++g) {
          const float4 x = col4[g];
          acc = __fadd_rn(acc, x.x);
          acc = __fadd_rn(acc, x.y);
          acc = __fadd_rn(acc, x.z);
          acc = __fadd_rn(acc, x.w);
        }
      } else {
        const int rows = static_cast<int>(end - b0);
        for (int j = 0; j < rows; ++j) acc = __fadd_rn(acc, col[j]);
      }
    }
  }
  if (lane < mc) {
    const int node = q / n_bins;
    const int bin = q - node * n_bins;
    out[((static_cast<long long>(node) * F + f) * n_bins + bin) * m + c0 + lane] = acc;
  }
}

int opt_in(const void* fn, size_t smem) {
  if (smem <= kDefaultSmem) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

}  // namespace

// binned: int32, element (i, f) at binned[i * sr + f * sf]; stats: (n, m)
// float32 row-major; node_id: (n,) int32; out: (n_nodes, F, n_bins, m)
// float32, every element written. tile_rows and tiles are the caller's plan
// (tile_rows the least power of two >= 1024, >= 2 * Q and >= n / 32;
// tiles = max(1, ceil(n / tile_rows))); counts: F * Q * tiles int32 and
// perm: F * n int32 scratch.
extern "C" int alink_tree_hist(const void* binned, long long sr, long long sf,
                               const void* stats, int m, const void* node_id, void* out,
                               int n, int F, int n_nodes, int n_bins, int tile_rows,
                               int tiles, void* counts, void* perm, void* stream) {
  if (n < 0 || F <= 0 || F > 65535 || m <= 0 || n_nodes <= 0 || n_bins <= 0 || sr < 0 ||
      sf < 0 || tile_rows < kMinTileRows || (tile_rows & (tile_rows - 1)) != 0 ||
      tiles <= 0 || tiles > kMaxTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long Q = static_cast<long long>(n_nodes) * n_bins;
  const long long chunks = (Q + kKeyChunk - 1) / kKeyChunk;
  if (Q >= (1LL << 30) || tile_rows < 2 * Q || chunks > 65535 ||
      F * Q / kWalkWarps >= (1LL << 31) || (m + kWalkMC - 1) / kWalkMC > 65535 ||
      static_cast<long long>(tiles) * tile_rows < n ||
      static_cast<long long>(tiles - 1) * tile_rows >= (n > 0 ? n : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Keys keys{static_cast<const int32_t*>(binned), sr, sf,
                  static_cast<const int32_t*>(node_id), n_nodes, n_bins};
  int* cnt = static_cast<int*>(counts);
  int* pm = static_cast<int*>(perm);
  const int q = static_cast<int>(Q);
  const size_t table = static_cast<size_t>(Q < kKeyChunk ? Q : kKeyChunk) * sizeof(int);
  int place_warps = kPlaceWarps;
  while (place_warps > 1 && place_warps * table > kPlaceSmem) place_warps /= 2;
  int rc = opt_in(reinterpret_cast<const void*>(hist_count_kernel), table);
  if (rc == 0)
    rc = opt_in(reinterpret_cast<const void*>(hist_place_kernel), place_warps * table);
  if (rc != 0) return rc;

  const dim3 grid(tiles, F, static_cast<unsigned>(chunks));
  hist_count_kernel<<<grid, kCountWarps * kWarp, table, s>>>(keys, cnt, n, q, tile_rows,
                                                             tiles);
  if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  hist_scan_kernel<<<F, kScanThreads, 0, s>>>(cnt, Q * tiles);
  if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  hist_place_kernel<<<grid, place_warps * kWarp, place_warps * table, s>>>(
      keys, cnt, pm, n, q, tile_rows, tiles);
  if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  const long long slots = static_cast<long long>(F) * Q;
  const dim3 wgrid(static_cast<unsigned>((slots + kWalkWarps - 1) / kWalkWarps),
                   (m + kWalkMC - 1) / kWalkMC);
  hist_walk_kernel<<<wgrid, kWalkWarps * kWarp, 0, s>>>(
      cnt, pm, static_cast<const float*>(stats), m, static_cast<float*>(out), n, F, q, tiles,
      n_bins);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* alink_tree_hist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
