// The level histogram of tree growing, for Hopper (sm_90a).
//
// What it replaces:
//   tree_hist_kernel <- alink_tpu/operator/common/tree/hist.py::_pallas_level_hist
//
// Contract:
//   out[node, f, bin, c] = sum of stats[i, c] over the rows i with
//   node_id[i] == node and binned[i, f] == bin, each (node, f, bin, c) slot
//   adding its rows in ASCENDING ROW ORDER from +0.0, one rounded float add
//   each (__fadd_rn). That is the order the JAX package's CPU default (an
//   XLA scatter-add) sums in, bitwise. Every output slot is written exactly
//   once, by one thread, so the order is fixed by construction: no atomics,
//   and a run on the card is reproducible bit for bit. Rows whose stats are
//   zero add nothing (an accumulator that starts at +0.0 never turns -0.0
//   under round to nearest), which is how padding and bagging stay inert.
//   A bin outside [0, n_bins) or a node outside [0, n_nodes) fails a
//   device-side assert, as PyTorch's own CUDA indexing does; the clamp
//   behind it only keeps a build without asserts (NDEBUG) in bounds.
//
// What bounds it: at the main path's deepest level (48,842 rows, 14
// features, 32 nodes x 64 bins, 3 stats) it must move about 3.9 MB, about
// 1.2 us at the card's memory rate. This simple design is bound by neither:
// every thread scans every row of its feature, so a launch costs about n
// shared-memory reads per thread, O(n * Q / 128) row visits per feature,
// where Q = n_nodes * n_bins buckets. That is fine at depth 6; a sorted or
// partitioned design is for a later change.
//
// Design:
//   grid (feature, bucket tile, stat chunk). A bucket is q = node * n_bins
//   + bin. Each thread owns one bucket of its tile and keeps its sums in
//   registers. The block walks ALL rows in chunks of kChunk: it stages
//   each row's q (or -1 past the end) and the chunk's stats in shared
//   memory, then every thread scans the chunk in row order, four q at a
//   time, and adds the rows whose q is its bucket.
//   Stats go MC columns per block (MC = 3 for GBDT and variance, 4
//   otherwise, the last chunk of a wider m masked).
//   binned is read through its strides, so the caller may keep a
//   column-major (F, n) copy and pass its transpose: each block then reads
//   one contiguous column. A stride of 0 serves the leaf histogram's
//   all-zero column without materializing it.
//
// Interface: plain C, loaded with ctypes. A launch goes on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <cassert>

namespace {

constexpr int kThreads = 128;  // one bucket per thread: a tile of 128 buckets
constexpr int kChunk = 2048;
constexpr int kRowsPerThread = kChunk / kThreads;

template <int MC>
__global__ void __launch_bounds__(kThreads)
tree_hist_kernel(const int32_t* __restrict__ binned, long long sr, long long sf,
                 const float* __restrict__ stats, int m,
                 const int32_t* __restrict__ node_id, float* __restrict__ out,
                 int n, int F, int n_nodes, int n_bins) {
  __shared__ __align__(16) int32_t sq[kChunk];
  __shared__ float ss[kChunk * MC];
  const int f = blockIdx.x;
  const int c0 = blockIdx.z * MC;
  const int mc = min(MC, m - c0);
  const int Q = n_nodes * n_bins;
  const int my_q = blockIdx.y * kThreads + threadIdx.x;
  float acc[MC];
#pragma unroll
  for (int c = 0; c < MC; ++c) acc[c] = 0.0f;

  for (int r0 = 0; r0 < n; r0 += kChunk) {
    const int rows = min(kChunk, n - r0);
    __syncthreads();  // the previous chunk is consumed
    // stage q = node * n_bins + bin of each row (-1 past the end): all
    // loads first, so they are in flight together
    int bv[kRowsPerThread], nv[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int i = k * kThreads + threadIdx.x;
      const long long row = r0 + i;
      bv[k] = i < rows ? binned[row * sr + f * sf] : 0;
      nv[k] = i < rows ? node_id[row] : 0;
    }
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int i = k * kThreads + threadIdx.x;
      int q = -1;
      if (i < rows) {
        assert(bv[k] >= 0 && bv[k] < n_bins && nv[k] >= 0 && nv[k] < n_nodes);
        q = min(max(nv[k], 0), n_nodes - 1) * n_bins + min(max(bv[k], 0), n_bins - 1);
      }
      sq[i] = q;
    }
    // stage the chunk's stats, MC columns from c0
#pragma unroll 8
    for (int k = 0; k < kRowsPerThread * MC; ++k) {
      const int j = k * kThreads + threadIdx.x;
      if (j < rows * MC) {
        const int i = j / MC;
        const int c = j - i * MC;
        ss[j] = c < mc ? stats[static_cast<size_t>(r0 + i) * m + c0 + c] : 0.0f;
      }
    }
    __syncthreads();
    if (my_q >= Q) continue;
    // scan the chunk in row order, four q at a time
    const int4* sq4 = reinterpret_cast<const int4*>(sq);
    const int groups = (rows + 3) / 4;
    for (int g = 0; g < groups; ++g) {
      const int4 qq = sq4[g];
      const int qs[4] = {qq.x, qq.y, qq.z, qq.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (qs[u] == my_q) {
          const float* s = ss + (4 * g + u) * MC;
#pragma unroll
          for (int c = 0; c < MC; ++c) acc[c] = __fadd_rn(acc[c], s[c]);
        }
      }
    }
  }

  if (my_q < Q) {
    const int node = my_q / n_bins;
    const int bin = my_q - node * n_bins;
    float* dst = out + ((static_cast<size_t>(node) * F + f) * n_bins + bin) * m + c0;
#pragma unroll
    for (int c = 0; c < MC; ++c)
      if (c < mc) dst[c] = acc[c];
  }
}

}  // namespace

// binned: int32, element (i, f) at binned[i * sr + f * sf]; stats: (n, m)
// float32 row-major; node_id: (n,) int32; out: (n_nodes, F, n_bins, m)
// float32, every element written.
extern "C" int alink_tree_hist(const void* binned, long long sr, long long sf,
                               const void* stats, int m, const void* node_id, void* out,
                               int n, int F, int n_nodes, int n_bins, void* stream) {
  if (n < 0 || F <= 0 || m <= 0 || n_nodes <= 0 || n_bins <= 0 || sr < 0 || sf < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long Q = static_cast<long long>(n_nodes) * n_bins;
  const long long tiles = (Q + kThreads - 1) / kThreads;
  if (Q >= (1LL << 31) || tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* b = static_cast<const int32_t*>(binned);
  const float* st = static_cast<const float*>(stats);
  const int32_t* nid = static_cast<const int32_t*>(node_id);
  float* o = static_cast<float*>(out);
  if (m == 3) {
    const dim3 grid(F, static_cast<unsigned>(tiles), 1);
    tree_hist_kernel<3><<<grid, kThreads, 0, s>>>(b, sr, sf, st, m, nid, o, n, F, n_nodes,
                                                  n_bins);
  } else {
    const dim3 grid(F, static_cast<unsigned>(tiles), (m + 3) / 4);
    tree_hist_kernel<4><<<grid, kThreads, 0, s>>>(b, sr, sf, st, m, nid, o, n, F, n_nodes,
                                                  n_bins);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* alink_tree_hist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
