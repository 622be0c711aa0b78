// FTRL state kernels for Hopper (sm_90a): the state gather, the
// deterministic scatter-add and the walk of one chunk of the strict sparse
// online FTRL steps.
//
// What they replace:
//   ftrl_gather_kernel       <- alink_tpu/kernels/ftrl.py::_gather_call
//                               (gather_rows; and gather_pair, the same
//                               gather of z and n in one launch)
//   ftrl_scatter_add_kernel  <- alink_tpu/kernels/ftrl.py::_scatter_call
//                               (scatter_add_rows)
//   ftrl_walk_kernel         <- alink_tpu/kernels/ftrl.py::chained_corr and
//                               the per-sample loop of the strict steps
//                               around it (alink_tpu/operator/stream/
//                               onlinelearning/ftrl.py, the sparse and the
//                               chained step factories)
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
//   walk        kernels/ftrl.py::walk_chunk_plain, bitwise on the card: for
//               k = 0..K-1 in order, sample k's z and n at its slots
//               corrected by the deltas of samples j < k at the same slot,
//               w from the FTRL-proximal closed form, the margin as the
//               pairwise tree of x * w (tree_sum), the clipped sigmoid, g,
//               g^2, sigma and the deltas (g - sigma w, g^2). The
//               correction in one of two associations:
//                 chained  sum_{j<k} sum_b M[k, j, a, b] * D[j, b, c], one
//                          chain per output in the order j, then b, from
//                          +0.0, every product rounded on its own, then
//                          base + chain. Products that are exact zeros (a
//                          slot that does not match, a finite delta) leave
//                          a chain from +0.0 as it is and are skipped; 0 *
//                          inf and 0 * NaN are NaN and reach it.
//                 sample   for j = 0..k-1 in order, the in-order sum from
//                          +0.0 of sample j's deltas at the slot (a
//                          selection: a NaN delta elsewhere does not leak)
//                          added to the running value.
//               Every op rounds as PyTorch rounds it on the card: the
//               division by the Python float alpha is a multiply by its
//               reciprocal (rounded in T on the host), 1 / t is
//               reciprocal(t), exp and sqrt are CUDA's (expf, exp,
//               correctly rounded sqrt), the hyperparameters become T
//               before any arithmetic.
// Built with --fmad=false as well, so nothing else contracts either.
//
// What bounds them: the launch, and for the walk its dependent chain. At
// the shapes of the FTRL steps (M = 160 to 1280 touched slots of a 2^20
// state, K = 4 or 16 rows of width 40 a chunk) each kernel moves a few
// kilobytes to a few hundred kilobytes, microseconds or less at the card's
// memory rate, so a launch's fixed cost dominates. For the gather it is
// all there is: its body runs at the launch floor, and what a call costs
// is the host's issue of it (the wrapper's checks, the allocation of the
// output, the ctypes call), which the design below and kernels/ftrl.py
// keep short; the pair form issues one launch where stacking two gathers
// issued three. The state itself is touched only at the M named slots; the
// rest of the 2^20 slots are never read. Past the launch, the scatter-add's
// time goes to its sort (a few passes over M positions on one SM) and to
// its longest run of one slot, a chain of dependent adds. The walk is a
// chain through every sample of the chunk (each Criteo row holds the
// intercept, so each sample reads the one before it): per sample the
// correction, the weights (sqrt, divide), the margin's tree, exp and the
// reciprocal, the deltas, one after the other.
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
//   walk     - ONE block a chunk (chunks depend on each other through the
//              state, so one launch walks one), of any K * w the scatter-add
//              takes. Eight warps set it up: the chunk's slots, values,
//              labels and gathered state into shared memory (past the 227
//              KB a block can opt in to, into a global-memory scratch the
//              caller sizes with alink_ftrl_walk_spill), the positions
//              sorted by a hash bucket of their slot
//              (a counting sort: atomic counts, a block scan, placement),
//              then, by a scan of its bucket's contiguous run (none for a
//              slot alone in its bucket; eight entries a step, no branch),
//              each position's previous
//              occurrence of its slot, the last one in an earlier row and
//              how many come before it in its own row. No (K, K, w, w)
//              collision tensor exists and no product with a zero is
//              formed. Then warp 0 walks the samples, lane l holding the
//              row's positions l, l + 32, ... (R a lane, R = 1, 2, 4 or 8
//              for w up to 256), with no branch between a lane's R chains
//              (a position past the row computes on the row's last one and
//              is masked). Wider rows, and a chunk in the scratch, take the
//              wide form: the row in pieces of 256 positions, what a
//              position needs after the margin kept in memory. (A direct
//              scan of the earlier slots in place of the sort was slower
//              at every shape measured.) A position's correction is ONE
//              read: every occurrence of a slot keeps the running value its
//              successors need (chained: the chain over the slot's
//              occurrences so far; sample: the row's partial and the
//              corrected value after the row), so only the adds the
//              contract orders are made, each by the lane that owns the
//              occurrence, right after its delta, from the value its
//              correction read. Repeats of a slot inside a row are recorded
//              in their order, one level a repeat. The margin's tree adds
//              the lane's registers, then the lanes' butterfly
//              (__shfl_xor_sync), which leaves the sum in every lane;
//              chained, a per-row count of non-finite deltas (a ballot)
//              beside each occurrence's own count says whether a 0 * inf
//              or 0 * NaN reached the chain.
// An index outside [0, S) fails a device-side assert, as PyTorch's own
// CUDA indexing does: the launch's stream then reports cudaErrorAssert at
// its next synchronize, where the plain version raises IndexError at once.
// The clamp behind the assert only keeps a build without asserts (NDEBUG)
// inside the state. The walk never indexes the state by slot: it compares
// slots only.
//
// Interface: plain C, loaded with ctypes. A launch goes on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <cassert>

namespace {

constexpr int kGatherThreads = 256;
constexpr int kScatterThreads = 1024;
constexpr int kWalkThreads = 256;  // eight warps set a chunk up, warp 0 walks it
// the scatter block sorts with 12 bytes a position plus 8 KB of digit
// tables, then reuses that memory for the sorted updates and a bitmap of run
// heads (at most 11264 * 16 + 1540 bytes), inside the 227 KB a block can opt
// in to
constexpr int kScatterMaxM = 11264;
constexpr int kScatterPerThread = 11;  // sorted positions a thread holds: 11264 / 1024
constexpr int kSortWarps = 8;          // the warps that sort, one digit table each
constexpr size_t kDefaultSmem = 48 * 1024;
// a walk's chunk: as many positions (K * w) as the scatter-add takes, in
// shared memory up to the 227 KB a block can opt in to (less the static
// 32 bytes of the block scan), else in global memory
constexpr int kWalkMaxP = kScatterMaxM;
constexpr size_t kWalkMaxSmem = 227 * 1024 - 64;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float rcp_rn(float a) { return __frcp_rn(a); }
__device__ __forceinline__ double rcp_rn(double a) { return __drcp_rn(a); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float exp_(float a) { return expf(a); }
__device__ __forceinline__ double exp_(double a) { return exp(a); }
__device__ __forceinline__ float clip35(float a) { return fminf(fmaxf(a, -35.0f), 35.0f); }
__device__ __forceinline__ double clip35(double a) { return fmin(fmax(a, -35.0), 35.0); }
template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() { return __int_as_float(0x7fffffff); }
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7fffffffffffffffll);
}

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

// The hyperparameters in T, 1 / alpha rounded as PyTorch rounds it
template <typename T>
struct WalkHp {
  T beta, l1, l2, inv_alpha;
};

// w from (z, n): kernels/ftrl.py::ftrl_weights, op by op
template <typename T>
__device__ __forceinline__ T ftrl_w(T z, T n, const WalkHp<T>& h) {
  const T decay = add_rn(mul_rn(add_rn(sqrt_rn(n), h.beta), h.inv_alpha), h.l2);
  const T sign = static_cast<T>((T(0) < z) - (z < T(0)));
  const T w = div_rn(-sub_rn(z, mul_rn(sign, h.l1)), decay);
  return fabs(z) <= h.l1 ? T(0) : w;
}

// the clipped logistic: 1 / (1 + exp(-clamp(m, -35, 35))), NaN kept
template <typename T>
__device__ __forceinline__ T sigmoid_rn(T m) {
  const T c = m != m ? m : clip35(m);
  return rcp_rn(add_rn(exp_(-c), T(1)));
}

__device__ __forceinline__ int slot_bucket(int s, int bits) {
  return static_cast<int>((static_cast<unsigned>(s) * 2654435761u) >> (32 - bits));
}

// a[0..n) := its exclusive prefix sums; every thread of the block calls it
__device__ void block_exclusive_scan(int* a, int n) {
  __shared__ int warp_total[kWalkThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int per = (n + kWalkThreads - 1) / kWalkThreads;
  const int lo = min(n, static_cast<int>(threadIdx.x) * per), hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int base = incl - sum;
  for (int v = 0; v < warp; ++v) base += warp_total[v];
  for (int i = lo; i < hi; ++i) {
    const int c = a[i];
    a[i] = base;
    base += c;
  }
}

// The walk's arrays, laid out from `base`: seven arrays of P = K * w T
// (values, z, n and four running values), K labels, then six arrays of P
// ints, 2^hbits + 1 bucket starts and K per-row repeat depths.
template <typename T>
struct WalkMem {
  T *xs, *z0, *n0, *ra, *rb, *rc, *rd, *ys;
  int *slot, *place, *prev, *lastb, *dep, *nfc, *start, *rowdep;
};

inline int walk_hbits(int P) {
  int hbits = 1;  // buckets: a power of two, at least twice the positions
  while ((1 << hbits) < 2 * P) ++hbits;
  return hbits;
}

template <typename T>
size_t walk_bytes(int K, int w) {
  const size_t P = static_cast<size_t>(K) * w;
  return (7 * P + K) * sizeof(T) + (6 * P + (size_t(1) << walk_hbits(K * w)) + 1 + K) * sizeof(int);
}

template <typename T>
__device__ __forceinline__ WalkMem<T> walk_mem(unsigned char* base, int K, int w, int hbits) {
  const int P = K * w;
  WalkMem<T> m;
  m.xs = reinterpret_cast<T*>(base);
  m.z0 = m.xs + P;
  m.n0 = m.z0 + P;
  // running values of each occurrence. chained: ra/rb the chain of z's and
  // n's deltas over the slot's occurrences up to this one; sample: ra/rb
  // the partial of this row's occurrences up to this one, rc/rd the
  // corrected z and n after this row
  m.ra = m.n0 + P;
  m.rb = m.ra + P;
  m.rc = m.rb + P;
  m.rd = m.rc + P;
  m.ys = m.rd + P;
  m.slot = reinterpret_cast<int*>(m.ys + K);
  m.place = m.slot + P;  // the position's place among its bucket's
  m.prev = m.place + P;  // the slot's previous occurrence, or -1
  m.lastb = m.prev + P;  // its last occurrence in an earlier row, or -1
  m.dep = m.lastb + P;   // its occurrences before this one in this row
  m.nfc = m.dep + P;     // chained: non-finite deltas of z and n (<< 16) so
                         // far; first the positions sorted by bucket
  m.start = m.nfc + P;   // 2^hbits + 1 bucket starts
  m.rowdep = m.start + (1 << hbits) + 1;
  return m;
}

// The walk's setup, by the whole block: the chunk into the walk's arrays;
// each position counted in its slot's bucket; the positions sorted by
// bucket (a counting sort), so a position finds its slot's other
// occurrences in one contiguous run; then each position's links.
template <typename T>
__device__ void walk_links(const WalkMem<T>& m, const int32_t* __restrict__ xi,
                           const T* __restrict__ xv, const T* __restrict__ yy,
                           const T* __restrict__ zn, int K, int w, int hbits) {
  const int P = K * w, H = 1 << hbits, tid = threadIdx.x;
#pragma unroll 4
  for (int p = tid; p < P; p += kWalkThreads) {
    m.slot[p] = xi[p];
    m.xs[p] = xv[p];
    m.z0[p] = zn[2 * p];
    m.n0[p] = zn[2 * p + 1];
  }
  for (int h = tid; h <= H; h += kWalkThreads) m.start[h] = 0;
  for (int k = tid; k < K; k += kWalkThreads) {
    m.ys[k] = yy[k];
    m.rowdep[k] = 0;
  }
  __syncthreads();
  for (int p = tid; p < P; p += kWalkThreads)
    m.place[p] = atomicAdd(&m.start[slot_bucket(m.slot[p], hbits)], 1);
  __syncthreads();
  block_exclusive_scan(m.start, H + 1);
  __syncthreads();
  for (int p = tid; p < P; p += kWalkThreads)
    m.nfc[m.start[slot_bucket(m.slot[p], hbits)] + m.place[p]] = p;
  __syncthreads();
  for (int p = tid; p < P; p += kWalkThreads) {
    const int s = m.slot[p], row0 = p - p % w, b = slot_bucket(s, hbits);
    const int lo = m.start[b], hi = m.start[b + 1];
    int pv = -1, lb = -1, dp = 0;
    // the bucket's run, eight entries a step with no branch, so that their
    // loads overlap (a slot in every row, as the intercept, fills a run of K)
    for (int i0 = lo; hi - lo > 1 && i0 < hi; i0 += 8) {
      int q[8], sq[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) q[u] = i0 + u < hi ? m.nfc[i0 + u] : p;
#pragma unroll
      for (int u = 0; u < 8; ++u) sq[u] = m.slot[q[u]];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const bool before = q[u] < p && sq[u] == s;
        pv = before ? max(pv, q[u]) : pv;
        lb = before && q[u] < row0 ? max(lb, q[u]) : lb;
        dp += before && q[u] >= row0;
      }
    }
    m.prev[p] = pv;
    m.lastb[p] = lb;
    m.dep[p] = dp;
    if (dp) atomicMax(&m.rowdep[p / w], dp);
  }
  __syncthreads();
}

// One chunk of K rows of width w, R positions a lane: lane l takes the
// row's positions l, l + 32, ... In the narrow form (kWide false; w <= 32 R,
// and 32 R is the tree's width for w > 32) the chunk is in shared memory
// and a lane keeps its positions' values in registers through a sample. The
// wide form (R = 8) takes any w, and its arrays from `spill` (global memory)
// when the chunk does not fit in shared memory: the lanes walk the row in
// pieces of 256 positions, and what a position needs after the margin (its
// corrected z and n, its correction's base) and the terms of the margin's
// tree (in the row's part of d, before its deltas replace them) go to
// memory between the passes.
template <typename T, bool kChained, int R, bool kWide>
__global__ void __launch_bounds__(kWalkThreads)
ftrl_walk_kernel(const int32_t* __restrict__ xi, const T* __restrict__ xv,
                 const T* __restrict__ yy, const T* __restrict__ zn, T* __restrict__ margin,
                 T* __restrict__ d, int K, int w, int hbits, WalkHp<T> hp,
                 unsigned char* __restrict__ spill) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WalkMem<T> sm = walk_mem<T>(kWide && spill ? spill : smem, K, w, hbits);
  walk_links(sm, xi, xv, yy, zn, K, w, hbits);
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x, P = K * w;
  int width = 1;  // the tree's width: w padded with +0.0 to a power of two
  while (width < w) width <<= 1;
  const int pieces = kWide ? (w + 32 * R - 1) / (32 * R) : 1;
  int nf_z = 0, nf_n = 0;  // chained: non-finite deltas in the rows walked
  // narrow: a lane's positions past the row compute on the row's last
  // position and are masked, so that no branch keeps its R chains apart;
  // the next sample's links are read a sample ahead
  int lbn[R], dpn[R];
  if (!kWide) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      lbn[r] = sm.lastb[min(lane + 32 * r, w - 1)];
      dpn[r] = sm.dep[min(lane + 32 * r, w - 1)];
    }
  }
  for (int k = 0; k < K; ++k) {
    T x[R], z[R], n[R], wt[R], t[R], bz[R], bn[R], dz[R], dn[R];
    int nb[R], dp[R];
    const int depth = sm.rowdep[k];
    T* const tt = d + k * w;  // wide: the row's terms, then its deltas of z
    for (int pc = 0; pc < pieces; ++pc) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int a = pc * 32 * R + lane + 32 * r, p = k * w + min(a, w - 1);
        int lb;
        if (kWide) {
          lb = sm.lastb[p];
        } else {
          lb = lbn[r];
          dp[r] = dpn[r];
          if (k + 1 < K) {
            lbn[r] = sm.lastb[p + w];
            dpn[r] = sm.dep[p + w];
          }
        }
        const int q = max(lb, 0);
        T zc = sm.z0[p], nc = sm.n0[p];
        if (kChained) {
          bz[r] = lb >= 0 ? sm.ra[q] : T(0);
          bn[r] = lb >= 0 ? sm.rb[q] : T(0);
          nb[r] = lb >= 0 ? sm.nfc[q] : 0;
          // a non-finite delta at another slot: 0 * inf or 0 * NaN
          zc = add_rn(zc, nf_z > (nb[r] & 0xffff) ? quiet_nan<T>() : bz[r]);
          nc = add_rn(nc, nf_n > (nb[r] >> 16) ? quiet_nan<T>() : bn[r]);
        } else {
          // no earlier row holds the slot: the +0.0 partials of the rows
          // before (none for sample 0)
          const T zp = k > 0 ? add_rn(zc, T(0)) : zc, np = k > 0 ? add_rn(nc, T(0)) : nc;
          zc = lb >= 0 ? sm.rc[q] : zp;
          nc = lb >= 0 ? sm.rd[q] : np;
        }
        x[r] = sm.xs[p];
        z[r] = zc;
        n[r] = nc;
        wt[r] = ftrl_w(zc, nc, hp);
        t[r] = a < w ? mul_rn(x[r], wt[r]) : T(0);
        if (kWide && a < w) {
          // p's own row: no other position reads these before p's deltas
          sm.z0[p] = zc;
          sm.n0[p] = nc;
          tt[a] = t[r];
          if (kChained) {
            sm.ra[p] = bz[r];
            sm.rb[p] = bn[r];
            sm.nfc[p] = nb[r];
          }
        }
      }
    }
    // the margin: tree_sum's halves. Wide: the levels above a piece first,
    // in memory, each lane on its own positions (a level's halves are a
    // multiple of 32 apart); then across a lane's registers, then across
    // the lanes
    if (kWide) {
      for (int h = width / 2; h >= 32 * R; h /= 2)
        for (int i = lane; i < h; i += 32) tt[i] = add_rn(tt[i], i + h < w ? tt[i + h] : T(0));
#pragma unroll
      for (int r = 0; r < R; ++r) t[r] = lane + 32 * r < w ? tt[lane + 32 * r] : T(0);
    }
#pragma unroll
    for (int h = R / 2; h >= 1; h /= 2) {
      if (kWide && 32 * h >= width) continue;
#pragma unroll
      for (int r = 0; r < h; ++r) t[r] = add_rn(t[r], t[r + h]);
    }
    for (int h = min(width, 32) / 2; h >= 1; h /= 2)
      t[0] = add_rn(t[0], __shfl_xor_sync(0xffffffffu, t[0], h));
    const T mg = t[0];
    const T gy = sub_rn(sigmoid_rn(mg), sm.ys[k]);
    if (lane == 0) margin[k] = mg;
    for (int pc = 0; pc < pieces; ++pc) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int p = k * w + min(pc * 32 * R + lane + 32 * r, w - 1);
        if (kWide) {
          x[r] = sm.xs[p];
          z[r] = sm.z0[p];
          n[r] = sm.n0[p];
          wt[r] = ftrl_w(z[r], n[r], hp);
          dp[r] = sm.dep[p];
          if (kChained) {
            bz[r] = sm.ra[p];
            bn[r] = sm.rb[p];
            nb[r] = sm.nfc[p];
          }
        }
        const T g = mul_rn(gy, x[r]), gg = mul_rn(g, g);
        const T sigma = mul_rn(sub_rn(sqrt_rn(add_rn(n[r], gg)), sqrt_rn(n[r])), hp.inv_alpha);
        dz[r] = sub_rn(g, mul_rn(sigma, wt[r]));
        dn[r] = gg;
      }
      // each occurrence's running values. Level 0, no earlier occurrence
      // in the row: its previous occurrence is the one the correction read.
      // Repeats inside the row follow below, one level after the other.
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int a = pc * 32 * R + lane + 32 * r, p = k * w + a;
        if (a >= w) continue;
        d[p] = dz[r];
        d[P + p] = dn[r];
        if (dp[r]) continue;
        if (kChained) {
          sm.ra[p] = add_rn(bz[r], dz[r]);
          sm.rb[p] = add_rn(bn[r], dn[r]);
          sm.nfc[p] = nb[r] + !isfinite(dz[r]) + (static_cast<int>(!isfinite(dn[r])) << 16);
        } else {
          // the value before this row's partial (k = 0: after the +0.0
          // partial a later sample adds for this row's predecessors)
          const T pz = add_rn(T(0), dz[r]), pn = add_rn(T(0), dn[r]);
          sm.ra[p] = pz;
          sm.rb[p] = pn;
          sm.rc[p] = add_rn(k ? z[r] : add_rn(z[r], T(0)), pz);
          sm.rd[p] = add_rn(k ? n[r] : add_rn(n[r], T(0)), pn);
        }
      }
      if (kChained) {
        bool bad = false;
#pragma unroll
        for (int r = 0; r < R; ++r)
          bad |= pc * 32 * R + lane + 32 * r < w && !(isfinite(dz[r]) && isfinite(dn[r]));
        if (__any_sync(0xffffffffu, bad)) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const bool live = pc * 32 * R + lane + 32 * r < w;
            nf_z += __popc(__ballot_sync(0xffffffffu, live && !isfinite(dz[r])));
            nf_n += __popc(__ballot_sync(0xffffffffu, live && !isfinite(dn[r])));
          }
        }
      }
    }
    for (int level = 1; level <= depth; ++level) {
      __syncwarp();
      for (int pc = 0; pc < pieces; ++pc) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int a = pc * 32 * R + lane + 32 * r, p = k * w + a;
          if (a >= w || (kWide ? sm.dep[p] : dp[r]) != level) continue;
          const int pv = sm.prev[p];  // in this row, one level down
          const T ez = kWide ? d[p] : dz[r], en = kWide ? d[P + p] : dn[r];
          if (kChained) {
            sm.ra[p] = add_rn(sm.ra[pv], ez);
            sm.rb[p] = add_rn(sm.rb[pv], en);
            sm.nfc[p] = sm.nfc[pv] + !isfinite(ez) + (static_cast<int>(!isfinite(en)) << 16);
          } else {
            const T zr = kWide ? sm.z0[p] : z[r], nr = kWide ? sm.n0[p] : n[r];
            const T pz = add_rn(sm.ra[pv], ez), pn = add_rn(sm.rb[pv], en);
            sm.ra[p] = pz;
            sm.rb[p] = pn;
            sm.rc[p] = add_rn(k ? zr : add_rn(zr, T(0)), pz);
            sm.rd[p] = add_rn(k ? nr : add_rn(nr, T(0)), pn);
          }
        }
      }
    }
    __syncwarp();
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
using WalkFn = void (*)(const int32_t*, const T*, const T*, const T*, T*, T*, int, int, int,
                        WalkHp<T>, unsigned char*);

template <typename T, bool kChained>
WalkFn<T> walk_kernel(int R, bool wide) {
  if (wide) return ftrl_walk_kernel<T, kChained, 8, true>;
  switch (R) {
    case 1: return ftrl_walk_kernel<T, kChained, 1, false>;
    case 2: return ftrl_walk_kernel<T, kChained, 2, false>;
    case 4: return ftrl_walk_kernel<T, kChained, 4, false>;
    default: return ftrl_walk_kernel<T, kChained, 8, false>;
  }
}

// the global memory a walk needs: 0 when its chunk fits in shared memory
template <typename T>
size_t walk_spill(int K, int w) {
  const size_t bytes = walk_bytes<T>(K, w);
  return bytes <= kWalkMaxSmem ? 0 : bytes;
}

template <typename T>
int walk(int chained, const void* xi, const void* xv, const void* yy, const void* zn,
         void* margin, void* d, int K, int w, double beta, double l1, double l2,
         double inv_alpha, void* spill, cudaStream_t s) {
  const bool shared = walk_spill<T>(K, w) == 0;
  if (!shared && spill == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int R = w <= 32 ? 1 : w <= 64 ? 2 : w <= 128 ? 4 : 8;
  const bool wide = w > 32 * 8 || !shared;
  const WalkFn<T> fn = chained ? walk_kernel<T, true>(R, wide) : walk_kernel<T, false>(R, wide);
  const size_t smem = shared ? walk_bytes<T>(K, w) : 0;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const WalkHp<T> hp{static_cast<T>(beta), static_cast<T>(l1), static_cast<T>(l2),
                     static_cast<T>(inv_alpha)};
  fn<<<1, kWalkThreads, smem, s>>>(static_cast<const int32_t*>(xi), static_cast<const T*>(xv),
                                   static_cast<const T*>(yy), static_cast<const T*>(zn),
                                   static_cast<T*>(margin), static_cast<T*>(d), K, w,
                                   walk_hbits(K * w), hp,
                                   shared ? nullptr : static_cast<unsigned char*>(spill));
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

static bool walk_shape_ok(int K, int w) {
  return K > 0 && w > 0 && static_cast<long long>(K) * w <= kWalkMaxP;
}

// The global memory (bytes) a walk of K rows of width w needs as `spill`:
// 0 when the chunk fits in shared memory; -1 for a shape or dtype the
// walk does not take.
extern "C" long long alink_ftrl_walk_spill(int dtype, int K, int w) {
  if (!walk_shape_ok(K, w)) return -1;
  if (dtype == 0) return static_cast<long long>(walk_spill<float>(K, w));
  if (dtype == 1) return static_cast<long long>(walk_spill<double>(K, w));
  return -1;
}

// One chunk of the strict steps: xi (K, w) int32, xv (K, w), yy (K,), zn
// (K * w, 2) of one dtype; writes margin[0..K) and the deltas d (2, K * w).
// chained: 1 for the chained association, 0 for the per-sample one.
// inv_alpha: 1 / alpha rounded in the dtype. K * w <= kWalkMaxP. spill:
// alink_ftrl_walk_spill's bytes of global memory (unused when that is 0).
extern "C" int alink_ftrl_walk(int dtype, int chained, const void* xi, const void* xv,
                               const void* yy, const void* zn, void* margin, void* d, int K,
                               int w, double beta, double l1, double l2, double inv_alpha,
                               void* spill, void* stream) {
  if (!walk_shape_ok(K, w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return walk<float>(chained, xi, xv, yy, zn, margin, d, K, w, beta, l1, l2, inv_alpha,
                       spill, s);
  if (dtype == 1)
    return walk<double>(chained, xi, xv, yy, zn, margin, d, K, w, beta, l1, l2, inv_alpha,
                        spill, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* alink_ftrl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
