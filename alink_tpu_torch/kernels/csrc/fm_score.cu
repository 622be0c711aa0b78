// The FM serving score for Hopper (sm_90a), "P4".
//
// What it replaces: no TPU kernel. It is the JAX package's strict-order FM
// score, FmModelMapper.serving_kernel's `_dense` and `_sparse`
// (alink_tpu/operator/batch/classification/fm_ops.py:275 and :284), XLA
// programs of serving/sharded.py::scan_sum, whose order PyTorch ops give
// only as a Python loop over the row's width (a set of launches a
// position).
//
// Contract (scan_sum's order, bitwise): for each row,
//   margin = (w0 + lin) + 0.5 * sum_f (s_f * s_f - q_f)
//   lin    = sum_j val_j * w[idx_j]
//   s_f    = sum_j val_j * V[idx_j, f]
//   q_f    = sum_j (val_j * val_j) * (V[idx_j, f] * V[idx_j, f])
// every sum strictly left to right from +0.0, every product rounded on its
// own (__fmul_rn / __dmul_rn, never an FMA; built with --fmad=false too).
// The dense layout is the same with idx_j = j over the row's dim columns.
// Zero padding (val 0 at idx 0) adds +-0.0 to chains that start at +0.0:
// a no-op, so a row scores the same in every bucket.
//
// What bounds it: the chains. A row is 2k + 1 dependent chains of `width`
// adds (s_f, q_f, lin; the products are off the chains), then one chain of
// k adds. At serving buckets (at most 512 rows) the card has far more issue
// slots than there are chains, so a call costs the latency of its first
// loads, then the walk of the longest chain: the instructions its thread
// issues a position, and the latency of its dependent adds. The bytes (the
// rows' values and indices, the rows of w and V they name) are kilobytes
// to a few megabytes.
//
// Design: a thread a chain, the loads staged ahead in shared memory.
//  - A block owns R rows (R from the row count and the SM count, so that a
//    512-row bucket spreads over the SMs) and has a thread for each chain:
//    first the s chains, k + 1 a row (s_f, then lin as the s of a column
//    that is w), then, from the next warp on, the q chains, k a row. So a
//    warp runs one kind of chain and no branch splits it, and a q chain's
//    three products do not lengthen an s chain's walk. Past 480 chains a
//    thread takes several, their sums kept in shared memory between tiles.
//    One more thread, in a warp of its own, issues the bulk copies, so no
//    walker waits on their issue.
//  - Positions go in tiles of P, P chosen at launch so that the stages fit
//    the opt-in shared memory for any k and width. Dense: each stage holds
//    X's R x P slab, V's P rows (P * k contiguous values) and P values of
//    w. Sparse: idx and val's R x P slabs; once a tile's indices have
//    landed, the block gathers each (row, factor) column of the tile
//    (V[idx, f], or w[idx]) into shared memory, two tiles deep, so the
//    gathers of tile t + 1 fly while tile t is walked. The contiguous spans
//    go by TMA bulk copies (an mbarrier a stage counts their bytes), three
//    tiles deep; a span that is not 16-byte
//    aligned goes by cp.async, a value a thread.
//  - The walk reads a tile from shared memory in groups of positions, the
//    next group's loads issued before this group's adds (left to itself
//    the compiler puts each load just before its use, and a position then
//    costs a shared-memory round trip). A row's or a column's tile sits an
//    odd number of 16-byte units from the next, so 16-byte loads of
//    neighbouring rows fall in different banks.
//  - The tail: the chains' sums go to shared memory and one thread a row
//    adds the s_f * s_f - q_f in f order and writes the margin.
//
// Interface: plain C, loaded with ctypes. A launch goes on the caller's
// stream, allocates nothing and returns cudaGetLastError(). A wait on a
// copy that never lands traps rather than hanging the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 480;      // walkers a block at most: with the producer warp, 512
constexpr int kMaxRows = 8;           // a block's rows at most
constexpr int kDenseTile = 512;       // positions a tile at most, dense
constexpr int kSparseTile = 64;       // and sparse
constexpr int kStages = 3;            // dense tiles and sparse slabs in flight at most
constexpr int kGatherStages = 2;      // sparse gathered tiles at most
constexpr int kGroup = 16;            // a tile of 16 or more positions: a multiple of 16
constexpr int kMaxDevices = 64;
constexpr long long kWaitCycles = 4000000000LL;  // a copy not landed by then: trap

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// four consecutive values from a 16-byte aligned shared address
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void load4(const double* p, double* o) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  o[0] = a.x, o[1] = a.y, o[2] = b.x, o[3] = b.y;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// one value of kBytes (4 or 8) from global src to shared dst
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)),
               "l"(__cvta_generic_to_global(src)), "n"(kBytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(b)) : "memory");
}
// the stage's one arrival, and the bytes its bulk copies will bring
__device__ __forceinline__ void mbar_expect(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  const long long t0 = clock64();
  unsigned done = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// Whether a span of count values at src goes by a bulk copy: src 16-byte
// aligned and the bytes a multiple of 16 (the shared side is aligned by
// the layout)
template <typename T>
__device__ __forceinline__ bool bulk_ok(const T* src, int count) {
  return (reinterpret_cast<uintptr_t>(src) & 15) == 0 && (count * sizeof(T)) % 16 == 0;
}

// A contiguous span of count values from global src to shared dst: one
// bulk copy by the producer thread onto the stage's barrier (whose byte
// count it set from bulk_ok beforehand), else cp.async, thread t of nt
// taking the values t, t + nt, ...
template <typename T>
__device__ __forceinline__ void stage_span(T* dst, const T* src, int count, uint64_t* bar, int t,
                                           int nt, bool producer) {
  if (bulk_ok(src, count)) {
    if (producer) bulk_copy(dst, src, static_cast<unsigned>(count * sizeof(T)), bar);
    return;
  }
  for (int i = t; i < count; i += nt) cp_async<sizeof(T)>(dst + i, src + i);
}

// The shared-memory layout and the chains of a launch, computed on the host.
struct Geometry {
  int rows;         // R: rows a block
  int tile;         // P: positions a tile
  int stride;       // values between two rows' (or columns') tiles
  int istride;      // sparse: ints between two rows' index tiles
  int s_chains;     // R * (k + 1): the s chains (lin last in a row)
  int q_base;       // the first q chain: s_chains rounded up to a warp
  int chains;       // q_base + R * k
  int walkers;      // threads that walk chains: chains, at most kMaxThreads
  int producer;     // the thread that issues the bulk copies: walkers rounded up to a warp
  int bulk;         // every span goes by a bulk copy: the walkers skip the staging code
  int stage_bytes;  // dense: one tile stage; sparse: one idx/val stage
  int v_off;        // dense: V's offset in a stage; sparse: idx's
  int w_off;        // dense: w's offset in a stage
  int g_off;        // sparse: the gathered stages' start
  int g_bytes;      // sparse: one gathered stage
  int bar_off;      // the stages' mbarriers
  int state_off;    // the chains' sums between tiles, when a thread has several
};

// A group of kU positions from p: the row's values and the column's
// weights (contiguous, or every vs-th value)
template <typename T, bool kContig, int kU>
__device__ __forceinline__ void load_group(const T* __restrict__ x, const T* __restrict__ v,
                                           int vs, int p, T* xr, T* vr) {
#pragma unroll
  for (int u = 0; u < kU; u += 4) load4(x + p + u, xr + u);
  if constexpr (kContig) {
#pragma unroll
    for (int u = 0; u < kU; u += 4) load4(v + p + u, vr + u);
  } else {
#pragma unroll
    for (int u = 0; u < kU; ++u) vr[u] = v[(p + u) * vs];
  }
}

template <typename T, bool kQ>
__device__ __forceinline__ T term(T x, T v) {
  return kQ ? mul_rn(mul_rn(x, x), mul_rn(v, v)) : mul_rn(x, v);
}

template <typename T, bool kQ, int kU>
__device__ __forceinline__ void add_group(const T* xr, const T* vr, T& c) {
#pragma unroll
  for (int u = 0; u < kU; ++u) c = add_rn(c, term<T, kQ>(xr[u], vr[u]));
}

// One chain over cnt positions: c += term(x[p], v[p * vs]) in p order (an s
// chain's term x v, a q chain's (x x)(v v)); groups of kU positions, the
// next group loaded before this one is added (left to itself the compiler
// puts each load just before its use), then the rest one at a time.
template <typename T, bool kQ, bool kContig>
__device__ __forceinline__ void walk(const T* __restrict__ x, const T* __restrict__ v, int vs,
                                     int cnt, T& c) {
  constexpr int kU = sizeof(T) == 4 ? 16 : 8;
  const int groups = cnt / kU;
  T xa[kU], va[kU], xb[kU], vb[kU];
  int g = 0;
  if (groups > 0) load_group<T, kContig, kU>(x, v, vs, 0, xa, va);
  for (; g + 2 <= groups; g += 2) {
    load_group<T, kContig, kU>(x, v, vs, (g + 1) * kU, xb, vb);
    add_group<T, kQ, kU>(xa, va, c);
    if (g + 2 < groups) load_group<T, kContig, kU>(x, v, vs, (g + 2) * kU, xa, va);
    add_group<T, kQ, kU>(xb, vb, c);
  }
  if (g < groups) add_group<T, kQ, kU>(xa, va, c);
  for (int p = groups * kU; p < cnt; ++p) c = add_rn(c, term<T, kQ>(x[p], v[kContig ? p : p * vs]));
}

// kDense: idx is null and position j of row i reads x[i * width + j] at
// feature j; else feature idx[i * width + j], clamped into [0, dim) (the
// host encoder refuses out-of-range features before a launch)
template <typename T, bool kDense>
__global__ void __launch_bounds__(kMaxThreads + 32)
fm_score_kernel(const int32_t* __restrict__ idx, const T* __restrict__ val,
                const T* __restrict__ w0, const T* __restrict__ w, const T* __restrict__ V,
                T* __restrict__ out, int n, int width, int dim, int k, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, nt = blockDim.x;
  const T bias = *w0;  // its load flies while the tiles do
  const int row0 = blockIdx.x * g.rows;
  const int live = min(g.rows, n - row0);
  const int per = k + 1;
  const int tiles = (width + g.tile - 1) / g.tile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + g.bar_off);
  const int nw = g.walkers;
  const bool multi = g.chains > nw;  // a walker takes several chains
  const bool producer = t == g.producer;
  const bool stager = producer || !g.bulk;  // runs the staging code
  T* state = reinterpret_cast<T*>(smem + g.state_off);
  if (producer) {
    for (int i = 0; i < kStages; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (multi)
    for (int i = t; i < g.chains; i += nt) state[i] = T(0);
  __syncthreads();
  T c1 = T(0);  // the sum of the thread's one chain

  // every chain of the thread over tile ti: xs the tile's values (R rows),
  // column(r, f, vs) the weights of row r's factor f (f == k: w)
  auto walk_tile = [&](int ti, const T* xs, auto column) {
    const int cnt = min(g.tile, width - ti * g.tile);
    for (int c = t; t < nw && c < g.chains; c += nw) {
      const bool q = c >= g.q_base;
      if (!q && c >= g.s_chains) continue;  // the warp's padding
      const int ci = q ? c - g.q_base : c, span = q ? k : per;
      const int r = ci / span, f = ci - r * span;
      if (r >= live) continue;
      T sum = multi ? state[c] : c1;
      int vs;
      const T* v = column(r, f, vs);
      if (q) walk<T, true, !kDense>(xs + r * g.stride, v, vs, cnt, sum);
      else walk<T, false, !kDense>(xs + r * g.stride, v, vs, cnt, sum);
      if (multi) state[c] = sum;
      else c1 = sum;
    }
  };

  if constexpr (kDense) {
    auto issue = [&](int ti) {  // tile ti's X slab, V rows and w into its stage
      if (ti < tiles && stager) {
        const int p0 = ti * g.tile, cnt = min(g.tile, width - p0);
        unsigned char* b = smem + (ti % kStages) * g.stage_bytes;
        uint64_t* bar = &bars[ti % kStages];
        unsigned bytes = 0;
        if (producer) {  // the stage's byte count first, then the copies
          for (int r = 0; r < live; ++r)
            if (bulk_ok(val + static_cast<size_t>(row0 + r) * width + p0, cnt)) bytes += cnt * sizeof(T);
          if (bulk_ok(V + static_cast<size_t>(p0) * k, cnt * k)) bytes += cnt * k * sizeof(T);
          if (bulk_ok(w + p0, cnt)) bytes += cnt * sizeof(T);
          mbar_expect(bar, bytes);
        }
        T* xs = reinterpret_cast<T*>(b);
        for (int r = 0; r < live; ++r)
          stage_span(xs + r * g.stride, val + static_cast<size_t>(row0 + r) * width + p0, cnt, bar,
                     t, nt, producer);
        stage_span(reinterpret_cast<T*>(b + g.v_off), V + static_cast<size_t>(p0) * k, cnt * k,
                   bar, t, nt, producer);
        stage_span(reinterpret_cast<T*>(b + g.w_off), w + p0, cnt, bar, t, nt, producer);
      }
      cp_commit();
    };
    for (int i = 0; i < kStages - 1; ++i) issue(i);
    for (int ti = 0; ti < tiles; ++ti) {
      cp_wait<kStages - 2>();  // this thread's cp.async of tile ti
      if (!producer) mbar_wait(&bars[ti % kStages], (ti / kStages) & 1);  // the bulk copies
      // everyone's cp.async, and tile ti - 1's walks are done (before tile
      // 0, with only bulk copies, there is nothing to wait for)
      if (ti > 0 || !g.bulk) __syncthreads();
      issue(ti + kStages - 1);
      const unsigned char* b = smem + (ti % kStages) * g.stage_bytes;
      const T* vsm = reinterpret_cast<const T*>(b + g.v_off);
      const T* wsm = reinterpret_cast<const T*>(b + g.w_off);
      walk_tile(ti, reinterpret_cast<const T*>(b), [&](int, int f, int& vs) {
        vs = f < k ? k : 1;
        return f < k ? vsm + f : wsm;
      });
    }
  } else {
    const int scols = g.s_chains;  // gathered columns: (row, factor), w last in a row
    auto stage = [&](int ti) { return smem + (ti % kStages) * g.stage_bytes; };
    auto gathered = [&](int ti) {
      return reinterpret_cast<T*>(smem + g.g_off + (ti % kGatherStages) * g.g_bytes);
    };
    auto issue_rows = [&](int ti) {  // tile ti's val and idx slabs
      if (ti >= tiles || !stager) return;
      const int p0 = ti * g.tile, cnt = min(g.tile, width - p0);
      unsigned char* b = stage(ti);
      uint64_t* bar = &bars[ti % kStages];
      if (producer) {
        unsigned bytes = 0;
        for (int r = 0; r < live; ++r) {
          const size_t at = static_cast<size_t>(row0 + r) * width + p0;
          if (bulk_ok(val + at, cnt)) bytes += cnt * sizeof(T);
          if (bulk_ok(idx + at, cnt)) bytes += cnt * 4;
        }
        mbar_expect(bar, bytes);
      }
      for (int r = 0; r < live; ++r) {
        const size_t at = static_cast<size_t>(row0 + r) * width + p0;
        stage_span(reinterpret_cast<T*>(b) + r * g.stride, val + at, cnt, bar, t, nt, producer);
        stage_span(reinterpret_cast<int32_t*>(b + g.v_off) + r * g.istride, idx + at, cnt, bar, t,
                   nt, producer);
      }
    };
    // the gather: thread t takes column t % scols at positions t / scols,
    // t / scols + nt / scols, ... (with fewer threads than columns, columns
    // t, t + nt, ... at every position), so a warp reads neighbouring
    // factors of one row of V
    const bool wide = nt >= scols;
    const int pstep = wide ? nt / scols : 1, col0 = wide ? t % scols : t;
    const int pfirst = wide ? t / scols : 0, cstep = wide ? scols : nt;
    const bool gathers = !wide || t < pstep * scols;
    auto issue_gather = [&](int ti) {  // each column's weights of tile ti
      if (ti >= tiles || !gathers) return;
      const int cnt = min(g.tile, width - ti * g.tile);
      const int32_t* is = reinterpret_cast<const int32_t*>(stage(ti) + g.v_off);
      T* gs = gathered(ti);
      for (int col = col0; col < scols; col += cstep) {
        const int r = col / per, f = col - r * per;
        if (r >= live) continue;
        const T* src = f < k ? V + f : w;
        const size_t step = f < k ? static_cast<size_t>(k) : 1;
        const int32_t* ir = is + r * g.istride;
        T* dst = gs + static_cast<size_t>(col) * g.stride;
        int p = pfirst;
        for (; p + 3 * pstep < cnt; p += 4 * pstep) {  // four indices, then four copies
          int feat[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) feat[u] = ir[p + u * pstep];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            cp_async<sizeof(T)>(dst + p + u * pstep,
                                src + static_cast<size_t>(min(max(feat[u], 0), dim - 1)) * step);
        }
        for (; p < cnt; p += pstep)
          cp_async<sizeof(T)>(dst + p, src + static_cast<size_t>(min(max(ir[p], 0), dim - 1)) * step);
      }
    };
    issue_rows(0);
    issue_rows(1);
    mbar_wait(&bars[0], 0);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    issue_gather(0);
    cp_commit();
    for (int ti = 0; ti < tiles; ++ti) {
      cp_wait<0>();  // gathers of tile ti (and any cp.async of slab ti + 1)
      if (ti + 1 < tiles) mbar_wait(&bars[(ti + 1) % kStages], ((ti + 1) / kStages) & 1);
      __syncthreads();  // everyone's copies, and tile ti - 1's walks are done
      issue_gather(ti + 1);
      issue_rows(ti + 2);
      cp_commit();
      const T* gs = gathered(ti);
      walk_tile(ti, reinterpret_cast<const T*>(stage(ti)), [&](int r, int f, int& vs) {
        vs = 1;
        return gs + static_cast<size_t>(r * per + f) * g.stride;
      });
    }
  }

  // the tail: each chain's sum in shared memory (over the tiles, all
  // walked), then one thread a row adds s_f * s_f - q_f in f order
  cp_wait<0>();
  __syncthreads();
  T* sums = reinterpret_cast<T*>(smem);  // the s chains, then the q chains at s_chains
  for (int c = t; t < nw && c < g.chains; c += nw) {
    const bool q = c >= g.q_base;
    if (!q && c >= g.s_chains) continue;
    const int ci = q ? c - g.q_base : c;
    if (ci / (q ? k : per) >= live) continue;
    sums[q ? g.s_chains + ci : ci] = multi ? state[c] : c1;
  }
  __syncthreads();
  if (t < live) {
    const T* sr = sums + t * per;
    const T* qr = sums + g.s_chains + t * k;
    T acc = T(0);
    int f = 0;
    for (; f + 8 <= k; f += 8) {  // eight sums loaded, then added
      T a[8], b[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) a[u] = sr[f + u], b[u] = qr[f + u];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc = add_rn(acc, sub_rn(mul_rn(a[u], a[u]), b[u]));
    }
    for (; f < k; ++f) acc = add_rn(acc, sub_rn(mul_rn(sr[f], sr[f]), qr[f]));
    out[row0 + t] = add_rn(add_rn(bias, sr[k]), mul_rn(T(0.5), acc));
  }
}

struct DeviceInfo {
  int sms = 0;
  int optin = 0;           // opt-in shared memory a block
  bool raised[2][2] = {};  // the kernels' dynamic shared memory raised to it
};
DeviceInfo g_devices[kMaxDevices];

size_t align16(size_t b) { return (b + 15) & ~static_cast<size_t>(15); }

// The layout of R rows and tiles of P positions; its bytes in *total.
template <typename T, bool kDense>
Geometry layout(int R, int P, int k, int width, size_t* total) {
  const size_t es = sizeof(T);
  const int pad = static_cast<int>(16 / es);
  const int ntiles = (width + P - 1) / P;
  const int stages = ntiles < kStages ? (ntiles > 0 ? ntiles : 1) : kStages;
  const int gstages = stages < kGatherStages ? stages : kGatherStages;
  int stride = (P + pad - 1) / pad * pad;
  if ((stride / pad) % 2 == 0) stride += pad;  // an odd number of 16-byte units
  Geometry g{};
  g.rows = R;
  g.tile = P;
  g.stride = stride;
  g.istride = (P + 3) / 4 * 4;
  g.s_chains = R * (k + 1);
  g.q_base = (g.s_chains + 31) / 32 * 32;
  g.chains = g.q_base + R * k;
  g.walkers = g.chains < kMaxThreads ? g.chains : kMaxThreads;
  g.producer = (g.walkers + 31) / 32 * 32;
  size_t tiles;
  if (kDense) {
    g.v_off = static_cast<int>(align16(R * stride * es));
    g.w_off = g.v_off + static_cast<int>(align16(static_cast<size_t>(P) * k * es));
    g.stage_bytes = g.w_off + static_cast<int>(align16(P * es));
    tiles = static_cast<size_t>(stages) * g.stage_bytes;
  } else {
    g.v_off = static_cast<int>(align16(R * stride * es));
    g.stage_bytes = g.v_off + static_cast<int>(align16(static_cast<size_t>(R) * g.istride * 4));
    g.g_off = stages * g.stage_bytes;
    g.g_bytes = static_cast<int>(align16(static_cast<size_t>(g.s_chains) * stride * es));
    tiles = g.g_off + static_cast<size_t>(gstages) * g.g_bytes;
  }
  const size_t sums = (g.s_chains + static_cast<size_t>(R) * k) * es;
  g.bar_off = static_cast<int>(align16(tiles > sums ? tiles : sums));
  g.state_off = g.bar_off + static_cast<int>(align16(kStages * sizeof(uint64_t)));
  *total = g.state_off + (g.chains > kMaxThreads ? g.chains * es : 0);
  return g;
}

template <typename T, bool kDense>
int launch(const void* idx, const void* val, const void* w0, const void* w, const void* V,
           void* out, int n, int width, int dim, int k, cudaStream_t s) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  DeviceInfo& info = g_devices[dev];
  if (info.sms == 0) {
    int sms = 0, optin = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    info.optin = optin;
    info.sms = sms;
  }
  // rows a block: spread the rows over the SMs, a thread a chain up to
  // kMaxThreads (one row a block past that, its threads taking several)
  int R = (n + info.sms - 1) / info.sms;
  R = R < 1 ? 1 : (R > kMaxRows ? kMaxRows : R);
  while (R > 1 && (R * (k + 1) + 31) / 32 * 32 + R * k > kMaxThreads) --R;
  // positions a tile: the most (a multiple of 16, else of 4, else fewer
  // when even those do not fit) whose stages fit the opt-in shared memory
  const int cap = kDense ? kDenseTile : kSparseTile;
  int P = width < cap ? (width + kGroup - 1) / kGroup * kGroup : cap;
  if (P < 1) P = 1;
  size_t total = 0;
  Geometry g = layout<T, kDense>(R, P, k, width, &total);
  while (total > static_cast<size_t>(info.optin)) {
    if (P > kGroup) P = (P - 1) / kGroup * kGroup;
    else if (P > 4) P = (P - 1) / 4 * 4;
    else if (P > 1) --P;
    else if (R > 1) --R;
    else return static_cast<int>(cudaErrorInvalidValue);  // k past the shared memory
    g = layout<T, kDense>(R, P, k, width, &total);
  }
  // every span 16-byte aligned with a multiple of 16 bytes: the bases, the
  // rows' starts (width) and the tiles' starts (P)
  const auto a16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  g.bulk = a16(val) && a16(V) && a16(w) && width * sizeof(T) % 16 == 0 &&
           P * sizeof(T) % 16 == 0 &&
           (kDense || (a16(idx) && width * 4 % 16 == 0 && P * 4 % 16 == 0));
  bool& raised = info.raised[sizeof(T) == 8][kDense];
  if (total > 48 * 1024 && !raised) {
    e = cudaFuncSetAttribute(fm_score_kernel<T, kDense>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, info.optin);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised = true;
  }
  fm_score_kernel<T, kDense><<<(n + R - 1) / R, g.producer + 1, total, s>>>(
      static_cast<const int32_t*>(idx), static_cast<const T*>(val), static_cast<const T*>(w0),
      static_cast<const T*>(w), static_cast<const T*>(V), static_cast<T*>(out), n, width, dim, k,
      g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a[0..10]: dtype (0 float, 1 double), then the pointers idx (null for the
// dense layout, width == dim), val, w0, w, V, out, then n, width, dim, k:
// one array, so that a ctypes call passes two arguments
extern "C" int alink_fm_score(const int64_t* a, void* stream) {
  const int dtype = static_cast<int>(a[0]);
  const void* idx = reinterpret_cast<const void*>(a[1]);
  const void* val = reinterpret_cast<const void*>(a[2]);
  const void* w0 = reinterpret_cast<const void*>(a[3]);
  const void* w = reinterpret_cast<const void*>(a[4]);
  const void* V = reinterpret_cast<const void*>(a[5]);
  void* out = reinterpret_cast<void*>(a[6]);
  if (a[7] <= 0 || a[8] < 0 || a[9] <= 0 || a[10] <= 0 || a[7] > INT32_MAX || a[8] > INT32_MAX ||
      a[9] > INT32_MAX || a[10] > INT32_MAX || (idx == nullptr && a[8] > a[9]))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = static_cast<int>(a[7]), width = static_cast<int>(a[8]);
  const int dim = static_cast<int>(a[9]), k = static_cast<int>(a[10]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dense = idx == nullptr;
  if (dtype == 0)
    return dense ? launch<float, true>(idx, val, w0, w, V, out, n, width, dim, k, s)
                 : launch<float, false>(idx, val, w0, w, V, out, n, width, dim, k, s);
  if (dtype == 1)
    return dense ? launch<double, true>(idx, val, w0, w, V, out, n, width, dim, k, s)
                 : launch<double, false>(idx, val, w0, w, V, out, n, width, dim, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* alink_fm_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
