// Fused serving score kernels for Hopper (sm_90a).
//
// What they replace:
//   serve_dense_kernel  <- alink_tpu/kernels/serve.py::_fused_dense_call
//   serve_sparse_kernel <- alink_tpu/kernels/serve.py::_fused_sparse_call
// Both compute one linear score per request row,
//   dense:  s[i] = link(sum_j X[i,j] * w[j])
//   sparse: s[i] = link(sum_k val[i,k] * w[idx[i,k]])
// with the bias (and, in int8 mode, the weight scale) applied in the
// epilogue.
//
// The reduction-order contract (the JAX package's): every term is rounded
// on its own (__fmul_rn / __dmul_rn, never an FMA), terms are added
// strictly left to right from zero (__fadd_rn / __dadd_rn), the epilogue
// comes last. Each row is therefore ONE ordered chain; the kernels get
// their parallelism across rows only. Built with --fmad=false as well, so
// nothing else contracts either.
//
// What bounds them. The sparse kernel: memory bytes and the launch. It
// reads idx, val and the gathered w entries once, one multiply and one add
// per value read, far below the card's operations-per-byte line; at a
// 512-row bucket that is well under a launch's fixed cost.
// The dense kernel: the chain. Its bytes (X once, w once) take well under
// a microsecond at a 512 x 1024 bucket, but each row is one chain of dim
// dependent adds, so no row finishes before dim x the add's latency; at
// dim 1024 that is a few microseconds, however many rows run beside it.
// The host path around both (encode, copies, decode) dominates a request.
//
// Design:
//   dense  — one warp per row, `rows` warps a block (the wrapper's
//            _dense_plan in kernels/serve.py picks `rows` so that a
//            512-row bucket gives every SM a block, and the chunk width).
//            The block streams its rows and w through a ring of kStages
//            chunks of up to 2 KB in shared memory: each warp copies its
//            row's next chunks with 16-byte cp.async copies and the block
//            copies w's once, so chunks c+1 and c+2 are in flight while
//            chunk c is used. For chunk c the warp's 32 lanes first turn
//            it into terms (16-byte shared loads, the multiplies in
//            parallel: __fmul_rn gives the same bits in any lane) in a
//            buffer of the warp's; then lane 0 adds them in column order,
//            loading the next 32 terms (as 16-byte shared loads) before it
//            adds the current 32, so only the adds are serial. A row or w
//            whose address is not 16-byte aligned (an odd dim, a view that
//            starts inside a word) is staged element by element instead,
//            the last chunk's tail too; the terms and the walk are the
//            same either way. Past the adds, a chunk costs its term pass
//            and a block barrier (the lanes wait while lane 0 walks).
//   sparse — one warp per `rows` consecutive rows (1 to 32), `warps` warps
//            a block (the wrapper's _sparse_plan in kernels/serve.py picks
//            them so that a 512-row bucket gives every SM a block). The
//            warp's rows are one contiguous span of idx and val: its lanes
//            read it in order (neighbouring lanes, neighbouring words),
//            gather w[idx] and form the terms in parallel (__fmul_rn gives
//            the same bits in any lane) into a buffer of the warp's, `chunk`
//            terms at a time; then lane r adds row r's terms of the chunk
//            in column order, so one lane walks each row's chain and the
//            chains of the warp's rows run side by side. At 2^20 features
//            w is 4 MB in f32 and stays in the 50 MB L2. Indices are
//            clamped into [0, dim): the host encoder rejects out-of-range
//            indices before a launch, the clamp only keeps a bad launch
//            inside w.
//
// Modes (the per-mode arithmetic is the Arith<> specialisation below):
//   0 f32  — float terms and sum, epilogue acc + b
//   1 f64  — the f32 mode with a float64 ship dtype: double terms and sum
//   2 bf16 — bf16 values and weights; each term is the float product of
//            the two bf16 values (exact: 8 x 8 significant bits), NOT
//            rounded back to bf16; float sum; epilogue acc + b
//   3 int8 — float values, int8 weights; terms x * float(q), float sum;
//            epilogue fma(acc, scale, b), one rounding
//
// Interface: plain C, loaded with ctypes. A launch goes on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { kF32 = 0, kF64 = 1, kBF16 = 2, kINT8 = 3 };

template <int M>
struct Arith;

template <>
struct Arith<kF32> {
  using X = float;
  using W = float;
  using Acc = float;
  using B = float;
  static __device__ __forceinline__ Acc term(X x, W w) { return __fmul_rn(x, w); }
  static __device__ __forceinline__ Acc add(Acc a, Acc t) { return __fadd_rn(a, t); }
  static __device__ __forceinline__ Acc link(Acc a, const float*, const B* b) {
    return __fadd_rn(a, *b);
  }
};

template <>
struct Arith<kF64> {
  using X = double;
  using W = double;
  using Acc = double;
  using B = double;
  static __device__ __forceinline__ Acc term(X x, W w) { return __dmul_rn(x, w); }
  static __device__ __forceinline__ Acc add(Acc a, Acc t) { return __dadd_rn(a, t); }
  static __device__ __forceinline__ Acc link(Acc a, const float*, const B* b) {
    return __dadd_rn(a, *b);
  }
};

template <>
struct Arith<kBF16> {
  using X = __nv_bfloat16;
  using W = __nv_bfloat16;
  using Acc = float;
  using B = float;
  static __device__ __forceinline__ Acc term(X x, W w) {
    return __fmul_rn(__bfloat162float(x), __bfloat162float(w));
  }
  static __device__ __forceinline__ Acc add(Acc a, Acc t) { return __fadd_rn(a, t); }
  static __device__ __forceinline__ Acc link(Acc a, const float*, const B* b) {
    return __fadd_rn(a, *b);
  }
};

template <>
struct Arith<kINT8> {
  using X = float;
  using W = int8_t;
  using Acc = float;
  using B = float;
  static __device__ __forceinline__ Acc term(X x, W q) {
    return __fmul_rn(x, static_cast<float>(q));
  }
  static __device__ __forceinline__ Acc add(Acc a, Acc t) { return __fadd_rn(a, t); }
  static __device__ __forceinline__ Acc link(Acc a, const float* scale, const B* b) {
    return __fmaf_rn(a, *scale, *b);
  }
};

constexpr int kMaxRows = 4;          // warps (= rows) a dense block at most
constexpr int kStages = 3;           // chunks in the dense ring
constexpr int kStep = 32;            // terms the walker adds between two loads
constexpr int kMaxChunkBytes = 2048; // bytes of one row's chunk of X at most
constexpr int kSparseMaxWarps = 4;     // warps a sparse block at most
constexpr int kSparseMaxRows = 32;     // rows a warp at most: one lane walks each
constexpr int kSparseMaxChunk = 256;   // terms a warp forms between two walks

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy count elements from src to dst (shared, 16-byte aligned), thread t
// of nt: whole 16-byte pieces by cp.async where src is 16-byte aligned,
// the rest element by element.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int count, int t, int nt) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int pieces = count * static_cast<int>(sizeof(T)) / 16;
    for (int p = t; p < pieces; p += nt)
      cp_async16(reinterpret_cast<char*>(dst) + 16 * p,
                 reinterpret_cast<const char*>(src) + 16 * p);
    done = pieces * 16 / static_cast<int>(sizeof(T));
  }
  for (int e = done + t; e < count; e += nt) dst[e] = src[e];
}

// N consecutive elements in registers, moved to and from shared memory as
// 16-byte words (N * sizeof(T) a multiple of 16, the address 16-byte aligned)
template <typename T, int N>
struct alignas(16) Regs {
  T v[N];
  __device__ __forceinline__ void load(const T* src) {
#pragma unroll
    for (int q = 0; q < N * static_cast<int>(sizeof(T)) / 16; ++q)
      reinterpret_cast<uint4*>(v)[q] = reinterpret_cast<const uint4*>(src)[q];
  }
  __device__ __forceinline__ void store(T* dst) const {
#pragma unroll
    for (int q = 0; q < N * static_cast<int>(sizeof(T)) / 16; ++q)
      reinterpret_cast<uint4*>(dst)[q] = reinterpret_cast<const uint4*>(v)[q];
  }
};

// Add the terms t[0 .. count) to acc in order, count a multiple of kStep.
// The next kStep terms are loaded before the current ones are added, so
// the loads run ahead of the chain (the last load reads kStep terms past
// count, which the caller's buffer holds).
template <typename Acc>
__device__ __forceinline__ Acc walk(const Acc* t, int count, Acc acc) {
  Regs<Acc, kStep> cur;
  cur.load(t);
#pragma unroll 2
  for (int j = 0; j < count; j += kStep) {
    Regs<Acc, kStep> next;
    next.load(t + j + kStep);
#pragma unroll
    for (int k = 0; k < kStep; ++k) acc = add_rn(acc, cur.v[k]);
    cur = next;
  }
  return acc;
}

// One warp per row, `rows` rows a block; `chunk` columns a stage (a
// multiple of kStep, at most kMaxChunkBytes of X). Shared memory: kStages
// slots of `rows` row chunks, kStages chunks of w, then each warp's terms
// (chunk + kStep of them).
template <int M>
__global__ void __launch_bounds__(kMaxRows * 32)
serve_dense_kernel(const typename Arith<M>::X* __restrict__ x,
                   const typename Arith<M>::W* __restrict__ w,
                   const float* __restrict__ scale,
                   const typename Arith<M>::B* __restrict__ b,
                   typename Arith<M>::Acc* __restrict__ out, int n, int dim, int rows,
                   int chunk) {
  using A = Arith<M>;
  using X = typename A::X;
  using W = typename A::W;
  using Acc = typename A::Acc;
  constexpr int V = 16 / sizeof(X);  // values of one 16-byte word of x
  extern __shared__ __align__(16) unsigned char smem[];
  X* xs = reinterpret_cast<X*>(smem);
  W* ws = reinterpret_cast<W*>(smem + static_cast<size_t>(kStages) * rows * chunk * sizeof(X));
  Acc* ts = reinterpret_cast<Acc*>(smem + static_cast<size_t>(kStages) * chunk *
                                              (rows * sizeof(X) + sizeof(W)));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * rows + warp;
  const bool live = row < n;
  const X* xrow = x + static_cast<size_t>(live ? row : 0) * dim;
  Acc* terms = ts + warp * (chunk + kStep);
  const int chunks = (dim + chunk - 1) / chunk;
  auto issue = [&](int c) {
    const int k0 = c * chunk, kw = min(chunk, dim - k0), s = c % kStages;
    if (live) stage(xs + (s * rows + warp) * chunk, xrow + k0, kw, lane, 32);
    stage(ws + s * chunk, w + k0, kw, static_cast<int>(threadIdx.x), rows * 32);
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) issue(c);
    cp_async_commit();
  }
  Acc acc = 0;
  for (int c = 0; c < chunks; ++c) {
    // chunk c has landed (one group a chunk, committed even when empty),
    // and every walker has left chunk c - 1, whose slot the next copy takes
    cp_async_wait<kStages - 2>();
    __syncthreads();
    __syncwarp();
    if (c + kStages - 1 < chunks) issue(c + kStages - 1);
    cp_async_commit();
    if (!live) continue;
    const int s = c % kStages, kw = min(chunk, dim - c * chunk);
    const int steps = (kw + kStep - 1) / kStep * kStep;
    const X* xc = xs + (s * rows + warp) * chunk;
    const W* wc = ws + s * chunk;
    // the warp's lanes turn the chunk into terms, V a lane at a time; a
    // term past kw is +0.0, which leaves any sum from +0.0 as it was (such
    // a sum is never -0.0 under round to nearest)
#pragma unroll 4
    for (int e = lane * V; e < steps; e += 32 * V) {
      Regs<X, V> xv;
      xv.load(xc + e);
      Regs<Acc, V> tv;
#pragma unroll
      for (int v = 0; v < V; ++v) tv.v[v] = e + v < kw ? A::term(xv.v[v], wc[e + v]) : Acc(0);
      tv.store(terms + e);
    }
    __syncwarp();
    if (lane == 0) acc = walk<Acc>(terms, steps, acc);
    __syncwarp();
  }
  if (live && lane == 0) out[row] = A::link(acc, scale, b);
}

// One warp per `rows` rows, `warps` warps a block; `chunk` terms (a multiple
// of 32, at most kSparseMaxChunk) a pass. Shared memory: each warp's chunk
// of terms.
template <int M>
__global__ void __launch_bounds__(kSparseMaxWarps * 32)
serve_sparse_kernel(const int32_t* __restrict__ idx,
                    const typename Arith<M>::X* __restrict__ val,
                    const typename Arith<M>::W* __restrict__ w,
                    const float* __restrict__ scale,
                    const typename Arith<M>::B* __restrict__ b,
                    typename Arith<M>::Acc* __restrict__ out, int n, int width,
                    int dim, int rows, int chunk) {
  using A = Arith<M>;
  using Acc = typename A::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * (blockDim.x / 32) + warp) * rows;
  if (row0 >= n) return;
  Acc* terms = reinterpret_cast<Acc*>(smem) + warp * chunk;
  const int live = min(rows, n - row0), span = live * width;
  const size_t base = static_cast<size_t>(row0) * width;
  // lane r < live walks row r: span positions [lo, lo + width)
  const int lo = lane * width;
  Acc acc = 0;
  for (int c0 = 0; c0 < span; c0 += chunk) {
    const int cw = min(chunk, span - c0);
    for (int e = lane; e < cw; e += 32) {
      const size_t g = base + c0 + e;
      const int j = min(max(idx[g], 0), dim - 1);
      terms[e] = A::term(val[g], w[j]);
    }
    __syncwarp();
    if (lane < live) {
      const int end = min(lo + width, c0 + cw) - c0;
#pragma unroll 4
      for (int e = max(lo, c0) - c0; e < end; ++e) acc = A::add(acc, terms[e]);
    }
    __syncwarp();
  }
  if (lane < live) out[row0 + lane] = A::link(acc, scale, b);
}

template <int M>
int launch_dense(const void* x, const void* w, const void* scale, const void* b, void* out,
                 int n, int dim, int rows, int chunk, cudaStream_t s) {
  using A = Arith<M>;
  if (rows < 1 || rows > kMaxRows || chunk < kStep || chunk % kStep != 0 ||
      chunk * sizeof(typename A::X) > kMaxChunkBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  // at most 47,616 bytes (bf16: 4 rows of 1024 columns), under the 48 KB a
  // launch takes without opting in
  const size_t smem =
      kStages * static_cast<size_t>(chunk) * (rows * sizeof(typename A::X) + sizeof(typename A::W)) +
      static_cast<size_t>(rows) * (chunk + kStep) * sizeof(typename A::Acc);
  const int blocks = (n + rows - 1) / rows;
  serve_dense_kernel<M><<<blocks, rows * 32, smem, s>>>(
      static_cast<const typename A::X*>(x), static_cast<const typename A::W*>(w),
      static_cast<const float*>(scale), static_cast<const typename A::B*>(b),
      static_cast<typename A::Acc*>(out), n, dim, rows, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <int M>
int launch_sparse(const void* idx, const void* val, const void* w, const void* scale,
                  const void* b, void* out, int n, int width, int dim, int rows, int warps,
                  int chunk, cudaStream_t s) {
  using A = Arith<M>;
  if (rows < 1 || rows > kSparseMaxRows || warps < 1 || warps > kSparseMaxWarps ||
      chunk < 32 || chunk > kSparseMaxChunk || chunk % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = rows * warps;
  const int blocks = (n + per_block - 1) / per_block;
  // at most 8 KB: 4 warps of 256 double terms
  const size_t smem = static_cast<size_t>(warps) * chunk * sizeof(typename A::Acc);
  serve_sparse_kernel<M><<<blocks, warps * 32, smem, s>>>(
      static_cast<const int32_t*>(idx), static_cast<const typename A::X*>(val),
      static_cast<const typename A::W*>(w), static_cast<const float*>(scale),
      static_cast<const typename A::B*>(b), static_cast<typename A::Acc*>(out), n,
      width, dim, rows, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows: warps (= rows) a block, 1..kMaxRows; chunk: columns a stage, a
// multiple of 32 of at most 2048 bytes of X (kernels/serve.py::_dense_plan)
extern "C" int alink_serve_dense(int mode, const void* x, const void* w,
                                 const void* scale, const void* b, void* out, int n,
                                 int dim, int rows, int chunk, void* stream) {
  if (n <= 0 || dim <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF32: return launch_dense<kF32>(x, w, scale, b, out, n, dim, rows, chunk, s);
    case kF64: return launch_dense<kF64>(x, w, scale, b, out, n, dim, rows, chunk, s);
    case kBF16: return launch_dense<kBF16>(x, w, scale, b, out, n, dim, rows, chunk, s);
    case kINT8: return launch_dense<kINT8>(x, w, scale, b, out, n, dim, rows, chunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// rows: rows a warp, 1..kSparseMaxRows; warps: warps a block,
// 1..kSparseMaxWarps; chunk: terms a warp forms a pass, a multiple of 32 up
// to kSparseMaxChunk (kernels/serve.py::_sparse_plan)
extern "C" int alink_serve_sparse(int mode, const void* idx, const void* val,
                                  const void* w, const void* scale, const void* b,
                                  void* out, int n, int width, int dim, int rows, int warps,
                                  int chunk, void* stream) {
  if (n <= 0 || dim <= 0 || width < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF32:
      return launch_sparse<kF32>(idx, val, w, scale, b, out, n, width, dim, rows, warps, chunk, s);
    case kF64:
      return launch_sparse<kF64>(idx, val, w, scale, b, out, n, width, dim, rows, warps, chunk, s);
    case kBF16:
      return launch_sparse<kBF16>(idx, val, w, scale, b, out, n, width, dim, rows, warps, chunk,
                                  s);
    case kINT8:
      return launch_sparse<kINT8>(idx, val, w, scale, b, out, n, width, dim, rows, warps, chunk,
                                  s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* alink_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
