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
// What bounds them: memory bytes. The dense kernel reads X once
// (rows x dim values) and w once per block of rows; the sparse kernel
// reads idx, val and the gathered w entries once. One multiply and one
// add per value read: far below the card's operations-per-byte line. At
// serving shapes (a 512-row bucket) the bytes are a few MB or less, so
// both sit below the launch latency of a kernel, and the host path
// around them (encode, copies, decode) dominates a request.
//
// Design, simple first:
//   dense  — a block of ROWS rows (one thread per row) stages an
//            ROWS x TK tile of X and the matching TK-chunk of w through
//            shared memory. The loads are coalesced along the feature axis
//            (consecutive threads read consecutive columns); the tile rows
//            are padded by one element so the per-row walk hits distinct
//            banks. Each thread then walks its own row through the tile in
//            order.
//   sparse — one thread per row reads its idx/val row and gathers w[idx]
//            from global memory. At 2^20 features w is 4 MB in f32 and
//            stays in the 50 MB L2. Indices are clamped into [0, dim):
//            the host encoder rejects out-of-range indices before a launch,
//            the clamp only keeps a bad launch inside w.
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

constexpr int kRows = 32;   // rows (= threads) per dense block
constexpr int kTile = 64;   // features per staged tile
constexpr int kSparseThreads = 128;

template <int M>
__global__ void __launch_bounds__(kRows)
serve_dense_kernel(const typename Arith<M>::X* __restrict__ x,
                   const typename Arith<M>::W* __restrict__ w,
                   const float* __restrict__ scale,
                   const typename Arith<M>::B* __restrict__ b,
                   typename Arith<M>::Acc* __restrict__ out, int n, int dim) {
  using A = Arith<M>;
  using X = typename A::X;
  using W = typename A::W;
  // raw storage: bf16 has a constructor, which __shared__ arrays refuse
  __shared__ __align__(16) unsigned char xs_raw[kRows * (kTile + 1) * sizeof(X)];
  __shared__ __align__(16) unsigned char ws_raw[kTile * sizeof(W)];
  X* xs = reinterpret_cast<X*>(xs_raw);
  W* ws = reinterpret_cast<W*>(ws_raw);

  const int r = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  typename A::Acc acc = 0;
  for (int k0 = 0; k0 < dim; k0 += kTile) {
    const int kw = min(kTile, dim - k0);
    for (int e = r; e < rows * kTile; e += kRows) {
      const int rr = e / kTile;
      const int c = e - rr * kTile;
      if (c < kw) {
        xs[rr * (kTile + 1) + c] = x[static_cast<size_t>(row0 + rr) * dim + k0 + c];
      }
    }
    for (int c = r; c < kw; c += kRows) ws[c] = w[k0 + c];
    __syncthreads();
    if (r < rows) {
      const X* xr = xs + r * (kTile + 1);
      for (int c = 0; c < kw; ++c) acc = A::add(acc, A::term(xr[c], ws[c]));
    }
    __syncthreads();
  }
  if (r < rows) out[row0 + r] = A::link(acc, scale, b);
}

template <int M>
__global__ void __launch_bounds__(kSparseThreads)
serve_sparse_kernel(const int32_t* __restrict__ idx,
                    const typename Arith<M>::X* __restrict__ val,
                    const typename Arith<M>::W* __restrict__ w,
                    const float* __restrict__ scale,
                    const typename Arith<M>::B* __restrict__ b,
                    typename Arith<M>::Acc* __restrict__ out, int n, int width,
                    int dim) {
  using A = Arith<M>;
  const int row = blockIdx.x * kSparseThreads + threadIdx.x;
  if (row >= n) return;
  const int32_t* ir = idx + static_cast<size_t>(row) * width;
  const typename A::X* vr = val + static_cast<size_t>(row) * width;
  typename A::Acc acc = 0;
  for (int k = 0; k < width; ++k) {
    const int j = min(max(ir[k], 0), dim - 1);
    acc = A::add(acc, A::term(vr[k], w[j]));
  }
  out[row] = A::link(acc, scale, b);
}

template <int M>
void launch_dense(const void* x, const void* w, const void* scale, const void* b,
                  void* out, int n, int dim, cudaStream_t s) {
  using A = Arith<M>;
  const int blocks = (n + kRows - 1) / kRows;
  serve_dense_kernel<M><<<blocks, kRows, 0, s>>>(
      static_cast<const typename A::X*>(x), static_cast<const typename A::W*>(w),
      static_cast<const float*>(scale), static_cast<const typename A::B*>(b),
      static_cast<typename A::Acc*>(out), n, dim);
}

template <int M>
void launch_sparse(const void* idx, const void* val, const void* w, const void* scale,
                   const void* b, void* out, int n, int width, int dim,
                   cudaStream_t s) {
  using A = Arith<M>;
  const int blocks = (n + kSparseThreads - 1) / kSparseThreads;
  serve_sparse_kernel<M><<<blocks, kSparseThreads, 0, s>>>(
      static_cast<const int32_t*>(idx), static_cast<const typename A::X*>(val),
      static_cast<const typename A::W*>(w), static_cast<const float*>(scale),
      static_cast<const typename A::B*>(b), static_cast<typename A::Acc*>(out), n,
      width, dim);
}

}  // namespace

extern "C" int alink_serve_dense(int mode, const void* x, const void* w,
                                 const void* scale, const void* b, void* out, int n,
                                 int dim, void* stream) {
  if (n <= 0 || dim <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF32: launch_dense<kF32>(x, w, scale, b, out, n, dim, s); break;
    case kF64: launch_dense<kF64>(x, w, scale, b, out, n, dim, s); break;
    case kBF16: launch_dense<kBF16>(x, w, scale, b, out, n, dim, s); break;
    case kINT8: launch_dense<kINT8>(x, w, scale, b, out, n, dim, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int alink_serve_sparse(int mode, const void* idx, const void* val,
                                  const void* w, const void* scale, const void* b,
                                  void* out, int n, int width, int dim, void* stream) {
  if (n <= 0 || dim <= 0 || width < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF32: launch_sparse<kF32>(idx, val, w, scale, b, out, n, width, dim, s); break;
    case kF64: launch_sparse<kF64>(idx, val, w, scale, b, out, n, width, dim, s); break;
    case kBF16: launch_sparse<kBF16>(idx, val, w, scale, b, out, n, width, dim, s); break;
    case kINT8: launch_sparse<kINT8>(idx, val, w, scale, b, out, n, width, dim, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* alink_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
