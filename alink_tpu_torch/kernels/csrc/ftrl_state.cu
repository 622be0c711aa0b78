// FTRL state kernels for Hopper (sm_90a): the state gather, the
// deterministic scatter-add and the chained-correction matvec of the sparse
// online FTRL steps.
//
// What they replace:
//   ftrl_gather_kernel       <- alink_tpu/kernels/ftrl.py::_gather_call
//                               (gather_rows)
//   ftrl_scatter_add_kernel  <- alink_tpu/kernels/ftrl.py::_scatter_call
//                               (scatter_add_rows)
//   ftrl_chained_corr_kernel <- alink_tpu/kernels/ftrl.py::chained_corr
// Each is instantiated for float and double; gather and scatter-add for
// C = 1 (z or n alone) and C = 2 (z and n stacked as (S, 2)).
//
// Contracts (the JAX package's, pinned bitwise against its XLA ops):
//   gather      out[m, c] = state[idx[m], c].
//   scatter-add state[idx[m], c] += upd[m, c] for m = 0..M-1 IN ORDER:
//               duplicate slots accumulate in update order, each add
//               rounded on its own (__fadd_rn / __dadd_rn); a slot that no
//               update names is never written, so a stored -0.0 survives.
//               No atomics: atomicAdd's order changes from run to run.
//   chained     out[a, c] = sum_{j<k} sum_b Mk[j, a, b] * D[j, b, c], one
//               chain per output in the order j, then b, from a zero
//               accumulator; every product rounded on its own (no FMA,
//               no TF32, no tensor cores).
// Built with --fmad=false as well, so nothing else contracts either.
//
// What bounds them: the launch. At the shapes of the FTRL steps (M = 160 to
// 1280 touched slots of a 2^20 state, K = 16 chained rows of width 40) each
// kernel moves a few kilobytes to a few hundred kilobytes, microseconds or
// less at the card's memory rate, so a launch's fixed cost dominates. The
// state itself is touched only at the M named slots; the rest of the 2^20
// slots are never read.
//
// Design, simple first:
//   gather   — one thread per (m, c).
//   scatter  — ONE block. It stages idx and upd in shared memory (dynamic,
//              opted in above 48 KB). Position i owns its slot when no
//              earlier position j < i names the same slot; the owner reads
//              state[slot] once, adds upd[j] for every j >= i with that slot
//              in order, and writes once. O(M^2) compares on shared memory,
//              spread over the block's threads: fine at M <= 1280, where a
//              slot named by every row of a chunk (the intercept) is one
//              chain of up to 32 adds. Padded positions (slot 0, update 0.0)
//              are added like any other, as the JAX package adds them
//              (-0.0 + 0.0 turns into +0.0 there).
//   chained  — ONE block, one thread per output (a, c), each walking its
//              chain of k * w products.
// An index outside [0, S) fails a device-side assert, as PyTorch's own
// CUDA indexing does: the launch's stream then reports cudaErrorAssert at
// its next synchronize, where the plain version raises IndexError at once.
// The clamp behind the assert only keeps a build without asserts (NDEBUG)
// inside the state.
//
// Interface: plain C, loaded with ctypes. A launch goes on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <cassert>

namespace {

constexpr int kGatherThreads = 256;
constexpr int kScatterThreads = 1024;
constexpr int kCorrThreads = 256;
// idx and upd staged in the scatter block's shared memory, at most
// 4 + 2 * 8 bytes a position, inside the 227 KB a block can opt in to
constexpr int kScatterMaxM = 11264;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

__device__ __forceinline__ int checked_slot(int32_t s, int S) {
  assert(s >= 0 && s < S);
  return min(max(static_cast<int>(s), 0), S - 1);
}

template <typename T, int C>
__global__ void __launch_bounds__(kGatherThreads)
ftrl_gather_kernel(const T* __restrict__ state, const int32_t* __restrict__ idx,
                   T* __restrict__ out, int M, int S) {
  const int t = blockIdx.x * kGatherThreads + threadIdx.x;
  if (t >= M * C) return;
  const int m = t / C;
  const int c = t - m * C;
  out[t] = state[static_cast<size_t>(checked_slot(idx[m], S)) * C + c];
}

template <typename T, int C>
__global__ void __launch_bounds__(kScatterThreads)
ftrl_scatter_add_kernel(T* __restrict__ state, const int32_t* __restrict__ idx,
                        const T* __restrict__ upd, int M, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* u = reinterpret_cast<T*>(smem);
  int32_t* slots = reinterpret_cast<int32_t*>(u + static_cast<size_t>(M) * C);
  for (int i = threadIdx.x; i < M; i += blockDim.x) slots[i] = checked_slot(idx[i], S);
  for (int i = threadIdx.x; i < M * C; i += blockDim.x) u[i] = upd[i];
  __syncthreads();
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const int32_t slot = slots[i];
    bool owner = true;
    for (int j = 0; j < i; ++j) {
      if (slots[j] == slot) {
        owner = false;
        break;
      }
    }
    if (!owner) continue;
    T acc[C];
    T* dst = state + static_cast<size_t>(slot) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = dst[c];
    for (int j = i; j < M; ++j) {
      if (slots[j] != slot) continue;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = add_rn(acc[c], u[j * C + c]);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) dst[c] = acc[c];
  }
}

template <typename T>
__global__ void __launch_bounds__(kCorrThreads)
ftrl_chained_corr_kernel(const T* __restrict__ Mk, const T* __restrict__ D,
                         T* __restrict__ out, int k, int w, int C) {
  for (int t = threadIdx.x; t < w * C; t += blockDim.x) {
    const int a = t / C;
    const int c = t - a * C;
    T acc = 0;
    for (int j = 0; j < k; ++j) {
      const T* mrow = Mk + (static_cast<size_t>(j) * w + a) * w;
      const T* dj = D + static_cast<size_t>(j) * w * C + c;
      for (int b = 0; b < w; ++b) acc = add_rn(acc, mul_rn(mrow[b], dj[b * C]));
    }
    out[t] = acc;
  }
}

template <typename T>
int gather(const void* state, const void* idx, void* out, int M, int S, int C,
           cudaStream_t s) {
  const int blocks = (M * C + kGatherThreads - 1) / kGatherThreads;
  const T* st = static_cast<const T*>(state);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  T* o = static_cast<T*>(out);
  if (C == 1) {
    ftrl_gather_kernel<T, 1><<<blocks, kGatherThreads, 0, s>>>(st, ix, o, M, S);
  } else if (C == 2) {
    ftrl_gather_kernel<T, 2><<<blocks, kGatherThreads, 0, s>>>(st, ix, o, M, S);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C>
int launch_scatter(T* st, const int32_t* ix, const T* u, int M, int S, cudaStream_t s) {
  const int threads = M < kScatterThreads ? ((M + 31) / 32) * 32 : kScatterThreads;
  const size_t smem = static_cast<size_t>(M) * (C * sizeof(T) + sizeof(int32_t));
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(ftrl_scatter_add_kernel<T, C>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ftrl_scatter_add_kernel<T, C><<<1, threads, smem, s>>>(st, ix, u, M, S);
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
int chained_corr(const void* Mk, const void* D, void* out, int k, int w, int C,
                 cudaStream_t s) {
  const int threads = w * C < kCorrThreads ? ((w * C + 31) / 32) * 32 : kCorrThreads;
  ftrl_chained_corr_kernel<T><<<1, threads, 0, s>>>(
      static_cast<const T*>(Mk), static_cast<const T*>(D), static_cast<T*>(out), k, w,
      C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float, 1 = double. C: 1 or 2.
extern "C" int alink_ftrl_gather(int dtype, const void* state, const void* idx, void* out,
                                 int M, int S, int C, void* stream) {
  if (M <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return gather<float>(state, idx, out, M, S, C, s);
  if (dtype == 1) return gather<double>(state, idx, out, M, S, C, s);
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

extern "C" int alink_ftrl_chained_corr(int dtype, const void* Mk, const void* D, void* out,
                                       int k, int w, int C, void* stream) {
  if (k <= 0 || w <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return chained_corr<float>(Mk, D, out, k, w, C, s);
  if (dtype == 1) return chained_corr<double>(Mk, D, out, k, w, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* alink_ftrl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
