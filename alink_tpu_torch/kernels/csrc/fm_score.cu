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
// What bounds it: the launch at serving buckets (at most 512 rows), then the
// chains: each row is k + 1 dependent chains of `width` adds, run side by
// side, and one final chain of k adds. The bytes are the rows' idx and val
// and the gathered rows of w and V, kilobytes to a few megabytes.
//
// Design: one warp a row, kRows rows a block. The lanes take the factors
// (lane f, f + 32, ...), each walking the row's positions in order for s_f
// and q_f (the position's idx and val are one broadcast load, V's row is
// read coalesced); lane 0 also walks lin. Then each lane stores its
// s_f * s_f - q_f terms in the warp's shared buffer and lane 0 adds them in
// f order and writes the margin.
//
// Interface: plain C, loaded with ctypes. A launch goes on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;                 // warps (rows) a block
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// kDense: idx is null and position j of row i reads x[i * width + j] at
// feature j; else feature idx[i * width + j], clamped into [0, dim) (the
// host encoder refuses out-of-range features before a launch)
template <typename T, bool kDense>
__global__ void __launch_bounds__(kRows * 32)
fm_score_kernel(const int32_t* __restrict__ idx, const T* __restrict__ val,
                const T* __restrict__ w0, const T* __restrict__ w, const T* __restrict__ V,
                T* __restrict__ out, int n, int width, int dim, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the warp's k terms, then lin
  T* terms = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(threadIdx.x / 32) * (k + 1);
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRows + threadIdx.x / 32;
  if (row >= n) return;
  const size_t base = static_cast<size_t>(row) * width;
  for (int f0 = 0; f0 < k; f0 += 32) {
    const int f = f0 + lane;
    T s = T(0), q = T(0), lin = T(0);
    for (int j = 0; j < width; ++j) {
      const T x = val[base + j];
      const int feat = kDense ? j : min(max(static_cast<int>(idx[base + j]), 0), dim - 1);
      if (f < k) {
        const T v = V[static_cast<size_t>(feat) * k + f];
        s = add_rn(s, mul_rn(x, v));
        q = add_rn(q, mul_rn(mul_rn(x, x), mul_rn(v, v)));
      }
      if (f0 == 0 && lane == 0) lin = add_rn(lin, mul_rn(x, w[feat]));
    }
    if (f < k) terms[f] = sub_rn(mul_rn(s, s), q);
    if (f0 == 0 && lane == 0) terms[k] = lin;  // past the factors: lin's slot
  }
  __syncwarp();
  if (lane == 0) {
    T acc = T(0);
    for (int f = 0; f < k; ++f) acc = add_rn(acc, terms[f]);
    out[row] = add_rn(add_rn(*w0, terms[k]), mul_rn(T(0.5), acc));
  }
}

template <typename T, bool kDense>
int launch(const void* idx, const void* val, const void* w0, const void* w, const void* V,
           void* out, int n, int width, int dim, int k, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(kRows) * (k + 1) * sizeof(T);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(fm_score_kernel<T, kDense>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fm_score_kernel<T, kDense><<<(n + kRows - 1) / kRows, kRows * 32, smem, s>>>(
      static_cast<const int32_t*>(idx), static_cast<const T*>(val), static_cast<const T*>(w0),
      static_cast<const T*>(w), static_cast<const T*>(V), static_cast<T*>(out), n, width, dim,
      k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0 float, 1 double; idx null for the dense layout (width == dim)
extern "C" int alink_fm_score(int dtype, const void* idx, const void* val, const void* w0,
                              const void* w, const void* V, void* out, int n, int width,
                              int dim, int k, void* stream) {
  if (n <= 0 || width < 0 || dim <= 0 || k <= 0 || (idx == nullptr && width > dim))
    return static_cast<int>(cudaErrorInvalidValue);
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
