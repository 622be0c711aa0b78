// The ordered sparse gradient of linear training for Hopper (sm_90a).
//
// What it replaces: no TPU kernel. It is the port's form of the gradient
// X^T c of a padded-COO or field-blocked design
// (alink_tpu/operator/common/optim/objfunc.py::rmatvec, an XLA scatter-add,
// and alink_tpu/ops/fieldblock.py::fb_rmatvec, a one-hot product), written
// because PyTorch's index_add_ adds with atomics on the card: two trainings
// would not give the same bits.
//
// Contract (kernels/linear.py::linear_grad_plain, bitwise):
//   grad[s] = sum of val[p] * c[p / width] over the flat positions p with
//             key[p] == s, each product rounded on its own (__fmul_rn /
//             __dmul_rn), added in ascending p (row, then column) from +0.0,
//             one rounded add each (__fadd_rn / __dadd_rn). A slot no
//             position names gets +0.0.
// That is what the JAX package's scatter-add and index_add_ compute on the
// CPU. Built with --fmad=false as well, so nothing contracts.
//
// The plan (kernels/linear.py::grad_plan, built once a training: the key
// layout does not change between supersteps): perm, the positions stably
// sorted by key, so each slot's positions form a run in ascending order,
// and starts[s] .. starts[s + 1], slot s's run in perm.
//
// Design: one warp a run, the warps striding over the slots. The lanes
// fetch the run's terms kStage at a time (position, then value and c: two
// dependent loads, independent of the sum), form the products and stage
// them in shared memory; lane 0 adds the staged terms in order while the
// lanes' loads of the next stage's terms and the positions of the stage
// after it are in flight. Nothing is atomic.
//
// What bounds it: its longest run. With an intercept every row names slot
// 0, so its run is n dependent adds, one after the other, in one lane:
// n times the add's latency is the kernel's floor (about 0.43 ms in float32
// and 0.82 ms in float64 at n = 200,000 and 1980 MHz). The rest of the
// slots take their runs in parallel; a short run costs a warp two
// dependent global loads and a few adds.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;          // warps a block
constexpr int kUnroll = 8;         // terms a lane fetches per stage
constexpr int kStage = 32 * kUnroll;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// 16-byte vectors of shared memory, added to a chain element by element
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  __device__ __forceinline__ static float add(float a, float4 v) {
    return __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(a, v.x), v.y), v.z), v.w);
  }
};
template <>
struct Vec<double> {
  using type = double2;
  __device__ __forceinline__ static double add(double a, double2 v) {
    return __dadd_rn(__dadd_rn(a, v.x), v.y);
  }
};

// One stage of a run is kStage consecutive positions, kUnroll a lane. Its
// fetch is two dependent loads: the positions (perm), then each position's
// value and its row's c. The walk keeps the two a stage apart, so that no
// load waits on the one before it while lane 0 adds.
__device__ __forceinline__ void fetch_pos(int (&pos)[kUnroll], const int* __restrict__ perm,
                                          int base, int end, int lane) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int j = base + u * 32 + lane;
    pos[u] = j < end ? __ldg(perm + j) : -1;
  }
}

template <typename T>
__device__ __forceinline__ void fetch_terms(T (&v)[kUnroll], T (&cv)[kUnroll],
                                            const int (&pos)[kUnroll],
                                            const T* __restrict__ val,
                                            const T* __restrict__ c, int width) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int p = pos[u];
    v[u] = p >= 0 ? __ldg(val + p) : T(0);
    cv[u] = p >= 0 ? __ldg(c + p / width) : T(0);
  }
}

// Lane 0's chain over cnt staged terms, in order. The terms come out of
// shared memory 32 at a time as 16-byte vectors, the next 32 read while the
// current 32 are added, so a read's latency stays off the chain.
template <typename T>
__device__ __forceinline__ T add_staged(T acc, const T* buf, int cnt) {
  using V = typename Vec<T>::type;
  constexpr int kPer = sizeof(V) / sizeof(T);
  constexpr int kVecs = 32 / kPer;
  int j = 0;
  V cur[kVecs];
  if (cnt >= 32) {
#pragma unroll
    for (int q = 0; q < kVecs; ++q) cur[q] = reinterpret_cast<const V*>(buf)[q];
  }
  for (; j + 32 <= cnt; j += 32) {
    V nxt[kVecs];
    const bool more = j + 64 <= cnt;
#pragma unroll
    for (int q = 0; q < kVecs; ++q)
      if (more) nxt[q] = reinterpret_cast<const V*>(buf + j + 32)[q];
#pragma unroll
    for (int q = 0; q < kVecs; ++q) acc = Vec<T>::add(acc, cur[q]);
#pragma unroll
    for (int q = 0; q < kVecs; ++q) cur[q] = nxt[q];
  }
  for (; j < cnt; ++j) acc = add_rn(acc, buf[j]);
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    linear_grad_kernel(const int* __restrict__ perm, const int* __restrict__ starts,
                       const T* __restrict__ val, const T* __restrict__ c,
                       T* __restrict__ out, int dim, int width) {
  __shared__ __align__(16) T stage[kWarps][kStage];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  T* buf = stage[wid];
  for (int s = blockIdx.x * kWarps + wid; s < dim; s += gridDim.x * kWarps) {
    const int b = __ldg(starts + s);
    const int e = __ldg(starts + s + 1);
    T acc = T(0);
    int pos[kUnroll];
    T v[kUnroll], cv[kUnroll];
    fetch_pos(pos, perm, b, e, lane);
    fetch_terms(v, cv, pos, val, c, width);
    fetch_pos(pos, perm, b + kStage, e, lane);
    for (int base = b; base < e; base += kStage) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) buf[u * 32 + lane] = mul_rn(v[u], cv[u]);
      __syncwarp();
      // the next stage's terms (its positions came a stage ago) and the
      // positions of the one after it, in flight while lane 0 adds
      fetch_terms(v, cv, pos, val, c, width);
      fetch_pos(pos, perm, base + 2 * kStage, e, lane);
      if (lane == 0) acc = add_staged(acc, buf, min(kStage, e - base));
      __syncwarp();
    }
    if (lane == 0) out[s] = acc;
  }
}

template <typename T>
int launch(const void* perm, const void* starts, const void* val, const void* c, void* out,
           int dim, int width, int blocks, cudaStream_t s) {
  linear_grad_kernel<T><<<blocks, kWarps * 32, 0, s>>>(
      static_cast<const int*>(perm), static_cast<const int*>(starts),
      static_cast<const T*>(val), static_cast<const T*>(c), static_cast<T*>(out), dim, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0: float32, 1: float64. perm (n * width) int32, starts (dim + 1)
// int32, val (n * width) and c (n) of the dtype, out (dim) of the dtype.
// blocks: the grid (the warps stride over the slots).
extern "C" int alink_linear_grad(int dtype, const void* perm, const void* starts,
                                 const void* val, const void* c, void* out, int dim, int width,
                                 int blocks, void* stream) {
  if (dim <= 0 || width <= 0 || blocks <= 0 || blocks > (1 << 30) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(perm, starts, val, c, out, dim, width, blocks, s)
                    : launch<double>(perm, starts, val, c, out, dim, width, blocks, s);
}

extern "C" int alink_linear_grad_warps() { return kWarps; }

extern "C" const char* alink_linear_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
