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
// sorted by key, so each slot's positions form a run in ascending order;
// starts[s] .. starts[s + 1], slot s's run in perm; and order, the slots
// in three classes: the n_heavy runs of at least HEAVY_MIN terms and the
// n_medium runs of more than SHORT_MAX, each by length, longest first (ties
// by slot), then the short rest (empty runs included) by slot.
//
// What bounds it: its longest run. With an intercept every row names slot
// 0, so its run is n dependent adds, one after the other, in one thread: n
// times the add's latency is the kernel's floor (about 0.43 ms in float32
// and 0.82 ms in float64 at n = 200,000 and 1980 MHz). Everything else is
// short work in parallel, and its bytes bound is a few hundredths of that.
//
// Design: one launch, two kinds of block.
//
// * Heavy clusters (the first heavy_blocks of the grid, two blocks a
//   cluster, so the scheduler places them before the bulk) each walk heavy
//   runs order[k], order[k + clusters], ... The launch then asks for the
//   opt-in maximum of shared memory, so every block holds an SM alone.
//   Block 0's thread 0 is the walker: it only adds, reading staged
//   products out of a shared-memory ring as 16-byte vectors a group of 32
//   floats (16 doubles) ahead. Block 1's eight warps are the producers:
//   they fetch positions, then their values and their rows' c (the row is
//   p / width by a multiply with a precomputed magic number), form the
//   rounded products and store them into the walker's ring across the
//   cluster. Full and empty slots are signalled with mbarriers, so neither
//   side waits on the other unless the ring is empty or full (see
//   heavy_cluster).
// * Light blocks walk every other slot: a medium run by a warp (its lanes
//   fetch and stage 256 terms at a time, lane 0 adds them in order while
//   the next stage's loads are in flight), a short run by one lane, which
//   issues its run's loads 8 at a time before it adds them, the next run's
//   bounds already in flight. With no heavy run the launch keeps a small
//   shared-memory size and no clusters, and the light blocks fill each SM
//   as the kernel always did.
//
// Nothing is atomic and the kernel allocates nothing.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;                  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 8;                 // terms a lane fetches at a time
constexpr int kStage = 32 * kUnroll;       // a light warp's stage
constexpr int kRounds = 4;                 // a producer's rounds a slot
constexpr int kHeavyStage = kRounds * kStage;  // a ring slot's terms
// a producer's rounds of terms in flight at once: all of a slot's in
// float32; two in float64, whose registers would not hold more
template <typename T>
constexpr int kTermsAhead = sizeof(T) == 4 ? kRounds : 2;
constexpr int kProducers = kWarps;         // the producers' block
constexpr int kRing = 2 * kProducers;      // slots; each producer owns two

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// p / width for 0 <= p < 2^31: floor(p * magic / 2^shift), with
// magic = ceil(2^shift / width) and shift = 31 + ceil(log2 width), exact on
// that range (Granlund and Montgomery, 1994; kernels/linear.py::div_magic)
__device__ __forceinline__ int row_of(int p, unsigned magic, int shift) {
  return static_cast<int>((static_cast<unsigned long long>(static_cast<unsigned>(p)) * magic) >>
                          shift);
}

// The walk's adds as volatile asm statements. The compiler keeps volatile
// statements in the order written, so the adds and the shared-memory reads
// of the walk (below) stay interleaved as add_staged lays them out: each
// read is issued a whole group of adds before its first use. Left free,
// the compiler moved a group's reads after the adds they were meant to
// overlap, and each group's first add waited on them.
__device__ __forceinline__ float chain_add(float a, float b) {
  asm volatile("add.rn.f32 %0, %0, %1;\n" : "+f"(a) : "f"(b));
  return a;
}
__device__ __forceinline__ double chain_add(double a, double b) {
  asm volatile("add.rn.f64 %0, %0, %1;\n" : "+d"(a) : "d"(b));
  return a;
}

// 16-byte vectors of shared memory, added to a chain element by element
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  __device__ __forceinline__ static float add(float a, float4 v) {
    return chain_add(chain_add(chain_add(chain_add(a, v.x), v.y), v.z), v.w);
  }
};
template <>
struct Vec<double> {
  using type = double2;
  __device__ __forceinline__ static double add(double a, double2 v) {
    return chain_add(chain_add(a, v.x), v.y);
  }
};

// kUnroll consecutive-by-32 positions of a run from j0: the positions
// (perm), then each position's value and its row's c. Past the run's end a
// position is -1 and its term 0.
__device__ __forceinline__ void fetch_pos(int (&pos)[kUnroll], const int* __restrict__ perm,
                                          int j0, int end) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int j = j0 + u * 32;
    pos[u] = j < end ? __ldg(perm + j) : -1;
  }
}

template <typename T>
__device__ __forceinline__ void fetch_terms(T (&v)[kUnroll], T (&cv)[kUnroll],
                                            const int (&pos)[kUnroll],
                                            const T* __restrict__ val,
                                            const T* __restrict__ c, unsigned magic,
                                            int shift) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int p = pos[u];
    v[u] = p >= 0 ? __ldg(val + p) : T(0);
    cv[u] = p >= 0 ? __ldg(c + row_of(p, magic, shift)) : T(0);
  }
}

// The chain over cnt staged terms, in order, of a buffer of cap terms. The
// terms come out of shared memory as 16-byte vectors, eight vectors (32
// floats or 16 doubles: a group) at a time into two sets of registers in
// turn: one set is read while the other is added, so a read's latency stays
// off the chain, and nothing is moved between the two. The read of the
// group after next is unconditional, clamped to the buffer's last group
// (whose values then go unused), so that no branch splits it from the adds
// it overlaps.
template <typename T>
__device__ __forceinline__ T add_vecs(T acc, const typename Vec<T>::type (&x)[8]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) acc = Vec<T>::add(acc, x[q]);
  return acc;
}

// A 16-byte read of shared memory as a volatile asm statement (see
// chain_add)
__device__ __forceinline__ void read_vec(float4& x, const float4* p) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p)))
               : "memory");
}
__device__ __forceinline__ void read_vec(double2& x, const double2* p) {
  asm volatile("ld.shared.v2.f64 {%0, %1}, [%2];\n"
               : "=d"(x.x), "=d"(x.y)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p)))
               : "memory");
}

template <typename T>
__device__ __forceinline__ void read_vecs(typename Vec<T>::type (&x)[8], const T* buf, int group) {
  using V = typename Vec<T>::type;
#pragma unroll
  for (int q = 0; q < 8; ++q) read_vec(x[q], reinterpret_cast<const V*>(buf) + group * 8 + q);
}

template <typename T, int kCap>
__device__ __forceinline__ T add_staged(T acc, const T* buf, int cnt) {
  using V = typename Vec<T>::type;
  constexpr int kGroup = 8 * static_cast<int>(sizeof(V) / sizeof(T));
  static_assert(kCap % kGroup == 0, "a buffer holds whole groups");
  constexpr int kLast = kCap / kGroup - 1;
  const int groups = cnt / kGroup;
  V a[8], b[8];
  int g = 0;
  if (groups > 0) read_vecs<T>(a, buf, 0);
  for (; g + 2 <= groups; g += 2) {
    read_vecs<T>(b, buf, g + 1);
    acc = add_vecs<T>(acc, a);
    read_vecs<T>(a, buf, min(g + 2, kLast));
    acc = add_vecs<T>(acc, b);
  }
  if (g < groups) {
    acc = add_vecs<T>(acc, a);
    ++g;
  }
  for (int k = g * kGroup; k < cnt; ++k) acc = add_rn(acc, buf[k]);
  return acc;
}

// -- mbarriers, the cluster of a heavy run and its remote stores (PTX) ----

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of both blocks of the cluster: their shared memory (and
// barriers) written before it is seen by the other block after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// the address in the cluster's shared window of the same place in block
// `rank` as this block's shared address `addr`
__device__ __forceinline__ unsigned map_to(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// arrive on one of this block's mbarriers, with release semantics: this
// thread's earlier shared-memory reads are ordered before the phase
// completes
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// arrive on an mbarrier of either block, with release semantics at cluster
// scope: this thread's earlier shared-memory writes (a producer's stores) or
// reads (the walker's) are ordered before the phase completes
__device__ __forceinline__ void bar_arrive_at(unsigned cluster_addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                   cluster_addr)
               : "memory");
}

__device__ __forceinline__ void store_at(unsigned cluster_addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(cluster_addr), "f"(v) : "memory");
}
__device__ __forceinline__ void store_at(unsigned cluster_addr, double v) {
  asm volatile("st.shared::cluster.f64 [%0], %1;\n" ::"r"(cluster_addr), "d"(v) : "memory");
}

// whether the phase of the given parity of one of this block's mbarriers has
// completed, with acquire semantics at cluster scope; the hardware may
// suspend the thread a while before it answers no
__device__ __forceinline__ bool bar_try(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of the given parity has completed. A wait that has
// not ended after 2^36 cycles (over half a minute) traps: a fault in the
// hand-off fails the launch instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  if (bar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!bar_try(bar, parity))
    if (clock64() - t0 > (1LL << 36)) __trap();
}

struct Args {
  const int* perm;
  const int* starts;
  const int* order;
  unsigned magic;
  int shift;
  int n_heavy, n_medium, n_short;
  int heavy_blocks;
};

// -- heavy clusters --------------------------------------------------------
//
// A heavy run is walked by a cluster of two blocks, each on an SM of its
// own. Block 0 (the walker's) holds the ring, kRing slots of kHeavyStage
// terms, full[i] (32 arrivals: the filling producer warp's lanes) and
// read[i] (1 arrival: the walker); block 1 (the producers') holds empty[i]
// (1 arrival). Both blocks lay their shared memory out alike: full, read,
// empty, ring. Stage g of the cluster (its runs' stages counted in order)
// goes into slot g % kRing and is filled by producer warp g % kProducers;
// kRing is a multiple of kProducers, so a slot always has the same producer
// and each side sees its barriers' phases in order.
//
// The producers' loads run on the other SM: a column's run (the
// intercept's) loads a cache line a term, and on the walker's SM those
// loads queued ahead of its shared-memory reads and slowed its chain. An
// arrive on the other block's barrier is a release at cluster scope, a
// memory barrier that stalls its thread, so the walker only arrives on
// read[i], in its own block, and a relay thread of block 0 passes each
// slot on to empty[i] in block 1. Neither block waits for the other at its
// end: the walker has read every stage block 1 writes, and the relay
// passes on only the slots a producer will wait for, so no thread reaches
// the other block after that block's last wait on it.
template <typename T>
__device__ __forceinline__ void heavy_cluster(const Args& a, const T* __restrict__ val,
                                              const T* __restrict__ c, T* __restrict__ out,
                                              unsigned char* smem) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* read = full + kRing;
  uint64_t* empty = read + kRing;
  T* ring = reinterpret_cast<T*>(empty + kRing);
  const unsigned rank = cluster_rank();
  const int cluster = blockIdx.x >> 1;
  const int clusters = a.heavy_blocks >> 1;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) {
      if (rank == 0) {
        bar_init(full + i, 32);
        bar_init(read + i, 1);
      } else {
        bar_init(empty + i, 1);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();
  if (rank == 0 && threadIdx.x == 0) {
    // the walker
    unsigned g = 0;
    for (int r = cluster; r < a.n_heavy; r += clusters) {
      const int s = __ldg(a.order + r);
      const int b = __ldg(a.starts + s);
      const int e = __ldg(a.starts + s + 1);
      T acc = T(0);
      for (int base = b; base < e; base += kHeavyStage, ++g) {
        const unsigned slot = g % kRing;
        bar_wait(full + slot, (g / kRing) & 1u);
        acc = add_staged<T, kHeavyStage>(acc, ring + slot * kHeavyStage,
                                          min(kHeavyStage, e - base));
        bar_arrive(read + slot);
      }
      out[s] = acc;
    }
  } else if (rank == 0 && threadIdx.x == 32) {
    // the relay: the cluster's stages, then each slot read on to block 1
    // for the stages a producer refills
    unsigned stages = 0;
    for (int r = cluster; r < a.n_heavy; r += clusters) {
      const int s = __ldg(a.order + r);
      stages += (__ldg(a.starts + s + 1) - __ldg(a.starts + s) + kHeavyStage - 1) / kHeavyStage;
    }
    const unsigned empty_at = map_to(smem_addr(empty), 1);
    for (unsigned g = 0; g + kRing < stages; ++g) {
      const unsigned slot = g % kRing;
      bar_wait(read + slot, (g / kRing) & 1u);
      bar_arrive_at(empty_at + slot * 8);
    }
  } else if (rank == 1) {
    // a producer warp
    const int lane = threadIdx.x & 31;
    const unsigned j = threadIdx.x >> 5;
    const unsigned full_at = map_to(smem_addr(full), 0);
    const unsigned ring_at = map_to(smem_addr(ring), 0) + lane * sizeof(T);
    unsigned g = 0;
    for (int r = cluster; r < a.n_heavy; r += clusters) {
      const int s = __ldg(a.order + r);
      const int b = __ldg(a.starts + s);
      const int e = __ldg(a.starts + s + 1);
      for (int base = b; base < e; base += kHeavyStage, ++g) {
        if (g % kProducers != j) continue;
        const unsigned slot = g % kRing;
        const unsigned dst = ring_at + slot * kHeavyStage * sizeof(T);
        // every round's positions, then the first kAhead rounds' terms, are
        // fetched before the slot is free; each later round's terms kAhead
        // rounds ahead of their stores. Past the run's end a term is 0 and
        // goes unread.
        constexpr int kAhead = kTermsAhead<T>;
        int pos[kRounds][kUnroll];
        T v[kAhead][kUnroll], cv[kAhead][kUnroll];
#pragma unroll
        for (int h = 0; h < kRounds; ++h) fetch_pos(pos[h], a.perm, base + h * kStage + lane, e);
#pragma unroll
        for (int h = 0; h < kAhead; ++h)
          fetch_terms(v[h], cv[h], pos[h], val, c, a.magic, a.shift);
        bar_wait(empty + slot, ((g / kRing) & 1u) ^ 1u);
#pragma unroll
        for (int h = 0; h < kRounds; ++h) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            store_at(dst + (h * kStage + u * 32) * sizeof(T),
                     mul_rn(v[h % kAhead][u], cv[h % kAhead][u]));
          if (h + kAhead < kRounds)
            fetch_terms(v[h % kAhead], cv[h % kAhead], pos[h + kAhead], val, c, a.magic,
                        a.shift);
        }
        bar_arrive_at(full_at + slot * 8);
      }
    }
  }
}

// -- light blocks ----------------------------------------------------------

// one warp walks a run of any length: the lanes fetch kStage terms at a
// time and stage their products; lane 0 adds them in order while the lanes'
// loads of the next stage's terms, and the positions of the one after it,
// are in flight
template <typename T>
__device__ __forceinline__ T walk_warp(const Args& a, const T* __restrict__ val,
                                       const T* __restrict__ c, T* buf, int b, int e,
                                       int lane) {
  T acc = T(0);
  int pos[kUnroll];
  T v[kUnroll], cv[kUnroll];
  fetch_pos(pos, a.perm, b + lane, e);
  fetch_terms(v, cv, pos, val, c, a.magic, a.shift);
  fetch_pos(pos, a.perm, b + kStage + lane, e);
  for (int base = b; base < e; base += kStage) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) buf[u * 32 + lane] = mul_rn(v[u], cv[u]);
    __syncwarp();
    fetch_terms(v, cv, pos, val, c, a.magic, a.shift);
    fetch_pos(pos, a.perm, base + 2 * kStage + lane, e);
    if (lane == 0) acc = add_staged<T, kStage>(acc, buf, min(kStage, e - base));
    __syncwarp();
  }
  return acc;
}

// one lane walks a run: kUnroll positions at a time, then their terms,
// then their adds in order
template <typename T>
__device__ __forceinline__ T walk_lane(const Args& a, const T* __restrict__ val,
                                       const T* __restrict__ c, int b, int e) {
  T acc = T(0);
  for (int base = b; base < e; base += kUnroll) {
    int pos[kUnroll];
    T v[kUnroll], cv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) pos[u] = base + u < e ? __ldg(a.perm + base + u) : -1;
    fetch_terms(v, cv, pos, val, c, a.magic, a.shift);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (base + u < e) acc = add_rn(acc, mul_rn(v[u], cv[u]));
  }
  return acc;
}

template <typename T>
__device__ __forceinline__ void light_block(const Args& a, const T* __restrict__ val,
                                            const T* __restrict__ c, T* __restrict__ out,
                                            unsigned char* smem) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int warps = (gridDim.x - a.heavy_blocks) * kWarps;
  const int gw = (blockIdx.x - a.heavy_blocks) * kWarps + wid;
  T* buf = reinterpret_cast<T*>(smem) + wid * kStage;
  const int* medium = a.order + a.n_heavy;
  for (int i = gw; i < a.n_medium; i += warps) {
    const int s = __ldg(medium + i);
    const T acc = walk_warp(a, val, c, buf, __ldg(a.starts + s), __ldg(a.starts + s + 1), lane);
    if (lane == 0) out[s] = acc;
  }
  // a lane's short runs i, i + stride, ...: while it walks one, the bounds
  // of the next and the slot of the one after are in flight, so a run
  // costs its two dependent loads (positions, then terms), not four
  const int* shortr = medium + a.n_medium;
  const int stride = warps * 32;
  const int i0 = gw * 32 + lane;
  int s = i0 < a.n_short ? __ldg(shortr + i0) : 0;
  int b = i0 < a.n_short ? __ldg(a.starts + s) : 0;
  int e = i0 < a.n_short ? __ldg(a.starts + s + 1) : 0;
  int s1 = i0 + stride < a.n_short ? __ldg(shortr + i0 + stride) : 0;
  for (int i = i0; i < a.n_short; i += stride) {
    const bool more = i + stride < a.n_short;
    const int b1 = more ? __ldg(a.starts + s1) : 0;
    const int e1 = more ? __ldg(a.starts + s1 + 1) : 0;
    const int s2 = i + 2 * stride < a.n_short ? __ldg(shortr + i + 2 * stride) : 0;
    out[s] = walk_lane(a, val, c, b, e);
    s = s1;
    b = b1;
    e = e1;
    s1 = s2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    linear_grad_kernel(Args a, const T* __restrict__ val, const T* __restrict__ c,
                       T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (static_cast<int>(blockIdx.x) < a.heavy_blocks)
    heavy_cluster(a, val, c, out, smem);
  else
    light_block(a, val, c, out, smem);
}

// the opt-in maximum of a block's shared memory on the current device
int heavy_smem(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(e);
}

template <typename T>
int launch(const Args& a, const void* val, const void* c, void* out, int blocks,
           cudaStream_t s) {
  int smem = kWarps * kStage * static_cast<int>(sizeof(T));
  if (a.heavy_blocks > 0) {
    const int need = 3 * kRing * 8 + kRing * kHeavyStage * static_cast<int>(sizeof(T));
    if (int rc = heavy_smem(&smem)) return rc;
    if (smem < need) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = cudaFuncSetAttribute(
        linear_grad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // with heavy runs, clusters of two blocks (the grid is even)
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 2;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = a.heavy_blocks > 0 ? 1 : 0;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, linear_grad_kernel<T>, a, static_cast<const T*>(val),
                         static_cast<const T*>(c), static_cast<T*>(out));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// dtype 0: float32, 1: float64. perm (n * width) int32, starts (dim + 1)
// int32, order (dim) int32, val (n * width) and c (n) of the dtype, out
// (dim) of the dtype. magic, shift: p / width as row_of computes it.
// n_heavy + n_medium <= dim; the grid is heavy_blocks (two a cluster; 0
// when n_heavy is 0) then light_blocks (0 only when every slot is heavy;
// even when there are heavy blocks).
extern "C" int alink_linear_grad(int dtype, const void* perm, const void* starts,
                                 const void* order, const void* val, const void* c, void* out,
                                 int dim, unsigned magic, int shift, int n_heavy, int n_medium,
                                 int heavy_blocks, int light_blocks, void* stream) {
  const bool heavy_ok = n_heavy == 0 ? heavy_blocks == 0
                                     : heavy_blocks > 0 && heavy_blocks % 2 == 0 &&
                                           heavy_blocks <= 2 * n_heavy && light_blocks % 2 == 0;
  const bool light_ok = light_blocks > 0 || n_heavy == dim;
  if (dim <= 0 || n_heavy < 0 || n_medium < 0 || n_heavy + n_medium > dim || !heavy_ok ||
      !light_ok || light_blocks < 0 || light_blocks > (1 << 24) || shift < 31 || shift > 62 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(perm), static_cast<const int*>(starts),
               static_cast<const int*>(order), magic, shift, n_heavy, n_medium,
               dim - n_heavy - n_medium, heavy_blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = heavy_blocks + light_blocks;
  return dtype == 0 ? launch<float>(a, val, c, out, blocks, s)
                    : launch<double>(a, val, c, out, blocks, s);
}

extern "C" int alink_linear_grad_warps() { return kWarps; }

extern "C" const char* alink_linear_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
