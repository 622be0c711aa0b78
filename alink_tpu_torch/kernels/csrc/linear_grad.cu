// The ordered keyed sums of linear training and of FTRL's batch step, for
// Hopper (sm_90a): one run walk, two sources of terms.
//
// What they replace: no TPU kernel.
//  * P1, the sparse gradient X^T c of a padded-COO or field-blocked design
//    (alink_tpu/operator/common/optim/objfunc.py::rmatvec, an XLA
//    scatter-add, and alink_tpu/ops/fieldblock.py::fb_rmatvec, a one-hot
//    product);
//  * P2, FTRL's batch update z.at[li].add(dz), n.at[li].add(dn)
//    (alink_tpu/operator/stream/onlinelearning/ftrl.py::
//    _ftrl_sparse_batch_step_factory, an XLA scatter-add).
// Both written because PyTorch's index_add_ adds with atomics on the card:
// two runs would not give the same bits.
//
// Contracts, bitwise (each add one rounded __fadd_rn / __dadd_rn, built with
// --fmad=false as well, so nothing contracts):
//  * P1 (kernels/linear.py::linear_grad_plain): grad[s] = the sum of
//    val[p] * c[p / width] over the flat positions p with key[p] == s, each
//    product rounded on its own (__fmul_rn / __dmul_rn), added in ascending
//    p (row, then column) from +0.0. The kernel writes only the slots that
//    positions name, into a vector the caller zeroed, so a slot no position
//    names is +0.0. That is what the JAX package's scatter-add and
//    index_add_ compute on the CPU.
//  * P2 (kernels/ftrl.py::scatter_add_rows_plain, the JAX package's
//    .at[].add): z[key[p]] += term[p, 0] and n[key[p]] += term[p, 1] for
//    every position p in ascending order, in place, both in one launch. A
//    slot no position names is never written, so it keeps its bits (a
//    stored -0.0 too).
//
// The plan, one for both (kernels/linear.py::run_plan, built on the card by
// csrc/run_plan.cu over the distinct keys of the positions: once a training
// for P1's design, once a micro-batch for FTRL's): perm, the positions
// stably sorted by key, so each run's positions are in ascending order;
// starts[r] .. starts[r + 1], run r in perm; slots[r], run r's key; order,
// the runs in three classes: the n_heavy runs of at least HEAVY_MIN terms
// and the n_medium runs of more than SHORT_MAX, each by length, longest
// first (ties by run), then the short rest by run; and counts, {runs,
// n_heavy, n_medium, n_short} in device memory, read by the kernels, so the
// host never waits for the plan. Runs are in key order.
//
// What bounds it: its longest run. With an intercept every row names slot
// 0, so its run is n dependent adds, one after the other, in one thread: n
// times the add's latency is the kernel's floor (about 0.43 ms in float32
// and 0.82 ms in float64 at n = 200,000 and 1980 MHz). P2 walks z's and
// n's chains of a run side by side in one thread, so the two cost about one
// chain. Everything else is short work in parallel, and its bytes bound is a
// few hundredths of that.
//
// Design: two launches of one walk, their grids from upper bounds of the
// positions (kernels/linear.py::launch_grid); a block with no work leaves.
//
// * Heavy clusters (two blocks a cluster) each walk heavy runs order[k],
//   order[k + clusters], ... They ask for the opt-in maximum of shared
//   memory, so each block holds an SM alone, and are launched first; the
//   light launch is their programmatic dependent on the same stream, so the
//   clusters are placed before the light blocks fill the SMs and the light
//   blocks run beside the walker (see launch).
//   Block 0's thread 0 is the walker: it only adds, reading staged terms
//   out of a shared-memory ring as 16-byte vectors a group of 32 floats
//   (16 doubles) ahead. Block 1's eight warps are the producers: they fetch
//   positions, then their terms (P1: the values and their rows' c, the row
//   by a multiply with a precomputed magic number; P2: the terms), form the
//   rounded products and store them into the walker's ring across the
//   cluster with st.async, whose bytes complete the slot's mbarrier, a
//   stage's term loads waiting for those of the stage two before it. Full
//   and empty slots are signalled with mbarriers, so neither side waits on
//   the other unless the ring is empty or full (see heavy_cluster).
// * Light blocks, at a small shared-memory size, as many an SM as fit, walk
//   every other run: a medium run by a warp (its lanes
//   fetch and stage 256 terms at a time, lane 0 adds them in order while
//   the next stage's loads are in flight), a short run by one lane, which
//   issues its run's loads 8 at a time before it adds them, the next run's
//   bounds already in flight. With no room for a heavy run (fewer than
//   HEAVY_MIN positions) they are the only launch.
//
// Nothing is atomic and the kernels allocate nothing.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <mutex>

namespace {

constexpr int kWarps = 8;                  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 8;                 // terms a lane fetches at a time
constexpr int kStage = 32 * kUnroll;       // a light warp's stage, in terms
constexpr int kRounds = 4;                 // a producer's rounds a slot
constexpr int kProducers = kWarps;         // the producers' block
constexpr int kRing = 2 * kProducers;      // slots; each producer owns two
constexpr int kDepth = 2;                  // stages whose term loads are in flight
static_assert(kProducers % kDepth == 0, "the fetch hand-off's phases stay in step");
// a heavy block's barriers: full, read and empty (kRing each) and fetched
// (kProducers), before the ring
constexpr int kHeavyBars = 3 * kRing + kProducers;

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

// -- the sources of terms ---------------------------------------------------
//
// A source says what a run's chains start from and where they go (init,
// store, by run), and what its term at a position is: load() issues the
// position's loads (a position of -1, past a run's end, loads nothing and
// gives 0), term() forms chain q's term from them. P chains a run, added
// side by side; a staged buffer holds a term's P values together.

// P1: one chain, from +0.0 into out[slots[r]]; the term
// val[p] * c[p / width]
template <typename T_>
struct GradTerms {
  using T = T_;
  static constexpr int P = 1;
  struct Raw {
    T v, c;
  };
  const T* __restrict__ val;
  const T* __restrict__ c;
  T* __restrict__ out;
  const int* __restrict__ slots;
  unsigned magic;
  int shift;
  __device__ __forceinline__ Raw load(int p) const {
    Raw r;
    r.v = p >= 0 ? __ldg(val + p) : T(0);
    r.c = p >= 0 ? __ldg(c + row_of(p, magic, shift)) : T(0);
    return r;
  }
  __device__ __forceinline__ T term(const Raw& r, int) const { return mul_rn(r.v, r.c); }
  __device__ __forceinline__ void init(T (&acc)[P], int) const { acc[0] = T(0); }
  __device__ __forceinline__ void store(const T (&acc)[P], int r) const {
    out[__ldg(slots + r)] = acc[0];
  }
};

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// P2: two chains, z's and n's, from z[slots[r]] and n[slots[r]] and back
// there; the terms at p are terms[2p] and terms[2p + 1], one 8- or 16-byte
// load
template <typename T_>
struct AddTerms {
  using T = T_;
  static constexpr int P = 2;
  using Raw = typename Pair<T>::type;
  const T* __restrict__ terms;
  T* z;
  T* n;
  const int* __restrict__ slots;
  __device__ __forceinline__ Raw load(int p) const {
    return p >= 0 ? __ldg(reinterpret_cast<const Raw*>(terms) + p) : Raw{T(0), T(0)};
  }
  __device__ __forceinline__ T term(const Raw& r, int q) const { return q == 0 ? r.x : r.y; }
  __device__ __forceinline__ void init(T (&acc)[P], int r) const {
    const int s = __ldg(slots + r);
    acc[0] = z[s];
    acc[1] = n[s];
  }
  __device__ __forceinline__ void store(const T (&acc)[P], int r) const {
    const int s = __ldg(slots + r);
    z[s] = acc[0];
    n[s] = acc[1];
  }
};

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

// 16-byte vectors of shared memory, added element by element, element e to
// chain e % P (a vector holds whole terms: 4 and 2 are multiples of P)
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  template <int P>
  __device__ __forceinline__ static void add(float (&a)[P], float4 v) {
    a[0] = chain_add(a[0], v.x);
    a[1 % P] = chain_add(a[1 % P], v.y);
    a[2 % P] = chain_add(a[2 % P], v.z);
    a[3 % P] = chain_add(a[3 % P], v.w);
  }
};
template <>
struct Vec<double> {
  using type = double2;
  template <int P>
  __device__ __forceinline__ static void add(double (&a)[P], double2 v) {
    a[0] = chain_add(a[0], v.x);
    a[1 % P] = chain_add(a[1 % P], v.y);
  }
};

// kUnroll consecutive-by-32 positions of a run from j0 (perm). Past the
// run's end a position is -1.
__device__ __forceinline__ void fetch_pos(int (&pos)[kUnroll], const int* __restrict__ perm,
                                          int j0, int end) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int j = j0 + u * 32;
    pos[u] = j < end ? __ldg(perm + j) : -1;
  }
}

// each position's loads
template <typename Src>
__device__ __forceinline__ void fetch_terms(typename Src::Raw (&raw)[kUnroll],
                                            const int (&pos)[kUnroll], const Src& src) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) raw[u] = src.load(pos[u]);
}

// The chains over cnt staged values (cnt / P terms), in order, of a buffer
// of cap values. The values come out of shared memory as 16-byte vectors,
// eight vectors (32 floats or 16 doubles: a group) at a time into two sets
// of registers in turn: one set is read while the other is added, so a
// read's latency stays off the chains, and nothing is moved between the two.
// Each read sits between the adds of one vector and the next, so no run of
// reads holds up the chains' issue. The read of the group after next is
// unconditional, clamped to the buffer's last group (whose values then go
// unused), so that no branch splits it from the adds it overlaps.
template <typename T, int P>
__device__ __forceinline__ void add_vecs(T (&acc)[P], const typename Vec<T>::type (&x)[8]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) Vec<T>::template add<P>(acc, x[q]);
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

// the adds of group x, each vector's after the read into y of the vector
// of the same place in group `group`
template <typename T, int P>
__device__ __forceinline__ void add_read_vecs(T (&acc)[P], const typename Vec<T>::type (&x)[8],
                                              typename Vec<T>::type (&y)[8], const T* buf,
                                              int group) {
  using V = typename Vec<T>::type;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    read_vec(y[q], reinterpret_cast<const V*>(buf) + group * 8 + q);
    Vec<T>::template add<P>(acc, x[q]);
  }
}

template <typename T, int P, int kCap>
__device__ __forceinline__ void add_staged(T (&acc)[P], const T* buf, int cnt) {
  using V = typename Vec<T>::type;
  constexpr int kGroup = 8 * static_cast<int>(sizeof(V) / sizeof(T));
  static_assert(kCap % kGroup == 0 && kGroup % P == 0, "a buffer holds whole groups");
  constexpr int kLast = kCap / kGroup - 1;
  const int groups = cnt / kGroup;
  V a[8], b[8];
  int g = 0;
  if (groups > 0) read_vecs<T>(a, buf, 0);
  for (; g + 2 <= groups; g += 2) {
    add_read_vecs<T, P>(acc, a, b, buf, g + 1);
    add_read_vecs<T, P>(acc, b, a, buf, min(g + 2, kLast));
  }
  if (g < groups) {
    add_vecs<T, P>(acc, a);
    ++g;
  }
  for (int k = g * kGroup; k < cnt; k += P) {
#pragma unroll
    for (int q = 0; q < P; ++q) acc[q] = add_rn(acc[q], buf[k + q]);
  }
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
// scope: this thread's earlier memory operations are ordered before the
// phase completes (the relay's hand-on of a slot the walker has read)
__device__ __forceinline__ void bar_arrive_at(unsigned cluster_addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                   cluster_addr)
               : "memory");
}

// arrive on one of this block's mbarriers and expect `bytes` more of
// asynchronous stores in the phase that arrival belongs to
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// an asynchronous store into the shared memory of a block of the cluster
// (either value type, one or two values), which completes its bytes on
// that block's mbarrier `bar`: no fence, and the mbarrier's phase makes
// the values visible to whoever waits on it
__device__ __forceinline__ void store_async(unsigned addr, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "f"(v), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void store_async(unsigned addr, double v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f64 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "d"(v), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void store_async(unsigned addr, float x, float y, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
          addr),
      "f"(x), "f"(y), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void store_async(unsigned addr, double x, double y, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f64 [%0], {%1, %2}, [%3];\n" ::"r"(
          addr),
      "d"(x), "d"(y), "r"(bar)
      : "memory");
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

// the plan (csrc/run_plan.cu); counts = {runs, n_heavy, n_medium,
// n_short}, read from device memory by every block; beside: the light
// blocks that work while heavy runs are walked (0: all of them)
struct Args {
  const int* perm;
  const int* starts;
  const int* order;
  const int* counts;
  int beside;
};

// the run the k-th entry of order names: its key's run s, and its positions
// perm[b .. e)
struct Run {
  int s, b, e;
};
__device__ __forceinline__ Run run_at(const Args& a, int k) {
  const int s = __ldg(a.order + k);
  return Run{s, __ldg(a.starts + s), __ldg(a.starts + s + 1)};
}

// a producer's rounds of kStage terms in a heavy stage: kRounds, so a
// stage is 1024 terms and its walker passes few stage boundaries (each
// costs it a barrier wait and a restart of its reads), but half that for
// P2 in float64, whose ring of 1024-term stages (256 KB) would not fit a
// block's shared memory
template <typename Src>
__host__ __device__ constexpr int heavy_rounds() {
  return Src::P == 2 && sizeof(typename Src::T) == 8 ? kRounds / 2 : kRounds;
}

// -- heavy clusters --------------------------------------------------------
//
// A heavy run is walked by a cluster of two blocks, each on an SM of its
// own. Block 0 (the walker's) holds the ring, kRing slots of a stage's
// values (heavy_rounds rounds of kStage terms, P values each), full[i] (1
// arrival, the walker's, which expects the slot's bytes of asynchronous
// stores: a phase completes when both
// have come) and read[i] (1 arrival: the walker); block 1 (the producers')
// holds empty[i] (1 arrival) and fetched[j] (1 arrival a stage producer j
// has fetched). Both blocks lay their shared memory out alike: full, read,
// empty, fetched, ring. Stage g of the cluster (its runs' stages
// counted in order) goes into slot g % kRing and is filled by producer warp
// g % kProducers; kRing is a multiple of kProducers, so a slot always has
// the same producer and each side sees its barriers' phases in order. The
// walker arrives on full[i] for a slot's first stage before the cluster's
// barrier, and for its next stage as soon as it has read one, before it
// frees the slot, so every stage's bytes find their phase expecting them.
// A producer stores a stage with st.async, each store completing its bytes
// on the walker's full[i]: no fence and no arrive on its side. It fetches
// its first stage while the barriers are set up.
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
template <typename Src>
__device__ __forceinline__ void heavy_cluster(const Args& a, const Src& src, unsigned char* smem) {
  using T = typename Src::T;
  constexpr int P = Src::P;
  constexpr int kRoundsP = heavy_rounds<Src>();   // a producer's rounds a slot
  constexpr int kHeavyStage = kRoundsP * kStage;  // a ring slot's terms
  constexpr int kSlot = kHeavyStage * P;          // and values
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* read = full + kRing;
  uint64_t* empty = read + kRing;
  uint64_t* fetched = empty + kRing;
  T* ring = reinterpret_cast<T*>(full + kHeavyBars);
  // the light launch may start once every heavy block is here
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int n_heavy = a.counts[1];
  const int cluster = blockIdx.x >> 1;
  const int clusters = gridDim.x >> 1;
  // the grid is an upper bound: a cluster with no heavy run leaves at
  // once, both blocks alike, before either touches the other
  if (cluster >= n_heavy) return;
  // the first run's bounds, loaded while the barriers are set up
  const Run first = run_at(a, cluster);
  const unsigned rank = cluster_rank();
  const int lane = threadIdx.x & 31;
  const unsigned j = threadIdx.x >> 5;
  // a producer's loads: every round's positions, then the first kAhead
  // rounds' terms, are fetched before its slot is free; each later round's
  // terms kAhead rounds ahead of their stores (all of a slot's rounds where
  // a term's loads are 8 bytes or less; two where registers would not hold
  // more). Past the run's end a term is 0 and goes unread. Stage g's terms
  // are fetched only once stage g - kDepth's are in (fetched[]; kDepth
  // divides kProducers, so a producer's next phase of fetched[] needs every
  // wait on its last one to have passed): a column's run (the intercept's)
  // loads a cache line a term, and all of a run's stages fetched at once
  // left its first stage waiting on the whole run's lines, so the walker
  // started late. Producer j's first stage, stage j of the first run, has
  // its positions fetched before the barriers, and producer 0 its terms
  // too, a head start on stage 1's.
  constexpr int kAhead = sizeof(typename Src::Raw) <= 8 ? kRoundsP : 2;
  int pos[kRoundsP][kUnroll];
  typename Src::Raw raw[kAhead][kUnroll];
  const bool early = rank == 1 && first.e - first.b > static_cast<int>(j) * kHeavyStage;
  if (early) {
    const int base = first.b + static_cast<int>(j) * kHeavyStage;
#pragma unroll
    for (int h = 0; h < kRoundsP; ++h) fetch_pos(pos[h], a.perm, base + h * kStage + lane, first.e);
    if (j == 0) {
#pragma unroll
      for (int h = 0; h < kAhead; ++h) fetch_terms(raw[h], pos[h], src);
    }
  }
  constexpr unsigned kSlotBytes = kSlot * sizeof(T);
  if (rank == 0 && threadIdx.x < 2 * kRing) bar_init(full + threadIdx.x, 1);  // full, read
  if (rank == 1 && threadIdx.x < kRing + kProducers) bar_init(empty + threadIdx.x, 1);  // empty, fetched
  if (threadIdx.x < (rank == 0 ? 2 * kRing : kRing + kProducers))
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  if (rank == 0 && threadIdx.x == 0)
    for (int i = 0; i < kRing; ++i) bar_expect(full + i, kSlotBytes);
  cluster_sync();
  if (rank == 0 && threadIdx.x == 0) {
    // the walker
    unsigned g = 0;
    for (int r = cluster; r < n_heavy; r += clusters) {
      const Run run = r == cluster ? first : run_at(a, r);
      const int s = run.s, b = run.b, e = run.e;
      T acc[P];
      src.init(acc, s);
      for (int base = b; base < e; base += kHeavyStage, ++g) {
        const unsigned slot = g % kRing;
        bar_wait(full + slot, (g / kRing) & 1u);
        add_staged<T, P, kSlot>(acc, ring + slot * kSlot, min(kHeavyStage, e - base) * P);
        bar_expect(full + slot, kSlotBytes);  // its stage g + kRing
        bar_arrive(read + slot);
      }
      src.store(acc, s);
    }
  } else if (rank == 0 && threadIdx.x == 32) {
    // the relay: the cluster's stages, then each slot read on to block 1
    // for the stages a producer refills
    unsigned stages = 0;
    for (int r = cluster; r < n_heavy; r += clusters) {
      const Run run = r == cluster ? first : run_at(a, r);
      stages += (run.e - run.b + kHeavyStage - 1) / kHeavyStage;
    }
    const unsigned empty_at = map_to(smem_addr(empty), 1);
    for (unsigned g = 0; g + kRing < stages; ++g) {
      const unsigned slot = g % kRing;
      bar_wait(read + slot, (g / kRing) & 1u);
      bar_arrive_at(empty_at + slot * 8);
    }
  } else if (rank == 1) {
    // a producer warp
    const unsigned full_at = map_to(smem_addr(full), 0);
    const unsigned ring_at = map_to(smem_addr(ring), 0) + lane * P * sizeof(T);
    unsigned g = 0;
    for (int r = cluster; r < n_heavy; r += clusters) {
      const Run run = r == cluster ? first : run_at(a, r);
      const int b = run.b, e = run.e;
      for (int base = b; base < e; base += kHeavyStage, ++g) {
        if (g % kProducers != j) continue;
        const unsigned slot = g % kRing;
        const unsigned dst = ring_at + slot * kSlotBytes;
        const unsigned bar = full_at + slot * 8;
        const bool prefetched = early && g == j;
        if (!prefetched) {
#pragma unroll
          for (int h = 0; h < kRoundsP; ++h)
            fetch_pos(pos[h], a.perm, base + h * kStage + lane, e);
        }
        if (!(prefetched && j == 0)) {
          if (g >= kDepth)
            bar_wait(fetched + (g - kDepth) % kProducers, ((g - kDepth) / kProducers) & 1u);
#pragma unroll
          for (int h = 0; h < kAhead; ++h) fetch_terms(raw[h], pos[h], src);
        }
        bar_wait(empty + slot, ((g / kRing) & 1u) ^ 1u);
#pragma unroll
        for (int h = 0; h < kRoundsP; ++h) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const unsigned at = dst + (h * kStage + u * 32) * P * sizeof(T);
            if constexpr (P == 2)
              store_async(at, src.term(raw[h % kAhead][u], 0), src.term(raw[h % kAhead][u], 1),
                          bar);
            else
              store_async(at, src.term(raw[h % kAhead][u], 0), bar);
          }
          if (h + kAhead < kRoundsP) fetch_terms(raw[h % kAhead], pos[h + kAhead], src);
        }
        // every lane's terms have come (its stores used them)
        __syncwarp();
        if (lane == 0) bar_arrive(fetched + j);
      }
    }
  }
}

// -- light blocks ----------------------------------------------------------

// one warp walks a run of any length onto acc: the lanes fetch kStage terms
// at a time and stage them; lane 0 adds them in order while the lanes'
// loads of the next stage's terms, and the positions of the one after it,
// are in flight
template <typename Src>
__device__ __forceinline__ void walk_warp(const Args& a, const Src& src, typename Src::T* buf,
                                          int b, int e, int lane,
                                          typename Src::T (&acc)[Src::P]) {
  using T = typename Src::T;
  constexpr int P = Src::P;
  int pos[kUnroll];
  typename Src::Raw raw[kUnroll];
  fetch_pos(pos, a.perm, b + lane, e);
  fetch_terms(raw, pos, src);
  fetch_pos(pos, a.perm, b + kStage + lane, e);
  for (int base = b; base < e; base += kStage) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int q = 0; q < P; ++q) buf[(u * 32 + lane) * P + q] = src.term(raw[u], q);
    __syncwarp();
    fetch_terms(raw, pos, src);
    fetch_pos(pos, a.perm, base + 2 * kStage + lane, e);
    if (lane == 0) add_staged<T, P, kStage * P>(acc, buf, min(kStage, e - base) * P);
    __syncwarp();
  }
}

// one lane walks a run onto acc: kUnroll positions at a time, then their
// terms, then their adds in order
template <typename Src>
__device__ __forceinline__ void walk_lane(const Args& a, const Src& src, int b, int e,
                                          typename Src::T (&acc)[Src::P]) {
  constexpr int P = Src::P;
  for (int base = b; base < e; base += kUnroll) {
    int pos[kUnroll];
    typename Src::Raw raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) pos[u] = base + u < e ? __ldg(a.perm + base + u) : -1;
    fetch_terms(raw, pos, src);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (base + u < e) {
#pragma unroll
        for (int q = 0; q < P; ++q) acc[q] = add_rn(acc[q], src.term(raw[u], q));
      }
  }
}

// a working light block's runs: warp gw of `warps` takes medium runs gw,
// gw + warps, ...; its lanes take short runs
template <typename Src>
__device__ __forceinline__ void light_runs(const Args& a, const Src& src, unsigned char* smem,
                                           int lane, int wid, int warps, int n_heavy,
                                           int n_medium, int n_short) {
  using T = typename Src::T;
  constexpr int P = Src::P;
  const int gw = blockIdx.x * kWarps + wid;
  T* buf = reinterpret_cast<T*>(smem) + wid * kStage * P;
  const int* medium = a.order + n_heavy;
  for (int i = gw; i < n_medium; i += warps) {
    const int s = __ldg(medium + i);
    T acc[P];
    src.init(acc, s);
    walk_warp(a, src, buf, __ldg(a.starts + s), __ldg(a.starts + s + 1), lane, acc);
    if (lane == 0) src.store(acc, s);
  }
  // a lane's short runs i, i + stride, ...: while it walks one, the bounds
  // of the next and the run of the one after are in flight, so a run costs
  // its two dependent loads (positions, then terms), not four
  const int* shortr = medium + n_medium;
  const int stride = warps * 32;
  const int i0 = gw * 32 + lane;
  int s = i0 < n_short ? __ldg(shortr + i0) : 0;
  int b = i0 < n_short ? __ldg(a.starts + s) : 0;
  int e = i0 < n_short ? __ldg(a.starts + s + 1) : 0;
  int s1 = i0 + stride < n_short ? __ldg(shortr + i0 + stride) : 0;
  for (int i = i0; i < n_short; i += stride) {
    const bool more = i + stride < n_short;
    const int b1 = more ? __ldg(a.starts + s1) : 0;
    const int e1 = more ? __ldg(a.starts + s1 + 1) : 0;
    const int s2 = i + 2 * stride < n_short ? __ldg(shortr + i + 2 * stride) : 0;
    T acc[P];
    src.init(acc, s);
    walk_lane(a, src, b, e, acc);
    src.store(acc, s);
    s = s1;
    b = b1;
    e = e1;
    s1 = s2;
  }
}

template <typename Src>
__device__ __forceinline__ void light_block(const Args& a, const Src& src, unsigned char* smem) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int n_heavy = a.counts[1], n_medium = a.counts[2], n_short = a.counts[3];
  // beside a heavy walk only the first `beside` blocks work, about one an
  // SM: more light warps slowed the walk's producers (their loads share the
  // memory system); with no heavy run every block works. The others leave
  // at once, so the blocks still to be placed are not held up.
  const int workers =
      n_heavy > 0 && a.beside > 0 ? min(static_cast<int>(gridDim.x), a.beside) : gridDim.x;
  if (static_cast<int>(blockIdx.x) >= workers) return;
  light_runs(a, src, smem, lane, wid, workers * kWarps, n_heavy, n_medium, n_short);
  // launched as the heavy launch's dependent: end after it (see launch)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// P1's kernels and P2's: the heavy clusters and the light blocks, two
// launches of one walk, named apart for the profiler
template <typename T>
__global__ void __launch_bounds__(kThreads) linear_grad_heavy_kernel(Args a, GradTerms<T> src) {
  extern __shared__ __align__(16) unsigned char smem[];
  heavy_cluster(a, src, smem);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) linear_grad_light_kernel(Args a, GradTerms<T> src) {
  extern __shared__ __align__(16) unsigned char smem[];
  light_block(a, src, smem);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) scatter_walk_heavy_kernel(Args a, AddTerms<T> src) {
  extern __shared__ __align__(16) unsigned char smem[];
  heavy_cluster(a, src, smem);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) scatter_walk_light_kernel(Args a, AddTerms<T> src) {
  extern __shared__ __align__(16) unsigned char smem[];
  light_block(a, src, smem);
}

// A device's launch settings, found at its first launch with heavy blocks:
// the opt-in maximum of a block's shared memory (set on the heavy kernels
// once) and the SM count
constexpr int kMaxDevices = 64;
struct Device {
  bool ready = false;
  int smem = 0, sms = 0;
};
Device g_device[kMaxDevices];
std::mutex g_device_mu;

int device_setup(Device& d, int device) {
  cudaError_t e = cudaDeviceGetAttribute(&d.smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, device);
  const void* heavy[] = {reinterpret_cast<const void*>(linear_grad_heavy_kernel<float>),
                         reinterpret_cast<const void*>(linear_grad_heavy_kernel<double>),
                         reinterpret_cast<const void*>(scatter_walk_heavy_kernel<float>),
                         reinterpret_cast<const void*>(scatter_walk_heavy_kernel<double>)};
  for (const void* k : heavy)
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, d.smem);
  if (e == cudaSuccess) d.ready = true;
  return static_cast<int>(e);
}

// The walk: with heavy blocks, the heavy clusters (the opt-in maximum of
// shared memory, so each block holds an SM alone), then the light blocks
// as their programmatic dependent on the same stream: the light launch
// starts once every heavy block has started (griddepcontrol.launch_
// dependents, its first instruction) or left, so the clusters are placed
// before the light blocks fill the SMs, and the two run side by side. A
// working light block ends with griddepcontrol.wait, so the light launch
// completes after the heavy one and the stream's next work waits for
// both. When the plan has heavy runs, one light block an SM works
// (Args::beside) and the others leave at once. Without heavy blocks, the
// light blocks alone (their wait returns at once).
template <typename Src>
int launch(void (*heavy)(Args, Src), void (*light)(Args, Src), Args a, const Src& src,
           int device, int heavy_blocks, int light_blocks, cudaStream_t s) {
  using T = typename Src::T;
  const int light_smem = kWarps * kStage * Src::P * static_cast<int>(sizeof(T));
  if (heavy_blocks == 0) {
    light<<<light_blocks, kThreads, light_smem, s>>>(a, src);
    return static_cast<int>(cudaGetLastError());
  }
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int smem = 0, sms = 0;
  {
    std::lock_guard<std::mutex> lock(g_device_mu);
    Device& d = g_device[device];
    if (!d.ready)
      if (int rc = device_setup(d, device)) return rc;
    smem = d.smem;
    sms = d.sms;
  }
  const int need =
      kHeavyBars * 8 + kRing * heavy_rounds<Src>() * kStage * Src::P * static_cast<int>(sizeof(T));
  if (smem < need) return static_cast<int>(cudaErrorInvalidValue);
  a.beside = std::max(1, sms - 2);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 2;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(heavy_blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, heavy, a, src);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute dependent;
  dependent.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent.val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3(light_blocks);
  cfg.dynamicSmemBytes = light_smem;
  cfg.attrs = &dependent;
  e = cudaLaunchKernelEx(&cfg, light, a, src);
  return static_cast<int>(e);
}

// the checks both entry points make of a grid: heavy blocks two a cluster
// (0: no heavy launch), at least one light block
bool grid_ok(int heavy_blocks, int light_blocks) {
  return heavy_blocks >= 0 && heavy_blocks % 2 == 0 && light_blocks > 0 &&
         light_blocks <= (1 << 24);
}

}  // namespace

// P1. device: the current CUDA device; dtype 0: float32, 1: float64. perm,
// starts, order, slots and counts (runs, n_heavy, n_medium, n_short) the
// plan of csrc/run_plan.cu over the n * width positions; val (n * width)
// and c (n) of the dtype, out of the dtype, zeroed by the caller: each run
// is stored at its slot. magic, shift: p / width as row_of computes it.
// The grid, from upper bounds: heavy_blocks (two a cluster; 0 when no run
// can be heavy) and light_blocks (at least 1).
extern "C" int alink_linear_grad(int device, int dtype, const void* perm, const void* starts,
                                 const void* order, const void* slots, const void* counts,
                                 const void* val, const void* c, void* out, unsigned magic,
                                 int shift, int heavy_blocks, int light_blocks, void* stream) {
  if (!grid_ok(heavy_blocks, light_blocks) || shift < 31 || shift > 62 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(perm), static_cast<const int*>(starts),
               static_cast<const int*>(order), static_cast<const int*>(counts), 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sl = static_cast<const int*>(slots);
  if (dtype == 0)
    return launch(linear_grad_heavy_kernel<float>, linear_grad_light_kernel<float>, a,
                  GradTerms<float>{static_cast<const float*>(val), static_cast<const float*>(c),
                                   static_cast<float*>(out), sl, magic, shift},
                  device, heavy_blocks, light_blocks, s);
  return launch(linear_grad_heavy_kernel<double>, linear_grad_light_kernel<double>, a,
                GradTerms<double>{static_cast<const double*>(val), static_cast<const double*>(c),
                                  static_cast<double*>(out), sl, magic, shift},
                device, heavy_blocks, light_blocks, s);
}

// P2. device and dtype as for P1. The plan as for P1, over the M positions;
// terms (M, 2) of the dtype, aligned to a pair, z and n the states, updated
// in place. The grid as for P1.
extern "C" int alink_scatter_walk(int device, int dtype, const void* perm, const void* starts,
                                  const void* order, const void* slots, const void* counts,
                                  const void* terms, void* z, void* n, int heavy_blocks,
                                  int light_blocks, void* stream) {
  if (!grid_ok(heavy_blocks, light_blocks) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(perm), static_cast<const int*>(starts),
               static_cast<const int*>(order), static_cast<const int*>(counts), 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sl = static_cast<const int*>(slots);
  if (dtype == 0)
    return launch(scatter_walk_heavy_kernel<float>, scatter_walk_light_kernel<float>, a,
                  AddTerms<float>{static_cast<const float*>(terms), static_cast<float*>(z),
                                  static_cast<float*>(n), sl},
                  device, heavy_blocks, light_blocks, s);
  return launch(scatter_walk_heavy_kernel<double>, scatter_walk_light_kernel<double>, a,
                AddTerms<double>{static_cast<const double*>(terms), static_cast<double*>(z),
                                 static_cast<double*>(n), sl},
                device, heavy_blocks, light_blocks, s);
}

extern "C" int alink_linear_grad_warps() { return kWarps; }

extern "C" const char* alink_linear_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
