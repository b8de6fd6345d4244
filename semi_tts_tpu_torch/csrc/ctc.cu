// K6: CTC over the log-semiring lattice, a CTA of chain warps a row (past
// 1,024 states, a cluster of them; past 49,152, a chain of clusters).
//
// Replaces: B5, `semi_tts_tpu/ops/ctc.py`: `_alpha_pass` (`:63`, the
// forward recursion and the NLL), `_ctc_nll_bwd` (`:123`, the backward
// recursion, the occupancies and the one-hot gradient einsum) and
// `_logaddexp3` (`:34`). The lattice is z = (blank, y1, blank, ..., blank),
// S = 2U + 1 states; the skip s-2 -> s is allowed into label states whose
// label differs from the one two back; states past 2*target_len are dead.
//
// ctc_alpha: alphas (T, B, S) and nll (B,). Rows freeze past their input
//   length (alpha_t = alpha_{t-1}); nll = -logaddexp(alpha[2L], alpha[2L-1]).
// ctc_beta_grad: one kernel. beta_t = term for t >= input_len - 1, else the
//   three-way log-add of the next step's (beta + emit); the occupancy
//   exp(min(alpha + beta + nll, 0)) of each valid state; grad[b, t, c] =
//   -g[b] * the sum over the valid states s with z_s = c of the occupancy,
//   zero at t >= input_len and for rows with nll >= 5e29 (an impossible
//   alignment: P = 0).
//
// Every edge of the JAX version is kept: the -1e30 sentinel, the 1e-37
// clamp inside the log-add (a dead branch must not poison the sum), target
// length 0 (only the blank path), T = 1 (alphas are the first step; beta is
// the terminal vector). The arithmetic is the plain version's, operation for
// operation (accurate expf and logf), so the alphas match it bit for bit even
// where they reach thousands and an fp32 ulp is above the check's 1e-4.
//
// What bounds it on an H100: the latency of the chain. The bytes (log_probs
// once, alphas written and read back, the gradient) are ~1 MB at the
// flagship shapes (B=8, T=133, C=43, S=65), a fraction of a microsecond; the
// T steps depend on each other, and a step is one three-way log-add per
// state: ~45 dependent instructions through three accurate expf and a logf
// (`chip_ablate.py` times the chain with nothing else in its step). A step
// can cost no less, and the design keeps everything else off it:
//
// - A state a thread (two past 512 states), the row's states over up to 16
//   chain warps that run in parallel on the SM's schedulers. A thread's
//   s-1 and s-2 (backward: s+1 and s+2) come from the lattice of the last
//   two steps in shared memory, double-buffered, so one named barrier of
//   the chain warps a step is race-free (in ctc_alpha those are all of the
//   CTA's warps; ctc_beta_grad's class-sum warps are not in it). Timed
//   whole, the barrier costs nothing measurable; one warp a row with several
//   states a lane linked by shuffles, and chain warps handing their edge
//   states to the next by tagged words with no barrier, are 1.6-1.9x slower
//   (`chip_ablate.py` keeps both as whole-kernel variants).
// - Emissions (backward, also the alphas) are gathered per state, S values
//   a step and not C, in register chunks of steps loaded a chunk ahead: no
//   step waits on a global load, and nothing grows with C or T. A chunk
//   holds 8 steps, backward 8 / K, so that a thread's two chunks of
//   emissions and two of alphas fit its registers beside the class-sum
//   warps without a spill.
// - ctc_beta_grad writes each chunk's log occupancies alpha + beta + nll
//   into a ring of kDepth slots in shared memory, handed to 8 class-sum
//   warps by an mbarrier a slot (each step's a step late, past the next
//   barrier). Those sort the valid states by (class, s) once (bitonic) and
//   cut each class's run of sorted states at every multiple of kSeg into
//   segments. A chunk is summed in two passes: a warp a block of 32 sorted
//   states, a lane a state, takes the exp of its occupancies at the chunk's
//   steps and sums each segment by shuffles in a fixed order; then a thread
//   a (run, step) adds its segments' sums in order into grad[b, t, class].
//   No thread's serial sum grows with S (the blank class holds half the
//   states); the rest of the row is zero. No (T, B, S) scratch, no second
//   launch, no atomics: a rerun is bit for bit.
// - K states a lane, K in {1, 2}: up to 32 * 2 * 16 = 1,024 states. A
//   forward chunk holds min(8, 16 / K) steps, a backward one 8 / K, so that
//   a thread's chunks stay at 16 values; past 2 states a lane (the cluster
//   route's slices) the sort's keys can outgrow a chunk's segment sums and
//   their region grows to hold them.
//
// Past 1,024 states, the cluster route (`ctc_alpha_cluster_f32`,
// `ctc_beta_grad_cluster_f32`), which `chip_ablate.py --ctc-long` times
// faster there than this route at 4 and 8 states a lane (those are gone) at
// every row count it sweeps: a thread-block cluster of P CTAs a row (up to
// 16, non-portable past 8), CTA p holding the slice of 32 K W states from p
// * 32 K W, K = 2, 4 or 8 states a lane in up to 12 warps: 49,152 states at
// 16 CTAs. Each CTA
// runs the chain above on its slice (the same code, `alpha_chain`/
// `beta_grad` with Split): its lanes' states stay in registers, their
// neighbours come from its lattice under the named barrier. Only a slice's
// edge crosses CTAs: forward, its top two states of each step go into CTA
// p + 1's shared memory (backward, the bottom two x go down to CTA p - 1),
// by an `st.async` whose bytes complete that slot's mbarrier, through a
// ring of kEdgeRing slots that the receiver hands back with an `st.async`
// onto the sender's "empty" mbarrier of the slot. Only the warp at the
// edge waits, and no step waits on a cluster barrier: information flows
// one way, so CTA p - 1 runs up to kEdgeRing steps ahead of CTA p and a
// hand-off's latency is paid once over the row, not once a step. No
// hand-off fences: a release (a remote `mbarrier.arrive.release.cluster`
// after a plain remote store, the first design) waits for the thread's
// stores of alphas to device memory, and cost ~0.33 us a step of ~0.8
// (`chip_ablate.py --ctc-long`).
// A chain thread's own K neighbouring states, stored by it, spread a warp's
// store of a step over 4K sectors (32 at K = 8): at 4 and 8 states a lane a
// copy warp beside the chain warps stores each step's lattice instead, a
// coalesced row, after the step's barrier (which it joins: the lattice of
// step t is kept until the barrier of step t + 1). The backward's alphas,
// which only the occupancies need, come into a ring beside the occupancy
// ring by 4-byte asynchronous copies, a coalesced row a step, whose
// completion arrives on the slot's "full" mbarrier: no chain registers hold
// them (at 8 states a lane, 16 of them spilled the chain at the 96
// registers that 20 warps leave), and the class-sum warps add alpha + beta +
// nll in the plain version's order.
// Each CTA's class-sum warps sum the occupancies of its slice as above into
// a (B, P, T, C) scratch of partial sums; after the one cluster barrier at
// the end, grad[b, t, c] = -g[b] times their sum in rank order. No
// (T, B, S) scratch, no atomics: a rerun is bit for bit.
//
// Past a cluster's 16 x 32 x 8 x 12 = 49,152 states, the chained route
// (`ctc_alpha_chain_f32`, `ctc_beta_grad_chain_f32`; it replaced a CTA a row
// whose lattice went through device memory each step, ~36 us a step): Q
// clusters of P CTAs a row, each running the cluster route's CTA body on
// its slices (`alpha_chain`/`beta_grad` with Chain) at 2 states a lane,
// any S. (`chip_ablate.py --ctc-long --wide` swept 2, 4 and 8 states a lane
// at B = 2, 8, 16: 2 was fastest, or within 18% of the fastest where every
// cluster ran its chain, and 4 and 8 lost up to 3x with the rows' targets.)
// A cluster takes a ticket from an atomic counter as it starts; ticket i is
// cluster i / B of row i % B forward (backward: the clusters in reverse
// order), so a cluster waits only on one that holds a lower ticket, which
// runs or has run: nothing need be resident at once, and B x Q clusters past
// the card run in waves. Consecutive clusters of a row hand on their edge
// (forward: the top two alphas of a step; backward: the bottom two x)
// through a (T) array in device memory written once a step (no ring: its
// writer never waits), its flag released at gpu scope every 8 steps; a link
// warp of the receiving CTA acquires the flag and copies the steps into a
// second edge ring of its shared memory, so that the chain warp at the end
// reads the link as it reads an edge. A cluster wholly past the row's 2 tl +
// 1 valid states writes -inf alphas and runs no chain (backward: does
// nothing), so a row pays for the lattice its targets reach, as F.ctc_loss
// does. Each CTA's class sums go into a (B, Q P, T, C) scratch; the row's
// last cluster (a per-row counter) adds them in slice order. The ticket
// counter, the per-row counts and the links' flags are a launch's own
// scratch, zeroed by its caller for each launch (and each graph replay), so
// that two launches share nothing. No atomics on values: a rerun is bit for
// bit.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kChunk = 8;            // values a register chunk holds a state; backward kChunk / K (CHUNK)
constexpr int kMaxChainWarps = 16;   // warps that carry a row's chain (MAX_CHAIN_WARPS)
constexpr int kConsumerWarps = 8;    // ctc_beta_grad's class-sum warps (CONSUMER_WARPS)
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kDepth = 4;            // occupancy ring slots, chunks (DEPTH)
constexpr int kSeg = 8;              // sorted states a class-sum segment adds at most (SEG)
// a sorted state's ring position (bits 0-15) | its segment (bits 16-29) |
// kHead where the segment starts
constexpr int kHead = 1 << 30;
constexpr int kSmemLimit = 232448;   // H100: dynamic shared memory a block may use
constexpr int kMaxCluster = 16;      // the cluster route's CTAs a row (MAX_CLUSTER)
constexpr int kPortableCluster = 8;  // past this, a non-portable cluster (PORTABLE_CLUSTER)
constexpr int kMaxClusterWarps = 12; // its chain warps at most (MAX_CLUSTER_WARPS)
constexpr int kEdgeRing = 8;         // edge slots between neighbouring CTAs (EDGE_RING)
// The cluster route's forward at K >= 4 states a lane has a copy warp beside
// its chain warps, which stores each step's alphas from the lattice, a
// coalesced row (a chain thread's own K neighbouring states, stored by it,
// spread a warp's stores over 4K sectors each)
__host__ __device__ constexpr bool copy_warp(int K, bool Split) { return Split && K >= 4; }
// the edge's full and empty mbarriers, its slots of two floats and their
// acknowledgements' words (EDGE_BYTES)
constexpr size_t kEdgeBytes = 28 * kEdgeRing;
// The chained route (past a cluster's states): a link warp beside the rest
// copies the link from the cluster below into a second edge ring (LINK_BYTES:
// the ring and the cluster's ticket); the link's flag is published every
// kLinkEvery steps (LINK_EVERY) and at its last step
constexpr size_t kLinkBytes = kEdgeBytes + 16;
constexpr int kLinkEvery = 8;

// Steps a forward register chunk holds at K states a lane (CHUNK at K <= 2).
__host__ __device__ constexpr int fwd_chunk(int K) { return K <= 2 ? kChunk : 16 / K; }

// Shared bytes at K states a lane and W chain warps; kernels/ctc.py
// `_alpha_smem`/`_beta_smem` are the same formulas. Both hold the lattice of
// the last two steps, each with four -inf guard cells (below state 0
// forward, above the last state backward).
__host__ __device__ constexpr int lattice_floats(int K, int W) { return 2 * (32 * K * W + 4); }
constexpr size_t alpha_smem(int K, int W) { return 4 * (size_t)lattice_floats(K, W); }
__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

// The segment sums' region in floats: a chunk's sums (32 K W, kChunk / K),
// or the sort's keys of 8 bytes, 32 K W rounded up to a power of two, where
// those are more (K = 4, 8).
__host__ __device__ constexpr int part_floats(int K, int W) {
  return 32 * W * kChunk > 2 * pow2_at_least(32 * K * W) ? 32 * W * kChunk
                                                         : 2 * pow2_at_least(32 * K * W);
}
// A ring of kDepth chunks of a value a state a step (CH K = kChunk).
__host__ __device__ constexpr int ring_floats(int W) { return 32 * W * kDepth * kChunk; }
constexpr size_t beta_smem(int K, int W) {
  // the occupancy ring's full and empty mbarriers and the count of class
  // runs; the lattice; the occupancy ring (kDepth, kChunk / K,
  // K, 32 W); four lists of 32 K W ints (segment starts, sorted classes,
  // sorted positions, runs' first segments); the segments' sums of a chunk
  // (32 K W, kChunk / K), which first hold the sort's keys
  return 16 * kDepth + 16 +
         4 * ((size_t)lattice_floats(K, W) + (size_t)32 * W * kDepth * kChunk +
              (size_t)part_floats(K, W) + (size_t)4 * 32 * K * W);
}

// p ? x : y. The kernels' selects go through this call: written inline as
// conditional expressions they compiled to a slower chain.
__device__ __forceinline__ float sel(bool p, float x, float y) { return p ? x : y; }

// *g = v where p, without a branch; EvictFirst: a streaming store (`.cs`),
// for outputs that no later step of the kernel reads.
template <bool EvictFirst = false>
__device__ __forceinline__ void st_if(bool p, float* g, float v) {
  if constexpr (EvictFirst)
    asm volatile("{\n .reg .pred q;\n setp.ne.s32 q, %2, 0;\n @q st.global.cs.f32 [%0], %1;\n}\n" ::"l"(
                     g),
                 "f"(v), "r"((int)p));
  else
    asm volatile("{\n .reg .pred q;\n setp.ne.s32 q, %2, 0;\n @q st.global.f32 [%0], %1;\n}\n" ::"l"(g),
                 "f"(v), "r"((int)p));
}

__device__ __forceinline__ float logaddexp3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const bool dead = m <= kNegInf / 2;
  const float ms = sel(dead, 0.0f, m);
  const float s = expf(a - ms) + expf(b - ms) + expf(c - ms);
  return sel(dead, kNegInf, ms + logf(fmaxf(s, 1e-37f)));
}

// Extended label of state s (blank at even states).
__device__ __forceinline__ int label(const int* tgt, int s, int blank) {
  return (s & 1) ? tgt[(s - 1) >> 1] : blank;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// An asynchronous copy of 4 bytes from device memory to shared address dst.
__device__ __forceinline__ void cp_async4(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// An arrival on the mbarrier `bar`, one of its expected ones, made once this
// thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Cluster: acquire at cluster scope, for phases that peers' asynchronous
// stores complete (what they stored is then visible), and polled by
// test_wait, which never suspends the warp: on the cluster route's edge,
// where a warp waits every step, a suspending try_wait cost 6-7% of the
// forward's step (`chip_ablate.py --ctc-long`).
template <bool Cluster = false>
__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  if constexpr (Cluster)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.test_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  else
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, 1000000;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` of the mbarrier has completed. A
// wait of more than 2 s traps, so a lost hand-off fails the launch instead
// of hanging the card.
template <bool Cluster = false>
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  if (mbar_try_wait<Cluster>(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait<Cluster>(bar, parity))
    if (global_ns() - t0 > 2000000000ull) __trap();
}

// ------------------------------------------------ a cluster's edge hand-off --

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return (int)n;
}

// Every thread of the cluster: what it wrote before (shared or global
// memory) is visible to every thread of the cluster after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// The address in CTA `rank` of the cluster of this CTA's shared address a.
__device__ __forceinline__ unsigned map_rank(unsigned a, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(a), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// An asynchronous store of two floats (one: st_async1) into a peer's shared
// memory, `dst` in the cluster's window, whose bytes complete the peer's
// mbarrier `bar` (in the window). It fences nothing: it does not wait for
// this thread's earlier stores to device memory, as a release would.
__device__ __forceinline__ void st_async2(unsigned dst, float lo, float hi, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
          dst),
      "f"(lo), "f"(hi), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async1(unsigned dst, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(
                   dst),
               "f"(v), "r"(bar)
               : "memory");
}

// ------------------------------------------------ the chained route's links --

// The chained route's counters, a launch's own `sync` scratch of 1 + B Q
// words that its caller zeroes for each launch (kernels/ctc.py; a memset
// node in a CUDA graph): the clusters' ticket counter, then the per-row count
// of clusters whose class sums are in (backward), then each link's flag, the
// step count published so far ((B, Q - 1) of them). Nothing is reset by the
// kernel, so launches on different streams share nothing.
__device__ __forceinline__ unsigned* chain_rows(unsigned* sync) { return sync + 1; }
__device__ __forceinline__ unsigned* chain_flags(unsigned* sync, int B, int b, int Q) {
  return sync + 1 + B + (size_t)b * (Q - 1);
}

__device__ __forceinline__ void st_release_gpu(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A 32-bit word in the shared memory of CTA `rank` of the cluster.
__device__ __forceinline__ unsigned ld_cluster_u32(unsigned a, int rank) {
  unsigned v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(map_rank(a, rank)) : "memory");
  return v;
}

__device__ __forceinline__ void st_cluster_u32(unsigned a, int rank, unsigned v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(map_rank(a, rank)), "r"(v) : "memory");
}

// The chained route's start, every thread of the cluster: CTA 0's thread 0
// takes the cluster's ticket (the counter `tickets`, 0 at the launch) into
// `tk`, a word of its shared memory; after the cluster barrier (which also
// publishes the edges' mbarriers, set before it) every CTA reads it, and a
// second barrier keeps CTA 0 until they have.
__device__ __forceinline__ unsigned chain_ticket(unsigned* tickets, unsigned tk) {
  if (threadIdx.x == 0 && cluster_rank() == 0) {
    const unsigned t = atomicAdd(tickets, 1u);
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(tk), "r"(t) : "memory");
  }
  cluster_sync();
  const unsigned t = ld_cluster_u32(tk, 0);
  cluster_sync();
  return t;
}

// The link between the row's clusters q and q + 1 at its writer's end: step
// e's two floats into the (T) array `row` (a plain store), the flag released
// at gpu scope every kLinkEvery steps and at the last (`last`), so that the
// reader that acquires it sees the floats. One thread; nothing waits.
__device__ __forceinline__ void link_put(float2* row, unsigned* flag, int e, float lo, float hi,
                                         bool last) {
  row[e] = make_float2(lo, hi);
  if (last || (e + 1) % kLinkEvery == 0) st_release_gpu(flag, (unsigned)e + 1);
}

// A CTA's two ends of the chain of a row's CTAs. It receives the edge of
// CTA `from` (two floats a step) into the slots of its own ring and sends
// its own edge into the ring of CTA `to` (-1: none), each by `st.async`. At
// `base` in its shared memory: kEdgeRing "full" mbarriers (a slot's two
// floats have landed), kEdgeRing "empty" ones (the receiver has read what
// this CTA last sent into that slot), the slots, and a word a slot that
// the receiver's acknowledgement lands in. Step e uses slot e % kEdgeRing;
// the sender runs up to kEdgeRing steps ahead of the receiver and waits
// only when it is that far. Each mbarrier takes one arrival a phase, its
// owner's, with the bytes it expects (`mbar_expect_tx`), armed for a phase
// once the last has completed.
struct Edge {
  unsigned base;
  int to, from;

  __device__ unsigned full(int i) const { return base + 8 * i; }
  __device__ unsigned empty(int i) const { return base + 8 * (kEdgeRing + i); }
  __device__ unsigned slot(int i) const { return base + 8 * (2 * kEdgeRing + i); }
  __device__ unsigned ack(int i) const { return base + 24 * kEdgeRing + 4 * i; }

  // One thread: the mbarriers, armed for their first phase and visible to
  // the cluster (a cluster_sync must follow before any hand-off).
  __device__ void init() const {
    for (int i = 0; i < kEdgeRing; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < kEdgeRing; ++i) {
      mbar_expect_tx(full(i), 8);
      mbar_expect_tx(empty(i), 4);
    }
  }

  // Step e's edge (lo, hi) into CTA `to`'s slot. A whole warp calls (the
  // warp waits for the slot, ROADMAP C6); lane `src` holds the values.
  __device__ void send(int e, int src, float lo, float hi) const {
    const int i = e % kEdgeRing, r = e / kEdgeRing;
    if (r > 0) mbar_wait<true>(empty(i), (r - 1) & 1);  // what round r - 1 sent was read
    if ((threadIdx.x & 31) == src) {
      if (r > 0) mbar_expect_tx(empty(i), 4);  // round r's acknowledgement
      st_async2(map_rank(slot(i), to), lo, hi, map_rank(full(i), to));
    }
  }

  // Step e's edge from CTA `from`: a whole warp waits for it; lane `dst`
  // reads it (the other lanes get -inf), arms the slot for its next round
  // and acknowledges it. The acknowledgement's word is a value just read,
  // so it cannot leave before the read.
  __device__ float2 recv(int e, int dst) const {
    const int i = e % kEdgeRing;
    mbar_wait<true>(full(i), (e / kEdgeRing) & 1);
    float2 v = make_float2(kNegInf, kNegInf);
    if ((threadIdx.x & 31) == dst) {
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(slot(i))
                   : "memory");
      mbar_expect_tx(full(i), 8);
      st_async1(map_rank(ack(i), from), v.x, map_rank(empty(i), from));
    }
    return v;
  }
};

// The link warp of the chained route's CTA at a cluster's lower end
// (backward: upper): steps 0 .. n - 1 of the (T) link array `row`, each
// once its flag says the writer has published it (acquired at gpu scope,
// polled by lane 0; a wait of more than 2 s traps), sent into this CTA's own
// ring `lk` as a peer's edge would be, so that the chain warp at the end
// reads the link as it reads an edge.
__device__ __forceinline__ void link_get(const Edge& lk, const float2* row, unsigned* flag, int n) {
  const int lane = threadIdx.x & 31;
  unsigned seen = 0;
  for (int e = 0; e < n; ++e) {
    if (seen < (unsigned)e + 1) {
      unsigned long long t0 = 0;
      for (;;) {
        unsigned v = lane == 0 ? ld_acquire_gpu(flag) : 0u;
        seen = __shfl_sync(0xffffffffu, v, 0);
        if (seen >= (unsigned)e + 1) break;
        if (t0 == 0) t0 = global_ns();
        else if (global_ns() - t0 > 2000000000ull) __trap();
      }
    }
    float2 v = make_float2(kNegInf, kNegInf);
    if (lane == 0) v = __ldcg(row + e);
    lk.send(e, 0, v.x, v.y);
  }
}

// A chunk of CH steps of this thread's emissions (and, backward, alphas),
// loaded into registers a chunk ahead of the chain: no step waits on a
// global load.
template <int CH, int K>
struct Chunk {
  float v[CH][K];
};

// The forward chain over a slice of a row: the whole row in a CTA (Split
// false, the shared-memory route), or in the cluster route the slice of CTA
// `rank` of the row's cluster of P, states s0 = rank * 32 K W on. Lane L =
// threadIdx.x of its W = blockDim.x / 32 chain warps holds states s0 + L*K ..
// s0 + L*K+K-1. Shared memory: the lattice of the last two steps, (2, 32 K W
// + 4) floats, state s0 + s of step t at (t & 1, 2 + s) with -inf at 0 and 1
// (below the slice); in a cluster, then its `Edge`: each step's top two
// states of the slice go up to CTA rank + 1, whose lane 0 takes them as its
// s - 1 and s - 2 in place of those guards.
//
// Chained (Chain true, past a cluster's states): the row's states over Q
// clusters of P CTAs, the cluster that takes ticket i (`chain_ticket`, in the
// order clusters start) cluster q = i / B of row b = i % B, its CTA `rank`
// the slice from (q P + rank) 32 K W. Between clusters q and q + 1 of a row
// the link (`link` (B, Q - 1, T) float2, its flag in `sync`): CTA P - 1 of cluster q writes its
// top two states of each step there (`link_put`), and the link warp (the
// CTA's last) of CTA 0 of cluster q + 1 copies them into a second ring
// (`link_get`), from which its warp 0 reads them as an edge. A cluster waits
// only on one with a lower ticket, which runs or has run: clusters past the
// card's run in waves. A cluster wholly past the row's 2 tl + 1 valid states
// writes -inf alphas and runs no chain; the cluster below it then writes no
// link.
template <int K, bool Split, bool Chain = false>
__device__ __forceinline__ void alpha_chain(const float* __restrict__ log_probs,
                                            const int* __restrict__ targets,
                                            const int* __restrict__ input_lengths,
                                            const int* __restrict__ target_lengths,
                                            float* __restrict__ alphas, float* __restrict__ nll,
                                            int B, int T, int C, int U, int blank,
                                            float2* __restrict__ link = nullptr,
                                            unsigned* sync = nullptr, int Q = 1) {
  static_assert(!Split || K >= 2, "a slice's edge is its top lane's two top states");
  static_assert(Split || !Chain, "the chained route runs the cluster route's CTAs");
  constexpr int CH = fwd_chunk(K);  // steps a chunk
  constexpr bool kCopy = copy_warp(K, Split);
  extern __shared__ __align__(16) float lat[];
  // the chain's threads (then the copy warp, then the link warp), its barrier's
  const int nl = blockDim.x - (kCopy ? 32 : 0) - (Chain ? 32 : 0), nb = nl + (kCopy ? 32 : 0);
  const int L = threadIdx.x, ls = 32 * K * (nl >> 5) + 4;  // a step's row
  const int S = 2 * U + 1;
  const int P = Split ? cluster_size() : 1, rank = Split ? cluster_rank() : 0;
  if (L < 2) lat[L] = lat[ls + L] = kNegInf;
  const Edge ed{smem_addr(lat + 2 * ls), rank + 1 < P ? rank + 1 : -1, rank - 1};
  const Edge lk{ed.base + (unsigned)kEdgeBytes, rank, rank};  // the link's ring, filled by this CTA
  int b = blockIdx.x / P, q = 0;
  if constexpr (Chain) {
    if (L == 0) {
      ed.init();
      lk.init();
    }
    const unsigned t = chain_ticket(sync, lk.base + (unsigned)kEdgeBytes);
    q = (int)(t / B), b = (int)(t % B);
  } else if constexpr (Split) {
    if (L == 0) ed.init();
    cluster_sync();  // every peer's mbarriers are set before any hand-off
  }
  const int s0 = (q * P + rank) * (ls - 4);
  const int* tgt = targets + (size_t)b * U;
  const int tl = min(target_lengths[b], U);
  // steps computed; from Tc on the row is frozen (step 0 always is computed)
  const int Tc = max(1, min(input_lengths[b], T));
  const float* lp = log_probs + (size_t)b * T * C;

  const size_t t_stride = (size_t)B * S;
  // the slice's states of the row, and their alphas' row at step 0
  const int n_row = min(ls - 4, S - s0);
  float* row0 = alphas + (size_t)b * S + s0;
  // the chained route's clusters of the row that hold valid states, and
  // whether this CTA reads a link (CTA 0 of a cluster past the first) or
  // writes one (CTA P - 1 of a cluster below the row's last)
  const int live = Chain ? (2 * tl + 1 + P * (ls - 4) - 1) / (P * (ls - 4)) : 1;
  const bool link_in = Chain && rank == 0 && q > 0, link_out = Chain && rank == P - 1 && q + 1 < live;
  unsigned* flags = Chain ? chain_flags(sync, B, b, Q) : nullptr;
  if (Chain && q >= live) {  // wholly past the valid states: -inf at every step
    for (int t = 0; t < T; ++t)
      for (int i = L; i < n_row; i += blockDim.x) st_if<true>(true, row0 + (size_t)t * t_stride + i, kNegInf);
    return;  // no peer addresses this CTA after chain_ticket
  }
  if (Chain && L >= nb) {  // the link warp
    if (link_in) link_get(lk, link + ((size_t)b * (Q - 1) + q - 1) * T, flags + q - 1, Tc);
  } else if (kCopy && L >= nl) {
    // the copy warp: after the barrier of step t, the lattice of step t
    // (complete, and kept until the barrier of step t + 1, which waits for
    // this warp) to alphas[t], a coalesced row
    for (int t = 0; t < Tc; ++t) {
      asm volatile("bar.sync 1, %0;\n" ::"r"(nb) : "memory");
      const float* src = lat + (t & 1) * ls + 2;
      float* dst = row0 + (size_t)t * t_stride;
      for (int i = L - nl; i < n_row; i += 32) st_if<true>(true, dst + i, src[i]);
    }
  } else {
    int z[K];
    unsigned on = 0, valid = 0, skip = 0;  // bit j: state s0 + L*K + j
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int s = s0 + L * K + j;
      z[j] = s < S ? label(tgt, s, blank) : blank;
      if (s < S) on |= 1u << j;
      if (s < 2 * tl + 1) valid |= 1u << j;
      if ((s & 1) && s >= 2 && s < S && z[j] != label(tgt, s - 2, blank)) skip |= 1u << j;
    }
    auto fetch = [&](Chunk<CH, K>& c, int k) {  // chunk k's emissions, this thread's states
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const float* row = lp + (size_t)min(k * CH + i, Tc - 1) * C;
#pragma unroll
        for (int j = 0; j < K; ++j) c.v[i][j] = __ldg(row + z[j]);
      }
    };
    const int n_chunks = (Tc + CH - 1) / CH;
    Chunk<CH, K> cur, nxt;
    fetch(cur, 0);
    if (n_chunks > 1) fetch(nxt, 1);

    float* out = row0 + L * K;
    float a[K];
    for (int k = 0; k < n_chunks; ++k) {
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int t = k * CH + i;
        if (t >= Tc) break;
        if (t == 0) {
#pragma unroll
          for (int j = 0; j < K; ++j)
            a[j] = sel(((valid >> j) & 1) && s0 + L * K + j <= 1, cur.v[0][j], kNegInf);
        } else {
          // alpha[s-1] and alpha[s-2] below this thread's first state, from the
          // lattice of step t - 1
          const float* prev = lat + ((t - 1) & 1) * ls + 2 + L * K;
          float up1 = prev[-1], up2 = prev[-2];
          // warp 0: CTA rank - 1's top two of step t - 1 (CTA 0 of a chained
          // cluster: the link's, from its own ring)
          if (Split && (rank > 0 || link_in) && L < 32) {
            const float2 e = (rank > 0 ? ed : lk).recv(t - 1, 0);
            if (L == 0) up1 = e.y, up2 = e.x;
          }
          float nw[K];
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const float a1 = j >= 1 ? a[j >= 1 ? j - 1 : 0] : up1;
            const float a2 = sel((skip >> j) & 1, j >= 2 ? a[j >= 2 ? j - 2 : 0] : j == 1 ? up1 : up2,
                                 kNegInf);
            nw[j] = sel((valid >> j) & 1, logaddexp3(a[j], a1, a2) + cur.v[i][j], kNegInf);
          }
#pragma unroll
          for (int j = 0; j < K; ++j) a[j] = nw[j];
        }
        float* next = lat + (t & 1) * ls + 2 + L * K;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          next[j] = a[j];
          if constexpr (!kCopy) st_if<Split>((on >> j) & 1, out + j, a[j]);
        }
        // the top warp: the slice's top two states of step t up to CTA rank + 1
        // (the top CTA of a chained cluster: into the link, its top lane)
        if (Split && rank + 1 < P && L >= nl - 32) ed.send(t, 31, a[K >= 2 ? K - 2 : 0], a[K - 1]);
        if (link_out && L == nl - 1)
          link_put(link + ((size_t)b * (Q - 1) + q) * T, flags + q, t, a[K >= 2 ? K - 2 : 0], a[K - 1],
                   t == Tc - 1);
        out += t_stride;
        // the chain warps' barrier (and the copy warp's): step t's lattice
        // is complete; the buffer of step t - 1 is free for step t + 1
        asm volatile("bar.sync 1, %0;\n" ::"r"(nb) : "memory");
      }
      cur = nxt;
      if (k + 2 < n_chunks) fetch(nxt, k + 2);
    }
    if constexpr (!kCopy)
      for (int t = Tc; t < T; ++t, out += t_stride) {  // the row's input has ended: frozen
#pragma unroll
        for (int j = 0; j < K; ++j) st_if<Split>((on >> j) & 1, out + j, a[j]);
      }
  }
  // frozen past the input: rows of step Tc - 1's lattice, by every thread
  // that passed its barrier (not the link warp, which may be here first)
  if (kCopy && L < nb) {
    const float* fin = lat + ((Tc - 1) & 1) * ls + 2;
    for (int t = Tc; t < T; ++t)
      for (int i = L; i < n_row; i += nb) st_if<true>(true, row0 + (size_t)t * t_stride + i, fin[i]);
  }
  // The NLL, in the CTA that holds state 2 tl. Where that is the slice's
  // first state, state 2 tl - 1 is the top state of CTA rank - 1 at step
  // Tc - 1: its last edge (or the link's).
  const bool ends = 2 * tl >= s0 && 2 * tl < s0 + ls - 4;
  float below = kNegInf;
  if (Split && ends && tl > 0 && 2 * tl == s0 && L < 32) below = (rank > 0 ? ed : lk).recv(Tc - 1, 0).y;
  if (L == 0 && ends) {
    const float* fin = lat + ((Tc - 1) & 1) * ls + 2 - s0;  // by state
    const float a_end = fin[2 * tl];
    const float a_last = tl > 0 ? (2 * tl > s0 ? fin[2 * tl - 1] : below) : kNegInf;
    const float m = fmaxf(a_end, a_last);
    nll[b] = -(m + log1pf(expf(-fabsf(a_end - a_last))));
  }
  if constexpr (Split) cluster_sync();  // no CTA leaves while a peer may address it
}

template <int K>
__global__ void __launch_bounds__(32 * kMaxChainWarps)
    ctc_alpha_kernel(const float* __restrict__ log_probs, const int* __restrict__ targets,
                     const int* __restrict__ input_lengths, const int* __restrict__ target_lengths,
                     float* __restrict__ alphas, float* __restrict__ nll, int B, int T, int C, int U,
                     int blank) {
  alpha_chain<K, false>(log_probs, targets, input_lengths, target_lengths, alphas, nll, B, T, C, U,
                        blank);
}

// The cluster route's forward: a cluster of P CTAs a row (grid B P).
template <int K>
__global__ void __launch_bounds__(32 * (kMaxClusterWarps + copy_warp(K, true)))
    ctc_alpha_cluster_kernel(const float* __restrict__ log_probs, const int* __restrict__ targets,
                             const int* __restrict__ input_lengths,
                             const int* __restrict__ target_lengths, float* __restrict__ alphas,
                             float* __restrict__ nll, int B, int T, int C, int U, int blank) {
  alpha_chain<K, true>(log_probs, targets, input_lengths, target_lengths, alphas, nll, B, T, C, U,
                       blank);
}

// The chained route's forward: Q clusters of P CTAs a row (grid B Q P),
// `link` (B, Q - 1, T) float2 and `sync` 1 + B Q zeroed words of scratch.
template <int K>
__global__ void __launch_bounds__(32 * (kMaxClusterWarps + copy_warp(K, true) + 1))
    ctc_alpha_chain_kernel(const float* __restrict__ log_probs, const int* __restrict__ targets,
                           const int* __restrict__ input_lengths,
                           const int* __restrict__ target_lengths, float* __restrict__ alphas,
                           float* __restrict__ nll, float2* __restrict__ link,
                           unsigned* sync, int B, int T, int C, int U, int blank,
                           int Q) {
  alpha_chain<K, true, true>(log_probs, targets, input_lengths, target_lengths, alphas, nll, B, T,
                             C, U, blank, link, sync, Q);
}

// Row b of a cluster's gradient, once every CTA of its cluster (all of
// its threads call this) has its class sums in `partials` (B, P, T, C):
// grad[b] = -g[b] times their sum in rank order, each CTA a share of the
// (step, class) entries.
__device__ __forceinline__ void cluster_grad(const float* __restrict__ g, float* __restrict__ grow,
                                             const float* __restrict__ partials, int b, int P,
                                             int rank, int T, int C) {
  cluster_sync();
  const float* ps = partials + (size_t)b * P * T * C;
  for (size_t i = threadIdx.x + (size_t)rank * blockDim.x; i < (size_t)T * C;
       i += (size_t)P * blockDim.x) {
    float acc = 0.0f;
    for (int p = 0; p < P; ++p) acc += __ldcg(ps + (size_t)p * T * C + i);
    grow[i] = -acc * g[b];
  }
}

// Row b of the chained route's gradient, all threads of each CTA: once the
// cluster's CTAs have their class sums in `partials` (B, Q P, T, C), its CTA
// 0 counts the cluster in (`rows`, the launch's per-row counts, after a
// fence: the sums before the count, cumulatively) and tells its peers
// through their word `tk` whether it was the row's last of the `live`
// clusters that hold valid states. The last cluster adds the row's sums in
// slice order (q P + rank), each CTA a share of the (step, class) entries:
// grad[b] = -g[b] times their sum. A fixed order, whichever cluster is last.
__device__ __forceinline__ void chain_grad(const float* __restrict__ g, float* __restrict__ grow,
                                           const float* __restrict__ partials, unsigned* rows,
                                           int b, int Q, int P, int rank, int T, int C, int live,
                                           unsigned tk) {
  cluster_sync();
  if (threadIdx.x == 0 && rank == 0) {
    __threadfence();
    const bool last = atomicAdd(&rows[b], 1u) == (unsigned)live - 1;
    if (last) __threadfence();  // the other clusters' sums before the reads below
    for (int p = 0; p < P; ++p) st_cluster_u32(tk, p, last ? 1u : 0u);
  }
  cluster_sync();  // no remote access after this
  unsigned last;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(last) : "r"(tk) : "memory");
  if (!last) return;
  const float* ps = partials + (size_t)b * Q * P * T * C;
  for (size_t i = threadIdx.x + (size_t)rank * blockDim.x; i < (size_t)T * C;
       i += (size_t)P * blockDim.x) {
    float acc = 0.0f;
    for (int p = 0; p < live * P; ++p) acc += __ldcg(ps + (size_t)p * T * C + i);
    grow[i] = -acc * g[b];
  }
}

// The backward chain and class sums over a slice of a row, as alpha_chain
// slices it: W = blockDim.x / 32 - kConsumerWarps chain warps (lane L =
// threadIdx.x holds states s0 + L*K .. s0 + L*K+K-1), then the class-sum
// warps. Shared memory: the full and empty mbarriers of the occupancy
// ring's slots; the chain's values x = beta + emission of the last two
// steps, (2, 32 K W + 4) floats, state s0 + s of step n at (n & 1, s) with
// -inf above the slice; the occupancy ring, (kDepth, CH, K, 32 W) floats
// (CH = kChunk / K steps a chunk), entry (i, j, L) at step n = k*CH + i of
// the chain (t = Tc - 1 - n) and state s0 + L*K + j; the class sums' lists,
// 32 K W ints each, and a chunk's segment sums; in a cluster, all of it
// after its `Edge`: each step's bottom two x of the slice go down to CTA
// rank - 1, whose top lane takes them as its x[s+1] and x[s+2] in place of
// the guards. A cluster's CTAs store their class sums into `partials` (B,
// P, T, C), and `cluster_grad` adds them up. Chained (as alpha_chain, past
// a cluster's states): ticket i takes cluster q = Q - 1 - i / B of row b =
// i % B (the clusters in reverse order), the link between clusters q - 1
// and q carries CTA 0 of cluster q's bottom two x down to CTA P - 1 of
// cluster q - 1, whose link warp (the CTA's last, after the class-sum
// warps) reads it; clusters wholly past the valid states do nothing; the
// class sums go into `partials` (B, Q P, T, C) and `chain_grad` adds them.
template <int K, bool Split, bool Chain = false>
__device__ __forceinline__ void beta_grad(const float* __restrict__ log_probs,
                                          const int* __restrict__ targets,
                                          const int* __restrict__ input_lengths,
                                          const int* __restrict__ target_lengths,
                                          const float* __restrict__ alphas,
                                          const float* __restrict__ nll,
                                          const float* __restrict__ g, float* __restrict__ grad,
                                          float* __restrict__ partials, int B, int T, int C, int U,
                                          int blank, float2* __restrict__ link = nullptr,
                                          unsigned* sync = nullptr, int Q = 1) {
  static_assert(!Split || K >= 2, "a slice's edge is its bottom lane's two bottom states");
  static_assert(Split || !Chain, "the chained route runs the cluster route's CTAs");
  constexpr int CH = kChunk / K;  // steps a chunk: kChunk values a thread
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (blockDim.x >> 5) - kConsumerWarps - (Chain ? 1 : 0), nl = 32 * W, ls = 32 * K * W + 4;
  const int S = 2 * U + 1;
  const int P = Split ? cluster_size() : 1, rank = Split ? cluster_rank() : 0;
  const Edge ed{smem_addr(smem), rank - 1, rank + 1 < P ? rank + 1 : -1};
  const Edge lk{ed.base + (unsigned)kEdgeBytes, rank, rank};  // the link's ring (chained)
  const unsigned tk = lk.base + (unsigned)kEdgeBytes;           // the ticket's word (chained)
  int b = blockIdx.x / P, q = 0;
  if constexpr (Chain) {
    if (threadIdx.x == 0) {
      ed.init();
      lk.init();
    }
    const unsigned t = chain_ticket(sync, tk);
    q = Q - 1 - (int)(t / B), b = (int)(t % B);
  }
  const int s0 = (q * P + rank) * (ls - 4);
  const int* tgt = targets + (size_t)b * U;
  const int tl = min(target_lengths[b], U), n_valid = 2 * tl + 1;
  const int Tc = min(input_lengths[b], T);  // steps with a gradient
  const float nll_b = nll[b];
  float* grow = grad + (size_t)b * T * C;
  // the chained route's clusters of the row that hold valid states
  const int live = Chain ? (n_valid + P * (ls - 4) - 1) / (P * (ls - 4)) : 1;
  if (Chain && q >= live) return;  // no peer addresses this CTA after chain_ticket
  if (Tc <= 0 || !(nll_b < -kNegInf / 2)) {  // no input, or an impossible alignment: zero
    for (size_t i = threadIdx.x + (size_t)(q * P + rank) * blockDim.x; i < (size_t)T * C;
         i += (size_t)live * P * blockDim.x)
      grow[i] = 0.0f;
    return;
  }
  // a chained CTA reads the link from the cluster above (CTA P - 1 below the
  // row's last live cluster) or writes it to the cluster below (CTA 0 past
  // the first)
  const bool link_in = Chain && rank == P - 1 && q + 1 < live, link_out = Chain && rank == 0 && q > 0;
  unsigned* flags = Chain ? chain_flags(sync, B, b, Q) : nullptr;
  // the slice's valid states (the row's itself in a CTA a row: computed,
  // it slowed the shared route's backward by 7% at one state a lane), and
  // where its class sums go: the row's gradient, or in a cluster the CTA's
  // partial sums
  const int nv = Split ? min(max(n_valid - s0, 0), ls - 4) : n_valid;
  float* gsum = Split ? partials + (((size_t)b * Q + q) * P + rank) * T * C : grow;
  unsigned char* base = smem + (Chain ? kEdgeBytes + kLinkBytes : Split ? kEdgeBytes : 0);
  const unsigned full0 = smem_addr(base), empty0 = full0 + 8 * kDepth;
  int* n_runs = reinterpret_cast<int*>(base + 16 * kDepth);
  float* lat = reinterpret_cast<float*>(base + 16 * kDepth + 16);
  float* o_ring = lat + lattice_floats(K, W);
  float* a_ring = o_ring + ring_floats(W);  // the cluster route's alphas, as o_ring
  int* zs = reinterpret_cast<int*>(Split ? a_ring + ring_floats(W) : a_ring);
  int* sz = zs + K * nl;
  int* spos = sz + K * nl;
  int* run_seg = spos + K * nl;
  float* part = reinterpret_cast<float*>(run_seg + K * nl);
  if (threadIdx.x == 0)
    for (int i = 0; i < kDepth; ++i) {
      mbar_init(full0 + 8 * i, Split ? 2 * nl : nl);  // and the copies' arrivals
      mbar_init(empty0 + 8 * i, kConsumers);
    }
  if (threadIdx.x < 4) lat[ls - 4 + threadIdx.x] = lat[2 * ls - 4 + threadIdx.x] = kNegInf;
  if constexpr (Split && !Chain) {
    if (threadIdx.x == 0) ed.init();
    cluster_sync();  // every peer's mbarriers are set before any hand-off
  } else {
    __syncthreads();  // (chained: the edges' were set before chain_ticket's barriers)
  }
  const int n_chunks = (Tc + CH - 1) / CH;

  if (threadIdx.x < nl) {  // the backward chain
    const int L = threadIdx.x;
    const float* lp = log_probs + (size_t)b * T * C;
    int z[K];
    unsigned on = 0, valid = 0, skip_from = 0, term = 0;  // bit j: state s0 + L*K + j
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int s = s0 + L * K + j;
      z[j] = s < S ? label(tgt, s, blank) : blank;
      if (s < S) on |= 1u << j;
      if (s < n_valid) valid |= 1u << j;
      // s -> s+2 is allowed iff the skip into s+2 is
      if ((s & 1) && s + 2 < S && label(tgt, s + 2, blank) != z[j]) skip_from |= 1u << j;
      if (s < n_valid && (s == 2 * tl || (s == 2 * tl - 1 && tl > 0))) term |= 1u << j;
    }
    // chunk k's next-step emissions and (on the shared route) alphas, this
    // thread's states (states past S read state 0's: they are masked)
    auto fetch = [&](Chunk<CH, K>& e, Chunk<CH, K>& al, int k) {
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int t = max(Tc - 1 - (k * CH + i), 0);
        const float* erow = lp + (size_t)min(t + 1, Tc - 1) * C;
        const float* arow = alphas + ((size_t)t * B + b) * S;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          e.v[i][j] = __ldg(erow + z[j]);
          if constexpr (!Split) al.v[i][j] = __ldg(arow + ((on >> j) & 1 ? s0 + L * K + j : 0));
        }
      }
    };
    Chunk<CH, K> e_cur, a_cur, e_nxt, a_nxt;
    fetch(e_cur, a_cur, 0);
    if (n_chunks > 1) fetch(e_nxt, a_nxt, 1);

    float beta[K];
    // step i's log occupancies alpha + beta + nll into the chunk's slot
    // (the class-sum warps take their exp; on the cluster route its betas,
    // to which they add the alphas of the slot's ring): stored a step late,
    // after the next step's barrier, so that the chain does not wait for them
    auto put_occ = [&](float* ok, int i) {
      if constexpr (Split) {
#pragma unroll
        for (int j = 0; j < K; ++j) ok[(size_t)(i * K + j) * nl] = beta[j];
        return;
      }
#pragma unroll
      for (int j = 0; j < K; ++j) ok[(size_t)(i * K + j) * nl] = a_cur.v[i][j] + beta[j] + nll_b;
    };
    for (int k = 0; k < n_chunks; ++k) {
      const int slot = k % kDepth;
      if (k >= kDepth) mbar_wait(empty0 + 8 * slot, ((k / kDepth) - 1) & 1);  // slot consumed
      float* ok = o_ring + (size_t)slot * CH * K * nl + L;
      const int i_end = min(CH, Tc - k * CH);
      if constexpr (Split) {
        // the chunk's alphas of the slice's valid states into the slot of
        // the alpha ring, in the occupancy ring's order: a coalesced row a
        // step (lane L states L, L + nl, ...), no registers; their arrival
        // on the slot's full mbarrier once they have landed
        const unsigned ak = smem_addr(a_ring + (size_t)slot * CH * K * nl);
        for (int i = 0; i < i_end; ++i) {
          const float* arow = alphas + ((size_t)(Tc - 1 - (k * CH + i)) * B + b) * S + s0;
#pragma unroll
          for (int m = 0; m < K; ++m) {
            const int x = L + m * nl;
            if (x < nv) cp_async4(ak + 4 * ((i * K + x % K) * nl + x / K), arow + x);
          }
        }
        cp_async_arrive(full0 + 8 * slot);
      }
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int n = k * CH + i;
        if (i >= i_end) break;
        if (n == 0) {  // t = Tc - 1: the terminal vector
#pragma unroll
          for (int j = 0; j < K; ++j) beta[j] = sel((term >> j) & 1, 0.0f, kNegInf);
        } else {
          float x[K];
          float* xs = lat + (n & 1) * ls + L * K;
#pragma unroll
          for (int j = 0; j < K; ++j) {
            x[j] = sel((valid >> j) & 1, beta[j] + e_cur.v[i][j], kNegInf);
            xs[j] = x[j];
          }
          // warp 0: the slice's bottom two x of step n down to CTA rank - 1
          // (CTA 0 of a chained cluster: into the link, its lane 0)
          if (Split && rank > 0 && L < 32) ed.send(n - 1, 0, x[0], x[K >= 2 ? 1 : 0]);
          if (link_out && L == 0)
            link_put(link + ((size_t)b * (Q - 1) + q - 1) * T, flags + q - 1, n - 1, x[0],
                     x[K >= 2 ? 1 : 0], n == Tc - 1);
          // the chain warps' barrier: step n's x is complete; the buffer of
          // step n - 1 is free for step n + 1
          asm volatile("bar.sync 1, %0;\n" ::"r"(nl) : "memory");
          if (i > 0) put_occ(ok, i - 1);
          float dn1 = xs[K], dn2 = xs[K + 1];  // x[s+1] and x[s+2] above this thread's states
          // the top warp: from CTA rank + 1 (or the link's, from its own ring)
          if (Split && (rank + 1 < P || link_in) && L >= nl - 32) {
            const float2 e = (rank + 1 < P ? ed : lk).recv(n - 1, 31);
            if (L == nl - 1) dn1 = e.x, dn2 = e.y;
          }
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const float x1 = j + 1 < K ? x[j + 1 < K ? j + 1 : 0] : dn1;
            const float x2 = sel((skip_from >> j) & 1,
                                 j + 2 < K ? x[j + 2 < K ? j + 2 : 0] : j + 2 == K ? dn1 : dn2,
                                 kNegInf);
            beta[j] = logaddexp3(x[j], x1, x2);
          }
        }
      }
      put_occ(ok, i_end - 1);
      mbar_arrive(full0 + 8 * slot);  // this thread's occupancies of chunk k are in the ring
      e_cur = e_nxt;
      a_cur = a_nxt;
      if (k + 2 < n_chunks) fetch(e_nxt, a_nxt, k + 2);
    }
    if constexpr (Chain) chain_grad(g, grow, partials, chain_rows(sync), b, Q, P, rank, T, C, live, tk);
    else if constexpr (Split) cluster_grad(g, grow, partials, b, P, rank, T, C);
    return;
  }
  if (Chain && threadIdx.x >= nl + kConsumers) {  // the link warp
    if (link_in) link_get(lk, link + ((size_t)b * (Q - 1) + q) * T, flags + q, Tc - 1);
    chain_grad(g, grow, partials, chain_rows(sync), b, Q, P, rank, T, C, live, tk);
    return;
  }

  // The class sums of the slice. The row (a cluster's: the CTA's partial
  // sums) is zero but at the classes of the valid states below the input
  // length, which the chunks' sums overwrite.
  const int ct = threadIdx.x - nl;
  for (size_t i = ct; i < (size_t)T * C; i += kConsumers) gsum[i] = 0.0f;
  // the valid states sorted by (class, s): a bitonic sort of the keys
  // class << 32 | s in `part` (free until the first chunk's sums), padded
  // to a power of two; then their classes and ring positions
  long long* key = reinterpret_cast<long long*>(part);
  int n_pow = 1;
  while (n_pow < nv) n_pow <<= 1;
  for (int i = ct; i < n_pow; i += kConsumers)
    key[i] = i < nv ? (long long)label(tgt, s0 + i, blank) << 32 | i : LLONG_MAX;
  for (int k = 2; k <= n_pow; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      asm volatile("bar.sync 2, %0;\n" ::"r"(kConsumers) : "memory");
      for (int i = ct; i < n_pow / 2; i += kConsumers) {
        const int lo = 2 * i - (i & (j - 1)), hi = lo + j;  // lo: bit j clear
        const long long x = key[lo], y = key[hi];
        if ((x > y) == ((lo & k) == 0)) key[lo] = y, key[hi] = x;
      }
    }
  asm volatile("bar.sync 2, %0;\n" ::"r"(kConsumers) : "memory");
  for (int r = ct; r < nv; r += kConsumers) {
    const int s = (int)(key[r] & 0xffffffff);
    sz[r] = (int)(key[r] >> 32);
    spos[r] = (s % K) * nl + s / K;
  }
  asm volatile("bar.sync 2, %0;\n" ::"r"(kConsumers) : "memory");
  // The runs of a class in that order, cut into segments at every multiple
  // of kSeg: segment q holds sorted states seg[q] .. seg[q + 1] - 1; run q
  // (of class sz[seg[run_seg[q]]]) segments run_seg[q] .. run_seg[q + 1] - 1.
  // A thread numbers the starts in its block of sorted states after an
  // exclusive scan of the blocks' counts (runs in bits 16 on, segments below).
  int* seg = zs;
  auto starts = [&](int r) {
    const int rs = r == 0 || sz[r] != sz[r - 1];
    return rs << 16 | (rs | (r % kSeg == 0));
  };
  const int per = (nv + kConsumers - 1) / kConsumers;
  const int r0 = min(ct * per, nv), r1 = min(r0 + per, nv);
  int count = 0;
  for (int r = r0; r < r1; ++r) count += starts(r);
  int* wsum = reinterpret_cast<int*>(part);  // the keys are read
  int x = count;
  const int lane = ct & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) wsum[ct >> 5] = x;
  asm volatile("bar.sync 2, %0;\n" ::"r"(kConsumers) : "memory");
  for (int w = 0; w < (ct >> 5); ++w) x += wsum[w];
  int nr = (x - count) >> 16, ns = (x - count) & 0xffff;
  for (int r = r0; r < r1; ++r) {
    const int st = starts(r);
    if (st >> 16) run_seg[nr++] = ns;
    if (st & 1) {
      spos[r] |= kHead;
      seg[ns++] = r;
    }
    spos[r] |= (ns - 1) << 16;
  }
  if (ct == kConsumers - 1) {
    seg[ns] = nv;
    run_seg[nr] = ns;
    *n_runs = nr;
  }
  asm volatile("bar.sync 2, %0;\n" ::"r"(kConsumers) : "memory");  // and the zeros are written
  const int runs = *n_runs, n_blocks = (nv + 31) >> 5, cw = ct >> 5;
  const float gb = g[b];
  for (int k = 0; k < n_chunks; ++k) {
    const int slot = k % kDepth;
    mbar_wait(full0 + 8 * slot, (k / kDepth) & 1);
    const float* ok = o_ring + (size_t)slot * CH * K * nl;
    const float* ak = a_ring + (size_t)slot * CH * K * nl;
    const int i_end = min(CH, Tc - k * CH), t0 = Tc - 1 - k * CH;
    // a warp a block of 32 sorted states, a lane a state: its occupancies
    // exp(min(alpha + beta + nll, 0)) at the chunk's steps; then each
    // segment's sums, in a fixed order of shuffles within the segment, into
    // part
    for (int blk = cw; blk < n_blocks; blk += kConsumerWarps) {
      const int r = blk * 32 + lane;
      const bool in = r < nv;
      const int sp = in ? spos[r] : kHead;  // past the states: a head, summed into none
      const unsigned heads = __ballot_sync(0xffffffffu, sp & kHead);
      const float* o = ok + (sp & 0xffff);
      const float* al = ak + (sp & 0xffff);
      float v[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const size_t at = (size_t)i * K * nl;
        const float occ = Split ? al[at] + o[at] + nll_b : o[at];  // alpha + beta + nll
        v[i] = in && i < i_end ? expf(fminf(occ, 0.0f)) : 0.0f;
      }
#pragma unroll
      for (int d = 1; d < kSeg; d <<= 1) {
        // lanes lane + 1 .. lane + d are in this segment
        const bool take =
            (lane & (kSeg - 1)) + d < kSeg && !((heads >> (lane + 1)) & ((1u << d) - 1));
#pragma unroll
        for (int i = 0; i < CH; ++i) {
          const float y = __shfl_down_sync(0xffffffffu, v[i], d);
          if (take) v[i] += y;
        }
      }
      if (in && (sp & kHead)) {
#pragma unroll
        for (int i = 0; i < CH; ++i)
          if (i < i_end) part[(sp >> 16 & 0x3fff) * CH + i] = v[i];
      }
    }
    mbar_arrive(empty0 + 8 * slot);  // chunk k's occupancies are read
    asm volatile("bar.sync 2, %0;\n" ::"r"(kConsumers) : "memory");  // the segment sums are in
    // a thread a (run, step): the run's segment sums in order
    for (int p = ct; p < runs * CH; p += kConsumers) {
      const int q = p / CH, i = p % CH;
      if (i >= i_end) continue;
      float acc = 0.0f;
#pragma unroll 8
      for (int j = run_seg[q]; j < run_seg[q + 1]; ++j) acc += part[j * CH + i];
      gsum[(size_t)(t0 - i) * C + sz[seg[run_seg[q]]]] = Split ? acc : -acc * gb;
    }
    asm volatile("bar.sync 2, %0;\n" ::"r"(kConsumers) : "memory");  // part is free again
  }
  if constexpr (Chain) chain_grad(g, grow, partials, chain_rows(sync), b, Q, P, rank, T, C, live, tk);
  else if constexpr (Split) cluster_grad(g, grow, partials, b, P, rank, T, C);
}


template <int K>
__global__ void __launch_bounds__(32 * (kMaxChainWarps + kConsumerWarps))
    ctc_beta_grad_kernel(const float* __restrict__ log_probs, const int* __restrict__ targets,
                         const int* __restrict__ input_lengths,
                         const int* __restrict__ target_lengths, const float* __restrict__ alphas,
                         const float* __restrict__ nll, const float* __restrict__ g,
                         float* __restrict__ grad, int B, int T, int C, int U, int blank) {
  beta_grad<K, false>(log_probs, targets, input_lengths, target_lengths, alphas, nll, g, grad,
                      nullptr, B, T, C, U, blank);
}

// The cluster route's backward: a cluster of P CTAs a row (grid B P),
// `partials` (B, P, T, C) floats of scratch. At most 12 chain warps: 20
// warps leave a thread 96 registers, and at 24 the chain spilled.
template <int K>
__global__ void __launch_bounds__(32 * (kMaxClusterWarps + kConsumerWarps))
    ctc_beta_grad_cluster_kernel(const float* __restrict__ log_probs,
                                 const int* __restrict__ targets,
                                 const int* __restrict__ input_lengths,
                                 const int* __restrict__ target_lengths,
                                 const float* __restrict__ alphas, const float* __restrict__ nll,
                                 const float* __restrict__ g, float* __restrict__ grad,
                                 float* __restrict__ partials, int B, int T, int C, int U,
                                 int blank) {
  beta_grad<K, true>(log_probs, targets, input_lengths, target_lengths, alphas, nll, g, grad,
                     partials, B, T, C, U, blank);
}

// The chained route's backward: Q clusters of P CTAs a row (grid B Q P),
// `partials` (B, Q P, T, C) floats, `link` (B, Q - 1, T) float2 and `sync`
// 1 + B Q zeroed words of scratch; a link warp beside the cluster route's warps (still 96 registers
// a thread at 12 chain warps).
template <int K>
__global__ void __launch_bounds__(32 * (kMaxClusterWarps + kConsumerWarps + 1))
    ctc_beta_grad_chain_kernel(const float* __restrict__ log_probs,
                               const int* __restrict__ targets,
                               const int* __restrict__ input_lengths,
                               const int* __restrict__ target_lengths,
                               const float* __restrict__ alphas, const float* __restrict__ nll,
                               const float* __restrict__ g, float* __restrict__ grad,
                               float* __restrict__ partials, float2* __restrict__ link,
                               unsigned* sync, int B, int T, int C, int U, int blank,
                               int Q) {
  beta_grad<K, true, true>(log_probs, targets, input_lengths, target_lengths, alphas, nll, g, grad,
                           partials, B, T, C, U, blank, link, sync, Q);
}

template <int K>
cudaError_t launch_alpha(const float* log_probs, const int* targets, const int* input_lengths,
                         const int* target_lengths, float* alphas, float* nll, int B, int T, int C,
                         int U, int blank, int W, cudaStream_t st) {
  const size_t smem = alpha_smem(K, W);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ctc_alpha_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  ctc_alpha_kernel<K><<<B, 32 * W, smem, st>>>(log_probs, targets, input_lengths, target_lengths,
                                               alphas, nll, B, T, C, U, blank);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_beta_grad(const float* log_probs, const int* targets, const int* input_lengths,
                             const int* target_lengths, const float* alphas, const float* nll,
                             const float* g, float* grad, int B, int T, int C, int U, int blank,
                             int W, cudaStream_t st) {
  const size_t smem = beta_smem(K, W);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ctc_beta_grad_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  ctc_beta_grad_kernel<K><<<B, 32 * (W + kConsumerWarps), smem, st>>>(
      log_probs, targets, input_lengths, target_lengths, alphas, nll, g, grad, B, T, C, U, blank);
  return cudaGetLastError();
}

// `ctc_plan`'s (states a lane, chain warps) hold S states.
bool plan_ok(int S, int K, int W) {
  return (K == 1 || K == 2) && W >= 1 && W <= kMaxChainWarps &&
         S <= 32 * K * W;
}

// ------------------------------------------------------ the cluster route --

// Launches a cluster-route kernel, a cluster of P CTAs a row (its dynamic
// shared memory allowed up to `max_smem`, the most any plan of its K asks,
// so that a graph captured at another plan still launches), or
// (max_clusters != nullptr) asks how many of its clusters fit on the card at
// once.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int B, int P, int threads, size_t smem,
                           size_t max_smem, cudaStream_t st, int* max_clusters, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_smem);
  if (err == cudaSuccess && P > kPortableCluster)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * P);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(max_clusters, (const void*)kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int K>
cudaError_t launch_alpha_cluster(const float* log_probs, const int* targets,
                                 const int* input_lengths, const int* target_lengths,
                                 float* alphas, float* nll, int B, int T, int C, int U, int blank,
                                 int W, int P, cudaStream_t st, int* max_clusters) {
  return launch_cluster(ctc_alpha_cluster_kernel<K>, B, P, 32 * (W + copy_warp(K, true)),
                        alpha_smem(K, W) + kEdgeBytes,
                        alpha_smem(K, kMaxClusterWarps) + kEdgeBytes, st, max_clusters, log_probs,
                        targets, input_lengths, target_lengths, alphas, nll, B, T, C, U, blank);
}

// The cluster route's backward: beta_smem, the ring of alphas, the edge.
constexpr size_t beta_smem_cluster(int K, int W) {
  return beta_smem(K, W) + 4 * (size_t)ring_floats(W) + kEdgeBytes;
}

template <int K>
cudaError_t launch_beta_grad_cluster(const float* log_probs, const int* targets,
                                     const int* input_lengths, const int* target_lengths,
                                     const float* alphas, const float* nll, const float* g,
                                     float* grad, float* partials, int B, int T, int C, int U,
                                     int blank, int W, int P, cudaStream_t st,
                                     int* max_clusters) {
  return launch_cluster(ctc_beta_grad_cluster_kernel<K>, B, P, 32 * (W + kConsumerWarps),
                        beta_smem_cluster(K, W), beta_smem_cluster(K, kMaxClusterWarps),
                        st, max_clusters, log_probs, targets, input_lengths, target_lengths,
                        alphas, nll, g, grad, partials, B, T, C, U, blank);
}

// `ctc_plan`'s cluster route: K states a lane (2, 4 or 8) in W chain warps,
// P CTAs a row, every slice holding some of the S states.
bool cluster_plan_ok(int S, int K, int W, int P) {
  const long long n = 32LL * K * W;
  return (K == 2 || K == 4 || K == 8) && W >= 1 && W <= kMaxClusterWarps && P >= 2 &&
         P <= kMaxCluster &&
         (P - 1) * n < S && S <= P * n;
}

// ------------------------------------------------------ the chained route --

// The chained route runs at kChainK states a lane (CHAIN_K).
constexpr int kChainK = 2;

cudaError_t launch_alpha_chain(const float* log_probs, const int* targets,
                               const int* input_lengths, const int* target_lengths, float* alphas,
                               float* nll, float2* link, unsigned* sync, int B, int T, int C,
                               int U, int blank, int W, int P, int Q, cudaStream_t st,
                               int* max_clusters) {
  constexpr int K = kChainK;
  return launch_cluster(ctc_alpha_chain_kernel<K>, B * Q, P, 32 * (W + copy_warp(K, true) + 1),
                        alpha_smem(K, W) + kEdgeBytes + kLinkBytes,
                        alpha_smem(K, kMaxClusterWarps) + kEdgeBytes + kLinkBytes, st,
                        max_clusters, log_probs, targets, input_lengths, target_lengths, alphas,
                        nll, link, sync, B, T, C, U, blank, Q);
}

cudaError_t launch_beta_grad_chain(const float* log_probs, const int* targets,
                                   const int* input_lengths, const int* target_lengths,
                                   const float* alphas, const float* nll, const float* g,
                                   float* grad, float* partials, float2* link, unsigned* sync,
                                   int B, int T, int C, int U, int blank, int W, int P, int Q,
                                   cudaStream_t st, int* max_clusters) {
  constexpr int K = kChainK;
  return launch_cluster(ctc_beta_grad_chain_kernel<K>, B * Q, P, 32 * (W + kConsumerWarps + 1),
                        beta_smem_cluster(K, W) + kLinkBytes,
                        beta_smem_cluster(K, kMaxClusterWarps) + kLinkBytes, st, max_clusters,
                        log_probs, targets, input_lengths, target_lengths, alphas, nll, g, grad,
                        partials, link, sync, B, T, C, U, blank, Q);
}

// `ctc_plan`'s chained route: Q clusters of P CTAs a row, each CTA a slice of
// 32 K W of the S states.
bool chain_plan_ok(int S, int K, int W, int P, int Q) {
  const long long n = 32LL * K * W;
  return K == kChainK && W >= 1 && W <= kMaxClusterWarps && P >= 2 && P <= kMaxCluster &&
         Q >= 1 && (long long)Q * P * n >= S;
}

bool args_ok(int B, int T, int C, int U, int blank) {
  return B >= 1 && T >= 1 && U >= 1 && blank >= 0 && blank < C;
}

}  // namespace

// K and W come from kernels/ctc.py `ctc_plan`: K states a lane (1 or 2) in
// W chain warps, 32 K W >= S = 2U + 1.
extern "C" int ctc_alpha_f32(const float* log_probs, const int* targets, const int* input_lengths,
                             const int* target_lengths, float* alphas, float* nll, int B, int T,
                             int C, int U, int blank, int K, int W, void* stream) {
  if (!args_ok(B, T, C, U, blank) || !plan_ok(2 * U + 1, K, W))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(K == 1 ? launch_alpha<1> : launch_alpha<2>)(
      log_probs, targets, input_lengths, target_lengths, alphas, nll, B, T, C, U, blank, W, st);
}

extern "C" int ctc_beta_grad_f32(const float* log_probs, const int* targets,
                                 const int* input_lengths, const int* target_lengths,
                                 const float* alphas, const float* nll, const float* g,
                                 float* grad, int B, int T, int C, int U, int blank, int K, int W,
                                 void* stream) {
  if (!args_ok(B, T, C, U, blank) || !plan_ok(2 * U + 1, K, W) ||
      beta_smem(K, W) > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(K == 1 ? launch_beta_grad<1> : launch_beta_grad<2>)(
      log_probs, targets, input_lengths, target_lengths, alphas, nll, g, grad, B, T, C, U, blank,
      W, st);
}

// The cluster route: as ctc_alpha_f32 with K (2, 4 or 8) and W from
// kernels/ctc.py `ctc_plan` and P CTAs a row, P * 32 K W >= S = 2U + 1.
extern "C" int ctc_alpha_cluster_f32(const float* log_probs, const int* targets,
                                     const int* input_lengths, const int* target_lengths,
                                     float* alphas, float* nll, int B, int T, int C, int U,
                                     int blank, int K, int W, int P, void* stream) {
  if (!args_ok(B, T, C, U, blank) || !cluster_plan_ok(2 * U + 1, K, W, P))
    return (int)cudaErrorInvalidValue;
  return (int)(K == 2   ? launch_alpha_cluster<2>
               : K == 4 ? launch_alpha_cluster<4>
                        : launch_alpha_cluster<8>)(log_probs, targets, input_lengths,
                                                   target_lengths, alphas, nll, B, T, C, U, blank,
                                                   W, P, (cudaStream_t)stream, nullptr);
}

// The cluster route's gradient: `partials` (B, P, T, C) floats of scratch,
// each CTA's class sums.
extern "C" int ctc_beta_grad_cluster_f32(const float* log_probs, const int* targets,
                                         const int* input_lengths, const int* target_lengths,
                                         const float* alphas, const float* nll, const float* g,
                                         float* grad, float* partials, int B, int T, int C, int U,
                                         int blank, int K, int W, int P, void* stream) {
  if (!args_ok(B, T, C, U, blank) || !cluster_plan_ok(2 * U + 1, K, W, P))
    return (int)cudaErrorInvalidValue;
  return (int)(K == 2   ? launch_beta_grad_cluster<2>
               : K == 4 ? launch_beta_grad_cluster<4>
                        : launch_beta_grad_cluster<8>)(log_probs, targets, input_lengths,
                                                       target_lengths, alphas, nll, g, grad,
                                                       partials, B, T, C, U, blank, W, P,
                                                       (cudaStream_t)stream, nullptr);
}

// How many clusters of P CTAs of the cluster route's forward (backward: 1)
// at K states a lane in W chain warps fit on the card at once, or minus a
// cudaError_t.
extern "C" int ctc_cluster_max_clusters(int K, int W, int P, int backward) {
  if ((K != 2 && K != 4 && K != 8) || W < 1 || W > kMaxClusterWarps || P < 1 ||
      P > kMaxCluster)
    return -(int)cudaErrorInvalidValue;
  int n = 0;
  const cudaError_t err =
      backward ? (K == 2   ? launch_beta_grad_cluster<2>
                  : K == 4 ? launch_beta_grad_cluster<4>
                           : launch_beta_grad_cluster<8>)(nullptr, nullptr, nullptr, nullptr,
                                                          nullptr, nullptr, nullptr, nullptr,
                                                          nullptr, 1, 1, 1, 1, 0, W, P, nullptr,
                                                          &n)
               : (K == 2   ? launch_alpha_cluster<2>
                  : K == 4 ? launch_alpha_cluster<4>
                           : launch_alpha_cluster<8>)(nullptr, nullptr, nullptr, nullptr, nullptr,
                                                      nullptr, 1, 1, 1, 1, 0, W, P, nullptr, &n);
  return err == cudaSuccess ? n : -(int)err;
}

// The chained route: as ctc_alpha_cluster_f32 with Q clusters of P CTAs a
// row at 2 states a lane (kernels/ctc.py `ctc_plan`, Q P 32 K W >= S);
// `link` (B, Q - 1, T) float2 (null when Q = 1) and `sync` 1 + B Q words,
// zero, of scratch.
extern "C" int ctc_alpha_chain_f32(const float* log_probs, const int* targets,
                                   const int* input_lengths, const int* target_lengths,
                                   float* alphas, float* nll, float* link, unsigned* sync, int B,
                                   int T, int C, int U, int blank, int K, int W, int P, int Q,
                                   void* stream) {
  if (!args_ok(B, T, C, U, blank) || !chain_plan_ok(2 * U + 1, K, W, P, Q) ||
      (Q > 1 && link == nullptr) || sync == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)launch_alpha_chain(log_probs, targets, input_lengths, target_lengths, alphas, nll,
                                 reinterpret_cast<float2*>(link), sync, B, T, C, U, blank, W, P,
                                 Q, (cudaStream_t)stream, nullptr);
}

// The chained route's gradient: `partials` (B, Q P, T, C) floats, `link`
// (B, Q - 1, T) float2 and `sync` 1 + B Q words, zero, of scratch.
extern "C" int ctc_beta_grad_chain_f32(const float* log_probs, const int* targets,
                                       const int* input_lengths, const int* target_lengths,
                                       const float* alphas, const float* nll, const float* g,
                                       float* grad, float* partials, float* link, unsigned* sync,
                                       int B, int T, int C, int U, int blank, int K, int W, int P,
                                       int Q, void* stream) {
  if (!args_ok(B, T, C, U, blank) || !chain_plan_ok(2 * U + 1, K, W, P, Q) ||
      (Q > 1 && link == nullptr) || sync == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)launch_beta_grad_chain(log_probs, targets, input_lengths, target_lengths, alphas,
                                     nll, g, grad, partials, reinterpret_cast<float2*>(link),
                                     sync, B, T, C, U, blank, W, P, Q, (cudaStream_t)stream,
                                     nullptr);
}

// How many clusters of P CTAs of the chained route's forward (backward: 1)
// at K (2) states a lane in W chain warps fit on the card at once, or minus
// a cudaError_t.
extern "C" int ctc_chain_max_clusters(int K, int W, int P, int backward) {
  if (K != kChainK || W < 1 || W > kMaxClusterWarps || P < 1 || P > kMaxCluster)
    return -(int)cudaErrorInvalidValue;
  int n = 0;
  const cudaError_t err =
      backward ? launch_beta_grad_chain(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                        nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, 1, 1, 0,
                                        W, P, 1, nullptr, &n)
               : launch_alpha_chain(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                    nullptr, 1, 1, 1, 1, 0, W, P, 1, nullptr, &n);
  return err == cudaSuccess ? n : -(int)err;
}
