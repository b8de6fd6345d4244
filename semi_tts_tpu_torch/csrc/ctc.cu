// K6: CTC over the log-semiring lattice, a CTA of chain warps a row.
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
// - K states a lane, K in {1, 2, 4, 8}: up to 32 * 8 * 16 = 4,096 states. A
//   forward chunk holds min(8, 16 / K) steps, a backward one 8 / K, so that
//   a thread's chunks stay at 16 values; past 2 states a lane the sort's
//   keys can outgrow a chunk's segment sums and their region grows to hold
//   them (~197 KB at K = 8 in 16 warps).
//
// Past 4,096 states, the device-memory route (`ctc_alpha_long_f32`,
// `ctc_beta_grad_long_f32`): a CTA of 1,024 threads a row, a thread a
// state at a time in a strided loop. The forward reads step t - 1's alphas
// back from the (T, B, S) output it writes, one __syncthreads a step. The
// backward first sorts the row's valid states by (class, s) (one warp, a
// stable counting sort by __match_any_sync ballots), then runs the beta
// chain the same way over a (T, B, S) scratch; a second kernel, a CTA a
// (step, row), sums the occupancies exp(min(alpha + beta + nll, 0)) of each
// class's sorted run (a warp a class, lanes strided over the run, then
// shuffles in a fixed order) into grad[b, t, class]. The same arithmetic
// as the shared-memory route, no atomics: a rerun is bit for bit.

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
constexpr int kLongThreads = 1024;   // the device-memory route's CTA (LONG_THREADS)
constexpr int kGradThreads = 256;    // its class sums' CTA, a (step, row)

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

// *g = v where p, without a branch.
__device__ __forceinline__ void st_if(bool p, float* g, float v) {
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

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
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
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 2000000000ull) __trap();
}

// A chunk of CH steps of this thread's emissions (and, backward, alphas),
// loaded into registers a chunk ahead of the chain: no step waits on a
// global load.
template <int CH, int K>
struct Chunk {
  float v[CH][K];
};

// A CTA a row: lane L = threadIdx.x of its W = blockDim.x / 32 chain warps
// holds states L*K .. L*K+K-1. Shared memory: the lattice of the last two
// steps, (2, 32 K W + 4) floats, state s of step t at (t & 1, 2 + s) with
// -inf at 0 and 1 (below state 0).
template <int K>
__global__ void __launch_bounds__(32 * kMaxChainWarps)
    ctc_alpha_kernel(const float* __restrict__ log_probs, const int* __restrict__ targets,
                     const int* __restrict__ input_lengths, const int* __restrict__ target_lengths,
                     float* __restrict__ alphas, float* __restrict__ nll, int B, int T, int C, int U,
                     int blank) {
  constexpr int CH = fwd_chunk(K);  // steps a chunk
  extern __shared__ __align__(16) float lat[];
  const int nl = blockDim.x, L = threadIdx.x, ls = 32 * K * (nl >> 5) + 4;  // a step's row
  const int S = 2 * U + 1;
  const int b = blockIdx.x;
  const int* tgt = targets + (size_t)b * U;
  const int tl = min(target_lengths[b], U);
  // steps computed; from Tc on the row is frozen (step 0 always is computed)
  const int Tc = max(1, min(input_lengths[b], T));
  const float* lp = log_probs + (size_t)b * T * C;
  if (L < 2) lat[L] = lat[ls + L] = kNegInf;

  int z[K];
  unsigned on = 0, valid = 0, skip = 0;  // bit j: state L*K + j
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = L * K + j;
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

  const size_t t_stride = (size_t)B * S;
  float* out = alphas + (size_t)b * S + L * K;
  float a[K];
  for (int k = 0; k < n_chunks; ++k) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int t = k * CH + i;
      if (t >= Tc) break;
      if (t == 0) {
#pragma unroll
        for (int j = 0; j < K; ++j)
          a[j] = sel(((valid >> j) & 1) && L * K + j <= 1, cur.v[0][j], kNegInf);
      } else {
        // alpha[s-1] and alpha[s-2] below this thread's first state, from the
        // lattice of step t - 1
        const float* prev = lat + ((t - 1) & 1) * ls + 2 + L * K;
        const float up1 = prev[-1], up2 = prev[-2];
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
        st_if((on >> j) & 1, out + j, a[j]);
      }
      out += t_stride;
      // the chain warps' barrier: step t's lattice is complete; the buffer
      // of step t - 1 is free for step t + 1
      asm volatile("bar.sync 1, %0;\n" ::"r"(nl) : "memory");
    }
    cur = nxt;
    if (k + 2 < n_chunks) fetch(nxt, k + 2);
  }
  for (int t = Tc; t < T; ++t, out += t_stride) {  // the row's input has ended: frozen
#pragma unroll
    for (int j = 0; j < K; ++j) st_if((on >> j) & 1, out + j, a[j]);
  }
  if (L == 0) {
    const float* fin = lat + ((Tc - 1) & 1) * ls + 2;
    const float a_end = fin[2 * tl];
    const float a_last = tl > 0 ? fin[2 * tl - 1] : kNegInf;
    const float m = fmaxf(a_end, a_last);
    nll[b] = -(m + log1pf(expf(-fabsf(a_end - a_last))));
  }
}

// A CTA a row: W = blockDim.x / 32 - kConsumerWarps chain warps (lane L =
// threadIdx.x holds states L*K .. L*K+K-1), then the class-sum warps.
// Shared memory: the full and empty mbarriers of the occupancy ring's slots;
// the chain's values x = beta + emission of the last two steps, (2, 32 K W +
// 4) floats, state s of step n at (n & 1, s) with -inf above the last
// state; the occupancy ring, (kDepth, CH, K, 32 W) floats (CH = kChunk /
// K steps a chunk), entry (i, j, L) at step n = k*CH + i of the chain (t =
// Tc - 1 - n) and state L*K + j; the class sums' lists, 32 K W ints each,
// and a chunk's segment sums.
template <int K>
__global__ void __launch_bounds__(32 * (kMaxChainWarps + kConsumerWarps))
    ctc_beta_grad_kernel(const float* __restrict__ log_probs, const int* __restrict__ targets,
                         const int* __restrict__ input_lengths,
                         const int* __restrict__ target_lengths, const float* __restrict__ alphas,
                         const float* __restrict__ nll, const float* __restrict__ g,
                         float* __restrict__ grad, int B, int T, int C, int U, int blank) {
  constexpr int CH = kChunk / K;  // steps a chunk: kChunk values a thread
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (blockDim.x >> 5) - kConsumerWarps, nl = 32 * W, ls = 32 * K * W + 4;
  const int S = 2 * U + 1;
  const int b = blockIdx.x;
  const int* tgt = targets + (size_t)b * U;
  const int tl = min(target_lengths[b], U), n_valid = 2 * tl + 1;
  const int Tc = min(input_lengths[b], T);  // steps with a gradient
  const float nll_b = nll[b];
  float* grow = grad + (size_t)b * T * C;
  if (Tc <= 0 || !(nll_b < -kNegInf / 2)) {  // no input, or an impossible alignment: zero
    for (size_t i = threadIdx.x; i < (size_t)T * C; i += blockDim.x) grow[i] = 0.0f;
    return;
  }
  const unsigned full0 = smem_addr(smem), empty0 = full0 + 8 * kDepth;
  int* n_runs = reinterpret_cast<int*>(smem + 16 * kDepth);
  float* lat = reinterpret_cast<float*>(smem + 16 * kDepth + 16);
  float* o_ring = lat + lattice_floats(K, W);
  int* zs = reinterpret_cast<int*>(o_ring + (size_t)kDepth * CH * K * nl);
  int* sz = zs + K * nl;
  int* spos = sz + K * nl;
  int* run_seg = spos + K * nl;
  float* part = reinterpret_cast<float*>(run_seg + K * nl);
  if (threadIdx.x == 0)
    for (int i = 0; i < kDepth; ++i) {
      mbar_init(full0 + 8 * i, nl);
      mbar_init(empty0 + 8 * i, kConsumers);
    }
  if (threadIdx.x < 4) lat[ls - 4 + threadIdx.x] = lat[2 * ls - 4 + threadIdx.x] = kNegInf;
  __syncthreads();
  const int n_chunks = (Tc + CH - 1) / CH;

  if (threadIdx.x < nl) {  // the backward chain
    const int L = threadIdx.x;
    const float* lp = log_probs + (size_t)b * T * C;
    int z[K];
    unsigned on = 0, valid = 0, skip_from = 0, term = 0;  // bit j: state L*K + j
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int s = L * K + j;
      z[j] = s < S ? label(tgt, s, blank) : blank;
      if (s < S) on |= 1u << j;
      if (s < n_valid) valid |= 1u << j;
      // s -> s+2 is allowed iff the skip into s+2 is
      if ((s & 1) && s + 2 < S && label(tgt, s + 2, blank) != z[j]) skip_from |= 1u << j;
      if (s < n_valid && (s == 2 * tl || (s == 2 * tl - 1 && tl > 0))) term |= 1u << j;
    }
    // chunk k's next-step emissions and alphas, this thread's states (states
    // past S read state 0's: they are masked)
    auto fetch = [&](Chunk<CH, K>& e, Chunk<CH, K>& al, int k) {
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int t = max(Tc - 1 - (k * CH + i), 0);
        const float* erow = lp + (size_t)min(t + 1, Tc - 1) * C;
        const float* arow = alphas + ((size_t)t * B + b) * S;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          e.v[i][j] = __ldg(erow + z[j]);
          al.v[i][j] = __ldg(arow + ((on >> j) & 1 ? L * K + j : 0));
        }
      }
    };
    Chunk<CH, K> e_cur, a_cur, e_nxt, a_nxt;
    fetch(e_cur, a_cur, 0);
    if (n_chunks > 1) fetch(e_nxt, a_nxt, 1);

    float beta[K];
    // step i's log occupancies alpha + beta + nll into the chunk's slot
    // (the class-sum warps take their exp): stored a step late, after the
    // next step's barrier, so that the chain does not wait for them
    auto put_occ = [&](float* ok, int i) {
#pragma unroll
      for (int j = 0; j < K; ++j) ok[(size_t)(i * K + j) * nl] = a_cur.v[i][j] + beta[j] + nll_b;
    };
    for (int k = 0; k < n_chunks; ++k) {
      const int slot = k % kDepth;
      if (k >= kDepth) mbar_wait(empty0 + 8 * slot, ((k / kDepth) - 1) & 1);  // slot consumed
      float* ok = o_ring + (size_t)slot * CH * K * nl + L;
      const int i_end = min(CH, Tc - k * CH);
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
          // the chain warps' barrier: step n's x is complete; the buffer of
          // step n - 1 is free for step n + 1
          asm volatile("bar.sync 1, %0;\n" ::"r"(nl) : "memory");
          if (i > 0) put_occ(ok, i - 1);
          const float dn1 = xs[K], dn2 = xs[K + 1];  // x[s+1] and x[s+2] above this thread's states
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
    return;
  }

  // The class sums. The row is zero but at the classes of the valid states
  // below the input length, which the chunks' sums overwrite.
  const int ct = threadIdx.x - nl;
  for (size_t i = ct; i < (size_t)T * C; i += kConsumers) grow[i] = 0.0f;
  // the valid states sorted by (class, s): a bitonic sort of the keys
  // class << 32 | s in `part` (free until the first chunk's sums), padded
  // to a power of two; then their classes and ring positions
  long long* key = reinterpret_cast<long long*>(part);
  int n_pow = 1;
  while (n_pow < n_valid) n_pow <<= 1;
  for (int i = ct; i < n_pow; i += kConsumers)
    key[i] = i < n_valid ? (long long)label(tgt, i, blank) << 32 | i : LLONG_MAX;
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
  for (int r = ct; r < n_valid; r += kConsumers) {
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
  const int per = (n_valid + kConsumers - 1) / kConsumers;
  const int r0 = min(ct * per, n_valid), r1 = min(r0 + per, n_valid);
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
    seg[ns] = n_valid;
    run_seg[nr] = ns;
    *n_runs = nr;
  }
  asm volatile("bar.sync 2, %0;\n" ::"r"(kConsumers) : "memory");  // and the zeros are written
  const int runs = *n_runs, n_blocks = (n_valid + 31) >> 5, cw = ct >> 5;
  const float gb = g[b];
  for (int k = 0; k < n_chunks; ++k) {
    const int slot = k % kDepth;
    mbar_wait(full0 + 8 * slot, (k / kDepth) & 1);
    const float* ok = o_ring + (size_t)slot * CH * K * nl;
    const int i_end = min(CH, Tc - k * CH), t0 = Tc - 1 - k * CH;
    // a warp a block of 32 sorted states, a lane a state: its occupancies
    // exp(min(alpha + beta + nll, 0)) at the chunk's steps; then each
    // segment's sums, in a fixed order of shuffles within the segment, into
    // part
    for (int blk = cw; blk < n_blocks; blk += kConsumerWarps) {
      const int r = blk * 32 + lane;
      const bool in = r < n_valid;
      const int sp = in ? spos[r] : kHead;  // past the states: a head, summed into none
      const unsigned heads = __ballot_sync(0xffffffffu, sp & kHead);
      const float* o = ok + (sp & 0xffff);
      float v[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i) v[i] = in && i < i_end ? expf(fminf(o[(size_t)i * K * nl], 0.0f)) : 0.0f;
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
      grow[(size_t)(t0 - i) * C + sz[seg[run_seg[q]]]] = -acc * gb;
    }
    asm volatile("bar.sync 2, %0;\n" ::"r"(kConsumers) : "memory");  // part is free again
  }
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
  return (K == 1 || K == 2 || K == 4 || K == 8) && W >= 1 && W <= kMaxChainWarps &&
         S <= 32 * K * W;
}

// ------------------------------------------ the device-memory route --

__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }

// Forward, a CTA a row: alphas[t] from alphas[t - 1] in device memory (read
// past L1: written by other threads of the CTA before the step's barrier).
__global__ void __launch_bounds__(kLongThreads)
    ctc_alpha_long_kernel(const float* __restrict__ log_probs, const int* __restrict__ targets,
                          const int* __restrict__ input_lengths,
                          const int* __restrict__ target_lengths, float* alphas,
                          float* __restrict__ nll, int B, int T, int C, int U, int blank) {
  const int S = 2 * U + 1, b = blockIdx.x;
  const int* tgt = targets + (size_t)b * U;
  const int tl = min(target_lengths[b], U), n_valid = 2 * tl + 1;
  const int Tc = max(1, min(input_lengths[b], T));
  const float* lp = log_probs + (size_t)b * T * C;
  const size_t ts = (size_t)B * S;
  float* row = alphas + (size_t)b * S;
  for (int t = 0; t < Tc; ++t) {
    const float* prev = row + (size_t)max(t - 1, 0) * ts;
    const float* e = lp + (size_t)t * C;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const int z = label(tgt, s, blank);
      float a;
      if (t == 0) {
        a = sel(s < n_valid && s <= 1, e[z], kNegInf);
      } else {
        const bool skip = (s & 1) && s >= 2 && z != label(tgt, s - 2, blank);
        const float a1 = s >= 1 ? ld_cg(prev + s - 1) : kNegInf;
        const float a2 = skip ? ld_cg(prev + s - 2) : kNegInf;
        a = sel(s < n_valid, logaddexp3(ld_cg(prev + s), a1, a2) + e[z], kNegInf);
      }
      row[(size_t)t * ts + s] = a;
    }
    __syncthreads();  // step t is written
  }
  const float* fin = row + (size_t)(Tc - 1) * ts;
  for (int t = Tc; t < T; ++t)  // the row's input has ended: frozen
    for (int s = threadIdx.x; s < S; s += blockDim.x) row[(size_t)t * ts + s] = ld_cg(fin + s);
  if (threadIdx.x == 0) {
    const float a_end = ld_cg(fin + 2 * tl);
    const float a_last = tl > 0 ? ld_cg(fin + 2 * tl - 1) : kNegInf;
    const float m = fmaxf(a_end, a_last);
    nll[b] = -(m + log1pf(expf(-fabsf(a_end - a_last))));
  }
}

// Backward chain, a CTA a row: first warp 0 sorts the valid states by
// (class, s) into order (B, S) and the classes' run starts into cstart (B,
// C + 1) (a stable counting sort: a class's lanes found by
// __match_any_sync, ranked by the lanes below; `fill` (B, C) the running
// ends), then betas (T, B, S) from t = Tc - 1 down, beta_t from step t + 1's
// in device memory, one __syncthreads a step.
__global__ void __launch_bounds__(kLongThreads)
    ctc_beta_long_kernel(const float* __restrict__ log_probs, const int* __restrict__ targets,
                         const int* __restrict__ input_lengths,
                         const int* __restrict__ target_lengths, const float* __restrict__ nll,
                         float* betas, int* __restrict__ order, int* __restrict__ cstart,
                         int* __restrict__ fill, int B, int T, int C, int U, int blank) {
  const int S = 2 * U + 1, b = blockIdx.x;
  const int* tgt = targets + (size_t)b * U;
  const int tl = min(target_lengths[b], U), n_valid = 2 * tl + 1;
  const int Tc = min(input_lengths[b], T);
  if (Tc <= 0 || !(nll[b] < -kNegInf / 2)) return;  // the gradient kernel writes zeros
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int* start = cstart + (size_t)b * (C + 1);
    int* at = fill + (size_t)b * C;
    int* ord = order + (size_t)b * S;
    for (int c = lane; c < C; c += 32) at[c] = 0;
    __syncwarp();
    for (int pass = 0; pass < 2; ++pass) {
      for (int s0 = 0; s0 < n_valid; s0 += 32) {
        const int s = s0 + lane;
        const int z = s < n_valid ? label(tgt, s, blank) : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, z);
        const int rank = __popc(peers & ((1u << lane) - 1u));
        const int base = z >= 0 ? at[z] : 0;
        __syncwarp();
        if (z >= 0) {
          if (pass == 1) ord[base + rank] = s;
          if (rank == 0) at[z] = base + __popc(peers);
        }
        __syncwarp();
      }
      if (pass == 0 && lane == 0) {  // counts -> run starts; the running ends start there
        int acc = 0;
        for (int c = 0; c < C; ++c) {
          const int n = at[c];
          start[c] = at[c] = acc;
          acc += n;
        }
        start[C] = acc;
      }
      __syncwarp();
    }
  }
  const float* lp = log_probs + (size_t)b * T * C;
  const size_t ts = (size_t)B * S;
  float* row = betas + (size_t)b * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    row[(size_t)(Tc - 1) * ts + s] = sel(s < n_valid && (s == 2 * tl || (s == 2 * tl - 1 && tl > 0)),
                                 0.0f, kNegInf);
  __syncthreads();
  for (int t = Tc - 2; t >= 0; --t) {
    const float* nxt = row + (size_t)(t + 1) * ts;
    const float* e = lp + (size_t)(t + 1) * C;
    // x = beta + emission of step t + 1, -inf past the valid states
    auto x = [&](int q) {
      return q < n_valid ? ld_cg(nxt + q) + e[label(tgt, q, blank)] : kNegInf;
    };
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const bool skip_from = (s & 1) && s + 2 < S && label(tgt, s + 2, blank) != label(tgt, s, blank);
      const float x2 = skip_from ? x(s + 2) : kNegInf;
      row[(size_t)t * ts + s] = logaddexp3(x(s), s + 1 < S ? x(s + 1) : kNegInf, x2);
    }
    __syncthreads();  // step t is written
  }
}

// grad[b, t, c], a CTA a (step, row): warp w sums the occupancies of class
// c's sorted run (c = w, w + 8, ...), lanes strided over the run, then by
// xor shuffles; zero past the input length and for an impossible row.
__global__ void __launch_bounds__(kGradThreads)
    ctc_grad_long_kernel(const int* __restrict__ input_lengths, const float* __restrict__ alphas,
                         const float* __restrict__ betas, const float* __restrict__ nll,
                         const float* __restrict__ g, const int* __restrict__ order,
                         const int* __restrict__ cstart, float* __restrict__ grad, int B, int T,
                         int C, int U) {
  const int t = blockIdx.x, b = blockIdx.y, S = 2 * U + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  float* out = grad + ((size_t)b * T + t) * C;
  const float nb = nll[b];
  if (t >= min(input_lengths[b], T) || !(nb < -kNegInf / 2)) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) out[c] = 0.0f;
    return;
  }
  const size_t at = ((size_t)t * B + b) * S;
  const int* ord = order + (size_t)b * S;
  const int* start = cstart + (size_t)b * (C + 1);
  const float gb = g[b];
  for (int c = warp; c < C; c += nwarps) {
    float acc = 0.0f;
    for (int r = start[c] + lane; r < start[c + 1]; r += 32) {
      const int s = ord[r];
      acc += expf(fminf(alphas[at + s] + betas[at + s] + nb, 0.0f));
    }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) out[c] = -acc * gb;
  }
}

bool args_ok(int B, int T, int C, int U, int blank) {
  return B >= 1 && T >= 1 && U >= 1 && blank >= 0 && blank < C;
}

}  // namespace

// K and W come from kernels/ctc.py `ctc_plan`: K states a lane (1, 2, 4 or
// 8) in W chain warps, 32 K W >= S = 2U + 1.
extern "C" int ctc_alpha_f32(const float* log_probs, const int* targets, const int* input_lengths,
                             const int* target_lengths, float* alphas, float* nll, int B, int T,
                             int C, int U, int blank, int K, int W, void* stream) {
  if (!args_ok(B, T, C, U, blank) || !plan_ok(2 * U + 1, K, W))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(K == 1   ? launch_alpha<1>
               : K == 2 ? launch_alpha<2>
               : K == 4 ? launch_alpha<4>
                        : launch_alpha<8>)(log_probs, targets, input_lengths, target_lengths,
                                           alphas, nll, B, T, C, U, blank, W, st);
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
  return (int)(K == 1   ? launch_beta_grad<1>
               : K == 2 ? launch_beta_grad<2>
               : K == 4 ? launch_beta_grad<4>
                        : launch_beta_grad<8>)(log_probs, targets, input_lengths, target_lengths,
                                               alphas, nll, g, grad, B, T, C, U, blank, W, st);
}

// The device-memory route (any S): alphas (T, B, S) and nll (B,).
extern "C" int ctc_alpha_long_f32(const float* log_probs, const int* targets,
                                  const int* input_lengths, const int* target_lengths,
                                  float* alphas, float* nll, int B, int T, int C, int U, int blank,
                                  void* stream) {
  if (!args_ok(B, T, C, U, blank)) return (int)cudaErrorInvalidValue;
  ctc_alpha_long_kernel<<<B, kLongThreads, 0, (cudaStream_t)stream>>>(
      log_probs, targets, input_lengths, target_lengths, alphas, nll, B, T, C, U, blank);
  return (int)cudaGetLastError();
}

// The device-memory route's gradient: `betas` (T, B, S) floats and `ints`
// (B, S + 2C + 1) ints of scratch: the sorted states, the run starts and
// the sort's running ends.
extern "C" int ctc_beta_grad_long_f32(const float* log_probs, const int* targets,
                                      const int* input_lengths, const int* target_lengths,
                                      const float* alphas, const float* nll, const float* g,
                                      float* grad, float* betas, int* ints, int B, int T, int C,
                                      int U, int blank, void* stream) {
  if (!args_ok(B, T, C, U, blank) || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int S = 2 * U + 1;
  int* order = ints;
  int* cstart = order + (size_t)B * S;
  int* fill = cstart + (size_t)B * (C + 1);
  const cudaStream_t st = (cudaStream_t)stream;
  ctc_beta_long_kernel<<<B, kLongThreads, 0, st>>>(log_probs, targets, input_lengths,
                                                   target_lengths, nll, betas, order, cstart, fill,
                                                   B, T, C, U, blank);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ctc_grad_long_kernel<<<dim3(T, B), kGradThreads, 0, st>>>(input_lengths, alphas, betas, nll, g,
                                                            order, cstart, grad, B, T, C, U);
  return (int)cudaGetLastError();
}
