// The wide routes of the four recurrence kernels: LSTM and GRU recurrences
// over pre-projected inputs and their backward recurrences, at any hidden size
// H >= 1, any batch B >= 1 and one or two directions, where the narrow
// kernels of rnn.cu (K1/K7 at 4 <= H <= 288 with H % 4 == 0, K2/K8 at
// H <= 128) have no plan. kernels/rnn.py `lstm_route`/`gru_route` pick the
// route; each kernel computes exactly what its narrow twin computes.
//
// Replaces:
// - K1w `lstm_wide_fwd_cluster_kernel`, and `rec_wide_kernel<4>` where it does
//   not fit: the Pallas kernel P1 `tools/proto_pallas_rnn.py:33`
//   `pallas_lstm_rec`, the forward of `semi_tts_tpu/ops/rnn.py:95`
//   `_lstm_rec_fwd` (gates i, f, g, o; with or without the cell states);
// - K7w `lstm_wide_bwd_cluster_kernel`, and `lstm_wide_bwd_kernel` where it
//   does not fit: the backward scan of `_lstm_rec_bwd`
//   (`semi_tts_tpu/ops/rnn.py:114`);
// - K2w `gru_wide_fwd_cluster_kernel`, and `rec_wide_kernel<3>` where it does
//   not fit: `_gru_rec_fwd` (`:225`), gates r, z, n with b_hh inside the
//   recurrence, so that r gates h @ W_hn^T + b_hn;
// - K8w `gru_wide_bwd_cluster_kernel`, and `gru_wide_bwd_kernel` where it
//   does not fit: the backward scan of `_gru_rec_bwd` (`:244`).
// fp32 FFMA throughout, no tensor cores, as in the JAX recurrences.
//
// What bounds it on an H100: each step needs the whole of the previous
// step's vector (h for the forwards, the gate gradients for the backwards),
// so the time is about T x (the latency of one step). W_hh (G*H x H, 4 MiB
// for the LSTM at H=512, 16 MiB at H=1024) does not fit one SM, nor a
// cluster of 16.
//
// The first design (each where its second does not fit):
// - One cooperative launch (cudaLaunchKernelEx with the cooperative
//   attribute, so every CTA is resident at once) of at most one CTA an SM:
//   the hidden units are split over the CTAs of a direction, CTA p owning
//   units [p*U, p*U + U). Both directions run in the same launch
//   (blockIdx.y), side by side.
// - A forward CTA holds the G*U gate rows of W_hh of its units (K = H each),
//   a backward CTA the U columns of W_hh of its units, as rows of W_hh^T
//   (K = G*H each), in shared memory as far as they fit; the rest are read
//   from L2 every step (W_hh^T comes from the wrapper).
// - Each step the CTA stages the previous step's vector of up to 8 batch
//   rows at a time from L2 (ld.global.cg) into shared memory; warps take
//   groups of 4 rows and a slice of k, a lane accumulating 4 rows x 8 batch
//   rows; a transposing shuffle reduction leaves each lane one of the 32
//   sums, and partial sums of the k slices meet in shared memory.
// - The vector a step publishes is the output itself (hs, or the gate
//   gradients of K7w) or, for K8w, a double-buffered scratch of the hidden-
//   side gate gradients; then the grid meets at a barrier (a monotone
//   counter in global memory, zeroed by the wrapper: red.release.gpu to
//   arrive, ld.acquire.gpu to wait). A wait of more than 2 s traps, so a
//   lost arrival fails the launch instead of hanging the card. Only thread 0
//   of each CTA waits; the others wait at __syncthreads (no unit-lane
//   waits).
// - The cell state (K1w) and the carried gradients (K7w, K8w) of a CTA's
//   units live in a global scratch that only that CTA reads and writes, so
//   no B is too large.
// The second designs, thread-block clusters of 8 with no grid barrier, are
// described where they start below.
// Gate order is torch's: i, f, g, o for the LSTM and r, z, n for the GRU.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;   // batch rows of a staged vector chunk (at most)
constexpr int kRows = 4;    // rows of W a warp accumulates at once: kRows x kChunk = 32 sums
constexpr int kSmemLimit = 232448;

__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }

__device__ __forceinline__ float tanh_(float x) {
  return copysignf(1.0f - __fdividef(2.0f, __expf(2.0f * fabsf(x)) + 1.0f), x);
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Every CTA of the grid meets here: the `target`-th arrival on `bar` ends it.
// Each CTA's writes before the barrier are visible to every CTA after it.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(bar), "r"(1u) : "memory");
    unsigned long long t0 = 0;
    for (;;) {
      unsigned v;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(bar) : "memory");
      if (v >= target) break;
      if (t0 == 0) t0 = global_ns();
      else if (global_ns() - t0 > 2000000000ull) __trap();
    }
  }
  __syncthreads();
}

// Halving shuffle reduction: N values per lane over the lanes at distance
// S, S/2, ..., 1. While N > 1 each step keeps half the values (the upper lane
// of a pair the upper half), so after the five steps lane l holds in v[0] the
// warp's sum of value l >> (5 - log2 N).
template <int N, int S>
struct Halve {
  static __device__ __forceinline__ void run(float* v, int lane) {
    constexpr int H = N / 2;
    const bool upper = lane & S;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = upper ? v[i] : v[i + H];
      const float keep = upper ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
    }
    Halve<H, S / 2>::run(v, lane);
  }
};

template <int S>
struct Halve<1, S> {
  static __device__ __forceinline__ void run(float* v, int lane) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], S);
    Halve<1, S / 2>::run(v, lane);
  }
};

template <>
struct Halve<1, 0> {
  static __device__ __forceinline__ void run(float*, int) {}
};

// Shared-memory layout of a CTA (floats): `red` partial sums, `acc` the
// forward's gate pre-activations (chunk x rows), `vec` the staged vector
// chunk (chunk x K), `w` the staged rows (rows_smem x K).
struct Layout {
  int red, acc, vec, w, total;
};

__host__ __device__ inline Layout layout(bool fwd, int rows, int K, int chunk, int rows_smem) {
  Layout l;
  const int nrg = (rows + kRows - 1) / kRows;
  l.red = 0;
  l.acc = (nrg > kWarps ? nrg : kWarps) * 32;
  l.vec = l.acc + (fwd ? chunk * rows : 0);
  l.w = l.vec + chunk * K;
  l.total = l.w + rows_smem * K;
  return l;
}

// For the nb (<= kChunk) vectors staged in `vec` (row b at vec + b*K) and the
// `rows` rows of this CTA (row r at row(r), K values), calls out(r, b, sum of
// row(r)[k] * vec[b*K + k] over k) for every r < rows and b < nb. Warps take
// (group of kRows rows, k slice) items; ends after a __syncthreads.
template <class Row, class Out>
__device__ __forceinline__ void dot_rows(const float* vec, int K, int rows, int nb, Row row,
                                         float* red, Out out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nrg = (rows + kRows - 1) / kRows;
  const int nks = nrg >= kWarps ? 1 : kWarps / nrg;
  int off[kChunk];
#pragma unroll
  for (int b = 0; b < kChunk; ++b) off[b] = (b < nb ? b : nb - 1) * K;
  for (int item = warp; item < nrg * nks; item += kWarps) {
    const int rg = item % nrg, ks = item / nrg;
    const float* w[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) w[i] = row(min(rg * kRows + i, rows - 1));
    float a[kRows * kChunk];
#pragma unroll
    for (int i = 0; i < kRows * kChunk; ++i) a[i] = 0.0f;
    for (int k = ks * 32 + lane; k < K; k += 32 * nks) {
      float hv[kChunk];
#pragma unroll
      for (int b = 0; b < kChunk; ++b) hv[b] = vec[off[b] + k];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float wv = w[i][k];
#pragma unroll
        for (int b = 0; b < kChunk; ++b) a[i * kChunk + b] = fmaf(wv, hv[b], a[i * kChunk + b]);
      }
    }
    Halve<kRows * kChunk, 16>::run(a, lane);  // lane l: the sum of value l = (row l/8, batch l%8)
    red[(ks * nrg + rg) * 32 + lane] = a[0];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * nb; idx += kThreads) {
    const int b = idx / rows, r = idx - b * rows;
    const int rg = r / kRows, i = r - rg * kRows;
    float s = 0.0f;
    for (int ks = 0; ks < nks; ++ks) s += red[(ks * nrg + rg) * 32 + i * kChunk + b];
    out(r, b, s);
  }
  __syncthreads();
}

// Copies the first rows_smem rows (row(r), K values each) into w.
template <class Row>
__device__ __forceinline__ void stage_rows(float* w, int K, int rows_smem, Row row) {
  for (int r = 0; r < rows_smem; ++r) {
    const float* src = row(r);
    for (int k = threadIdx.x; k < K; k += kThreads) w[r * K + k] = __ldg(src + k);
  }
  __syncthreads();
}

// Stages nb rows of a vector, row b at src + b*stride (K values), into vec
// (row b at vec + b*K): a thread keeps kChunk x kStage loads in flight.
constexpr int kStage = 2;

__device__ __forceinline__ void stage_vec(float* vec, const float* src, size_t stride, int K,
                                          int nb) {
  for (int k0 = threadIdx.x; k0 < K; k0 += kThreads * kStage) {
    float v[kChunk][kStage];
#pragma unroll
    for (int b = 0; b < kChunk; ++b)
#pragma unroll
      for (int u = 0; u < kStage; ++u)
        if (b < nb && k0 + u * kThreads < K) v[b][u] = __ldcg(src + b * stride + k0 + u * kThreads);
#pragma unroll
    for (int b = 0; b < kChunk; ++b)
#pragma unroll
      for (int u = 0; u < kStage; ++u)
        if (b < nb && k0 + u * kThreads < K) vec[b * K + k0 + u * kThreads] = v[b][u];
  }
  __syncthreads();
}

struct Fwd {
  const float* x[2];    // x_proj (T, B, G*H) of each direction
  const float* w[2];    // W_hh (G*H, H)
  const float* b[2];    // b_hh (G*H), GRU only
  int rev[2];
  float* hs;            // (T, B, ndir*H)
  float* cs;            // (T, B, ndir*H) or null, LSTM only
  float* state;         // (ndir, B, H) cell states, LSTM only
  unsigned* bar;
  int T, B, H, ndir, U, chunk, rows_smem;
};

// K1w (G = 4) and K2w (G = 3).
template <int G>
__global__ void __launch_bounds__(kThreads, 1) rec_wide_kernel(Fwd p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dir = blockIdx.y, H = p.H, B = p.B, T = p.T, U = p.U;
  const int u0 = blockIdx.x * U, uv = min(U, H - u0), rows = G * U, ld = p.ndir * H;
  const int col = dir * H;
  const float* x = p.x[dir];
  const float* W = p.w[dir];
  const Layout L = layout(true, rows, H, p.chunk, p.rows_smem);
  float *red = smem + L.red, *acc = smem + L.acc, *vec = smem + L.vec, *ws = smem + L.w;
  auto global_row = [&](int r) {
    const int g = r / U, u = min(r - g * U, uv - 1);
    return W + (size_t)(g * H + u0 + u) * H;
  };
  stage_rows(ws, H, p.rows_smem, global_row);
  auto row = [&](int r) { return r < p.rows_smem ? ws + r * H : global_row(r); };
  const unsigned nblocks = gridDim.x * gridDim.y;
  int c0_ = 0;  // the chunk's first batch row
  for (int s = 0; s < T; ++s) {
    const int t = p.rev[dir] ? T - 1 - s : s;
    const int tp = p.rev[dir] ? t + 1 : t - 1;
    // A cell's inputs: its G gate inputs (the GRU's r and z biases folded
    // in) and, last, the LSTM's cell state or the GRU's b_hn.
    auto load = [&](int i, float(&in)[G + 1]) {
      const int bl = i / uv, b = c0_ + bl, j = u0 + (i - bl * uv);
      const float* xr = x + ((size_t)t * B + b) * G * H;
#pragma unroll
      for (int g = 0; g < G; ++g) in[g] = xr[g * H + j];
      if (G == 4) {
        in[G] = s > 0 ? p.state[((size_t)dir * B + b) * H + j] : 0.0f;
      } else {
        const float* bh = p.b[dir];
        in[0] += bh[j];
        in[1] += bh[H + j];
        in[G] = bh[2 * H + j];
      }
    };
    auto cell = [&](int i, const float(&in)[G + 1]) {
      const int bl = i / uv, u = i - bl * uv, b = c0_ + bl, j = u0 + u;
      float pre[G];
#pragma unroll
      for (int g = 0; g < G; ++g) pre[g] = s > 0 ? acc[bl * rows + g * U + u] : 0.0f;
      const size_t o = ((size_t)t * B + b) * ld + col + j;
      if (G == 4) {
        const float ig = sigmoid(in[0] + pre[0]), fg = sigmoid(in[1] + pre[1]);
        const float gg = tanh_(in[2] + pre[2]), og = sigmoid(in[3] + pre[3]);
        const float c = fg * in[G] + ig * gg;
        p.hs[o] = og * tanh_(c);
        if (p.cs) p.cs[o] = c;
        p.state[((size_t)dir * B + b) * H + j] = c;
      } else {
        const float r = sigmoid(in[0] + pre[0]), z = sigmoid(in[1] + pre[1]);
        const float n = tanh_(in[2] + r * (pre[2] + in[G]));
        const float h_prev = s > 0 ? vec[bl * H + j] : 0.0f;
        p.hs[o] = (1.0f - z) * n + z * h_prev;
      }
    };
    for (c0_ = 0; c0_ < B; c0_ += p.chunk) {
      const int nb = min(p.chunk, B - c0_), c0 = c0_;
      // the first cell's inputs are loaded before the product, which hides
      // their latency
      float first[G + 1];
      if (threadIdx.x < nb * uv) load(threadIdx.x, first);
      if (s > 0) {
        __syncthreads();  // the last chunk's cell updates have read vec and acc
        stage_vec(vec, p.hs + ((size_t)tp * B + c0) * ld + col, ld, H, nb);
        dot_rows(vec, H, rows, nb, row, red,
                 [&](int r, int b, float v) { acc[b * rows + r] = v; });
      }
      if (threadIdx.x < nb * uv) cell(threadIdx.x, first);
      for (int i = threadIdx.x + kThreads; i < nb * uv; i += kThreads) {
        float in[G + 1];
        load(i, in);
        cell(i, in);
      }
    }
    if (s + 1 < T) grid_sync(p.bar, (unsigned)(s + 1) * nblocks);
  }
}

struct LstmBwd {
  const float* gates[2];  // gate pre-activations (T, B, 4H)
  const float* wt[2];     // W_hh^T (H, 4H)
  float* dg[2];           // gate gradients (T, B, 4H)
  int rev[2];
  const float* cs;        // (T, B, ndir*H)
  const float* g_hs;      // (T, B, ndir*H)
  float* dh;              // (ndir, B, H) carried dh
  float* dc;              // (ndir, B, H) carried dc
  unsigned* bar;
  int T, B, H, ndir, U, chunk, rows_smem;
};

// K7w. Step s: the gate gradients of the CTA's units (phase A), published in
// dg; the barrier; then dh_rec = dg_t @ W_hh for the CTA's units (phase B).
__global__ void __launch_bounds__(kThreads, 1) lstm_wide_bwd_kernel(LstmBwd p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dir = blockIdx.y, H = p.H, B = p.B, T = p.T, U = p.U, K = 4 * H;
  const int u0 = blockIdx.x * U, uv = min(U, H - u0), ld = p.ndir * H, col = dir * H;
  const float* WT = p.wt[dir];
  const Layout L = layout(false, U, K, p.chunk, p.rows_smem);
  float *red = smem + L.red, *vec = smem + L.vec, *ws = smem + L.w;
  auto global_row = [&](int r) { return WT + (size_t)(u0 + min(r, uv - 1)) * K; };
  stage_rows(ws, K, p.rows_smem, global_row);
  auto row = [&](int r) { return r < p.rows_smem ? ws + r * K : global_row(r); };
  const unsigned nblocks = gridDim.x * gridDim.y;
  const int rev = p.rev[dir];
  // A unit's phase-A inputs at step s (the time axis walked opposite to the
  // forward's): its 4 gate pre-activations, its cell state, the cell state
  // the step consumed and the incoming gradient.
  auto load = [&](int s, int i, float(&in)[7]) {
    const int t = rev ? s : T - 1 - s, tc = rev ? t + 1 : t - 1;
    const int b = i / uv, j = u0 + (i - b * uv);
    const float* gr = p.gates[dir] + ((size_t)t * B + b) * K;
#pragma unroll
    for (int g = 0; g < 4; ++g) in[g] = gr[g * H + j];
    const size_t o = ((size_t)t * B + b) * ld + col + j;
    in[4] = p.cs[o];
    in[5] = tc >= 0 && tc < T ? p.cs[((size_t)tc * B + b) * ld + col + j] : 0.0f;
    in[6] = p.g_hs[o];
  };
  auto cell = [&](int s, int i, const float(&in)[7]) {
    const int t = rev ? s : T - 1 - s;
    const int b = i / uv, j = u0 + (i - b * uv);
    const size_t st = ((size_t)dir * B + b) * H + j;
    const float ia = sigmoid(in[0]), fa = sigmoid(in[1]), ga = tanh_(in[2]), oa = sigmoid(in[3]);
    const float tc_ = tanh_(in[4]);
    const float dh = in[6] + (s > 0 ? p.dh[st] : 0.0f);
    const float dc = (s > 0 ? p.dc[st] : 0.0f) + dh * oa * (1.0f - tc_ * tc_);
    float* d = p.dg[dir] + ((size_t)t * B + b) * K;
    d[j] = dc * ga * ia * (1.0f - ia);
    d[H + j] = dc * in[5] * fa * (1.0f - fa);
    d[2 * H + j] = dc * ia * (1.0f - ga * ga);
    d[3 * H + j] = dh * tc_ * oa * (1.0f - oa);
    p.dc[st] = dc * fa;
  };
  // the inputs of the thread's first unit are loaded a step ahead, so that
  // their latency hides behind the barrier and phase B
  float first[7];
  if (threadIdx.x < B * uv) load(0, threadIdx.x, first);
  for (int s = 0; s < T; ++s) {
    const int t = rev ? s : T - 1 - s;
    if (threadIdx.x < B * uv) cell(s, threadIdx.x, first);
    for (int i = threadIdx.x + kThreads; i < B * uv; i += kThreads) {
      float in[7];
      load(s, i, in);
      cell(s, i, in);
    }
    if (s + 1 == T) break;
    if (threadIdx.x < B * uv) load(s + 1, threadIdx.x, first);
    grid_sync(p.bar, (unsigned)(s + 1) * nblocks);
    for (int c0 = 0; c0 < B; c0 += p.chunk) {
      const int nb = min(p.chunk, B - c0);
      stage_vec(vec, p.dg[dir] + ((size_t)t * B + c0) * K, K, K, nb);
      dot_rows(vec, K, U, nb, row, red, [&](int r, int b, float v) {
        if (r < uv) p.dh[((size_t)dir * B + c0 + b) * H + u0 + r] = v;
      });
    }
  }
}

// ------------------------------ K7w and K8w, the second design: clusters --
//
// What held the first design back (chip_ablate.py --k7w's cuts, PERF.md): a
// grid barrier a step over every CTA, then each CTA staging the step's whole
// B x G*H vector (the LSTM's gate gradients, the GRU's coef_h * [dh2, dh2,
// dh2]) from L2 (64 KiB a CTA at B=8, H=512, G=4). Here CTA p keeps the G*U
// gate rows of W_hh (G*H x H, not transposed) of its own units, the same
// bytes K1w's forward keeps, and multiplies its own part of that vector (B x
// G*U, in shared memory: it never goes through L2 to be read back) by them
// into a partial dh_rec over all H units (phase B1). The partials meet in a
// reduce-scatter: within a thread-block cluster of kCl CTAs over distributed
// shared memory, CTA r summing, in rank order, the cluster's partials of
// column slice r (cw = ceil(H/32)*4 columns from r*cw, float4 reads where
// the rows allow) and publishing them to `pub` in L2 with a step-stamped
// flag (released at gpu scope, phase B2); then each CTA reads, once the
// flags of the clusters' CTAs whose slices hold its units say so
// (acquired), the M clusters' sums of its units and adds them in cluster
// order (phase C): its dh_rec, kept in shared memory with what its units
// carry (the LSTM's dc; the GRU's dh2 * z, added to the sums). One cluster
// barrier and a few flag waits a step instead of a grid barrier; M x B x U
// floats read from L2 a CTA instead of B x G*H. Every CTA waits on others,
// so the whole grid must be resident at once: the launch is cooperative (a
// grid too large fails it), sized by the plan with
// cudaOccupancyMaxActiveClusters (`wide_cluster_max_clusters`), at one CTA
// an SM (shared memory padded to kOneCtaSmem: two CTAs of a cluster on one
// SM would halve its step's FMA rate). Fixed summation orders throughout: a
// rerun is bit for bit. Partials and published sums are double-buffered by
// step parity (a CTA writes a buffer again only two steps later, after the
// barrier and flags that its readers passed). The GRU's design is the
// LSTM's at three gates with its own phase A (`gru_wide_bwd_kernel`'s).
constexpr int kCl = 8;                    // CTAs a cluster (WIDE_CLUSTER)
constexpr size_t kOneCtaSmem = 116 * 1024;  // past half an SM's shared memory (WIDE_ONE_CTA_SMEM)

struct BwdCl {
  const float* in[2];     // LSTM: gate pre-activations (T, B, 4H); GRU: coef_h (T, B, 3H)
  const float* z[2];      // GRU: update gates (T, B, H)
  const float* w[2];      // W_hh (G*H, H)
  float* out[2];          // LSTM: gate gradients (T, B, 4H); GRU: dh2 (T, B, H)
  int rev[2];
  const float* cs;        // LSTM: (T, B, ndir*H)
  const float* g_hs;      // (T, B, ndir*H)
  float* pub;             // (2, ndir, M, B, H): each cluster's sums of the partials
  unsigned* flags;        // (ndir, M, kCl), zeroed: the steps each CTA has published
  int T, B, H, ndir, U;
  int rows;               // batch rows of a chunk of the partials: B, or a multiple of kChunk
};

__device__ __forceinline__ void cl_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" :::
                   "memory");
}

__device__ __forceinline__ int cl_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// The float (float4) at shared address a of CTA `rank` of the cluster.
__device__ __forceinline__ unsigned peer_addr(unsigned a, int rank) {
  unsigned m;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(m) : "r"(a), "r"(rank));
  return m;
}

__device__ __forceinline__ float ld_peer(unsigned a, int rank) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(peer_addr(a, rank)) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_peer4(unsigned a, int rank) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(peer_addr(a, rank))
               : "memory");
  return v;
}

// Waits until the flag at f reads at least `step` (acquired at gpu scope);
// traps after 2 s, so that a lost publication fails the launch.
__device__ __forceinline__ void wait_flag(const unsigned* f, unsigned step) {
  unsigned long long t0 = 0;
  for (;;) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(f) : "memory");
    if (v >= step) break;
    if (t0 == 0) t0 = global_ns();
    else if (global_ns() - t0 > 2000000000ull) __trap();
  }
}

// A cluster rank's slice of the H columns: cw = ceil(H / 32) * 4 from r * cw.
__host__ __device__ inline int slice_cols(int H) { return (H + 4 * kCl - 1) / (4 * kCl) * 4; }

// Shared-memory bytes of a cluster-design backward CTA (kernels/rnn.py
// `_cluster_smem`): its part of the step's vector (ceil(B/8), G*U, 8: a gate
// row's 8 batch rows are two float4 broadcasts), its dh_rec and carried
// values (B, U each, each from a 16-byte boundary), its G*U rows of W_hh,
// the partials of `rows` batch rows at a time (2, rows, H); at least
// kOneCtaSmem.
__host__ __device__ inline size_t bu_floats(int B, int U) { return ((size_t)B * U + 3) / 4 * 4; }
__host__ __device__ inline size_t cluster_smem_bytes(int G, int B, int H, int U, int rows) {
  const size_t f = (size_t)(B + kChunk - 1) / kChunk * kChunk * G * U + 2 * bu_floats(B, U) +
                   (size_t)G * U * H + 2 * (size_t)rows * H;
  return 4 * f > kOneCtaSmem ? 4 * f : kOneCtaSmem;
}

// The cluster design of the backwards, G = 4 (K7w) or 3 (K8w): grid (N,
// ndir), clusters of kCl CTAs along x; kKpt columns of dh_rec a thread
// accumulates at once (1, 2 or 4: the fewest passes over H).
template <int G, int kKpt>
__device__ __forceinline__ void bwd_cluster(const BwdCl& p, float* smem) {
  const int dir = blockIdx.y, H = p.H, B = p.B, T = p.T, U = p.U, G4 = G * U;
  const int N = gridDim.x, M = N / kCl, cta = blockIdx.x, r = cl_rank(), c = cta / kCl;
  const int u0 = cta * U, uv = max(0, min(U, H - u0)), ld = p.ndir * H, col = dir * H;
  const int nbc = (B + kChunk - 1) / kChunk;      // chunks of 8 batch rows
  float* dgs = smem;                              // (nbc, G*U, 8) this step's vector
  float* dhs = dgs + (size_t)nbc * G4 * kChunk;   // (B, U) dh_rec of the units
  float* dcs = dhs + bu_floats(B, U);             // (B, U) carried: dc, or dh2 * z
  float* ws = dcs + bu_floats(B, U);              // (G*U, H): row g*U + u
  float* part = ws + (size_t)G4 * H;              // (2, rows, H) partial dh_rec, read by peers
  const float* W = p.w[dir];
  // gate row g*U + u of W_hh: row g*H + u0 + u (a CTA past the units keeps a
  // real row; its part of the vector is 0)
  for (int i = threadIdx.x; i < nbc * G4 * kChunk; i += kThreads) dgs[i] = 0.0f;
  stage_rows(ws, H, G4, [&](int rr) {
    const int g = rr / U, u = rr - g * U;
    return W + (size_t)(g * H + min(u0 + u, H - 1)) * H;
  });
  const int rev = p.rev[dir];
  // A unit's phase-A inputs at step s (the time axis walked opposite to the
  // forward's). LSTM: its 4 gate pre-activations, its cell state, the cell
  // state the step consumed and the incoming gradient; GRU: the incoming
  // gradient, its 3 coefficients and its update gate.
  constexpr int kIn = G == 4 ? 7 : 5;
  auto load = [&](int s, int i, float(&in)[kIn]) {
    const int t = rev ? s : T - 1 - s;
    const int b = i / uv, j = u0 + (i - b * uv);
    const size_t tb = (size_t)t * B + b, o = tb * ld + col + j;
    const float* gr = p.in[dir] + tb * G * H;
    if constexpr (G == 4) {
      const int tc = rev ? t + 1 : t - 1;
#pragma unroll
      for (int g = 0; g < 4; ++g) in[g] = gr[g * H + j];
      in[4] = p.cs[o];
      in[5] = tc >= 0 && tc < T ? p.cs[((size_t)tc * B + b) * ld + col + j] : 0.0f;
      in[6] = p.g_hs[o];
    } else {
      in[0] = p.g_hs[o];
#pragma unroll
      for (int g = 0; g < 3; ++g) in[1 + g] = gr[g * H + j];
      in[4] = p.z[dir][tb * H + j];
    }
  };
  auto cell = [&](int s, int i, const float(&in)[kIn]) {
    const int t = rev ? s : T - 1 - s;
    const int b = i / uv, u = i - b * uv, j = u0 + u;
    float* e = dgs + ((size_t)(b / kChunk) * G4 + u) * kChunk + b % kChunk;
    if constexpr (G == 4) {
      const float ia = sigmoid(in[0]), fa = sigmoid(in[1]), ga = tanh_(in[2]), oa = sigmoid(in[3]);
      const float tc_ = tanh_(in[4]);
      const float dh = in[6] + (s > 0 ? dhs[b * U + u] : 0.0f);
      const float dc = (s > 0 ? dcs[b * U + u] : 0.0f) + dh * oa * (1.0f - tc_ * tc_);
      const float d0 = dc * ga * ia * (1.0f - ia), d1 = dc * in[5] * fa * (1.0f - fa);
      const float d2 = dc * ia * (1.0f - ga * ga), d3 = dh * tc_ * oa * (1.0f - oa);
      float* d = p.out[dir] + ((size_t)t * B + b) * 4 * H;
      d[j] = d0;
      d[H + j] = d1;
      d[2 * H + j] = d2;
      d[3 * H + j] = d3;
      e[0] = d0;
      e[U * kChunk] = d1;
      e[2 * U * kChunk] = d2;
      e[3 * U * kChunk] = d3;
      dcs[b * U + u] = dc * fa;
    } else {
      const float d = in[0] + (s > 0 ? dhs[b * U + u] : 0.0f);
      p.out[dir][((size_t)t * B + b) * H + j] = d;
#pragma unroll
      for (int g = 0; g < 3; ++g) e[g * U * kChunk] = in[1 + g] * d;
      dcs[b * U + u] = d * in[4];
    }
  };
  unsigned* flags = p.flags + (size_t)dir * M * kCl;
  const int cw = slice_cols(H), k_lo = r * cw, k_hi = min(H, k_lo + cw);  // this rank's slice
  // the nr ranks from r_lo whose slices hold this CTA's units (none past them)
  const int r_lo = uv > 0 ? u0 / cw : 0, nr = uv > 0 ? (u0 + uv - 1) / cw - r_lo + 1 : 0;
  const bool vec = H % 4 == 0;  // partial rows and slices in whole float4s
  const int lane = threadIdx.x & 31;
  float first[kIn];  // the inputs of the thread's first unit, loaded a step ahead
  if (threadIdx.x < B * uv) load(0, threadIdx.x, first);
  for (int s = 0; s < T; ++s) {
    const int buf = s & 1;
    // phase A: the CTA's part of the step's vector
    if (threadIdx.x < B * uv) cell(s, threadIdx.x, first);
    for (int i = threadIdx.x + kThreads; i < B * uv; i += kThreads) {
      float in[kIn];
      load(s, i, in);
      cell(s, i, in);
    }
    if (s + 1 == T) break;
    if (threadIdx.x < B * uv) load(s + 1, threadIdx.x, first);
    __syncthreads();  // the gate gradients are in dgs
    // phases B1 and B2 a chunk of `rows` batch rows at a time (one chunk
    // where the partials of all B rows fit), the partials double-buffered by
    // the chunks' running count: a CTA writes a buffer again only after the
    // cluster barrier of the next chunk, which its peers pass once they have
    // read it
    float* pub = p.pub + (((size_t)buf * p.ndir + dir) * M + c) * (size_t)B * H;
    const int rows = p.rows, nch = (B + rows - 1) / rows;
    for (int ci = 0; ci < nch; ++ci) {
      const int c0 = ci * rows, c1 = min(B, c0 + rows);
      // phase B1: part[b][k] = sum over the G*U rows (in order) of dgs[b][row] W[row][k]
      float* pb = part + (size_t)((s * nch + ci) & 1) * rows * H;
      for (int b0 = c0; b0 < c1; b0 += kChunk) {
        const int nb = min(kChunk, c1 - b0);
        const float4* dp =
            reinterpret_cast<const float4*>(dgs + (size_t)(b0 / kChunk) * G4 * kChunk);
        for (int k0 = threadIdx.x; k0 < H; k0 += kThreads * kKpt) {
          float acc[kKpt][kChunk];
#pragma unroll
          for (int j = 0; j < kKpt; ++j)
#pragma unroll
            for (int bb = 0; bb < kChunk; ++bb) acc[j][bb] = 0.0f;
          const float* wc = ws + k0;
#pragma unroll 4
          for (int rr = 0; rr < G4; ++rr, wc += H) {
            const float4 x = dp[2 * rr], y = dp[2 * rr + 1];  // batch rows past B hold 0
            const float dv[kChunk] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
            for (int j = 0; j < kKpt; ++j) {
              const float w = k0 + j * kThreads < H ? wc[j * kThreads] : 0.0f;
#pragma unroll
              for (int bb = 0; bb < kChunk; ++bb) acc[j][bb] = fmaf(dv[bb], w, acc[j][bb]);
            }
          }
#pragma unroll
          for (int j = 0; j < kKpt; ++j) {
            const int k = k0 + j * kThreads;
#pragma unroll
            for (int bb = 0; bb < kChunk; ++bb)
              if (k < H && bb < nb) pb[(size_t)(b0 - c0 + bb) * H + k] = acc[j][bb];
          }
        }
      }
      cl_sync();  // every CTA of the cluster has its partials of the chunk in
      // phase B2: the cluster's sums of this rank's column slice, the peers'
      // partials in rank order, published
      const unsigned pa = (unsigned)__cvta_generic_to_shared(pb);
      const int nrow = c1 - c0;
      if (vec) {
        const int c4 = (k_hi - k_lo + 3) / 4;
        for (int i = threadIdx.x; i < nrow * c4; i += kThreads) {
          const int b = i / c4, k = k_lo + 4 * (i - b * c4);
          const unsigned at = pa + 4u * (unsigned)(b * H + k);
          float4 acc = ld_peer4(at, 0);
#pragma unroll
          for (int q = 1; q < kCl; ++q) {
            const float4 v = ld_peer4(at, q);
            acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
          }
          *reinterpret_cast<float4*>(pub + (size_t)(c0 + b) * H + k) = acc;
        }
      } else {
        for (int i = threadIdx.x; i < nrow * (k_hi - k_lo); i += kThreads) {
          const int b = i / (k_hi - k_lo), k = k_lo + i - b * (k_hi - k_lo);
          const unsigned at = pa + 4u * (unsigned)(b * H + k);
          float acc = ld_peer(at, 0);
#pragma unroll
          for (int q = 1; q < kCl; ++q) acc += ld_peer(at, q);
          pub[(size_t)(c0 + b) * H + k] = acc;
        }
      }
    }
    __syncthreads();  // this CTA's slice is written
    if (threadIdx.x == 0)
      asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(flags + c * kCl + r), "r"((unsigned)s + 1)
                   : "memory");
    // phase C: once every cluster's CTAs whose slices hold this CTA's units
    // have published this step, its dh_rec: the clusters' sums in cluster order
    if (threadIdx.x < 32) {
      for (int f = lane; f < M * nr; f += 32)
        wait_flag(flags + (f / nr) * kCl + r_lo + f % nr, s + 1);
      __syncwarp();
    }
    __syncthreads();
    const float* pr = p.pub + ((size_t)buf * p.ndir + dir) * M * (size_t)B * H + u0;
    for (int i = threadIdx.x; i < B * uv; i += kThreads) {
      const int b = i / uv, u = i - b * uv;
      float acc = 0.0f;
      for (int m = 0; m < M; ++m) acc += __ldcg(pr + ((size_t)m * B + b) * H + u);
      // the GRU's dh_rec = dh2 * z + the product (one rounding, either order)
      dhs[b * U + u] = G == 4 ? acc : acc + dcs[b * U + u];
    }
    __syncthreads();  // dh_rec is in dhs for the next step's phase A
  }
  cl_sync();  // no CTA leaves while a peer may still read its partials
}

template <int kKpt>
__global__ void __launch_bounds__(kThreads, 1) lstm_wide_bwd_cluster_kernel(BwdCl p) {
  extern __shared__ float4 smem4[];
  bwd_cluster<4, kKpt>(p, reinterpret_cast<float*>(smem4));
}

template <int kKpt>
__global__ void __launch_bounds__(kThreads, 1) gru_wide_bwd_cluster_kernel(BwdCl p) {
  extern __shared__ float4 smem4[];
  bwd_cluster<3, kKpt>(p, reinterpret_cast<float*>(smem4));
}

// ------------------------- K1w and K2w, the second design: an all-gather --
//
// The forward's product needs all of h_{t-1} (B x H) in every CTA, so a
// reduce-scatter as K7w's would move B x G*H partials, G times the bytes.
// Here each CTA keeps its units' G*U gate rows of W_hh in shared memory, as
// the first design, and h reaches it by an all-gather instead of a grid
// barrier and a staging of the whole h from L2:
// - within a thread-block cluster of kCl CTAs, each CTA stores its B x U
//   slice of h_t into every CTA of the cluster (itself too) by st.async,
//   whose bytes complete the receiver's mbarrier of that step's parity (B x
//   kc x 4 bytes a phase: no cluster barrier a step);
// - between clusters, h_t goes through L2 as 8-byte words of (h, step + 1),
//   written and read whole, by step parity: a reader that sees the step
//   sees the value, with no flag and no fence between. A CTA loads the
//   other clusters' words of its chunk before it waits on its own cluster's
//   mbarrier, and loads again, all at once, only the words not yet at the
//   step, so that their L2 round trips run under that wait and under the
//   product on its own cluster's columns.
// W_hh's columns are kept rotated to start at the cluster's own, so both
// parts of the product are contiguous. What the first design's cuts found
// slowest was its product (2.8 of a 5.7 us step at T=133 B=8 H=512 ndir=2,
// chip_ablate.py --k1w): a warp a group of 4 rows reduced by shuffles. Here
// thread (g, s) holds 4 gate rows x 8 batch rows of sums over slice s of
// the own and then of the other columns (a float4 of W_hh, stored
// column-major, and two float4 broadcasts of h a column: 32 FMAs to 3
// loads), and the slices' partials meet in shared memory, summed in slice
// order: a fixed order, so a rerun is bit for bit. The G*U gate rows are
// taken 4 at a time, so the GRU's plan takes U a multiple of 4 (no zero
// fourth gate: its 3U rows are 3U/4 groups). The cell states of the LSTM's
// units, or h_{t-1} of the GRU's (for z * h), stay in shared memory, and
// the GRU's b_hh of its units too (b_hr, b_hz added to the gate inputs,
// b_hn to the hidden product before r scales it); x_proj of the next step
// is prefetched into shared memory (cp.async) while a step runs. One CTA an
// SM, a cooperative clustered launch sized by
// cudaOccupancyMaxActiveClusters, batch rows kChunk at a time. The first
// design stays where a CTA's rows of W_hh and buffers do not fit
// (kernels/rnn.py `wide_fwd_plan`).
constexpr int kGather = 16;  // loads a thread keeps in flight staging the other clusters' columns
constexpr int kMaxSlices = 64;  // column slices of the product, at most

struct FwdCl {
  const float* x[2];   // x_proj (T, B, G*H) of each direction
  const float* w[2];   // W_hh (G*H, H)
  const float* b[2];   // b_hh (3H), GRU only
  int rev[2];
  float* hs;           // (T, B, ndir*H)
  float* cs;           // (T, B, ndir*H) or null, LSTM only
  unsigned long long* hx;  // (2, ndir, B, H), zeroed: words (h, its step + 1), by step parity
  int T, B, H, ndir, U;
};

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` of this CTA's mbarrier `bar` has
// completed, acquiring at cluster scope what peers' asynchronous stores
// wrote; traps after 2 s.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned long long t0 = 0;
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.test_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = global_ns();
    else if (global_ns() - t0 > 2000000000ull) __trap();
  }
}

// An asynchronous store of a float into shared address `dst` of the cluster's
// window, its 4 bytes completing the mbarrier `bar` (in the window).
__device__ __forceinline__ void st_async(unsigned dst, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(
                   dst),
               "f"(v), "r"(bar)
               : "memory");
}

// A word of h and its step: 8 bytes, written and read whole (single-copy
// atomic), so that a reader that sees the step sees the value, with no fence
// and no flag between.
__device__ __forceinline__ void st_word(unsigned long long* a, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(a), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_word(const unsigned long long* a) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n" : "=l"(v) : "l"(a) : "memory");
  return v;
}

// Shared-memory layout of a K1w (G = 4) or K2w (G = 3) cluster-design CTA
// (floats; kernels/rnn.py `_fwd_cluster_smem`), R = G*U gate rows (a
// multiple of 4) in R / 4 groups of 4: `red` the slices' partial sums (32,
// kThreads + R/4: a row's stride R/4 past the threads keeps the slice-order
// sums free of bank conflicts), `acc` a chunk's gate pre-activations
// (kChunk, R), `vec` the other clusters' columns of a chunk (H, kChunk),
// `own` the cluster's columns of h (2, ceil(B/8), kCl*U, kChunk), `xs`
// x_proj of the CTA's units (2, B, R), `cst` the LSTM's cell states or the
// GRU's h_{t-1} of its units (B, U), `bias` the GRU's b_hh of its gate rows
// (R; none for the LSTM), `w` the R gate rows column-major (H, R), `bar` the
// two mbarriers of `own`; at least kOneCtaSmem bytes.
struct FwdLayout {
  int red, acc, vec, own, xs, cst, bias, w, bar, total;
};

__host__ __device__ inline FwdLayout fwd_layout(int G, int B, int H, int U) {
  FwdLayout l;
  const int R = G * U, nbc = (B + kChunk - 1) / kChunk;
  l.red = 0;
  l.acc = 32 * (kThreads + R / 4);
  l.vec = l.acc + kChunk * R;
  l.own = l.vec + kChunk * H;
  l.xs = l.own + 2 * nbc * kCl * U * kChunk;
  l.cst = l.xs + 2 * B * R;
  l.bias = l.cst + (int)bu_floats(B, U);
  l.w = l.bias + (G == 3 ? R : 0);
  l.bar = (l.w + R * H + 1) / 2 * 2;
  l.total = l.bar + 4;
  return l;
}

__host__ __device__ inline size_t fwd_cluster_smem_bytes(int G, int B, int H, int U) {
  const size_t b = 4 * (size_t)fwd_layout(G, B, H, U).total;
  return b > kOneCtaSmem ? b : kOneCtaSmem;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a[i][b] += the sum over k in [lo, hi) of w[k * R + 4g + i] * h[k * 8 + b]
__device__ __forceinline__ void fma_cols(const float* h, const float* w, int R, int g, int lo,
                                         int hi, float (&a)[4][kChunk]) {
#pragma unroll 4
  for (int k = lo; k < hi; ++k) {
    const float4 w4 = *reinterpret_cast<const float4*>(w + (size_t)k * R + 4 * g);
    const float4 h0 = *reinterpret_cast<const float4*>(h + k * kChunk);
    const float4 h1 = *reinterpret_cast<const float4*>(h + k * kChunk + 4);
    const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
    const float hv[kChunk] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < kChunk; ++b) a[i][b] = fmaf(wv[i], hv[b], a[i][b]);
  }
}

// The forwards' cluster design, G = 4 (K1w) or 3 (K2w): grid (N, ndir),
// clusters of kCl CTAs along x.
template <int G>
__device__ __forceinline__ void fwd_cluster(const FwdCl& p, float* smem) {
  const int dir = blockIdx.y, H = p.H, B = p.B, T = p.T, U = p.U, R = G * U;
  const int M = gridDim.x / kCl, rank = cl_rank(), cl = blockIdx.x / kCl;
  const int u0 = blockIdx.x * U, uv = max(0, min(U, H - u0)), ld = p.ndir * H, col = dir * H;
  // the cluster's own columns [k0, k0 + kc); the others' ko from k0 + kc on, mod H
  const int k0 = cl * kCl * U, kc = min(kCl * U, H - k0), ko = H - kc;
  const int nbc = (B + kChunk - 1) / kChunk;
  const FwdLayout L = fwd_layout(G, B, H, U);
  float *red = smem + L.red, *acc = smem + L.acc, *vec = smem + L.vec, *own = smem + L.own;
  float *xs = smem + L.xs, *cst = smem + L.cst, *bias = smem + L.bias, *ws = smem + L.w;
  const float* x = p.x[dir];
  const float* W = p.w[dir];
  const int rev = p.rev[dir];
  // thread (g, s): gate rows 4g .. 4g + 3 over column slice s of S
  const int NG = R / 4, S = min(kThreads / NG, kMaxSlices), tg = threadIdx.x % NG,
            ts = threadIdx.x / NG;
  // x_proj of step s of the CTA's units into xs[s & 1] (one commit group)
  auto prefetch = [&](int s) {
    const int t = rev ? T - 1 - s : s;
    float* dst = xs + (size_t)(s & 1) * B * R;
    for (int i = threadIdx.x; i < B * G * uv; i += kThreads) {
      const int b = i / (G * uv), q = i - b * G * uv, g = q / uv, u = q - g * uv;
      cp_async4(dst + b * R + g * U + u, x + ((size_t)t * B + b) * G * H + g * H + u0 + u);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  prefetch(0);
  // gate row r = g*U + u of W_hh (row g*H + u0 + u; a CTA past the units
  // keeps a real row) at ws[j * R + r], its columns rotated to start at k0
  for (int i = threadIdx.x; i < R * H; i += kThreads) {
    const int r = i / H, j = i - r * H, g = r / U, u = r - g * U;
    ws[(size_t)j * R + r] = __ldg(W + (size_t)(g * H + min(u0 + u, H - 1)) * H + (k0 + j) % H);
  }
  if (G == 3)  // the GRU's b_hh of the same rows
    for (int r = threadIdx.x; r < R; r += kThreads) {
      const int g = r / U, u = r - g * U;
      bias[r] = __ldg(p.b[dir] + g * H + min(u0 + u, H - 1));
    }
  // own[p]'s mbarrier: one arrival (this CTA's, with the bytes the cluster
  // stores into it a step) a phase; initialised before any peer stores
  const unsigned bar0 = (unsigned)__cvta_generic_to_shared(smem + L.bar);
  if (threadIdx.x == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cl_sync();
  for (int s = 0; s < T; ++s) {
    const int t = rev ? T - 1 - s : s, tp = rev ? t + 1 : t - 1;
    if (s + 1 < T) prefetch(s + 1);  // its buffer's last reader, step s - 1, is done
    // the cluster's h_t lands in own[s & 1] (B x kc floats) and completes this phase
    if (threadIdx.x == 0 && s + 1 < T) mbar_expect_tx(bar0 + 8 * (s & 1), 4u * B * kc);
    // the other clusters' words of h_{t-1} (step s) of batch rows c0 .. c0 +
    // nb, thread (j, b) = (j0 + 32q, tid % 8), are loaded into v, the
    // columns rotated as W_hh's; the first chunk's before the wait on the
    // cluster's own, so that their L2 round trip runs under it
    const unsigned long long* words = p.hx + ((size_t)((s + 1) & 1) * p.ndir + dir) * B * H;
    unsigned long long v[kGather];
    auto load_words = [&](int c0, int nb, int j0) {
#pragma unroll
      for (int q = 0; q < kGather; ++q) {
        const int j = j0 + q * (kThreads / kChunk), k = k0 + kc + j, b = threadIdx.x % kChunk;
        v[q] = j < ko && b < nb ? ld_word(words + (size_t)(c0 + b) * H + (k < H ? k : k - H))
                                : (unsigned long long)s << 32;
      }
    };
    if (s > 0 && ko > 0) load_words(0, min(kChunk, B), threadIdx.x / kChunk);
    // h_{t-1} of the cluster has landed in own[(s - 1) & 1]
    if (s > 0) mbar_wait(bar0 + 8 * ((s - 1) & 1), ((s - 1) >> 1) & 1);
    // h_{t-1}'s own columns; h_t's, in every CTA of the cluster
    const float* hp = own + (size_t)((s + 1) & 1) * nbc * kc * kChunk;
    float* hn = own + (size_t)(s & 1) * nbc * kc * kChunk;
    for (int c0 = 0; c0 < B; c0 += kChunk) {
      const int nb = min(kChunk, B - c0);
      if (s > 0) {
        float a[4][kChunk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int b = 0; b < kChunk; ++b) a[i][b] = 0.0f;
        if (c0 > 0 && ko > 0) load_words(c0, nb, threadIdx.x / kChunk);
        // the product on the cluster's own columns, in shared memory since the wait
        if (ts < S)
          fma_cols(hp + (size_t)(c0 / kChunk) * kc * kChunk, ws, R, tg, kc * ts / S,
                   kc * (ts + 1) / S, a);
        if (ko > 0) {
          __syncthreads();  // vec's last readers are done
          // the other clusters' columns at vec[j * 8 + b], the words not yet
          // at step s loaded again, all at once, until every one is
          const int b = threadIdx.x % kChunk;
          for (int j0 = threadIdx.x / kChunk; j0 < ko; j0 += kThreads / kChunk * kGather) {
            if (j0 != threadIdx.x / kChunk) load_words(c0, nb, j0);
            unsigned long long t0 = 0;
            for (;;) {
              bool stale = false;
#pragma unroll
              for (int q = 0; q < kGather; ++q) stale |= (unsigned)(v[q] >> 32) != (unsigned)s;
              if (!stale) break;
#pragma unroll
              for (int q = 0; q < kGather; ++q) {
                const int j = j0 + q * (kThreads / kChunk), k = k0 + kc + j;
                if ((unsigned)(v[q] >> 32) != (unsigned)s)
                  v[q] = ld_word(words + (size_t)(c0 + b) * H + (k < H ? k : k - H));
              }
              if (t0 == 0) t0 = global_ns();
              else if (global_ns() - t0 > 2000000000ull) __trap();
            }
#pragma unroll
            for (int q = 0; q < kGather; ++q)
              if (j0 + q * (kThreads / kChunk) < ko && b < nb)
                vec[(j0 + q * (kThreads / kChunk)) * kChunk + b] = __uint_as_float((unsigned)v[q]);
          }
          __syncthreads();
          if (ts < S) fma_cols(vec, ws + (size_t)kc * R, R, tg, ko * ts / S, ko * (ts + 1) / S, a);
        }
        // the slices' partials, summed in slice order
        if (ts < S) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int b = 0; b < kChunk; ++b)
              red[(i * kChunk + b) * (kThreads + NG) + threadIdx.x] = a[i][b];
        }
        __syncthreads();
        for (int o = threadIdx.x; o < 4 * kChunk * NG; o += kThreads) {
          const int g = o % NG, ib = o / NG, b = ib % kChunk;
          if (b >= nb) continue;
          float sum = 0.0f;
#pragma unroll 4
          for (int q = 0; q < S; ++q) sum += red[ib * (kThreads + NG) + q * NG + g];
          acc[b * R + 4 * g + ib / kChunk] = sum;
        }
      }
      if (c0 == 0) {  // this step's x_proj has landed
        if (s + 1 < T) cp_async_wait<1>();
        else cp_async_wait<0>();
      }
      __syncthreads();  // and acc is whole
      const float* xb = xs + (size_t)(s & 1) * B * R;
      for (int i = threadIdx.x; i < nb * uv; i += kThreads) {
        const int bl = i / uv, u = i - bl * uv, b = c0 + bl;
        const size_t o = ((size_t)t * B + b) * ld + col + u0 + u;
        float h;
        if constexpr (G == 4) {
          float pre[4];
#pragma unroll
          for (int g = 0; g < 4; ++g)
            pre[g] = s > 0 ? xb[b * R + g * U + u] + acc[bl * R + g * U + u] : xb[b * R + g * U + u];
          const float ig = sigmoid(pre[0]), fg = sigmoid(pre[1]);
          const float gg = tanh_(pre[2]), og = sigmoid(pre[3]);
          const float c = fg * (s > 0 ? cst[b * U + u] : 0.0f) + ig * gg;
          h = og * tanh_(c);
          if (p.cs) p.cs[o] = c;
          cst[b * U + u] = c;
        } else {  // the hidden products hp = h_{t-1} W_hh^T, 0 at s = 0
          float hp[3];
#pragma unroll
          for (int g = 0; g < 3; ++g) hp[g] = s > 0 ? acc[bl * R + g * U + u] : 0.0f;
          const float r = sigmoid(xb[b * R + u] + bias[u] + hp[0]);
          const float z = sigmoid(xb[b * R + U + u] + bias[U + u] + hp[1]);
          const float n = tanh_(xb[b * R + 2 * U + u] + r * (hp[2] + bias[2 * U + u]));
          h = (1.0f - z) * n + z * (s > 0 ? cst[b * U + u] : 0.0f);
          cst[b * U + u] = h;
        }
        p.hs[o] = h;
        if (s + 1 < T) {  // the all-gather: h into every CTA of the cluster, and L2
          const unsigned a = (unsigned)__cvta_generic_to_shared(
              hn + ((size_t)(b / kChunk) * kc + rank * U + u) * kChunk + b % kChunk);
#pragma unroll
          for (int q = 0; q < kCl; ++q)
            st_async(peer_addr(a, q), h, peer_addr(bar0 + 8 * (s & 1), q));
          if (M > 1)
            st_word(p.hx + (((size_t)(s & 1) * p.ndir + dir) * B + b) * H + u0 + u,
                    (unsigned long long)(s + 1) << 32 | __float_as_uint(h));
        }
      }
      __syncthreads();  // acc and red are free for the next chunk
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) lstm_wide_fwd_cluster_kernel(FwdCl p) {
  extern __shared__ float4 smem4[];
  fwd_cluster<4>(p, reinterpret_cast<float*>(smem4));
}

__global__ void __launch_bounds__(kThreads, 1) gru_wide_fwd_cluster_kernel(FwdCl p) {
  extern __shared__ float4 smem4[];
  fwd_cluster<3>(p, reinterpret_cast<float*>(smem4));
}

struct GruBwd {
  const float* z[2];     // update gates (T, B, H)
  const float* coef[2];  // hidden-side coefficients (T, B, 3H)
  const float* wt[2];    // W_hh^T (H, 3H)
  float* dh2[2];         // (T, B, H)
  int rev[2];
  const float* g_hs;     // (T, B, ndir*H)
  float* dh;             // (ndir, B, H) carried dh
  float* v;              // (2, ndir, B, 3H): coef_h * [dh2, dh2, dh2], double-buffered
  unsigned* bar;
  int T, B, H, ndir, U, chunk, rows_smem;
};

// K8w. Step s: dh2 of the CTA's units and their hidden-side gate gradients
// (phase A), published in v; the barrier; then dh_rec = dh2 * z + v @ W_hh
// for the CTA's units (phase B).
__global__ void __launch_bounds__(kThreads, 1) gru_wide_bwd_kernel(GruBwd p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dir = blockIdx.y, H = p.H, B = p.B, T = p.T, U = p.U, K = 3 * H;
  const int u0 = blockIdx.x * U, uv = min(U, H - u0), ld = p.ndir * H, col = dir * H;
  const float* WT = p.wt[dir];
  const Layout L = layout(false, U, K, p.chunk, p.rows_smem);
  float *red = smem + L.red, *vec = smem + L.vec, *ws = smem + L.w;
  auto global_row = [&](int r) { return WT + (size_t)(u0 + min(r, uv - 1)) * K; };
  stage_rows(ws, K, p.rows_smem, global_row);
  auto row = [&](int r) { return r < p.rows_smem ? ws + r * K : global_row(r); };
  const unsigned nblocks = gridDim.x * gridDim.y;
  const int rev = p.rev[dir];
  // A unit's phase-A inputs at step s: the incoming gradient, its 3
  // coefficients and its update gate.
  auto load = [&](int s, int i, float(&in)[5]) {
    const int t = rev ? s : T - 1 - s;
    const int b = i / uv, j = u0 + (i - b * uv);
    const size_t tb = (size_t)t * B + b;
    in[0] = p.g_hs[tb * ld + col + j];
    const float* c = p.coef[dir] + tb * K;
#pragma unroll
    for (int g = 0; g < 3; ++g) in[1 + g] = c[g * H + j];
    in[4] = p.z[dir][tb * H + j];
  };
  auto cell = [&](int s, int i, const float(&in)[5]) {
    const int t = rev ? s : T - 1 - s;
    const int b = i / uv, j = u0 + (i - b * uv);
    const size_t st = ((size_t)dir * B + b) * H + j;
    float* v = p.v + ((size_t)(s & 1) * p.ndir + dir) * B * K;
    const float d = in[0] + (s > 0 ? p.dh[st] : 0.0f);
    p.dh2[dir][((size_t)t * B + b) * H + j] = d;
#pragma unroll
    for (int g = 0; g < 3; ++g) v[(size_t)b * K + g * H + j] = in[1 + g] * d;
    p.dh[st] = d * in[4];
  };
  float first[5];  // loaded a step ahead, as K7w's
  if (threadIdx.x < B * uv) load(0, threadIdx.x, first);
  for (int s = 0; s < T; ++s) {
    if (threadIdx.x < B * uv) cell(s, threadIdx.x, first);
    for (int i = threadIdx.x + kThreads; i < B * uv; i += kThreads) {
      float in[5];
      load(s, i, in);
      cell(s, i, in);
    }
    if (s + 1 == T) break;
    if (threadIdx.x < B * uv) load(s + 1, threadIdx.x, first);
    grid_sync(p.bar, (unsigned)(s + 1) * nblocks);
    const float* v = p.v + ((size_t)(s & 1) * p.ndir + dir) * B * K;
    for (int c0 = 0; c0 < B; c0 += p.chunk) {
      const int nb = min(p.chunk, B - c0);
      stage_vec(vec, v + (size_t)c0 * K, K, K, nb);
      dot_rows(vec, K, U, nb, row, red, [&](int r, int b, float sum) {
        if (r < uv) p.dh[((size_t)dir * B + c0 + b) * H + u0 + r] += sum;
      });
    }
  }
}

// One cooperative launch of `kernel` over (ceil(H / U), ndir) CTAs.
template <class K, class P>
cudaError_t launch(K kernel, const P& p, bool fwd, int G, cudaStream_t stream) {
  const int rows = fwd ? G * p.U : p.U, K_ = fwd ? p.H : G * p.H;
  if (p.H < 1 || p.B < 1 || p.T < 1 || p.U < 1 || p.chunk < 1 || p.chunk > kChunk ||
      p.rows_smem < 0 || p.rows_smem > rows || p.ndir < 1 || p.ndir > 2)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)layout(fwd, rows, K_, p.chunk, p.rows_smem).total;
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.H + p.U - 1) / p.U, p.ndir);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// One cooperative clustered launch of `kernel` over (N, ndir) CTAs in
// clusters of kCl with `smem` bytes each (max_clusters != nullptr: how many of
// its clusters fit on the card at once instead).
template <class K, class P>
cudaError_t launch_cluster(K kernel, const P& p, int N, size_t smem, cudaStream_t stream,
                           int* max_clusters) {
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // clusters, and cooperative: a grid that cannot be resident at once fails
  // the launch (cudaErrorCooperativeLaunchTooLarge) instead of waiting forever
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N, p.ndir);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(max_clusters, (const void*)kernel, &cfg);
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <class P>
bool cluster_grid_ok(const P& p, int N) {
  return p.H >= 1 && p.B >= 1 && p.T >= 1 && p.U >= 1 && N >= kCl && N % kCl == 0 &&
         (long long)N * p.U >= p.H && p.ndir >= 1 && p.ndir <= 2;
}

// The backwards' cluster design at G gates, its columns kKpt a thread at once.
template <int G, int kKpt>
cudaError_t launch_cluster_bwd(const BwdCl& p, int N, cudaStream_t stream, int* max_clusters) {
  if (!cluster_grid_ok(p, N) || p.rows < 1 || (p.rows < p.B && p.rows % kChunk))
    return cudaErrorInvalidValue;
  void (*kernel)(BwdCl) =
      G == 4 ? lstm_wide_bwd_cluster_kernel<kKpt> : gru_wide_bwd_cluster_kernel<kKpt>;
  return launch_cluster(kernel, p, N, cluster_smem_bytes(G, p.B, p.H, p.U, p.rows), stream,
                        max_clusters);
}

template <int G>
cudaError_t launch_cluster_bwd_h(const BwdCl& p, int N, cudaStream_t stream) {
  return p.H <= 256   ? launch_cluster_bwd<G, 1>(p, N, stream, nullptr)
         : p.H <= 512 ? launch_cluster_bwd<G, 2>(p, N, stream, nullptr)
                      : launch_cluster_bwd<G, 4>(p, N, stream, nullptr);
}

// The forwards' cluster design at G gates (its G*U gate rows in whole groups of 4).
template <int G>
cudaError_t launch_cluster_fwd(const FwdCl& p, int N, cudaStream_t stream, int* max_clusters) {
  if (!cluster_grid_ok(p, N) || (G * p.U) % 4 != 0 || G * p.U > 4 * kThreads)
    return cudaErrorInvalidValue;
  void (*kernel)(FwdCl) = G == 4 ? lstm_wide_fwd_cluster_kernel : gru_wide_fwd_cluster_kernel;
  return launch_cluster(kernel, p, N, fwd_cluster_smem_bytes(G, p.B, p.H, p.U), stream,
                        max_clusters);
}

}  // namespace

// K1w: hs (T, B, ndir*H), direction k (x_proj_k, w_hh_k, reverse_k) in
// columns [k*H, k*H + H); cs, when not null, the cell states in the same
// layout; `state` (ndir, B, H) scratch; `bar` one zeroed counter. `units`
// hidden units a CTA, `chunk` batch rows staged at once, `rows_smem` gate
// rows of W_hh kept in shared memory (kernels/rnn.py `wide_plan`).
extern "C" int lstm_rec_wide_f32(const float* x0, const float* x1, const float* w0,
                                 const float* w1, float* hs, float* cs, float* state,
                                 unsigned* bar, int T, int B, int H, int ndir, int rev0, int rev1,
                                 int units, int chunk, int rows_smem, void* stream) {
  Fwd p = {{x0, x1}, {w0, w1}, {nullptr, nullptr}, {rev0, rev1}, hs, cs, state, bar,
           T, B, H, ndir, units, chunk, rows_smem};
  return (int)launch(rec_wide_kernel<4>, p, true, 4, (cudaStream_t)stream);
}

// K2w: as K1w for the GRU, with b_hh per direction and no cell state.
extern "C" int gru_rec_wide_f32(const float* x0, const float* x1, const float* w0,
                                const float* w1, const float* b0, const float* b1, float* hs,
                                unsigned* bar, int T, int B, int H, int ndir, int rev0, int rev1,
                                int units, int chunk, int rows_smem, void* stream) {
  Fwd p = {{x0, x1}, {w0, w1}, {b0, b1}, {rev0, rev1}, hs, nullptr, nullptr, bar,
           T, B, H, ndir, units, chunk, rows_smem};
  return (int)launch(rec_wide_kernel<3>, p, true, 3, (cudaStream_t)stream);
}

// K7w: dgates_k (T, B, 4H) of direction k from its gate pre-activations and
// W_hh_k^T (H, 4H), and from cs and g_hs (T, B, ndir*H); dh, dc (ndir, B,
// H) scratch; `rows_smem` columns of W_hh kept in shared memory.
extern "C" int lstm_rec_bwd_wide_f32(const float* g0, const float* g1, const float* wt0,
                                     const float* wt1, const float* cs, const float* g_hs,
                                     float* dg0, float* dg1, float* dh, float* dc, unsigned* bar,
                                     int T, int B, int H, int ndir, int rev0, int rev1, int units,
                                     int chunk, int rows_smem, void* stream) {
  LstmBwd p = {{g0, g1}, {wt0, wt1}, {dg0, dg1}, {rev0, rev1}, cs, g_hs, dh, dc, bar,
               T, B, H, ndir, units, chunk, rows_smem};
  return (int)launch(lstm_wide_bwd_kernel, p, false, 4, (cudaStream_t)stream);
}

// K8w: dh2_k (T, B, H) of direction k from its update gate z_k (T, B, H),
// coefficients coef_k (T, B, 3H) and W_hh_k^T (H, 3H), and from g_hs (T, B,
// ndir*H); dh (ndir, B, H) and v (2, ndir, B, 3H) scratch.
extern "C" int gru_rec_bwd_wide_f32(const float* z0, const float* z1, const float* c0,
                                    const float* c1, const float* wt0, const float* wt1,
                                    const float* g_hs, float* dh0, float* dh1, float* dh,
                                    float* v, unsigned* bar, int T, int B, int H, int ndir,
                                    int rev0, int rev1, int units, int chunk, int rows_smem,
                                    void* stream) {
  GruBwd p = {{z0, z1}, {c0, c1}, {wt0, wt1}, {dh0, dh1}, {rev0, rev1}, g_hs, dh, v, bar,
              T, B, H, ndir, units, chunk, rows_smem};
  return (int)launch(gru_wide_bwd_kernel, p, false, 3, (cudaStream_t)stream);
}

// K1w, the cluster design: as lstm_rec_wide_f32 with `hx` (2, ndir, B, H)
// zeroed 8-byte words of scratch in place of `state` and `bar`; `ctas` CTAs a
// direction (a multiple of 8, all resident at once: kernels/rnn.py
// `wide_fwd_plan` asks wide_cluster_max_clusters), `units` units a CTA.
extern "C" int lstm_rec_wide_cluster_f32(const float* x0, const float* x1, const float* w0,
                                         const float* w1, float* hs, float* cs,
                                         unsigned long long* hx, int T, int B, int H, int ndir,
                                         int rev0, int rev1, int units, int ctas, void* stream) {
  FwdCl p = {{x0, x1}, {w0, w1}, {nullptr, nullptr}, {rev0, rev1}, hs, cs, hx, T, B, H, ndir, units};
  return (int)launch_cluster_fwd<4>(p, ctas, (cudaStream_t)stream, nullptr);
}

// K2w, the cluster design: as gru_rec_wide_f32 with `hx` as K1w's cluster
// design in place of `bar`; `units` a multiple of 4.
extern "C" int gru_rec_wide_cluster_f32(const float* x0, const float* x1, const float* w0,
                                        const float* w1, const float* b0, const float* b1,
                                        float* hs, unsigned long long* hx, int T, int B, int H,
                                        int ndir, int rev0, int rev1, int units, int ctas,
                                        void* stream) {
  FwdCl p = {{x0, x1}, {w0, w1}, {b0, b1}, {rev0, rev1}, hs, nullptr, hx, T, B, H, ndir, units};
  return (int)launch_cluster_fwd<3>(p, ctas, (cudaStream_t)stream, nullptr);
}

// K7w, the cluster design: as lstm_rec_bwd_wide_f32 from W_hh_k (4H, H) itself;
// `pub` (2, ndir, ctas / 8, B, H) floats and `flags` (ndir, ctas) zeroed
// words of scratch; `ctas` CTAs a direction (a multiple of 8, all resident
// at once: kernels/rnn.py `wide_bwd_plan` asks wide_cluster_max_clusters),
// `units` units a CTA, its 4 units gate rows of W_hh in shared memory, the
// partials `rows` batch rows at a time.
extern "C" int lstm_rec_bwd_wide_cluster_f32(const float* g0, const float* g1, const float* w0,
                                             const float* w1, const float* cs, const float* g_hs,
                                             float* dg0, float* dg1, float* pub, unsigned* flags,
                                             int T, int B, int H, int ndir, int rev0, int rev1,
                                             int units, int ctas, int rows, void* stream) {
  BwdCl p = {{g0, g1}, {nullptr, nullptr}, {w0, w1}, {dg0, dg1}, {rev0, rev1}, cs, g_hs, pub,
             flags, T, B, H, ndir, units, rows};
  return (int)launch_cluster_bwd_h<4>(p, ctas, (cudaStream_t)stream);
}

// K8w, the cluster design: as gru_rec_bwd_wide_f32 from W_hh_k (3H, H) itself,
// with `pub` and `flags` as K7w's cluster design in place of dh, v and bar.
extern "C" int gru_rec_bwd_wide_cluster_f32(const float* z0, const float* z1, const float* c0,
                                            const float* c1, const float* w0, const float* w1,
                                            const float* g_hs, float* dh0, float* dh1, float* pub,
                                            unsigned* flags, int T, int B, int H, int ndir,
                                            int rev0, int rev1, int units, int ctas, int rows,
                                            void* stream) {
  BwdCl p = {{c0, c1}, {z0, z1}, {w0, w1}, {dh0, dh1}, {rev0, rev1}, nullptr, g_hs, pub, flags,
             T, B, H, ndir, units, rows};
  return (int)launch_cluster_bwd_h<3>(p, ctas, (cudaStream_t)stream);
}

// How many clusters of a cluster design (`kernel` 0: K1w, 1: K7w, 2: K8w, 3: K2w), at
// B rows, H units, `units` a CTA and (the backwards) partials of `rows`
// batch rows, fit on the card at once (or minus a cudaError_t).
extern "C" int wide_cluster_max_clusters(int kernel, int B, int H, int units, int rows) {
  const int ctas = ((H + units - 1) / units + kCl - 1) / kCl * kCl;
  int n = 0;
  cudaError_t err;
  if (kernel == 0 || kernel == 3) {
    FwdCl p = {{nullptr, nullptr}, {nullptr, nullptr}, {nullptr, nullptr}, {0, 0}, nullptr,
               nullptr, nullptr, 1, B, H, 1, units};
    err = kernel == 0 ? launch_cluster_fwd<4>(p, ctas, nullptr, &n)
                      : launch_cluster_fwd<3>(p, ctas, nullptr, &n);
  } else {
    BwdCl p = {{nullptr, nullptr}, {nullptr, nullptr}, {nullptr, nullptr}, {nullptr, nullptr},
               {0, 0}, nullptr, nullptr, nullptr, nullptr, 1, B, H, 1, units, rows};
    err = kernel == 1 ? launch_cluster_bwd<4, 1>(p, ctas, nullptr, &n)
                      : launch_cluster_bwd<3, 1>(p, ctas, nullptr, &n);
  }
  return err == cudaSuccess ? n : -(int)err;
}
