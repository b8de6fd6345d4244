// The wide routes of the four recurrence kernels: LSTM and GRU recurrences
// over pre-projected inputs and their backward recurrences, at any hidden size
// H >= 1, any batch B >= 1 and one or two directions, where the narrow
// kernels of rnn.cu (K1/K7 at 4 <= H <= 288 with H % 4 == 0, K2/K8 at
// H <= 128) have no plan. kernels/rnn.py `lstm_route`/`gru_route` pick the
// route; each kernel computes exactly what its narrow twin computes.
//
// Replaces:
// - K1w `rec_wide_kernel<4>`: the Pallas kernel P1 `tools/proto_pallas_rnn.py:33`
//   `pallas_lstm_rec`, the forward of `semi_tts_tpu/ops/rnn.py:95`
//   `_lstm_rec_fwd` (gates i, f, g, o; with or without the cell states);
// - K7w `lstm_wide_bwd_kernel`: the backward scan of `_lstm_rec_bwd`
//   (`semi_tts_tpu/ops/rnn.py:114`);
// - K2w `rec_wide_kernel<3>`: `_gru_rec_fwd` (`:225`), gates r, z, n with b_hh
//   inside the recurrence, so that r gates h @ W_hn^T + b_hn;
// - K8w `gru_wide_bwd_kernel`: the backward scan of `_gru_rec_bwd` (`:244`).
// fp32 FFMA throughout, no tensor cores, as in the JAX recurrences.
//
// What bounds it on an H100: each step needs the whole of the previous
// step's vector (h for the forwards, the gate gradients for the backwards),
// so the time is about T x (the latency of one step). W_hh (G*H x H, 4 MiB
// for the LSTM at H=512, 16 MiB at H=1024) does not fit one SM, nor a
// cluster of 16.
//
// Design:
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
