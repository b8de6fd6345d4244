// LSTM and GRU recurrences over pre-projected inputs, one or both directions
// of a bidirectional layer in one launch: the forwards K1 and K2 here, the
// backward recurrences K7 (LSTM) and K8 (GRU) in their own sections below.
//
// Replaces: K1 `lstm_rec`, the Pallas kernel P1 `tools/proto_pallas_rnn.py:33`
// `pallas_lstm_rec`, which is the forward of `semi_tts_tpu/ops/rnn.py:95`
// `_lstm_rec_fwd` (gates i, f, g, o); K2 `gru_rec`, the forward of
// `semi_tts_tpu/ops/rnn.py:225` `_gru_rec_fwd` (gates r, z, n, with b_hh
// inside the recurrence so that r gates h @ W_hn^T + b_hn). fp32 FFMA
// throughout, no tensor cores, as in the JAX recurrences.
//
// What bounds it on an H100: step t needs h_{t-1}, so the time is about
// T x (the latency of one step). The bytes (x_proj, W_hh once, hs) and the
// FLOPs (2*T*B*G*H*H) put the card's bound far below that. A step is the
// product h @ W_hh^T (G*H rows of H) and its reduction, the cell update, and
// the barrier that publishes the new h. Reading W_hh from L2 every step
// (1 MiB for the LSTM at H=256) would dominate, so W_hh stays on chip.
//
// Design:
// - Both directions run in one launch: the direction is blockIdx.y, and each
//   writes its half of the (T, B, ndir*H) output that the caller concatenates.
// - A group of 8 lanes owns one hidden unit j and splits the reduction axis k
//   between its lanes; each lane holds all gate rows of unit j for its k, so
//   a few xor shuffles leave the unit's gate pre-activations in the group's
//   lanes, which apply the cell update there, with no trip through shared
//   memory.
// - x_proj of the next kAhead - 1 steps is staged in a shared-memory ring with
//   cp.async, so no step waits on a load from L2.
// - K2 (GRU, H <= 128): W_hh lives in registers for the whole sequence (3
//   gates x ceil(H/8) values a lane), loaded once; h is double-buffered in
//   shared memory so one __syncthreads a step is race-free. One block serves
//   one batch row of one direction.
// - K1 (LSTM, H <= 288, H % 4 == 0): W_hh (4H x H) does not fit one SM, so a
//   cluster of 8 CTAs splits the hidden units: CTA r owns units
//   [r*U, r*U + U) and keeps their 4*U gate rows in dynamic shared memory
//   (128 KiB at H=256), loaded once with cp.async; below 8 rows each lane
//   also keeps half of its slice in registers, which halves the W_hh reads
//   from shared memory. A cluster serves R batch rows of one direction, and
//   each W_hh value read feeds all R of them. After the k-split sums a
//   reduce-scatter leaves each lane the 4 gates of one row, so the cell
//   update runs once per (unit, row) and the cell state never leaves its lane. Each step the new h values go into
//   the next h buffer of all 8 CTAs through distributed shared memory, then
//   the cluster meets at one barrier; h is double-buffered, so one barrier a
//   step is race-free, and the barrier that ends the last step also keeps
//   every CTA alive until no peer writes into it. The wrapper picks R so that
//   the clusters fit on the card at once (kernels/rnn.py `lstm_plan`).
// - Measured on an H100 (PERF.md): a K1 step is held back by the shared-memory
//   reads of the product (W_hh and h, 16 bytes a lane per load) and by the
//   DSMEM stores plus cluster barrier; a K2 step by the cell update and the
//   block barrier; a K7 step by its partial sums (phase B), a K8 step by its
//   FMA chain behind the barrier.
// Gate order is torch's: i, f, g, o for the LSTM and r, z, n for the GRU.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kGroup = 8;          // lanes per hidden unit
constexpr int kCluster = 8;        // K1 CTAs per cluster
constexpr int kLstmMaxH = 288;
constexpr int kLstmMaxUnits = 36;  // lstm_units(kLstmMaxH)
constexpr int kGruMaxH = 128;
constexpr int kAhead = 4;          // x_proj ring: steps in shared memory

// fp32 through the fast exponential and divide; chip_smoke.py holds both
// kernels to their plain versions at 1e-4 (they differ by ~2e-7).
__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }

__device__ __forceinline__ float tanh_(float x) {
  return copysignf(1.0f - __fdividef(2.0f, __expf(2.0f * fabsf(x)) + 1.0f), x);
}

// Sum over the 8 lanes of a unit's group; every lane gets the total.
template <int N>
__device__ __forceinline__ void group_sum(float (&v)[N]) {
#pragma unroll
  for (int o = 1; o < kGroup; o <<= 1)
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] += __shfl_xor_sync(0xffffffffu, v[n], o);
}

struct Dir {
  const float* x_proj;  // (T, B, G*H)
  const float* w_hh;    // (G*H, H)
  const float* b_hh;    // (G*H), GRU only
  int reverse;
  int col;              // first column of this direction in a row of hs
};

struct Dirs {
  Dir d[2];
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Wait until at most kAhead - 2 groups are in flight: the group of the next
// step has landed.
__device__ __forceinline__ void cp_async_wait_next() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 2) : "memory");
}

__device__ __forceinline__ Dir this_dir(const Dirs& dirs) {
  return blockIdx.y ? dirs.d[1] : dirs.d[0];
}

// ---------------------------------------------------------------- K2: GRU --

// KPL: k values a lane holds (8*KPL >= H). One block per batch row.
template <int KPL>
__global__ void __launch_bounds__(64 * KPL) gru_rec_kernel(Dirs dirs, float* __restrict__ hs,
                                                           int T, int B, int H, int ld) {
  constexpr int KP = kGroup * KPL;  // h padded with zeros to KP
  __shared__ float hbuf[2][KP];
  __shared__ float xring[kAhead][3 * KP];  // x_proj of the coming steps
  const Dir d = this_dir(dirs);
  const int g = threadIdx.x & (kGroup - 1);
  const int j = threadIdx.x / kGroup;
  const bool active = j < H;
  const bool leader = active && g == 0;
  const int b = blockIdx.x;
  const int H3 = 3 * H;

  // W_hh rows of unit j at k = g + 8*i, zero past H: registers for all T steps
  float wr[KPL], wz[KPL], wn[KPL];
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int k = g + kGroup * i;
    const bool in = active && k < H;
    wr[i] = in ? d.w_hh[(size_t)j * H + k] : 0.0f;
    wz[i] = in ? d.w_hh[(size_t)(H + j) * H + k] : 0.0f;
    wn[i] = in ? d.w_hh[(size_t)(2 * H + j) * H + k] : 0.0f;
  }
  const float br = leader ? d.b_hh[j] : 0.0f;
  const float bz = leader ? d.b_hh[H + j] : 0.0f;
  const float bn = leader ? d.b_hh[2 * H + j] : 0.0f;
  for (int i = threadIdx.x; i < 2 * KP; i += blockDim.x) (&hbuf[0][0])[i] = 0.0f;

  // thread e < 3H copies x_proj[t(s), b, e] of step s
  auto fetch_x = [&](int s) {
    if (threadIdx.x < H3) {
      const int t = d.reverse ? T - 1 - s : s;
      const float* src = s < T ? d.x_proj + ((size_t)t * B + b) * H3 + threadIdx.x : d.x_proj;
      cp_async4(&xring[s % kAhead][threadIdx.x], src, s < T ? 4 : 0);
    }
    cp_async_commit();
  };
  for (int s = 0; s < kAhead - 1; ++s) fetch_x(s);
  cp_async_wait_next();  // step 0's x has landed (kAhead - 2 groups may still fly)
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int cur = s & 1;
    const int t = d.reverse ? T - 1 - s : s;
    fetch_x(s + kAhead - 1);  // into the slot that step s - 1 read
    float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const float hk = hbuf[cur][g + kGroup * i];
      acc[0] = fmaf(wr[i], hk, acc[0]);
      acc[1] = fmaf(wz[i], hk, acc[1]);
      acc[2] = fmaf(wn[i], hk, acc[2]);
    }
    group_sum(acc);
    if (leader) {
      const float* x = xring[s % kAhead];
      const float rg = sigmoid(x[j] + (acc[0] + br));
      const float zg = sigmoid(x[H + j] + (acc[1] + bz));
      const float ng = tanh_(x[2 * H + j] + rg * (acc[2] + bn));
      const float h2 = (1.0f - zg) * ng + zg * hbuf[cur][j];
      hbuf[cur ^ 1][j] = h2;
      hs[((size_t)t * B + b) * ld + d.col + j] = h2;
    }
    cp_async_wait_next();
    __syncthreads();
  }
}

template <int KPL>
cudaError_t launch_gru_t(const Dirs& dirs, float* hs, int T, int B, int H, int ndir,
                         cudaStream_t stream) {
  const int threads = (kGroup * H + 31) / 32 * 32;
  gru_rec_kernel<KPL><<<dim3(B, ndir), threads, 0, stream>>>(dirs, hs, T, B, H, ndir * H);
  return cudaGetLastError();
}

// --------------------------------------------------------------- K1: LSTM --

// Hidden units per CTA: ceil(H / 8) rounded up to a multiple of 4, so that a
// CTA's slice of an x_proj row is whole 16-byte chunks.
__host__ __device__ constexpr int lstm_units(int H) {
  return ((H + kCluster - 1) / kCluster + 3) / 4 * 4;
}

// Dynamic shared memory of one K1 CTA, in floats: W_hh rows (4, U, KP), h
// (2, R, KP) and the x_proj ring (kAhead, R, 4, U); KP = 64*KP64 is H padded
// with zeros.
__host__ __device__ constexpr size_t lstm_smem_floats(int KP64, int R, int U) {
  return (size_t)(4 * U + 2 * R) * 64 * KP64 + (size_t)kAhead * R * 4 * U;
}

// After the k-split sums, lane g of a unit holds the 4 gates of row
// g / (kGroup / R): a reduce-scatter over the rows, then a butterfly over the
// lanes that share a row. acc is (R, 4) row-major on entry; acc[0..4) is the
// lane's row on exit.
template <int R>
__device__ __forceinline__ void row_sums(float (&acc)[4 * R], int g) {
  constexpr int kScatter = R == 1 ? 0 : R == 2 ? 1 : R == 4 ? 2 : 3;
#pragma unroll
  for (int st = 0; st < kScatter; ++st) {
    const int half = 2 * R >> st;  // values kept after this step
    const int o = (kGroup / 2) >> st;
    const bool hi = (g & o) != 0;
#pragma unroll
    for (int k = 0; k < 2 * R; ++k) {
      if (k < half) {
        const float send = hi ? acc[k] : acc[k + half];
        const float keep = hi ? acc[k + half] : acc[k];
        acc[k] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    }
  }
#pragma unroll
  for (int o = (kGroup / 2) >> kScatter; o > 0; o >>= 1)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], o);
}

// KP64: ceil(H / 64); R: batch rows per cluster; CS: also store the cell
// states (training keeps them for K7). blockDim.x = kGroup * U.
template <int KP64, int R, bool CS>
__global__ void __launch_bounds__(kGroup * kLstmMaxUnits, 1)
    lstm_rec_kernel(Dirs dirs, float* __restrict__ hs, float* __restrict__ cs, int T, int B, int H,
                    int ld) {
  constexpr int KP = 64 * KP64;
  constexpr int KP4 = KP / 4;
  constexpr int NCH = KP4 / kGroup;       // float4 chunks of k per lane
  constexpr int kRowLanes = kGroup / R;   // lanes that share a row after row_sums
  static_assert(kGroup == kCluster, "each of a row's lanes stores h into R of the CTAs");
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const Dir d = this_dir(dirs);
  const int U = blockDim.x / kGroup;
  float* w_s = reinterpret_cast<float*>(smem4);  // (4, U, KP)
  float* h_s = w_s + (size_t)4 * U * KP;         // (2, R, KP)
  float* x_s = h_s + (size_t)2 * R * KP;         // (kAhead, R, 4, U)
  const int rank = (int)cluster.block_rank();
  const int g = threadIdx.x & (kGroup - 1);
  const int u = threadIdx.x / kGroup;
  const int j = rank * U + u;
  const int row = g / kRowLanes, dup = g % kRowLanes;
  const int b0 = (blockIdx.x / kCluster) * R;
  const bool writes = j < H && b0 + row < B;
  const int H4 = 4 * H;

  // this CTA's gate rows of W_hh, once: row (q, u) is W_hh[q*H + rank*U + u]
  for (int idx = threadIdx.x; idx < 4 * U * KP4; idx += blockDim.x) {
    const int wrow = idx / KP4, c = idx % KP4;
    const int q = wrow / U, jj = rank * U + wrow % U;
    const bool ok = jj < H && 4 * c < H;
    const float* src = ok ? d.w_hh + ((size_t)q * H + jj) * H + 4 * c : d.w_hh;
    cp_async16(w_s + (size_t)wrow * KP + 4 * c, src, ok ? 16 : 0);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < 2 * R * KP; i += blockDim.x) h_s[i] = 0.0f;

  // thread e < R*U copies chunk e of this CTA's x_proj slice of step s:
  // row e / U, gate (e % U) / (U/4), units 4*(e % (U/4)) .. + 4
  const int xe_r = threadIdx.x / U, xe_q = threadIdx.x % U / (U / 4), xe_m = threadIdx.x % (U / 4);
  auto fetch_x = [&](int s) {
    if (xe_r < R) {
      const int t = d.reverse ? T - 1 - s : s;
      const int jj = rank * U + 4 * xe_m;
      const bool ok = s < T && b0 + xe_r < B && jj < H;
      const float* src =
          ok ? d.x_proj + ((size_t)t * B + b0 + xe_r) * H4 + xe_q * H + jj : d.x_proj;
      cp_async16(x_s + (((size_t)(s % kAhead) * R + xe_r) * 4 + xe_q) * U + 4 * xe_m, src,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };
  for (int s = 0; s < kAhead - 1; ++s) fetch_x(s);
  cp_async_wait_next();  // W_hh and step 0's x have landed
  float c_state = 0.0f;
  // every peer has started and zeroed its h before anyone stores into it
  cluster.sync();

  const float4* w4 = reinterpret_cast<const float4*>(w_s) + (size_t)u * KP4;
  // the first NREG chunks of the lane's W_hh slice are also kept in
  // registers, halving the shared-memory reads of W_hh a step (at 8 rows the
  // accumulators need those registers)
  constexpr int NREG = R < 8 ? NCH / 2 : 0;
  float4 wreg[4][NREG > 0 ? NREG : 1];
#pragma unroll
  for (int i = 0; i < NREG; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) wreg[q][i] = w4[(size_t)q * U * KP4 + g + kGroup * i];
  for (int s = 0; s < T; ++s) {
    const int cur = s & 1;
    const int t = d.reverse ? T - 1 - s : s;
    fetch_x(s + kAhead - 1);  // into the slot that step s - 1 read
    float acc[4 * R];         // (R, 4)
#pragma unroll
    for (int n = 0; n < 4 * R; ++n) acc[n] = 0.0f;
    const float4* h4 = reinterpret_cast<const float4*>(h_s + (size_t)cur * R * KP);
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = g + kGroup * i;
      float4 hv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) hv[r] = h4[r * KP4 + c];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 wv = i < NREG ? wreg[q][i < NREG ? i : 0] : w4[(size_t)q * U * KP4 + c];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float a = acc[r * 4 + q];
          a = fmaf(wv.x, hv[r].x, a);
          a = fmaf(wv.y, hv[r].y, a);
          a = fmaf(wv.z, hv[r].z, a);
          acc[r * 4 + q] = fmaf(wv.w, hv[r].w, a);
        }
      }
    }
    row_sums<R>(acc, g);
    // lane g: the cell update of (unit j, row), c never leaves the CTA; the
    // kRowLanes lanes of a row share the 8 stores of h into the cluster: lane
    // dup stores into CTAs dup*R .. dup*R + R - 1
    const float* x = x_s + ((size_t)(s % kAhead) * R + row) * 4 * U + u;
    const float ig = sigmoid(x[0] + acc[0]);
    const float fg = sigmoid(x[U] + acc[1]);
    const float gg = tanh_(x[2 * U] + acc[2]);
    const float og = sigmoid(x[3 * U] + acc[3]);
    c_state = fg * c_state + ig * gg;
    const float h2 = og * tanh_(c_state);
    if (writes) {
      float* next = h_s + ((size_t)(cur ^ 1) * R + row) * KP + j;
#pragma unroll
      for (int m = 0; m < R; ++m) *cluster.map_shared_rank(next, dup * R + m) = h2;
      if (dup == 0) {
        hs[((size_t)t * B + b0 + row) * ld + d.col + j] = h2;
        if (CS) cs[((size_t)t * B + b0 + row) * ld + d.col + j] = c_state;
      }
    }
    cp_async_wait_next();
    cluster.sync();
  }
}

// Launches K1, or (max_clusters != nullptr) asks how many of its clusters fit
// on the card at once.
template <int KP64, int R, bool CS>
cudaError_t launch_lstm_t(const Dirs& dirs, float* hs, float* cs, int T, int B, int H, int ndir,
                          cudaStream_t stream, int* max_clusters) {
  auto kernel = lstm_rec_kernel<KP64, R, CS>;
  const int U = lstm_units(H);
  const size_t smem = sizeof(float) * lstm_smem_floats(KP64, R, U);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * ((B + R - 1) / R), ndir);
  cfg.blockDim = dim3(kGroup * U);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(max_clusters, (const void*)kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, dirs, hs, cs, T, B, H, ndir * H);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int R, bool CS>
cudaError_t launch_lstm_r(const Dirs& dirs, float* hs, float* cs, int T, int B, int H, int ndir,
                          cudaStream_t stream, int* max_clusters) {
  switch ((H + 63) / 64) {
    case 1: return launch_lstm_t<1, R, CS>(dirs, hs, cs, T, B, H, ndir, stream, max_clusters);
    case 2: return launch_lstm_t<2, R, CS>(dirs, hs, cs, T, B, H, ndir, stream, max_clusters);
    case 3: return launch_lstm_t<3, R, CS>(dirs, hs, cs, T, B, H, ndir, stream, max_clusters);
    case 4: return launch_lstm_t<4, R, CS>(dirs, hs, cs, T, B, H, ndir, stream, max_clusters);
    case 5: return launch_lstm_t<5, R, CS>(dirs, hs, cs, T, B, H, ndir, stream, max_clusters);
    default: return cudaErrorInvalidValue;
  }
}

template <bool CS>
cudaError_t launch_lstm_cs(const Dirs& dirs, float* hs, float* cs, int T, int B, int H, int ndir,
                           int rows, cudaStream_t stream, int* max_clusters) {
  switch (rows) {
    case 1: return launch_lstm_r<1, CS>(dirs, hs, cs, T, B, H, ndir, stream, max_clusters);
    case 2: return launch_lstm_r<2, CS>(dirs, hs, cs, T, B, H, ndir, stream, max_clusters);
    case 4: return launch_lstm_r<4, CS>(dirs, hs, cs, T, B, H, ndir, stream, max_clusters);
    case 8: return launch_lstm_r<8, CS>(dirs, hs, cs, T, B, H, ndir, stream, max_clusters);
    default: return cudaErrorInvalidValue;
  }
}

// cs == nullptr launches the serving kernel, which stores no cell states.
cudaError_t launch_lstm(const Dirs& dirs, float* hs, float* cs, int T, int B, int H, int ndir,
                        int rows, cudaStream_t stream, int* max_clusters) {
  if (H < 4 || H > kLstmMaxH || H % 4 != 0 || ndir < 1 || ndir > 2) return cudaErrorInvalidValue;
  return cs != nullptr
             ? launch_lstm_cs<true>(dirs, hs, cs, T, B, H, ndir, rows, stream, max_clusters)
             : launch_lstm_cs<false>(dirs, hs, cs, T, B, H, ndir, rows, stream, max_clusters);
}

Dir make_dir(const float* x_proj, const float* w_hh, const float* b_hh, int reverse, int col) {
  Dir d;
  d.x_proj = x_proj;
  d.w_hh = w_hh;
  d.b_hh = b_hh;
  d.reverse = reverse;
  d.col = col;
  return d;
}

// --------------------------------------------------------- K7: LSTM bwd --
//
// The backward recurrence of `_lstm_rec_bwd` (`semi_tts_tpu/ops/rnn.py:114`),
// walked opposite to the forward's time direction, per (batch row, unit j):
//   dh = g_hs[t] + dh_rec;  dc = dc_rec + dh * o * (1 - tanh(c)^2)
//   dgates = [dc*g*i*(1-i), dc*c_prev*f*(1-f), dc*i*(1-g^2), dh*tanh(c)*o*(1-o)]
//   dh_rec = dgates @ W_hh (all 4H rows -> H);  dc_rec = dc * f
// with i, f, g, o the activations of the gate pre-activations that the
// caller recomputed with one GEMM (x_proj + h_prev @ W_hh^T, as JAX does).
// dW_hh = sum_t dgates_t^T h_prev_t is one GEMM outside the kernel.
//
// What bounds it: as K1, the latency of T dependent steps. A cluster of 8
// CTAs serves R batch rows of one direction; CTA r owns the units
// [r*U, r*U + U) and their 4*U gate rows of W_hh. A step:
// - (A) thread (row, unit) waits for its unit's partial sums of dh_rec (one
//   from each CTA that owns units: 8 unless 8U > H), adds them in rank
//   order and forms dh, dc and the 4 gate gradients. All that does not
//   depend on dh_rec (the activations, the products that multiply dh and
//   dc) was formed before the wait, from inputs that a cp.async ring holds
//   kRing steps ahead.
// - (B) lane (quad kq, g) of a group of 8 holds W_hh at the columns
//   4kq .. 4kq + 3 and at the gate rows 4(8i + g) .. + 3 of the CTA's slice,
//   most of them in registers for the whole sequence (the rest in its own
//   slots of shared memory); it forms 4R independent chains over its rows,
//   then an xor-shuffle tree (a reduce-scatter over offsets 4, 2, 1) leaves
//   each lane whole CTA sums of one row at 1, 2 or 4 columns.
// - (C) each lane sends its sums with st.async into the slot of its rank in
//   the owner CTA's double-buffered slots; the bytes complete the owner's
//   mbarrier of that buffer, which the owner armed with the step's byte
//   count from its peers (its own lanes store theirs and arrive on it).
//   No cluster barrier a step: a producer forms its step s+2 partial
//   only after the owner's step s+1 partial reached it, and the owner sends
//   that only after it read buffer s & 1 and re-armed its mbarrier.
// The summation order is fixed (chains in row order, the shuffle tree, the
// slots in rank order), so reruns are bit-identical.

struct BwdDir {
  const float* gates;  // (T, B, 4H) pre-activations
  const float* w_hh;   // (4H, H)
  float* dgates;       // (T, B, 4H)
  int reverse;
  int col;             // columns of this direction in cs and g_hs
};

struct BwdDirs {
  BwdDir d[2];
};

BwdDir make_bwd_dir(const float* gates, const float* w_hh, float* dgates, int reverse, int col) {
  BwdDir d;
  d.gates = gates;
  d.w_hh = w_hh;
  d.dgates = dgates;
  d.reverse = reverse;
  d.col = col;
  return d;
}

constexpr int kRing = 4;        // K7: steps of inputs in shared memory
constexpr int kStepIn = 6;      // K7: inputs of a (row, unit) a step: 4 gates, c, g_hs

// Chunks of 4 gate rows a lane of K7 holds: the 4U rows over 8 lanes.
__host__ __device__ constexpr int lstm_bwd_chunks(int U) { return (U + 7) / 8; }

// Of those, the chunks kept in registers; the accumulators of more rows take
// the rest of the register file.
// Past 512 threads (NCH = 5) 18 warps leave 96 registers a thread.
__host__ __device__ constexpr int lstm_bwd_reg_chunks(int R, int NCH) {
  return NCH >= 5 ? (R <= 2 ? 3 : 1) : NCH < (R <= 2 ? 4 : R == 4 ? 3 : 2) ? NCH
                                       : (R <= 2 ? 4 : R == 4 ? 3 : 2);
}

__host__ __device__ constexpr int lstm_bwd_threads(int H, int R, int U) {
  return ((2 * H > R * U ? 2 * H : R * U) + 31) / 32 * 32;
}

// Dynamic shared memory of one K7 CTA, in floats: 2 mbarriers (4 floats),
// the W_hh chunks not in registers (NCH - NREG, 4, H/4, 8 lanes, 4), the
// partial-sum slots (2, kCluster, R, U), the gate gradients (2, R, 32*NCH)
// and the input ring (kRing, kStepIn, R*U).
__host__ __device__ constexpr size_t lstm_bwd_smem_floats(int H, int R, int U) {
  return 4 +
         (size_t)(lstm_bwd_chunks(U) - lstm_bwd_reg_chunks(R, lstm_bwd_chunks(U))) * 128 * (H / 4) +
         (size_t)2 * kCluster * R * U + (size_t)2 * R * 32 * lstm_bwd_chunks(U) +
         (size_t)kRing * kStepIn * R * U;
}

__device__ __forceinline__ float sigmoid_acc(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The address in CTA `rank` of the cluster of this CTA's shared address a.
__device__ __forceinline__ unsigned map_rank(unsigned a, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(a), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
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

// Wait until the phase of parity `parity` of the mbarrier has completed; the
// acquire at cluster scope makes the peers' st.async bytes visible. A wait
// of more than 2 s traps, so a lost hand-off fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 2000000000ull) __trap();
}

template <int N>
__device__ __forceinline__ void st_async(unsigned dst, const float* v, unsigned bar) {
  if (N == 1)
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(
                     dst),
                 "f"(v[0]), "r"(bar)
                 : "memory");
  else if (N == 2)
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
            dst),
        "f"(v[0]), "f"(v[1]), "r"(bar)
        : "memory");
  else
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
        "[%5];\n" ::"r"(dst),
        "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]), "r"(bar)
        : "memory");
}

// Sum the (R, 4) values of the 8 lanes of a group: a reduce-scatter over the
// lane offsets 4, 2, 1 while more than one value is left, then a butterfly.
// Lane g keeps the flat entries [g*N/8, g*N/8 + N/8) for N = 4R >= 8, or entry
// g / 2 for R = 1, in v[0..). Every partner adds the same two numbers, so
// each entry is ((c0 + c4) + (c2 + c6)) + ((c1 + c5) + (c3 + c7)) of the
// lanes' chains c, in every lane that holds it.
template <int N>
__device__ __forceinline__ void lane_scatter(float (&v)[N], int g) {
  int n = N;
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1) {
    const bool hi = (g & o) != 0;
    if (n >= 2) {
      const int half = n / 2;
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        if (k < half) {
          const float send = hi ? v[k] : v[k + half];
          const float keep = hi ? v[k + half] : v[k];
          v[k] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      n = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
}

// R: batch rows per cluster; NCH: lstm_bwd_chunks(U). blockDim.x =
// lstm_bwd_threads(H, R, U).
template <int R, int NCH>
__global__ void __launch_bounds__(128 * NCH < 576 ? 128 * NCH : 576, 1)
    lstm_bwd_kernel(BwdDirs dirs, const float* __restrict__ cs, const float* __restrict__ g_hs,
                    int T, int B, int H, int ld) {
  constexpr int NREG = lstm_bwd_reg_chunks(R, NCH);
  constexpr int PR = 32 * NCH;  // the CTA's gate rows, padded with zeros
  // phase B in NP passes of RP rows: at 8 rows and 576 threads (96 registers
  // a thread) the accumulators of 4 rows at a time
  constexpr int NP = R == 8 && NCH >= 5 ? 2 : 1, RP = R / NP;
  constexpr int NV = 4 * RP >= kGroup ? 4 * RP / kGroup : 1;  // sums a lane sends a pass
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const BwdDir d = blockIdx.y ? dirs.d[1] : dirs.d[0];
  const int U = lstm_units(H);
  const int KQ = H / 4;
  const int RU = R * U;
  float* base = reinterpret_cast<float*>(smem4);
  const unsigned bar0 = smem_addr(base);                      // 2 mbarriers: slots 0 and 1
  float4* w_s = reinterpret_cast<float4*>(base + 4);           // (NCH - NREG, 4, KQ, 8)
  float* slot = base + 4 + (size_t)(NCH - NREG) * 128 * KQ;  // (2, kCluster, R, U)
  float* dg_s = slot + (size_t)2 * kCluster * RU;              // (2, R, PR)
  float* ring = dg_s + (size_t)2 * R * PR;                     // (kRing, kStepIn, R*U)
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int b0 = (blockIdx.x / kCluster) * R;
  const int H4 = 4 * H;
  // units this CTA owns (fewer than U in the last CTAs when 8U > H); a step
  // fills its slots with the 7 peers' bytes and the arrivals of its own lanes
  // that hold sums of its units
  // CTAs [owners, 8) own no unit: their W_hh rows are zero, so they sit the
  // recurrence out (a CTA that waited for nothing would run ahead of the
  // double-buffered slots), and the owners sum the first `owners` slots
  const int owners = (H + U - 1) / U;
  const int owned = H - rank * U < 0 ? 0 : H - rank * U < U ? H - rank * U : U;
  const unsigned step_bytes = (unsigned)(4 * (owners - 1) * R * owned);
  const unsigned own_lanes = (unsigned)(owned / 4 * (RP == 1 ? kGroup / 2 : kGroup) * NP);

  // phase B lane: columns 4kq .. 4kq + 3, gate-row chunks 8i + g
  const int g = tid & (kGroup - 1), kq = tid / kGroup;
  const bool sums = kq < KQ;
  float4 wreg[NREG][4];
#pragma unroll
  for (int i = 0; i < NCH; ++i)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int p = 4 * (kGroup * i + g) + m;  // padded gate row of the CTA: q*U + u
      const int jj = rank * U + p % U;
      float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (sums && p < 4 * U && jj < H)
        w = *reinterpret_cast<const float4*>(d.w_hh + ((size_t)(p / U) * H + jj) * H + 4 * kq);
      if (i < NREG)
        wreg[i < NREG ? i : 0][m] = w;
      else if (sums)
        w_s[(((size_t)(i - NREG) * 4 + m) * KQ + kq) * kGroup + g] = w;
    }
  for (int i = tid; i < 2 * R * PR; i += blockDim.x) dg_s[i] = 0.0f;

  // phase A thread: (row r, unit j)
  const int r = tid / U, u = tid % U;
  const int j = rank * U + u;
  const bool unit = tid < RU && j < H;
  const bool active = unit && b0 + r < B;
  auto fetch = [&](int s) {  // step s's inputs into ring slot s % kRing, zero past T
    if (tid < RU) {
      const bool ok = active && s < T;
      const int t = d.reverse ? s : T - 1 - s;
      const size_t row = (size_t)t * B + b0 + r;
      float* dst = ring + (size_t)(s % kRing) * kStepIn * RU + tid;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        cp_async4(dst + (size_t)q * RU, ok ? d.gates + row * H4 + q * H + j : d.gates, ok ? 4 : 0);
      cp_async4(dst + (size_t)4 * RU, ok ? cs + row * ld + d.col + j : cs, ok ? 4 : 0);
      cp_async4(dst + (size_t)5 * RU, ok ? g_hs + row * ld + d.col + j : g_hs, ok ? 4 : 0);
    }
    cp_async_commit();
  };
  auto store_dg = [&](int s, const float(&dg)[4]) {
    if (active) {
      const int t = d.reverse ? s : T - 1 - s;
      float* out = d.dgates + ((size_t)t * B + b0 + r) * H4 + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) out[q * H] = dg[q];
    }
  };
  for (int s = 0; s < kRing; ++s) fetch(s);
  if (tid == 0) {
    mbar_init(bar0, 1 + own_lanes);
    mbar_init(bar0 + 8, 1 + own_lanes);
    // each slot buffer armed for the first step that sends into it
    if (owned > 0 && T >= 2) mbar_expect_tx(bar0, step_bytes);
    if (owned > 0 && T >= 3) mbar_expect_tx(bar0 + 8, step_bytes);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every peer has started and armed its mbarriers before any st.async
  cluster.sync();

  float dc_rec = 0.0f, dh_rec = 0.0f;
  for (int s = 0; s < (rank < owners ? T : 0); ++s) {
    // inputs: all of step s that does not wait for dh_rec
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 2) : "memory");
    float ca = 0.0f, cb = 0.0f, cc = 0.0f, cd = 0.0f, ce = 0.0f, f = 0.0f, gy = 0.0f;
    if (tid < RU) {
      const float* in = ring + (size_t)(s % kRing) * kStepIn * RU + tid;
      const float c_prev = ring[(size_t)((s + 1) % kRing) * kStepIn * RU + 4 * RU + tid];
      const float i = sigmoid_acc(in[0]), gg = tanhf(in[2 * RU]), o = sigmoid_acc(in[3 * RU]);
      f = sigmoid_acc(in[RU]);
      const float tc = tanhf(in[4 * RU]);
      gy = in[5 * RU];
      ca = gg * i * (1.0f - i);
      cb = c_prev * f * (1.0f - f);
      cc = i * (1.0f - gg * gg);
      cd = tc * o * (1.0f - o);
      ce = o * (1.0f - tc * tc);
    }
    fetch(s + kRing);  // into the slot just read
    // phase A: dh_rec from the partial sums of the last step, in rank order.
    // Whole warps wait (with only the unit lanes waiting, K7 hung at one row
    // and 8 or 12 units a CTA on an H100; cause not established, PERF.md)
    float dg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (s > 0 && owned > 0 && tid < (RU + 31) / 32 * 32)
      mbar_wait(bar0 + 8 * ((s - 1) & 1), ((s - 1) >> 1) & 1);
    if (tid < RU) {
      if (unit && s > 0) {
        const int buf = (s - 1) & 1;
        const float* sl = slot + ((size_t)buf * kCluster * R + r) * U + u;
        float part[kCluster];
#pragma unroll
        for (int c = 0; c < kCluster; ++c) part[c] = c < owners ? sl[(size_t)c * RU] : 0.0f;
        dh_rec = 0.0f;
#pragma unroll
        for (int c = 0; c < kCluster; ++c)
          if (c < owners) dh_rec += part[c];
        // buffer `buf` is next sent into at step s + 1
        if (tid == 0 && s + 1 <= T - 2) mbar_expect_tx(bar0 + 8 * buf, step_bytes);
      }
      const float dh = gy + dh_rec;
      const float dc = dc_rec + dh * ce;
      dc_rec = dc * f;
      if (active) {
        dg[0] = dc * ca;
        dg[1] = dc * cb;
        dg[2] = dc * cc;
        dg[3] = dh * cd;
      }
      float* dgs = dg_s + (size_t)((s & 1) * R + r) * PR + u;
#pragma unroll
      for (int q = 0; q < 4; ++q) dgs[q * U] = dg[q];
    }
    // with two passes the gate gradients leave their registers first
    if (NP > 1) store_dg(s, dg);
    if (s < T - 1) {
      __syncwarp();  // every warp meets the block barrier converged
      __syncthreads();
      // phase B: the CTA's partial dh_rec at columns 4kq .. + 3 for its R rows
      // (every lane of a warp takes part in the shuffles; lanes past H/4
      // quads hold zeros and send nothing)
#pragma unroll
      for (int pass = 0; pass < NP; ++pass) {  // rows pass*RP .. + RP
        float acc[4 * RP];  // (RP, 4)
#pragma unroll
        for (int n = 0; n < 4 * RP; ++n) acc[n] = 0.0f;
        const float4* dg4 =
            reinterpret_cast<const float4*>(dg_s + ((size_t)(s & 1) * R + pass * RP) * PR);
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
          float4 w[4];
#pragma unroll
          for (int m = 0; m < 4; ++m)
            w[m] = i < NREG ? wreg[i < NREG ? i : 0][m]
                   : sums   ? w_s[(((size_t)(i - NREG) * 4 + m) * KQ + kq) * kGroup + g]
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
          for (int rr = 0; rr < RP; ++rr) {
            const float4 v = dg4[rr * (PR / 4) + kGroup * i + g];
            const float dv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              acc[rr * 4 + 0] = fmaf(dv[m], w[m].x, acc[rr * 4 + 0]);
              acc[rr * 4 + 1] = fmaf(dv[m], w[m].y, acc[rr * 4 + 1]);
              acc[rr * 4 + 2] = fmaf(dv[m], w[m].z, acc[rr * 4 + 2]);
              acc[rr * 4 + 3] = fmaf(dv[m], w[m].w, acc[rr * 4 + 3]);
            }
          }
        }
        lane_scatter(acc, g);
        // exchange: the lane's sums into the owner's slot of this rank
        const int e = 4 * RP >= kGroup ? g * NV : g / 2;  // first flat (row, column) entry
        const int k = 4 * kq + e % 4;
        const int owner = k / U, buf = s & 1;
        float* dst =
            slot + ((size_t)(buf * kCluster + rank) * R + pass * RP + e / 4) * U + k % U;
        if (sums && (RP > 1 || (g & 1) == 0)) {
          if (owner == rank) {  // the CTA's own sums: plain stores and an arrival
#pragma unroll
            for (int n = 0; n < NV; ++n) dst[n] = acc[n];
            mbar_arrive(bar0 + 8 * buf);
          } else {
            st_async<NV>(map_rank(smem_addr(dst), owner), acc, map_rank(bar0 + 8 * buf, owner));
          }
        }
      }
    }
    if (NP == 1) store_dg(s, dg);  // off the critical path
  }
  cp_async_wait_all();
  // no CTA leaves while a peer may still address it
  cluster.sync();
}

template <int R, int NCH>
cudaError_t launch_lstm_bwd_t(const BwdDirs& dirs, const float* cs, const float* g_hs, int T,
                              int B, int H, int ndir, cudaStream_t stream, int* max_clusters) {
  auto kernel = lstm_bwd_kernel<R, NCH>;
  const int U = lstm_units(H);
  const size_t smem = sizeof(float) * lstm_bwd_smem_floats(H, R, U);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * ((B + R - 1) / R), ndir);
  cfg.blockDim = dim3(lstm_bwd_threads(H, R, U));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(max_clusters, (const void*)kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, dirs, cs, g_hs, T, B, H, ndir * H);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int R>
cudaError_t launch_lstm_bwd_r(const BwdDirs& dirs, const float* cs, const float* g_hs, int T,
                              int B, int H, int ndir, cudaStream_t stream, int* max_clusters) {
  switch (lstm_bwd_chunks(lstm_units(H))) {
    case 1: return launch_lstm_bwd_t<R, 1>(dirs, cs, g_hs, T, B, H, ndir, stream, max_clusters);
    case 2: return launch_lstm_bwd_t<R, 2>(dirs, cs, g_hs, T, B, H, ndir, stream, max_clusters);
    case 3: return launch_lstm_bwd_t<R, 3>(dirs, cs, g_hs, T, B, H, ndir, stream, max_clusters);
    case 4: return launch_lstm_bwd_t<R, 4>(dirs, cs, g_hs, T, B, H, ndir, stream, max_clusters);
    case 5: return launch_lstm_bwd_t<R, 5>(dirs, cs, g_hs, T, B, H, ndir, stream, max_clusters);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_lstm_bwd(const BwdDirs& dirs, const float* cs, const float* g_hs, int T, int B,
                            int H, int ndir, int rows, cudaStream_t stream, int* max_clusters) {
  if (H < 4 || H > kLstmMaxH || H % 4 != 0 || ndir < 1 || ndir > 2) return cudaErrorInvalidValue;
  switch (rows) {
    case 1: return launch_lstm_bwd_r<1>(dirs, cs, g_hs, T, B, H, ndir, stream, max_clusters);
    case 2: return launch_lstm_bwd_r<2>(dirs, cs, g_hs, T, B, H, ndir, stream, max_clusters);
    case 4: return launch_lstm_bwd_r<4>(dirs, cs, g_hs, T, B, H, ndir, stream, max_clusters);
    case 8: return launch_lstm_bwd_r<8>(dirs, cs, g_hs, T, B, H, ndir, stream, max_clusters);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------- K8: GRU bwd --
//
// The backward recurrence of `_gru_rec_bwd` (`semi_tts_tpu/ops/rnn.py:244`),
// walked opposite to the forward's time direction, per (batch row, unit k):
//   dh2[t] = g_hs[t] + dh_rec
//   dh_rec = dh2[t] * z[t] + sum_g (coef_h[t, g] * dh2[t, g mod H]) * W_hh[g, k]
// over the 3H gate rows g. Every gate gradient is a coefficient times dh2,
// so the caller recomputes z and coef_h = [cr, cz, dn_c * r] (T, B, 3H) with
// one GEMM and elementwise work, as JAX does, and forms dx_proj, dW_hh and
// db_hh from dh2 with one product or sum each.
//
// What bounds it: as K2, the latency of T dependent steps; bytes and FLOPs
// are far below. One block per batch row and direction. A group of 16 lanes
// (half a warp) serves 4 units k: lane l holds W_hh at the rows l + 16i of
// each gate and the group's 4 columns in registers for the whole sequence
// (past kGruRegRows rows a lane, in its own slots of shared memory), so each
// value of the step's vector read from shared memory feeds 4 FMAs. A step:
// the lanes sum their rows of the vector into 4 chains, a reduce-scatter and
// a butterfly over the group's lane offsets leave unit n's dh_rec in lanes
// 4n .. 4n + 3, which all form dh2; lanes 4n + q (q < 3) write the product
// coef_q * dh2 into the double-buffered vector and lane 4n + 3 stores dh2 to
// global memory after the hand-off. The hand-off is one barrier a step over
// the block's warps (H/4 groups: 10 warps at H = 80); an mbarrier that each
// warp arrives on read slower on an H100 (PERF.md).
// The inputs are loaded two steps ahead into registers, and the step loop is
// unrolled by 2 (faster on an H100, PERF.md).

struct GruBwdDir {
  const float* z;     // (T, B, H) update gate
  const float* coef;  // (T, B, 3H) coef_h
  const float* w_hh;  // (3H, H)
  float* dh;          // (T, B, H) dh2
  int reverse;
  int col;            // columns of this direction in g_hs
};

struct GruBwdDirs {
  GruBwdDir d[2];
};

GruBwdDir make_gru_bwd_dir(const float* z, const float* coef, const float* w_hh, float* dh,
                           int reverse, int col) {
  GruBwdDir d;
  d.z = z;
  d.coef = coef;
  d.w_hh = w_hh;
  d.dh = dh;
  d.reverse = reverse;
  d.col = col;
  return d;
}

constexpr int kGruLanes = 16;       // K8: lanes of a group of 4 units
constexpr int kGruRegRows = 7;      // K8: rows of each gate a lane keeps in registers

// RPL: rows of each gate a lane holds (16*RPL >= H). blockDim.x: 16 lanes for
// each 4 units, rounded up to whole warps.
struct GruBwdIn {  // a lane's inputs of one step
  float gy, z, cf;
};

template <int RPL>
__global__ void __launch_bounds__(64 * RPL, 1)
    gru_bwd_kernel(GruBwdDirs dirs, const float* __restrict__ g_hs, int T, int B, int H, int ld) {
  constexpr int KP = kGruLanes * RPL;  // rows of one gate, zero past H
  constexpr int NR = RPL < kGruRegRows ? RPL : kGruRegRows;
  __shared__ float v[2][3 * KP];       // coef_h * dh2 of a step, gate q at [q * KP, q * KP + H)
  __shared__ float4 w_s[RPL > NR ? 3 * (RPL - NR) * 64 * RPL : 1];  // (3, RPL - NR, threads)
  const GruBwdDir d = blockIdx.y ? dirs.d[1] : dirs.d[0];
  const int l = threadIdx.x & (kGruLanes - 1);
  const int k4 = 4 * (threadIdx.x / kGruLanes);  // the group's first unit
  const int b = blockIdx.x;

  // W_hh[q*H + l + 16i, k4 .. k4 + 3]
  float4 w[3][NR];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const int row = l + kGruLanes * i;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < H) {
        const float* src = d.w_hh + (size_t)(q * H + row) * H + k4;
        x.x = k4 < H ? src[0] : 0.0f;
        x.y = k4 + 1 < H ? src[1] : 0.0f;
        x.z = k4 + 2 < H ? src[2] : 0.0f;
        x.w = k4 + 3 < H ? src[3] : 0.0f;
      }
      if (i < NR)
        w[q][i < NR ? i : 0] = x;
      else
        w_s[((size_t)q * (RPL - NR) + i - NR) * blockDim.x + threadIdx.x] = x;
    }
  for (int i = threadIdx.x; i < 2 * 3 * KP; i += blockDim.x) (&v[0][0])[i] = 0.0f;

  // after the reduction lane l holds unit k = k4 + l / 4; lanes 4n + q write
  // the product of gate q < 3, lane 4n + 3 stores dh2
  const int k = k4 + l / 4, role = l % 4;
  const bool active = k < H;
  auto fetch = [&](int s) {
    GruBwdIn in = {0.0f, 0.0f, 0.0f};
    if (active && s < T) {
      const int t = d.reverse ? s : T - 1 - s;
      const size_t row = (size_t)t * B + b;
      in.gy = g_hs[row * ld + d.col + k];
      in.z = d.z[row * H + k];
      if (role < 3) in.cf = d.coef[row * 3 * H + role * H + k];
    }
    return in;
  };
  GruBwdIn cur = fetch(0), nx1 = fetch(1);
  float dh_rec = 0.0f;
  __syncthreads();

#pragma unroll 2
  for (int s = 0; s < T; ++s) {
    const GruBwdIn nx2 = fetch(s + 2);
    float* vs = v[s & 1];
    const float dh2 = cur.gy + dh_rec;
    if (active && role < 3) vs[role * KP + k] = cur.cf * dh2;
    __syncthreads();  // vs is double-buffered: one barrier a step is race-free
    if (active && role == 3) {
      const int t = d.reverse ? s : T - 1 - s;
      d.dh[((size_t)t * B + b) * H + k] = dh2;
    }
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        const float x = vs[q * KP + l + kGruLanes * i];
        const float4 wv = i < NR ? w[q][i < NR ? i : 0]
                                 : w_s[((size_t)q * (RPL - NR) + i - NR) * blockDim.x + threadIdx.x];
        acc[0] = fmaf(wv.x, x, acc[0]);
        acc[1] = fmaf(wv.y, x, acc[1]);
        acc[2] = fmaf(wv.z, x, acc[2]);
        acc[3] = fmaf(wv.w, x, acc[3]);
      }
    // reduce-scatter over lane offsets 8 and 4, then a butterfly over 2 and 1
#pragma unroll
    for (int o = kGruLanes / 2, n = 4; o > 0; o >>= 1) {
      const bool hi = (l & o) != 0;
      if (n >= 2) {
        const int half = n / 2;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (m < half) {
            const float send = hi ? acc[m] : acc[m + half];
            const float keep = hi ? acc[m + half] : acc[m];
            acc[m] = keep + __shfl_xor_sync(0xffffffffu, send, o);
          }
        }
        n = half;
      } else {
        acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], o);
      }
    }
    dh_rec = fmaf(dh2, cur.z, acc[0]);
    cur = nx1;
    nx1 = nx2;
  }
}

template <int RPL>
cudaError_t launch_gru_bwd_t(const GruBwdDirs& dirs, const float* g_hs, int T, int B, int H,
                             int ndir, cudaStream_t stream) {
  const int threads = (kGruLanes * ((H + 3) / 4) + 31) / 32 * 32;
  gru_bwd_kernel<RPL><<<dim3(B, ndir), threads, 0, stream>>>(dirs, g_hs, T, B, H, ndir * H);
  return cudaGetLastError();
}

}  // namespace


// hs (T, B, ndir*H): direction k (x_proj_k, w_hh_k, reverse_k) fills columns
// [k*H, k*H + H); cs, when not null, gets the cell states in the same layout.
// `rows` is the batch rows per cluster (1, 2, 4 or 8).
extern "C" int lstm_rec_f32(const float* x_proj0, const float* x_proj1, const float* w_hh0,
                            const float* w_hh1, float* hs, float* cs, int T, int B, int H,
                            int ndir, int reverse0, int reverse1, int rows, void* stream) {
  Dirs dirs;
  dirs.d[0] = make_dir(x_proj0, w_hh0, nullptr, reverse0, 0);
  dirs.d[1] = make_dir(x_proj1, w_hh1, nullptr, reverse1, H);
  return (int)launch_lstm(dirs, hs, cs, T, B, H, ndir, rows, (cudaStream_t)stream, nullptr);
}

// How many K1 clusters of `rows` batch rows at hidden size H fit on the card
// at once, or minus a cudaError_t.
extern "C" int lstm_rec_max_clusters(int H, int rows) {
  Dirs dirs = {};
  int n = 0;
  const cudaError_t err = launch_lstm(dirs, nullptr, nullptr, 1, rows, H, 1, rows, nullptr, &n);
  return err == cudaSuccess ? n : -(int)err;
}

// dgates_k (T, B, 4H) of direction k from its gate pre-activations gates_k
// (T, B, 4H) and W_hh_k, and from cs and g_hs (T, B, ndir*H), direction k in
// columns [k*H, k*H + H). `rows` as for lstm_rec_f32.
extern "C" int lstm_rec_bwd_f32(const float* gates0, const float* gates1, const float* w_hh0,
                                const float* w_hh1, const float* cs, const float* g_hs,
                                float* dgates0, float* dgates1, int T, int B, int H, int ndir,
                                int reverse0, int reverse1, int rows, void* stream) {
  BwdDirs dirs;
  dirs.d[0] = make_bwd_dir(gates0, w_hh0, dgates0, reverse0, 0);
  dirs.d[1] = make_bwd_dir(gates1, w_hh1, dgates1, reverse1, H);
  return (int)launch_lstm_bwd(dirs, cs, g_hs, T, B, H, ndir, rows, (cudaStream_t)stream, nullptr);
}

// How many K7 clusters of `rows` batch rows at hidden size H fit on the card
// at once, or minus a cudaError_t.
extern "C" int lstm_rec_bwd_max_clusters(int H, int rows) {
  BwdDirs dirs = {};
  int n = 0;
  const cudaError_t err =
      launch_lstm_bwd(dirs, nullptr, nullptr, 1, rows, H, 1, rows, nullptr, &n);
  return err == cudaSuccess ? n : -(int)err;
}

// As lstm_rec_f32 for the GRU, with b_hh per direction.
extern "C" int gru_rec_f32(const float* x_proj0, const float* x_proj1, const float* w_hh0,
                           const float* w_hh1, const float* b_hh0, const float* b_hh1, float* hs,
                           int T, int B, int H, int ndir, int reverse0, int reverse1,
                           void* stream) {
  if (H < 1 || H > kGruMaxH || ndir < 1 || ndir > 2) return (int)cudaErrorInvalidValue;
  Dirs dirs;
  dirs.d[0] = make_dir(x_proj0, w_hh0, b_hh0, reverse0, 0);
  dirs.d[1] = make_dir(x_proj1, w_hh1, b_hh1, reverse1, H);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (2 * ((H + 15) / 16)) {
    case 2: return (int)launch_gru_t<2>(dirs, hs, T, B, H, ndir, s);
    case 4: return (int)launch_gru_t<4>(dirs, hs, T, B, H, ndir, s);
    case 6: return (int)launch_gru_t<6>(dirs, hs, T, B, H, ndir, s);
    case 8: return (int)launch_gru_t<8>(dirs, hs, T, B, H, ndir, s);
    case 10: return (int)launch_gru_t<10>(dirs, hs, T, B, H, ndir, s);
    case 12: return (int)launch_gru_t<12>(dirs, hs, T, B, H, ndir, s);
    case 14: return (int)launch_gru_t<14>(dirs, hs, T, B, H, ndir, s);
    case 16: return (int)launch_gru_t<16>(dirs, hs, T, B, H, ndir, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dh_k (T, B, H), the dh2 of direction k, from its update gate z_k (T, B, H),
// its coefficients coef_k (T, B, 3H) and W_hh_k, and from g_hs (T, B,
// ndir*H), direction k in columns [k*H, k*H + H).
extern "C" int gru_rec_bwd_f32(const float* z0, const float* z1, const float* coef0,
                               const float* coef1, const float* w_hh0, const float* w_hh1,
                               const float* g_hs, float* dh0, float* dh1, int T, int B, int H,
                               int ndir, int reverse0, int reverse1, void* stream) {
  if (H < 1 || H > kGruMaxH || ndir < 1 || ndir > 2) return (int)cudaErrorInvalidValue;
  GruBwdDirs dirs;
  dirs.d[0] = make_gru_bwd_dir(z0, coef0, w_hh0, dh0, reverse0, 0);
  dirs.d[1] = make_gru_bwd_dir(z1, coef1, w_hh1, dh1, reverse1, H);
  const cudaStream_t s = (cudaStream_t)stream;
  switch ((H + 15) / 16) {
    case 1: return (int)launch_gru_bwd_t<1>(dirs, g_hs, T, B, H, ndir, s);
    case 2: return (int)launch_gru_bwd_t<2>(dirs, g_hs, T, B, H, ndir, s);
    case 3: return (int)launch_gru_bwd_t<3>(dirs, g_hs, T, B, H, ndir, s);
    case 4: return (int)launch_gru_bwd_t<4>(dirs, g_hs, T, B, H, ndir, s);
    case 5: return (int)launch_gru_bwd_t<5>(dirs, g_hs, T, B, H, ndir, s);
    case 6: return (int)launch_gru_bwd_t<6>(dirs, g_hs, T, B, H, ndir, s);
    case 7: return (int)launch_gru_bwd_t<7>(dirs, g_hs, T, B, H, ndir, s);
    case 8: return (int)launch_gru_bwd_t<8>(dirs, g_hs, T, B, H, ndir, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
