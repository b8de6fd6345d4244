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
//   block barrier.
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
// What bounds it: as K1, the latency of T dependent steps. The step product
// has K1's shape transposed, so K1's layout is kept: a cluster of 8 CTAs
// serves R batch rows of one direction, and CTA r keeps the 4*U gate rows of
// W_hh of its units [r*U, r*U + U) in shared memory (128 KiB at H=256),
// loaded once. A step: (A) thread (row, unit) updates dh/dc and its 4 gate
// gradients, which only need that unit's dh_rec and dc, so they stay local;
// (B) thread k forms the CTA's partial sum of dh_rec[k] over its 4*U rows for
// all R rows (W_hh read once per row group, gate gradients as float4
// broadcasts) and stores it into the slot of its rank in the CTA that owns
// unit k, through distributed shared memory; one cluster barrier; the owner
// sums the 8 slots in rank order at the next step's (A). The slots are
// double-buffered, so one barrier a step is race-free. The next step's
// inputs are loaded into registers one step ahead.

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

// Shared memory of one K7 CTA, in floats: W_hh rows (4U, H), the partial-sum
// slots (2, kCluster, R, U) and the gate gradients (R, 4U).
__host__ __device__ constexpr size_t lstm_bwd_smem_floats(int H, int R, int U) {
  return (size_t)4 * U * H + (size_t)2 * kCluster * R * U + (size_t)R * 4 * U;
}

__device__ __forceinline__ float sigmoid_acc(float x) { return 1.0f / (1.0f + expf(-x)); }

struct StepIn {  // one (row, unit)'s inputs of a step
  float gi, gf, gg, go, c, c_prev, gy;
};

template <int R>
__global__ void __launch_bounds__(kGroup * kLstmMaxUnits, 1)
    lstm_bwd_kernel(BwdDirs dirs, const float* __restrict__ cs, const float* __restrict__ g_hs,
                    int T, int B, int H, int ld) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const BwdDir d = blockIdx.y ? dirs.d[1] : dirs.d[0];
  const int U = blockDim.x / kGroup;
  const int U4 = 4 * U;
  float* w_s = reinterpret_cast<float*>(smem4);         // (4U, H): row q*U + u
  float* slot = w_s + (size_t)U4 * H;                   // (2, kCluster, R, U)
  float* dg_s = slot + (size_t)2 * kCluster * R * U;    // (R, 4U)
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int b0 = (blockIdx.x / kCluster) * R;
  const int H4 = 4 * H;

  for (int idx = tid; idx < U4 * (H / 4); idx += blockDim.x) {
    const int wrow = idx / (H / 4), c = idx % (H / 4);
    const int q = wrow / U, jj = rank * U + wrow % U;
    const bool ok = jj < H;
    const float* src = ok ? d.w_hh + ((size_t)q * H + jj) * H + 4 * c : d.w_hh;
    cp_async16(w_s + (size_t)wrow * H + 4 * c, src, ok ? 16 : 0);
  }
  cp_async_commit();
  for (int i = tid; i < 2 * kCluster * R * U; i += blockDim.x) slot[i] = 0.0f;

  // phase A: thread (r, u)
  const int r = tid / U, u = tid % U;
  const int j = rank * U + u;
  const bool active = r < R && j < H && b0 + r < B;
  auto fetch = [&](int s) {
    StepIn in = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (active && s < T) {
      const int t = d.reverse ? s : T - 1 - s;
      const int tp = d.reverse ? t + 1 : t - 1;  // the step whose carry t consumed
      const size_t row = (size_t)t * B + b0 + r;
      const float* gt = d.gates + row * H4 + j;
      in.gi = gt[0];
      in.gf = gt[H];
      in.gg = gt[2 * H];
      in.go = gt[3 * H];
      in.c = cs[row * ld + d.col + j];
      in.c_prev = (tp >= 0 && tp < T) ? cs[((size_t)tp * B + b0 + r) * ld + d.col + j] : 0.0f;
      in.gy = g_hs[row * ld + d.col + j];
    }
    return in;
  };
  StepIn cur = fetch(0);
  float dc_rec = 0.0f;
  cp_async_wait_all();
  // W_hh has landed and every peer has started before any slot store
  cluster.sync();

  for (int s = 0; s < T; ++s) {
    const StepIn nxt = fetch(s + 1);
    if (r < R) {
      float dh_rec = 0.0f;
      if (s > 0) {
        const float* sl = slot + ((size_t)((s - 1) & 1) * kCluster * R + r) * U + u;
#pragma unroll
        for (int c = 0; c < kCluster; ++c) dh_rec += sl[(size_t)c * R * U];
      }
      const float i = sigmoid_acc(cur.gi), f = sigmoid_acc(cur.gf);
      const float g = tanhf(cur.gg), o = sigmoid_acc(cur.go);
      const float tc = tanhf(cur.c);
      const float dh = cur.gy + dh_rec;
      const float dc = dc_rec + dh * o * (1.0f - tc * tc);
      const float dg[4] = {dc * g * i * (1.0f - i), dc * cur.c_prev * f * (1.0f - f),
                           dc * i * (1.0f - g * g), dh * tc * o * (1.0f - o)};
      dc_rec = dc * f;
      if (active) {
        const int t = d.reverse ? s : T - 1 - s;
        float* out = d.dgates + ((size_t)t * B + b0 + r) * H4 + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) out[q * H] = dg[q];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) dg_s[r * U4 + q * U + u] = active ? dg[q] : 0.0f;
    }
    if (s == T - 1) break;  // the last step's dh_rec is not needed
    __syncthreads();
    // phase B: thread k, the CTA's partial dh_rec[k] for each of its R rows
    const int buf = s & 1;
    for (int k = tid; k < H; k += blockDim.x) {
      float acc[R];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) acc[rr] = 0.0f;
      const float4* dg4 = reinterpret_cast<const float4*>(dg_s);
      for (int q4 = 0; q4 < U; ++q4) {  // rows 4*q4 .. 4*q4 + 3 of the CTA's 4U
        const float* wr = w_s + (size_t)(4 * q4) * H + k;
        const float w0 = wr[0], w1 = wr[H], w2 = wr[2 * H], w3 = wr[3 * H];
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          const float4 v = dg4[rr * U + q4];
          acc[rr] = fmaf(v.x, w0, fmaf(v.y, w1, fmaf(v.z, w2, fmaf(v.w, w3, acc[rr]))));
        }
      }
      const int owner = k / U, uu = k % U;
      float* dst = slot + ((size_t)(buf * kCluster + rank) * R) * U + uu;
#pragma unroll
      for (int rr = 0; rr < R; ++rr) *cluster.map_shared_rank(dst + (size_t)rr * U, owner) = acc[rr];
    }
    cluster.sync();
    cur = nxt;
  }
}

template <int R>
cudaError_t launch_lstm_bwd_r(const BwdDirs& dirs, const float* cs, const float* g_hs, int T,
                              int B, int H, int ndir, cudaStream_t stream, int* max_clusters) {
  auto kernel = lstm_bwd_kernel<R>;
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
  cfg.blockDim = dim3(kGroup * U);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(max_clusters, (const void*)kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, dirs, cs, g_hs, T, B, H, ndir * H);
  return err != cudaSuccess ? err : cudaGetLastError();
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
// are far below. K2's layout transposed: one block per batch row and
// direction, a group of 8 lanes per unit k, each lane holding column k of
// W_hh at the gate rows g + 8i of each gate in registers for the whole
// sequence. A step: the unit's leader lane forms dh2 and the three products
// coef * dh2 of its unit into a double-buffered shared vector; one block
// barrier; every lane sums its rows of that vector against its W_hh column
// and a few xor shuffles give the leader the unit's dh_rec. dh_rec never
// leaves the leader's registers, and the next step's inputs are loaded one
// step ahead.

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

struct GruBwdIn {  // a unit's inputs of one step
  float gy, z, cr, cz, cn;
};

// KPL: gate rows of each gate a lane holds (8*KPL >= H). One block per batch row.
template <int KPL>
__global__ void __launch_bounds__(64 * KPL)
    gru_bwd_kernel(GruBwdDirs dirs, const float* __restrict__ g_hs, int T, int B, int H, int ld) {
  constexpr int KP = kGroup * KPL;  // rows of one gate, zero past H
  __shared__ float dhp[2][3 * KP];  // coef_h * dh2 of a step, gate q at [q * KP, q * KP + H)
  const GruBwdDir d = blockIdx.y ? dirs.d[1] : dirs.d[0];
  const int g = threadIdx.x & (kGroup - 1);
  const int k = threadIdx.x / kGroup;
  const bool active = k < H;
  const bool leader = active && g == 0;
  const int b = blockIdx.x;

  // column k of W_hh at rows q*H + g + 8i: registers for all T steps
  float w[3][KPL];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int row = g + kGroup * i;
      w[q][i] = active && row < H ? d.w_hh[(size_t)(q * H + row) * H + k] : 0.0f;
    }
  for (int i = threadIdx.x; i < 2 * 3 * KP; i += blockDim.x) (&dhp[0][0])[i] = 0.0f;

  auto fetch = [&](int s) {
    GruBwdIn in = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (leader && s < T) {
      const int t = d.reverse ? s : T - 1 - s;
      const size_t row = (size_t)t * B + b;
      const float* c = d.coef + row * 3 * H;
      in.gy = g_hs[row * ld + d.col + k];
      in.z = d.z[row * H + k];
      in.cr = c[k];
      in.cz = c[H + k];
      in.cn = c[2 * H + k];
    }
    return in;
  };
  GruBwdIn cur = fetch(0);
  float dh_rec = 0.0f;
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const GruBwdIn nxt = fetch(s + 1);
    float* v = dhp[s & 1];
    float dh2 = 0.0f;
    if (leader) {
      const int t = d.reverse ? s : T - 1 - s;
      dh2 = cur.gy + dh_rec;
      d.dh[((size_t)t * B + b) * H + k] = dh2;
      v[k] = cur.cr * dh2;
      v[KP + k] = cur.cz * dh2;
      v[2 * KP + k] = cur.cn * dh2;
    }
    __syncthreads();  // dhp is double-buffered: one barrier a step is race-free
    float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int i = 0; i < KPL; ++i) acc[q] = fmaf(w[q][i], v[q * KP + g + kGroup * i], acc[q]);
    group_sum(acc);
    if (leader) dh_rec = fmaf(dh2, cur.z, (acc[0] + acc[1]) + acc[2]);
    cur = nxt;
  }
}

template <int KPL>
cudaError_t launch_gru_bwd_t(const GruBwdDirs& dirs, const float* g_hs, int T, int B, int H,
                             int ndir, cudaStream_t stream) {
  const int threads = (kGroup * H + 31) / 32 * 32;
  gru_bwd_kernel<KPL><<<dim3(B, ndir), threads, 0, stream>>>(dirs, g_hs, T, B, H, ndir * H);
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
  switch (2 * ((H + 15) / 16)) {
    case 2: return (int)launch_gru_bwd_t<2>(dirs, g_hs, T, B, H, ndir, s);
    case 4: return (int)launch_gru_bwd_t<4>(dirs, g_hs, T, B, H, ndir, s);
    case 6: return (int)launch_gru_bwd_t<6>(dirs, g_hs, T, B, H, ndir, s);
    case 8: return (int)launch_gru_bwd_t<8>(dirs, g_hs, T, B, H, ndir, s);
    case 10: return (int)launch_gru_bwd_t<10>(dirs, g_hs, T, B, H, ndir, s);
    case 12: return (int)launch_gru_bwd_t<12>(dirs, g_hs, T, B, H, ndir, s);
    case 14: return (int)launch_gru_bwd_t<14>(dirs, g_hs, T, B, H, ndir, s);
    case 16: return (int)launch_gru_bwd_t<16>(dirs, g_hs, T, B, H, ndir, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
