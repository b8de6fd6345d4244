// LSTM and GRU recurrences over pre-projected inputs (forward only).
//
// Replaces: the forward of `semi_tts_tpu/ops/rnn.py` `_lstm_rec`
// (`_lstm_rec_fwd`, the same function as the Pallas kernel
// `tools/proto_pallas_rnn.py` `pallas_lstm_rec`) and of `_gru_rec`
// (`_gru_rec_fwd`, with b_hh added before r gates the hidden n-part).
//
// What bounds it on an H100: the T steps are sequential, so the time is T
// times the latency of one step: one (H) x (H, G*H) product per batch row,
// then the cell update. The bytes are small (x_proj, W_hh once, hs) and the
// FLOPs are 2*T*B*G*H*H; neither is near the card's rate at serving shapes.
// The latency of one step is the read of W_hh (1 MB at H=256 for the LSTM,
// 77 KB at H=80 for the GRU) from L2 and two block barriers.
//
// Design: one block per batch row, with a loop over T inside the block in
// place of the TPU's sequential grid. h, c and the gate pre-activations live
// in shared memory across steps (the TPU kernel kept them in VMEM scratch).
// Each warp owns a set of gates and works on four W_hh rows at once, so four
// row reads are in flight per lane; its lanes read a row with neighbouring
// lanes on neighbouring addresses (coalesced, float4 where H % 128 == 0) and
// reduce with shuffles. The product h @ W_hh^T is computed here, not by
// cuBLAS, as in the Pallas body.
// Gate order is torch's: i, f, g, o for the LSTM and r, z, n for the GRU.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// pre[g] = bias[g] + sum_k w[g, k] * h[k] for g in [0, G). Each warp takes
// kRows gates at a time, so kRows independent row reads are in flight per
// lane (the loop is bound by load latency, not by bandwidth); kVec4 reads
// w and h as float4 (needs H % 128 == 0 and a 16-byte aligned w).
constexpr int kRows = 4;

template <bool kVec4>
__device__ __forceinline__ void hidden_product(const float* __restrict__ w,
                                               const float* __restrict__ bias,
                                               const float* h, float* pre,
                                               int G, int H) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int g0 = warp * kRows; g0 < G; g0 += nwarps * kRows) {
    float acc[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[j] = 0.0f;
    if (kVec4) {
      for (int k = lane * 4; k < H; k += 128) {
        const float4 hv = *reinterpret_cast<const float4*>(h + k);
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          if (g0 + j < G) {
            const float4 wv = __ldg(reinterpret_cast<const float4*>(w + (size_t)(g0 + j) * H + k));
            acc[j] = fmaf(wv.w, hv.w, fmaf(wv.z, hv.z, fmaf(wv.y, hv.y, fmaf(wv.x, hv.x, acc[j]))));
          }
        }
      }
    } else {
      for (int k = lane; k < H; k += 32) {
        const float hv = h[k];
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          if (g0 + j < G) acc[j] = fmaf(__ldg(w + (size_t)(g0 + j) * H + k), hv, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const float sum = warp_sum(acc[j]);
      if (lane == 0 && g0 + j < G) pre[g0 + j] = bias[g0 + j] + sum;
    }
  }
}

template <bool kVec4>
__global__ void lstm_rec_kernel(const float* __restrict__ x_proj, const float* __restrict__ w_hh,
                                float* __restrict__ hs, int T, int B, int H, int reverse) {
  extern __shared__ float smem[];
  float* h = smem;          // (H)
  float* c = h + H;         // (H)
  float* gates = c + H;     // (4H)
  const int b = blockIdx.x;
  const int H4 = 4 * H;
  for (int j = threadIdx.x; j < H; j += blockDim.x) { h[j] = 0.0f; c[j] = 0.0f; }
  __syncthreads();
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    // gates = x_proj[t, b] + h @ W_hh^T  (x_proj enters as the "bias")
    hidden_product<kVec4>(w_hh, x_proj + ((size_t)t * B + b) * H4, h, gates, H4, H);
    __syncthreads();
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float i = sigmoid(gates[j]);
      const float f = sigmoid(gates[H + j]);
      const float g = tanhf(gates[2 * H + j]);
      const float o = sigmoid(gates[3 * H + j]);
      const float c2 = f * c[j] + i * g;
      const float h2 = o * tanhf(c2);
      c[j] = c2;
      h[j] = h2;
      hs[((size_t)t * B + b) * H + j] = h2;
    }
    __syncthreads();
  }
}

template <bool kVec4>
__global__ void gru_rec_kernel(const float* __restrict__ x_proj, const float* __restrict__ w_hh,
                               const float* __restrict__ b_hh, float* __restrict__ hs,
                               int T, int B, int H, int reverse) {
  extern __shared__ float smem[];
  float* h = smem;          // (H)
  float* hp = h + H;        // (3H): h @ W_hh^T + b_hh
  const int b = blockIdx.x;
  const int H3 = 3 * H;
  for (int j = threadIdx.x; j < H; j += blockDim.x) h[j] = 0.0f;
  __syncthreads();
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    hidden_product<kVec4>(w_hh, b_hh, h, hp, H3, H);
    __syncthreads();
    const float* xp = x_proj + ((size_t)t * B + b) * H3;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float r = sigmoid(xp[j] + hp[j]);
      const float z = sigmoid(xp[H + j] + hp[H + j]);
      const float n = tanhf(xp[2 * H + j] + r * hp[2 * H + j]);
      const float h2 = (1.0f - z) * n + z * h[j];
      h[j] = h2;
      hs[((size_t)t * B + b) * H + j] = h2;
    }
    __syncthreads();
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool vec4_ok(const float* w, int H) {
  return H % 128 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
}

template <bool kVec4>
int launch_lstm(const float* x_proj, const float* w_hh, float* hs, int T, int B, int H,
                int reverse, cudaStream_t stream) {
  // h, c and the gates; 16-byte aligned offsets for the float4 reads of h
  const size_t smem = (size_t)6 * H * sizeof(float);
  cudaError_t err = set_smem(lstm_rec_kernel<kVec4>, smem);
  if (err != cudaSuccess) return (int)err;
  lstm_rec_kernel<kVec4><<<B, kThreads, smem, stream>>>(x_proj, w_hh, hs, T, B, H, reverse);
  return (int)cudaGetLastError();
}

template <bool kVec4>
int launch_gru(const float* x_proj, const float* w_hh, const float* b_hh, float* hs,
               int T, int B, int H, int reverse, cudaStream_t stream) {
  const size_t smem = (size_t)4 * H * sizeof(float);
  cudaError_t err = set_smem(gru_rec_kernel<kVec4>, smem);
  if (err != cudaSuccess) return (int)err;
  gru_rec_kernel<kVec4><<<B, kThreads, smem, stream>>>(x_proj, w_hh, b_hh, hs, T, B, H, reverse);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lstm_rec_f32(const float* x_proj, const float* w_hh, float* hs,
                            int T, int B, int H, int reverse, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return vec4_ok(w_hh, H) ? launch_lstm<true>(x_proj, w_hh, hs, T, B, H, reverse, s)
                          : launch_lstm<false>(x_proj, w_hh, hs, T, B, H, reverse, s);
}

extern "C" int gru_rec_f32(const float* x_proj, const float* w_hh, const float* b_hh, float* hs,
                           int T, int B, int H, int reverse, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return vec4_ok(w_hh, H) ? launch_gru<true>(x_proj, w_hh, b_hh, hs, T, B, H, reverse, s)
                          : launch_gru<false>(x_proj, w_hh, b_hh, hs, T, B, H, reverse, s);
}
