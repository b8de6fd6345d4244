#!/usr/bin/env python3
"""Where the time of K3 `attention_step`, K9 `attention_step_bwd`, K4
`gl_ola_frame`, K5 `stft_frames`, K6 `ctc_alpha` and `ctc_beta_grad`, K7
`bilstm_rec_bwd`, K8 `bigru_rec_bwd` and B6 `trim_merge` goes, on one NVIDIA
card; and the ASR, paired or speech-first train step's time in a given tree.

    python3 chip_ablate.py [--src TREE] [--only SRC,...]
    python3 chip_ablate.py --asr-busy TREE
    python3 chip_ablate.py --paired-busy TREE
    python3 chip_ablate.py --speech-first-busy TREE
    python3 chip_ablate.py --kernel-mem TREE
    python3 chip_ablate.py --sanitize k7|k6|b6|b6_bwd --plan T=..,B=..[,...] [--variant unit_lanes]
    python3 chip_ablate.py --sanitize-all

The first builds copies of ``semi_tts_tpu_torch/csrc/attention.cu``,
``ctc.cu``, ``features.cu``, ``griffin_lim.cu``, ``quantize.cu`` and
``rnn.cu`` that stop after a phase (into the kernels' build directory,
under ``ablate/``), and times each copy at `chip_smoke.py`'s shapes for that
kernel (K9 at every shape a train step gives it, `K9_SHAPES`; K6 at
`K6_SHAPES`; K5 at `K5_SHAPES`, and at every tile of `K5_TILES`; B6 at
`B6_SHAPES`), beside the whole kernel, as
device time per call from a replayed CUDA graph. A cut copy computes
nothing useful: only its time means anything, and the time of a phase is
the difference between two cuts. Entries named "whole kernel, ..." are
whole variants of the kernel (another design, a constant changed); their
largest difference from the plain version is reported (``max_abs_err``). A one-shot kernel (K3, K4, K9) returns after the phase; a recurrence
(K7, K8) ends every step there, and its cuts also drop the waits on the
phases cut away, so that no step waits for data that never comes. Each
kernel has a cut list per design, and the copy takes the list whose every
marker is a line of the source: an edit that moves a marker fails loudly.
``--src TREE`` times the checkout at TREE the same way, with that tree's
sources, wrappers and `chip_smoke.py`, which times an earlier design beside
this one. ``--only ctc,rnn`` times the cuts of those sources alone. Prints
the card's name and power limit, then one JSON line ``{"ablation": ...}``.

The other three run the flagship ASR step (K6 at T=133), the paired step,
or the speech-first step with the flagship's unpaired weights
(`chip_smoke.py`'s B=8 x 3.0 s batches; K9 at L=133), of the checkout at
TREE, with that tree's `chip_smoke.py`
and package: six steps (the median wall of the last five) and three
profiled steps, numbers 10 to 12 (device busy time, kernel launches and
the device time of K6's kernels or K9's, and in the speech-first step K5's
and B6's, ``picked_ms``), and the peak
device memory of the six.
To compare two trees, run it for each in one call, in the order parent,
change, change, parent. Prints one JSON line ``{"asr_busy": ...}``,
``{"paired_busy": ...}`` or ``{"speech_first_busy": ...}``.

``--kernel-mem TREE`` reports the device memory that the checkout's
`chip_smoke.py` phases before serving leave allocated (`kernel_mem`).

``--sanitize`` launches one kernel once at the given plan (K7
`bilstm_rec_bwd`: T, B, H, ndir; K6 `ctc_beta_grad`: B, T, S; B6
`trim_merge`: B, T; `trim_merge_bwd`: B, T), from a copy of its source whose
mbarrier waits trap after 60 s instead of 2 s (a kernel under
``compute-sanitizer`` runs many times slower), and prints its largest
difference from the plain version; ``--variant unit_lanes`` builds K7 with
only its unit lanes waiting for the partial sums (the wait that hung at one
row and 8 or 12 units a CTA). ``--sanitize-all`` runs every plan of
`SANITIZE_PLANS` under ``compute-sanitizer --tool synccheck`` and ``--tool
racecheck`` (each instrumenting only the kernel's own launches) and once
without a tool, writes each log under the kernels' build directory
(``ablate/sanitize/``), and prints
one JSON line ``{"sanitize": [...]}``: each run's error summary, exit code
and wall time.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch


def after(marker, text):
    """An edit that puts ``text`` after the line(s) ``marker``."""
    return marker, marker + text


def ret(marker):
    return after(marker, "  return;\n")


# K7: a cut that drops the wait on the slots drops their re-arming too, as
# no bytes complete the phase it armed
WAIT = ("    if (s > 0 && owned > 0 && tid < (RU + 31) / 32 * 32)\n"
        "      mbar_wait(bar0 + 8 * ((s - 1) & 1), ((s - 1) >> 1) & 1);\n")
REARM = "        if (tid == 0 && s + 1 <= T - 2) mbar_expect_tx(bar0 + 8 * buf, step_bytes);\n"
# K5, a CTA a tile: the starts of a tile's staging, padded signal and frames
K5_STAGE = "  // 1. the tile's samples on their way; the window row meanwhile\n"
K5_SIGNAL = "  // 2. the tile's padded signal, a sample at a time\n"
K5_FRAMES = "  // 3. the windowed frames: a thread a column of the tile's rows, its window\n"
# K5, a CTA a tile: the kernel built and launched with n threads a CTA
def K5_THREADS(n):
    return [("constexpr int kThreads = 256;", f"constexpr int kThreads = {n};"),
            ("      threads < 32 || threads > kThreads ||", "      threads < 32 || threads > 1024 ||"),
            ("  cfg.blockDim = dim3(threads);\n", f"  cfg.blockDim = dim3({n});\n")]


# B6, bulk copies at entry: a cut's wait for the staged latent's bulk copy
B6_LATENT_WAIT = "  if (stage_latent) mbar_wait(bar0 + 16, 0);\n"
# K9 (PR 6): the end of a tile's wait for its processed memory, and of the tile loop
K9_PM_WAIT = ('    asm volatile("cp.async.wait_group 1;\\n" ::: "memory");  '
              "// this tile's processed memory\n    __syncthreads();\n")
K9_LOOP_END = ("      __syncthreads();  // the tile's buffers are free for the next\n    }\n  }\n"
               "  __syncthreads();\n")

# K9 (PR 8): the dispatch of the per-span kernel with loc_lin staged, made
# to read it from L2
K9_DISPATCH = tuple("".join(f"      case {P}: launch = launch_bwd<{P}, {stage}>; break;\n"
                            for P in range(4, 33, 4)) for stage in ("true", "false"))

# K6, the first design: the end of each kernel's parameter list, where a cut
# returns at once
K6_ALPHA_START = " " * 33 + "float* __restrict__ nll, int B, int T, int C, int U, int blank) {\n"
K6_BETA_START = " " * 32 + "float* __restrict__ occ, int B, int T, int C, int U, int blank) {\n"
K6_GRAD_START = " " * 32 + "float* __restrict__ grad, int B, int T, int C, int U, int blank) {\n"
# K6, chain warps: the start of each kernel; a thread's alpha stores of a step;
# the chain's barrier a step; the backward chain's wait for a consumed slot
# and its log occupancies; the class-sum warps after their lists
K6_ALPHA_W = ("  const int nl = blockDim.x, L = threadIdx.x, ls = 32 * K * (nl >> 5) + 4;  "
              "// a step's row\n")
K6_BETA_W = ("  const int W = (blockDim.x >> 5) - kConsumerWarps, nl = 32 * W, "
             "ls = 32 * K * W + 4;\n")
K6_ALPHA_STORE = ("        next[j] = a[j];\n        st_if((on >> j) & 1, out + j, a[j]);\n",
                  "        next[j] = a[j];\n")
K6_BAR = 'asm volatile("bar.sync 1, %0;\\n" ::"r"(nl) : "memory");\n'
K6_ALPHA_BAR = ("      " + K6_BAR + "    }\n    cur = nxt;\n", "    }\n    cur = nxt;\n")
K6_BETA_BAR = ("          " + K6_BAR + "          if (i > 0)", "          if (i > 0)")
K6_EMPTY_WAIT = ("      if (k >= kDepth) mbar_wait(empty0 + 8 * slot, ((k / kDepth) - 1) & 1);  "
                 "// slot consumed\n", "")
K6_OCC = ("      for (int j = 0; j < K; ++j) ok[(size_t)(i * K + j) * nl] = a_cur.v[i][j] + beta[j] + "
          "nll_b;\n")
K6_NO_SUMS = ("  const float gb = g[b];\n", "  return;\n  const float gb = g[b];\n")
K6_SEG_SUMS = ('    asm volatile("bar.sync 2, %0;\\n" ::"r"(kConsumers) : "memory");  '
               "// the segment sums are in\n")
# the class sums with runs not cut into segments: a thread a (run, step)
# adds the exp of the whole run's occupancies from the ring, and the ring
# slot is handed back after that (the chain-warp design's first class sums)
K6_RUN_SUMS = [
    ("      const int r = blk * 32 + lane;\n", "      continue;\n      const int r = blk * 32 + lane;\n"),
    ("    mbar_arrive(empty0 + 8 * slot);  // chunk k's occupancies are read\n", ""),
    ("      for (int j = run_seg[q]; j < run_seg[q + 1]; ++j) acc += part[j * CH + i];\n",
     "      for (int r = seg[run_seg[q]]; r < seg[run_seg[q + 1]]; ++r)\n"
     "        acc += expf(fminf(ok[(size_t)i * K * nl + (spos[r] & 0xffff)], 0.0f));\n"),
    ('    asm volatile("bar.sync 2, %0;\\n" ::"r"(kConsumers) : "memory");  // part is free again\n',
     '    mbar_arrive(empty0 + 8 * slot);\n'
     '    asm volatile("bar.sync 2, %0;\\n" ::"r"(kConsumers) : "memory");  // part is free again\n')]
K6_WARPS_5 = ("constexpr int kConsumerWarps = 8;", "constexpr int kConsumerWarps = 5;")
K6_SEG_32 = ("constexpr int kSeg = 8;", "constexpr int kSeg = 32;")
K6_ALPHA_LAUNCH = "template <int K>\ncudaError_t launch_alpha("
K6_ALPHA_SMEM = "  const size_t smem = alpha_smem(K, W);\n"
K6_ALPHA_ARGS = "log_probs, targets, input_lengths, target_lengths, alphas, nll, B, T, C, U, blank"
# Two designs of ctc_alpha that were not kept, whole kernels launched in its
# place. One warp a row, KV states a lane, s-1 and s-2 across
# lanes by shuffles, the gathered emissions in a shared ring of kRing chunks
# that the warp fills with cp.async two chunks ahead.
K6_ONE_WARP = r"""
constexpr int kRing = 3;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

template <int KV>
__global__ void __launch_bounds__(32)
    ctc_alpha_warp_kernel(const float* __restrict__ log_probs, const int* __restrict__ targets,
                          const int* __restrict__ input_lengths,
                          const int* __restrict__ target_lengths, float* __restrict__ alphas,
                          float* __restrict__ nll, int B, int T, int C, int U, int blank) {
  extern __shared__ __align__(16) float ring[];  // (kRing, kChunk, KV, 32)
  const int L = threadIdx.x, S = 2 * U + 1, b = blockIdx.x;
  const int* tgt = targets + (size_t)b * U;
  const int tl = min(target_lengths[b], U);
  const int Tc = max(1, min(input_lengths[b], T));
  const float* lp = log_probs + (size_t)b * T * C;
  int z[KV];
  unsigned on = 0, valid = 0, skip = 0;
#pragma unroll
  for (int j = 0; j < KV; ++j) {
    const int s = L * KV + j;
    z[j] = s < S ? label(tgt, s, blank) : blank;
    if (s < S) on |= 1u << j;
    if (s < 2 * tl + 1) valid |= 1u << j;
    if ((s & 1) && s >= 2 && s < S && z[j] != label(tgt, s - 2, blank)) skip |= 1u << j;
  }
  const int n_chunks = (Tc + kChunk - 1) / kChunk;
  auto load_chunk = [&](int k) {  // chunk k's emissions of this lane's states: one group
    if (k < n_chunks) {
      float* dst = ring + (size_t)(k % kRing) * kChunk * KV * 32 + L;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const float* row = lp + (size_t)min(k * kChunk + i, Tc - 1) * C;
#pragma unroll
        for (int j = 0; j < KV; ++j) cp_async4(dst + (i * KV + j) * 32, row + z[j]);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  load_chunk(0);
  load_chunk(1);
  const size_t t_stride = (size_t)B * S;
  float* out = alphas + (size_t)b * S + L * KV;
  float a[KV];
  for (int k = 0; k < n_chunks; ++k) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // chunk k has landed
    const float* e = ring + (size_t)(k % kRing) * kChunk * KV * 32 + L;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int t = k * kChunk + i;
      if (t >= Tc) break;
      if (t == 0) {
#pragma unroll
        for (int j = 0; j < KV; ++j)
          a[j] = sel(((valid >> j) & 1) && L * KV + j <= 1, e[j * 32], kNegInf);
      } else {
        float up1 = __shfl_up_sync(0xffffffffu, a[KV - 1], 1);
        float up2 = KV >= 2 ? __shfl_up_sync(0xffffffffu, a[KV >= 2 ? KV - 2 : 0], 1)
                            : __shfl_up_sync(0xffffffffu, a[0], 2);
        up1 = sel(L == 0, kNegInf, up1);
        up2 = sel(L < (KV >= 2 ? 1 : 2), kNegInf, up2);
        float nw[KV];
#pragma unroll
        for (int j = 0; j < KV; ++j) {
          const float a1 = j >= 1 ? a[j >= 1 ? j - 1 : 0] : up1;
          const float a2 = sel((skip >> j) & 1, j >= 2 ? a[j >= 2 ? j - 2 : 0] : j == 1 ? up1 : up2,
                               kNegInf);
          nw[j] = sel((valid >> j) & 1, logaddexp3(a[j], a1, a2) + e[(i * KV + j) * 32], kNegInf);
        }
#pragma unroll
        for (int j = 0; j < KV; ++j) a[j] = nw[j];
      }
#pragma unroll
      for (int j = 0; j < KV; ++j) st_if((on >> j) & 1, out + j, a[j]);
      out += t_stride;
    }
    load_chunk(k + 2);  // into the slot of chunk k - 1, read in the last round
  }
  for (int t = Tc; t < T; ++t, out += t_stride) {
#pragma unroll
    for (int j = 0; j < KV; ++j) st_if((on >> j) & 1, out + j, a[j]);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
#pragma unroll
  for (int j = 0; j < KV; ++j) ring[L * KV + j] = a[j];
  __syncwarp();
  if (L == 0) {
    const float a_end = ring[2 * tl];
    const float a_last = tl > 0 ? ring[2 * tl - 1] : kNegInf;
    const float m = fmaxf(a_end, a_last);
    nll[b] = -(m + log1pf(expf(-fabsf(a_end - a_last))));
  }
}

template <int KV>
cudaError_t launch_alpha_warp_kv(const float* log_probs, const int* targets,
                                 const int* input_lengths, const int* target_lengths,
                                 float* alphas, float* nll, int B, int T, int C, int U, int blank,
                                 cudaStream_t st) {
  const size_t smem = (size_t)4 * kRing * kChunk * KV * 32;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ctc_alpha_warp_kernel<KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  ctc_alpha_warp_kernel<KV><<<B, 32, smem, st>>>(log_probs, targets, input_lengths,
                                                 target_lengths, alphas, nll, B, T, C, U, blank);
  return cudaGetLastError();
}

cudaError_t launch_alpha_warp(const float* log_probs, const int* targets, const int* input_lengths,
                              const int* target_lengths, float* alphas, float* nll, int B, int T,
                              int C, int U, int blank, cudaStream_t st) {
  const int kv = (2 * U + 1 + 31) / 32;
  auto f = kv <= 1 ? launch_alpha_warp_kv<1> : kv <= 2 ? launch_alpha_warp_kv<2>
         : kv <= 3 ? launch_alpha_warp_kv<3> : kv <= 4 ? launch_alpha_warp_kv<4>
         : kv <= 8 ? launch_alpha_warp_kv<8> : kv <= 16 ? launch_alpha_warp_kv<16>
                   : launch_alpha_warp_kv<32>;
  return f(log_probs, targets, input_lengths, target_lengths, alphas, nll, B, T, C, U, blank, st);
}

"""
# The kept chain warps with no barrier: s-1 and s-2 inside a warp by
# shuffles; across warps, lane 31 (and 30) of warp w stores its top states'
# values of step t tagged with t in one 64-bit word, into a ring of
# kTagRing steps that warp w + 1 polls. Once a chunk, a warp waits until the
# warp above has read the slots it is about to overwrite. A poll of more
# than 2 s traps.
K6_TAGGED = r"""
constexpr int kTagRing = 32;

__device__ __forceinline__ unsigned long long ld_word(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.volatile.shared.u64 %0, [%1];\n" : "=l"(w) : "r"(smem_addr(p)) : "memory");
  return w;
}

__device__ __forceinline__ float ld_tagged(const unsigned long long* p, int t) {
  unsigned long long w = ld_word(p);
  if ((int)(w >> 32) != t) {
    const unsigned long long t0 = global_ns();
    while ((int)((w = ld_word(p)) >> 32) != t)
      if (global_ns() - t0 > 2000000000ull) __trap();
  }
  return __uint_as_float((unsigned)w);
}

__device__ __forceinline__ void st_word(unsigned long long* p, unsigned long long w) {
  asm volatile("st.volatile.shared.u64 [%0], %1;\n" ::"r"(smem_addr(p)), "l"(w) : "memory");
}

__device__ __forceinline__ void st_tagged(unsigned long long* p, float v, int t) {
  st_word(p, ((unsigned long long)(unsigned)t << 32) | __float_as_uint(v));
}

template <int K>
__global__ void __launch_bounds__(32 * kMaxChainWarps)
    ctc_alpha_tagged_kernel(const float* __restrict__ log_probs, const int* __restrict__ targets,
                            const int* __restrict__ input_lengths,
                            const int* __restrict__ target_lengths, float* __restrict__ alphas,
                            float* __restrict__ nll, int B, int T, int C, int U, int blank) {
  constexpr int CH = kChunk;
  // (W, 2, kTagRing) tagged words; W progress counters (as words); the
  // final alphas
  extern __shared__ __align__(16) unsigned long long tags[];
  const int W = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31, L = threadIdx.x;
  unsigned long long* progress = tags + (size_t)W * 2 * kTagRing;
  float* fin = reinterpret_cast<float*>(progress + W);
  for (int i = threadIdx.x; i < W * (2 * kTagRing + 1); i += blockDim.x) tags[i] = ~0ull;
  __syncthreads();
  unsigned long long* mine = tags + (size_t)w * 2 * kTagRing;
  const unsigned long long* below = mine - 2 * kTagRing;
  const int S = 2 * U + 1;
  const int b = blockIdx.x;
  const int* tgt = targets + (size_t)b * U;
  const int tl = min(target_lengths[b], U);
  const int Tc = max(1, min(input_lengths[b], T));
  const float* lp = log_probs + (size_t)b * T * C;
  int z[K];
  unsigned on = 0, valid = 0, skip = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = L * K + j;
    z[j] = s < S ? label(tgt, s, blank) : blank;
    if (s < S) on |= 1u << j;
    if (s < 2 * tl + 1) valid |= 1u << j;
    if ((s & 1) && s >= 2 && s < S && z[j] != label(tgt, s - 2, blank)) skip |= 1u << j;
  }
  auto fetch = [&](Chunk<CH, K>& c, int k) {
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
    // the warp above has read the steps whose slots this chunk overwrites
    const int need = k * CH + CH - kTagRing;
    if (w + 1 < W && need > 0) {
      const unsigned long long t0 = global_ns();
      while ((long long)ld_word(progress + w + 1) < need)  // ~0 (-1): no chunk yet
        if (global_ns() - t0 > 2000000000ull) __trap();
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int t = k * CH + i;
      if (t >= Tc) break;
      if (t == 0) {
#pragma unroll
        for (int j = 0; j < K; ++j)
          a[j] = sel(((valid >> j) & 1) && L * K + j <= 1, cur.v[0][j], kNegInf);
      } else {
        const int sl = (t - 1) % kTagRing;
        const float x1 = w > 0 ? ld_tagged(below + sl, t - 1) : kNegInf;
        const float x2 = w > 0 ? ld_tagged(below + kTagRing + sl, t - 1) : kNegInf;
        float up1 = __shfl_up_sync(0xffffffffu, a[K - 1], 1);
        float up2 = K >= 2 ? __shfl_up_sync(0xffffffffu, a[K >= 2 ? K - 2 : 0], 1)
                           : __shfl_up_sync(0xffffffffu, a[0], 2);
        up1 = sel(lane == 0, x1, up1);
        up2 = sel(lane == 0, x2, K == 1 && lane == 1 ? x1 : up2);
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
      const int sl = t % kTagRing;
      if (lane == 31) st_tagged(mine + sl, a[K - 1], t);
      if (K >= 2 && lane == 31) st_tagged(mine + kTagRing + sl, a[K >= 2 ? K - 2 : 0], t);
      if (K == 1 && lane == 30) st_tagged(mine + kTagRing + sl, a[0], t);
#pragma unroll
      for (int j = 0; j < K; ++j) st_if((on >> j) & 1, out + j, a[j]);
      out += t_stride;
    }
    if (lane == 0) st_word(progress + w, (unsigned long long)min(k * CH + CH - 1, Tc - 1));
    cur = nxt;
    if (k + 2 < n_chunks) fetch(nxt, k + 2);
  }
  for (int t = Tc; t < T; ++t, out += t_stride) {
#pragma unroll
    for (int j = 0; j < K; ++j) st_if((on >> j) & 1, out + j, a[j]);
  }
#pragma unroll
  for (int j = 0; j < K; ++j) fin[L * K + j] = a[j];
  __syncthreads();
  if (L == 0) {
    const float a_end = fin[2 * tl];
    const float a_last = tl > 0 ? fin[2 * tl - 1] : kNegInf;
    const float m = fmaxf(a_end, a_last);
    nll[b] = -(m + log1pf(expf(-fabsf(a_end - a_last))));
  }
}

template <int K>
cudaError_t launch_alpha_tagged(const float* log_probs, const int* targets,
                                const int* input_lengths, const int* target_lengths,
                                float* alphas, float* nll, int B, int T, int C, int U, int blank,
                                int W, cudaStream_t st) {
  const size_t smem = (size_t)8 * W * (2 * kTagRing + 1) + (size_t)4 * 32 * K * W;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ctc_alpha_tagged_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  ctc_alpha_tagged_kernel<K><<<B, 32 * W, smem, st>>>(log_probs, targets, input_lengths,
                                                      target_lengths, alphas, nll, B, T, C, U,
                                                      blank);
  return cudaGetLastError();
}

"""
K6_FAST_MATH = [("  const float s = expf(a - ms) + expf(b - ms) + expf(c - ms);\n",
                 "  const float s = __expf(a - ms) + __expf(b - ms) + __expf(c - ms);\n"),
                ("ms + logf(fmaxf(s, 1e-37f))", "ms + __logf(fmaxf(s, 1e-37f))")]

# source -> [(kernel case in chip_smoke.py, {design: [(cut name, [(old, new), ...])]})]
CUTS = {
    "attention": [("attention_step", {"cluster per batch row (PR 3)": [
        ("launch", [ret("                      int vec) {\n"
                        "  cg::cluster_group cluster = cg::this_cluster();\n")]),
        ("prologue", [ret("  cluster_wait();\n")]),
        ("location features", [ret("    if (l0 == 0) asm volatile(\"cp.async.wait_group 0;\\n\" ::: "
                                   "\"memory\");  // pm and memory\n    __syncthreads();\n")]),
        ("energies and exchange",
         [ret("  cluster.sync();  // every partial has landed; no remote access after this\n")]),
    ]}), ("attention_step_bwd", {"a CTA a span of positions, fixed-order sums (PR 8)": [
        # each cut ends the per-span kernel after a phase; the sums kernel runs whole
        ("launch", [("  // prologue: what the whole CTA holds in one cp.async group, the span's\n",
                     "  return;\n  // prologue: what the whole CTA holds in one cp.async group, "
                     "the span's\n")]),
        ("prologue, s and dw", [ret('  asm volatile("cp.async.wait_group 1;\\n" ::: "memory");  '
                                    "// the held operands have landed\n  __syncthreads();\n")]),
        ("location features", [ret('  asm volatile("cp.async.wait_group 0;\\n" ::: "memory");  '
                                   "// processed memory\n  __syncthreads();\n")]),
        ("tanh, dpre, d_pm, d_v, d_pq, d_loc_lin", [("  if (F == 0) return;\n", "  return;\n")]),
        ("d_loc", [("  // d_loc_w over the span,", "  return;\n  // d_loc_w over the span,")]),
        ("d_loc_w and the halo's products", [("  // the span's d_attn_hist over the window",
                                              "  return;\n  // the span's d_attn_hist over the window")]),
        # not cuts: the whole per-span kernel, the sums kernel returning at
        # once; and the whole kernel with the sums kernel launched plainly
        ("whole kernel, no sums", [after("  __shared__ float4 sums[kThreads];\n", "  return;\n")]),
        ("whole kernel, no programmatic launch",
         [("  attr[0].val.programmaticStreamSerializationAllowed = 1;\n",
           "  attr[0].val.programmaticStreamSerializationAllowed = 0;\n")]),
        # loc_lin read from L2 at every span, as at the widths where it does
        # not fit in shared memory
        ("whole kernel, loc_lin from L2", [K9_DISPATCH]),
        # and with float4 loads of loc_lin's rows (F a multiple of 4 here)
        ("whole kernel, loc_lin from L2 as float4s", [K9_DISPATCH, (
            "#pragma unroll\n        for (int j = 0; j < 4; ++j) lv[j] = f + j < F ? "
            "__ldg(loc_lin + (size_t)a * F + f + j) : 0.0f;\n",
            "        const float4 x = __ldg(reinterpret_cast<const float4*>(loc_lin + (size_t)a * F + f));\n"
            "        lv[0] = x.x, lv[1] = x.y, lv[2] = x.z, lv[3] = x.w;\n")]),
        # d_loc_lin's loop over filters unrolled by 4, which spills at spans
        # 20 and 24 (by 2 in the source, not at all at span 24)
        ("whole kernel, d_loc_lin unrolled by 4",
         [("#pragma unroll (P == 24 ? 1 : 2)\n", "#pragma unroll 4\n")]),
    ], "tiles in one cluster a row (PR 6)": [
        ("launch", [ret("                           int D, int C, int F, int K, int tile) {\n"
                        "  cg::cluster_group cluster = cg::this_cluster();\n")]),
        ("prologue", [ret("  cluster.sync();  // every CTA of the cluster has started: peers' "
                          "shared memory is live\n")]),
        ("dw pass", [ret("  for (int l = tid; l < L; l += blockDim.x) dw[l] = w[l] * (dw[l] - wdw);\n"
                         "  const float* de = dw;\n")]),
        # the tile loop ends after a phase; the kernel after the loop
        ("location features", [after(K9_PM_WAIT, "    continue;\n"), ret(K9_LOOP_END)]),
        ("tanh, dpre and d_pm", [after("      red[i] = dv;\n      red[GA + i] = dq;\n    }\n"
                                       "    __syncthreads();\n", "    continue;\n"),
                                 ret(K9_LOOP_END)]),
        ("d_loc_lin", [after("        *out = acc;\n      }\n", "      continue;\n"), ret(K9_LOOP_END)]),
        ("d_loc exchange", [ret(K9_LOOP_END)]),
        ("d_v, d_pq and d_loc_w", [("  // d_attn_hist a tile of positions at a time",
                                    "  return;\n  // d_attn_hist a tile of positions at a time")]),
    ]})],
    "ctc": [
        ("ctc_alpha", {
            "chain warps, the lattice and a named barrier, register chunks": [
                ("launch", [after(K6_ALPHA_W, "  return;\n")]),
                ("the chain, no alpha stores", [K6_ALPHA_STORE]),
                # not cuts: the chain's log-adds alone (each thread's state
                # from its own, no barrier, no stores), the whole kernel
                # without its barrier a step (its results are wrong), and
                # with the fast, inexact __expf/__logf in the log-add
                ("whole kernel, the log-add alone", [
                    K6_ALPHA_STORE, K6_ALPHA_BAR,
                    ("        const float up1 = prev[-1], up2 = prev[-2];\n",
                     "        const float up1 = a[0], up2 = a[K - 1];\n")]),
                ("whole kernel, no barrier", [K6_ALPHA_BAR]),
                ("whole kernel, __expf and __logf", K6_FAST_MATH),
                # designs not kept, whole kernels in its place (their results
                # are checked too: `err`)
                ("whole kernel, one warp a row, shuffles, a cp.async ring", [
                    (K6_ALPHA_LAUNCH, K6_ONE_WARP + K6_ALPHA_LAUNCH),
                    (K6_ALPHA_SMEM, f"  return launch_alpha_warp({K6_ALPHA_ARGS}, st);\n"
                                    + K6_ALPHA_SMEM)]),
                ("whole kernel, chain warps, a tagged hand-off and no barrier", [
                    (K6_ALPHA_LAUNCH, K6_TAGGED + K6_ALPHA_LAUNCH),
                    (K6_ALPHA_SMEM, f"  return launch_alpha_tagged<K>({K6_ALPHA_ARGS}, W, st);\n"
                                    + K6_ALPHA_SMEM)]),
            ],
            "a CTA a row, the lattice in shared memory": [
                ("launch", [ret(K6_ALPHA_START)]),
                ("the recursion, no alpha stores",
                 [("      alphas[((size_t)t * B + b) * S + s] = nw;\n", "")]),
            ],
        }),
        ("ctc_beta_grad", {
            "one kernel: chain warps, an occupancy ring, class-sum warps": [
                ("launch", [after(K6_BETA_W, "  return;\n")]),
                # the chain's warps return once their first chunks are asked
                # for; the class-sum warps once the rows past the input are
                # zero and their lists are built
                ("prologue: zero rows, class lists, first loads", [
                    after("    if (n_chunks > 1) fetch(e_nxt, a_nxt, 1);\n", "    return;\n"),
                    K6_NO_SUMS]),
                # the chain keeps its betas in the occupancy ring
                ("the chain, no log occupancies or class sums", [
                    K6_EMPTY_WAIT,
                    (K6_OCC, "      for (int j = 0; j < K; ++j) ok[(size_t)(i * K + j) * nl] = beta[j];\n"),
                    K6_NO_SUMS]),
                ("and the log occupancies", [K6_EMPTY_WAIT, K6_NO_SUMS]),
                # the class sums' first pass: the segments' sums, no runs' sums
                ("and the segment sums", [after(K6_SEG_SUMS, "    continue;\n")]),
                ("whole kernel, no barrier", [K6_BETA_BAR]),
                ("whole kernel, a ring of 2 chunks", [("constexpr int kDepth = 4;",
                                                       "constexpr int kDepth = 2;")]),
                ("whole kernel, a thread a (run, step), no segments", K6_RUN_SUMS),
                # with 3 or 5 class-sum warps in place of 8
                ("whole kernel, 3 class-sum warps", [("constexpr int kConsumerWarps = 8;",
                                                      "constexpr int kConsumerWarps = 3;")]),
                ("whole kernel, 5 class-sum warps", [K6_WARPS_5]),
                # segments of up to a warp's 32 states (fewer partials a run)
                ("whole kernel, segments of 32", [K6_SEG_32]),
                ("whole kernel, __expf and __logf", K6_FAST_MATH),
            ],
            "the recursion, an occupancy scratch, a sums kernel": [
                ("launch", [ret(K6_BETA_START), ret(K6_GRAD_START)]),
                ("the recursion, no occupancy stores", [
                    ("      occ[((size_t)t * B + b) * S + s] = v0 ? expf(fminf(cal + beta + nll_b, "
                     "0.0f)) : 0.0f;\n", ""), ret(K6_GRAD_START)]),
                ("and the stores (no ctc_grad_kernel)", [ret(K6_GRAD_START)]),
                ("ctc_grad_kernel alone", [ret(K6_BETA_START)]),
            ],
        }),
    ],
    "features": [("stft_frames", {
        "a CTA a tile of frames, staged in shared memory": [
            ("launch", [ret("  const int tid = threadIdx.x, nt = blockDim.x;\n")]),
            # the row's length and the geometry; the tiles past the row's
            # frames write their zeros
            ("row loads and zero tiles", [(K5_STAGE, "  return;\n" + K5_STAGE)]),
            ("staged samples and the window", [(K5_SIGNAL, "  return;\n" + K5_SIGNAL)]),
            ("the padded signal", [(K5_FRAMES, "  return;\n" + K5_FRAMES)]),
            # not cuts: the window by cospif(2 k / win) in place of the plain
            # version's rounding (within an ulp of it); every tile through the
            # mirror-and-mask path
            ("whole kernel, the window by cospif", [(
                "                ? __fsub_rn(0.5f, __fmul_rn(0.5f, cosf(__fdiv_rn(__fmul_rn(6.2831855f, "
                "(float)k),\n" + " " * 66 + "(float)win))))\n",
                "                ? 0.5f - 0.5f * cospif(2.0f * (float)k / (float)win)\n")]),
            ("whole kernel, no interior path", [("  if (tl.i0 >= 1 && tl.i0 + W <= L) {",
                                                 "  if (false) {")]),
            # a plain launch, in place of the programmatic dependent one
            ("whole kernel, plain launch", [
                ("  attr[0].val.programmaticStreamSerializationAllowed = 1;\n  cudaLaunchConfig_t cfg",
                 "  attr[0].val.programmaticStreamSerializationAllowed = 0;\n  cudaLaunchConfig_t cfg")]),
            # 128 or 512 threads a CTA in place of 256
            ("whole kernel, 128 threads", K5_THREADS(128)),
            ("whole kernel, 512 threads", K5_THREADS(512)),
            # an interior tile's frames straight from the staged samples
            # (the pre-emphasis once a frame that reads a sample), no padded
            # signal and one barrier fewer
            ("whole kernel, interior frames from the staged samples", [(
                "  padded_signal(xs, tl, rw, rw + R, sw, sz, noisy, tl.m, coeff, pad);\n",
                "  if (noisy && tl.i0 >= 1 && tl.i0 + tl.W <= tl.L) {\n"
                "    const float* z = rw + R;\n"
                "    for (int n = tid; n < span; n += nt) {\n"
                "      const float w = hw[n];\n"
                "      for (int g = 0; g < tl.kept; ++g) {\n"
                "        const int j = g * hop + n;\n"
                "        const float cur = __fadd_rn(rw[sw + j + 1], __fmul_rn(tl.m, z[sz + j + 1]));\n"
                "        const float prev = __fadd_rn(rw[sw + j], __fmul_rn(tl.m, z[sz + j]));\n"
                "        out[(size_t)g * span + n] = __fmul_rn(__fsub_rn(cur, __fmul_rn(coeff, prev)), w);\n"
                "      }\n"
                "      for (int g = tl.kept; g < tl.rows; ++g) out[(size_t)g * span + n] = 0.0f;\n"
                "    }\n"
                "    return;\n"
                "  }\n"
                "  padded_signal(xs, tl, rw, rw + R, sw, sz, noisy, tl.m, coeff, pad);\n")]),
        ],
        "a thread an output element (the first design)": [
            ("launch", [ret("  const int n = blockIdx.x * blockDim.x + threadIdx.x;\n")]),
            # each thread's loads of its row's length and the geometry; the
            # frames past the row's end written
            ("row loads and zero frames", [ret("    *out = 0.0f;\n    return;\n  }\n")]),
            # not a cut: the whole kernel with a window of ones, no cosf
            # (its results are wrong)
            ("whole kernel, no window cosf", [(
                "      (k >= 0 && k < win) ? 0.5f - 0.5f * cosf(6.2831855f * (float)k / (float)win) : "
                "0.0f;\n", "      (k >= 0 && k < win) ? 1.0f : 0.0f;\n")]),
        ],
    })],
    "quantize": [("trim_merge", {
        # a cut waits for the bulk copies still in flight before it returns,
        # so that none lands in shared memory the CTA has left
        "bulk copies at entry, ballot scans": [
            ("launch", [ret("  const int n_chunks = tokens != nullptr ? 0 : (T + chunk - 1) / chunk;\n")]),
            ("copies landed", [after(
                "  __syncthreads();  // the copies' ends (and the given tokens) are in\n",
                "  for (int k = 0; k < min(depth, n_chunks); ++k) mbar_wait(bar0 + 8 * k, 0);\n"
                + B6_LATENT_WAIT + "  return;\n")]),
            ("tokens", [after(
                "      pshift[sl] = issue(k + depth);  // its ends are in by the next chunk's barrier\n"
                "    }\n  }\n", B6_LATENT_WAIT + "  return;\n")]),
            ("scans, slots and counts", [after(
                "  __syncthreads();  // every slot's start is in\n", B6_LATENT_WAIT + "  return;\n")]),
        ],
        "a CTA a row, Hillis-Steele scans (the first design)": [
            ("launch", [ret("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, "
                            "nwarps = blockDim.x >> 5;\n")]),
            ("tokens", [("  __syncthreads();\n  for (int t = tid; t < T; t += blockDim.x) acc[t] = (t == 0",
                         "  __syncthreads();\n  return;\n"
                         "  for (int t = tid; t < T; t += blockDim.x) acc[t] = (t == 0")]),
            ("scans, slots and counts", [ret("  if (tid == 0) lengths[b] = n_kept;\n"
                                             "  __syncthreads();\n")]),
        ],
    }), ("trim_merge_bwd", {
        "a lane group a frame, float4, a dependent launch": [
            ("launch", [ret('  asm volatile("griddepcontrol.wait;\\n" ::: "memory");\n'
                            "  const int lane = threadIdx.x & 31, lanes = 1 << lanes_log2;\n")]),
            ("slot and count", [after("  c = __shfl_sync(0xffffffffu, c, leader);\n", "  return;\n")]),
        ],
        "a thread an element, grid-stride (the first design)": [
            ("launch", [after("                                      float* __restrict__ d_latent, "
                              "int T, int D, size_t n) {\n", "  return;\n")]),
        ],
    })],
    "griffin_lim": [("gl_ola_frame", {"tiled overlap-add (PR 3)": [
        ("overlap-add into shared memory",
         [ret("  ola_segment(fb, env, lo, hi - lo + 1, g, [&](int i, float v) { seg[i] = v; });\n"
              "  __syncthreads();\n")]),
    ]})],
    "rnn": [
        ("bilstm_rec_bwd", {
            "W_hh in registers, an mbarrier hand-off (PR 7)": [
                # the cp.async ring and the products formed before the wait
                ("inputs", [after(
                    "    fetch(s + kRing);  // into the slot just read\n",
                    "    if (tid < RU) dg_s[tid] = ca + cb + cc + cd + ce + f + gy;  // kept live\n"
                    "    continue;\n")]),
                ("phase A", [
                    (WAIT, ""),
                    (REARM, ""),
                    after("      for (int q = 0; q < 4; ++q) dgs[q * U] = dg[q];\n    }\n",
                          "    continue;\n")]),
                # the block barrier, the lanes' chains and the shuffle tree; every
                # lane stores its sums into the CTA's own slots
                ("partial sums", [
                    (WAIT, ""),
                    (REARM, ""),
                    ("            mbar_arrive(bar0 + 8 * buf);\n", ""),
                    ("            st_async<NV>(map_rank(smem_addr(dst), owner), acc, "
                     "map_rank(bar0 + 8 * buf, owner));\n",
                     "            dst[0] = acc[0] + acc[NV - 1];\n")]),
                # not a cut: the whole kernel with only the unit lanes waiting,
                # inside phase A's branch (it hangs at one row and 8 or 12
                # units a CTA; timed here at 2 rows and 32 units)
                ("whole kernel, unit lanes wait", [
                    (WAIT, ""),
                    ("        const int buf = (s - 1) & 1;\n        const float* sl",
                     "        const int buf = (s - 1) & 1;\n"
                     "        mbar_wait(bar0 + 8 * buf, ((s - 1) >> 1) & 1);\n        const float* sl")]),
            ],
            "cluster barrier a step (PR 4)": [
                # phase A alone: the gate gradients from the slots as they are
                ("inputs and phase A", [after(
                    "      for (int q = 0; q < 4; ++q) dg_s[r * U4 + q * U + u] = active ? dg[q] : 0.0f;\n"
                    "    }\n", "    cur = nxt;\n    continue;\n")]),
                # the partial sums stored into the CTA's own slots, a block barrier a step
                ("partial sums, no exchange", [
                    ("*cluster.map_shared_rank(dst + (size_t)rr * U, owner) = acc[rr];",
                     "dst[(size_t)rr * U] = acc[rr];"),
                    ("    cluster.sync();\n    cur = nxt;\n", "    __syncthreads();\n    cur = nxt;\n")]),
            ],
        }),
        ("bigru_rec_bwd", {
            "16-lane groups of 4 units (PR 7)": [
                ("dh2 and the products", [after(
                    "    if (active && role < 3) vs[role * KP + k] = cur.cf * dh2;\n",
                    "    cur = nx1;\n    nx1 = nx2;\n    continue;\n")]),
                ("and the hand-off", [after(
                    "    __syncthreads();  // vs is double-buffered: one barrier a step is race-free\n",
                    "    cur = nx1;\n    nx1 = nx2;\n    continue;\n")]),
                ("and the FMAs", [(
                    "    // reduce-scatter over lane offsets 8 and 4, then a butterfly over 2 and 1\n",
                    "    dh_rec = acc[0] + acc[1] + acc[2] + acc[3];\n"
                    "    cur = nx1;\n    nx1 = nx2;\n    continue;\n")]),
                # not cuts: the whole kernel with an mbarrier that each warp
                # arrives on in place of the barrier, and with its step loop
                # not unrolled
                ("whole kernel, mbarrier hand-off", [
                    after("  const int k4 = 4 * (threadIdx.x / kGruLanes);  // the group's first unit\n",
                          "  __shared__ unsigned long long bar;\n"
                          "  const unsigned bar_a = (unsigned)__cvta_generic_to_shared(&bar);\n"
                          "  if (threadIdx.x == 0) mbar_init(bar_a, blockDim.x / 32);\n"),
                    ("    __syncthreads();  // vs is double-buffered: one barrier a step is race-free\n",
                     "    __syncwarp();\n    if ((threadIdx.x & 31) == 0) mbar_arrive(bar_a);\n"
                     "    mbar_wait(bar_a, s & 1);\n")]),
                ("whole kernel, not unrolled", [("#pragma unroll 2\n  for (int s = 0; s < T; ++s) {",
                                                 "  for (int s = 0; s < T; ++s) {")]),
            ],
            "one leader lane a unit (PR 5)": [
                ("dh2 and the products", [(
                    "    __syncthreads();  // dhp is double-buffered: one barrier a step is race-free\n",
                    "    cur = nxt;\n    continue;\n")]),
                ("and the block barrier", [after(
                    "    __syncthreads();  // dhp is double-buffered: one barrier a step is race-free\n",
                    "    cur = nxt;\n    continue;\n")]),
            ],
        }),
    ],
}


def ctc_ptxas(log):
    """{"kernel<K>": [registers, spill bytes]} of K6's kernels (and the
    variants'), from nvcc's ``-Xptxas -v`` output."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(ctc_[a-z_]*?_kernel)(?:ILi(\d+)E)?", line)
            name = (m[1] + (f"<{m[2]}>" if m[2] else "")) if m else None
        elif name and "spill stores" in line:
            out.setdefault(name, [None, None])[1] = int(re.search(r"(\d+) bytes spill stores", line)[1])
        elif name and "Used" in line:
            out.setdefault(name, [None, None])[0] = int(re.search(r"Used (\d+) registers", line)[1])
    return out


def pick_design(text, src, name, designs):
    """The (design, cuts) of ``designs`` whose every edit finds its marker
    once in ``text``."""
    for design, cuts in designs.items():
        if all(text.count(old) == 1 for _, edits in cuts for old, _ in edits):
            return design, cuts
    raise SystemExit(f"chip_ablate: no cut list of {name} matches csrc/{src}.cu "
                     f"(designs: {list(designs)})")


# (B, L) of every K9 call in the train steps: the paired step (8, 32), the
# text-first step (16, 32), the speech-first step (16, 133), the 15.28 s
# speech-first step (2, 679; timed at 700) and the longest K3 takes (2, 1187)
K9_SHAPES = ((8, 32), (16, 32), (16, 133), (2, 700), (2, 1187))


def k9_calls(k9, dev):
    """{"B=.. L=..": one K9 call} at `K9_SHAPES` and flagship widths, from
    seeded inputs and K3's forward on them; works with a tree whose
    `attention_step_bwd` does not take the forward's context."""
    import inspect

    A, D, C, F_, K = 256, 512, 2, 32, 31
    g = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    lw, ll, v = randn(F_, C, K, scale=0.15), randn(A, F_, scale=0.15), randn(A, scale=0.05)
    takes_context = "context" in inspect.signature(k9.attention_step_bwd).parameters
    calls = {}
    for B_, L in K9_SHAPES:
        pq, pm, mem = randn(B_, A), randn(B_, L, A, scale=0.5), randn(B_, L, D)
        w = torch.softmax(randn(B_, L), -1)
        hist = torch.stack([w, w + torch.softmax(randn(B_, L), -1)], 1).contiguous()
        context, weights = k9.attention_step(pq, pm, mem, hist, lw, ll, v)
        args = (pq, pm, mem, hist, lw, ll, v, weights) + ((context,) if takes_context else ()) \
            + (randn(B_, D), randn(B_, L))
        calls[f"B={B_} L={L}"] = lambda a=args: k9.attention_step_bwd(*a)
    return calls


# (B, T, C, S) of K6: the ASR, paired and speech-first steps (8, 133), the
# text-first step's unpaired CTC (8, 96), and chip_smoke.py's longest and
# widest checks (T=700; U=511, S=1,023)
K6_SHAPES = ((8, 133, 43, 65), (8, 96, 43, 65), (8, 700, 43, 65), (2, 600, 43, 1023))


def k6_calls(k6, dev):
    """{name: {"B=.. T=.. C=.. S=..": (kernel call, plain call)}} of K6's
    two wrappers at `K6_SHAPES`, from seeded inputs as `chip_smoke.py` makes
    them (log-softmax rows, targets in 3..42, target lengths from U down to
    two thirds of U, full input lengths; ctc_beta_grad from the plain
    alphas, g as the 'mean' reduction's); works with either design's tree."""
    alpha, beta = {}, {}
    for B_, T, C, S in K6_SHAPES:
        U = (S - 1) // 2
        g = torch.Generator(device=dev).manual_seed(5)
        lp = torch.log(torch.softmax(torch.randn(B_, T, C, generator=g, device=dev) * 2.0, -1)
                       + 1e-10)
        tl = torch.tensor([U - (5 * b) % (U // 3 + 1) for b in range(B_)], dtype=torch.int32)
        tg = torch.randint(3, C, (B_, U), generator=torch.Generator().manual_seed(6),
                           dtype=torch.int32)
        tg[torch.arange(U)[None, :] >= tl[:, None]] = 0
        a = (lp, tg.to(dev), torch.full((B_,), T, dtype=torch.int32, device=dev), tl.to(dev))
        alphas, nll = k6.ctc_alpha_plain(*a)
        b_ = a + (alphas, nll, 1.0 / (B_ * torch.clamp(a[3], min=1).to(torch.float32)))
        key = f"B={B_} T={T} C={C} S={S}"
        alpha[key] = (lambda a=a: k6.ctc_alpha(*a), lambda a=a: k6.ctc_alpha_plain(*a))
        beta[key] = (lambda b_=b_: k6.ctc_beta_grad(*b_), lambda b_=b_: k6.ctc_beta_grad_plain(*b_))
    return {"ctc_alpha": alpha, "ctc_beta_grad": beta}


# (B, S, path) of K5: the flagship step's augmented and clean framing (B=8 x
# 3.0 s) and the 15.28 s utterance's, the longest of the corpus
K5_SHAPES = ((8, 66150, "augmented"), (8, 66150, "clean"), (1, 336924, "augmented"),
             (1, 336924, "clean"))


def k5_calls(k5, dev, chip_smoke, tile=None):
    """{"B=.. T=.. span=..": (kernel call, plain call)} of `stft_frames` at
    `K5_SHAPES` and the flagship audio config: the augmented path at stretch
    rate 1.0 with noise mixed in, the clean path at the static hop; works
    with a tree whose wrapper does not take ``max_hop``. ``tile``: frames a
    CTA in place of the plan's."""
    import inspect

    from semi_tts_tpu_torch.ops.features import AudioFeaturizer
    from semi_tts_tpu_torch.ops.stft import window_support

    audio = chip_smoke.audio_config()
    feat = AudioFeaturizer(audio, dev)
    takes_max_hop = "max_hop" in inspect.signature(k5.stft_frames).parameters
    # the hop at the highest stretch rate, as `AudioConfig.max_stretch_hop`
    max_hop = int(audio.frame_shift_ms / 1000 * int(audio.sample_rate
                                                      * max(audio.time_stretch_range)))
    g = torch.Generator(device=dev).manual_seed(4)
    calls = {}
    for B_, S, path in K5_SHAPES:
        waves = torch.from_numpy(chip_smoke.numpy_waves([S] * B_, S, seed=5)).to(dev)
        lengths = torch.full((B_,), S, dtype=torch.int32, device=dev)
        if path == "augmented":
            kw = dict(n_fft=audio.n_fft, support=window_support(audio.n_fft, audio.max_stretch_win),
                      num_frames=1 + S // audio.min_stretch_hop, clamp=True,
                      coeff=audio.preemphasis_coeff, noise=torch.randn(B_, S, generator=g, device=dev),
                      mix=torch.rand(B_, generator=g, device=dev) * 0.3)
            geom, hop = feat.stretch_geometry(1.0, dev), max_hop
        else:
            kw = dict(n_fft=audio.n_fft, support=window_support(audio.n_fft, audio.win_length),
                      num_frames=1 + S // audio.hop_length, clamp=False,
                      coeff=audio.preemphasis_coeff)
            geom, hop = feat._clean_geom, audio.hop_length
        mine = dict(kw, max_hop=hop) if takes_max_hop else kw
        if tile is not None:
            mine["tile"] = tile
        key = f"{path} B={B_} T={kw['num_frames']} span={kw['support'][1]}"
        calls[key] = (lambda a=(waves, lengths, geom), k=mine: k5.stft_frames(*a, **k),
                      lambda a=(waves, lengths, geom), k=kw: k5.stft_frames_plain(*a, **k))
    return calls


# (B, T) of B6: the flagship speech-first step and its 15.28 s utterance
B6_SHAPES = ((8, 133), (1, 680))


def b6_calls(b6, dev, chip_smoke):
    """{"B=.. T=..": (kernel call, plain call)} of `trim_merge` at
    `B6_SHAPES` (C=43, D=64, max_frames_per_phn 3), from `chip_smoke.py`'s
    inputs."""
    g = torch.Generator(device=dev).manual_seed(6)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    calls = {}
    for B_, T in B6_SHAPES:
        p, lat = chip_smoke._trim_merge_inputs(randn, dev, B_, T)
        calls[f"B={B_} T={T}"] = (lambda p=p, lat=lat: b6.trim_merge(p, lat, 3),
                                  lambda p=p, lat=lat: b6.trim_merge_plain(p, lat, 3))
    return calls


# (B, T) of B6's backward: the flagship speech-first step's unpaired rows,
# both batches' rows, and the 15.28 s utterance's
B6_BWD_SHAPES = ((8, 133), (16, 133), (1, 680))


def b6_bwd_calls(b6, dev, chip_smoke):
    """{"B=.. T=..": (kernel call, plain call)} of `trim_merge_bwd` at
    `B6_BWD_SHAPES` (D=64), from the slots and counts of the forward's plain
    version on `chip_smoke.py`'s inputs."""
    g = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    calls = {}
    for B_, T in B6_BWD_SHAPES:
        p, lat = chip_smoke._trim_merge_inputs(randn, dev, B_, T)
        _, _, slot, count = b6.trim_merge_plain(p, lat, 3)
        a = (randn(*lat.shape), slot, count)
        calls[f"B={B_} T={T}"] = (lambda a=a: b6.trim_merge_bwd(*a),
                                  lambda a=a: b6.trim_merge_bwd_plain(*a))
    return calls


# frames a CTA that `stft_frames` is timed at beside its plan's
K5_TILES = (1, 2, 3, 4, 5, 6, 7, 8)


def k9_span_times(k9, calls, chip_smoke):
    """K9 at each of ``calls``' shapes with every span of `SPANS` in place of
    the plan's: {span: {shape: ms}}."""
    out = {}
    for P in k9.SPANS:
        with chip_smoke.k9_span(k9, P):
            out[P] = {n: chip_smoke.device_ms(f, 50) for n, f in calls.items()}
    return out


def enter_tree(tree):
    """Import `chip_smoke` and the package from the checkout at ``tree``."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    return tree


def main(src_tree=None, only=None):
    """Time the cuts of every source in `CUTS`, or of the sources in ``only``."""
    if src_tree is not None:
        src_tree = enter_tree(src_tree)
    import chip_smoke
    from semi_tts_tpu_torch import kernels, use_fp32
    from semi_tts_tpu_torch.kernels import attention as k9, build, ctc as k6
    from semi_tts_tpu_torch.kernels import features as k5, quantize as b6

    chip_smoke.phase_device()
    use_fp32()
    kernels.build_all()
    csrc = build.CSRC
    out_dir = build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, plans = {}, []
    for src, kernel_cuts in CUTS.items():
        if only and src not in only:
            continue
        text = open(os.path.join(csrc, f"{src}.cu")).read()
        copies = {f"{src}_whole": text}
        for name, designs in kernel_cuts:
            design, cuts = pick_design(text, src, name, designs)
            names = []
            for i, (cut, edits) in enumerate(cuts):
                cut_text = text
                for old, new in edits:
                    cut_text = cut_text.replace(old, new)
                copies[f"{src}_{name}_{i}"] = cut_text
                names.append((cut, f"{src}_{name}_{i}"))
            plans.append((src, name, design, names))
        for stem, cut_text in copies.items():
            cu = out_dir / f"{stem}.cu"
            cu.write_text(cut_text)
            procs[stem] = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # K9's whole-kernel copies, whose registers and spills by span are reported
    k9_copies = {stem: cut for _, name, _, names in plans if name == "attention_step_bwd"
                 for cut, stem in names if cut.startswith("whole")}
    k9_copies["attention_whole"] = "whole"
    # and K6's whole copies
    ctc_copies = {stem: cut for src, _, _, names in plans if src == "ctc"
                  for cut, stem in names if cut.startswith("whole")}
    ctc_copies["ctc_whole"] = "whole"
    ptxas = {}
    for stem, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"chip_ablate: nvcc failed for {stem}:\n{log}")
        if stem in k9_copies:
            ptxas[k9_copies[stem]] = {k: [v.get("registers"), v.get("spill_bytes")]
                                      for k, v in chip_smoke.ptxas_report(log).items()
                                      if k.startswith("attention_bwd_kernel<")}
        if stem in ctc_copies:
            ptxas["ctc " + ctc_copies[stem]] = ctc_ptxas(log)
    dev = torch.device("cuda")
    cases = {c["name"]: c for c in chip_smoke.kernel_cases(dev)}
    cases["attention_step_bwd"]["by_shape"] = k9_calls(k9, dev)
    by_shape = dict(k6_calls(k6, dev), stft_frames=k5_calls(k5, dev, chip_smoke),
                    trim_merge=b6_calls(b6, dev, chip_smoke),
                    trim_merge_bwd=b6_bwd_calls(b6, dev, chip_smoke))
    for name, calls in by_shape.items():
        cases[name]["by_shape"] = {n: f for n, (f, _) in calls.items()}
        cases[name]["shape_checks"] = list(calls.values())

    def load(src, stem):
        build._libs[src] = ctypes.CDLL(str(out_dir / f"{stem}.so"))
        build.bind.cache_clear()

    def timed(src, stem, case):
        load(src, stem)
        if "by_shape" in case:
            return {n: chip_smoke.device_ms(f, 50) for n, f in case["by_shape"].items()}
        return chip_smoke.device_ms(case["kernel"], case["iters"])

    def err(src, stem, case):
        """The largest difference from the plain version of a whole-kernel
        copy: at the case's shape, and at K6's every shape."""
        load(src, stem)
        pairs = [(case["kernel"], case["plain"])] + case.get("shape_checks", [])
        return max(chip_smoke.max_err(f(), p()) for f, p in pairs)

    result = {}
    with torch.no_grad():
        if hasattr(k5, "frames_plan") and (not only or "features" in only):
            result["stft_frames by tile"] = {
                G: {n: chip_smoke.device_ms(f, 50)
                    for n, (f, _) in k5_calls(k5, dev, chip_smoke, tile=G).items()}
                for G in K5_TILES}
        if hasattr(k9, "SPANS") and (not only or "attention" in only):
            result["attention_step_bwd by span"] = k9_span_times(
                k9, cases["attention_step_bwd"]["by_shape"], chip_smoke)
        for src, name, design, names in plans:
            case, mine = cases[name], build.load(src)
            times = {"whole": timed(src, f"{src}_whole", case)}
            errs = {"whole": err(src, f"{src}_whole", case)}
            for cut, stem in names:
                times[cut if cut.startswith("whole") else "to " + cut] = timed(src, stem, case)
                if cut.startswith("whole"):
                    errs[cut] = err(src, stem, case)
            times["whole again"] = timed(src, f"{src}_whole", case)
            build._libs[src] = mine
            build.bind.cache_clear()
            result[name] = {"design": design, "shapes": case["shapes"], "steps": case.get("steps"),
                            "ms": times, "max_abs_err": errs}
    print(json.dumps({"ablation": result, "src": str(csrc), "ptxas": ptxas}))


# the kernels whose device time a profiled step picks out: K6 (either
# design's kernel names) in the ASR step, K9 in the others
PICKED = {"asr": ("ctc_alpha", "ctc_beta", "ctc_grad"), "paired": ("attention_bwd",),
          "speech_first": ("attention_bwd", "stft_frames_kernel", "trim_merge_kernel")}


def step_busy(tree, kind):
    """The flagship ``kind`` step ("asr", "paired" or "speech_first") of the
    checkout at ``tree``: six steps, then steps 10 to 12 profiled."""
    import time

    tree = enter_tree(tree)
    import chip_smoke as cs
    import numpy as np
    from semi_tts_tpu_torch import kernels, use_fp32
    from semi_tts_tpu_torch.models import vqvae as V
    from semi_tts_tpu_torch.ops.features import AudioFeaturizer
    from semi_tts_tpu_torch.train.optim import Optimizer
    from semi_tts_tpu_torch.train.steps import StepBuilder, Weights
    from semi_tts_tpu_torch.utils.metrics import read_phn_attr

    cs.phase_device()
    use_fp32()
    kernels.build_all()
    dev = torch.device("cuda")
    config = cs.flagship_config()
    cfg = cs.flagship_vqvae_config(config)
    phn_attr = torch.from_numpy(read_phn_attr(config["model"]["codebook"]["phn_attr_pth"])).to(dev)
    model = V.VQVAE(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    opt = Optimizer(model.parameters(), lr=1e-3, lr_scheduler="decay")
    batch = cs.training_batch(0, dev)
    if kind == "asr":
        from semi_tts_tpu_torch.train.train_asr import make_asr_step

        asr_step = make_asr_step(StepBuilder(cfg, AudioFeaturizer(cs.audio_config(), dev),
                                             phn_attr), opt)
        step, rest = (lambda m, i, _rate, *b: asr_step(m, i, *b)), ()
    elif kind == "paired":
        builder = StepBuilder(cfg, AudioFeaturizer(cs.audio_config(), dev), phn_attr,
                              freq_loss_kwargs=cs.FLAGSHIP_FREQ_LOSS)
        step, rest = builder.make_paired_step(opt), ()
    else:
        builder = StepBuilder(cfg, AudioFeaturizer(cs.audio_config(), dev), phn_attr,
                              weights=Weights(**cs.CYCLE_WEIGHTS),
                              freq_loss_kwargs=cs.FLAGSHIP_FREQ_LOSS)
        step, rest = builder.make_speech_first_step(opt), cs.training_batch(2, dev)
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model, i, 1.0, *batch, *rest)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls[1:]))
    prof = [cs.profiled_step(lambda k=k: step(model, 10 + k, 1.0, *batch, *rest), wall,
                             picked=PICKED[kind]) for k in range(3)]
    print(json.dumps({f"{kind}_busy": {
        "tree": tree, "cudnn_deterministic": torch.backends.cudnn.deterministic, "wall_s": wall,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "walls_s": walls, "busy_s": [p["device_busy_s"] for p in prof],
        "launches": [p["kernel_launches"] for p in prof],
        "picked_ms": [p["picked_ms"] for p in prof]}}))


def kernel_mem(tree):
    """The device memory that `chip_smoke.py`'s phases before serving (the
    kernels line, the ASR shape and featurizer lines) leave allocated, in the
    checkout at ``tree``: after each timed call of the kernels line, after
    each phase, after a garbage collection and after cuBLAS's per-stream
    workspaces are freed."""
    import gc

    tree = enter_tree(tree)
    import chip_smoke as cs
    from semi_tts_tpu_torch import kernels, use_fp32

    cs.phase_device()
    use_fp32()
    kernels.build_all()
    dev = torch.device("cuda")
    mem = torch.cuda.memory_allocated
    timed, device_ms = [], cs.device_ms

    def recorded(fn, *args, **kwargs):
        out = device_ms(fn, *args, **kwargs)
        timed.append(mem())
        return out

    cs.device_ms = recorded
    table = cs.phase_kernels(dev)
    after = {"start": 0, "kernels line": mem()}
    cs.asr_lstm_check(dev)
    after["asr_shape line"] = mem()
    cs.featurizer_line(dev)
    after["featurizer line"] = mem()
    gc.collect()
    after["gc"] = mem()
    torch._C._cuda_clearCublasWorkspaces()
    after["cuBLAS workspaces freed"] = mem()
    # the growth at each timed call of the kernels line, by the kernel timed
    names = [r["name"] for r in table]
    print(json.dumps({"kernel_mem": {"tree": tree, "allocated_after": after,
                                     "kernels": names, "after_each_timed_call": timed}}))


# K7 with only its unit lanes waiting for the partial sums, inside phase
# A's branch (the wait as first written; it hung at one row and 8 or 12
# units a CTA)
K7_UNIT_LANES = [(WAIT, ""),
                 ("        const int buf = (s - 1) & 1;\n        const float* sl",
                  "        const int buf = (s - 1) & 1;\n"
                  "        mbar_wait(bar0 + 8 * buf, ((s - 1) >> 1) & 1);\n        const float* sl")]
# the unit-lane wait with a trace: each thread of K7 stores its step and a
# code into host-mapped memory (`k7_set_trace`) at the step's start (1),
# around the wait (2, 3), before and after the warp and block barriers (4,
# 5, 6), at the end (7) and after the closing cluster barrier (8); a wait
# that times out stores 9 before it traps
K7_TRACE = [
    ("__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {\n",
     "__device__ unsigned long long* g_k7_trace;\n"
     "__device__ __forceinline__ void k7_trace(int s, int code) {\n"
     "  if (g_k7_trace != nullptr) {\n"
     "    volatile unsigned long long* q = g_k7_trace + ((size_t)(blockIdx.y * gridDim.x + "
     "blockIdx.x) * blockDim.x + threadIdx.x);\n"
     "    *q = ((unsigned long long)(unsigned)s << 8) | (unsigned)code;\n"
     "    __threadfence_system();\n  }\n}\n\n"
     "__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {\n"),
    ("if (global_ns() - t0 > 60000000000ull) __trap();",
     "if (global_ns() - t0 > 60000000000ull) {\n      k7_trace(0, 9);\n      __trap();\n    }"),
    ("  for (int s = 0; s < (rank < owners ? T : 0); ++s) {\n",
     "  for (int s = 0; s < (rank < owners ? T : 0); ++s) {\n    k7_trace(s, 1);\n"),
    ("        mbar_wait(bar0 + 8 * buf, ((s - 1) >> 1) & 1);\n",
     "        k7_trace(s, 2);\n        mbar_wait(bar0 + 8 * buf, ((s - 1) >> 1) & 1);\n"
     "        k7_trace(s, 3);\n"),
    ("      __syncwarp();  // every warp meets the block barrier converged\n      __syncthreads();\n",
     "      k7_trace(s, 4);\n      __syncwarp();  // every warp meets the block barrier converged\n"
     "      k7_trace(s, 5);\n      __syncthreads();\n      k7_trace(s, 6);\n"),
    ("  cp_async_wait_all();\n  // no CTA leaves while a peer may still address it\n  cluster.sync();\n",
     "  cp_async_wait_all();\n  k7_trace(T, 7);\n  // no CTA leaves while a peer may still address "
     "it\n  cluster.sync();\n  k7_trace(T, 8);\n"),
    ("}  // namespace\n",
     "}  // namespace\n\nextern \"C\" int k7_set_trace(void* p, void* stream) {\n"
     "  return (int)cudaMemcpyToSymbol(g_k7_trace, &p, sizeof(p));\n}\n")]
# every mbarrier wait's trap, 2 s, made 60 s for a kernel under compute-sanitizer
SLOW_TRAP = ("if (global_ns() - t0 > 2000000000ull) __trap();",
             "if (global_ns() - t0 > 60000000000ull) __trap();")
# kernel -> (source, the kernel's name as compute-sanitizer filters it)
SANITIZED = {"k7": ("rnn", "lstm_bwd"), "k6": ("ctc", "ctc_beta"), "b6": ("quantize", "trim_merge_kernel"),
             "b6_bwd": ("quantize", "trim_merge_bwd_kernel")}
# (kernel, plan, variant) of --sanitize-all: K7 at the plans that hung (one
# row, 8 and 12 units a CTA), with either wait, and at the shipped plans of
# the ASR step (B=8), the cycles (B=16: 4 rows a cluster) and the 15.28 s
# step (T=679, B=2); K6's ctc_beta_grad at the flagship step and at S=1,023;
# B6 at the flagship step and through the p_code ring (T=1,500). Then the
# unit-lane wait where no warp is partly unit lanes (B=8 H=256: 64 unit
# lanes), at 16 units a CTA (H=128), and at T=2 (one hand-off) and T=3
SANITIZE_PLANS = (
    [("k7", f"T=133,B=1,H={H},ndir=2", v) for H in (64, 96) for v in ("", "unit_lanes")]
    + [("k7", "T=133,B=8,H=256,ndir=2", ""), ("k7", "T=133,B=16,H=256,ndir=2", ""),
       ("k7", "T=679,B=2,H=256,ndir=2", ""),
       ("k6", "B=8,T=133,S=65", ""), ("k6", "B=2,T=600,S=1023", ""),
       ("b6", "B=8,T=133", ""), ("b6", "B=2,T=1500", ""), ("b6_bwd", "B=8,T=133", "")]
    + [("k7", p, "unit_lanes") for p in ("T=133,B=8,H=256,ndir=2", "T=133,B=1,H=128,ndir=2",
                                         "T=2,B=1,H=64,ndir=2", "T=3,B=1,H=64,ndir=2")]
    + [("k7", f"T=133,B=1,H={H},ndir={n}", "unit_lanes_trace") for H in (64, 96) for n in (1, 2)])
# compute-sanitizer's answer on a card it cannot instrument
UNSUPPORTED = "Device not supported"


SANITIZE_BUDGET_S = 1500   # --sanitize-all starts no run past this


def sanitize_lib(src, variant):
    """The library of a copy of ``csrc/<src>.cu`` with `SLOW_TRAP` (and the
    variant's edits), built once into the ablation directory."""
    from semi_tts_tpu_torch.kernels import build

    text = open(os.path.join(build.CSRC, f"{src}.cu")).read()
    edits = ([SLOW_TRAP] + (K7_UNIT_LANES if variant.startswith("unit_lanes") else [])
             + (K7_TRACE if variant.endswith("trace") else []))
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"chip_ablate: csrc/{src}.cu has {text.count(old)} of {old!r}")
        text = text.replace(old, new)
    out_dir = build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = out_dir / f"sanitize_{src}_{variant or 'shipped'}"
    so = stem.with_suffix(".so")
    if not so.exists():
        stem.with_suffix(".cu").write_text(text)
        res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                              str(stem.with_suffix(".cu"))], capture_output=True, text=True)
        if res.returncode != 0:
            raise SystemExit(f"chip_ablate: nvcc failed for {stem}:\n{res.stdout}{res.stderr}")
    return so


def sanitize(kernel, plan, variant=""):
    """One launch of ``kernel`` at ``plan`` ("K=v,..."), from its
    `sanitize_lib`; prints its largest difference from the plain version,
    or the error of a failed launch and the seconds it took to come."""
    import time

    import chip_smoke as cs
    from semi_tts_tpu_torch.kernels import build, ctc as k6, quantize as b6, rnn as k7

    src = SANITIZED[kernel][0]
    build._libs[src] = ctypes.CDLL(str(sanitize_lib(src, variant)))
    build.bind.cache_clear()
    kw = {k: int(v) for k, v in (x.split("=") for x in plan.split(","))}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def unif(*shape, a):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * a

    trace = None
    if kernel == "k7":
        a = cs._lstm_bwd_inputs(randn, unif, kw["T"], kw["B"], kw["H"], kw["ndir"])
        run, plain = lambda: k7.bilstm_rec_bwd(*a), lambda: k7.bilstm_rec_bwd_plain(*a)
        info = k7.lstm_bwd_plan(kw["B"], kw["H"], kw["ndir"], k7.max_clusters(kw["H"], "lstm_rec_bwd"))
        if variant.endswith("trace"):
            trace = torch.zeros(info["grid"][0] * info["grid"][1] * info["threads"],
                                dtype=torch.int64).pin_memory()
            build.check(build.bind(src, "k7_set_trace", 1, 0)(trace.data_ptr(), build.stream()),
                        "k7_set_trace")
    elif kernel == "k6":
        a = cs._ctc_beta_args(cs._ctc_shape_inputs(randn, dev, kw["B"], kw["T"], 43, kw["S"]))
        run, plain = lambda: k6.ctc_beta_grad(*a), lambda: k6.ctc_beta_grad_plain(*a)
        info = k6.ctc_plan(kw["B"], kw["T"], kw["S"])
    elif kernel == "b6":
        p, lat = cs._trim_merge_inputs(randn, dev, kw["B"], kw["T"], long_runs=kw["T"] > 680)
        run, plain = lambda: b6.trim_merge(p, lat, 3), lambda: b6.trim_merge_plain(p, lat, 3)
        info = b6.trim_merge_plan(kw["T"], 43, 64)
    else:
        p, lat = cs._trim_merge_inputs(randn, dev, kw["B"], kw["T"])
        _, _, slot, count = b6.trim_merge_plain(p, lat, 3)
        a = (randn(*lat.shape), slot, count)
        run, plain = lambda: b6.trim_merge_bwd(*a), lambda: b6.trim_merge_bwd_plain(*a)
        info = b6.trim_merge_bwd_plan(kw["B"], kw["T"], 64)
    out = {"kernel": kernel, "plan": plan, "variant": variant, "launch_plan": info}
    with torch.no_grad():
        want = plain()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            got = run()
            torch.cuda.synchronize()
        except RuntimeError as e:  # the launch failed: how soon, and with what
            out.update(error=str(e).splitlines()[0], s_to_error=time.perf_counter() - t0)
            if trace is not None:
                out["trace"] = k7_trace_summary(trace.numpy(), info)
            print(json.dumps({"sanitized": out}))
            return 1
        if trace is not None:
            out["trace"] = k7_trace_summary(trace.numpy(), info)
        out.update(s=time.perf_counter() - t0, max_abs_err=cs.max_err(got, want))
    print(json.dumps({"sanitized": out}))


def k7_trace_summary(trace, info):
    """For each CTA of a traced K7 launch: {"(step, code)": threads that
    stored it last}, from `K7_TRACE`'s host-mapped stores."""
    per_cta = trace.reshape(-1, info["threads"])
    out = {}
    for c, row in enumerate(per_cta):
        counts = {}
        for v in row.tolist():
            key = f"{v >> 8},{v & 0xff}"
            counts[key] = counts.get(key, 0) + 1
        out[f"cta {c % info['grid'][0]} dir {c // info['grid'][0]}"] = counts
    return out


def sanitize_all():
    """Every plan of `SANITIZE_PLANS` under synccheck and racecheck, and
    once without a tool; logs under the build directory's ablate/sanitize/."""
    import re
    import signal
    import time

    import chip_smoke as cs
    from semi_tts_tpu_torch.kernels import build

    cs.phase_device()
    tool_bin = os.path.join(os.path.dirname(build._nvcc()), "compute-sanitizer")
    for src, variant in {(SANITIZED[k][0], v) for k, _, v in SANITIZE_PLANS}:
        sanitize_lib(src, variant)
    logs = build.BUILD_DIR / "ablate" / "sanitize"
    logs.mkdir(parents=True, exist_ok=True)
    runs, start, unsupported = [], time.perf_counter(), False
    for kernel, plan, variant in SANITIZE_PLANS:
        for tool in ("none", "synccheck", "racecheck"):
            why = ("over SANITIZE_BUDGET_S" if time.perf_counter() - start > SANITIZE_BUDGET_S
                   else "compute-sanitizer: " + UNSUPPORTED if tool != "none" and unsupported
                   else None)
            if why:
                runs.append({"kernel": kernel, "plan": plan, "variant": variant or "shipped",
                             "tool": tool, "rc": "not run: " + why})
                continue
            cmd = [sys.executable, os.path.abspath(__file__), "--sanitize", kernel, "--plan", plan]
            if variant:
                cmd += ["--variant", variant]
            if tool != "none":
                cmd = [tool_bin, "--tool", tool, "--kernel-name",
                       f"regex={SANITIZED[kernel][1]}"] + cmd
            t0 = time.perf_counter()
            # its own session, so that a timeout stops the sanitizer and the run under it
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True, start_new_session=True)
            try:
                out, _ = proc.communicate(timeout=120 if tool == "none" else 420)
                rc = proc.returncode
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                out, _ = proc.communicate()
                rc = "timeout"
            name = f"{kernel}_{plan.replace(',', '_').replace('=', '')}_{variant or 'shipped'}_{tool}"
            with open(logs / (name + ".log"), "w") as f:
                f.write(out)
            unsupported = unsupported or UNSUPPORTED in out
            summary = re.findall(r"ERROR SUMMARY: .*", out)
            line = [json.loads(l)["sanitized"] for l in out.splitlines() if l.startswith('{"sanitized"')]
            launch = {k: v for k, v in (line[0] if line else {}).items()
                      if k not in ("kernel", "plan", "variant")}
            runs.append({"kernel": kernel, "plan": plan, "variant": variant or "shipped",
                         "tool": tool, "rc": rc, "process_s": round(time.perf_counter() - t0, 1),
                         "summary": summary[-1] if summary else None,
                         "sanitizer": UNSUPPORTED if UNSUPPORTED in out else None, **launch,
                         "tail": None if line else out[-600:]})
            print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"sanitize": runs}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sanitize"]:
        args = sys.argv[1:]
        sys.exit(sanitize(args[1], args[args.index("--plan") + 1],
                          args[args.index("--variant") + 1] if "--variant" in args else ""))
    if sys.argv[1:2] == ["--sanitize-all"]:
        sys.exit(sanitize_all())
    if sys.argv[1:2] == ["--kernel-mem"]:
        sys.exit(kernel_mem(sys.argv[2]))
    if sys.argv[1:2] == ["--asr-busy"]:
        sys.exit(step_busy(sys.argv[2], "asr"))
    if sys.argv[1:2] == ["--paired-busy"]:
        sys.exit(step_busy(sys.argv[2], "paired"))
    if sys.argv[1:2] == ["--speech-first-busy"]:
        sys.exit(step_busy(sys.argv[2], "speech_first"))
    args = sys.argv[1:]
    only = args[args.index("--only") + 1].split(",") if "--only" in args else None
    sys.exit(main(args[args.index("--src") + 1] if "--src" in args else None, only))
