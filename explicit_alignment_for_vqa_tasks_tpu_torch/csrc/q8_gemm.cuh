// The int8 pieces that csrc/int8_encoder.cu and csrc/vit_block_q8.cu share
// beside the s8 GEMM loop of csrc/q8_gemm_tma.cuh, for NVIDIA Hopper
// (sm_90a): the per-row activation quantization (with an optional RMSNorm
// or LayerNorm in front), the shapes the GEMM takes, and the fragment
// layout its epilogues write from.
//
//   row_quant_kernel<T, NORM, W>: one block per row of x (K wide, T = bf16
//     or float), the norm's scale and bias of W (bf16, or fp32 where the
//     caller's parameters are fp32). The fp32 row sits in shared memory,
//     normalised in place by
//       kRms    h = (x * rsqrt(mean(x^2) + eps)) * w             (T5)
//       kLayer  h = (((x - m) * (1 / sqrt(var + eps))) * w) + b  (CLIP; m
//               the mean, var the mean of the squared deviations)
//     or left as it is (kNone). Per (row, group):
//       hs = max(amax(|h|), 1e-6) * (1/127)   (the JAX kernels divide by
//            127.0, which XLA compiles into this product)
//       hq = clip(rint(h / hs), -127, 127)    (IEEE division, ties even)
//     The codes (M, K) and scales (M, G) go to device memory.
//   shape_ok: K in G groups of whole 64-byte k steps, N in whole 128-column
//     tiles.
//   fragment_row0: the GEMM's accumulator fragments. Element 4 j + e of a
//     consumer thread (lane l, gid = l / 4, tig = l % 4, warp w of
//     warpgroup wg, 64 rows a warpgroup) is row
//       fragment_row0(m0) + 8 (e / 2),  fragment_row0 = m0 + 64 wg + 16 w
//       + gid
//     and column n0 + 8 j + 2 tig + e % 2 of the tile at (m0, n0).
//
// Every multiply and add is written with __fmul_rn / __fadd_rn so that nvcc
// cannot contract them into FMAs that the plain PyTorch versions do not
// have; the build has no --use_fast_math.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace q8_gemm {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;  // threads per row_quant block
constexpr int NWARPS = NT / 32;
constexpr int K_STEP = 64;   // bytes of the GEMM's shallowest k step
constexpr int N_TILE = 128;  // columns of its narrowest tile

enum Norm : int { kNone = 0, kRms = 1, kLayer = 2 };

__device__ inline float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ inline float to_f32(float v) { return v; }

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// Block-wide sum or max of one value per thread; every thread gets the
// result. `red` holds NWARPS + 1 floats.
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = MAX ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < NWARPS ? red[lane] : 0.0f;  // |h| >= 0, so 0 is neutral
    t = MAX ? warp_max(t) : warp_sum(t);
    if (lane == 0) red[NWARPS] = t;
  }
  __syncthreads();
  const float r = red[NWARPS];
  __syncthreads();  // red is free for the next reduction
  return r;
}

// One block per row of x (K wide): the optional norm, then per-(row,
// group) symmetric int8 quantization into codes (M, K) and scales (M, G).
// w is the norm's scale, b the LayerNorm's bias (null where unused).
template <typename T, int NORM, typename W = bf16>
__global__ void __launch_bounds__(NT)
row_quant_kernel(const T* __restrict__ x, const W* __restrict__ w,
                 const W* __restrict__ b, int8_t* __restrict__ codes,
                 float* __restrict__ scales, int K, int G, float eps) {
  extern __shared__ float h[];  // the row, K floats
  __shared__ float red[NWARPS + 1];
  const size_t row = blockIdx.x;
  const T* xr = x + row * K;
  const float width = static_cast<float>(K);
  float s = 0.0f;
  for (int i = threadIdx.x; i < K; i += NT) {
    const float v = to_f32(xr[i]);
    h[i] = v;
    if constexpr (NORM == kRms) s = __fadd_rn(s, __fmul_rn(v, v));
    if constexpr (NORM == kLayer) s = __fadd_rn(s, v);
  }
  if constexpr (NORM == kRms) {
    const float var = __fdiv_rn(block_reduce<false>(s, red), width);
    const float r = rsqrtf(__fadd_rn(var, eps));
    for (int i = threadIdx.x; i < K; i += NT) {  // this thread's own h[i]
      h[i] = __fmul_rn(__fmul_rn(h[i], r), to_f32(w[i]));
    }
  }
  if constexpr (NORM == kLayer) {
    const float mean = __fdiv_rn(block_reduce<false>(s, red), width);
    float ss = 0.0f;
    for (int i = threadIdx.x; i < K; i += NT) {  // this thread's own h[i]
      const float d = __fsub_rn(h[i], mean);
      ss = __fadd_rn(ss, __fmul_rn(d, d));
    }
    const float var = __fdiv_rn(block_reduce<false>(ss, red), width);
    const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
    for (int i = threadIdx.x; i < K; i += NT) {
      h[i] = __fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(h[i], mean), r),
                    to_f32(w[i])),
          to_f32(b[i]));
    }
  }
  __syncthreads();
  const int kg = K / G;
  for (int g = 0; g < G; ++g) {
    const float* hg = h + g * kg;
    float amax = 0.0f;
    for (int i = threadIdx.x; i < kg; i += NT) amax = fmaxf(amax, fabsf(hg[i]));
    amax = block_reduce<true>(amax, red);
    const float scale = __fmul_rn(fmaxf(amax, 1e-6f), 1.0f / 127.0f);
    int8_t* cg = codes + row * K + g * kg;
    for (int i = threadIdx.x; i < kg; i += NT) {
      const float q = rintf(__fdiv_rn(hg[i], scale));
      cg[i] = static_cast<int8_t>(fminf(fmaxf(q, -127.0f), 127.0f));
    }
    if (threadIdx.x == 0) scales[row * G + g] = scale;
  }
}

template <typename T, int NORM, typename W = bf16>
int row_quant(const void* x, const void* w, const void* b, void* codes,
              void* scales, int M, int K, int G, float eps,
              cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(K) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      row_quant_kernel<T, NORM, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  row_quant_kernel<T, NORM, W><<<M, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const W*>(b), static_cast<int8_t*>(codes),
      static_cast<float*>(scales), K, G, eps);
  return static_cast<int>(cudaGetLastError());
}

// The s8 GEMM takes K in G groups of whole K_STEP-byte k steps, N in
// whole N_TILE-column tiles, and a tile count that an int holds.
inline bool shape_ok(int M, int K, int N, int G) {
  return M > 0 && K > 0 && N > 0 && G > 0 && K % G == 0 &&
         (K / G) % K_STEP == 0 && N % N_TILE == 0 &&
         (M / 128 + 1LL) * (N / N_TILE) <= 0x7fffffff;
}

// The first row of this consumer thread's accumulator elements in the tile
// at m0.
__device__ inline int fragment_row0(int m0) {
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  return m0 + wg * 64 + warp * 16 + (threadIdx.x % 32) / 4;
}

}  // namespace q8_gemm
