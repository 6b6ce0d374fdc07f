// The stages that csrc/vit_block.cu and csrc/gpt2_block.cu build their
// pre-LN transformer blocks from, for NVIDIA Hopper (sm_90a):
//
//   layer_norm: one block per row (of bf16 x, or of an fp32 residual r1)
//     writes h = bf16(LN(x) * s + b), its fp32 row in shared memory, both
//     sums block reductions. fp32: mean m, then var = mean((x - m)^2), then
//     ((x - m) * (1 / sqrt(var + eps))) * s + b.
//   gemm: bf16_gemm.cuh's 128 x 128 mma.sync main loop with the epilogue of
//     the stage, in fp32 on the accumulator:
//       kBiasScale      (acc + bias) * scale   blockIdx.z picks the weight,
//                       bias, output and scale, so that q, k and v come from
//                       one launch (three (D, D) weights, or the column
//                       thirds of a fused (D, 3 D) one through `ldb`)
//       kBiasQuickGelu  quickGELU(acc + bias)  z * (1 / (1 + exp(-1.702 z)))
//       kBiasResidual   residual + (acc + bias)
//       kBiasTanhGelu   tanh-gelu(acc + bias)  0.5 z (1 + tanh(0.7978845608
//                       (z + 0.044715 z^3))), in the JAX _tanh_gelu's order
//     Outputs bf16 or fp32 (OutT), residuals bf16 or fp32 (ResT).
//
// Every multiply and add is written with __fmul_rn / __fadd_rn / __fsub_rn
// so that nvcc cannot contract them into FMAs that the plain PyTorch
// versions do not have; the square root and the divisions are correctly
// rounded and the exponentials and tanh are expf and tanhf (the build has
// no --use_fast_math).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "bf16_gemm.cuh"

namespace block_stages {

using namespace bf16_gemm;

__device__ inline float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ inline float to_f32(float v) { return v; }

// ---- layer norm -----------------------------------------------------------

// One block per row of x (D wide, T = bf16 or float): h = bf16(LN(x) * s + b)
template <typename T>
__global__ void __launch_bounds__(NT)
layer_norm_kernel(const T* __restrict__ x, const bf16* __restrict__ scale,
                  const bf16* __restrict__ bias, bf16* __restrict__ h, int D,
                  float eps) {
  extern __shared__ float row[];  // D floats
  __shared__ float red[NWARPS + 1];
  const size_t off = static_cast<size_t>(blockIdx.x) * D;
  const float width = static_cast<float>(D);
  float s = 0.0f;
  for (int i = threadIdx.x; i < D; i += NT) {
    const float v = to_f32(x[off + i]);
    row[i] = v;
    s = __fadd_rn(s, v);
  }
  const float mean = __fdiv_rn(block_sum(s, red), width);
  float ss = 0.0f;
  for (int i = threadIdx.x; i < D; i += NT) {  // this thread's own row[i]
    const float d = __fsub_rn(row[i], mean);
    ss = __fadd_rn(ss, __fmul_rn(d, d));
  }
  const float var = __fdiv_rn(block_sum(ss, red), width);
  const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  for (int i = threadIdx.x; i < D; i += NT) {
    const float y = __fmul_rn(__fsub_rn(row[i], mean), r);
    h[off + i] = __float2bfloat16_rn(
        __fadd_rn(__fmul_rn(y, __bfloat162float(scale[i])),
                  __bfloat162float(bias[i])));
  }
}

template <typename T>
int layer_norm(const void* x, const void* scale, const void* bias, void* h,
               int M, int D, float eps, cudaStream_t stream) {
  layer_norm_kernel<T><<<M, NT, D * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const bf16*>(scale),
      static_cast<const bf16*>(bias), static_cast<bf16*>(h), D, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---- GEMM with the stages' epilogues ----------------------------------------

enum Epilogue : int {
  kBiasScale = 0,
  kBiasQuickGelu = 1,
  kBiasResidual = 2,
  kBiasTanhGelu = 3
};

struct GemmArgs {
  const bf16* a;         // (M, K) row-major
  const bf16* b[3];      // (K, N) row-major with row stride ldb, one per
                         // blockIdx.z
  const bf16* bias[3];   // (N,)
  void* out[3];          // (M, N) of the kernel's OutT
  float scale[3];        // kBiasScale: the factor after the bias
  const void* residual;  // (M, N) of the kernel's ResT, for kBiasResidual
  int M, K, N, ldb;
};

__device__ inline float quick_gelu(float z) {
  // z * sigmoid(1.702 z), the sigmoid as 1 / (1 + exp(-x))
  const float e = expf(-__fmul_rn(1.702f, z));
  return __fmul_rn(z, __fdiv_rn(1.0f, __fadd_rn(1.0f, e)));
}

__device__ inline float tanh_gelu(float z) {
  // 0.5 z (1 + tanh(0.7978845608028654 (z + 0.044715 z z z))), evaluated
  // left to right as the JAX _tanh_gelu writes it
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, z), z), z);
  const float t = tanhf(__fmul_rn(0.7978845608028654f, __fadd_rn(z, cube)));
  return __fmul_rn(__fmul_rn(0.5f, z), __fadd_rn(1.0f, t));
}

__device__ inline float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ inline float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ inline void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ inline void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

template <int EPI, typename OutT, typename ResT>
__global__ void __launch_bounds__(NT)
stage_gemm_kernel(const GemmArgs args) {
  extern __shared__ __align__(128) bf16 smem[];
  const int z = blockIdx.z;
  const bf16* b = z == 0 ? args.b[0] : (z == 1 ? args.b[1] : args.b[2]);
  const bf16* bias =
      z == 0 ? args.bias[0] : (z == 1 ? args.bias[1] : args.bias[2]);
  OutT* out = static_cast<OutT*>(
      z == 0 ? args.out[0] : (z == 1 ? args.out[1] : args.out[2]));
  const float scale =
      z == 0 ? args.scale[0] : (z == 1 ? args.scale[1] : args.scale[2]);

  const int M = args.M, N = args.N;
  const int n0 = blockIdx.x * B_COLS, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int gid = lane >> 2, tig = lane & 3;

  float acc[4][4][4];
  mainloop<1>(smem, args.a, b, nullptr, M, args.K, args.ldb, m0, n0, acc);

  // c0, c1 are row gid, columns 2 tig and 2 tig + 1 of the n8 tile; c2, c3
  // the same columns of row gid + 8
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + warp_m * 64 + mt * 16 + gid + 8 * half;
      if (row >= M) continue;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int col = n0 + warp_n * 32 + s * 8 + 2 * tig;
        const size_t off = static_cast<size_t>(row) * N + col;
        const float2 bv = load2(bias + col);
        float v0 = __fadd_rn(acc[mt][s][2 * half], bv.x);
        float v1 = __fadd_rn(acc[mt][s][2 * half + 1], bv.y);
        if constexpr (EPI == kBiasScale) {
          v0 = __fmul_rn(v0, scale);
          v1 = __fmul_rn(v1, scale);
        } else if constexpr (EPI == kBiasQuickGelu) {
          v0 = quick_gelu(v0);
          v1 = quick_gelu(v1);
        } else if constexpr (EPI == kBiasTanhGelu) {
          v0 = tanh_gelu(v0);
          v1 = tanh_gelu(v1);
        } else {  // kBiasResidual
          const float2 r = load2(static_cast<const ResT*>(args.residual) + off);
          v0 = __fadd_rn(r.x, v0);
          v1 = __fadd_rn(r.y, v1);
        }
        store2(out + off, v0, v1);
      }
    }
  }
}

template <int EPI, typename OutT = bf16, typename ResT = bf16>
int gemm(const GemmArgs& args, int products, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stage_gemm_kernel<EPI, OutT, ResT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(args.N / B_COLS, (args.M + BM - 1) / BM, products);
  stage_gemm_kernel<EPI, OutT, ResT><<<grid, NT, GEMM_SMEM, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// One product a . b + bias into out (bias then scale 1, which is exact,
// when EPI is kBiasScale), with `residual` for kBiasResidual.
inline GemmArgs gemm_args(const void* a, const void* b, const void* bias,
                          void* out, const void* residual, int M, int K,
                          int N) {
  GemmArgs g{};
  g.a = static_cast<const bf16*>(a);
  g.b[0] = static_cast<const bf16*>(b);
  g.bias[0] = static_cast<const bf16*>(bias);
  g.out[0] = out;
  g.scale[0] = 1.0f;
  g.residual = residual;
  g.M = M;
  g.K = K;
  g.N = N;
  g.ldb = N;
  return g;
}

// The three products of q, k and v over the same a, q's times scale: the
// weights w[i] (D, D) with row stride ldb, each (D,) bias at bias[i].
inline GemmArgs qkv_args(const void* a, const void* const (&w)[3],
                         const void* const (&bias)[3], void* q, void* k,
                         void* v, int M, int D, int ldb, float scale) {
  GemmArgs g{};
  g.a = static_cast<const bf16*>(a);
  void* o[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    g.b[i] = static_cast<const bf16*>(w[i]);
    g.bias[i] = static_cast<const bf16*>(bias[i]);
    g.out[i] = o[i];
    g.scale[i] = i == 0 ? scale : 1.0f;
  }
  g.M = M;
  g.K = D;
  g.N = D;
  g.ldb = ldb;
  return g;
}

// The GEMMs take K and N as whole 128-wide tiles, a row grid within
// CUDA's limit, and the norm's fp32 row in 48 KB of shared memory.
inline bool gemm_shape_ok(int M, int D) {
  return M > 0 && D > 0 && D % B_COLS == 0 && D % BK == 0 &&
         (M + BM - 1) / BM <= 65535 &&
         static_cast<size_t>(D) * sizeof(float) <= 48 * 1024;
}

}  // namespace block_stages
