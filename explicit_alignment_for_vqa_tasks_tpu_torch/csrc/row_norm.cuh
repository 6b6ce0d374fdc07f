// The row norms in front of the bf16 GEMMs, for NVIDIA Hopper (sm_90a):
// the LayerNorm of vit_block.cu (through block_stages.cuh) and
// gpt2_block.cu, and the RMSNorm of t5_ffn.cu.
//
// One warp per row (of bf16 x, or of an fp32 residual r1 or x; s and b bf16,
// or fp32 for fp32 parameters) writes h in bf16:
// the row in the warp's registers (16-byte loads of 8 elements a lane, 8
// rows a block of 256 threads), each sum a lane's own elements in order
// then a butterfly of shuffles. In fp32:
//   layer_norm  mean m, then var = mean((x - m)^2), then
//               h = bf16(((x - m) * (1 / sqrt(var + eps))) * s + b)
//   rms_norm    var = mean(x^2), then h = bf16((x * rsqrt(var + eps)) * s)
// It moves the row once in and h once out: a bound by bytes (a block per
// row with block reductions took 0.45 ms for ViT-L's 147,712 x 1024 rows on
// an H100, whose 605 MB take 0.18). Rows of at most MAX_WIDTH elements, a
// multiple of 8. Every multiply and add is written with __fmul_rn /
// __fadd_rn / __fsub_rn so that nvcc cannot contract them into FMAs; the
// LayerNorm's square root and division are correctly rounded, the
// RMSNorm's rsqrt is rsqrtf, as the Pallas kernels' are lax.rsqrt.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace row_norm {

constexpr int VEC = 8;          // elements of a lane's load
constexpr int ROWS = 8;         // rows a block of 256 threads, one a warp
constexpr int MAX_CHUNKS = 16;  // 8-element loads a lane, at most
constexpr int MAX_WIDTH = MAX_CHUNKS * 32 * VEC;  // 4096

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// 8 consecutive elements of a row as floats (16 bytes of bf16, 32 of fp32)
__device__ inline void load8(const __nv_bfloat16* p, float (&v)[VEC]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ inline void load8(const float* p, float (&v)[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The calling warp's row of x (D wide, T = bf16 or float): h = bf16(LN(x)
// * s + b), or with RMS h = bf16(RMSNorm(x) * s) (bias unused); the scale
// and bias of type S (bf16, or float for the RMSNorm of fp32 params). Lane l
// holds the row's 8-element chunks l, l + 32, ... (CHUNKS of them, the last
// ones past D / 8 unused).
template <typename T, typename S, int CHUNKS, bool RMS>
__device__ __forceinline__ void norm_row(
    const T* __restrict__ x, const S* __restrict__ scale,
    const S* __restrict__ bias, __nv_bfloat16* __restrict__ h,
    int M, int D, float eps) {
  const int row = blockIdx.x * ROWS + threadIdx.x / 32;
  if (row >= M) return;
  const int lane = threadIdx.x % 32;
  const int chunks = D / VEC;
  const size_t off = static_cast<size_t>(row) * D;
  const float width = static_cast<float>(D);
  float v[CHUNKS][VEC];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    if (lane + 32 * c < chunks) {
      load8(x + off + VEC * (lane + 32 * c), v[c]);
    }
  }
  float mean = 0.0f;  // LayerNorm only
  if constexpr (!RMS) {
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      if (lane + 32 * c >= chunks) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e) s = __fadd_rn(s, v[c][e]);
    }
    mean = __fdiv_rn(warp_sum(s), width);
  }
  float ss = 0.0f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    if (lane + 32 * c >= chunks) continue;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float d = RMS ? v[c][e] : __fsub_rn(v[c][e], mean);
      ss = __fadd_rn(ss, __fmul_rn(d, d));
    }
  }
  const float var = __fdiv_rn(warp_sum(ss), width);
  const float r = RMS ? rsqrtf(__fadd_rn(var, eps))
                      : __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = VEC * (lane + 32 * c);
    if (col >= D) continue;
    float sc[VEC], bi[VEC];
    load8(scale + col, sc);
    if constexpr (!RMS) load8(bias + col, bi);
    uint4 packed;
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      float y[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = 2 * i + u;
        if constexpr (RMS) {
          y[u] = __fmul_rn(__fmul_rn(v[c][e], r), sc[e]);
        } else {
          y[u] = __fadd_rn(
              __fmul_rn(__fmul_rn(__fsub_rn(v[c][e], mean), r), sc[e]),
              bi[e]);
        }
      }
      out[i] = __floats2bfloat162_rn(y[0], y[1]);
    }
    *reinterpret_cast<uint4*>(h + off + col) = packed;
  }
}

// One warp a row (the kernels' names tell the profiler's split which norm
// ran).
template <typename T, typename S, int CHUNKS>
__global__ void __launch_bounds__(ROWS * 32)
layer_norm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                  const S* __restrict__ bias, __nv_bfloat16* __restrict__ h,
                  int M, int D, float eps) {
  norm_row<T, S, CHUNKS, false>(x, scale, bias, h, M, D, eps);
}

template <typename T, typename S, int CHUNKS>
__global__ void __launch_bounds__(ROWS * 32)
rms_norm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                __nv_bfloat16* __restrict__ h, int M, int D, float eps) {
  norm_row<T, S, CHUNKS, true>(x, scale, nullptr, h, M, D, eps);
}

template <typename T, typename S, int CHUNKS, bool RMS>
int norm_rows(const void* x, const void* scale, const void* bias, void* h,
              int M, int D, float eps, cudaStream_t stream) {
  const int blocks = (M + ROWS - 1) / ROWS;
  const auto* s = static_cast<const S*>(scale);
  auto* out = static_cast<__nv_bfloat16*>(h);
  if constexpr (RMS) {
    rms_norm_kernel<T, S, CHUNKS><<<blocks, ROWS * 32, 0, stream>>>(
        static_cast<const T*>(x), s, out, M, D, eps);
  } else {
    layer_norm_kernel<T, S, CHUNKS><<<blocks, ROWS * 32, 0, stream>>>(
        static_cast<const T*>(x), s, static_cast<const S*>(bias), out, M, D,
        eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// The norm of M rows of D (a multiple of 8, at most MAX_WIDTH) elements, at
// the fewest chunks a lane that hold a row.
template <typename T, typename S, bool RMS>
int norm(const void* x, const void* scale, const void* bias, void* h, int M,
         int D, float eps, cudaStream_t stream) {
  if (M <= 0 || D <= 0 || D % VEC || D > MAX_WIDTH) {
    return cudaErrorInvalidValue;
  }
  const int chunks = (D / VEC + 31) / 32;
  using Launch = int (*)(const void*, const void*, const void*, void*, int,
                         int, float, cudaStream_t);
  const Launch launch =
      chunks <= 1    ? &norm_rows<T, S, 1, RMS>
      : chunks <= 2  ? &norm_rows<T, S, 2, RMS>
      : chunks <= 3  ? &norm_rows<T, S, 3, RMS>
      : chunks <= 4  ? &norm_rows<T, S, 4, RMS>
      : chunks <= 6  ? &norm_rows<T, S, 6, RMS>
      : chunks <= 8  ? &norm_rows<T, S, 8, RMS>
      : chunks <= 12 ? &norm_rows<T, S, 12, RMS>
                     : &norm_rows<T, S, 16, RMS>;
  return launch(x, scale, bias, h, M, D, eps, stream);
}

// h = bf16(LN(x) * scale + bias) over rows of x (T = bf16 or float)
template <typename T, typename S = __nv_bfloat16>
int layer_norm(const void* x, const void* scale, const void* bias, void* h,
               int M, int D, float eps, cudaStream_t stream) {
  return norm<T, S, false>(x, scale, bias, h, M, D, eps, stream);
}

// h = bf16(RMSNorm(x) * scale) over rows of x (T = bf16 or float), the
// scale of type S (bf16 or float)
template <typename T = __nv_bfloat16, typename S = __nv_bfloat16>
int rms_norm(const void* x, const void* scale, void* h, int M, int D,
             float eps, cudaStream_t stream) {
  return norm<T, S, true>(x, scale, nullptr, h, M, D, eps, stream);
}

// The norms take rows of a multiple of 8 elements, at most MAX_WIDTH.
inline bool norm_shape_ok(int D) {
  return D > 0 && D % VEC == 0 && D <= MAX_WIDTH;
}

}  // namespace row_norm
