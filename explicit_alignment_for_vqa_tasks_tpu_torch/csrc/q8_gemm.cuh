// The int8 pieces that csrc/int8_encoder.cu and csrc/vit_block_q8.cu share,
// for NVIDIA Hopper (sm_90a): the per-row activation quantization (with an
// optional RMSNorm or LayerNorm in front) and the s8 wgmma GEMM main loop.
//
//   row_quant_kernel<T, NORM>: one block per row of x (K wide, T = bf16 or
//     float). The fp32 row sits in shared memory, normalised in place by
//       kRms    h = (x * rsqrt(mean(x^2) + eps)) * w             (T5)
//       kLayer  h = (((x - m) * (1 / sqrt(var + eps))) * w) + b  (CLIP; m
//               the mean, var the mean of the squared deviations)
//     or left as it is (kNone). Per (row, group):
//       hs = max(amax(|h|), 1e-6) * (1/127)   (the JAX kernels divide by
//            127.0, which XLA compiles into this product)
//       hq = clip(rint(h / hs), -127, 127)    (IEEE division, ties even)
//     The codes (M, K) and scales (M, G) go to device memory.
//   mainloop: a 128 x 128 output tile per block of two warpgroups, each
//     taking 64 rows with wgmma.m64n128k32.s32.s8.s8 (int8 wgmma needs both
//     operands K-major, so the weights come transposed, (N, K)). A 4-slot
//     cp.async ring stages 64-deep k steps of A and B in shared memory as
//     wgmma's no-swizzle core matrices (8 rows x 16 bytes, contiguous),
//     addressed by matrix descriptors. Each k step ends with the wgmma
//     group waited for; at the end of each contraction group the exact
//     int32 accumulators are folded into fp32 registers,
//       acc = sum over g, in order, of (float(P_g) * hs_g) * s_g,
//     P_g the group's exact int32 product. Each kernel that includes this
//     file writes its own epilogue from acc: element 4 j + e of a thread
//     (lane l, gid = l / 4, tig = l % 4, warp w of warpgroup wg) is row
//       fragment_row0(m0) + 8 (e / 2),  fragment_row0 = m0 + 64 wg + 16 w
//       + gid
//     and column n0 + 8 j + 2 tig + e % 2.
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

constexpr int NT = 256;  // threads per block, both kernels
constexpr int NWARPS = NT / 32;
constexpr int BM = 128, BN = 128, BK = 64;  // block tile and k step
constexpr int STAGES = 4;                   // cp.async ring slots
constexpr int KCH = BK / 16;                // 16-byte k chunks of a tile row
constexpr int GEMM_SMEM = STAGES * KCH * (BM + BN) * 16;

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
template <typename T, int NORM>
__global__ void __launch_bounds__(NT)
row_quant_kernel(const T* __restrict__ x, const bf16* __restrict__ w,
                 const bf16* __restrict__ b, int8_t* __restrict__ codes,
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
      h[i] = __fmul_rn(__fmul_rn(h[i], r), __bfloat162float(w[i]));
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
                    __bfloat162float(w[i])),
          __bfloat162float(b[i]));
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

template <typename T, int NORM>
int row_quant(const void* x, const void* w, const void* b, void* codes,
              void* scales, int M, int K, int G, float eps,
              cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(K) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      row_quant_kernel<T, NORM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  row_quant_kernel<T, NORM><<<M, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(b), static_cast<int8_t*>(codes),
      static_cast<float*>(scales), K, G, eps);
  return static_cast<int>(cudaGetLastError());
}

// The GEMM takes K in G groups of whole 64-deep k steps, N as whole 128-wide
// tiles and a row grid within CUDA's limit.
inline bool shape_ok(int M, int K, int N, int G) {
  return M > 0 && K > 0 && N > 0 && G > 0 && K % G == 0 &&
         (K / G) % BK == 0 && N % BN == 0 && (M + BM - 1) / BM <= 65535;
}

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// A wgmma shared-memory matrix descriptor, no swizzle: the operand is
// made of 8-row x 16-byte core matrices, each 128 contiguous bytes; `lbo`
// is the byte step between core matrices along K, `sbo` along M or N.
__device__ inline uint64_t gmma_desc(const void* p, uint32_t lbo,
                                     uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// d (+)= A . B^T for a 64 x 128 x 32 tile of one warpgroup: int8 in, int32
// accumulate (exact); d is overwritten when accumulate is 0
__device__ inline void wgmma_s8_m64n128k32(int (&d)[64], uint64_t desc_a,
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ inline void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ inline void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The first row of this thread's accumulator elements in the tile at m0.
__device__ inline int fragment_row0(int m0) {
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  return m0 + wg * 64 + warp * 16 + (threadIdx.x % 32) / 4;
}

// acc = sum_g (float(A_g . B_g^T) * a_scale_g) * b_scale_g for the 128 x 128
// tile at (m0, n0), in the fragment layout above: a (M, K) int8 codes with
// (M, G) scales, b (N, K) int8 weights with (G, N) scales. Shared memory:
// STAGES ring slots (GEMM_SMEM bytes), each an A and a B tile of BK bytes
// per row kept as [16-byte k chunk][row][16], i.e. wgmma's core matrices
// (8 rows x 16 bytes) contiguous. Warpgroup wg takes rows 64 wg .. 64 wg +
// 63. Rows at or past M are zero-filled and must not be stored.
__device__ __forceinline__ void mainloop(int8_t* smem,
                                         const int8_t* __restrict__ a,
                                         const float* __restrict__ a_scale,
                                         const int8_t* __restrict__ b,
                                         const float* __restrict__ b_scale,
                                         int M, int K, int N, int G, int m0,
                                         int n0, float (&acc)[64]) {
  constexpr int TILE_A = KCH * BM * 16, TILE_B = KCH * BN * 16;
  constexpr int STAGE_BYTES = TILE_A + TILE_B;

  const int wg = threadIdx.x / 128;
  const int tig = threadIdx.x % 4;
  const int steps_per_group = K / G / BK, steps = K / BK;

  // one k step's A and B tiles into ring slot `stage`
  auto load_step = [&](int step, int stage) {
    int8_t* sa = smem + stage * STAGE_BYTES;
    int8_t* sb = sa + TILE_A;
    const int k0 = step * BK;
#pragma unroll
    for (int u = 0; u < BM * KCH / NT; ++u) {
      const int idx = threadIdx.x + u * NT;
      const int r = idx / KCH, c = idx % KCH;
      const bool valid = m0 + r < M;
      const int8_t* src =
          a + static_cast<size_t>(valid ? m0 + r : 0) * K + k0 + c * 16;
      cp_async16(sa + (c * BM + r) * 16, src, valid);
    }
#pragma unroll
    for (int u = 0; u < BN * KCH / NT; ++u) {
      const int idx = threadIdx.x + u * NT;
      const int r = idx / KCH, c = idx % KCH;
      cp_async16(sb + (c * BN + r) * 16,
                 b + static_cast<size_t>(n0 + r) * K + k0 + c * 16, true);
    }
  };

  const int row0 = fragment_row0(m0);
  int d[64];

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_step(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int step = 0; step < steps; ++step) {
    const int g = step / steps_per_group;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    // this thread's copies are visible to the tensor cores' async proxy,
    // then everyone's are
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (step + STAGES - 1 < steps) {
      load_step(step + STAGES - 1, (step + STAGES - 1) % STAGES);
    }
    asm volatile("cp.async.commit_group;\n" ::);

    const int8_t* sa = smem + (step % STAGES) * STAGE_BYTES;
    const int8_t* sb = sa + TILE_A;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      const uint64_t da =
          gmma_desc(sa + (2 * kk * BM + wg * 64) * 16, BM * 16, 128);
      const uint64_t db = gmma_desc(sb + 2 * kk * BN * 16, BN * 16, 128);
      wgmma_s8_m64n128k32(d, da, db,
                          (step % steps_per_group != 0 || kk > 0) ? 1 : 0);
    }
    wgmma_commit_and_wait();

    if ((step + 1) % steps_per_group == 0) {
      // fold group g: acc += (float(P_g) * hs_g) * s_g, groups in order
      const float hs0 =
          row0 < M ? a_scale[static_cast<size_t>(row0) * G + g] : 0.0f;
      const float hs1 =
          row0 + 8 < M ? a_scale[static_cast<size_t>(row0 + 8) * G + g]
                       : 0.0f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 sc = __ldg(reinterpret_cast<const float2*>(
            b_scale + static_cast<size_t>(g) * N + n0 + 8 * j + 2 * tig));
        const float hs[4] = {hs0, hs0, hs1, hs1};
        const float sw[4] = {sc.x, sc.y, sc.x, sc.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float t = __fmul_rn(
              __fmul_rn(static_cast<float>(d[4 * j + e]), hs[e]), sw[e]);
          acc[4 * j + e] = g == 0 ? t : __fadd_rn(acc[4 * j + e], t);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

}  // namespace q8_gemm
