// The stages of csrc/vit_block.cu's kernels that are not on
// bf16_gemm_tma.cuh's loop, for NVIDIA Hopper (sm_90a):
//
//   layer_norm: row_norm.cuh's, one warp per row (of bf16 x, or of an fp32
//     residual r1).
//   residual_gemm: bf16_gemm.cuh's 128 x 128 mma.sync main loop with the
//     epilogue out = bf16(residual + (acc + bias)) in fp32 on the
//     accumulator, attention_core_oproj's out-projection (the bias bf16, or
//     fp32 for fp32 parameters).
//
// Every add is written with __fadd_rn so that nvcc cannot contract it into
// an FMA that the plain PyTorch version does not have (the build has no
// --use_fast_math).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "bf16_gemm.cuh"
#include "forms.cuh"
#include "row_norm.cuh"

namespace block_stages {

using namespace bf16_gemm;
using namespace row_norm;

// ---- GEMM with the residual epilogue ---------------------------------------

template <typename BiasT>
struct GemmArgs {
  const bf16* a;         // (M, K) row-major
  const bf16* b;         // (K, N) row-major
  const BiasT* bias;     // (N,)
  bf16* out;             // (M, N)
  const bf16* residual;  // (M, N)
  int M, K, N;
};

using forms::load2;

template <typename BiasT>
__global__ void __launch_bounds__(NT)
stage_gemm_kernel(const GemmArgs<BiasT> args) {
  extern __shared__ __align__(128) bf16 smem[];
  const int M = args.M, N = args.N;
  const int n0 = blockIdx.x * B_COLS, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int gid = lane >> 2, tig = lane & 3;

  float acc[4][4][4];
  mainloop(smem, args.a, args.b, M, args.K, N, m0, n0, acc);

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
        const float2 bv = load2(args.bias + col);
        const float2 r = load2(args.residual + off);
        *reinterpret_cast<__nv_bfloat162*>(args.out + off) =
            __floats2bfloat162_rn(
                __fadd_rn(r.x, __fadd_rn(acc[mt][s][2 * half], bv.x)),
                __fadd_rn(r.y, __fadd_rn(acc[mt][s][2 * half + 1], bv.y)));
      }
    }
  }
}

// out (M, N) = residual + (a . b + bias), all bf16 but the bias, of BiasT
// (bf16, or fp32). Returns the launch's cudaError_t (0 on success).
template <typename BiasT = bf16>
int residual_gemm(const void* a, const void* b, const void* bias, void* out,
                  const void* residual, int M, int K, int N,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stage_gemm_kernel<BiasT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      GEMM_SMEM);
  if (err != cudaSuccess) return err;
  const GemmArgs<BiasT> args{
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<const BiasT*>(bias), static_cast<bf16*>(out),
      static_cast<const bf16*>(residual), M, K, N};
  const dim3 grid(N / B_COLS, (M + BM - 1) / BM);
  stage_gemm_kernel<BiasT><<<grid, NT, GEMM_SMEM, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// The mma.sync GEMMs take K and N as whole 128-wide tiles and a row grid
// within CUDA's limit.
inline bool gemm_shape_ok(int M, int D) {
  return M > 0 && D > 0 && D % B_COLS == 0 && D % BK == 0 &&
         (M + BM - 1) / BM <= 65535;
}

}  // namespace block_stages
