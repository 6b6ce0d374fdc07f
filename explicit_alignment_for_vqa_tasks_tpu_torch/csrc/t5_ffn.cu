// T5 encoder FFN with its norm and residual for NVIDIA Hopper (sm_90a).
//
// Replaces explicit_alignment_for_vqa_tasks_tpu/ops/fused_attention_block.py
// ::fused_t5_ffn (the Pallas kernel, pallas_call at :671, body :596-628; its
// XLA twin _t5_ffn_reference, :1048-1066). It computes, in the Pallas
// kernel's order of rounding (x and the output bf16, weights bf16 (K, N)):
//
//   h   = bf16((x * rsqrt(mean(x^2) + eps)) * w_ln)     fp32 RMSNorm
//   hid = bf16(gelu_tanh(h . wi_0) * (h . wi_1))        both products fp32,
//                                                       never rounded before
//                                                       the one cast of hid
//         (non-gated: hid = bf16(gelu_tanh(h . wi_0)))
//   out = bf16(x + hid . wo)                            fp32 accumulation
//
// Every multiply and add of the fp32 epilogues is written with __fmul_rn /
// __fadd_rn so that nvcc cannot contract them into FMAs that the plain
// PyTorch version does not have; the build has no --use_fast_math.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the
// main path's M = 32 x 557 = 17,824 rows, D = 2048, F = 5120 (gated) it does
// 3 x 2 M D F = 1.121 TFLOP, which is 1.134 ms; the bytes it must move (x
// and the output, 73 MB each, and the 63 MB of weights) take 0.06 ms. It is
// bound by operations; the encoder runs it once per layer.
//
// Design (simple and right before fast). The Pallas kernel keeps all three
// weight matrices in VMEM (63 MB at T0-3B widths); no SM holds that, so
// here it is a short pipeline of three kernels:
//   rms_norm: one block per row writes h in bf16 (its fp32 row in shared
//     memory, the sum of squares a block reduction).
//   gemm (up): one 128 x 128 output tile per block of eight warps on the
//     tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate; the
//     main loop, shared with vit_block.cu, is in bf16_gemm.cuh). The
//     gated form takes 64 columns of wi_0 and the same 64 of wi_1 per block,
//     so each thread holds both accumulators of an output element and the
//     epilogue writes gelu(a0) * a1 as bf16: the Pallas kernel's one
//     rounding of hid.
//   gemm (down): the same kernel over wo with a residual epilogue.
// The bf16 hid makes one round trip through device memory (182 MB at the
// main shape).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "bf16_gemm.cuh"

namespace {

using namespace bf16_gemm;

enum Epilogue : int { kGeluGate = 0, kGelu = 1, kResidual = 2 };

// One block per row of x (D wide): h = bf16((x * rsqrt(mean(x^2) + eps)) * w)
__global__ void __launch_bounds__(NT)
rms_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ lnw,
                bf16* __restrict__ h, int D, float eps) {
  extern __shared__ float row[];  // D floats
  __shared__ float red[NWARPS + 1];
  const size_t off = static_cast<size_t>(blockIdx.x) * D;
  float ss = 0.0f;
  for (int i = threadIdx.x; i < D; i += NT) {
    const float v = __bfloat162float(x[off + i]);
    row[i] = v;
    ss = __fadd_rn(ss, __fmul_rn(v, v));
  }
  const float var = __fdiv_rn(block_sum(ss, red), static_cast<float>(D));
  const float r = rsqrtf(__fadd_rn(var, eps));
  for (int i = threadIdx.x; i < D; i += NT) {  // this thread's own row[i]
    h[off + i] = __float2bfloat16_rn(
        __fmul_rn(__fmul_rn(row[i], r), __bfloat162float(lnw[i])));
  }
}

__device__ inline float tanh_gelu(float x) {
  // 0.5 * x * (1 + tanh(0.7978845608028654 * (x + 0.044715 * x * x * x)))
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(x, cube));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

struct GemmArgs {
  const bf16* a;         // (M, K) row-major
  const bf16* b[2];      // (K, N) row-major, one or two products
  bf16* out;             // (M, N)
  const bf16* residual;  // (M, N) for kResidual
  int M, K, N;
};

// out = epilogue(A . B[0] (, A . B[1])) for the block's BM rows and
// 128 / NPROD columns of each product (bf16_gemm.cuh's fragment layout).
template <int NPROD, int EPI>
__global__ void __launch_bounds__(NT)
gemm_bf16_kernel(const GemmArgs args) {
  extern __shared__ __align__(128) bf16 smem[];
  constexpr int BN_P = B_COLS / NPROD;  // columns per product
  constexpr int SPP = 4 / NPROD;        // n8 slots per product per warp

  const int M = args.M, N = args.N;
  const int n0 = blockIdx.x * BN_P, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int gid = lane >> 2, tig = lane & 3;

  float acc[4][4][4];
  mainloop<NPROD>(smem, args.a, args.b[0], args.b[1], M, args.K, N, m0, n0,
                  acc);

  // epilogue: c0, c1 are row gid, columns 2 tig and 2 tig + 1 of the n8
  // tile; c2, c3 the same columns of row gid + 8
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + warp_m * 64 + mt * 16 + gid + 8 * half;
      if (row >= M) continue;
#pragma unroll
      for (int s = 0; s < SPP; ++s) {
        const int col = n0 + warp_n * (SPP * 8) + s * 8 + 2 * tig;
        const size_t off = static_cast<size_t>(row) * N + col;
        float v0 = acc[mt][s][2 * half], v1 = acc[mt][s][2 * half + 1];
        if constexpr (EPI == kGeluGate) {
          v0 = __fmul_rn(tanh_gelu(v0), acc[mt][s + SPP][2 * half]);
          v1 = __fmul_rn(tanh_gelu(v1), acc[mt][s + SPP][2 * half + 1]);
        } else if constexpr (EPI == kGelu) {
          v0 = tanh_gelu(v0);
          v1 = tanh_gelu(v1);
        } else {  // kResidual
          const __nv_bfloat162 r =
              *reinterpret_cast<const __nv_bfloat162*>(args.residual + off);
          v0 = __fadd_rn(__low2float(r), v0);
          v1 = __fadd_rn(__high2float(r), v1);
        }
        *reinterpret_cast<__nv_bfloat162*>(args.out + off) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int NPROD, int EPI>
int gemm(const GemmArgs& args, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_bf16_kernel<NPROD, EPI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(args.N / (B_COLS / NPROD), (args.M + BM - 1) / BM);
  gemm_bf16_kernel<NPROD, EPI><<<grid, NT, GEMM_SMEM, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (M, D) bf16 = x + FFN(RMSNorm(x)) for x (M, D) bf16; w0, w1 (D, F)
// and wo (F, D) bf16 in the JAX layout; w1 is null for the non-gated FFN.
// h (M, D) and hidden (M, F) are the caller's bf16 scratch. Runs on
// `stream`; returns the first cudaError_t of its launches (0 on success).
extern "C" int fused_t5_ffn_launch(const void* x, const void* lnw,
                                   const void* w0, const void* w1,
                                   const void* wo, void* h, void* hidden,
                                   void* out, int M, int D, int F, float eps,
                                   void* stream) {
  if (M <= 0 || D <= 0 || F <= 0 || D % BK || F % BK || D % B_COLS ||
      F % B_COLS || (M + BM - 1) / BM > 65535 ||
      static_cast<size_t>(D) * sizeof(float) > 48 * 1024) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rms_norm_kernel<<<M, NT, D * sizeof(float), s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(lnw),
      static_cast<bf16*>(h), D, eps);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  GemmArgs up{};
  up.a = static_cast<const bf16*>(h);
  up.b[0] = static_cast<const bf16*>(w0);
  up.b[1] = static_cast<const bf16*>(w1);
  up.out = static_cast<bf16*>(hidden);
  up.M = M;
  up.K = D;
  up.N = F;
  rc = w1 != nullptr ? gemm<2, kGeluGate>(up, s) : gemm<1, kGelu>(up, s);
  if (rc != 0) return rc;

  GemmArgs down{};
  down.a = static_cast<const bf16*>(hidden);
  down.b[0] = static_cast<const bf16*>(wo);
  down.out = static_cast<bf16*>(out);
  down.residual = static_cast<const bf16*>(x);
  down.M = M;
  down.K = F;
  down.N = D;
  return gemm<1, kResidual>(down, s);
}
