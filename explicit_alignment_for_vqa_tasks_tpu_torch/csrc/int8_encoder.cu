// int8 T5 encoder kernels for NVIDIA Hopper (sm_90a): the bulk-eval mode's
// attention projections and FFN, every product int8 on the tensor cores.
//
// Replaces, in explicit_alignment_for_vqa_tasks_tpu/ops/fused_attention_block.py:
//   fused_t5_ln_qkv_q8       (pallas_call at :1666, body :1614-1631)
//   fused_oproj_residual_q8  (pallas_call at :1715, body :1680-1691)
//   fused_t5_ffn_q8          (pallas_call at :1595, body :1500-1538)
//
// What they compute, in the Pallas kernels' order of rounding (x, the
// residual and the outputs bf16; weights int8 (K, N) with fp32 (G, N)
// per-(contraction group, output column) scales):
//
//   h      = (x * rsqrt(mean(x^2) + eps)) * w        fp32 RMSNorm (not for
//                                                    the out-projection)
//   hs     = max(amax(|h| over the group), 1e-6) * (1/127)  per (row, group);
//            the JAX kernels divide by 127.0, which XLA compiles into this
//            product with the fp32 reciprocal
//   hq     = clip(rint(h / hs), -127, 127)           IEEE division, ties even
//   acc    = sum over g = 0..G-1, in order, of (float(P_g) * hs_g) * s_g
//            where P_g is the group's exact int32 product hq_g . W_g
//   qkv    : q, k, v = bf16(acc_q), bf16(acc_k), bf16(acc_v), one shared hq
//   oproj  : out = bf16(float(residual) + acc)
//   ffn    : hid = gelu_tanh(acc_0) * acc_1  (fp32, never rounded to bf16),
//            requantized per (row, g_hid group), out = bf16(x + acc_o)
//
// Every multiply and add of the fp32 epilogues is written with __fmul_rn /
// __fadd_rn so that nvcc cannot contract them into FMAs: the plain PyTorch
// version rounds after each operation, and so must the kernel. The build has
// no --use_fast_math.
//
// What bounds them on an H100 SXM (1,979 TOP/s int8 dense, 3.35 TB/s): at
// the main path's M = 32 x 557 = 17,824 rows and T0-3B widths (D = inner =
// 2048, F = 5120, 8 groups) the work is 2 M K N operations per product:
// 448.6 G for q/k/v (0.227 ms), 149.5 G for the out-projection (0.076 ms),
// 1,121.4 G for the FFN (0.567 ms), while the bytes each must move (bf16
// activations in and out, int8 weights, fp32 scales) take 0.05-0.09 ms. All
// three are bound by operations.
//
// Design. A wrapper runs two kinds of CUDA kernel:
//   row_quant (q8_gemm.cuh, shared with vit_block_q8.cu): one block per
//     row, the fp32 row (RMS-normalised where the op norms) in shared
//     memory, each group's amax a block reduction, the codes and the row's
//     G scales to device memory.
//   the s8 wgmma GEMM (the weights K-major, (N, K), so the wrapper passes
//     them transposed), the groups folded in order; the epilogue here: bf16
//     store, residual add, gelu to an fp32 hidden, or the gate's product
//     into that hidden. The out-projection runs on q8_gemm_tma.cuh's main
//     loop (TMA, a producer warpgroup, wgmma kept in flight, persistent;
//     128 x 128 tiles with two int32 accumulator sets alternating by
//     group); q/k/v and the FFN still on q8_gemm.cuh's gemm_q8, 128 x 128
//     tiles, one block each.
// q, k and v are one gemm_q8 launch (grid z = 3) over one shared
// quantization. The FFN runs row_quant, gemm (gelu), gemm (times the gate),
// row_quant of the fp32 hidden, gemm (+ residual); the hidden makes one
// round trip through device memory (365 MB at the main shape), which a
// later version can fuse into the up-products' epilogue.
//
// What holds gemm_q8 at a tenth of the int8 peak (three times cuBLASLt's
// time) is not the tensor cores but its main loop (it waits for its
// products after every 64-deep k step, its consumer threads issue the
// copies and meet at a __syncthreads() every step, its no-swizzle staging
// has 4-way bank conflicts, each block pays its own prologue and epilogue)
// and its epilogue, whose loads wait one by one behind the stores before
// them. Measured on an H100 at M = 17,824, D = 2048, 8 groups: the
// out-projection's GEMM took 0.72 ms on gemm_q8, 0.32 ms with the same
// epilogue on q8_gemm_tma.cuh's loop and 0.23 ms with its loads first
// (torch._int_mm: 0.22 ms; PERF.md has the runs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "q8_gemm.cuh"
#include "q8_gemm_tma.cuh"

namespace {

using namespace q8_gemm;

constexpr int MAX_PRODUCTS = 3;

enum Epilogue : int { kBf16 = 0, kResidualBf16 = 1, kGeluF32 = 2, kMulF32 = 3 };

struct GemmArgs {
  const int8_t* a;        // (M, K) activation codes, K contiguous
  const float* a_scale;   // (M, G) per-(row, group) scales
  const int8_t* b[MAX_PRODUCTS];        // (N, K) int8 weights, K contiguous
  const float* b_scale[MAX_PRODUCTS];   // (G, N) fp32 scales
  void* out[MAX_PRODUCTS];              // (M, N) bf16 or fp32
  const bf16* residual;   // (M, N) for kResidualBf16
  int M, K, N, G;
};

__device__ inline float tanh_gelu(float x) {
  // 0.5 * x * (1 + tanh(0.7978845608028654 * (x + 0.044715 * x * x * x)))
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(x, cube));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

// out[z] = epilogue(sum_g (float(A_g . B[z]_g^T) * a_scale_g) * b_scale[z]_g)
// for the 128 x 128 tile (blockIdx.y, blockIdx.x) of product z = blockIdx.z.
template <int EPI>
__global__ void __launch_bounds__(NT)
gemm_q8_kernel(const GemmArgs args) {
  extern __shared__ __align__(128) int8_t smem[];
  const int z = blockIdx.z;
  const int M = args.M, N = args.N;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tig = threadIdx.x % 4;
  const int row0 = fragment_row0(m0);
  float acc[64];
  mainloop(smem, args.a, args.a_scale, args.b[z], args.b_scale[z], M, args.K,
           N, args.G, m0, n0, acc);

  // epilogue: two consecutive columns of rows row0 and row0 + 8 per chunk
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * tig;
      const size_t off = static_cast<size_t>(row) * N + col;
      float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if (EPI == kBf16 || EPI == kResidualBf16) {
        if (EPI == kResidualBf16) {
          const __nv_bfloat162 r =
              *reinterpret_cast<const __nv_bfloat162*>(args.residual + off);
          v0 = __fadd_rn(__low2float(r), v0);
          v1 = __fadd_rn(__high2float(r), v1);
        }
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(args.out[z]) +
                                           off) = __floats2bfloat162_rn(v0, v1);
      } else {
        float2* o =
            reinterpret_cast<float2*>(static_cast<float*>(args.out[z]) + off);
        if (EPI == kGeluF32) {
          *o = make_float2(tanh_gelu(v0), tanh_gelu(v1));
        } else {  // kMulF32: the hidden already holds gelu(a0)
          const float2 h = *o;
          *o = make_float2(__fmul_rn(h.x, v0), __fmul_rn(h.y, v1));
        }
      }
    }
  }
}

// gemm_q8_kernel's bf16 epilogues over q8_gemm_tma.cuh's main loop
// (product 0), in the same order of rounding. Each chunk's residual is read
// before any of its stores: the compiler may not move a load past a store
// that could alias it, and loads between stores, each waiting for device
// memory in turn, took longer than the tile's products.
template <int EPI>
struct TmaEpilogue {
  static_assert(EPI == kBf16 || EPI == kResidualBf16, "bf16 epilogues only");
  using Args = GemmArgs;
  static constexpr int CHUNK = 8;
  template <int TILE_N>
  __device__ static void store(const Args& args,
                               const float (&acc)[TILE_N / 2], int row0,
                               int n0) {
    const int M = args.M, N = args.N;
    const int tig = threadIdx.x % 4;
    bf16* out = static_cast<bf16*>(args.out[0]);
#pragma unroll
    for (int j0 = 0; j0 < TILE_N / 8; j0 += CHUNK) {
      float2 res[2][CHUNK];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
#pragma unroll
        for (int jj = 0; jj < CHUNK; ++jj) {
          const size_t off =
              static_cast<size_t>(row) * N + n0 + 8 * (j0 + jj) + 2 * tig;
          res[half][jj] = EPI == kResidualBf16 && row < M
                              ? __bfloat1622float2(
                                    *reinterpret_cast<const __nv_bfloat162*>(
                                        args.residual + off))
                              : make_float2(0.0f, 0.0f);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        if (row >= M) continue;
#pragma unroll
        for (int jj = 0; jj < CHUNK; ++jj) {
          const int j = j0 + jj;
          const size_t off =
              static_cast<size_t>(row) * N + n0 + 8 * j + 2 * tig;
          float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
          if (EPI == kResidualBf16) {
            v0 = __fadd_rn(res[half][jj].x, v0);
            v1 = __fadd_rn(res[half][jj].y, v1);
          }
          *reinterpret_cast<__nv_bfloat162*>(out + off) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
};

template <int EPI>
int gemm(const GemmArgs& args, int products, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_q8_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      GEMM_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(args.N / BN, (args.M + BM - 1) / BM, products);
  gemm_q8_kernel<EPI><<<grid, NT, GEMM_SMEM, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

GemmArgs gemm_args(const void* a, const void* a_scale, int M, int K, int N,
                   int G) {
  GemmArgs args{};
  args.a = static_cast<const int8_t*>(a);
  args.a_scale = static_cast<const float*>(a_scale);
  args.M = M;
  args.K = K;
  args.N = N;
  args.G = G;
  return args;
}

void set_product(GemmArgs& args, int z, const void* w, const void* s,
                 void* out) {
  args.b[z] = static_cast<const int8_t*>(w);
  args.b_scale[z] = static_cast<const float*>(s);
  args.out[z] = out;
}

}  // namespace

// Each launcher runs on `stream` and returns the first cudaError_t of its
// launches (0 on success). Scratch (codes, scales, the FFN hidden) is the
// caller's. Weights come K-major: wq etc. are (N, K), the transpose of the
// JAX layout's (K, N).

// q, k, v (M, N) bf16 = RMSNorm(x (M, D)) through wq, wk, wv (N, D).
extern "C" int fused_t5_ln_qkv_q8_launch(
    const void* x, const void* lnw, const void* wq, const void* sq,
    const void* wk, const void* sk, const void* wv, const void* sv,
    void* codes, void* row_scales, void* q, void* k, void* v, int M, int D,
    int N, int G, float eps, void* stream) {
  if (!shape_ok(M, D, N, G)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = row_quant<bf16, kRms>(x, lnw, nullptr, codes, row_scales, M,
                                  D, G, eps, s);
  if (rc != 0) return rc;
  GemmArgs args = gemm_args(codes, row_scales, M, D, N, G);
  set_product(args, 0, wq, sq, q);
  set_product(args, 1, wk, sk, k);
  set_product(args, 2, wv, sv, v);
  return gemm<kBf16>(args, 3, s);
}

// out (M, N) bf16 = residual + attn (M, K) through wo (N, K).
extern "C" int fused_oproj_residual_q8_launch(
    const void* residual, const void* attn, const void* wo, const void* so,
    void* codes, void* row_scales, void* out, int M, int K, int N, int G,
    void* stream) {
  if (!shape_ok(M, K, N, G)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = row_quant<bf16, kNone>(attn, nullptr, nullptr, codes, row_scales,
                                  M, K, G, 0.0f, s);
  if (rc != 0) return rc;
  GemmArgs args = gemm_args(codes, row_scales, M, K, N, G);
  set_product(args, 0, wo, so, out);
  args.residual = static_cast<const bf16*>(residual);
  return q8_gemm_tma::gemm<TmaEpilogue<kResidualBf16>>(
      codes, row_scales, wo, so, M, K, N, G, args, s);
}

// out (M, D) bf16 = x + FFN(RMSNorm(x)); w1 and s1 are null for the
// non-gated FFN; w0, w1 are (F, D), wo is (D, F). hidden is fp32 (M, F).
extern "C" int fused_t5_ffn_q8_launch(
    const void* x, const void* lnw, const void* w0, const void* s0,
    const void* w1, const void* s1, const void* wo, const void* so,
    void* codes_in, void* scales_in, void* hidden, void* codes_hid,
    void* scales_hid, void* out, int M, int D, int F, int G_in, int G_hid,
    float eps, void* stream) {
  if (!shape_ok(M, D, F, G_in) || !shape_ok(M, F, D, G_hid)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = row_quant<bf16, kRms>(x, lnw, nullptr, codes_in, scales_in, M, D,
                                 G_in, eps, s);
  if (rc != 0) return rc;
  GemmArgs up = gemm_args(codes_in, scales_in, M, D, F, G_in);
  set_product(up, 0, w0, s0, hidden);
  rc = gemm<kGeluF32>(up, 1, s);
  if (rc != 0) return rc;
  if (w1 != nullptr) {
    set_product(up, 0, w1, s1, hidden);
    rc = gemm<kMulF32>(up, 1, s);
    if (rc != 0) return rc;
  }
  rc = row_quant<float, kNone>(hidden, nullptr, nullptr, codes_hid,
                               scales_hid, M, F, G_hid, 0.0f, s);
  if (rc != 0) return rc;
  GemmArgs down = gemm_args(codes_hid, scales_hid, M, F, D, G_hid);
  set_product(down, 0, wo, so, out);
  down.residual = static_cast<const bf16*>(x);
  return gemm<kResidualBf16>(down, 1, s);
}
