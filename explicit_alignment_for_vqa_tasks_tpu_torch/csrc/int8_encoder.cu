// int8 T5 encoder kernels for NVIDIA Hopper (sm_90a): the bulk-eval mode's
// attention projections and FFN, every product int8 on the tensor cores.
//
// Replaces, in explicit_alignment_for_vqa_tasks_tpu/ops/fused_attention_block.py:
//   fused_t5_ln_qkv_q8       (pallas_call at :1666, body :1614-1631)
//   fused_oproj_residual_q8  (pallas_call at :1715, body :1680-1691)
//   fused_t5_ffn_q8          (pallas_call at :1595, body :1500-1538)
//
// What they compute, in the Pallas kernels' order of rounding (x, the
// residual and the outputs bf16, or fp32 in the fp32 forms below; weights
// int8 (K, N) with fp32 (G, N) per-(contraction group, output column)
// scales):
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
//   ffn    : hid = gelu_tanh(acc_0) * acc_1  (fp32, never rounded to bf16;
//            gelu_tanh(acc_0) without the gate), requantized per (row,
//            g_hid group), out = bf16(x + acc_o)
//
// The fp32 forms (tpu.compute_dtype=float32 with an int8 opt-in): the JAX
// kernels take x in any dtype and write x.dtype (residual.dtype for the
// out-projection), reading the norm's scale .astype(f32). On fp32 x the
// arithmetic above is the same; only the loads and the stores change:
// row_quant reads the fp32 row (and an fp32 scale: the wrappers widen a bf16
// one, which is exact), q, k, v and the residual sums are stored unrounded
// (kQkvF32, kResidualF32: an fp32 residual in, fp32 out), and the
// out-projection's attn and residual are each bf16 or fp32. The s8 main
// loop is the bf16 forms' own. Each launcher takes the dtypes as flags.
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
//   the s8 GEMM on q8_gemm_tma.cuh's main loop (TMA, a producer warpgroup,
//     wgmma kept in flight, persistent; 128 x 128 tiles with two int32
//     accumulator sets alternating by group, 128 x 256 where G = 1 and the
//     width allows; the weights K-major, (N, K), so the wrapper passes them
//     transposed), the groups folded in order; the epilogue here: bf16
//     stores routed to q, k or v, residual add, or the FFN's fp32 hidden.
// q/k/v run row_quant and ONE product of N = 3 inner over one shared
// quantization: the wrapper stacks the K-major wq^T, wk^T and wv^T into one
// (3 inner, D) weight and their scales into (G, 3 inner), and the epilogue
// writes each column tile into q, k or v (a tile never straddles two: the
// launcher asks that its width divide inner).
// The FFN runs row_quant, ONE up-product for wi_0 and wi_1 together,
// row_quant of the fp32 hidden, and the down-product with the residual
// epilogue. The wrapper interleaves the K-major gate weights by eight rows
// (wi_0^T rows 8c .. 8c + 7, then wi_1^T's same rows: N = 2 F) and their
// (G, 2 F) scales the same way. In the loop's fragment layout a thread's
// chunk j holds columns n0 + 8 j + 2 tig (+1), so chunk 2c of a tile is a0
// and chunk 2c + 1 is a1 of the same hidden columns n0 / 2 + 8 c + 2 tig
// (+1): the epilogue writes hid = gelu(a0) * a1 once (without the gate,
// gelu(acc)). The hidden's scale is the amax of each (row, g_hid group),
// wider than a tile, so the fp32 hidden still makes one round trip through
// device memory (365 MB at the main shape, about 0.11 ms of writes);
// computing the up-products twice instead would add 748 G operations.
//
// With each chunk's loads before its stores, the GEMMs run near
// torch._int_mm on an H100 at M = 17,824, D = 2048, F = 5120, 8 groups:
// the out-projection's 0.23 ms (_int_mm 0.21), the FFN's up-product 1.23
// ms (its two products 1.05) and down-product 0.39 (0.41); PERF.md has the
// runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "activations.cuh"
#include "q8_gemm.cuh"
#include "q8_gemm_tma.cuh"

namespace {

using namespace q8_gemm;

// The epilogues of the products on q8_gemm_tma.cuh (TmaEpilogue).
enum Epilogue : int {
  kResidualBf16 = 0,
  kGeluHidden = 1,
  kGatedGeluHidden = 2,
  kQkvBf16 = 3,
  kQkvF32 = 4,
  kResidualF32 = 5,
};

struct GemmArgs {
  const int8_t* a;        // (M, K) activation codes, K contiguous
  const float* a_scale;   // (M, G) per-(row, group) scales
  const int8_t* b;        // (N, K) int8 weights, K contiguous
  const float* b_scale;   // (G, N) fp32 scales
  void* out[3];           // kQkv*: q, k, v (M, width); else out[0], (M, N)
                          // bf16 or fp32 or the (M, F) fp32 hidden (N = 2 F
                          // when gated)
  const void* residual;   // (M, N) bf16 (kResidualBf16) or fp32
  int M, K, N, G;
  int width;              // kQkvBf16: the columns of each of q, k and v
};

using activations::tanh_gelu;

// The epilogues over q8_gemm_tma.cuh's main loop, in the Pallas kernels'
// order of rounding. Each chunk's residual is read before any of its
// stores: the compiler may not move a load past a store that could alias
// it, and loads between stores, each waiting for device memory in turn,
// took longer than the tile's products.
//   kResidualBf16: out (M, N) bf16 = residual + acc.
//   kGeluHidden: the (M, N) fp32 hidden = gelu(acc).
//   kGatedGeluHidden: the product's N = 2 F columns interleave wi_0 and wi_1
//     by eight; chunk 2c of the tile holds a0 and chunk 2c + 1 a1 of hidden
//     columns n0 / 2 + 8 c + 2 tig (+1), so the (M, F) fp32 hidden =
//     gelu(a0) * a1 is written once.
//   kQkvBf16: the product's N = 3 width columns are q | k | v; the tile's
//     columns lie in one of them, bf16(acc) is written there.
//   kQkvF32, kResidualF32: the same with fp32 outputs (and an fp32
//     residual), nothing rounded.
template <int EPI>
struct TmaEpilogue {
  using Args = GemmArgs;
  template <int TILE_N>
  __device__ static void store(const Args& args,
                               const float (&acc)[TILE_N / 2], int row0,
                               int n0) {
    if constexpr (EPI == kResidualBf16) {
      store_residual<TILE_N, bf16>(args, acc, row0, n0);
    } else if constexpr (EPI == kResidualF32) {
      store_residual<TILE_N, float>(args, acc, row0, n0);
    } else if constexpr (EPI == kQkvBf16) {
      store_qkv<TILE_N, bf16>(args, acc, row0, n0);
    } else if constexpr (EPI == kQkvF32) {
      store_qkv<TILE_N, float>(args, acc, row0, n0);
    } else {
      store_hidden<TILE_N>(args, acc, row0, n0);
    }
  }

  // A pair of adjacent outputs, rounded to bf16 or stored as they are.
  __device__ static void put_pair(bf16* p, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  }
  __device__ static void put_pair(float* p, float v0, float v1) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  }
  __device__ static float2 get_pair(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static float2 get_pair(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }

  template <int TILE_N, typename OutT>
  __device__ static void store_qkv(const Args& args,
                                   const float (&acc)[TILE_N / 2], int row0,
                                   int n0) {
    const int part = n0 / args.width, c0 = n0 - part * args.width;
    const int tig = threadIdx.x % 4;
    OutT* out = static_cast<OutT*>(
        part == 0 ? args.out[0] : (part == 1 ? args.out[1] : args.out[2]));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row >= args.M) continue;
#pragma unroll
      for (int j = 0; j < TILE_N / 8; ++j) {
        const size_t off =
            static_cast<size_t>(row) * args.width + c0 + 8 * j + 2 * tig;
        put_pair(out + off, acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    }
  }

  template <int TILE_N>
  __device__ static void store_hidden(const Args& args,
                                      const float (&acc)[TILE_N / 2],
                                      int row0, int n0) {
    constexpr bool GATED = EPI == kGatedGeluHidden;
    constexpr int STEP = GATED ? 2 : 1;  // chunks a hidden column takes
    const int width = args.N / STEP, c0 = n0 / STEP;
    const int tig = threadIdx.x % 4;
    float* out = static_cast<float*>(args.out[0]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row >= args.M) continue;
#pragma unroll
      for (int j = 0; j < TILE_N / 8; j += STEP) {
        const int e = 4 * j + 2 * half;
        float v0 = tanh_gelu(acc[e]), v1 = tanh_gelu(acc[e + 1]);
        if constexpr (GATED) {  // a1: the next chunk's same element
          v0 = __fmul_rn(v0, acc[e + 4]);
          v1 = __fmul_rn(v1, acc[e + 5]);
        }
        const size_t off = static_cast<size_t>(row) * width + c0 +
                           8 * (j / STEP) + 2 * tig;
        *reinterpret_cast<float2*>(out + off) = make_float2(v0, v1);
      }
    }
  }

  // out (M, N) of T = residual (M, N) of T + acc, the sum in fp32.
  template <int TILE_N, typename T>
  __device__ static void store_residual(const Args& args,
                                        const float (&acc)[TILE_N / 2],
                                        int row0, int n0) {
    constexpr int CHUNK = 8;  // 8-column chunks read before their stores
    const int M = args.M, N = args.N;
    const int tig = threadIdx.x % 4;
    T* out = static_cast<T*>(args.out[0]);
    const T* residual = static_cast<const T*>(args.residual);
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
          res[half][jj] = row < M ? get_pair(residual + off)
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
          put_pair(out + off,
                   __fadd_rn(res[half][jj].x, acc[4 * j + 2 * half]),
                   __fadd_rn(res[half][jj].y, acc[4 * j + 2 * half + 1]));
        }
      }
    }
  }
};

// One product on q8_gemm_tma.cuh's loop with epilogue EPI.
template <int EPI>
int tma_gemm(const GemmArgs& args, cudaStream_t stream) {
  return q8_gemm_tma::gemm<TmaEpilogue<EPI>>(
      args.a, args.a_scale, args.b, args.b_scale, args.M, args.K, args.N,
      args.G, args, stream);
}

GemmArgs gemm_args(const void* a, const void* a_scale, const void* w,
                   const void* s, void* out, int M, int K, int N, int G) {
  GemmArgs args{};
  args.a = static_cast<const int8_t*>(a);
  args.a_scale = static_cast<const float*>(a_scale);
  args.b = static_cast<const int8_t*>(w);
  args.b_scale = static_cast<const float*>(s);
  args.out[0] = out;
  args.M = M;
  args.K = K;
  args.N = N;
  args.G = G;
  return args;
}

}  // namespace

// Each launcher runs on `stream` and returns the first cudaError_t of its
// launches (0 on success). Scratch (codes, scales, the FFN hidden) is the
// caller's. Weights come K-major: wq etc. are (N, K), the transpose of the
// JAX layout's (K, N). x_f32 (attn_f32, residual_f32) selects the fp32
// form: that tensor (and the norm's scale lnw) fp32 instead of bf16, the
// outputs in x's (the residual's) dtype.

// q, k, v (M, inner) = RMSNorm(x (M, D)) through w_qkv (3 inner, D),
// wq^T, wk^T and wv^T stacked, with s_qkv (G, 3 inner) their scales side by
// side.
extern "C" int fused_t5_ln_qkv_q8_launch(
    const void* x, const void* lnw, const void* w_qkv, const void* s_qkv,
    void* codes, void* row_scales, void* q, void* k, void* v, int M, int D,
    int inner, int G, int x_f32, float eps, void* stream) {
  const int N = 3 * inner;
  if (!shape_ok(M, D, N, G) || inner % q8_gemm_tma::tile_width(N, G) != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = x_f32 ? row_quant<float, kRms, float>(x, lnw, nullptr, codes,
                                                 row_scales, M, D, G, eps, s)
                 : row_quant<bf16, kRms>(x, lnw, nullptr, codes, row_scales,
                                         M, D, G, eps, s);
  if (rc != 0) return rc;
  GemmArgs args = gemm_args(codes, row_scales, w_qkv, s_qkv, q, M, D, N, G);
  args.out[1] = k;
  args.out[2] = v;
  args.width = inner;
  return x_f32 ? tma_gemm<kQkvF32>(args, s) : tma_gemm<kQkvBf16>(args, s);
}

// out (M, N) = residual + attn (M, K) through wo (N, K), attn and residual
// each bf16 or fp32, out in the residual's dtype (the JAX kernel writes
// residual.dtype).
extern "C" int fused_oproj_residual_q8_launch(
    const void* residual, const void* attn, const void* wo, const void* so,
    void* codes, void* row_scales, void* out, int M, int K, int N, int G,
    int attn_f32, int residual_f32, void* stream) {
  if (!shape_ok(M, K, N, G)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = attn_f32 ? row_quant<float, kNone>(attn, nullptr, nullptr, codes,
                                              row_scales, M, K, G, 0.0f, s)
                    : row_quant<bf16, kNone>(attn, nullptr, nullptr, codes,
                                             row_scales, M, K, G, 0.0f, s);
  if (rc != 0) return rc;
  GemmArgs args = gemm_args(codes, row_scales, wo, so, out, M, K, N, G);
  args.residual = residual;
  return residual_f32 ? tma_gemm<kResidualF32>(args, s)
                      : tma_gemm<kResidualBf16>(args, s);
}

// out (M, D) = x + FFN(RMSNorm(x)). Gated: w01 (2 F, D) holds wi_0^T and
// wi_1^T interleaved by eight rows, s01 (G_in, 2 F) their scales the same
// way; else w01 (F, D) is wi_0^T, s01 (G_in, F). wo is (D, F). hidden is fp32
// (M, F) in either form.
extern "C" int fused_t5_ffn_q8_launch(
    const void* x, const void* lnw, const void* w01, const void* s01,
    const void* wo, const void* so, void* codes_in, void* scales_in,
    void* hidden, void* codes_hid, void* scales_hid, void* out, int M, int D,
    int F, int gated, int G_in, int G_hid, int x_f32, float eps,
    void* stream) {
  const int n_up = gated ? 2 * F : F;
  if (!shape_ok(M, D, n_up, G_in) || !shape_ok(M, F, D, G_hid)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = x_f32 ? row_quant<float, kRms, float>(x, lnw, nullptr, codes_in,
                                                 scales_in, M, D, G_in, eps, s)
                 : row_quant<bf16, kRms>(x, lnw, nullptr, codes_in, scales_in,
                                         M, D, G_in, eps, s);
  if (rc != 0) return rc;
  GemmArgs up =
      gemm_args(codes_in, scales_in, w01, s01, hidden, M, D, n_up, G_in);
  rc = gated ? tma_gemm<kGatedGeluHidden>(up, s)
             : tma_gemm<kGeluHidden>(up, s);
  if (rc != 0) return rc;
  rc = row_quant<float, kNone>(hidden, nullptr, nullptr, codes_hid,
                               scales_hid, M, F, G_hid, 0.0f, s);
  if (rc != 0) return rc;
  GemmArgs down =
      gemm_args(codes_hid, scales_hid, wo, so, out, M, F, D, G_hid);
  down.residual = x;
  return x_f32 ? tma_gemm<kResidualF32>(down, s)
               : tma_gemm<kResidualBf16>(down, s);
}
