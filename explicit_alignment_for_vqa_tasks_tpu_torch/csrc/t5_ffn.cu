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
// Design. The Pallas kernel keeps all three weight matrices in VMEM (63 MB
// at T0-3B widths); no SM holds that, so here it is a short pipeline of
// three kernels, the products on bf16_gemm_tma.cuh's loop (TMA, a producer
// warpgroup, asynchronous wgmma, persistent, the weights read as MN-major B
// in their JAX layout with no copy, each output tile stored by TMA from
// swizzled shared memory):
//   rms_norm (row_norm.cuh): one warp a row writes h in bf16.
//   up: gated, the paired product, 128 columns of wi_0 and the same 128 of
//     wi_1 a 256-wide tile, so that each thread holds both accumulators of
//     an output element and the epilogue writes bf16(gelu(a0) * a1): the
//     Pallas kernel's one rounding of hid; non-gated, one product with the
//     gelu epilogue (128 x 256 tiles where F % 256 == 0, else 128 x 128).
//   down: one product over wo with the residual epilogue
//     (bf16_gemm_tma.cuh's ResidualEpilogue).
// The bf16 hid makes one round trip through device memory (182 MB at the
// main shape).
//
// The fp32 form (fp32 x, as tpu.compute_dtype=float32 makes the residual
// stream; JAX's kernel takes any x dtype and casts only the weights to
// bf16, :665-676): the RMSNorm reads fp32 rows (and an fp32 scale where the
// params are fp32) and still writes h in bf16, the products are the same
// bf16 ones, and the down product's epilogue adds the fp32 residual and
// stores the fp32 sum as it is (two 64 x 32 fp32 store boxes a chunk). The
// same operations; x and out take 146 MB more of bytes at the main shape.
//
// The partial form (fused_t5_ffn_partial_launch), for a rank of a tensor-
// parallel mesh: wi_0 and wi_1 are its column shard and wo its row shard, so
// the down product is one term of a sum over the model group, and x may be
// added once only, after that sum. Its down product's epilogue stores the
// fp32 accumulators as they are (PartialEpilogue, no residual read); the
// caller all-reduces them in fp32, adds x and rounds once. The norm and the
// up product are those of the whole form.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "activations.cuh"
#include "bf16_gemm_tma.cuh"
#include "row_norm.cuh"

namespace {

using activations::tanh_gelu;
using bf16_gemm_tma::pack_bf16;

// The up product's epilogues (no arguments): hid = bf16(gelu(a0) * a1) from
// the paired product's two accumulators of a column (n8 groups j and j +
// ACC / 8), or hid = bf16(gelu(a0)).
template <bool GATED>
struct GeluEpilogue {
  struct Args {};
  template <int ACC, class Put>
  __device__ static void chunk(const Args&, int, int, int,
                               const float (&acc)[ACC], int j0,
                               const Put& put) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * (j0 + jj) + 2 * half;
        float v0 = tanh_gelu(acc[i]), v1 = tanh_gelu(acc[i + 1]);
        if (GATED) {
          v0 = __fmul_rn(v0, acc[i + ACC / 2]);
          v1 = __fmul_rn(v1, acc[i + ACC / 2 + 1]);
        }
        put(jj, half, pack_bf16(v0, v1));
      }
    }
  }
};

// The partial form's down-product epilogue: out = the fp32 accumulators.
struct PartialEpilogue {
  using Out = float;
  struct Args {};
  template <int ACC, class Put>
  __device__ static void chunk(const Args&, int, int, int,
                               const float (&acc)[ACC], int j0,
                               const Put& put) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * (j0 + jj) + 2 * half;
        put(jj, half, bf16_gemm_tma::pack_out<float>(acc[i], acc[i + 1]));
      }
    }
  }
};

// The launches of the three kernels for x of type T (bf16, or fp32 where
// tpu.compute_dtype=float32 makes the residual stream fp32) and the norm's
// scale of type S; h, the hidden and the weights are bf16 whatever T is, as
// in the Pallas kernel. With RESIDUAL, out (of type T) = x + the down
// product; without, out (fp32) = the down product alone.
template <typename T, typename S, bool RESIDUAL = true>
int ffn(const void* x, const void* lnw, const void* w0, const void* w1,
        const void* wo, void* h, void* hidden, void* out, int M, int D,
        int F, float eps, cudaStream_t s) {
  namespace bt = bf16_gemm_tma;
  if (!row_norm::norm_shape_ok(D) || !bt::shape_ok(M, D, F, 2) ||
      !bt::shape_ok(M, F, D, 1)) {
    return cudaErrorInvalidValue;
  }
  int rc = row_norm::rms_norm<T, S>(x, lnw, h, M, D, eps, s);
  if (rc != 0) return rc;
  if (w1 != nullptr) {
    rc = bt::gemm_paired<GeluEpilogue<true>>(h, w0, w1, hidden, M, D, F, {},
                                             s);
  } else {
    void* const hid[1] = {hidden};
    rc = bt::gemm<GeluEpilogue<false>>(h, &w0, hid, 1, M, D, F, {}, s);
  }
  if (rc != 0) return rc;
  void* const res[1] = {out};
  if constexpr (!RESIDUAL) {
    return bt::gemm<PartialEpilogue>(hidden, &wo, res, 1, M, F, D, {}, s);
  } else {
    // out = T(x + hid . wo): the fp32 sum rounded once to T (fp32: as it is)
    using Residual = bt::ResidualEpilogue<T, false, T>;
    const typename Residual::Args args{nullptr, static_cast<const T*>(x), M,
                                       D};
    return bt::gemm<Residual>(hidden, &wo, res, 1, M, F, D, args, s);
  }
}

}  // namespace

// out (M, D) = x + FFN(RMSNorm(x)) for x (M, D) bf16 (x_f32 0) or fp32
// (x_f32 1), out of x's type, the norm's scale bf16 (lnw_f32 0) or fp32
// (lnw_f32 1, fp32 params); w0, w1 (D, F) and wo (F, D) bf16 in the JAX
// layout; w1 is null for the non-gated FFN. h (M, D) and hidden (M, F) are
// the caller's bf16 scratch. D and F are multiples of 128, D at most
// row_norm::MAX_WIDTH. Runs on `stream`; returns the first cudaError_t of
// its launches (0 on success).
extern "C" int fused_t5_ffn_launch(const void* x, const void* lnw,
                                   const void* w0, const void* w1,
                                   const void* wo, void* h, void* hidden,
                                   void* out, int M, int D, int F, int x_f32,
                                   int lnw_f32, float eps, void* stream) {
  using bf16 = __nv_bfloat16;
  const auto launch = x_f32 != 0
                          ? (lnw_f32 != 0 ? &ffn<float, float>
                                          : &ffn<float, bf16>)
                          : (lnw_f32 != 0 ? &ffn<bf16, float>
                                          : &ffn<bf16, bf16>);
  return launch(x, lnw, w0, w1, wo, h, hidden, out, M, D, F, eps,
                static_cast<cudaStream_t>(stream));
}

// out (M, D) fp32 = FFN(RMSNorm(x)), the down product's fp32 sum with no
// residual: the partial form, for a column shard w0, w1 (D, F) and a row
// shard wo (F, D) of a tensor-parallel rank. Its other arguments as
// fused_t5_ffn_launch's.
extern "C" int fused_t5_ffn_partial_launch(const void* x, const void* lnw,
                                           const void* w0, const void* w1,
                                           const void* wo, void* h,
                                           void* hidden, void* out, int M,
                                           int D, int F, int x_f32,
                                           int lnw_f32, float eps,
                                           void* stream) {
  using bf16 = __nv_bfloat16;
  const auto launch = x_f32 != 0
                          ? (lnw_f32 != 0 ? &ffn<float, float, false>
                                          : &ffn<float, bf16, false>)
                          : (lnw_f32 != 0 ? &ffn<bf16, float, false>
                                          : &ffn<bf16, bf16, false>);
  return launch(x, lnw, w0, w1, wo, h, hidden, out, M, D, F, eps,
                static_cast<cudaStream_t>(stream));
}
