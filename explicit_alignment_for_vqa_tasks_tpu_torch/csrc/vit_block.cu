// The CLIP ViT encoder's long-sequence kernels, for NVIDIA Hopper (sm_90a).
//
// Replaces four Pallas kernels of
// explicit_alignment_for_vqa_tasks_tpu/ops/fused_attention_block.py: the
// three programs of models/clip.py's long-sequence split3 branch (:201-235)
//   fused_ln_qkv           pallas_call at :290, body :235-262
//   attention_core_oproj   pallas_call at :366, body :301-342
//   fused_mlp_block        pallas_call at :445, body :379-413
// and the attention of the long split*, fused_attention and int8 branches
//   attention_core         pallas_call at :225, body :161-200
// (the whole blocks are vit_whole_block.cu's fused_vit_block and
// attention_block.cu's fused_attention_block). It computes, in the Pallas
// kernels' order of rounding (x (M, D) with M = B L rows; activations,
// weights and outputs bf16; the fp32 forms below):
//
//   fused_ln_qkv
//     h   = bf16(LN(x))      fp32: mean m, then var = mean((x - m)^2), then
//                            ((x - m) * (1 / sqrt(var + eps))) * s + b
//     q   = bf16(((h . wq) + bq) * scale)   products accumulated in fp32,
//     k   = bf16((h . wk) + bk)             then the bias, then the scale
//     v   = bf16((h . wv) + bv)
//   attention_core: vit_attention_wgmma.cuh's kBf16Sum (kFastExp with
//     fast_exp)
//   attention_core_oproj
//     o   = attention_core(q, k, v)        (kBf16Sum)
//     out = bf16(res + ((o . wo) + bo))
//   fused_mlp_block
//     h   = bf16(LN(x))
//     z   = (h . w_fc) + b_fc
//     hid = bf16(z * (1 / (1 + exp(-(1.702 z)))))   quickGELU
//     out = bf16(x + ((hid . w_proj) + b_proj))
//   the fp32 forms of the split3 kernels and attention_core (x, the
//     residual, q, k, v and the outputs fp32; or bf16 with the LayerNorms'
//     scales and biases and the biases fp32, as param_dtype=float32 gives
//     them): the Pallas kernels read each operand in its own dtype, widen it
//     to fp32 and write x.dtype, the JAX wrappers cast the weights to bf16;
//     so fused_ln_qkv and fused_mlp_block compute as above with x, q, k, v
//     and out unrounded, and
//     attention_core        s = q . k^T in fp32, p = exp(s - max) in fp32
//                           (fast_exp: exp(bf16(s - max))), denom = sum p,
//                           o = (p . v) / denom, fp32 (attention_f32.cuh)
//     attention_core_oproj  that o, unrounded, then
//                           out = res + ((o . wo) + bo) in fp32
//
// Every multiply and add of the fp32 epilogues and norms is written with
// __fmul_rn / __fadd_rn / __fsub_rn so that nvcc cannot contract them into
// FMAs that the plain PyTorch versions do not have; the square root and the
// divisions are correctly rounded and the exponentials are expf (the build
// has no --use_fast_math).
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 67 TFLOP/s fp32 on
// the CUDA cores, 3.35 TB/s), each input read once and each output written
// once. At ViT-L/14@336 with the image encoder's batch of 256 (M = 256 x 577
// = 147,712 rows, D = 1024, 16 heads of 64, F = 4096):
//   fused_ln_qkv          929.3 GFLOP = 0.940 ms; 1.22 GB = 0.36 ms
//   attention_core_oproj  658.9 GFLOP = 0.666 ms; 1.51 GB = 0.45 ms
//                         (this route, q . k^T twice: 833.5 GFLOP = 0.843 ms)
//   attention_core        349.1 GFLOP = 0.353 ms; 1.21 GB = 0.361 ms
//                         (this route: 523.7 GFLOP = 0.530 ms)
//   fused_mlp_block       2,478 GFLOP = 2.506 ms; 0.62 GB = 0.19 ms
// All are bound by operations but attention_core, bound by bytes; the
// encoders run each of their kernels once per layer. The fp32 forms at
// ViT-L, B = 256 (fp32 x, q, k, v and outputs; the attention on the CUDA
// cores at 67 TFLOP/s):
//   fused_ln_qkv          929.3 GFLOP = 0.940 ms; 2.43 GB = 0.73 ms
//   attention_core_oproj  349.1 GFLOP fp32 = 5.21 ms + the out-projection
//                         as 3 x 309.8 GFLOP of bf16 products = 0.94 ms:
//                         6.15 ms; 3.03 GB = 0.90 ms (this route, on whole
//                         64-row and 64-key tiles: 6.41 + 0.94 = 7.35 ms)
//   attention_core        349.1 GFLOP fp32 = 5.21 ms; 2.42 GB = 0.72 ms
//                         (this route: 6.41 ms; the two-pass route, q . k^T
//                         twice: 7.82 ms)
//   fused_mlp_block       2,478 GFLOP = 2.506 ms; 1.23 GB = 0.37 ms
//
// Design of the fp32 forms. One template for each split3 kernel's two
// forms, over X (the activations' type) and P (the vectors'): the same
// stages, with their loads and stores in those types (row_norm.cuh's
// LayerNorm of fp32 rows and P scales; bf16_gemm_tma.cuh's epilogues with P
// biases and fp32 store boxes for fp32 q, k, v and outputs). fp32 q, k, v
// rule out the bf16 tensor cores (TF32 keeps 10 bits of mantissa): the
// attention is attention_f32.cuh's CUDA-core kernel with no bias, no mask,
// a scale of 1 and the fast_exp exponential, by its held route where a
// block's 64 score rows fit its shared memory (L <= 576 at dh 64), else at
// dh 64 the held route with K in the score rows (L <= 640: ViT-L's 577
// tokens; 13.93 ms against the two-pass route's 23.41 in the same call at
// B = 256 on an H100), else the two-pass route (any L). Its output
// goes to attention_core_oproj's out-projection as three bf16 planes whose
// sum is o exactly (hi = bf16(o), mid = bf16(o - hi), lo = bf16(o - hi -
// mid)), so that product is exact on the tensor cores, wo read three times
// along K (each product exact in fp32: it differs from fp32 FFMA only in
// the order of the sums). The planes
// lie lo | mid | hi along K, smallest first: the tensor cores align each
// product to the running sum and truncate, so lo's products summed after
// hi's are lost.
//
// Design. A Pallas program keeps one image's LN output, scores and
// quickGELU hidden in VMEM; here each function is a short pipeline of
// kernels whose intermediates make one round trip through device memory:
//   layer_norm (row_norm.cuh, shared with gpt2_block.cu): one warp per
//     row, the row in registers, writes h in bf16.
//   q | k | v (fused_ln_qkv): ONE product of N = 3 D over wq, wk and wv on
//     bf16_gemm_tma.cuh's loop (TMA, persistent, asynchronous wgmma, 128 x
//     256 tiles where D % 256 == 0, else 128 x 128), the weights in their
//     JAX (D, D) layout as MN-major B operands through three tensor maps
//     (no copy); its epilogue (QkvEpilogue) routes each column tile into q,
//     k or v (bias, then q's scale) through shared memory and TMA stores.
//   fused_mlp_block's two products on the same loop: the up product with
//     the bias-then-quickGELU epilogue (bf16_gemm_tma.cuh's
//     BiasQuickGeluEpilogueOf, the sigmoid's reciprocal branch-free and
//     exact), the down product with the bias-then-residual one
//     (ResidualEpilogue).
//   gemm (block_stages.cuh): bf16_gemm.cuh's 128 x 128 mma.sync main loop
//     with the bias-then-residual epilogue, for attention_core_oproj's
//     out-projection.
//   attention: attention_core and attention_core_oproj's on wgmma and TMA
//     in vit_attention_wgmma.cuh (two passes over the keys, any L).


#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "attention_f32.cuh"
#include "bf16_gemm_tma.cuh"
#include "block_stages.cuh"
#include "forms.cuh"
#include "vit_attention.cuh"
#include "vit_attention_wgmma.cuh"

namespace {

using namespace block_stages;

// fused_ln_qkv's shapes: the norm's row (block_stages.cuh) and the q | k | v
// product's (K = D a multiple of 64, D a multiple of 128; any M).
inline bool ln_qkv_shape_ok(int M, int D) {
  return norm_shape_ok(D) && bf16_gemm_tma::shape_ok(M, D, D, 3);
}

// ---- the split3 kernels, in both forms -----------------------------------
//
// X is the activations' type (x, the residual, q, k, v and the outputs:
// bf16, or fp32 in the fp32 form), P the LayerNorms' and biases' (bf16, or
// fp32 for fp32 parameters); the weights are bf16 (the wrapper casts fp32
// ones, as the JAX wrapper casts them). One template each, so that the
// forms differ only in their loads and stores: on bf16 x with bf16-valued
// fp32 parameters a form computes the bf16 form's values bit for bit.

// fused_ln_qkv: h = bf16(LN(x)) (row_norm.cuh reads X rows and P scales),
// then one q | k | v product whose epilogue adds the P biases, scales q and
// stores X (fp32 through fp32 store boxes).
template <typename X, typename P>
int ln_qkv(const void* x, const void* ln_s, const void* ln_b, const void* wq,
           const void* bq, const void* wk, const void* bk, const void* wv,
           const void* bv, void* h, void* q, void* k, void* v, int M, int D,
           float scale, float eps, cudaStream_t s) {
  int rc = layer_norm<X, P>(x, ln_s, ln_b, h, M, D, eps, s);
  if (rc != 0) return rc;
  using Epi = bf16_gemm_tma::QkvEpilogueOf<X, false, P>;
  const typename Epi::Args args{
      {static_cast<const P*>(bq), static_cast<const P*>(bk),
       static_cast<const P*>(bv)},
      scale};
  const void* const w[3] = {wq, wk, wv};
  void* const out[3] = {q, k, v};
  return bf16_gemm_tma::gemm<Epi>(h, w, out, 3, M, D, D, args, s);
}

// fused_mlp_block: h = bf16(LN(x)), the up product with the P bias and
// quickGELU into the bf16 hidden, the down product adding the P bias and
// the X residual in fp32, stored as X.
template <typename X, typename P>
int mlp_block(const void* x, const void* ln_s, const void* ln_b,
              const void* w_fc, const void* b_fc, const void* w_proj,
              const void* b_proj, void* h, void* hidden, void* out, int M,
              int D, int F, float eps, cudaStream_t s) {
  namespace bt = bf16_gemm_tma;
  int rc = layer_norm<X, P>(x, ln_s, ln_b, h, M, D, eps, s);
  if (rc != 0) return rc;
  void* const hid[1] = {hidden};
  rc = bt::gemm<bt::BiasQuickGeluEpilogueOf<P>>(
      h, &w_fc, hid, 1, M, D, F, {static_cast<const P*>(b_fc)}, s);
  if (rc != 0) return rc;
  void* const res[1] = {out};
  using Epi = bt::ResidualEpilogue<X, true, X, P>;
  const typename Epi::Args args{static_cast<const P*>(b_proj),
                                static_cast<const X*>(x), M, D};
  return bt::gemm<Epi>(hidden, &w_proj, res, 1, M, F, D, args, s);
}

// attention_core_oproj: the bf16 form's attention (vit_attention_wgmma.cuh,
// kBf16Sum, into bf16 attn) and mma.sync out-projection, the bias of P; the
// fp32 form's attention in fp32 (attention_f32::self_attention, into the
// three planes of attn (M, 3 D) bf16) and its out-projection on
// bf16_gemm_tma.cuh over the planes, wo read three times along K (every
// product exact in fp32), adding the P bias and the fp32 residual, stored fp32.
template <typename X, typename P>
int core_oproj(const void* res, const void* q, const void* k, const void* v,
               const void* wo, const void* bo, void* attn, void* out, int B,
               int L, int H, int dh, int route, cudaStream_t s) {
  namespace bt = bf16_gemm_tma;
  const int M = B * L, D = H * dh;
  if constexpr (std::is_same<X, float>::value) {
    int rc = attention_f32::self_attention(q, k, v, nullptr, attn, B, L, H,
                                           dh, 0, route, s);
    if (rc != 0) return rc;
    void* const outs[1] = {out};
    using Epi = bt::ResidualEpilogue<float, true, float, P>;
    const typename Epi::Args args{static_cast<const P*>(bo),
                                  static_cast<const float*>(res), M, D};
    return bt::gemm<Epi>(attn, &wo, outs, 1, M, 3 * D, D, args, s, 0, D);
  } else {
    const int rc = vit_attention_wgmma::attention_dh<
        vit_attention_wgmma::kBf16Sum>(q, k, v, attn, B, L, H, dh, s);
    if (rc != 0) return rc;
    return residual_gemm<P>(attn, wo, bo, out, res, M, D, D, s);
  }
}

}  // namespace

// Largest sequence length whose score tile fits the current device's shared
// memory at head size dh in vit_attention.cuh's kernel (the whole blocks'
// attention, vit_whole_block.cu and vit_block_q8.cu; 0 if dh is not
// supported).
extern "C" int vit_attention_max_len(int dh) {
  return vit_attention::max_len(dh);
}

// q, k, v (M, D) = (bf16(LN(x)) . w + b) * (scale, 1, 1) for x (M, D):
// bf16 x, q, k, v (x_f32 = 0) or fp32 (1); ln_s, ln_b, bq, bk, bv (D,) bf16
// (params_f32 = 0) or fp32 (1); wq, wk, wv (D, D) bf16 in the JAX layout. h
// (M, D) is the caller's bf16 scratch. Runs on `stream`; returns the first
// cudaError_t of its launches (0 on success).
extern "C" int fused_ln_qkv_launch(const void* x, const void* ln_s,
                                   const void* ln_b, const void* wq,
                                   const void* bq, const void* wk,
                                   const void* bk, const void* wv,
                                   const void* bv, void* h, void* q, void* k,
                                   void* v, int M, int D, int x_f32,
                                   int params_f32, float scale, float eps,
                                   void* stream) {
  if (!ln_qkv_shape_ok(M, D)) return cudaErrorInvalidValue;
  return XP_FORM(ln_qkv, x_f32, params_f32)(
      x, ln_s, ln_b, wq, bq, wk, bk, wv, bv, h, q, k, v, M, D, scale, eps,
      static_cast<cudaStream_t>(stream));
}

// out (B, L, D) = res + softmax(q k^T) v . wo + bo per head, for res, q
// (pre-scaled), k, v (B, L, H dh) and out bf16 (x_f32 = 0) or fp32 (1), wo
// (D, D) bf16, bo (D,) bf16 (params_f32 = 0) or fp32 (1). attn is the
// caller's scratch for the attention output: (B, L, D) bf16, or (B L, 3 D)
// bf16 for the fp32 form's planes. The fp32 form's attention takes `route`
// (attention_f32::by_route's; the held ones refused where L's score rows do
// not fit); dh 64 or 128. Runs on `stream`; returns the first cudaError_t of
// its launches (0 on success).
extern "C" int attention_core_oproj_launch(const void* res, const void* q,
                                           const void* k, const void* v,
                                           const void* wo, const void* bo,
                                           void* attn, void* out, int B,
                                           int L, int H, int dh, int x_f32,
                                           int params_f32, int route,
                                           void* stream) {
  const int M = B * L, D = H * dh;
  if (x_f32 ? (B <= 0 || L <= 0 || H <= 0 ||
               !bf16_gemm_tma::shape_ok(M, 3 * D, D, 1) || D % 64)
            : (!vit_attention_wgmma::shape_ok(B, L, H) ||
               !gemm_shape_ok(M, D))) {
    return cudaErrorInvalidValue;
  }
  return XP_FORM(core_oproj, x_f32, params_f32)(
      res, q, k, v, wo, bo, attn, out, B, L, H, dh, route,
      static_cast<cudaStream_t>(stream));
}

// out (B, L, H dh) = softmax(q k^T) v per head for q (pre-scaled), k, v
// (B, L, H dh) and out bf16 (x_f32 = 0: vit_attention_wgmma.cuh) or fp32
// (1: attention_f32.cuh, dh 64 or 128, by `route`, attention_f32::by_route's
// numbers); the exponential of bf16(s - max) when fast_exp is not 0. Runs on
// `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int attention_core_launch(const void* q, const void* k,
                                     const void* v, void* out, int B, int L,
                                     int H, int dh, int fast_exp, int x_f32,
                                     int route, void* stream) {
  namespace vw = vit_attention_wgmma;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32) {
    return attention_f32::self_attention(q, k, v, out, nullptr, B, L, H, dh,
                                         fast_exp, route, s);
  }
  if (fast_exp) {
    return vw::attention_dh<vw::kFastExp>(q, k, v, out, B, L, H, dh, s);
  }
  return vw::attention_dh<vw::kBf16Sum>(q, k, v, out, B, L, H, dh, s);
}

// out (M, D) = x + quickGELU(bf16(LN(x)) . w_fc + b_fc) . w_proj + b_proj
// for x and out (M, D) bf16 (x_f32 = 0) or fp32 (1); ln_s, ln_b, b_proj
// (D,) and b_fc (F,) bf16 (params_f32 = 0) or fp32 (1); w_fc (D, F) and
// w_proj (F, D) bf16 in the JAX layout. h (M, D) and hidden (M, F) are the
// caller's bf16 scratch. Runs on `stream`; returns the first cudaError_t of
// its launches (0 on success).
extern "C" int fused_mlp_block_launch(const void* x, const void* ln_s,
                                      const void* ln_b, const void* w_fc,
                                      const void* b_fc, const void* w_proj,
                                      const void* b_proj, void* h,
                                      void* hidden, void* out, int M, int D,
                                      int F, int x_f32, int params_f32,
                                      float eps, void* stream) {
  namespace bt = bf16_gemm_tma;
  if (!norm_shape_ok(D) || !bt::shape_ok(M, D, F, 1) ||
      !bt::shape_ok(M, F, D, 1)) {
    return cudaErrorInvalidValue;
  }
  return XP_FORM(mlp_block, x_f32, params_f32)(
      x, ln_s, ln_b, w_fc, b_fc, w_proj, b_proj, h, hidden, out, M, D, F, eps,
      static_cast<cudaStream_t>(stream));
}
