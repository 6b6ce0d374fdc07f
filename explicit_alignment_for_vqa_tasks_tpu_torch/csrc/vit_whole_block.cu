// The CLIP ViT whole encoder block, in bf16 and in fp32, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas kernel of
// explicit_alignment_for_vqa_tasks_tpu/ops/fused_attention_block.py
//   fused_vit_block        pallas_call at :1398, body :1237-1346
// the whole block of models/clip.py's short fused_block branch (:273-291)
// and of the long whole / whole_dd variants (:182-199). It computes, in the
// Pallas kernel's order of rounding, over x (M, D) with M = B L rows:
//
//   h   = bf16(LN1(x))       fp32: mean m, then var = mean((x - m)^2), then
//                            ((x - m) * (1 / sqrt(var + eps))) * s + b
//   q   = bf16(((h . wq) + bq) * scale), k = bf16((h . wk) + bk),
//   v   = bf16((h . wv) + bv)   (the Pallas kernel keeps them fp32 and casts
//                                them to bf16 where the attention uses them)
//   o   = bf16(attention)    vit_attention.cuh's kNormalised by default,
//                            kDeferredDiv with deferred_div, kFastExp with
//                            fast_exp
//   r1  = x + ((o . wo) + bo)            fp32, never rounded
//   h2  = bf16(LN2(r1))                  the LayerNorm of the fp32 r1
//   hid = bf16(quickGELU((h2 . w_fc) + b_fc))
//   out = X(r1 + ((hid . w_proj) + b_proj))   one cast to x's dtype X
//
// Its forms: x (and out) bf16 or fp32 (X), the LayerNorms' scales and
// biases and the biases bf16 or fp32 (P, fp32 for param_dtype=float32); the
// weights bf16 (the JAX wrapper casts them, :1412-1414; the port's wrapper
// casts fp32 ones). The Pallas kernel reads x and the vectors in their own
// dtypes and widens them, so one template whole_block<X, P> serves every
// form, its stages differing only in their loads and stores; on bf16 x
// with bf16-valued fp32 vectors a form computes the bf16 form's values bit
// for bit. Every multiply and add of the epilogues and norms is written
// with __fmul_rn / __fadd_rn, so that nvcc contracts nothing the plain
// PyTorch version does not have (the build has no --use_fast_math).
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), each
// input read once and each output written once. At ViT-B/32 with the
// bench's batch of 1024 (M = 1024 x 50 = 51,200 rows, D = 768, 12 heads of
// 64, F = 3072): 724.8 GFLOP of projections + 7.9 of attention = 0.741 ms;
// 171 MB = 0.051 ms in bf16, 328 MB = 0.098 ms with fp32 x and out. Bound
// by operations in every form.
//
// Design. A Pallas program keeps a group's whole block in VMEM; no SM holds
// a ViT-B block's 14.2 MB of weights, so here the block is a pipeline of
// kernels whose intermediates make one round trip through device memory:
//   layer_norm (row_norm.cuh): one warp per row of x (then of the fp32 r1),
//     the row in registers, writes bf16 h.
//   q | k | v: ONE product of N = 3 D over wq, wk and wv on
//     bf16_gemm_tma.cuh's loop (TMA, persistent, asynchronous wgmma, 128 x
//     256 tiles where D % 256 == 0, else 128 x 128), the weights in their
//     JAX (D, D) layout through three tensor maps; its epilogue
//     (QkvEpilogueOf<bf16, false, P>) routes each column tile into bf16 q,
//     k or v (bias, then q's scale).
//   attention: vit_attention.cuh (WMMA, an image's score rows in shared
//     memory, L up to vit_attention_max_len) in the softmax order of the
//     function.
//   the out-projection adds x and writes the fp32 r1 (ResidualEpilogue<X,
//     true, float, P>, 64 x 32 fp32 store boxes); the up product's
//     epilogue is the bias-then-quickGELU one (BiasQuickGeluEpilogueOf<P>);
//     the down product adds the fp32 r1 and stores X (ResidualEpilogue<
//     float, true, X, P>).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_gemm_tma.cuh"
#include "forms.cuh"
#include "row_norm.cuh"
#include "vit_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace bt = bf16_gemm_tma;

// The bf16 attention in softmax order `mode` (vit_attention::Softmax).
int attention_mode(int mode, const void* q, const void* k, const void* v,
                   void* out, int B, int L, int H, int dh,
                   cudaStream_t stream) {
  namespace va = vit_attention;
  switch (mode) {
    case va::kFastExp:
      return va::attention_dh<va::kFastExp, bf16>(q, k, v, out, B, L, H, dh,
                                                  stream);
    case va::kNormalised:
      return va::attention_dh<va::kNormalised, bf16>(q, k, v, out, B, L, H,
                                                     dh, stream);
    case va::kDeferredDiv:
      return va::attention_dh<va::kDeferredDiv, bf16>(q, k, v, out, B, L, H,
                                                      dh, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The block over X x (and out) with P vectors; p[] holds ln1_s, ln1_b, wq,
// bq, wk, bk, wv, bv, wo, bo, ln2_s, ln2_b, w_fc, b_fc, w_proj, b_proj in
// that order.
template <typename X, typename P>
int whole_block(const void* x, const void* const* p, void* h, void* q,
                void* k, void* v, void* attn, void* r1, void* hidden,
                void* out, int B, int L, int H, int dh, int F, int mode,
                float scale, float eps, cudaStream_t s) {
  const int M = B * L, D = H * dh;
  int rc = row_norm::layer_norm<X, P>(x, p[0], p[1], h, M, D, eps, s);
  if (rc != 0) return rc;
  using QkvEpi = bt::QkvEpilogueOf<bf16, false, P>;
  const void* const w[3] = {p[2], p[4], p[6]};
  void* const qkv[3] = {q, k, v};
  rc = bt::gemm<QkvEpi>(
      h, w, qkv, 3, M, D, D,
      {{static_cast<const P*>(p[3]), static_cast<const P*>(p[5]),
        static_cast<const P*>(p[7])},
       scale},
      s);
  if (rc != 0) return rc;
  rc = attention_mode(mode, q, k, v, attn, B, L, H, dh, s);
  if (rc != 0) return rc;
  void* const res[1] = {r1};
  rc = bt::gemm<bt::ResidualEpilogue<X, true, float, P>>(
      attn, &p[8], res, 1, M, D, D,
      {static_cast<const P*>(p[9]), static_cast<const X*>(x), M, D}, s);
  if (rc != 0) return rc;
  rc = row_norm::layer_norm<float, P>(r1, p[10], p[11], h, M, D, eps, s);
  if (rc != 0) return rc;
  void* const hid[1] = {hidden};
  rc = bt::gemm<bt::BiasQuickGeluEpilogueOf<P>>(
      h, &p[12], hid, 1, M, D, F, {static_cast<const P*>(p[13])}, s);
  if (rc != 0) return rc;
  void* const outs[1] = {out};
  return bt::gemm<bt::ResidualEpilogue<float, true, X, P>>(
      hidden, &p[14], outs, 1, M, F, D,
      {static_cast<const P*>(p[15]), static_cast<const float*>(r1), M, D},
      s);
}

}  // namespace

// out (B, L, D) = the whole pre-LN CLIP block over x (B, L, D = H dh), x
// and out bf16 (x_f32 = 0) or fp32 (1); ln*, b* and bo (D,) and b_fc (F,)
// bf16 (params_f32 = 0) or fp32 (1); wq, wk, wv, wo (D, D), w_fc (D, F) and
// w_proj (F, D) bf16 in the JAX layout; `mode` the attention's softmax
// order (vit_attention::Softmax). Scratch of the caller: h (M, D) bf16
// (LN1, then LN2), q, k, v, attn (M, D) bf16, r1 (M, D) fp32 and hidden (M,
// F) bf16. Runs on `stream`; returns the first cudaError_t of its launches
// (0 on success).
extern "C" int fused_vit_block_launch(
    const void* x, const void* ln1_s, const void* ln1_b, const void* wq,
    const void* bq, const void* wk, const void* bk, const void* wv,
    const void* bv, const void* wo, const void* bo, const void* ln2_s,
    const void* ln2_b, const void* w_fc, const void* b_fc, const void* w_proj,
    const void* b_proj, void* h, void* q, void* k, void* v, void* attn,
    void* r1, void* hidden, void* out, int B, int L, int H, int dh, int F,
    int mode, int x_f32, int params_f32, float scale, float eps,
    void* stream) {
  const int M = B * L, D = H * dh;
  // every product on bf16_gemm_tma.cuh
  if (!vit_attention::shape_ok(B, L, H) || !row_norm::norm_shape_ok(D) ||
      !bt::shape_ok(M, D, D, 3) || !bt::shape_ok(M, D, F, 1) ||
      !bt::shape_ok(M, F, D, 1)) {
    return cudaErrorInvalidValue;
  }
  const void* const p[16] = {ln1_s, ln1_b, wq,    bq,    wk,   bk,
                             wv,    bv,    wo,    bo,    ln2_s, ln2_b,
                             w_fc,  b_fc,  w_proj, b_proj};
  return XP_FORM(whole_block, x_f32, params_f32)(
      x, p, h, q, k, v, attn, r1, hidden, out, B, L, H, dh, F, mode, scale,
      eps, static_cast<cudaStream_t>(stream));
}
