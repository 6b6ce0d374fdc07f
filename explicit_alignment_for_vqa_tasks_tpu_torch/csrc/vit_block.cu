// The CLIP ViT encoder blocks in bf16, for NVIDIA Hopper (sm_90a).
//
// Replaces six Pallas kernels of
// explicit_alignment_for_vqa_tasks_tpu/ops/fused_attention_block.py: the
// three programs of models/clip.py's long-sequence split3 branch (:201-235)
//   fused_ln_qkv           pallas_call at :290, body :235-262
//   attention_core_oproj   pallas_call at :366, body :301-342
//   fused_mlp_block        pallas_call at :445, body :379-413
// the attention of the long split*, fused_attention and int8 branches
//   attention_core         pallas_call at :225, body :161-200
// the whole block of the short fused_block branch (:273-291) and of the long
// whole / whole_dd variants (:182-199)
//   fused_vit_block        pallas_call at :1398, body :1237-1346
// and the attention half of the short fused_attention branch (:295-309)
//   fused_attention_block  pallas_call at :1452, bodies :107-158 (block_diag)
//                          and :47-105 (not)
// It computes, in the Pallas kernels' order of rounding (x (M, D) with M = B L
// rows; activations, weights and outputs bf16; the fp32 forms below):
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
//   fused_vit_block
//     q, k, v = fused_ln_qkv(x)            (the Pallas kernel keeps them fp32
//                                           and casts them to bf16 where used)
//     o   = bf16(attention)  vit_attention.cuh's kNormalised by default,
//                            kDeferredDiv with deferred_div, kFastExp with
//                            fast_exp
//     r1  = x + ((o . wo) + bo)            fp32, never rounded
//     h2  = bf16(LN2(r1))                  the LayerNorm of the fp32 r1
//     hid = bf16(quickGELU((h2 . w_fc) + b_fc))
//     out = bf16(r1 + ((hid . w_proj) + b_proj))
//   fused_attention_block (block_diag, or compute_dtype float32: the same
//     function, since the block-diagonal kernel's -1e30 on other images'
//     keys gives them exact zeros), everything fp32 after the upcast:
//     q   = ((x . wq) + bq) * scale, k = (x . wk) + bk, v = (x . wv) + bv
//     p   = e / sum(e), e = exp(s - max), s = q . k^T   per image and head
//     out = bf16(((p . v) . wo) + bo)      (the caller adds the residual)
//   fused_attention_block (compute_dtype bfloat16):
//     q   = bf16(bf16((x . wq) + bq) * bf16(scale)), k = bf16((x . wk) + bk),
//     v   = bf16((x . wv) + bv)
//     o   = bf16(p . v), p = bf16(e / sum(e))   (vit_attention.cuh's
//                                                kNormalised)
//     out = bf16((o . wo) + bo)
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
// At ViT-B/32 with the bench's batch of 1024 (M = 1024 x 50 = 51,200 rows,
// D = 768, 12 heads of 64, F = 3072):
//   fused_vit_block       724.8 GFLOP of projections + 7.9 of attention =
//                         0.741 ms; 171 MB = 0.051 ms
//   fused_attention_block 181.2 GFLOP of q, k, v (bf16 operands) = 0.183
//                         ms, 7.9 GFLOP of fp32 attention on the CUDA cores
//                         = 0.117 ms and the out-projection as 3 x 60.4
//                         GFLOP of bf16 products (below) = 0.183 ms: 0.484
//                         ms for this route (1.20 ms with the out-projection
//                         on the CUDA cores); 162 MB = 0.048 ms, and this
//                         route's scratch round trips (the fp32 q, k, v,
//                         3 x 157 MB, and the planes, 236 MB, each written
//                         and read) 1.42 GB = 0.42 ms
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
// sum is o exactly (fused_attention_block's planes below), so that product
// is exact on the tensor cores, wo read three times along K.
//
// Design. A Pallas program keeps one image's LN output, scores and
// quickGELU hidden (fused_vit_block: a group's whole block) in VMEM; no SM
// holds a ViT-B block's 14.2 MB of weights, so here each function is a
// short pipeline of kernels whose intermediates make one round trip
// through device memory:
//   layer_norm (row_norm.cuh, shared with gpt2_block.cu): one warp per
//     row (of bf16 x, or of fp32 r1), the row in registers, writes h in
//     bf16.
//   q | k | v (fused_ln_qkv, and fused_vit_block through it): ONE product
//     of N = 3 D over wq, wk and wv on bf16_gemm_tma.cuh's loop (TMA,
//     persistent, asynchronous wgmma, 128 x 256 tiles where D % 256 == 0,
//     else 128 x 128), the weights in their JAX (D, D) layout as MN-major
//     B operands through three tensor maps (no copy); its epilogue
//     (QkvEpilogue) routes each column tile into q, k or v (bias, then q's
//     scale) through shared memory and TMA stores.
//   fused_mlp_block's two products on the same loop: the up product with
//     the bias-then-quickGELU epilogue (BiasQuickGeluEpilogue, the
//     sigmoid's reciprocal branch-free and exact), the down product with
//     the bias-then-residual one (bf16_gemm_tma.cuh's ResidualEpilogue).
//   fused_vit_block's other three products on the same loop too: the
//     out-projection adds x and writes the fp32 r1 (ResidualEpilogue with
//     an fp32 output, stored as 64 x 32 fp32 boxes); the up product as
//     fused_mlp_block's; the down product adds the fp32 r1.
//   fused_attention_block's products on the same loop: q | k | v as one
//     product of N = 3 D whose epilogue writes fp32 q, k, v (64 x 32 fp32
//     store boxes), or bf16 ones with q's scale after the rounding
//     (compute_dtype bfloat16); the out-projection with the bias epilogue,
//     over the three planes below reading wo three times along K (no
//     stacked copy).
//   gemm (block_stages.cuh): bf16_gemm.cuh's 128 x 128 mma.sync main loop
//     with the bias-then-residual epilogue, for attention_core_oproj's
//     out-projection.
//   attention: attention_core and attention_core_oproj's on wgmma and TMA
//     in vit_attention_wgmma.cuh (two passes over the keys, any L); the
//     whole blocks' in vit_attention.cuh, in the softmax order of the
//     function.
//   fused_attention_block's fp32 attention has fp32 operands, where TF32
//     tensor cores would not hold the fp32 result: it runs on the CUDA
//     cores in fp32 (fmaf), one block per (head, image) holding every row
//     of the image (L <= 128), its Q and K transposed, V and then P in
//     shared memory, filled by 16-byte loads. Register tiles: a half-warp
//     per 4 query rows, each thread 4 rows x 4 keys of s a span of 64 keys
//     (16 FMAs a step of dh for two 16-byte loads), the row max and sum by
//     shuffles, then 4 rows x dh / 16 dims of p . v. Each dot product keeps
//     its order over dh (and p . v over the keys), and the softmax max ->
//     exp -> sum -> divide. (The warp-per-row kernel it replaces, with two
//     shared-memory loads an FMA and K and V copied by 4-byte loads, took
//     1.25 ms of a 2.68 ms call at ViT-B/32, B = 1024, on an H100.) Its
//     output goes out as three bf16 planes, hi = bf16(o), mid = bf16(o -
//     hi), lo = bf16(o - hi - mid), whose sum is o exactly; the
//     out-projection is then one bf16 GEMM over (M, 3 D) . (3 D, D), every
//     product exact in fp32, so it differs from fp32 FFMA only in the order
//     of the sums. The planes lie lo | mid | hi along K, smallest first:
//     the tensor cores align each product to the running sum and truncate,
//     so lo's products summed after hi's are lost (on an H100, with hi
//     first, 0.13 % of the bf16 outputs were an ulp off the fp32 plain
//     version's; in this order 0.075 %).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "activations.cuh"
#include "attention_f32.cuh"
#include "bf16_gemm_tma.cuh"
#include "block_stages.cuh"
#include "vit_attention.cuh"
#include "vit_attention_wgmma.cuh"

namespace {

using namespace activations;
using namespace block_stages;
using vit_attention::attention_dh;

// fused_vit_block's bf16 attention in softmax order `mode`
// (vit_attention::Softmax).
int attention_mode(int mode, const void* q, const void* k, const void* v,
                   void* out, int B, int L, int H, int dh,
                   cudaStream_t stream) {
  namespace va = vit_attention;
  switch (mode) {
    case va::kFastExp:
      return attention_dh<va::kFastExp, bf16>(q, k, v, out, B, L, H, dh,
                                              stream);
    case va::kNormalised:
      return attention_dh<va::kNormalised, bf16>(q, k, v, out, B, L, H, dh,
                                                 stream);
    case va::kDeferredDiv:
      return attention_dh<va::kDeferredDiv, bf16>(q, k, v, out, B, L, H, dh,
                                                  stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- the MLP epilogues on bf16_gemm_tma.cuh --------------------------------

// The up product: hid = bf16(quickGELU(acc + bias)), the bias bf16 or
// fp32, the sigmoid's reciprocal branch-free (activations.cuh's
// quick_gelu_fast) where every z of the thread's chunk is at least
// QUICK_GELU_FAST_FLOOR, else (rare) with quick_gelu's correctly rounded
// division. The test comes first, so that no accumulator outlives its use
// (a redo after the fast pass kept the chunk's 32 alive: 0.2 of a 2.6 ms
// up-GEMM at ViT-L, B=256, on an H100).
template <typename BiasT>
struct BiasQuickGeluEpilogueOf {
  struct Args {
    const BiasT* bias;  // (F,)
  };
  template <int ACC, class Put>
  __device__ static void chunk(const Args& args, int, int, int col,
                               const float (&acc)[ACC], int j0,
                               const Put& put) {
    const BiasT* bias = args.bias + col + 2 * (threadIdx.x % 4);
    float z[8][4];  // z[jj][2 half + e], in place of the chunk's acc
    bool low = false;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 b =
          bf16_gemm_tma::to_float2(bf16_gemm_tma::load_pair(bias + 8 * jj));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        z[jj][e] = __fadd_rn(acc[4 * (j0 + jj) + e], e % 2 ? b.y : b.x);
        low |= !(z[jj][e] >= QUICK_GELU_FAST_FLOOR);  // NaN too
      }
    }
    if (low) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          put(jj, half, bf16_gemm_tma::pack_bf16(
                            quick_gelu(z[jj][2 * half]),
                            quick_gelu(z[jj][2 * half + 1])));
        }
      }
      return;
    }
    bool unused = false;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        put(jj, half, bf16_gemm_tma::pack_bf16(
                          quick_gelu_fast(z[jj][2 * half], unused),
                          quick_gelu_fast(z[jj][2 * half + 1], unused)));
      }
    }
  }
};

using BiasQuickGeluEpilogue = BiasQuickGeluEpilogueOf<bf16>;
// fused_vit_block's out-projection, r1 = x + (acc + bias) in fp32, and its
// down product, out = bf16(r1 + (acc + bias)).
using R1Epilogue = bf16_gemm_tma::ResidualEpilogue<bf16, true, float>;
using R1ResidualEpilogue = bf16_gemm_tma::ResidualEpilogue<float, true>;
// fused_attention_block's q | k | v: fp32 (block_diag, compute_dtype
// float32), or bf16 with q's scale after the rounding (compute_dtype
// bfloat16).
using QkvF32Epilogue = bf16_gemm_tma::QkvEpilogueOf<float>;
using QkvRoundFirstEpilogue =
    bf16_gemm_tma::QkvEpilogueOf<__nv_bfloat16, true>;

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
  rc = bt::gemm<BiasQuickGeluEpilogueOf<P>>(h, &w_fc, hid, 1, M, D, F,
                                            {static_cast<const P*>(b_fc)}, s);
  if (rc != 0) return rc;
  void* const res[1] = {out};
  using Epi = bt::ResidualEpilogue<X, true, X, P>;
  const typename Epi::Args args{static_cast<const P*>(b_proj),
                                static_cast<const X*>(x), M, D};
  return bt::gemm<Epi>(hidden, &w_proj, res, 1, M, F, D, args, s);
}

// The fp32 attention of attention_core and attention_core_oproj over fp32
// q (pre-scaled), k, v (B, L, H dh): attention_f32.cuh with no bias, no
// mask and a scale of 1, by route 0 (two passes, any L), 1 (the held
// route) or 2 (the held route with K in the score rows, dh 64); the held
// ones refuse an L whose score rows do not fit. o into out (fp32) or, with
// planes, as three bf16 planes (B L, 3 H dh).
int attention_f32_vit(const void* q, const void* k, const void* v, void* out,
                      void* planes, int B, int L, int H, int dh,
                      int fast_exp, int route, cudaStream_t s) {
  const int D = H * dh;
  attention_f32::Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out);
  a.planes = static_cast<bf16*>(planes);
  a.B = B;
  a.Lq = a.Lk = L;
  a.H = H;
  a.ldq = a.ldk = a.ldo = D;
  a.scale = 1.0f;
  a.fast_exp = fast_exp;
  switch (route) {
    case 0: return attention_f32::attention(a, dh, s);
    case 1: return attention_f32::attention_held(a, dh, s);
    case 2: return attention_f32::attention_held_ks(a, dh, s);
    default: return cudaErrorInvalidValue;
  }
}

// attention_core_oproj: the bf16 form's attention (vit_attention_wgmma.cuh,
// kBf16Sum, into bf16 attn) and mma.sync out-projection, the bias of P; the
// fp32 form's attention in fp32 (attention_f32_vit, into the three planes
// of attn (M, 3 D) bf16) and its out-projection on bf16_gemm_tma.cuh over
// the planes, wo read three times along K (every product exact in fp32),
// adding the P bias and the fp32 residual, stored fp32.
template <typename X, typename P>
int core_oproj(const void* res, const void* q, const void* k, const void* v,
               const void* wo, const void* bo, void* attn, void* out, int B,
               int L, int H, int dh, int route, cudaStream_t s) {
  namespace bt = bf16_gemm_tma;
  const int M = B * L, D = H * dh;
  if constexpr (std::is_same<X, float>::value) {
    int rc = attention_f32_vit(q, k, v, nullptr, attn, B, L, H, dh, 0, route,
                               s);
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

// The form of (x_f32, params_f32): fn<bf16 or float, bf16 or float>.
#define VIT_FORM(fn, x_f32, params_f32)                                  \
  ((x_f32) ? ((params_f32) ? fn<float, float> : fn<float, bf16>)         \
           : ((params_f32) ? fn<bf16, float> : fn<bf16, bf16>))

// ---- fused_attention_block's fp32 attention ---------------------------------

// One block of 4 l8 threads (l8 = L rounded up to 8) per (head, image); a
// half-warp per 4 query rows, so every row of the image in one pass.
constexpr int F32_MAX_LEN = 128;

__host__ __device__ inline int f32_rows(int L) { return (L + 7) / 8 * 8; }
__host__ __device__ inline int f32_keys(int L) { return (L + 63) / 64 * 64; }

// Q^T (dh x l8), in whose place P (l8 / 4 row groups x L keys x 4 rows)
// goes after the scores; K^T (dh x the keys rounded up to 64), zero past L;
// V (L x dh).
inline size_t f32_att_smem_bytes(int L, int dh) {
  const size_t l8 = f32_rows(L);
  return (l8 * (dh > L ? dh : L) + static_cast<size_t>(dh) * f32_keys(L) +
          static_cast<size_t>(L) * dh) * sizeof(float);
}

// VW floats at p, as one vector load of shared memory.
template <int VW>
__device__ inline void load_vec(const float* p, float (&out)[VW]) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (VW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
    out[0] = *p;
  }
}

// VW values rounded to bf16 at p, as one store.
template <int VW>
__device__ inline void store_bf16(bf16* p, const float (&v)[VW]) {
  if constexpr (VW == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 t;
    t.x = *reinterpret_cast<const uint32_t*>(&a);
    t.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = t;
  } else if constexpr (VW == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    *p = __float2bfloat16(v[0]);
  }
}

// Over fp32 q (pre-scaled), k, v (B, L, H DH), all fp32 on the CUDA cores
// (fmaf): s = q . k^T, each dot over DH in order; p = e / sum(e) with e =
// exp(s - max); o = p . v over the keys in order. o goes out as three bf16
// planes of attn3 (B L, 3 H DH): lo | mid | hi, hi + mid + lo = o exactly,
// the smallest first. Register tiles: a thread holds 4 query rows x 4 KU
// keys of s (keys 64 u + 4 lane + t, lane of 16), fed by one float4 of Q^T
// (the 4 rows) and KU float4 of K^T a step of DH; the row max and sum by
// shuffles within the half-warp; then 4 rows x DH / 16 dims of o, fed by a
// float4 of P (the 4 rows' p of key j) and DH / 16 values of V's row j.
// L <= 64 KU.
template <int DH, int KU>
__global__ void __launch_bounds__(4 * F32_MAX_LEN)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, bf16* __restrict__ attn3,
                     int L, int H) {
  constexpr int VW = DH >= 64 ? 4 : DH / 16;  // o's dims a vector
  constexpr int NV = DH / (16 * VW);           // o's vectors a thread
  constexpr int LK = 64 * KU;                  // K^T's row
  const int h = blockIdx.x, b = blockIdx.y;
  const int D = H * DH;
  const int l8 = f32_rows(L);
  const int g = threadIdx.x / 16, lane = threadIdx.x % 16;
  extern __shared__ float4 f32_smem[];
  float* qp = reinterpret_cast<float*>(f32_smem);
  float* kt = qp + l8 * (DH > L ? DH : L);
  float* vs = kt + DH * LK;
  const size_t base =
      static_cast<size_t>(b) * L * D + static_cast<size_t>(h) * DH;

  // q and k transposed, v as it is, each by 16-byte loads. Neighbouring
  // threads take neighbouring rows of q and k (so that their transposed
  // stores fall in different banks) and neighbouring columns of v.
#pragma unroll 4
  for (int idx = threadIdx.x; idx < l8 * (DH / 4); idx += blockDim.x) {
    const int i = idx % l8, c = 4 * (idx / l8);
    float4 qv = make_float4(0.0f, 0.0f, 0.0f, 0.0f), kv = qv;
    if (i < L) {
      const size_t src = base + static_cast<size_t>(i) * D + c;
      qv = __ldg(reinterpret_cast<const float4*>(q + src));
      kv = __ldg(reinterpret_cast<const float4*>(k + src));
    }
    qp[c * l8 + i] = qv.x;
    qp[(c + 1) * l8 + i] = qv.y;
    qp[(c + 2) * l8 + i] = qv.z;
    qp[(c + 3) * l8 + i] = qv.w;
    kt[c * LK + i] = kv.x;
    kt[(c + 1) * LK + i] = kv.y;
    kt[(c + 2) * LK + i] = kv.z;
    kt[(c + 3) * LK + i] = kv.w;
  }
#pragma unroll 4
  for (int idx = threadIdx.x; idx < L * (DH / 4); idx += blockDim.x) {
    const int i = idx / (DH / 4), c = 4 * (idx % (DH / 4));
    *reinterpret_cast<float4*>(vs + i * DH + c) = __ldg(
        reinterpret_cast<const float4*>(v + base + static_cast<size_t>(i) * D +
                                        c));
  }
  for (int idx = threadIdx.x; idx < DH * (LK - l8); idx += blockDim.x) {
    kt[idx / (LK - l8) * LK + l8 + idx % (LK - l8)] = 0.0f;
  }
  __syncthreads();

  // s: rows 4 g + r, keys 64 u + 4 lane + t at s[r][4 u + t]
  float s[4][4 * KU];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4 * KU; ++c) s[r][c] = 0.0f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float qr[4];
    load_vec<4>(qp + d * l8 + 4 * g, qr);
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      float kr[4];
      load_vec<4>(kt + d * LK + 64 * u + 4 * lane, kr);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          s[r][4 * u + t] = fmaf(qr[r], kr[t], s[r][4 * u + t]);
        }
    }
  }

  // the softmax of each row over its L keys: max, exp, sum, then divide
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < 4 * KU; ++c) {
      if (64 * (c / 4) + 4 * lane + c % 4 < L) m = fmaxf(m, s[r][c]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * KU; ++c) {
      const bool key = 64 * (c / 4) + 4 * lane + c % 4 < L;
      s[r][c] = key ? expf(__fsub_rn(s[r][c], m)) : 0.0f;
      sum = __fadd_rn(sum, s[r][c]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
    }
#pragma unroll
    for (int c = 0; c < 4 * KU; ++c) s[r][c] = __fdiv_rn(s[r][c], sum);
  }

  // P in Q^T's place once every row's scores are done: key j of row group
  // g as the float4 of its 4 rows
  __syncthreads();
  float* pg = qp + g * L * 4;
#pragma unroll
  for (int c = 0; c < 4 * KU; ++c) {
    const int j = 64 * (c / 4) + 4 * lane + c % 4;
    if (j < L) {
      *reinterpret_cast<float4*>(pg + 4 * j) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    }
  }
  __syncwarp();

  // o: rows 4 g + r, dims 16 VW n + VW lane + e at o[r][VW n + e]
  float o[4][VW * NV];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < VW * NV; ++c) o[r][c] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < L; ++j) {
    float pr[4];
    load_vec<4>(pg + 4 * j, pr);
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      float vr[VW];
      load_vec<VW>(vs + j * DH + 16 * VW * n + VW * lane, vr);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          o[r][VW * n + e] = fmaf(pr[r], vr[e], o[r][VW * n + e]);
        }
    }
  }

  // the three planes, lo | mid | hi
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * g + r;
    if (row >= L) continue;
    bf16* dst = attn3 + (static_cast<size_t>(b) * L + row) * 3 * D +
                static_cast<size_t>(h) * DH;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      float lo[VW], mid[VW], hi[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const float x = o[r][VW * n + e];
        hi[e] = __bfloat162float(__float2bfloat16(x));
        const float rest = __fsub_rn(x, hi[e]);
        mid[e] = __bfloat162float(__float2bfloat16(rest));
        lo[e] = __fsub_rn(rest, mid[e]);
      }
      const int d0 = 16 * VW * n + VW * lane;
      store_bf16<VW>(dst + d0, lo);
      store_bf16<VW>(dst + D + d0, mid);
      store_bf16<VW>(dst + 2 * D + d0, hi);
    }
  }
}

template <int DH>
int block_attention_f32(const void* q, const void* k, const void* v,
                        void* attn3, int B, int L, int H,
                        cudaStream_t stream) {
  const size_t smem = f32_att_smem_bytes(L, DH);
  if (L > F32_MAX_LEN ||
      smem > static_cast<size_t>(vit_attention::smem_limit())) {
    return cudaErrorInvalidValue;
  }
  const auto kernel = L <= 64 ? attention_f32_kernel<DH, 1>
                              : attention_f32_kernel<DH, 2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), 4 * f32_rows(L), smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<bf16*>(attn3), L, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Largest sequence length whose score tile fits the current device's shared
// memory at head size dh in vit_attention.cuh's kernel (fused_vit_block's
// attention; 0 if dh is not supported).
extern "C" int vit_attention_max_len(int dh) {
  return vit_attention::max_len(dh);
}

// Largest sequence length fused_attention_block's fp32 attention takes at
// head size dh on the current device: at most F32_MAX_LEN (a block holds
// every row of an image), its fp32 Q, K, V and P in shared memory (0 if dh
// is not supported).
extern "C" int attention_block_max_len(int dh) {
  if (dh != 16 && dh != 32 && dh != 64 && dh != 128) return 0;
  const size_t limit = vit_attention::smem_limit();
  int L = F32_MAX_LEN;
  while (L > 0 && f32_att_smem_bytes(L, dh) > limit) --L;
  return L;
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
  return VIT_FORM(ln_qkv, x_f32, params_f32)(
      x, ln_s, ln_b, wq, bq, wk, bk, wv, bv, h, q, k, v, M, D, scale, eps,
      static_cast<cudaStream_t>(stream));
}

// out (B, L, D) = res + softmax(q k^T) v . wo + bo per head, for res, q
// (pre-scaled), k, v (B, L, H dh) and out bf16 (x_f32 = 0) or fp32 (1), wo
// (D, D) bf16, bo (D,) bf16 (params_f32 = 0) or fp32 (1). attn is the
// caller's scratch for the attention output: (B, L, D) bf16, or (B L, 3 D)
// bf16 for the fp32 form's planes. The fp32 form's attention takes `route`
// (attention_f32_vit's; the held ones refused where L's score rows do not
// fit); dh 64 or 128. Runs on `stream`; returns the first cudaError_t of
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
  return VIT_FORM(core_oproj, x_f32, params_f32)(
      res, q, k, v, wo, bo, attn, out, B, L, H, dh, route,
      static_cast<cudaStream_t>(stream));
}

// out (B, L, H dh) = softmax(q k^T) v per head for q (pre-scaled), k, v
// (B, L, H dh) and out bf16 (x_f32 = 0: vit_attention_wgmma.cuh) or fp32
// (1: attention_f32.cuh, dh 64 or 128, by `route`, attention_f32_vit's);
// the exponential of bf16(s - max) when fast_exp is not 0. Runs on
// `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int attention_core_launch(const void* q, const void* k,
                                     const void* v, void* out, int B, int L,
                                     int H, int dh, int fast_exp, int x_f32,
                                     int route, void* stream) {
  namespace vw = vit_attention_wgmma;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32) {
    return attention_f32_vit(q, k, v, out, nullptr, B, L, H, dh, fast_exp,
                             route, s);
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
  return VIT_FORM(mlp_block, x_f32, params_f32)(
      x, ln_s, ln_b, w_fc, b_fc, w_proj, b_proj, h, hidden, out, M, D, F, eps,
      static_cast<cudaStream_t>(stream));
}

// out (B, L, D) bf16 = the whole pre-LN CLIP block over x (B, L, D = H dh)
// bf16, every parameter bf16 in the JAX layout (ln*, b* and bo (D,), b_fc
// (F,), wq, wk, wv, wo (D, D), w_fc (D, F), w_proj (F, D)); `mode` the
// attention's softmax order (vit_attention::Softmax). Scratch of the caller:
// h (M, D) bf16 (LN1, then LN2), q, k, v, attn (M, D) bf16, r1 (M, D) fp32
// and hidden (M, F) bf16. Runs on `stream`; returns the first cudaError_t of
// its launches (0 on success).
extern "C" int fused_vit_block_launch(
    const void* x, const void* ln1_s, const void* ln1_b, const void* wq,
    const void* bq, const void* wk, const void* bk, const void* wv,
    const void* bv, const void* wo, const void* bo, const void* ln2_s,
    const void* ln2_b, const void* w_fc, const void* b_fc, const void* w_proj,
    const void* b_proj, void* h, void* q, void* k, void* v, void* attn,
    void* r1, void* hidden, void* out, int B, int L, int H, int dh, int F,
    int mode, float scale, float eps, void* stream) {
  namespace bt = bf16_gemm_tma;
  const int M = B * L, D = H * dh;
  // every product on bf16_gemm_tma.cuh
  if (!vit_attention::shape_ok(B, L, H) || !ln_qkv_shape_ok(M, D) ||
      !bt::shape_ok(M, D, D, 1) || !bt::shape_ok(M, D, F, 1) ||
      !bt::shape_ok(M, F, D, 1)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = ln_qkv<bf16, bf16>(x, ln1_s, ln1_b, wq, bq, wk, bk, wv, bv, h, q,
                              k, v, M, D, scale, eps, s);
  if (rc != 0) return rc;
  rc = attention_mode(mode, q, k, v, attn, B, L, H, dh, s);
  if (rc != 0) return rc;
  void* const res[1] = {r1};
  rc = bt::gemm<R1Epilogue>(attn, &wo, res, 1, M, D, D,
                            {static_cast<const bf16*>(bo),
                             static_cast<const bf16*>(x), M, D},
                            s);
  if (rc != 0) return rc;
  rc = layer_norm<float>(r1, ln2_s, ln2_b, h, M, D, eps, s);
  if (rc != 0) return rc;
  void* const hid[1] = {hidden};
  rc = bt::gemm<BiasQuickGeluEpilogue>(h, &w_fc, hid, 1, M, D, F,
                                       {static_cast<const bf16*>(b_fc)}, s);
  if (rc != 0) return rc;
  void* const outs[1] = {out};
  return bt::gemm<R1ResidualEpilogue>(
      hidden, &w_proj, outs, 1, M, F, D,
      {static_cast<const bf16*>(b_proj), static_cast<const float*>(r1), M, D},
      s);
}

// out (B, L, D) bf16 = fused_attention_block(x) in fp32 (block_diag, or
// compute_dtype float32) for post-LN x (B, L, D = H dh) bf16, wq, wk, wv, wo
// (D, D) and bq, bk, bv, bo (D,) bf16 in the JAX layout. Scratch of the
// caller: q, k, v (M, D) fp32 and attn3 (M, 3 D) bf16. Runs on `stream`;
// returns the first cudaError_t of its launches (0 on success).
extern "C" int fused_attention_block_launch(
    const void* x, const void* wq, const void* bq, const void* wk,
    const void* bk, const void* wv, const void* bv, const void* wo,
    const void* bo, void* q, void* k, void* v, void* attn3, void* out, int B,
    int L, int H, int dh, float scale, void* stream) {
  namespace bt = bf16_gemm_tma;
  const int M = B * L, D = H * dh;
  if (!vit_attention::shape_ok(B, L, H) || !bt::shape_ok(M, D, D, 3) ||
      !bt::shape_ok(M, 3 * D, D, 1)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* const w[3] = {wq, wk, wv};
  void* const qkv[3] = {q, k, v};
  int rc = bt::gemm<QkvF32Epilogue>(
      x, w, qkv, 3, M, D, D,
      {{static_cast<const bf16*>(bq), static_cast<const bf16*>(bk),
        static_cast<const bf16*>(bv)},
       scale},
      s);
  if (rc != 0) return rc;
  switch (dh) {
    case 16:
      rc = block_attention_f32<16>(q, k, v, attn3, B, L, H, s);
      break;
    case 32:
      rc = block_attention_f32<32>(q, k, v, attn3, B, L, H, s);
      break;
    case 64:
      rc = block_attention_f32<64>(q, k, v, attn3, B, L, H, s);
      break;
    case 128:
      rc = block_attention_f32<128>(q, k, v, attn3, B, L, H, s);
      break;
    default: return cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  // lo | mid | hi along K, each against wo (its k coordinate wraps at D)
  void* const outs[1] = {out};
  return bt::gemm<bt::BiasEpilogue>(attn3, &wo, outs, 1, M, 3 * D, D,
                                    {static_cast<const bf16*>(bo)}, s, 0, D);
}

// out (B, L, D) bf16 = fused_attention_block(x, compute_dtype=bfloat16)
// (not block_diag) for post-LN x and the parameters as above; scale_bf16
// the bf16 scale as a float. Scratch of the caller: q, k, v and attn (M, D)
// bf16. Runs on `stream`; returns the first cudaError_t of its launches (0
// on success).
extern "C" int fused_attention_block_bf16_launch(
    const void* x, const void* wq, const void* bq, const void* wk,
    const void* bk, const void* wv, const void* bv, const void* wo,
    const void* bo, void* q, void* k, void* v, void* attn, void* out, int B,
    int L, int H, int dh, float scale_bf16, void* stream) {
  namespace bt = bf16_gemm_tma;
  namespace va = vit_attention;
  const int M = B * L, D = H * dh;
  if (!va::shape_ok(B, L, H) || !bt::shape_ok(M, D, D, 3)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* const w[3] = {wq, wk, wv};
  void* const qkv[3] = {q, k, v};
  int rc = bt::gemm<QkvRoundFirstEpilogue>(
      x, w, qkv, 3, M, D, D,
      {{static_cast<const bf16*>(bq), static_cast<const bf16*>(bk),
        static_cast<const bf16*>(bv)},
       scale_bf16},
      s);
  if (rc != 0) return rc;
  rc = attention_dh<va::kNormalised, bf16>(q, k, v, attn, B, L, H, dh, s);
  if (rc != 0) return rc;
  void* const outs[1] = {out};
  return bt::gemm<bt::BiasEpilogue>(attn, &wo, outs, 1, M, D, D,
                                    {static_cast<const bf16*>(bo)}, s);
}
