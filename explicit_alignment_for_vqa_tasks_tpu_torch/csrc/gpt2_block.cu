// The whole pre-LN GPT-2 block in bf16, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel of
// explicit_alignment_for_vqa_tasks_tpu/ops/fused_attention_block.py
//   fused_gpt2_block   pallas_call at :933, body :840-895
// which models/gpt2.py::gpt2_forward runs once per layer (:182-202) when
// GPT2Config.fused_block is set and the sequence has 128 positions or fewer:
// ClipCap's teacher-forced loss (models/clipcap.py::clipcap_loss). It
// computes, in the Pallas kernel's order of rounding (x (M, D) with M = B L
// rows; activations, weights and outputs bf16; the (B, L) key mask int32):
//
//   h    = bf16(LN1(x))                  fp32: mean m, var = mean((x - m)^2),
//                                        ((x - m) * (1 / sqrt(var + eps))) *
//                                        s + b
//   q    = bf16((h . w_qkv[:, :D] + b_qkv[:D]) * scale)    products in fp32,
//   k    = bf16(h . w_qkv[:, D:2D] + b_qkv[D:2D])          then the bias,
//   v    = bf16(h . w_qkv[:, 2D:] + b_qkv[2D:])            then the scale
//   s    = q . k^T per sequence and head, fp32; key j is visible to query i
//          when j <= i and mask[b, j] > 0 (the Pallas kernel scores the others,
//          and the other sequences of its group, -1e30)
//   p    = bf16(e / sum(e)), e = exp(s - max) over the visible keys
//   attn = bf16(p . v)                   per head in fp32, concatenated
//   r1   = x + ((attn . w_out) + b_out)  fp32, never rounded
//   h2   = bf16(LN2(r1))
//   hid  = bf16(tanh-gelu((h2 . w_fc) + b_fc))   0.5 z (1 + tanh(0.79788456
//                                        (z + 0.044715 z^3))) in fp32
//   out  = bf16(r1 + ((hid . w_proj) + b_proj))
//
// A query row with no visible key (a sequence that starts with padding)
// has all G L scores of its Pallas program at exactly -1e30: the softmax is
// uniform over the group of G sequences, and the row's attention output is
// bf16(sum over the group's G L rows r of bf16(1 / (G L)) v[r]), the other
// sequences' values included. The attention below gives such a row zero
// probabilities; masked_rows_kernel then writes that value, in a pass over
// the rows that exits at once for every row with a visible key (all of them
// on ClipCap's path, whose prefix positions are always valid).
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), each
// input read once and each output written once. At GPT-2 small (D = 768, 12
// heads of 64, F = 3072) with ClipCap's loss batch of 32 sequences of 64
// positions (M = 2,048 rows): the projections are 2 M (3 D^2 + D^2 + 2 D F)
// = 28.99 GFLOP and the causal attention 4 D (per visible query-key pair)
// at most 0.20 GFLOP: 0.0295 ms; the bytes are 6.3 MB of activations and
// 14.2 MB of weights, 0.006 ms. At 128 positions (M = 4,096), 58.8 GFLOP,
// 0.059 ms. Bound by operations.
//
// Design. The Pallas program keeps a group's whole block in VMEM; no SM
// holds the block's 14.2 MB of weights, so here the block is vit_block.cu's
// fused_vit_block pipeline, whose intermediates make one round trip through
// device memory, every product on bf16_gemm_tma.cuh's loop (TMA,
// persistent, asynchronous wgmma, TMA-stored epilogues; 128 x 256 tiles,
// or 128 x 128 where the wide tiles would be fewer than the SMs, as for the
// out-projection and the down product at M = 2,048):
//   layer_norm (row_norm.cuh), then ONE q | k | v product over the column
//     thirds of the fused (D, 3 D) weight, three tensor maps w_qkv + i D
//     with a row stride of 3 D (no copy), its epilogue (QkvEpilogue) adding
//     b_qkv's thirds and scaling q (ln_qkv);
//   the attention: vit_attention.cuh's kNormalised order with its MASKED
//     option (causal and key mask), one block per (32 query rows, head,
//     sequence); then masked_rows_kernel;
//   the out-projection adds x and writes the fp32 r1 (ResidualEpilogue with
//     an fp32 output); LN2 of r1; the up product with the bias-then-tanh-
//     gelu epilogue (BiasTanhGeluEpilogueOf); the down product adds r1.
//
// The fp32 form (x_f32 of fused_gpt2_block_launch; tpu.compute_dtype=float32):
// the Pallas kernel reads x, the LayerNorm parameters and the biases in
// their own dtype, widens them to fp32 and writes x.dtype; its four products
// and its attention stay bf16 (the JAX wrapper casts the weights to bf16).
// So the stages above are the same but for their loads and stores, one
// template (gpt2_block<X, P>) for both forms: LN1 reads the fp32 x, the
// LayerNorms and biases are read in their own dtype (all bf16, or all fp32
// under params_dtype=float32) and widened in registers, the out-projection
// adds the fp32 x to make r1, and the down product stores the fp32 output
// through fp32 store boxes. The bytes grow by x's and the output's second
// halves (6.3 MB at the main shape), against the same 28.99 GFLOP: still
// bound by operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "activations.cuh"
#include "bf16_gemm_tma.cuh"
#include "row_norm.cuh"
#include "vit_attention.cuh"

namespace {

namespace bt = bf16_gemm_tma;
using bf16 = __nv_bfloat16;

constexpr int ROWS_NT = 256;  // masked_rows_kernel's threads

// One block per query row (b, i) of attn (M, D): if no key j <= i of
// sequence b is valid, the row becomes bf16(sum over the G L rows r of its
// group (G sequences from (b / G) G) of p v[r]), p = bf16(1 / (G L)), each
// column summed in order over r in fp32.
__global__ void __launch_bounds__(ROWS_NT)
masked_rows_kernel(const int* __restrict__ mask, const bf16* __restrict__ v,
                   bf16* __restrict__ attn, int L, int D, int G) {
  const int row = blockIdx.x;
  const int b = row / L, i = row % L;
  int valid = 0;
  for (int j = threadIdx.x; j <= i; j += ROWS_NT) {
    valid |= mask[static_cast<size_t>(b) * L + j] > 0;
  }
  if (__syncthreads_or(valid)) return;
  const int rows = G * L;
  const size_t first = static_cast<size_t>(b / G) * rows;
  const float p = __bfloat162float(__float2bfloat16(
      __fdiv_rn(1.0f, static_cast<float>(rows))));
  for (int d = threadIdx.x; d < D; d += ROWS_NT) {
    float o = 0.0f;
    for (int r = 0; r < rows; ++r) {
      o = __fadd_rn(o, __fmul_rn(p, __bfloat162float(
                                        v[(first + r) * D + d])));
    }
    attn[static_cast<size_t>(row) * D + d] = __float2bfloat16(o);
  }
}

// The up product: hid = bf16(tanh-gelu(acc + bias)), activations.cuh's
// tanh_gelu in the JAX _tanh_gelu's order, the bias bf16 or fp32. The
// chunk's bias is read before its arithmetic.
template <typename BiasT>
struct BiasTanhGeluEpilogueOf {
  struct Args {
    const BiasT* bias;  // (F,)
  };
  template <int ACC, class Put>
  __device__ static void chunk(const Args& args, int, int, int col,
                               const float (&acc)[ACC], int j0,
                               const Put& put) {
    const BiasT* bias = args.bias + col + 2 * (threadIdx.x % 4);
    float2 bv[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      bv[jj] = bt::to_float2(bt::load_pair(bias + 8 * jj));
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * (j0 + jj) + 2 * half;
        put(jj, half,
            bt::pack_bf16(
                activations::tanh_gelu(__fadd_rn(acc[i], bv[jj].x)),
                activations::tanh_gelu(__fadd_rn(acc[i + 1], bv[jj].y))));
      }
    }
  }
};

// The block's first stage over x of X (bf16, or fp32 in the fp32 form) with
// the LayerNorm and biases of P (bf16, or fp32): h = bf16(LN1(x)), then
// one q | k | v product over the column thirds of w_qkv (three tensor maps
// w_qkv + i D, a row stride of 3 D, no copy), the biases added and q
// scaled in its epilogue.
template <typename X, typename P>
int ln_qkv(const void* x, const void* ln_s, const void* ln_b,
           const void* w_qkv, const void* b_qkv, void* h, void* q, void* k,
           void* v, int M, int D, float scale, float eps, cudaStream_t s) {
  const int rc = row_norm::layer_norm<X, P>(x, ln_s, ln_b, h, M, D, eps, s);
  if (rc != 0) return rc;
  const bf16* w = static_cast<const bf16*>(w_qkv);
  const P* b = static_cast<const P*>(b_qkv);
  const void* const thirds[3] = {w, w + D, w + 2 * D};
  void* const out[3] = {q, k, v};
  return bt::gemm<bt::QkvEpilogueOf<bf16, false, P>>(
      h, thirds, out, 3, M, D, D, {{b, b + D, b + 2 * D}, scale}, s, 3 * D);
}

// The whole block over x (B, L, D) of X with the LayerNorms and biases of
// P, the four weights bf16; the output of X. The out-projection adds x to
// make the fp32 r1 (ResidualEpilogue with an fp32 output), the down product
// adds r1 (an output of X: fp32 store boxes for fp32).
template <typename X, typename P>
int gpt2_block(const void* x, const void* mask, const void* ln1_s,
               const void* ln1_b, const void* w_qkv, const void* b_qkv,
               const void* w_out, const void* b_out, const void* ln2_s,
               const void* ln2_b, const void* w_fc, const void* b_fc,
               const void* w_proj, const void* b_proj, void* h, void* q,
               void* k, void* v, void* attn, void* r1, void* hidden,
               void* out, int B, int L, int H, int dh, int F, int G,
               float scale, float eps, cudaStream_t s) {
  const int M = B * L, D = H * dh;
  int rc = ln_qkv<X, P>(x, ln1_s, ln1_b, w_qkv, b_qkv, h, q, k, v, M, D,
                        scale, eps, s);
  if (rc != 0) return rc;
  rc = vit_attention::attention_dh<vit_attention::kNormalised, bf16, true>(
      q, k, v, attn, B, L, H, dh, s, static_cast<const int*>(mask));
  if (rc != 0) return rc;
  masked_rows_kernel<<<M, ROWS_NT, 0, s>>>(static_cast<const int*>(mask),
                                           static_cast<const bf16*>(v),
                                           static_cast<bf16*>(attn), L, D, G);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  void* const res[1] = {r1};
  rc = bt::gemm<bt::ResidualEpilogue<X, true, float, P>>(
      attn, &w_out, res, 1, M, D, D,
      {static_cast<const P*>(b_out), static_cast<const X*>(x), M, D}, s);
  if (rc != 0) return rc;
  rc = row_norm::layer_norm<float, P>(r1, ln2_s, ln2_b, h, M, D, eps, s);
  if (rc != 0) return rc;
  void* const hid[1] = {hidden};
  rc = bt::gemm<BiasTanhGeluEpilogueOf<P>>(h, &w_fc, hid, 1, M, D, F,
                                           {static_cast<const P*>(b_fc)}, s);
  if (rc != 0) return rc;
  void* const outs[1] = {out};
  return bt::gemm<bt::ResidualEpilogue<float, true, X, P>>(
      hidden, &w_proj, outs, 1, M, F, D,
      {static_cast<const P*>(b_proj), static_cast<const float*>(r1), M, D},
      s);
}

}  // namespace

// Largest sequence length whose attention score tile fits the current
// device's shared memory at head size dh (0 if dh is not supported).
extern "C" int gpt2_attention_max_len(int dh) {
  return vit_attention::max_len(dh);
}

// The block's first stage (the bf16 form's): q, k, v (M, D) bf16 =
// (bf16(LN1(x)) . w_qkv's column thirds + b_qkv's thirds) * (scale, 1, 1)
// for x (M, D) bf16, ln_s, ln_b (D,), w_qkv (D, 3 D) and b_qkv (3 D,) bf16
// in the JAX layout. h (M, D) is the caller's bf16 scratch. Runs on
// `stream`; returns the first cudaError_t of its launches (0 on success).
extern "C" int gpt2_ln_qkv_launch(const void* x, const void* ln_s,
                                  const void* ln_b, const void* w_qkv,
                                  const void* b_qkv, void* h, void* q,
                                  void* k, void* v, int M, int D,
                                  float scale, float eps, void* stream) {
  if (!row_norm::norm_shape_ok(D) || !bt::shape_ok(M, D, D, 3)) {
    return cudaErrorInvalidValue;
  }
  return ln_qkv<bf16, bf16>(x, ln_s, ln_b, w_qkv, b_qkv, h, q, k, v, M, D,
                            scale, eps, static_cast<cudaStream_t>(stream));
}

// out (B, L, D) = the whole pre-LN GPT-2 block over x (B, L, D = H dh)
// under the (B, L) int32 key mask, every parameter in the JAX layout (ln*,
// b_out, b_proj (D,), b_qkv (3 D,), b_fc (F,), w_qkv (D, 3 D), w_out (D, D),
// w_fc (D, F), w_proj (F, D)): the bf16 form with x, the output and every
// parameter bf16 (x_f32 = params_f32 = 0); the fp32 form with x and the
// output fp32 (x_f32 = 1), the four weights bf16 (the wrapper casts fp32
// ones, as the JAX wrapper does) and the LayerNorms and biases all bf16
// (params_f32 = 0) or all fp32 (1). G (it divides B) is the Pallas kernel's
// group, which decides only the rows with no visible key. Scratch of the
// caller: h (M, D) bf16 (LN1, then LN2), q, k, v, attn (M, D) bf16, r1 (M,
// D) fp32 and hidden (M, F) bf16. Runs on `stream`; returns the first
// cudaError_t of its launches (0 on success).
extern "C" int fused_gpt2_block_launch(
    const void* x, const void* mask, const void* ln1_s, const void* ln1_b,
    const void* w_qkv, const void* b_qkv, const void* w_out,
    const void* b_out, const void* ln2_s, const void* ln2_b,
    const void* w_fc, const void* b_fc, const void* w_proj,
    const void* b_proj, void* h, void* q, void* k, void* v, void* attn,
    void* r1, void* hidden, void* out, int B, int L, int H, int dh, int F,
    int G, int x_f32, int params_f32, float scale, float eps, void* stream) {
  const int M = B * L, D = H * dh;
  // every product on bf16_gemm_tma.cuh; the bf16 form's parameters bf16
  if (!vit_attention::shape_ok(B, L, H) || !row_norm::norm_shape_ok(D) ||
      !bt::shape_ok(M, D, D, 3) || !bt::shape_ok(M, D, D, 1) ||
      !bt::shape_ok(M, D, F, 1) || !bt::shape_ok(M, F, D, 1) || G <= 0 ||
      B % G || (params_f32 && !x_f32)) {
    return cudaErrorInvalidValue;
  }
  const auto form = !x_f32     ? gpt2_block<bf16, bf16>
                    : params_f32 ? gpt2_block<float, float>
                                 : gpt2_block<float, bf16>;
  return form(x, mask, ln1_s, ln1_b, w_qkv, b_qkv, w_out, b_out, ln2_s, ln2_b,
              w_fc, b_fc, w_proj, b_proj, h, q, k, v, attn, r1, hidden, out,
              B, L, H, dh, F, G, scale, eps, static_cast<cudaStream_t>(stream));
}
