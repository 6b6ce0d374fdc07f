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
// Design (simple and right before fast). The Pallas program keeps a group's
// whole block in VMEM; no SM holds the block's 14.2 MB of weights, so here
// the block is vit_block.cu's fused_vit_block pipeline, whose intermediates
// make one round trip through device memory:
//   layer_norm, then one GEMM launch (block_stages.cuh) whose three
//     blockIdx.z slices take the column thirds of the fused (D, 3 D) weight
//     (row stride 3 D), writing q (scaled), k and v;
//   the attention: vit_attention.cuh's kNormalised order with its MASKED
//     option (causal and key mask), one block per (32 query rows, head,
//     sequence); then masked_rows_kernel;
//   the out-projection GEMM adds x and writes the fp32 r1; LN2 of r1; the
//     up GEMM with the tanh-gelu epilogue; the down GEMM adds r1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "block_stages.cuh"
#include "vit_attention.cuh"

namespace {

using namespace block_stages;

// One block per query row (b, i) of attn (M, D): if no key j <= i of
// sequence b is valid, the row becomes bf16(sum over the G L rows r of its
// group (G sequences from (b / G) G) of p v[r]), p = bf16(1 / (G L)), each
// column summed in order over r in fp32.
__global__ void __launch_bounds__(NT)
masked_rows_kernel(const int* __restrict__ mask, const bf16* __restrict__ v,
                   bf16* __restrict__ attn, int L, int D, int G) {
  const int row = blockIdx.x;
  const int b = row / L, i = row % L;
  int valid = 0;
  for (int j = threadIdx.x; j <= i; j += NT) {
    valid |= mask[static_cast<size_t>(b) * L + j] > 0;
  }
  if (__syncthreads_or(valid)) return;
  const int rows = G * L;
  const size_t first = static_cast<size_t>(b / G) * rows;
  const float p = __bfloat162float(__float2bfloat16(
      __fdiv_rn(1.0f, static_cast<float>(rows))));
  for (int d = threadIdx.x; d < D; d += NT) {
    float o = 0.0f;
    for (int r = 0; r < rows; ++r) {
      o = __fadd_rn(o, __fmul_rn(p, __bfloat162float(
                                        v[(first + r) * D + d])));
    }
    attn[static_cast<size_t>(row) * D + d] = __float2bfloat16(o);
  }
}

}  // namespace

// Largest sequence length whose attention score tile fits the current
// device's shared memory at head size dh (0 if dh is not supported).
extern "C" int gpt2_attention_max_len(int dh) {
  return vit_attention::max_len(dh);
}

// out (B, L, D) bf16 = the whole pre-LN GPT-2 block over x (B, L, D = H dh)
// bf16 under the (B, L) int32 key mask, every parameter bf16 in the JAX
// layout (ln*, b_out, b_proj (D,), b_qkv (3 D,), b_fc (F,), w_qkv (D, 3 D),
// w_out (D, D), w_fc (D, F), w_proj (F, D)); G (it divides B) the Pallas
// kernel's group, which decides only the rows with no visible key. Scratch
// of the caller: h (M, D) bf16 (LN1, then LN2), q, k, v, attn (M, D) bf16,
// r1 (M, D) fp32 and hidden (M, F) bf16. Runs on `stream`; returns the
// first cudaError_t of its launches (0 on success).
extern "C" int fused_gpt2_block_launch(
    const void* x, const void* mask, const void* ln1_s, const void* ln1_b,
    const void* w_qkv, const void* b_qkv, const void* w_out,
    const void* b_out, const void* ln2_s, const void* ln2_b,
    const void* w_fc, const void* b_fc, const void* w_proj,
    const void* b_proj, void* h, void* q, void* k, void* v, void* attn,
    void* r1, void* hidden, void* out, int B, int L, int H, int dh, int F,
    int G, float scale, float eps, void* stream) {
  const int M = B * L, D = H * dh;
  if (!vit_attention::shape_ok(B, L, H) || !gemm_shape_ok(M, D) ||
      !norm_shape_ok(D) || F <= 0 || F % B_COLS || F % BK || G <= 0 ||
      B % G) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* wq = static_cast<const bf16*>(w_qkv);
  const bf16* bq = static_cast<const bf16*>(b_qkv);
  int rc = layer_norm<bf16>(x, ln1_s, ln1_b, h, M, D, eps, s);
  if (rc != 0) return rc;
  rc = gemm<kBiasScale>(
      qkv_args(h, {wq, wq + D, wq + 2 * D}, {bq, bq + D, bq + 2 * D}, q, k,
               v, M, D, 3 * D, scale),
      3, s);
  if (rc != 0) return rc;
  rc = vit_attention::attention_dh<vit_attention::kNormalised, bf16, true>(
      q, k, v, attn, B, L, H, dh, s, static_cast<const int*>(mask));
  if (rc != 0) return rc;
  masked_rows_kernel<<<M, NT, 0, s>>>(static_cast<const int*>(mask),
                                      static_cast<const bf16*>(v),
                                      static_cast<bf16*>(attn), L, D, G);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  rc = gemm<kBiasResidual, float, bf16>(
      gemm_args(attn, w_out, b_out, r1, x, M, D, D), 1, s);
  if (rc != 0) return rc;
  rc = layer_norm<float>(r1, ln2_s, ln2_b, h, M, D, eps, s);
  if (rc != 0) return rc;
  rc = gemm<kBiasTanhGelu>(
      gemm_args(h, w_fc, b_fc, hidden, nullptr, M, D, F), 1, s);
  if (rc != 0) return rc;
  return gemm<kBiasResidual, bf16, float>(
      gemm_args(hidden, w_proj, b_proj, out, r1, M, F, D), 1, s);
}
