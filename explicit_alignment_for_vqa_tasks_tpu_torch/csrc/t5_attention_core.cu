// T5 encoder self-attention core for NVIDIA Hopper (sm_90a).
//
// Replaces explicit_alignment_for_vqa_tasks_tpu/ops/fused_attention_block.py
// ::t5_attention_core (the Pallas kernel, pallas_call at :1168, body
// :1109-1130). It computes, per batch row b and head h, in this order:
//
//   s     = q_h . k_h^T            fp32 accumulation, NO 1/sqrt(dh) scale
//   s     = s + bias[h]            fp32 relative-position bias, shared by the batch
//   s     = s + (mask[b] > 0 ? 0 : -1e9)   -1e9 and not -inf: a fully masked
//                                  row comes out as the uniform mean of v
//   m     = rowmax(s)
//   p     = bf16(exp(s - m))       unnormalised, rounded to bf16
//   denom = sum(float(p))
//   o     = bf16((p . v accumulated in fp32) / denom)
//
// q, k, v and o are (B, L, H*dh) bf16 and are read with the head stride of
// that layout; bias is (H, L, L) fp32 in the tiled order of
// ops/fused_attention_block.py::t5_bias_tiles; mask is (B, L) int32.
//
// The kernel is vit_attention_wgmma.cuh's in its kT5 order: two passes
// over the keys on TMA and asynchronous wgmma (the first for the row max,
// the second for p, its sums and p . v), persistent, the items ordered
// (query tile, batch row, head) so that the blocks at work share a head's
// bias in L2; each key tile's bias comes by bulk copy, each thread's 32
// values together. Any L >= 1. Its note gives the design and the bound
// (0.123 ms by operations at the main path's B = 32, L = 557, 32 heads of
// 64 on an H100 SXM; 0.099 ms by bytes).
//
// The fp32 form (q, k, v and o fp32, as tpu.compute_dtype=float32 reaches
// it; p kept in fp32, the Pallas kernel's astype(q.dtype)) is
// attention_f32.cuh's CUDA-core attention with scale 1, the (H, L, L) bias
// as it is and the key mask, head sizes 64 and 128, by one of two routes
// that L alone chooses: t5_attention_core_f32_held_launch where a block's
// 64 score rows fit its shared memory (L <= 576 at dh 64, <= 256 at dh 128:
// q . k^T once into the held rows, softmax in place, P . V from them, K and
// V by cp.async into a ring), t5_attention_core_f32_launch (two passes over
// the keys) for any L. Its note gives the design and the bound (1.21 ms by
// operations at the main path's shapes; the held route's 1.30 on its whole
// tiles, the two-pass route's 1.82).

#include <cuda_runtime.h>

#include "attention_f32.cuh"
#include "vit_attention_wgmma.cuh"

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
extern "C" int t5_attention_core_launch(const void* q, const void* k,
                                        const void* v, const void* bias_tiles,
                                        const void* mask, void* out, int B,
                                        int L, int H, int dh, void* stream) {
  namespace vw = vit_attention_wgmma;
  return vw::attention_dh<vw::kT5>(q, k, v, out, B, L, H, dh,
                                   static_cast<cudaStream_t>(stream),
                                   bias_tiles, mask);
}

namespace {

// q, k, v, out (B, L, H*dh) fp32, bias (H, L, L) fp32 as it is, mask (B, L)
// int32
attention_f32::Args f32_args(const void* q, const void* k, const void* v,
                             const void* bias, const void* mask, void* out,
                             int B, int L, int H, int dh) {
  const int D = H * dh;
  return attention_f32::Args{
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      0, static_cast<long long>(L) * L, L,
      static_cast<const int*>(mask), static_cast<float*>(out),
      B, L, L, H, D, D, D, 1.0f};
}

}  // namespace

// The fp32 form by the two-pass route (any L). Launch on `stream`; returns
// the cudaError_t of the launch (0 on success).
extern "C" int t5_attention_core_f32_launch(const void* q, const void* k,
                                            const void* v, const void* bias,
                                            const void* mask, void* out,
                                            int B, int L, int H, int dh,
                                            void* stream) {
  return attention_f32::attention(
      f32_args(q, k, v, bias, mask, out, B, L, H, dh), dh,
      static_cast<cudaStream_t>(stream));
}

// The fp32 form by the held route: cudaErrorInvalidValue, and nothing
// launched, for an L whose score rows do not fit a block's shared memory.
extern "C" int t5_attention_core_f32_held_launch(const void* q, const void* k,
                                                 const void* v,
                                                 const void* bias,
                                                 const void* mask, void* out,
                                                 int B, int L, int H, int dh,
                                                 void* stream) {
  return attention_f32::attention_held(
      f32_args(q, k, v, bias, mask, out, B, L, H, dh), dh,
      static_cast<cudaStream_t>(stream));
}
