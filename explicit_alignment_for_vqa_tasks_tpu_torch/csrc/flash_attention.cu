// The fp32 attention of the CLIP encoder's use_pallas option, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas kernel of
// explicit_alignment_for_vqa_tasks_tpu/ops/attention.py
//   flash_attention    pallas_call at :142, bodies :29-63
// whose one caller is models/clip.py's _encoder_block with use_pallas
// (:356-359), reached through tools/clip_encoder.py's ClipImageEncoder. Per
// (image, head) over (B, Lq, H, dh) pre-scaled q and (B, Lk, H, dh) k, v
// (bf16 values, upcast to fp32) and an optional fp32 bias broadcast to
// (B, H, Lq, Lk), in the Pallas kernel's order:
//
//   s   = q . k^T + bias          fp32
//   m   = max s;  e = exp(s - m)  fp32, unnormalised
//   o   = bf16((e . v) / sum(e))  PV in fp32, then the division by the
//                                 fp32 sum
//
// The JAX wrapper pads Lk to a multiple of 128 (at least 8) with keys whose
// score is exactly -1e9 (q . 0 plus the -1e9 of the padded bias) and whose
// v is 0. Here they are not stored: the n_pad padded keys join the row max
// as -1e9 and the denominator as n_pad exp(-1e9 - m). For a row with a real
// key above -1e9 they add exact zeros; for a row whose bias masks every key
// (all its scores near -1e9) they count in the denominator as in JAX. The
// JAX wrapper's padding of Lq changes no real row.
//
// The kernel is vit_attention_wgmma.cuh's in its kF32Planes order: two
// passes over the keys on TMA and asynchronous wgmma (the first for the row
// max, the second for e, its fp32 sums and e . v), persistent, Q in
// registers. q and k hold bf16 values, so every product q k is exact in
// fp32; e stays fp32 and is split in registers into three bf16 planes, hi =
// bf16(e), mid = bf16(e - hi), lo = bf16(e - hi - mid), whose sum is e
// exactly, so PV is three exact bf16 products with v against the same V
// tile, summed lo + mid, then + hi. Any Lq and Lk (no score row in shared
// memory). Its note gives the design.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), each
// input read once and each output written once. At ViT-L/14@336 with the
// image encoder's batch of 256 (B = 256, L = 577, 16 heads of 64, no bias):
// the bytes are q, k, v and o, 4 x 302.5 MB = 1.21 GB = 0.361 ms, the
// function's two products 349.1 GFLOP = 0.353 ms: bound by bytes. This
// route computes q k^T twice and PV as three products: 5 x 174.6 GFLOP =
// 873 GFLOP = 0.883 ms, bound by operations.
//
// The fp32 form (fp32 q, k, v and output): the Pallas kernel's order on fp32
// operands, o = fp32((e . v) / sum(e)), is attention_f32.cuh's CUDA-core
// kernel with a scale of 1, the (B, L, H, dh) layout (rows H dh apart, head
// h at h dh), the bias by its four strides and the n_pad padded keys
// counted as above; by the route the wrapper gives (vit_f32_route of Lk:
// the held route, the held route with K in the score rows up to 640 keys at
// dh 64, else two passes; dh 64 or 128). Its bound at ViT-L/14@336, B =
// 256: 4 B H L^2 dh = 349.1 GFLOP on fp32 FMAs at 67 TFLOP/s = 5.21 ms
// (6.41 ms on whole 64-key tiles, the held routes'); 2.42 GB = 0.72 ms. At
// ViT-B/32, B = 1024 (L = 50, 12 heads of 64): 7.9 GFLOP = 0.117 ms, 629 MB
// = 0.188 ms, bound by bytes.

#include <cuda_runtime.h>

#include "attention_f32.cuh"
#include "vit_attention_wgmma.cuh"

// out (B, Lq, H, dh) bf16 = softmax(q k^T + bias) v per (image, head) for
// pre-scaled q (B, Lq, H, dh) and k, v (B, Lk, H, dh) bf16; `bias` fp32 read
// at b sb + h sh + i sq + j sk (strides in elements, 0 on broadcast axes),
// or null for none; n_pad padded keys of score -1e9 and value 0. Runs on
// `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      void* out, int B, int Lq, int Lk, int H,
                                      int dh, int n_pad, long long sb,
                                      long long sh, long long sq,
                                      long long sk, void* stream) {
  namespace vw = vit_attention_wgmma;
  const vw::FlashTerms flash{static_cast<const float*>(bias), sb, sh, sq, sk,
                             n_pad};
  return vw::flash_dh(q, k, v, out, B, Lq, Lk, H, dh, flash,
                      static_cast<cudaStream_t>(stream));
}

// The fp32 form: out (B, Lq, H, dh) fp32 = softmax(q k^T + bias) v per
// (image, head) for pre-scaled q (B, Lq, H, dh) and k, v (B, Lk, H, dh)
// fp32; the bias and n_pad as flash_attention_launch's; `route` 0, 1 or 2
// (attention_f32::by_route's; the held ones refuse an Lk whose score rows
// do not fit); dh 64 or 128. Runs on `stream`; returns the launch's
// cudaError_t (0 on success).
extern "C" int flash_attention_f32_launch(const void* q, const void* k,
                                          const void* v, const void* bias,
                                          void* out, int B, int Lq, int Lk,
                                          int H, int dh, int n_pad,
                                          int route, long long sb,
                                          long long sh, long long sq,
                                          long long sk, void* stream) {
  if (n_pad < 0) return cudaErrorInvalidValue;
  attention_f32::FlashArgs a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.bias = static_cast<const float*>(bias);
  a.bias_b = sb;
  a.bias_h = sh;
  a.bias_row = sq;
  a.bias_key = sk;
  a.out = static_cast<float*>(out);
  a.B = B;
  a.Lq = Lq;
  a.Lk = Lk;
  a.H = H;
  a.ldq = a.ldk = a.ldo = H * dh;
  a.scale = 1.0f;
  a.n_pad = n_pad;
  return attention_f32::by_route(a, dh, route,
                                 static_cast<cudaStream_t>(stream));
}
