// The <X, P> forms of the ViT kernels (vit_block.cu, vit_block_q8.cu,
// vit_whole_block.cu, attention_block.cu): X the activations' and outputs'
// type, P the LayerNorms' scales and biases' and the biases' (bf16 or
// float). An fp32 operand is read as it is where a bf16 one is widened, and
// an fp32 output stored where a bf16 one is rounded; load2 and store2 do
// that for a pair of adjacent elements of either type.

#pragma once

#include <cuda_bf16.h>

namespace forms {

__device__ inline float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ inline float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ inline void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ inline void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

}  // namespace forms

// The form of (x_f32, params_f32): fn<bf16 or float, bf16 or float>.
#define XP_FORM(fn, x_f32, params_f32)                                     \
  ((x_f32) ? ((params_f32) ? fn<float, float> : fn<float, __nv_bfloat16>)  \
           : ((params_f32) ? fn<__nv_bfloat16, float>                      \
                           : fn<__nv_bfloat16, __nv_bfloat16>))
