// Decode-step cross-attention (one query token) for NVIDIA Hopper (sm_90a).
//
// Replaces explicit_alignment_for_vqa_tasks_tpu/ops/decode_attention.py
// ::cross_attention_decode (the Pallas kernel, pallas_call at :134, body
// :54-78). For batch row b, head h and the decoder layer `layer` of the
// stacked (layers, B, L, H*dh) caches it computes, in the Pallas kernel's
// order:
//
//   s   = K[layer, b, :, h] . q[b, h]      bf16 operands, fp32 accumulation,
//                                          NO 1/sqrt(dh) scale (T5)
//   s   = s + (mask[b] > 0 ? 0 : -1e9)     fp32; -1e9, never -inf
//   p   = exp(s - max(s))
//   p   = bf16(p / sum(p))                 normalised BEFORE the cast (unlike
//                                          t5_attention_core, which divides
//                                          after PV)
//   out = bf16(p . V[layer, b, :, h])      fp32 accumulation
//
// The TPU kernel spreads q block-diagonally so that one MXU product takes
// every head at once; its cross-head products are zeros. Here each block
// takes one (row, head) and computes only that head's products.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at the
// main path's B = 32, L = 557, H = 32, dh = 64 a launch must read one
// layer's K and V, 2 x 73.0 MB = 146 MB, which is 0.0436 ms; it does
// 4 B L H dh = 146 MFLOP, nothing at the tensor-core rate. So it is bound by
// bytes, and a decode step launches it once per decoder layer.
//
// Design (simple and right before fast): one block of eight warps per
// (head, batch row), the head the fastest grid axis so that the blocks of
// one row read neighbouring 128-byte pieces of the same cache rows together.
// Each row of K (and V) of a head is dh bf16 = dh / 8 16-byte chunks; a
// warp takes 32 / (dh / 8) rows at once, one chunk a lane, and keeps four
// such loads in flight per lane (streaming loads, the caches are read once).
// The block holds the L fp32 scores in shared memory; the softmax is three
// block-wide passes over them (max, exp and sum, then the division and the
// bf16 rounding in place). V streams through the same lane layout, each
// lane summing its 8 channels over its rows in fp32; the partial sums are
// reduced across the lanes of a warp by shuffles and across the warps in
// shared memory. The layer index is an argument: the kernel offsets its
// pointers into the whole stacked cache, so no per-layer slice is copied
// (what the Pallas kernel's scalar prefetch achieves).
//
// The fp32 form (q and the caches fp32, as tpu.compute_dtype=float32 makes
// them; JAX's compute_dtype = k_cache.dtype, decode_attention.py:101) is the
// same kernel on 4-float chunks: p is normalised and kept in fp32, and the
// output is fp32. Its bound is 2 x 146 MB = 292 MB a launch, 0.087 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;  // threads per block
constexpr int NWARPS = NT / 32;
constexpr int UNROLL = 4;  // 16-byte loads in flight per lane
constexpr float MASK_NEG = -1e9f;
constexpr int STATIC_SMEM_LIMIT = 48 * 1024;

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// Block-wide sum or max of one value per thread; every thread gets the
// result. `red` holds NWARPS + 1 floats.
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = MAX ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < NWARPS ? red[lane] : (MAX ? -INFINITY : 0.0f);
    t = MAX ? warp_max(t) : warp_sum(t);
    if (lane == 0) red[NWARPS] = t;
  }
  __syncthreads();
  const float r = red[NWARPS];
  __syncthreads();  // red is free for the next reduction
  return r;
}

// Elements of the caches' type (bf16 or fp32) a 16-byte chunk
template <typename T>
__host__ __device__ constexpr int per_chunk() {
  return 16 / static_cast<int>(sizeof(T));
}

// 8 bf16 of a 16-byte chunk as floats
__device__ inline void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// 4 floats of a 16-byte chunk
__device__ inline void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// A value rounded to the caches' type, as a float; and stored as that type
__device__ inline float round_to(float x, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ inline float round_to(float x, const float*) { return x; }
__device__ inline void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ inline void store(float* p, float x) { *p = x; }

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
cross_attention_decode_kernel(const T* __restrict__ q,
                              const T* __restrict__ kc,
                              const T* __restrict__ vc,
                              const int* __restrict__ mask,
                              T* __restrict__ out, int layer, int B, int L,
                              int H) {
  constexpr int EPC = per_chunk<T>();  // elements a 16-byte chunk
  constexpr int CH = DH / EPC;      // 16-byte chunks per head row
  constexpr int RPW = 32 / CH;      // rows a warp takes at once
  constexpr int STEP = RPW * NWARPS;  // rows the block takes at once
  extern __shared__ float s[];      // L scores, then probabilities
  __shared__ float red[NWARPS + 1];
  __shared__ float part[NWARPS][DH];

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = lane % CH, rsub = lane / CH;
  const size_t D = static_cast<size_t>(H) * DH;
  const size_t head = (static_cast<size_t>(layer) * B + b) * L * D +
                      static_cast<size_t>(h) * DH + c * EPC;
  const uint4* kp = reinterpret_cast<const uint4*>(kc + head);
  const uint4* vp = reinterpret_cast<const uint4*>(vc + head);
  const size_t row_step = D / EPC;  // one cache row in 16-byte chunks
  const int* mrow = mask + static_cast<size_t>(b) * L;

  float qf[EPC];
  unpack(*reinterpret_cast<const uint4*>(q + b * D + h * DH + c * EPC), qf);

  // scores: each lane's partial dot over its chunk, summed over the CH
  // lanes of the row
  for (int r0 = warp * RPW; r0 < L; r0 += STEP * UNROLL) {
    uint4 kr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * STEP + rsub;
      kr[u] = r < L ? __ldcs(kp + r * row_step) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[EPC];
      unpack(kr[u], kf);
      float dot = 0.0f;
#pragma unroll
      for (int e = 0; e < EPC; ++e) dot += kf[e] * qf[e];
#pragma unroll
      for (int off = CH / 2; off > 0; off >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      }
      const int r = r0 + u * STEP + rsub;
      if (c == 0 && r < L) {
        s[r] = __fadd_rn(dot, mrow[r] > 0 ? 0.0f : MASK_NEG);
      }
    }
  }
  __syncthreads();

  // softmax over the L scores: max, exp and sum, division and the rounding
  // to T
  float m = -INFINITY;
  for (int i = threadIdx.x; i < L; i += NT) m = fmaxf(m, s[i]);
  m = block_reduce<true>(m, red);
  float sum = 0.0f;
  for (int i = threadIdx.x; i < L; i += NT) {
    const float e = expf(__fsub_rn(s[i], m));
    s[i] = e;
    sum += e;
  }
  sum = block_reduce<false>(sum, red);
  for (int i = threadIdx.x; i < L; i += NT) {
    s[i] = round_to(__fdiv_rn(s[i], sum), q);
  }
  __syncthreads();

  // PV: each lane sums p[r] * v[r, its EPC channels] over its rows
  float acc[EPC];
#pragma unroll
  for (int e = 0; e < EPC; ++e) acc[e] = 0.0f;
  for (int r0 = warp * RPW; r0 < L; r0 += STEP * UNROLL) {
    uint4 vr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * STEP + rsub;
      vr[u] = r < L ? __ldcs(vp + r * row_step) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * STEP + rsub;
      const float p = r < L ? s[r] : 0.0f;
      float vf[EPC];
      unpack(vr[u], vf);
#pragma unroll
      for (int e = 0; e < EPC; ++e) acc[e] += p * vf[e];
    }
  }
  // lanes of one chunk (same c, every rsub) are CH apart
#pragma unroll
  for (int e = 0; e < EPC; ++e) {
#pragma unroll
    for (int off = CH; off < 32; off <<= 1) {
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
    }
  }
  if (rsub == 0) {
#pragma unroll
    for (int e = 0; e < EPC; ++e) part[warp][c * EPC + e] = acc[e];
  }
  __syncthreads();
  if (threadIdx.x < DH) {
    float o = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) o += part[w][threadIdx.x];
    store(out + b * D + h * DH + threadIdx.x, o);
  }
}

int smem_limit() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  return limit;
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, int layer, int B, int L, int H, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(L) * sizeof(float);
  const size_t fixed = (NWARPS + 1 + NWARPS * DH) * sizeof(float);
  if (smem + fixed > static_cast<size_t>(smem_limit())) {
    return cudaErrorInvalidValue;
  }
  if (smem + fixed > STATIC_SMEM_LIMIT) {
    cudaError_t err = cudaFuncSetAttribute(
        cross_attention_decode_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(H, B);
  cross_attention_decode_kernel<T, DH><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(mask),
      static_cast<T*>(out), layer, B, L, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* mask,
             void* out, int layer, int layers, int B, int L, int H, int dh,
             void* stream) {
  if (layer < 0 || layer >= layers || B <= 0 || B > 65535 || L <= 0 ||
      H <= 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, mask, out, layer, B, L, H, s);
    case 32: return launch<T, 32>(q, k, v, mask, out, layer, B, L, H, s);
    case 64: return launch<T, 64>(q, k, v, mask, out, layer, B, L, H, s);
    case 128: return launch<T, 128>(q, k, v, mask, out, layer, B, L, H, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// out (B, H*dh) bf16 = cross-attention of q (B, H*dh) over layer `layer` of
// the (layers, B, L, H*dh) bf16 caches k and v, with the (B, L) int32 key
// mask. Launches on `stream`; returns the cudaError_t of the launch (0 on
// success).
extern "C" int cross_attention_decode_launch(const void* q, const void* k,
                                             const void* v, const void* mask,
                                             void* out, int layer, int layers,
                                             int B, int L, int H, int dh,
                                             void* stream) {
  return dispatch<bf16>(q, k, v, mask, out, layer, layers, B, L, H, dh,
                        stream);
}

// The same with q, the caches and out fp32.
extern "C" int cross_attention_decode_f32_launch(const void* q, const void* k,
                                                 const void* v,
                                                 const void* mask, void* out,
                                                 int layer, int layers, int B,
                                                 int L, int H, int dh,
                                                 void* stream) {
  return dispatch<float>(q, k, v, mask, out, layer, layers, B, L, H, dh,
                         stream);
}
