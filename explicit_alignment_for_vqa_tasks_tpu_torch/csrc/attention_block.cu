// The attention half of a CLIP ViT block, fused_attention_block, in all its
// forms, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel of
// explicit_alignment_for_vqa_tasks_tpu/ops/fused_attention_block.py
//   fused_attention_block  pallas_call at :1452, bodies :107-158 (block_diag)
//                          and :47-105 (not)
// the attention half of models/clip.py's short fused_attention branch
// (:295-309), whose weights come in the activations' dtype (.astype(dt)).
// Over post-LN x (M, D) with M = B L rows; the caller adds the residual:
//
//   the fp32 chain (block_diag, or compute_dtype float32: the same function,
//   since the block-diagonal kernel's -1e30 on other images' keys gives
//   them exact zeros), x and the weights cast to fp32 (exact for bf16),
//   every product of fp32 operands:
//     q   = ((x . wq) + bq) * scale, k = (x . wk) + bk, v = (x . wv) + bv
//     p   = e / sum(e), e = exp(s - max), s = q . k^T   per image and head
//     out = X(((p . v) . wo) + bo)          X = x's dtype
//   the bf16 chain (compute_dtype bfloat16), x and the weights cast to bf16:
//     q   = bf16(bf16((x . wq) + bq) * bf16(scale)), k = bf16((x . wk) +
//           bk), v = bf16((x . wv) + bv)
//     o   = bf16(p . v), p = bf16(e / sum(e))   (vit_attention.cuh's
//                                                kNormalised)
//     out = X((o . wo) + bo)                 straight from the fp32 sum
//   the biases bf16 or fp32, read as they are.
//
// Products of fp32 operands on the bf16 tensor cores. An fp32 value a is
// the exact sum of three bf16 planes, hi = bf16(a), mid = bf16(a - hi), lo
// = bf16(a - hi - mid) (split_planes). Each product of two planes is exact
// in fp32, so a product of fp32 operands is a sum of plane products
// (bf16_gemm_tma.cuh's gemm_planes: A's planes side by side, each weight's
// one under the other, K running over a table of plane pairs). Of the nine
// pairs it keeps the six whose size is at least 2^-24 of hi . hi's: lo .
// hi, hi . lo, mid . mid, mid . hi, hi . mid, hi . hi, in that order: the
// tensor cores align each product to the running sum and truncate, so the
// smallest go first. A bf16 operand is one plane (its own value), which
// leaves three pairs (fp32 x and bf16 weights, or the reverse) or one (the
// bf16 product). The dropped pairs add at most 2^-25 of |x| |w| a term,
// within fp32's own rounding of the product. (Considered: an fp32 FFMA GEMM
// on the CUDA cores, 3.6 ms at B = 1024 on their 67 TFLOP/s against about
// 1.6 ms for the six plane products at 989.)
//
// The fp32 attention has fp32 operands, where TF32 tensor cores would not
// hold the fp32 result: at 128 tokens or fewer it is the register-tiled
// kernel below (one block an (image, head), every row in one pass), above
// that attention_f32.cuh's self_attention by the route the wrapper gives
// (vit_f32_route: held, held with K in the score rows, two-pass; dh 64 or
// 128). Its output goes out as three bf16 planes (lo | mid | hi, (M, 3 D)),
// the out-projection's A operand.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 67 TFLOP/s fp32 on
// the CUDA cores, 3.35 TB/s). At ViT-B/32 with the bench's batch of 1024 (M
// = 51,200 rows, D = 768, 12 heads of 64):
//   the function's products, fp32 x and weights: 241.6 GFLOP of
//   projections + 7.9 of attention = 249.5 GFLOP: 3.72 ms on fp32 FMAs;
//   this route, the projections as six bf16-plane products (1.450 TFLOP,
//   1.47 ms) and the attention on the CUDA cores (0.117 ms): 1.58 ms
//   bf16 x and weights: 181.2 GFLOP of q, k, v = 0.183 ms, 7.9 GFLOP of fp32
//   attention = 0.117 ms and the out-projection as 3 x 60.4 GFLOP of bf16
//   products = 0.183 ms: 0.484 ms for this route; 162 MB = 0.048 ms, and
//   its scratch round trips (the fp32 q, k, v, 3 x 157 MB, and the planes,
//   236 MB, each written and read) 1.42 GB = 0.42 ms
//
// The block kernel (L <= 128): the CUDA cores in fp32 (fmaf), one block per
// (head, image) holding every row of the image, its Q and K transposed, V
// and then P in shared memory, filled by 16-byte loads. Register tiles: a
// half-warp per 4 query rows, each thread 4 rows x 4 keys of s a span of 64
// keys (16 FMAs a step of dh for two 16-byte loads), the row max and sum by
// shuffles, then 4 rows x dh / 16 dims of p . v. Each dot product keeps its
// order over dh (and p . v over the keys), and the softmax max -> exp ->
// sum -> divide. (The warp-per-row kernel it replaced, with two
// shared-memory loads an FMA and K and V copied by 4-byte loads, took 1.25
// ms of a 2.68 ms call at ViT-B/32, B = 1024, on an H100.) With the planes
// hi first, 0.13 % of the bf16 outputs were an ulp off the fp32 plain
// version's on an H100; lo first, 0.075 %.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "attention_f32.cuh"
#include "bf16_gemm_tma.cuh"
#include "forms.cuh"
#include "vit_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace bt = bf16_gemm_tma;

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

// ---- fp32 operands as bf16 planes -----------------------------------------

constexpr int LO = 0, MID = 1, HI = 2;  // a plane's index in its buffer
constexpr int SPLIT_NT = 256;

// The planes of fp32 src (rows, cols; cols % 4 == 0): element (r, c)'s
// plane p at dst[p plane + r ld + c], hi = bf16(a), mid = bf16(a - hi), lo =
// bf16(a - hi - mid), whose sum is a exactly. Four elements a thread.
__global__ void __launch_bounds__(SPLIT_NT)
split_planes_kernel(const float* __restrict__ src, long long n4, int cols4,
                    bf16* __restrict__ dst, int ld, long long plane) {
  for (long long i = blockIdx.x * static_cast<long long>(SPLIT_NT) +
                     threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * SPLIT_NT) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src) + i);
    const float x[4] = {a.x, a.y, a.z, a.w};
    float hi[4], mid[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[e] = __bfloat162float(__float2bfloat16(x[e]));
      const float rest = __fsub_rn(x[e], hi[e]);
      mid[e] = __bfloat162float(__float2bfloat16(rest));
      lo[e] = __fsub_rn(rest, mid[e]);
    }
    bf16* d = dst + (i / cols4) * ld + 4 * (i % cols4);
    store_bf16<4>(d + LO * plane, lo);
    store_bf16<4>(d + MID * plane, mid);
    store_bf16<4>(d + HI * plane, hi);
  }
}

int split_planes(const void* src, int rows, int cols, void* dst, int ld,
                 long long plane, cudaStream_t stream) {
  if (rows <= 0 || cols <= 0 || cols % 4 || ld % 4 || plane % 4) {
    return cudaErrorInvalidValue;
  }
  const long long n4 = static_cast<long long>(rows) * (cols / 4);
  const long long want = (n4 + SPLIT_NT - 1) / SPLIT_NT;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  split_planes_kernel<<<blocks, SPLIT_NT, 0, stream>>>(
      static_cast<const float*>(src), n4, cols / 4, static_cast<bf16*>(dst),
      ld, plane);
  return static_cast<int>(cudaGetLastError());
}

// The plane pairs of a product of A (a_count planes: 3 for fp32, 1 for
// bf16) with B (b_count), the smallest products first.
bt::Planes plane_pairs(int a_count, int b_count) {
  if (a_count == 3 && b_count == 3) {
    return {3, 3, 6, {LO, HI, MID, MID, HI, HI}, {HI, LO, MID, HI, MID, HI}};
  }
  if (a_count == 3) return {3, 1, 3, {LO, MID, HI}, {0, 0, 0}};
  if (b_count == 3) return {1, 3, 3, {0, 0, 0}, {LO, MID, HI}};
  return {1, 1, 1, {0}, {0}};
}

// The route of the fp32 attention: the block kernel above (L <= 128), or
// attention_f32::by_route's 0, 1, 2.
constexpr int BLOCK_ROUTE = 3;

int fp32_attention(const void* q, const void* k, const void* v, void* attn3,
                   int B, int L, int H, int dh, int route,
                   cudaStream_t stream) {
  if (route != BLOCK_ROUTE) {
    return attention_f32::self_attention(q, k, v, nullptr, attn3, B, L, H,
                                         dh, 0, route, stream);
  }
  switch (dh) {
    case 16: return block_attention_f32<16>(q, k, v, attn3, B, L, H, stream);
    case 32: return block_attention_f32<32>(q, k, v, attn3, B, L, H, stream);
    case 64: return block_attention_f32<64>(q, k, v, attn3, B, L, H, stream);
    case 128:
      return block_attention_f32<128>(q, k, v, attn3, B, L, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The fp32 chain over X x (its planes into x_planes when fp32) and the
// weights w[] = wq, wk, wv, wo (bf16, or fp32 split into w_planes, four (3
// D, D) plane stacks, when w_f32), the biases b[] of P; the fp32 q, k, v,
// the attention's planes attn3 (M, 3 D), out (M, D) of X.
template <typename X, typename P>
int fp32_chain(const void* x, const void* const* w, const void* const* b,
               void* x_planes, void* w_planes, int w_f32, void* q, void* k,
               void* v, void* attn3, void* out, int B, int L, int H, int dh,
               int route, float scale, cudaStream_t s) {
  const int M = B * L, D = H * dh;
  const void* a = x;
  int a_count = 1, rc = 0;
  if constexpr (std::is_same<X, float>::value) {
    rc = split_planes(x, M, D, x_planes, 3 * D, D, s);
    if (rc != 0) return rc;
    a = x_planes;
    a_count = 3;
  }
  const void* wp[4] = {w[0], w[1], w[2], w[3]};
  const int b_count = w_f32 ? 3 : 1;
  for (int i = 0; w_f32 && i < 4; ++i) {
    bf16* planes = static_cast<bf16*>(w_planes) + 3LL * i * D * D;
    rc = split_planes(w[i], D, D, planes, D, static_cast<long long>(D) * D,
                      s);
    if (rc != 0) return rc;
    wp[i] = planes;
  }
  using QkvEpi = bt::QkvEpilogueOf<float, false, P>;
  void* const qkv[3] = {q, k, v};
  rc = bt::gemm_planes<QkvEpi>(
      a, wp, qkv, 3, M, D, D, plane_pairs(a_count, b_count),
      {{static_cast<const P*>(b[0]), static_cast<const P*>(b[1]),
        static_cast<const P*>(b[2])},
       scale},
      s);
  if (rc != 0) return rc;
  rc = fp32_attention(q, k, v, attn3, B, L, H, dh, route, s);
  if (rc != 0) return rc;
  void* const outs[1] = {out};
  return bt::gemm_planes<bt::BiasEpilogueOf<X, P>>(
      attn3, &wp[3], outs, 1, M, D, D, plane_pairs(3, b_count),
      {static_cast<const P*>(b[3])}, s);
}

// The bf16 chain over bf16 x and weights, the biases of P, out of X.
template <typename X, typename P>
int bf16_chain(const void* x, const void* const* w, const void* const* b,
               void* q, void* k, void* v, void* attn, void* out, int B, int L,
               int H, int dh, float scale_bf16, cudaStream_t s) {
  namespace va = vit_attention;
  const int M = B * L, D = H * dh;
  using QkvEpi = bt::QkvEpilogueOf<bf16, true, P>;
  void* const qkv[3] = {q, k, v};
  int rc = bt::gemm<QkvEpi>(
      x, w, qkv, 3, M, D, D,
      {{static_cast<const P*>(b[0]), static_cast<const P*>(b[1]),
        static_cast<const P*>(b[2])},
       scale_bf16},
      s);
  if (rc != 0) return rc;
  rc = va::attention_dh<va::kNormalised, bf16>(q, k, v, attn, B, L, H, dh, s);
  if (rc != 0) return rc;
  void* const outs[1] = {out};
  return bt::gemm<bt::BiasEpilogueOf<X, P>>(
      attn, &w[3], outs, 1, M, D, D, {static_cast<const P*>(b[3])}, s);
}

}  // namespace

// out (B, L, D) = fused_attention_block(x) by the fp32 chain (block_diag,
// or compute_dtype float32) for post-LN x (B, L, D = H dh) and out bf16
// (x_f32 = 0) or fp32 (1); wq, wk, wv, wo (D, D) in the JAX layout bf16
// (w_f32 = 0) or fp32 (1); bq, bk, bv, bo (D,) bf16 (b_f32 = 0) or fp32 (1).
// The attention by `route`: 3 the block kernel (L <= 128, dh 16, 32, 64 or
// 128), else attention_f32::by_route's (dh 64 or 128). Scratch of the
// caller: x_planes (M, 3 D) bf16 when x_f32, w_planes (4, 3 D, D) bf16 when
// w_f32, q, k, v (M, D) fp32 and attn3 (M, 3 D) bf16. Runs on `stream`;
// returns the first cudaError_t of its launches (0 on success).
extern "C" int fused_attention_block_launch(
    const void* x, const void* wq, const void* bq, const void* wk,
    const void* bk, const void* wv, const void* bv, const void* wo,
    const void* bo, void* x_planes, void* w_planes, void* q, void* k,
    void* v, void* attn3, void* out, int B, int L, int H, int dh, int x_f32,
    int w_f32, int b_f32, int route, float scale, void* stream) {
  const int M = B * L, D = H * dh;
  if (B <= 0 || L <= 0 || H <= 0 || B > 65535 || H > 65535 ||
      !bt::shape_ok(M, D, D, 3) ||
      (route == BLOCK_ROUTE && L > F32_MAX_LEN)) {
    return cudaErrorInvalidValue;
  }
  const void* const w[4] = {wq, wk, wv, wo};
  const void* const b[4] = {bq, bk, bv, bo};
  return XP_FORM(fp32_chain, x_f32, b_f32)(
      x, w, b, x_planes, w_planes, w_f32, q, k, v, attn3, out, B, L, H, dh,
      route, scale, static_cast<cudaStream_t>(stream));
}

// out (B, L, D) = fused_attention_block(x, compute_dtype=bfloat16) (not
// block_diag) for post-LN x (B, L, D = H dh) bf16 (the wrapper's cast of an
// fp32 x), wq, wk, wv, wo (D, D) bf16 in the JAX layout, bq, bk, bv, bo (D,)
// bf16 (b_f32 = 0) or fp32 (1), out bf16 (out_f32 = 0) or fp32 (1);
// scale_bf16 the bf16 scale as a float. Scratch of the caller: q, k, v and
// attn (M, D) bf16. Runs on `stream`; returns the first cudaError_t of its
// launches (0 on success).
extern "C" int fused_attention_block_bf16_launch(
    const void* x, const void* wq, const void* bq, const void* wk,
    const void* bk, const void* wv, const void* bv, const void* wo,
    const void* bo, void* q, void* k, void* v, void* attn, void* out, int B,
    int L, int H, int dh, int out_f32, int b_f32, float scale_bf16,
    void* stream) {
  const int M = B * L, D = H * dh;
  if (!vit_attention::shape_ok(B, L, H) || !bt::shape_ok(M, D, D, 3)) {
    return cudaErrorInvalidValue;
  }
  const void* const w[4] = {wq, wk, wv, wo};
  const void* const b[4] = {bq, bk, bv, bo};
  return XP_FORM(bf16_chain, out_f32, b_f32)(
      x, w, b, q, k, v, attn, out, B, L, H, dh, scale_bf16,
      static_cast<cudaStream_t>(stream));
}
