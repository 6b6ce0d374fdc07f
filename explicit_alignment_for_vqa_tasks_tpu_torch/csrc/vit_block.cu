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
//   fused_attention_block  pallas_call at :1452, body :108-158 (block_diag)
// It computes, in the Pallas kernels' order of rounding (x (M, D) with M = B L
// rows; activations, weights and outputs bf16):
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
//   fused_attention_block (block_diag), everything fp32 after the upcast:
//     q   = ((x . wq) + bq) * scale, k = (x . wk) + bk, v = (x . wv) + bv
//     p   = e / sum(e), e = exp(s - max), s = q . k^T   per image and head
//     out = bf16(((p . v) . wo) + bo)      (the caller adds the residual)
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
//                         on the CUDA cores); 162 MB = 0.048 ms
// All are bound by operations but attention_core, bound by bytes; the
// encoders run each of their kernels once per layer.
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
//   gemm (block_stages.cuh): bf16_gemm.cuh's 128 x 128 mma.sync main loop
//     with the epilogue of the stage, for attention_core_oproj's
//     out-projection (bias then residual) and fused_attention_block's
//     products (bias then scale: for its fp32 q, k and v blockIdx.z picks
//     the weight, bias, output and scale, so one launch covers the three
//     (D, D) weights).
//   attention: attention_core and attention_core_oproj's on wgmma and TMA
//     in vit_attention_wgmma.cuh (two passes over the keys, any L); the
//     whole blocks' in vit_attention.cuh, in the softmax order of the
//     function.
//   fused_attention_block's attention has fp32 operands, where TF32 tensor
//     cores would not hold the fp32 result: it runs on the CUDA cores in
//     fp32 (fmaf), one block of eight warps per (head, image) with the
//     image's K and V in shared memory, a warp per query row. Its output
//     goes out as three bf16 planes, hi = bf16(o), mid = bf16(o - hi), lo =
//     bf16(o - hi - mid), whose sum is o exactly; the out-projection is then
//     one bf16 GEMM over (M, 3 D) . (3 D, D) with wo stacked three times,
//     every product exact in fp32, so it differs from fp32 FFMA only in the
//     order of the sums. The planes lie lo | mid | hi along K, smallest
//     first: the tensor cores align each product to the running sum and
//     truncate, so lo's products summed after hi's are lost (on an H100,
//     with hi first, 0.13 % of the bf16 outputs were an ulp off the fp32
//     plain version's; in this order 0.075 %).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "activations.cuh"
#include "bf16_gemm_tma.cuh"
#include "block_stages.cuh"
#include "vit_attention.cuh"
#include "vit_attention_wgmma.cuh"

namespace {

using namespace activations;
using namespace block_stages;
using bf16_gemm_tma::QkvEpilogue;
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

// The up product: hid = bf16(quickGELU(acc + bias)), the sigmoid's
// reciprocal branch-free (activations.cuh's quick_gelu_fast) where every z
// of the thread's chunk is at least QUICK_GELU_FAST_FLOOR, else (rare)
// with quick_gelu's correctly rounded division. The test comes first, so
// that no accumulator outlives its use (a redo after the fast pass kept
// the chunk's 32 alive: 0.2 of a 2.6 ms up-GEMM at ViT-L, B=256, on an
// H100).
struct BiasQuickGeluEpilogue {
  struct Args {
    const bf16* bias;  // (F,)
  };
  template <int ACC, class Put>
  __device__ static void chunk(const Args& args, int, int, int col,
                               const float (&acc)[ACC], int j0,
                               const Put& put) {
    const bf16* bias = args.bias + col + 2 * (threadIdx.x % 4);
    float z[8][4];  // z[jj][2 half + e], in place of the chunk's acc
    bool low = false;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 b = load2(bias + 8 * jj);
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

// fused_mlp_block's down product: out = bf16(x + (acc + bias)).
using BiasResidualEpilogue = bf16_gemm_tma::ResidualEpilogue<bf16, true>;
// fused_vit_block's out-projection, r1 = x + (acc + bias) in fp32, and its
// down product, out = bf16(r1 + (acc + bias)).
using R1Epilogue = bf16_gemm_tma::ResidualEpilogue<bf16, true, float>;
using R1ResidualEpilogue = bf16_gemm_tma::ResidualEpilogue<float, true>;

// fused_ln_qkv's shapes: the norm's row (block_stages.cuh) and the q | k | v
// product's (K = D a multiple of 64, D a multiple of 128; any M).
inline bool ln_qkv_shape_ok(int M, int D) {
  return norm_shape_ok(D) && bf16_gemm_tma::shape_ok(M, D, D, 3);
}

// ---- fused_attention_block's fp32 attention ---------------------------------

constexpr int F32_WARPS = 8;

inline size_t f32_att_smem_bytes(int L, int dh) {
  return (static_cast<size_t>(L) * (dh + 1)      // K, rows padded by one
          + static_cast<size_t>(L) * dh          // V
          + F32_WARPS * static_cast<size_t>(dh)  // each warp's q row
          + F32_WARPS * static_cast<size_t>(L))  // each warp's score row
         * sizeof(float);
}

// One block per (head, image) over fp32 q (pre-scaled), k, v (B, L, H DH):
// s = q . k^T, p = e / sum(e) with e = exp(s - max), o = p . v, all fp32
// (fmaf); o goes out as three bf16 planes of attn3 (B L, 3 H DH): lo | mid |
// hi, hi + mid + lo = o exactly, the smallest first.
template <int DH>
__global__ void __launch_bounds__(F32_WARPS * 32)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, bf16* __restrict__ attn3,
                     int L, int H) {
  constexpr int K_LD = DH + 1;  // rows of K start in different banks
  const int h = blockIdx.x, b = blockIdx.y;
  const int D = H * DH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  extern __shared__ float fsm[];
  float* Ks = fsm;
  float* Vs = Ks + L * K_LD;
  float* qrow = Vs + L * DH + warp * DH;
  float* srow = Vs + L * DH + F32_WARPS * DH + warp * L;
  const size_t base =
      static_cast<size_t>(b) * L * D + static_cast<size_t>(h) * DH;
  for (int idx = threadIdx.x; idx < L * DH; idx += F32_WARPS * 32) {
    const int j = idx / DH, d = idx % DH;
    const size_t src = base + static_cast<size_t>(j) * D + d;
    Ks[j * K_LD + d] = k[src];
    Vs[j * DH + d] = v[src];
  }
  __syncthreads();
  for (int i = warp; i < L; i += F32_WARPS) {
    for (int d = lane; d < DH; d += 32) {
      qrow[d] = q[base + static_cast<size_t>(i) * D + d];
    }
    __syncwarp();
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      float s = 0.0f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) s = fmaf(qrow[d], Ks[j * K_LD + d], s);
      srow[j] = s;
      m = fmaxf(m, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    float sum = 0.0f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(__fsub_rn(srow[j], m));
      srow[j] = e;
      sum = __fadd_rn(sum, e);
    }
    sum = warp_sum(sum);
    for (int j = lane; j < L; j += 32) srow[j] = __fdiv_rn(srow[j], sum);
    __syncwarp();
    const size_t row = (static_cast<size_t>(b) * L + i) * 3 * D +
                       static_cast<size_t>(h) * DH;
    for (int d = lane; d < DH; d += 32) {
      float o = 0.0f;
      for (int j = 0; j < L; ++j) o = fmaf(srow[j], Vs[j * DH + d], o);
      const bf16 hi = __float2bfloat16(o);
      const float rest = __fsub_rn(o, __bfloat162float(hi));
      const bf16 mid = __float2bfloat16(rest);
      const float low = __fsub_rn(rest, __bfloat162float(mid));
      attn3[row + d] = __float2bfloat16(low);
      attn3[row + D + d] = mid;
      attn3[row + 2 * D + d] = hi;
    }
    __syncwarp();  // the rows are free for the next query
  }
}

template <int DH>
int attention_f32(const void* q, const void* k, const void* v, void* attn3,
                  int B, int L, int H, cudaStream_t stream) {
  const size_t smem = f32_att_smem_bytes(L, DH);
  if (smem > static_cast<size_t>(vit_attention::smem_limit())) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      attention_f32_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attention_f32_kernel<DH><<<dim3(H, B), F32_WARPS * 32, smem, stream>>>(
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

// Largest sequence length whose fp32 K and V (fused_attention_block's
// attention) fit the current device's shared memory at head size dh (0 if
// dh is not supported).
extern "C" int attention_block_max_len(int dh) {
  if (dh != 16 && dh != 32 && dh != 64 && dh != 128) return 0;
  const long long fixed = f32_att_smem_bytes(0, dh);
  const long long per_key = f32_att_smem_bytes(1, dh) - fixed;
  const long long keys = (vit_attention::smem_limit() - fixed) / per_key;
  return keys > 0 ? static_cast<int>(keys) : 0;
}

// q, k, v (M, D) bf16 = (bf16(LN(x)) . w + b) * (scale, 1, 1) for x (M, D)
// bf16; ln_s, ln_b, bq, bk, bv (D,) and wq, wk, wv (D, D) bf16 in the JAX
// layout. h (M, D) is the caller's bf16 scratch. Runs on `stream`; returns
// the first cudaError_t of its launches (0 on success).
extern "C" int fused_ln_qkv_launch(const void* x, const void* ln_s,
                                   const void* ln_b, const void* wq,
                                   const void* bq, const void* wk,
                                   const void* bk, const void* wv,
                                   const void* bv, void* h, void* q, void* k,
                                   void* v, int M, int D, float scale,
                                   float eps, void* stream) {
  if (!ln_qkv_shape_ok(M, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = layer_norm<bf16>(x, ln_s, ln_b, h, M, D, eps, s);
  if (rc != 0) return rc;
  const QkvEpilogue::Args args{{static_cast<const bf16*>(bq),
                                static_cast<const bf16*>(bk),
                                static_cast<const bf16*>(bv)},
                               scale};
  const void* const w[3] = {wq, wk, wv};
  void* const out[3] = {q, k, v};
  return bf16_gemm_tma::gemm<QkvEpilogue>(h, w, out, 3, M, D, D, args, s);
}

// out (B, L, D) bf16 = res + softmax(q k^T) v . wo + bo per head, for res,
// q (pre-scaled), k, v (B, L, H dh) bf16, wo (D, D) and bo (D,) bf16. attn
// (B, L, D) is the caller's bf16 scratch for the attention output. Runs on
// `stream`; returns the first cudaError_t of its launches (0 on success).
extern "C" int attention_core_oproj_launch(const void* res, const void* q,
                                           const void* k, const void* v,
                                           const void* wo, const void* bo,
                                           void* attn, void* out, int B,
                                           int L, int H, int dh,
                                           void* stream) {
  if (!vit_attention_wgmma::shape_ok(B, L, H) ||
      !gemm_shape_ok(B * L, H * dh)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = vit_attention_wgmma::attention_dh<
      vit_attention_wgmma::kBf16Sum>(q, k, v, attn, B, L, H, dh, s);
  if (rc != 0) return rc;
  return gemm<kBiasResidual>(
      gemm_args(attn, wo, bo, out, res, B * L, H * dh, H * dh), 1, s);
}

// out (B, L, H dh) bf16 = softmax(q k^T) v per head for q (pre-scaled), k,
// v (B, L, H dh) bf16; the exponential of bf16(s - max) when fast_exp is
// not 0. Runs on `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int attention_core_launch(const void* q, const void* k,
                                     const void* v, void* out, int B, int L,
                                     int H, int dh, int fast_exp,
                                     void* stream) {
  namespace vw = vit_attention_wgmma;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fast_exp) {
    return vw::attention_dh<vw::kFastExp>(q, k, v, out, B, L, H, dh, s);
  }
  return vw::attention_dh<vw::kBf16Sum>(q, k, v, out, B, L, H, dh, s);
}

// out (M, D) bf16 = x + quickGELU(bf16(LN(x)) . w_fc + b_fc) . w_proj +
// b_proj for x (M, D) bf16; ln_s, ln_b, b_proj (D,), b_fc (F,), w_fc (D, F)
// and w_proj (F, D) bf16 in the JAX layout. h (M, D) and hidden (M, F) are
// the caller's bf16 scratch. Runs on `stream`; returns the first
// cudaError_t of its launches (0 on success).
extern "C" int fused_mlp_block_launch(const void* x, const void* ln_s,
                                      const void* ln_b, const void* w_fc,
                                      const void* b_fc, const void* w_proj,
                                      const void* b_proj, void* h,
                                      void* hidden, void* out, int M, int D,
                                      int F, float eps, void* stream) {
  namespace bt = bf16_gemm_tma;
  if (!norm_shape_ok(D) || !bt::shape_ok(M, D, F, 1) ||
      !bt::shape_ok(M, F, D, 1)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = layer_norm<bf16>(x, ln_s, ln_b, h, M, D, eps, s);
  if (rc != 0) return rc;
  void* const hid[1] = {hidden};
  rc = bt::gemm<BiasQuickGeluEpilogue>(h, &w_fc, hid, 1, M, D, F,
                                       {static_cast<const bf16*>(b_fc)}, s);
  if (rc != 0) return rc;
  void* const res[1] = {out};
  const BiasResidualEpilogue::Args args{static_cast<const bf16*>(b_proj),
                                        static_cast<const bf16*>(x), M, D};
  return bt::gemm<BiasResidualEpilogue>(hidden, &w_proj, res, 1, M, F, D,
                                        args, s);
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
  int rc = fused_ln_qkv_launch(x, ln1_s, ln1_b, wq, bq, wk, bk, wv, bv, h, q,
                               k, v, M, D, scale, eps, stream);
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

// out (B, L, D) bf16 = fused_attention_block(x) (block_diag) for post-LN x
// (B, L, D = H dh) bf16, wq, wk, wv (D, D) and bq, bk, bv, bo (D,) bf16 in the
// JAX layout and wo3 (3 D, D) bf16, wo stacked three times. Scratch of the
// caller: q, k, v (M, D) fp32 and attn3 (M, 3 D) bf16. Runs on `stream`;
// returns the first cudaError_t of its launches (0 on success).
extern "C" int fused_attention_block_launch(
    const void* x, const void* wq, const void* bq, const void* wk,
    const void* bk, const void* wv, const void* bv, const void* wo3,
    const void* bo, void* q, void* k, void* v, void* attn3, void* out, int B,
    int L, int H, int dh, float scale, void* stream) {
  const int M = B * L, D = H * dh;
  if (!vit_attention::shape_ok(B, L, H) || !gemm_shape_ok(M, D) ||
      !gemm_shape_ok(M, 3 * D)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = gemm<kBiasScale, float>(
      qkv_args(x, {wq, wk, wv}, {bq, bk, bv}, q, k, v, M, D, scale), 3,
      s);
  if (rc != 0) return rc;
  switch (dh) {
    case 16: rc = attention_f32<16>(q, k, v, attn3, B, L, H, s); break;
    case 32: rc = attention_f32<32>(q, k, v, attn3, B, L, H, s); break;
    case 64: rc = attention_f32<64>(q, k, v, attn3, B, L, H, s); break;
    case 128: rc = attention_f32<128>(q, k, v, attn3, B, L, H, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return gemm<kBiasScale>(
      gemm_args(attn3, wo3, bo, out, nullptr, M, 3 * D, D), 1, s);
}
