// The int8 CLIP ViT blocks, for NVIDIA Hopper (sm_90a): the LayerNorm + q/k/v
// and the LayerNorm + MLP programs of the long-sequence int8 path, and the
// whole int8 block of the short one, every projection int8 on the tensor
// cores.
//
// Replaces three Pallas kernels of
// explicit_alignment_for_vqa_tasks_tpu/ops/fused_attention_block.py, the
// int8 programs of models/clip.py's long-sequence int8 branch (:532-579)
//   fused_qkv_q8        pallas_call at :584, body :530-556
//   fused_mlp_block_q8  pallas_call at :516, body :462-492
// (the attention between them is vit_block.cu's attention_core), and the
// whole block of the int8 branch at 128 tokens or fewer (:497-530)
//   fused_vit_block_q8  pallas_call at :810, body :702-769
// What they compute, in the Pallas kernels' order of rounding (x (M, D), M =
// B L rows, and the outputs bf16 or fp32, X; the LayerNorms' scales and
// biases and the biases bf16 or fp32, P; weights int8 (K, N) with fp32 (N,)
// per-output-channel scales):
//
//   h    = ((x - m) * (1 / sqrt(var + eps))) * s + b   fp32 LayerNorm, NOT
//          rounded to bf16 (m the mean, var the mean of (x - m)^2)
//   hs   = max(amax(|h|), 1e-6) * (1/127)     per row (XLA's form of / 127)
//   hq   = clip(rint(h / hs), -127, 127)
//   fused_qkv_q8, one (D, 3D) product over the concatenated q | k | v:
//     qkv = ((float(hq . W) * hs) * s) + b
//     q, k, v = X(qkv[:, :D] * scale), X(qkv[:, D:2D]), X(qkv[:, 2D:]) (fp32
//               x: stored as they are, unrounded)
//   fused_mlp_block_q8:
//     z   = ((float(hq . W_fc) * hs) * s_fc) + b_fc
//     hid = z * (1 / (1 + exp(-(1.702 z))))    fp32 quickGELU, never bf16
//     gs, gq: hid quantized per row over its whole width F
//     out = X(x + (((float(gq . W_proj) * gs) * s_proj) + b_proj)), x read
//           in its own dtype for the LayerNorm and again for the residual
//   fused_vit_block_q8:
//     q, k, v = fused_qkv_q8(x), stored bf16 in every form (the Pallas
//           kernel casts q, k, v and p to bf16 for the attention)
//     o   = vit_attention.cuh's kNormalised attention, kept fp32
//     r1  = x + (((float(oq . W_o) * os) * s_o) + b_o)   o quantized per row;
//           fp32, never rounded
//     out = fused_mlp_block_q8's MLP over the fp32 r1 (its LayerNorm, hidden
//           and residual fp32), one cast to X
// Each launcher is one template <X, P> (the forms of vit_block.cu): an fp32
// x is read as it is where the bf16 one is widened, an fp32 output stored
// where the bf16 one is rounded, and fp32 vectors read where bf16 ones are
// widened; nothing else differs between the four forms.
//
// Every multiply and add is written with __fmul_rn / __fadd_rn / __fsub_rn
// so that nvcc cannot contract them into FMAs; the square root and the
// divisions are correctly rounded and the exponential is expf (the build
// has no --use_fast_math).
//
// What bounds them on an H100 SXM (1,979 TOP/s int8 dense, 989 TFLOP/s bf16,
// 3.35 TB/s), 2 M K N operations per product, each input read once and each
// output written once. At ViT-L/14@336 with the image encoder's batch of 256
// (M = 256 x 577 = 147,712 rows, D = 1024, F = 4096):
//   fused_qkv_q8        929.3 G ops = 0.470 ms; 1.21 GB = 0.36 ms (fp32 x,
//                       q, k, v: 2.42 GB = 0.72 ms)
//   fused_mlp_block_q8  2,478 G ops = 1.252 ms; 0.61 GB = 0.18 ms (fp32 x
//                       and output: 1.22 GB = 0.36 ms)
// At ViT-B/32 with the bench's batch of 1024 (M = 51,200 rows, D = 768, 12
// heads of 64, F = 3072):
//   fused_vit_block_q8  724.8 G int8 ops = 0.366 ms, plus 7.9 GFLOP of bf16
//                       attention = 0.008 ms; 164 MB = 0.049 ms (fp32 x and
//                       output: 321 MB = 0.096 ms)
// All are bound by operations but fused_qkv_q8's fp32 form, bound by its
// bytes; the encoders run each once per layer.
//
// Design, from q8_gemm.cuh's row_quant and q8_gemm_tma.cuh's loop (TMA, a
// producer warpgroup, wgmma kept in flight, a persistent grid; 128 x 256
// tiles where the width allows, else 128 x 128):
//   fused_qkv_q8: row_quant with the LayerNorm in front (one block per row,
//     the fp32 row in shared memory), then one s8 GEMM with N = 3 D over the
//     K-major (3 D, D) weight whose epilogue adds the column's bias, scales
//     the q columns and writes each column tile into q, k or v (a tile never
//     straddles two of them: the launcher asks that its width divide D).
//   fused_mlp_block_q8: row_quant + LayerNorm; the up GEMM (N = F) with the
//     bias-then-quickGELU epilogue writing the fp32 hidden; row_quant of the
//     hidden over its whole 4096-wide row (16 KB of shared memory); the
//     down GEMM (K = F, one contraction group: 4096 x 127^2 is far inside
//     int32) with the bias-then-residual epilogue. The fp32 hidden makes
//     one round trip through device memory (2.42 GB at the main shape)
//     where the Pallas program keeps it in VMEM: its scale is the amax of
//     the whole F-wide row, which no tile sees. Computing the up-product twice instead (partial amaxes per
//     column tile, then the codes) lost on an H100: the epilogue's
//     quickGELU, not the hidden's bytes, bounds each up-pass while the
//     epilogue does not overlap the products (PERF.md has the runs).
//   fused_vit_block_q8: row_quant with the LayerNorm and the q | k | v
//     GEMM; the attention with an fp32 output; row_quant of that output;
//     the out-projection GEMM whose residual epilogue writes the fp32 r1;
//     then row_quant's LayerNorm over r1, the up GEMM, row_quant of the
//     hidden and the down GEMM adding r1, each with its epilogue below.
//     The codes, row scales, q, k, v, attention output, r1 and hidden each
//     make one round trip through device memory (no SM holds the block's
//     7.1 MB of int8 weights).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "activations.cuh"
#include "forms.cuh"
#include "q8_gemm.cuh"
#include "q8_gemm_tma.cuh"
#include "vit_attention.cuh"

namespace {

using namespace q8_gemm;

// The epilogues of the products on q8_gemm_tma.cuh (TmaEpilogue).
enum Epilogue : int { kQkv = 0, kQuickGeluF32 = 1, kResidual = 2 };

struct GemmArgs {
  const int8_t* a;        // (M, K) activation codes, K contiguous
  const float* a_scale;   // (M, 1) per-row scales
  const int8_t* b;        // (N, K) int8 weights, K contiguous
  const float* b_scale;   // (N,) fp32 per-output-channel scales
  const void* bias;       // (N,) of the epilogue's P
  const void* residual;   // (M, N) of the epilogue's ResT, for kResidual
  void* out[3];           // kQkv: q, k, v (M, D); else out[0] (M, N); of
                          // the epilogue's OutT (kQuickGeluF32: fp32)
  float scale;            // kQkv: the factor of the q columns
  int M, K, N, D;         // D: kQkv's column width of q, k and v
};

using activations::quick_gelu;
using activations::quick_gelu_fast;

using forms::load2;
using forms::store2;

// The epilogues over q8_gemm_tma.cuh's main loop, in the Pallas kernels'
// order of rounding. Each chunk's bias and residual are read before any of
// its stores: the compiler may not move a load past a store that could
// alias it, and loads between stores, each waiting for memory in turn, took
// longer than the tile's products. OutT and ResT are the outputs' and the
// residual's types (bf16 or float), P the bias's.
template <int EPI, typename OutT, typename ResT, typename P>
struct TmaEpilogue {
  using Args = GemmArgs;
  static constexpr int CHUNK = 8;
  template <int TILE_N>
  __device__ static void store(const Args& args,
                               const float (&acc)[TILE_N / 2], int row0,
                               int n0) {
    bool slow = false;  // kQuickGeluF32: an element needs quick_gelu
    const int M = args.M, N = args.N;
    const int tig = threadIdx.x % 4;
    // kQkv: the tile's columns lie in one of q, k, v (D % TILE_N == 0)
    const int part = EPI == kQkv ? n0 / args.D : 0;
    const int width = EPI == kQkv ? args.D : N;
    const int c0 = n0 - part * (EPI == kQkv ? args.D : 0);
#pragma unroll
    for (int j0 = 0; j0 < TILE_N / 8; j0 += CHUNK) {
      float2 bias[CHUNK], res[2][CHUNK];
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        bias[jj] = load2(static_cast<const P*>(args.bias) + n0 +
                         8 * (j0 + jj) + 2 * tig);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
#pragma unroll
        for (int jj = 0; jj < CHUNK; ++jj) {
          const size_t off = static_cast<size_t>(row) * width + c0 +
                             8 * (j0 + jj) + 2 * tig;
          res[half][jj] =
              EPI == kResidual && row < M
                  ? load2(static_cast<const ResT*>(args.residual) + off)
                  : make_float2(0.0f, 0.0f);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        if (row >= M) continue;
#pragma unroll
        for (int jj = 0; jj < CHUNK; ++jj) {
          const int j = j0 + jj;
          float v0 = __fadd_rn(acc[4 * j + 2 * half], bias[jj].x);
          float v1 = __fadd_rn(acc[4 * j + 2 * half + 1], bias[jj].y);
          const size_t off =
              static_cast<size_t>(row) * width + c0 + 8 * j + 2 * tig;
          if constexpr (EPI == kQkv) {
            if (part == 0) {
              v0 = __fmul_rn(v0, args.scale);
              v1 = __fmul_rn(v1, args.scale);
            }
            OutT* out = static_cast<OutT*>(
                part == 0 ? args.out[0]
                          : (part == 1 ? args.out[1] : args.out[2]));
            store2(out + off, v0, v1);
          } else if constexpr (EPI == kQuickGeluF32) {
            *reinterpret_cast<float2*>(static_cast<float*>(args.out[0]) +
                                       off) =
                make_float2(quick_gelu_fast(v0, slow),
                            quick_gelu_fast(v1, slow));
          } else {  // kResidual
            store2(static_cast<OutT*>(args.out[0]) + off,
                   __fadd_rn(res[half][jj].x, v0),
                   __fadd_rn(res[half][jj].y, v1));
          }
        }
      }
    }
    if constexpr (EPI == kQuickGeluF32) {
      if (slow) store_hidden_exact<TILE_N>(args, acc, row0, n0);
    }
  }

  // kQuickGeluF32's hidden of this thread again through quick_gelu (rare:
  // only where store's fast reciprocal was out of its range)
  template <int TILE_N>
  __device__ static void store_hidden_exact(const Args& args,
                                            const float (&acc)[TILE_N / 2],
                                            int row0, int n0) {
    const int tig = threadIdx.x % 4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row >= args.M) continue;
#pragma unroll
      for (int j = 0; j < TILE_N / 8; ++j) {
        const int col = n0 + 8 * j + 2 * tig;
        const float2 b = load2(static_cast<const P*>(args.bias) + col);
        *reinterpret_cast<float2*>(static_cast<float*>(args.out[0]) +
                                   static_cast<size_t>(row) * args.N + col) =
            make_float2(
                quick_gelu(__fadd_rn(acc[4 * j + 2 * half], b.x)),
                quick_gelu(__fadd_rn(acc[4 * j + 2 * half + 1], b.y)));
      }
    }
  }
};

// Counts the floats z (all 2^32) where activations.cuh's quick_gelu_fast
// differs from quick_gelu in its bits (two NaNs count as equal), used as
// this file's up-GEMM epilogue uses it (its slow case redone) or as
// vit_block.cu's does (below QUICK_GELU_FAST_FLOOR, and for NaN, the
// division instead).
__global__ void quick_gelu_check_kernel(unsigned long long* differ) {
  unsigned long long count = 0;
  for (uint64_t i = blockIdx.x * static_cast<uint64_t>(blockDim.x) +
                    threadIdx.x;
       i < (1ull << 32); i += static_cast<uint64_t>(gridDim.x) * blockDim.x) {
    const float z = __uint_as_float(static_cast<uint32_t>(i));
    bool slow = false;
    float got = quick_gelu_fast(z, slow);
    if (slow) got = quick_gelu(z);
    const float floored = z >= activations::QUICK_GELU_FAST_FLOOR
                              ? quick_gelu_fast(z, slow)
                              : quick_gelu(z);
    const float want = quick_gelu(z);
    count += __float_as_uint(got) != __float_as_uint(want) &&
             !(got != got && want != want);
    count += __float_as_uint(floored) != __float_as_uint(want) &&
             !(floored != floored && want != want);
  }
  atomicAdd(differ, count);
}

// A product on q8_gemm_tma.cuh's main loop (one contraction group; the
// blocks' widths are multiples of 128).
template <int EPI, typename OutT, typename ResT, typename P>
int tma_gemm(const GemmArgs& args, cudaStream_t stream) {
  return q8_gemm_tma::gemm<TmaEpilogue<EPI, OutT, ResT, P>, false>(
      args.a, args.a_scale, args.b, args.b_scale, args.M, args.K, args.N, 1,
      args, stream);
}

// D splits the q | k | v product's column tiles into q, k and v.
bool qkv_tiles_ok(int D) {
  return D % q8_gemm_tma::tile_width(3 * D, 1) == 0;
}

GemmArgs gemm_args(const void* a, const void* a_scale, const void* w,
                   const void* s, const void* bias, int M, int K, int N) {
  GemmArgs args{};
  args.a = static_cast<const int8_t*>(a);
  args.a_scale = static_cast<const float*>(a_scale);
  args.b = static_cast<const int8_t*>(w);
  args.b_scale = static_cast<const float*>(s);
  args.bias = bias;
  args.M = M;
  args.K = K;
  args.N = N;
  return args;
}

// The forms of the three launchers: X the activations' and outputs' type, P
// the LayerNorms' scales and biases' and the biases' (bf16 or float).

template <typename X, typename P>
int qkv_q8(const void* x, const void* ln_s, const void* ln_b,
           const void* w_qkv, const void* s_qkv, const void* b_qkv,
           void* codes, void* row_scales, void* q, void* k, void* v, int M,
           int D, float scale, float eps, cudaStream_t s) {
  int rc = row_quant<X, kLayer, P>(x, ln_s, ln_b, codes, row_scales, M, D, 1,
                                   eps, s);
  if (rc != 0) return rc;
  GemmArgs args = gemm_args(codes, row_scales, w_qkv, s_qkv, b_qkv, M, D,
                            3 * D);
  args.out[0] = q;
  args.out[1] = k;
  args.out[2] = v;
  args.scale = scale;
  args.D = D;
  return tma_gemm<kQkv, X, X, P>(args, s);
}

template <typename X, typename P>
int mlp_block_q8(const void* x, const void* ln_s, const void* ln_b,
                 const void* w_fc, const void* s_fc, const void* b_fc,
                 const void* w_proj, const void* s_proj, const void* b_proj,
                 void* codes_in, void* scales_in, void* hidden,
                 void* codes_hid, void* scales_hid, void* out, int M, int D,
                 int F, float eps, cudaStream_t s) {
  int rc = row_quant<X, kLayer, P>(x, ln_s, ln_b, codes_in, scales_in, M, D,
                                   1, eps, s);
  if (rc != 0) return rc;
  GemmArgs up = gemm_args(codes_in, scales_in, w_fc, s_fc, b_fc, M, D, F);
  up.out[0] = hidden;
  rc = tma_gemm<kQuickGeluF32, float, float, P>(up, s);
  if (rc != 0) return rc;
  rc = row_quant<float, kNone>(hidden, nullptr, nullptr, codes_hid,
                               scales_hid, M, F, 1, 0.0f, s);
  if (rc != 0) return rc;
  GemmArgs down =
      gemm_args(codes_hid, scales_hid, w_proj, s_proj, b_proj, M, F, D);
  down.out[0] = out;
  down.residual = x;
  return tma_gemm<kResidual, X, X, P>(down, s);
}

template <typename X, typename P>
int vit_block_q8(const void* x, const void* ln1_s, const void* ln1_b,
                 const void* w_qkv, const void* s_qkv, const void* b_qkv,
                 const void* wo, const void* so, const void* bo,
                 const void* ln2_s, const void* ln2_b, const void* w_fc,
                 const void* s_fc, const void* b_fc, const void* w_proj,
                 const void* s_proj, const void* b_proj, void* codes,
                 void* row_scales, void* q, void* k, void* v, void* attn,
                 void* r1, void* hidden, void* out, int B, int L, int H,
                 int dh, int F, float scale, float eps, cudaStream_t s) {
  const int M = B * L, D = H * dh;
  int rc = row_quant<X, kLayer, P>(x, ln1_s, ln1_b, codes, row_scales, M, D,
                                   1, eps, s);
  if (rc != 0) return rc;
  GemmArgs qkv = gemm_args(codes, row_scales, w_qkv, s_qkv, b_qkv, M, D,
                           3 * D);
  qkv.out[0] = q;
  qkv.out[1] = k;
  qkv.out[2] = v;
  qkv.scale = scale;
  qkv.D = D;
  rc = tma_gemm<kQkv, bf16, bf16, P>(qkv, s);  // bf16 q, k, v in every form
  if (rc != 0) return rc;
  rc = vit_attention::attention_dh<vit_attention::kNormalised, float>(
      q, k, v, attn, B, L, H, dh, s);
  if (rc != 0) return rc;
  rc = row_quant<float, kNone>(attn, nullptr, nullptr, codes, row_scales, M,
                               D, 1, 0.0f, s);
  if (rc != 0) return rc;
  GemmArgs oproj = gemm_args(codes, row_scales, wo, so, bo, M, D, D);
  oproj.out[0] = r1;
  oproj.residual = x;
  rc = tma_gemm<kResidual, float, X, P>(oproj, s);
  if (rc != 0) return rc;
  rc = row_quant<float, kLayer, P>(r1, ln2_s, ln2_b, codes, row_scales, M, D,
                                   1, eps, s);
  if (rc != 0) return rc;
  GemmArgs up = gemm_args(codes, row_scales, w_fc, s_fc, b_fc, M, D, F);
  up.out[0] = hidden;
  rc = tma_gemm<kQuickGeluF32, float, float, P>(up, s);
  if (rc != 0) return rc;
  rc = row_quant<float, kNone>(hidden, nullptr, nullptr, codes, row_scales, M,
                               F, 1, 0.0f, s);
  if (rc != 0) return rc;
  GemmArgs down =
      gemm_args(codes, row_scales, w_proj, s_proj, b_proj, M, F, D);
  down.out[0] = out;
  down.residual = r1;
  return tma_gemm<kResidual, X, float, P>(down, s);
}

}  // namespace

// Each launcher runs on `stream` and returns the first cudaError_t of its
// launches (0 on success). Scratch (codes, scales, the MLP hidden) is the
// caller's. Weights come K-major: (N, K), the transpose of the JAX layout's
// (K, N); scales are fp32 (N,). x and the outputs are bf16 (x_f32 = 0) or
// fp32 (1), the LayerNorm parameters and biases bf16 (params_f32 = 0) or
// fp32 (1).

// q, k, v (M, D) of x's dtype = LN(x (M, D)) through w_qkv (3 D, D), the q
// columns times scale.
extern "C" int fused_qkv_q8_launch(const void* x, const void* ln_s,
                                   const void* ln_b, const void* w_qkv,
                                   const void* s_qkv, const void* b_qkv,
                                   void* codes, void* row_scales, void* q,
                                   void* k, void* v, int M, int D, int x_f32,
                                   int params_f32, float scale, float eps,
                                   void* stream) {
  if (!shape_ok(M, D, 3 * D, 1) || !qkv_tiles_ok(D)) {
    return cudaErrorInvalidValue;
  }
  return XP_FORM(qkv_q8, x_f32, params_f32)(
      x, ln_s, ln_b, w_qkv, s_qkv, b_qkv, codes, row_scales, q, k, v, M, D,
      scale, eps, static_cast<cudaStream_t>(stream));
}

// out (M, D) of x's dtype = x + MLP(LN(x)) for x (M, D); w_fc (F, D) and
// w_proj (D, F). hidden is fp32 (M, F) in every form.
extern "C" int fused_mlp_block_q8_launch(
    const void* x, const void* ln_s, const void* ln_b, const void* w_fc,
    const void* s_fc, const void* b_fc, const void* w_proj,
    const void* s_proj, const void* b_proj, void* codes_in, void* scales_in,
    void* hidden, void* codes_hid, void* scales_hid, void* out, int M, int D,
    int F, int x_f32, int params_f32, float eps, void* stream) {
  if (!shape_ok(M, D, F, 1) || !shape_ok(M, F, D, 1)) {
    return cudaErrorInvalidValue;
  }
  return XP_FORM(mlp_block_q8, x_f32, params_f32)(
      x, ln_s, ln_b, w_fc, s_fc, b_fc, w_proj, s_proj, b_proj, codes_in,
      scales_in, hidden, codes_hid, scales_hid, out, M, D, F, eps,
      static_cast<cudaStream_t>(stream));
}

// differ (one uint64 on the card) += the floats where the epilogues'
// quickGELU differs from quick_gelu's correctly rounded division.
extern "C" int quick_gelu_check(void* differ, void* stream) {
  quick_gelu_check_kernel<<<132 * 8, 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(differ));
  return static_cast<int>(cudaGetLastError());
}

// out (B, L, D = H dh) of x's dtype = the whole int8 CLIP block over x (B,
// L, D): w_qkv (3 D, D), wo (D, D), w_fc (F, D), w_proj (D, F) K-major with
// their fp32 scales; ln*, bo, b_proj (D,), b_qkv (3 D,), b_fc (F,). Scratch
// of the caller: codes (M, F) int8 and row_scales (M, 1) fp32 (each
// product's input in turn), q, k, v (M, D) bf16 in every form, attn and r1
// (M, D) fp32, hidden (M, F) fp32.
extern "C" int fused_vit_block_q8_launch(
    const void* x, const void* ln1_s, const void* ln1_b, const void* w_qkv,
    const void* s_qkv, const void* b_qkv, const void* wo, const void* so,
    const void* bo, const void* ln2_s, const void* ln2_b, const void* w_fc,
    const void* s_fc, const void* b_fc, const void* w_proj,
    const void* s_proj, const void* b_proj, void* codes, void* row_scales,
    void* q, void* k, void* v, void* attn, void* r1, void* hidden, void* out,
    int B, int L, int H, int dh, int F, int x_f32, int params_f32,
    float scale, float eps, void* stream) {
  const int M = B * L, D = H * dh;
  if (!vit_attention::shape_ok(B, L, H) || !shape_ok(M, D, 3 * D, 1) ||
      !qkv_tiles_ok(D) || !shape_ok(M, D, F, 1) || !shape_ok(M, F, D, 1)) {
    return cudaErrorInvalidValue;
  }
  return XP_FORM(vit_block_q8, x_f32, params_f32)(
      x, ln1_s, ln1_b, w_qkv, s_qkv, b_qkv, wo, so, bo, ln2_s, ln2_b, w_fc,
      s_fc, b_fc, w_proj, s_proj, b_proj, codes, row_scales, q, k, v, attn,
      r1, hidden, out, B, L, H, dh, F, scale, eps,
      static_cast<cudaStream_t>(stream));
}
