// The CLIP ViT encoder block of the long-sequence "split3" path, for NVIDIA
// Hopper (sm_90a).
//
// Replaces four Pallas kernels of
// explicit_alignment_for_vqa_tasks_tpu/ops/fused_attention_block.py: the
// three programs of models/clip.py's split3 branch (:201-235)
//   fused_ln_qkv          pallas_call at :290, body :235-262
//   attention_core_oproj  pallas_call at :366, body :301-342
//   fused_mlp_block       pallas_call at :445, body :379-413
// and the attention of the long split*, fused_attention and int8 branches
//   attention_core        pallas_call at :225, body :161-200
// It computes, in the Pallas kernels' order of rounding (activations,
// weights and outputs bf16; x (M, D) with M = B L rows):
//
//   fused_ln_qkv
//     h   = bf16(LN(x))      fp32: mean m, then var = mean((x - m)^2), then
//                            ((x - m) * (1 / sqrt(var + eps))) * s + b
//     q   = bf16(((h . wq) + bq) * scale)   products accumulated in fp32,
//     k   = bf16((h . wk) + bk)             then the bias, then the scale
//     v   = bf16((h . wv) + bv)
//   attention_core, per image and head (q pre-scaled, no bias, no mask)
//     s   = q . k^T          fp32
//     p   = bf16(exp(s - rowmax(s)))        unnormalised
//     o   = bf16((p . v) / sum(float(p)))   the division after PV
//     with fast_exp: e = exp(float(bf16(s - rowmax(s)))) in fp32,
//     p = bf16(e), o = bf16((p . v) / sum(e)) (the interpret-mode Pallas
//     kernel's rounding: XLA rounds the bf16 exponential only where a bf16
//     operand needs it)
//   attention_core_oproj
//     o   = attention_core(q, k, v)
//     out = bf16(res + ((o . wo) + bo))
//   fused_mlp_block
//     h   = bf16(LN(x))
//     z   = (h . w_fc) + b_fc
//     hid = bf16(z * (1 / (1 + exp(-(1.702 z)))))   quickGELU
//     out = bf16(x + ((hid . w_proj) + b_proj))
//
// Every multiply and add of the fp32 epilogues and norms is written with
// __fmul_rn / __fadd_rn / __fsub_rn so that nvcc cannot contract them into
// FMAs that the plain PyTorch versions do not have; the square root and the
// divisions are correctly rounded and the exponentials are expf (the build
// has no --use_fast_math).
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), at
// ViT-L/14@336 with the image encoder's batch of 256 (M = 256 x 577 =
// 147,712 rows, D = 1024, 16 heads of 64, F = 4096), each input read once and
// each output written once:
//   fused_ln_qkv          929.3 GFLOP = 0.940 ms; 1.22 GB = 0.36 ms
//   attention_core_oproj  658.9 GFLOP = 0.666 ms; 1.51 GB = 0.45 ms
//   attention_core        349.1 GFLOP = 0.353 ms; 1.21 GB = 0.361 ms
//   fused_mlp_block       2,478 GFLOP = 2.506 ms; 0.62 GB = 0.19 ms
// The split3 three are bound by operations, attention_core by bytes; the
// encoder runs each of its kernels once per layer.
//
// Design (simple and right before fast). A Pallas program keeps one image's
// LN output, scores and quickGELU hidden in VMEM; here each function is a
// short pipeline of kernels whose intermediates make one round trip through
// device memory:
//   layer_norm: one block per row writes h in bf16 (302.5 MB at the main
//     shape), its fp32 row in shared memory, both sums block reductions.
//   gemm: bf16_gemm.cuh's 128 x 128 mma.sync main loop with the epilogue of
//     the stage. Bias then scale for q, k and v: blockIdx.z picks the
//     weight, bias, output and scale, so the three (D, D) weights need no
//     concatenation and one launch covers them. Bias then quickGELU for the
//     MLP's up product (the bf16 hid, 1.21 GB). Bias then residual for the
//     out-projection and the MLP's down product.
//   attention: t5_attention_core.cu's design without the position bias and
//     the key mask. One block of eight warps per (32 query rows, head,
//     image), query tiles fastest so that the blocks of one (image, head)
//     run together and share its K and V in L2. The block keeps the whole
//     fp32 score row of its tile in shared memory (73.9 KB at L = 577), so
//     the softmax takes the max, the bf16-rounded exp, the sum and then PV
//     in the Pallas kernel's order; the bf16 probabilities overwrite the
//     scores in place. Both products run on the tensor cores through WMMA.
//     It writes o in bf16 into a (B, L, D) buffer with the heads on the
//     lanes (302.5 MB), which the out-projection GEMM reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>

#include "bf16_gemm.cuh"

using namespace nvcuda;

namespace {

using namespace bf16_gemm;

// ---- layer norm -----------------------------------------------------------

// One block per row of x (D wide): h = bf16(LN(x) * s + b)
__global__ void __launch_bounds__(NT)
layer_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                  const bf16* __restrict__ bias, bf16* __restrict__ h, int D,
                  float eps) {
  extern __shared__ float row[];  // D floats
  __shared__ float red[NWARPS + 1];
  const size_t off = static_cast<size_t>(blockIdx.x) * D;
  const float width = static_cast<float>(D);
  float s = 0.0f;
  for (int i = threadIdx.x; i < D; i += NT) {
    const float v = __bfloat162float(x[off + i]);
    row[i] = v;
    s = __fadd_rn(s, v);
  }
  const float mean = __fdiv_rn(block_sum(s, red), width);
  float ss = 0.0f;
  for (int i = threadIdx.x; i < D; i += NT) {  // this thread's own row[i]
    const float d = __fsub_rn(row[i], mean);
    ss = __fadd_rn(ss, __fmul_rn(d, d));
  }
  const float var = __fdiv_rn(block_sum(ss, red), width);
  const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  for (int i = threadIdx.x; i < D; i += NT) {
    const float y = __fmul_rn(__fsub_rn(row[i], mean), r);
    h[off + i] = __float2bfloat16_rn(
        __fadd_rn(__fmul_rn(y, __bfloat162float(scale[i])),
                  __bfloat162float(bias[i])));
  }
}

int layer_norm(const void* x, const void* scale, const void* bias, void* h,
               int M, int D, float eps, cudaStream_t stream) {
  layer_norm_kernel<<<M, NT, D * sizeof(float), stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(scale),
      static_cast<const bf16*>(bias), static_cast<bf16*>(h), D, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---- GEMM with the stages' epilogues ----------------------------------------

enum Epilogue : int { kBiasScale = 0, kBiasQuickGelu = 1, kBiasResidual = 2 };

struct GemmArgs {
  const bf16* a;         // (M, K) row-major
  const bf16* b[3];      // (K, N) row-major, one per blockIdx.z
  const bf16* bias[3];   // (N,)
  bf16* out[3];          // (M, N)
  float scale[3];        // kBiasScale: the factor after the bias
  const bf16* residual;  // (M, N) for kBiasResidual
  int M, K, N;
};

__device__ inline float quick_gelu(float z) {
  // z * sigmoid(1.702 z), the sigmoid as 1 / (1 + exp(-x))
  const float e = expf(-__fmul_rn(1.702f, z));
  return __fmul_rn(z, __fdiv_rn(1.0f, __fadd_rn(1.0f, e)));
}

template <int EPI>
__global__ void __launch_bounds__(NT)
vit_gemm_kernel(const GemmArgs args) {
  extern __shared__ __align__(128) bf16 smem[];
  const int z = blockIdx.z;
  const bf16* b = z == 0 ? args.b[0] : (z == 1 ? args.b[1] : args.b[2]);
  const bf16* bias =
      z == 0 ? args.bias[0] : (z == 1 ? args.bias[1] : args.bias[2]);
  bf16* out = z == 0 ? args.out[0] : (z == 1 ? args.out[1] : args.out[2]);
  const float scale =
      z == 0 ? args.scale[0] : (z == 1 ? args.scale[1] : args.scale[2]);

  const int M = args.M, N = args.N;
  const int n0 = blockIdx.x * B_COLS, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int gid = lane >> 2, tig = lane & 3;

  float acc[4][4][4];
  mainloop<1>(smem, args.a, b, nullptr, M, args.K, N, m0, n0, acc);

  // c0, c1 are row gid, columns 2 tig and 2 tig + 1 of the n8 tile; c2, c3
  // the same columns of row gid + 8
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + warp_m * 64 + mt * 16 + gid + 8 * half;
      if (row >= M) continue;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int col = n0 + warp_n * 32 + s * 8 + 2 * tig;
        const size_t off = static_cast<size_t>(row) * N + col;
        const __nv_bfloat162 bv =
            *reinterpret_cast<const __nv_bfloat162*>(bias + col);
        float v0 = __fadd_rn(acc[mt][s][2 * half], __low2float(bv));
        float v1 = __fadd_rn(acc[mt][s][2 * half + 1], __high2float(bv));
        if constexpr (EPI == kBiasScale) {
          v0 = __fmul_rn(v0, scale);
          v1 = __fmul_rn(v1, scale);
        } else if constexpr (EPI == kBiasQuickGelu) {
          v0 = quick_gelu(v0);
          v1 = quick_gelu(v1);
        } else {  // kBiasResidual
          const __nv_bfloat162 r =
              *reinterpret_cast<const __nv_bfloat162*>(args.residual + off);
          v0 = __fadd_rn(__low2float(r), v0);
          v1 = __fadd_rn(__high2float(r), v1);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + off) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int EPI>
int gemm(const GemmArgs& args, int products, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      vit_gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      GEMM_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(args.N / B_COLS, (args.M + BM - 1) / BM, products);
  vit_gemm_kernel<EPI><<<grid, NT, GEMM_SMEM, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// The GEMMs take K and N as whole 128-wide tiles, a row grid within
// CUDA's limit, and the norm's fp32 row in 48 KB of shared memory.
bool gemm_shape_ok(int M, int D) {
  return M > 0 && D > 0 && D % B_COLS == 0 && D % BK == 0 &&
         (M + BM - 1) / BM <= 65535 &&
         static_cast<size_t>(D) * sizeof(float) <= 48 * 1024;
}

// ---- attention (no bias, no mask) -------------------------------------------

constexpr int TQ = 32;  // query rows per block
constexpr int KC = 64;  // keys per staged K / V chunk
constexpr int ATT_WARPS = 8;
constexpr int ATT_NT = ATT_WARPS * 32;
// Row padding of the shared-memory tiles (in elements), so that the rows of
// a 16 x 16 WMMA tile start in different banks.
constexpr int S_PAD = 4;    // fp32 score rows
constexpr int ROW_PAD = 8;  // bf16 q / k / v rows

__host__ __device__ inline int padded_len(int L) {
  return (L + KC - 1) / KC * KC;
}

inline size_t att_smem_bytes(int L, int dh) {
  const size_t lp = padded_len(L);
  return TQ * (lp + S_PAD) * sizeof(float)     // scores, then probabilities
         + TQ * (dh + ROW_PAD) * sizeof(bf16)  // q tile
         + KC * (dh + ROW_PAD) * sizeof(bf16)  // k or v chunk
         + TQ * sizeof(float);                 // denominators
}

// ROWS rows of one head (DH bf16 each) held in registers between their
// 16-byte loads from global memory and their store to shared memory as
// dst[ROWS][DH + ROW_PAD]; rows at or past L are zero. For K and V this
// keeps the next chunk's loads in flight while the tensor cores work on
// the current one.
template <int DH, int ROWS>
struct ChunkRegs {
  static constexpr int VEC = 8;
  static constexpr int PER_ROW = DH / VEC;
  static constexpr int COUNT = ROWS * PER_ROW;
  static constexpr int PER_THREAD = (COUNT + ATT_NT - 1) / ATT_NT;
  uint4 val[PER_THREAD];

  __device__ inline void fetch(const bf16* src, int row0, int L,
                               int row_stride) {
#pragma unroll
    for (int u = 0; u < PER_THREAD; ++u) {
      const int idx = threadIdx.x + u * ATT_NT;
      const int r = idx / PER_ROW, c = idx % PER_ROW;
      val[u] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < COUNT && row0 + r < L) {
        val[u] = *reinterpret_cast<const uint4*>(
            src + static_cast<size_t>(row0 + r) * row_stride + c * VEC);
      }
    }
  }

  __device__ inline void store(bf16* dst) const {
#pragma unroll
    for (int u = 0; u < PER_THREAD; ++u) {
      const int idx = threadIdx.x + u * ATT_NT;
      if (idx < COUNT) {
        const int r = idx / PER_ROW, c = idx % PER_ROW;
        *reinterpret_cast<uint4*>(dst + r * (DH + ROW_PAD) + c * VEC) = val[u];
      }
    }
  }
};

template <int DH, bool FAST_EXP>
__global__ void __launch_bounds__(ATT_NT)
vit_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     int L, int H) {
  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lp = padded_len(L);
  const int HD = H * DH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t head_off =
      static_cast<size_t>(b) * L * HD + static_cast<size_t>(h) * DH;

  extern __shared__ __align__(128) unsigned char att_smem[];
  constexpr int QK_LD = DH + ROW_PAD;
  const int s_ld = lp + S_PAD;
  float* S = reinterpret_cast<float*>(att_smem);
  // probabilities: row i's bf16 values sit at the start of score row i
  bf16* P = reinterpret_cast<bf16*>(S);
  const int p_ld = 2 * s_ld;
  bf16* Qs = reinterpret_cast<bf16*>(S + TQ * s_ld);
  bf16* KV = Qs + TQ * QK_LD;
  float* denom = reinterpret_cast<float*>(KV + KC * QK_LD);

  {
    ChunkRegs<DH, TQ> q_tile;
    q_tile.fetch(q + head_off, q0, L, HD);
    q_tile.store(Qs);
  }

  // ---- scores: S[TQ][lp] = q k^T in fp32 (keys past L score 0, unread) ---
  constexpr int S_TILES = (TQ / 16) * (KC / 16);
  ChunkRegs<DH, KC> chunk;
  chunk.fetch(k + head_off, 0, L, HD);
  for (int kc = 0; kc < lp; kc += KC) {
    __syncthreads();  // the previous chunk has been consumed
    chunk.store(KV);
    if (kc + KC < lp) chunk.fetch(k + head_off, kc + KC, L, HD);
    __syncthreads();
    for (int t = warp; t < S_TILES; t += ATT_WARPS) {
      const int tr = t / (KC / 16), tc = t % (KC / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int d = 0; d < DH; d += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        // K stored [key][d] is k^T in column-major order
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + tr * 16 * QK_LD + d, QK_LD);
        wmma::load_matrix_sync(fb, KV + tc * 16 * QK_LD + d, QK_LD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(S + tr * 16 * s_ld + kc + tc * 16, acc, s_ld,
                              wmma::mem_row_major);
    }
  }
  chunk.fetch(v + head_off, 0, L, HD);  // in flight during the softmax
  __syncthreads();

  // ---- softmax statistics, one warp per query row ---------------------
  for (int i = warp; i < TQ; i += ATT_WARPS) {
    float* srow = S + i * s_ld;
    bf16* prow = P + i * p_ld;
    if (q0 + i >= L) {  // past the sequence: no output, zero probabilities
      for (int j = lane; j < lp; j += 32) prow[j] = __float2bfloat16(0.0f);
      if (lane == 0) denom[i] = 1.0f;
      continue;
    }
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, srow[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    // every lane runs lp / 32 rounds; the bf16 writes of a round land on
    // scores that earlier rounds (or this round, before the __syncwarp)
    // have read
    float sum = 0.0f;
    for (int j = lane; j < lp; j += 32) {
      bf16 p = __float2bfloat16(0.0f);
      if (j < L) {
        if (FAST_EXP) {  // the sum takes the unrounded exponential
          const float e = expf(__bfloat162float(
              __float2bfloat16(__fsub_rn(srow[j], m))));
          p = __float2bfloat16(e);
          sum = __fadd_rn(sum, e);
        } else {
          p = __float2bfloat16(expf(__fsub_rn(srow[j], m)));
          sum = __fadd_rn(sum, __bfloat162float(p));
        }
      }
      __syncwarp();
      prow[j] = p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
    }
    if (lane == 0) denom[i] = sum;
  }
  __syncthreads();

  // ---- o = p v in fp32, accumulated over key chunks --------------------
  constexpr int O_TILES = (TQ / 16) * (DH / 16);
  constexpr int PER_WARP = (O_TILES + ATT_WARPS - 1) / ATT_WARPS;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[PER_WARP];
#pragma unroll
  for (int u = 0; u < PER_WARP; ++u) wmma::fill_fragment(oacc[u], 0.0f);
  for (int kc = 0; kc < lp; kc += KC) {
    chunk.store(KV);
    if (kc + KC < lp) chunk.fetch(v + head_off, kc + KC, L, HD);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < PER_WARP; ++u) {
      const int t = warp + u * ATT_WARPS;
      if (t < O_TILES) {
        const int tr = t / (DH / 16), tc = t % (DH / 16);
#pragma unroll
        for (int kk = 0; kk < KC; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, P + tr * 16 * p_ld + kc + kk, p_ld);
          wmma::load_matrix_sync(fb, KV + kk * QK_LD + tc * 16, QK_LD);
          wmma::mma_sync(oacc[u], fa, fb, oacc[u]);
        }
      }
    }
    __syncthreads();  // the chunk has been consumed
  }

  // ---- the division after PV and the bf16 store --------------------------
  constexpr int O_LD = DH + S_PAD;
  float* O = S;  // the probabilities are no longer needed
#pragma unroll
  for (int u = 0; u < PER_WARP; ++u) {
    const int t = warp + u * ATT_WARPS;
    if (t < O_TILES) {
      const int tr = t / (DH / 16), tc = t % (DH / 16);
      wmma::store_matrix_sync(O + tr * 16 * O_LD + tc * 16, oacc[u], O_LD,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TQ * DH; idx += ATT_NT) {
    const int i = idx / DH, d = idx % DH;
    const int qi = q0 + i;
    if (qi < L) {
      out[head_off + static_cast<size_t>(qi) * HD + d] =
          __float2bfloat16(__fdiv_rn(O[i * O_LD + d], denom[i]));
    }
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

template <int DH, bool FAST_EXP>
int attention(const void* q, const void* k, const void* v, void* out, int B,
              int L, int H, cudaStream_t stream) {
  const size_t smem = att_smem_bytes(L, DH);
  if (smem > static_cast<size_t>(smem_limit())) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      vit_attention_kernel<DH, FAST_EXP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((L + TQ - 1) / TQ, H, B);
  vit_attention_kernel<DH, FAST_EXP><<<grid, ATT_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), L, H);
  return static_cast<int>(cudaGetLastError());
}

template <bool FAST_EXP>
int attention_dh(const void* q, const void* k, const void* v, void* out,
                 int B, int L, int H, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return attention<16, FAST_EXP>(q, k, v, out, B, L, H, stream);
    case 32: return attention<32, FAST_EXP>(q, k, v, out, B, L, H, stream);
    case 64: return attention<64, FAST_EXP>(q, k, v, out, B, L, H, stream);
    case 128: return attention<128, FAST_EXP>(q, k, v, out, B, L, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The attention grid: (query tiles, H, B), within CUDA's limits.
bool attention_shape_ok(int B, int L, int H) {
  return B > 0 && L > 0 && H > 0 && B <= 65535 && H <= 65535 &&
         static_cast<long long>(B) * L <= 0x7fffffff;
}

}  // namespace

// Largest sequence length whose score tile fits the current device's shared
// memory at head size dh (0 if dh is not supported).
extern "C" int vit_attention_max_len(int dh) {
  if (dh != 16 && dh != 32 && dh != 64 && dh != 128) return 0;
  const long long fixed = att_smem_bytes(0, dh);
  const long long per_key = TQ * sizeof(float);
  const long long keys = (smem_limit() - fixed) / per_key;
  return keys > 0 ? static_cast<int>(keys / KC * KC) : 0;
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
  if (!gemm_shape_ok(M, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = layer_norm(x, ln_s, ln_b, h, M, D, eps, s);
  if (rc != 0) return rc;
  GemmArgs g{};
  g.a = static_cast<const bf16*>(h);
  const void* w[3] = {wq, wk, wv};
  const void* b[3] = {bq, bk, bv};
  void* o[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    g.b[i] = static_cast<const bf16*>(w[i]);
    g.bias[i] = static_cast<const bf16*>(b[i]);
    g.out[i] = static_cast<bf16*>(o[i]);
    g.scale[i] = i == 0 ? scale : 1.0f;
  }
  g.M = M;
  g.K = D;
  g.N = D;
  return gemm<kBiasScale>(g, 3, s);
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
  if (!attention_shape_ok(B, L, H) || !gemm_shape_ok(B * L, H * dh)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = attention_dh<false>(q, k, v, attn, B, L, H, dh, s);
  if (rc != 0) return rc;
  GemmArgs g{};
  g.a = static_cast<const bf16*>(attn);
  g.b[0] = static_cast<const bf16*>(wo);
  g.bias[0] = static_cast<const bf16*>(bo);
  g.out[0] = static_cast<bf16*>(out);
  g.residual = static_cast<const bf16*>(res);
  g.M = B * L;
  g.K = H * dh;
  g.N = H * dh;
  return gemm<kBiasResidual>(g, 1, s);
}

// out (B, L, H dh) bf16 = softmax(q k^T) v per head for q (pre-scaled), k,
// v (B, L, H dh) bf16; the exponential of bf16(s - max) when fast_exp is
// not 0. Runs on `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int attention_core_launch(const void* q, const void* k,
                                     const void* v, void* out, int B, int L,
                                     int H, int dh, int fast_exp,
                                     void* stream) {
  if (!attention_shape_ok(B, L, H)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast_exp ? attention_dh<true>(q, k, v, out, B, L, H, dh, s)
                  : attention_dh<false>(q, k, v, out, B, L, H, dh, s);
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
  if (!gemm_shape_ok(M, D) || F <= 0 || F % B_COLS || F % BK) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = layer_norm(x, ln_s, ln_b, h, M, D, eps, s);
  if (rc != 0) return rc;
  GemmArgs up{};
  up.a = static_cast<const bf16*>(h);
  up.b[0] = static_cast<const bf16*>(w_fc);
  up.bias[0] = static_cast<const bf16*>(b_fc);
  up.out[0] = static_cast<bf16*>(hidden);
  up.M = M;
  up.K = D;
  up.N = F;
  rc = gemm<kBiasQuickGelu>(up, 1, s);
  if (rc != 0) return rc;
  GemmArgs down{};
  down.a = static_cast<const bf16*>(hidden);
  down.b[0] = static_cast<const bf16*>(w_proj);
  down.bias[0] = static_cast<const bf16*>(b_proj);
  down.out[0] = static_cast<bf16*>(out);
  down.residual = static_cast<const bf16*>(x);
  down.M = M;
  down.K = F;
  down.N = D;
  return gemm<kBiasResidual>(down, 1, s);
}
