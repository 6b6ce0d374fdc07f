// The attention of the whole-block kernels (csrc/vit_block.cu's
// fused_vit_block, csrc/vit_block_q8.cu, csrc/gpt2_block.cu), for NVIDIA
// Hopper (sm_90a): softmax(q k^T) v per image and head over pre-scaled bf16
// q, k, v in the (B, L, H dh) layout (no bias, no mask), in one of three
// softmax orders (the port's SOFTMAX_MODES), e = exp(s - max):
//   kFastExp      e = exp(float(bf16(s - max))); p = bf16(e);
//                 o = (p . v) / sum(e)     fused_vit_block with fast_exp
//                 (the interpret-mode Pallas kernels' rounding:
//                 XLA rounds the bf16 exponential only where a bf16 operand
//                 needs it)
//   kNormalised   p = bf16(e / sum(e)); o = p . v     fused_vit_block,
//                 fused_vit_block_q8
//   kDeferredDiv  p = bf16(e); o = (p . v) / sum(e)  fused_vit_block with
//                 deferred_div
// s and PV in fp32; o is written as OutT (bf16, or fp32 for the int8 block,
// whose Pallas kernel quantizes the unrounded attention output).
//
// MASKED (off for the ViT kernels, on for csrc/gpt2_block.cu's causal GPT-2
// attention): key j is visible to query row i only when j <= i and
// key_mask[b L + j] > 0. The Pallas kernel scores the others -1e30, whose
// exponentials after a visible key's max are exactly 0, so they get e = 0
// here. A row with no visible key gets zero probabilities and output 0; its
// caller writes the Pallas kernel's value for such a row in a pass of its
// own.
//
// A Pallas program of G images takes a (G L, G L) score matrix whose
// cross-image entries are s - 1e30: their exponentials are exactly 0 and add
// nothing to a sum or to PV, so this kernel works image by image.
//
// Design: t5_attention_core.cu's without the position bias and the key mask.
// One block of eight warps per (32 query rows, head, image), query tiles
// fastest so that the blocks of one (image, head) run together and share its
// K and V in L2. The block keeps the whole fp32 score row of its tile in
// shared memory (73.9 KB at L = 577), so the softmax takes the max, the
// exponentials, the sum and then PV in the Pallas kernels' order; the bf16
// probabilities overwrite the scores in place (kNormalised first keeps its
// fp32 exponentials there for the division). Both products run on the tensor
// cores through WMMA.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>

namespace vit_attention {

using bf16 = __nv_bfloat16;

// the values of the port's SOFTMAX_MODES (0, "bf16_sum", is
// attention_core's, in vit_attention_wgmma.cuh)
enum Softmax : int {
  kFastExp = 1,
  kNormalised = 2,
  kDeferredDiv = 3
};

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

inline int smem_limit() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  return limit;
}

// Largest sequence length whose score tile fits the current device's shared
// memory at head size dh (0 if dh is not supported).
inline int max_len(int dh) {
  if (dh != 16 && dh != 32 && dh != 64 && dh != 128) return 0;
  const long long fixed = att_smem_bytes(0, dh);
  const long long per_key = TQ * sizeof(float);
  const long long keys = (smem_limit() - fixed) / per_key;
  return keys > 0 ? static_cast<int>(keys / KC * KC) : 0;
}

// The attention grid: (query tiles, H, B), within CUDA's limits.
inline bool shape_ok(int B, int L, int H) {
  return B > 0 && L > 0 && H > 0 && B <= 65535 && H <= 65535 &&
         static_cast<long long>(B) * L <= 0x7fffffff;
}

__device__ inline void store_out(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ inline void store_out(float* p, float v) { *p = v; }

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

template <int DH, int MODE, typename OutT, bool MASKED>
__global__ void __launch_bounds__(ATT_NT)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, OutT* __restrict__ out, int L,
                 int H, const int* __restrict__ key_mask) {
  using namespace nvcuda;
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

  // ---- softmax, one warp per query row ---------------------------------
  for (int i = warp; i < TQ; i += ATT_WARPS) {
    float* srow = S + i * s_ld;
    bf16* prow = P + i * p_ld;
    const int qi = q0 + i;
    // key j counts for this row (always, unless MASKED)
    auto visible = [&](int j) {
      return !MASKED ||
             (j <= qi && key_mask[static_cast<size_t>(b) * L + j] > 0);
    };
    float m = -INFINITY;
    if (qi < L) {
      for (int j = lane; j < L; j += 32) {
        if (visible(j)) m = fmaxf(m, srow[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      }
    }
    // past the sequence, or (MASKED) no visible key: zero probabilities
    if (qi >= L || (MASKED && m == -INFINITY)) {
      __syncwarp();  // every lane has read its scores
      for (int j = lane; j < lp; j += 32) prow[j] = __float2bfloat16(0.0f);
      if (lane == 0) denom[i] = 1.0f;
      continue;
    }
    // every lane runs lp / 32 rounds; the bf16 writes of a round land on
    // scores that earlier rounds (or this round, before the __syncwarp)
    // have read
    float sum = 0.0f;
    for (int j = lane; j < lp; j += 32) {
      if (MODE == kNormalised) {  // the fp32 e stays in place for now
        if (j < L) {
          const float e = visible(j) ? expf(__fsub_rn(srow[j], m)) : 0.0f;
          srow[j] = e;
          sum = __fadd_rn(sum, e);
        }
        continue;
      }
      bf16 p = __float2bfloat16(0.0f);
      if (j < L && visible(j)) {
        if (MODE == kFastExp) {
          const float e = expf(__bfloat162float(
              __float2bfloat16(__fsub_rn(srow[j], m))));
          p = __float2bfloat16(e);
          sum = __fadd_rn(sum, e);
        } else {
          const float e = expf(__fsub_rn(srow[j], m));
          p = __float2bfloat16(e);
          sum = __fadd_rn(sum, e);
        }
      }
      __syncwarp();
      prow[j] = p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
    }
    if (MODE == kNormalised) {  // p = bf16(e / sum), over the row in place
      for (int j = lane; j < lp; j += 32) {
        const bf16 p = j < L ? __float2bfloat16(__fdiv_rn(srow[j], sum))
                             : __float2bfloat16(0.0f);
        __syncwarp();
        prow[j] = p;
      }
      sum = 1.0f;  // nothing to divide after PV
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

  // ---- the division after PV (by 1 when normalised: exact) and the store --
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
      store_out(out + head_off + static_cast<size_t>(qi) * HD + d,
                __fdiv_rn(O[i * O_LD + d], denom[i]));
    }
  }
}

template <int DH, int MODE, typename OutT, bool MASKED>
int attention(const void* q, const void* k, const void* v, void* out, int B,
              int L, int H, const int* key_mask, cudaStream_t stream) {
  const size_t smem = att_smem_bytes(L, DH);
  if (smem > static_cast<size_t>(smem_limit())) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<DH, MODE, OutT, MASKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((L + TQ - 1) / TQ, H, B);
  attention_kernel<DH, MODE, OutT, MASKED><<<grid, ATT_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<OutT*>(out), L, H, key_mask);
  return static_cast<int>(cudaGetLastError());
}

// The attention of head size dh (16, 32, 64 or 128) in softmax order MODE,
// causal and under the (B, L) int32 key_mask when MASKED; returns its
// launch's cudaError_t (0 on success).
template <int MODE, typename OutT, bool MASKED = false>
int attention_dh(const void* q, const void* k, const void* v, void* out,
                 int B, int L, int H, int dh, cudaStream_t stream,
                 const int* key_mask = nullptr) {
  if (!shape_ok(B, L, H) || (MASKED && key_mask == nullptr)) {
    return cudaErrorInvalidValue;
  }
  switch (dh) {
    case 16:
      return attention<16, MODE, OutT, MASKED>(q, k, v, out, B, L, H,
                                               key_mask, stream);
    case 32:
      return attention<32, MODE, OutT, MASKED>(q, k, v, out, B, L, H,
                                               key_mask, stream);
    case 64:
      return attention<64, MODE, OutT, MASKED>(q, k, v, out, B, L, H,
                                               key_mask, stream);
    case 128:
      return attention<128, MODE, OutT, MASKED>(q, k, v, out, B, L, H,
                                                key_mask, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace vit_attention
