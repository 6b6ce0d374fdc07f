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
// that layout; bias is (H, L, L) fp32; mask is (B, L) int32.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at the
// main path's B=32, L=557, H=32, dh=64 the function must move q, k, v and o
// (4 x 73.0 MB) plus the bias (39.7 MB), about 332 MB, which is 0.099 ms;
// it does 4*B*H*L^2*dh = 81 GFLOP, which is 0.082 ms. So it is memory-bound
// at about 0.10 ms per launch, and the encoder launches it 24 times.
//
// Design (a simple kernel, right before fast): one block of eight warps
// per (batch row, tile of 32 query rows, head). The block keeps the whole
// fp32 score row of its tile in dynamic shared memory, so the softmax takes
// the max, the bf16-rounded exp, the sum and then PV exactly in the TPU
// kernel's order; an online (flash-style) rescale would round differently.
// The bf16 probabilities overwrite the scores in place (row by row, behind
// the reads), which halves the shared memory a block needs so that two
// blocks fit on an SM. Both products run on the tensor cores through WMMA
// (bf16 in, fp32 accumulate). The batch is the fastest grid axis, so the
// blocks that share a (head, query tile) of the bias run together and find
// it in L2. The score row limits the length: t5_attention_core_max_len
// gives the largest L that fits (1600 at dh=64 with the H100's 227 KB of
// shared memory per block).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int TQ = 32;  // query rows per block
constexpr int KC = 64;  // keys per staged K / V chunk
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr float MASK_NEG = -1e9f;
// Row padding of the shared-memory tiles (in elements), so that the rows of
// a 16 x 16 WMMA tile start in different banks.
constexpr int S_PAD = 4;    // fp32 score rows
constexpr int ROW_PAD = 8;  // bf16 q / k / v rows

using bf16 = __nv_bfloat16;

__host__ __device__ inline int padded_len(int L) {
  return (L + KC - 1) / KC * KC;
}

inline size_t smem_bytes(int L, int dh) {
  const size_t lp = padded_len(L);
  return TQ * (lp + S_PAD) * sizeof(float)   // scores, then probabilities
         + lp * sizeof(float)                // key mask as an additive bias
         + TQ * (dh + ROW_PAD) * sizeof(bf16)  // q tile
         + KC * (dh + ROW_PAD) * sizeof(bf16)  // k or v chunk
         + TQ * sizeof(float);               // denominators
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
  static constexpr int PER_THREAD = (COUNT + NTHREADS - 1) / NTHREADS;
  uint4 val[PER_THREAD];

  __device__ inline void fetch(const bf16* src, int row0, int L,
                               int row_stride) {
#pragma unroll
    for (int u = 0; u < PER_THREAD; ++u) {
      const int idx = threadIdx.x + u * NTHREADS;
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
      const int idx = threadIdx.x + u * NTHREADS;
      if (idx < COUNT) {
        const int r = idx / PER_ROW, c = idx % PER_ROW;
        *reinterpret_cast<uint4*>(dst + r * (DH + ROW_PAD) + c * VEC) = val[u];
      }
    }
  }
};

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
t5_attention_core_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const float* __restrict__ bias,
                         const int* __restrict__ mask,
                         bf16* __restrict__ out, int L, int H) {
  const int b = blockIdx.x;
  const int q0 = blockIdx.y * TQ;
  const int h = blockIdx.z;
  const int lp = padded_len(L);
  const int HD = H * DH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t head_off =
      static_cast<size_t>(b) * L * HD + static_cast<size_t>(h) * DH;

  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int QK_LD = DH + ROW_PAD;
  const int s_ld = lp + S_PAD;
  float* S = reinterpret_cast<float*>(smem);
  // probabilities: row i's bf16 values sit at the start of score row i
  bf16* P = reinterpret_cast<bf16*>(S);
  const int p_ld = 2 * s_ld;
  float* key_bias = S + TQ * s_ld;
  bf16* Qs = reinterpret_cast<bf16*>(key_bias + lp);
  bf16* KV = Qs + TQ * QK_LD;
  float* denom = reinterpret_cast<float*>(KV + KC * QK_LD);

  const int* mask_b = mask + static_cast<size_t>(b) * L;
  for (int j = threadIdx.x; j < lp; j += NTHREADS) {
    key_bias[j] = (j < L && mask_b[j] > 0) ? 0.0f : MASK_NEG;
  }
  {
    ChunkRegs<DH, TQ> q_tile;
    q_tile.fetch(q + head_off, q0, L, HD);
    q_tile.store(Qs);
  }

  // ---- scores: S[TQ][lp] = q k^T in fp32 --------------------------------
  constexpr int S_TILES = (TQ / 16) * (KC / 16);
  ChunkRegs<DH, KC> chunk;
  chunk.fetch(k + head_off, 0, L, HD);
  for (int kc = 0; kc < lp; kc += KC) {
    __syncthreads();  // the previous chunk has been consumed
    chunk.store(KV);
    if (kc + KC < lp) chunk.fetch(k + head_off, kc + KC, L, HD);
    __syncthreads();
    for (int t = warp; t < S_TILES; t += NWARPS) {
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
  const float* bias_h = bias + static_cast<size_t>(h) * L * L;
  for (int i = warp; i < TQ; i += NWARPS) {
    const int qi = q0 + i;
    float* srow = S + i * s_ld;
    bf16* prow = P + i * p_ld;
    if (qi >= L) {  // past the sequence: no output, zero probabilities
      for (int j = lane; j < lp; j += 32) prow[j] = __float2bfloat16(0.0f);
      if (lane == 0) denom[i] = 1.0f;
      continue;
    }
    const float* brow = bias_h + static_cast<size_t>(qi) * L;
    float m = -INFINITY;
    // the bias loads of a group are all issued before any is used
    constexpr int GROUP = 8;
    for (int j0 = lane; j0 < L; j0 += 32 * GROUP) {
      float bv[GROUP];
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        const int j = j0 + 32 * u;
        bv[u] = j < L ? __ldg(brow + j) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        const int j = j0 + 32 * u;
        if (j < L) {
          const float s = (srow[j] + bv[u]) + key_bias[j];
          srow[j] = s;
          m = fmaxf(m, s);
        }
      }
    }
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
        p = __float2bfloat16(expf(srow[j] - m));
        sum += __bfloat162float(p);
      }
      __syncwarp();
      prow[j] = p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    if (lane == 0) denom[i] = sum;
  }
  __syncthreads();

  // ---- o = p v in fp32, accumulated over key chunks --------------------
  constexpr int O_TILES = (TQ / 16) * (DH / 16);
  constexpr int PER_WARP = (O_TILES + NWARPS - 1) / NWARPS;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[PER_WARP];
#pragma unroll
  for (int u = 0; u < PER_WARP; ++u) wmma::fill_fragment(oacc[u], 0.0f);
  for (int kc = 0; kc < lp; kc += KC) {
    chunk.store(KV);
    if (kc + KC < lp) chunk.fetch(v + head_off, kc + KC, L, HD);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < PER_WARP; ++u) {
      const int t = warp + u * NWARPS;
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

  // ---- deferred division and the bf16 store ----------------------------
  constexpr int O_LD = DH + S_PAD;
  float* O = S;  // the probabilities are no longer needed
#pragma unroll
  for (int u = 0; u < PER_WARP; ++u) {
    const int t = warp + u * NWARPS;
    if (t < O_TILES) {
      const int tr = t / (DH / 16), tc = t % (DH / 16);
      wmma::store_matrix_sync(O + tr * 16 * O_LD + tc * 16, oacc[u], O_LD,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TQ * DH; idx += NTHREADS) {
    const int i = idx / DH, d = idx % DH;
    const int qi = q0 + i;
    if (qi < L) {
      out[head_off + static_cast<size_t>(qi) * HD + d] =
          __float2bfloat16(O[i * O_LD + d] / denom[i]);
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

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* mask, void* out, int B, int L, int H,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(L, DH);
  if (smem > static_cast<size_t>(smem_limit())) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      t5_attention_core_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (L + TQ - 1) / TQ, H);
  t5_attention_core_kernel<DH><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(mask), static_cast<bf16*>(out), L, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Largest sequence length whose score tile fits the current device's shared
// memory at head size dh (0 if dh is not supported).
extern "C" int t5_attention_core_max_len(int dh) {
  if (dh != 16 && dh != 32 && dh != 64 && dh != 128) return 0;
  const long long fixed = smem_bytes(0, dh);
  const long long per_key = (TQ + 1) * sizeof(float);
  const long long keys = (smem_limit() - fixed) / per_key;
  return keys > 0 ? static_cast<int>(keys / KC * KC) : 0;
}

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
extern "C" int t5_attention_core_launch(const void* q, const void* k,
                                        const void* v, const void* bias,
                                        const void* mask, void* out, int B,
                                        int L, int H, int dh, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || H > 65535 ||
      (L + TQ - 1) / TQ > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch<16>(q, k, v, bias, mask, out, B, L, H, s);
    case 32: return launch<32>(q, k, v, bias, mask, out, B, L, H, s);
    case 64: return launch<64>(q, k, v, bias, mask, out, B, L, H, s);
    case 128: return launch<128>(q, k, v, bias, mask, out, B, L, H, s);
    default: return cudaErrorInvalidValue;
  }
}
