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
// Route. q and k hold bf16 values, so every product q k is exact in fp32:
// the scores run on the tensor cores (WMMA, bf16 in, fp32 accumulate). The
// exponentials e stay fp32, unrounded; each 64-key chunk of them is split
// into three bf16 planes, hi = bf16(e), mid = bf16(e - hi), lo = bf16(e -
// hi - mid), whose sum is e exactly, and PV is three bf16 products with v
// (each product exact in fp32), accumulated apart and added lo + mid, then
// + hi, so that no plane's small terms are lost against a larger running
// sum.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), each
// input read once and each output written once. At ViT-L/14@336 with the
// image encoder's batch of 256 (B = 256, L = 577, 16 heads of 64, no bias):
// the bytes are q, k, v and o, 4 x 302.5 MB = 1.21 GB = 0.361 ms; the
// operations of this route are q k^T, 174.6 GFLOP, and PV as three bf16
// products, 3 x 174.6 GFLOP: 698.2 GFLOP = 0.706 ms. Bound by operations on
// this route (by bytes, 0.361 ms, with PV as one product).
//
// Design (simple and right before fast): csrc/vit_attention.cuh's. One
// block of eight warps per (32 query rows, head, image), query tiles
// fastest so that the blocks of one (image, head) run together and share its
// K and V in L2. The block keeps the whole fp32 score row of its tile in
// shared memory (82.4 KB at Lk = 577), so that the softmax takes the max,
// the exponentials and the sum in the Pallas kernel's order before PV.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TQ = 32;  // query rows per block
constexpr int KC = 64;  // keys per staged K / V chunk
constexpr int WARPS = 8;
constexpr int NT = WARPS * 32;
constexpr int S_PAD = 4;    // fp32 score rows (elements)
constexpr int ROW_PAD = 8;  // bf16 q / k / v / plane rows (elements)
constexpr int PLANES = 3;   // lo, mid, hi
constexpr float PAD_SCORE = -1e9f;

__host__ __device__ inline int padded_len(int L) {
  return (L + KC - 1) / KC * KC;
}

size_t smem_bytes(int Lk, int dh) {
  const size_t lp = padded_len(Lk);
  return TQ * (lp + S_PAD) * sizeof(float)               // scores, then e
         + TQ * (dh + ROW_PAD) * sizeof(bf16)            // q tile
         + KC * (dh + ROW_PAD) * sizeof(bf16)            // k or v chunk
         + PLANES * TQ * (KC + ROW_PAD) * sizeof(bf16)   // e's planes
         + TQ * sizeof(float);                           // denominators
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

// ROWS rows of one head (DH bf16 each, row stride `stride`) from row0 on,
// zero past L, into dst[ROWS][DH + ROW_PAD], 16 bytes a thread at a time.
template <int DH, int ROWS>
__device__ inline void load_rows(bf16* dst, const bf16* src, int row0, int L,
                                 int stride) {
  constexpr int PER_ROW = DH / 8;
  for (int idx = threadIdx.x; idx < ROWS * PER_ROW; idx += NT) {
    const int r = idx / PER_ROW, c = idx % PER_ROW;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L) {
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * stride + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * (DH + ROW_PAD) + c * 8) = val;
  }
}

template <int DH>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const float* __restrict__ bias,
                       bf16* __restrict__ out, int Lq, int Lk, int H,
                       int n_pad, long long sb, long long sh, long long sq,
                       long long sk) {
  using namespace nvcuda;
  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lp = padded_len(Lk);
  const int HD = H * DH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t q_off =
      static_cast<size_t>(b) * Lq * HD + static_cast<size_t>(h) * DH;
  const size_t kv_off =
      static_cast<size_t>(b) * Lk * HD + static_cast<size_t>(h) * DH;

  extern __shared__ __align__(128) unsigned char fa_smem[];
  constexpr int QK_LD = DH + ROW_PAD;
  constexpr int PL_LD = KC + ROW_PAD;
  const int s_ld = lp + S_PAD;
  float* S = reinterpret_cast<float*>(fa_smem);
  bf16* Qs = reinterpret_cast<bf16*>(S + TQ * s_ld);
  bf16* KV = Qs + TQ * QK_LD;
  bf16* Pl = KV + KC * QK_LD;  // [PLANES][TQ][PL_LD]: lo, mid, hi
  float* denom = reinterpret_cast<float*>(Pl + PLANES * TQ * PL_LD);

  load_rows<DH, TQ>(Qs, q + q_off, q0, Lq, HD);

  // ---- scores: S[TQ][lp] = q k^T in fp32 (keys past Lk are 0, unread) ----
  constexpr int S_TILES = (TQ / 16) * (KC / 16);
  for (int kc = 0; kc < lp; kc += KC) {
    __syncthreads();  // the previous chunk has been consumed
    load_rows<DH, KC>(KV, k + kv_off, kc, Lk, HD);
    __syncthreads();
    for (int t = warp; t < S_TILES; t += WARPS) {
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
  __syncthreads();

  // ---- softmax, one warp per query row: e = exp(s + bias - m) in place ----
  for (int i = warp; i < TQ; i += WARPS) {
    float* srow = S + i * s_ld;
    const int qi = q0 + i;
    if (qi >= Lq) {  // past the sequence: no output, zero e
      for (int j = lane; j < lp; j += 32) srow[j] = 0.0f;
      if (lane == 0) denom[i] = 1.0f;
      continue;
    }
    const float* brow =
        bias == nullptr ? nullptr : bias + b * sb + h * sh + qi * sq;
    float m = n_pad > 0 ? PAD_SCORE : -INFINITY;
    for (int j = lane; j < Lk; j += 32) {
      float s = srow[j];
      if (brow != nullptr) s = __fadd_rn(s, brow[j * sk]);
      srow[j] = s;
      m = fmaxf(m, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    float sum = 0.0f;
    for (int j = lane; j < lp; j += 32) {
      const float e = j < Lk ? expf(__fsub_rn(srow[j], m)) : 0.0f;
      srow[j] = e;
      sum = __fadd_rn(sum, e);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
    }
    if (n_pad > 0) {  // the padded keys' exp(-1e9 - m), each v = 0
      sum = __fadd_rn(sum, __fmul_rn(static_cast<float>(n_pad),
                                     expf(__fsub_rn(PAD_SCORE, m))));
    }
    if (lane == 0) denom[i] = sum;
  }

  // ---- o = e v in fp32 over key chunks, e as three exact bf16 planes ----
  constexpr int O_TILES = (TQ / 16) * (DH / 16);
  constexpr int PER_WARP = (O_TILES + WARPS - 1) / WARPS;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[PER_WARP][PLANES];
#pragma unroll
  for (int u = 0; u < PER_WARP; ++u)
#pragma unroll
    for (int pl = 0; pl < PLANES; ++pl) wmma::fill_fragment(oacc[u][pl], 0.0f);
  for (int kc = 0; kc < lp; kc += KC) {
    __syncthreads();  // the softmax, or the previous chunk, is done
    load_rows<DH, KC>(KV, v + kv_off, kc, Lk, HD);
    for (int idx = threadIdx.x; idx < TQ * KC; idx += NT) {
      const int r = idx / KC, c = idx % KC;
      const float e = S[r * s_ld + kc + c];
      const bf16 hi = __float2bfloat16(e);
      const float rest = __fsub_rn(e, __bfloat162float(hi));
      const bf16 mid = __float2bfloat16(rest);
      Pl[r * PL_LD + c] =
          __float2bfloat16(__fsub_rn(rest, __bfloat162float(mid)));
      Pl[(TQ + r) * PL_LD + c] = mid;
      Pl[(2 * TQ + r) * PL_LD + c] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < PER_WARP; ++u) {
      const int t = warp + u * WARPS;
      if (t < O_TILES) {
        const int tr = t / (DH / 16), tc = t % (DH / 16);
#pragma unroll
        for (int kk = 0; kk < KC; kk += 16) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, KV + kk * QK_LD + tc * 16, QK_LD);
#pragma unroll
          for (int pl = 0; pl < PLANES; ++pl) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
                fa;
            wmma::load_matrix_sync(
                fa, Pl + (pl * TQ + tr * 16) * PL_LD + kk, PL_LD);
            wmma::mma_sync(oacc[u][pl], fa, fb, oacc[u][pl]);
          }
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the scores and the planes

  // ---- (lo + mid) + hi, the division by the fp32 sum, the store ----------
  constexpr int O_LD = DH + S_PAD;
  float* O = S;
#pragma unroll
  for (int u = 0; u < PER_WARP; ++u) {
    const int t = warp + u * WARPS;
    if (t < O_TILES) {
      const int tr = t / (DH / 16), tc = t % (DH / 16);
      // fragments of one type share their element layout
      for (int e = 0; e < oacc[u][0].num_elements; ++e) {
        oacc[u][2].x[e] = __fadd_rn(
            __fadd_rn(oacc[u][0].x[e], oacc[u][1].x[e]), oacc[u][2].x[e]);
      }
      wmma::store_matrix_sync(O + tr * 16 * O_LD + tc * 16, oacc[u][2], O_LD,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TQ * DH; idx += NT) {
    const int i = idx / DH, d = idx % DH;
    const int qi = q0 + i;
    if (qi < Lq) {
      out[q_off + static_cast<size_t>(qi) * HD + d] =
          __float2bfloat16(__fdiv_rn(O[i * O_LD + d], denom[i]));
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int B, int Lq, int Lk, int H, int n_pad, long long sb,
           long long sh, long long sq, long long sk, cudaStream_t stream) {
  const size_t smem = smem_bytes(Lk, DH);
  if (smem > static_cast<size_t>(smem_limit())) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + TQ - 1) / TQ, H, B);
  flash_attention_kernel<DH><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(out), Lq, Lk, H, n_pad, sb, sh, sq, sk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Largest key length whose score tile fits the current device's shared
// memory at head size dh (0 if dh is not supported).
extern "C" int flash_attention_max_len(int dh) {
  if (dh != 16 && dh != 32 && dh != 64 && dh != 128) return 0;
  const long long fixed = smem_bytes(0, dh);
  const long long per_key = TQ * sizeof(float);
  const long long keys = (smem_limit() - fixed) / per_key;
  return keys > 0 ? static_cast<int>(keys / KC * KC) : 0;
}

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
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || n_pad < 0 || B > 65535 ||
      H > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16:
      return launch<16>(q, k, v, bias, out, B, Lq, Lk, H, n_pad, sb, sh, sq,
                        sk, s);
    case 32:
      return launch<32>(q, k, v, bias, out, B, Lq, Lk, H, n_pad, sb, sh, sq,
                        sk, s);
    case 64:
      return launch<64>(q, k, v, bias, out, B, Lq, Lk, H, n_pad, sb, sh, sq,
                        sk, s);
    case 128:
      return launch<128>(q, k, v, bias, out, B, Lq, Lk, H, n_pad, sb, sh, sq,
                         sk, s);
    default: return cudaErrorInvalidValue;
  }
}
