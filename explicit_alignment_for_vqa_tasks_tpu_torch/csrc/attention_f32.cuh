// fp32 attention on the CUDA cores, in the Pallas kernels' order, for NVIDIA
// Hopper (sm_90a): t5_attention_core's fp32 form (t5_attention_core.cu),
// the fp32 forms of the ViT attention_core and attention_core_oproj
// (vit_block.cu), fused_attention_block's attention above 128 tokens
// (attention_block.cu) and flash_attention's fp32 form
// (flash_attention.cu), with an optional scale, an optional additive bias
// with four strides, an optional key mask, padded keys, Lq != Lk, the
// fast_exp exponential and an output as three bf16 planes.
//
// For batch row b, head h, query row i and key j, in this order:
//
//   s     = (q_i . k_j) * scale        the dot over dh in order (fmaf), fp32
//   s     = s + bias[b, h, i, j]       where there is a bias
//   s     = s + (mask[b, j] > 0 ? 0 : -1e9)   where there is a key mask
//   m     = max_j s                    the WHOLE row's max before any exp,
//                                      with -1e9 where there are n_pad
//                                      padded keys
//   p     = exp(s - m)                 fp32, never rounded; with fast_exp
//                                      exp(bf16(s - m)), the exponential of
//                                      the rounded argument in fp32
//   denom = sum_j p                    unnormalised, plus n_pad
//                                      exp(-1e9 - m) for the padded keys
//   o     = (sum_j p v_j) / denom      the division after P . V
//
// which is JAX's _make_t5_core_kernel (ops/fused_attention_block.py:1105-1131)
// and _make_core_kernel (:161-200) on fp32 operands: no online-softmax
// rescale, whose order differs. Every multiply and add outside the dots is
// __fmul_rn / __fadd_rn, so that nvcc contracts nothing the plain PyTorch
// version does not have. o goes out in fp32, or (planes set) as three bf16
// planes lo | mid | hi of a (B Lq, 3 ldo) matrix, hi = bf16(o), mid =
// bf16(o - hi), lo = bf16(o - hi - mid), whose sum is o exactly: the A
// operand of a bf16 tensor-core product that reads its weight three times
// along K (attention_core_oproj's fp32 out-projection).
//
// Two routes, chosen by Lk alone (held_smem_bytes; the wrapper reckons the
// same bytes from the same constants, and launch_held refuses an Lk whose
// rows do not fit), and at head size 64 a third, the held route with K in
// the score rows (held_ks_smem_bytes: Lk <= 640, ViT-L/14@336's 577 among
// them), which the ViT wrappers take where the held route does not fit:
//
// The held route (attention_f32_held_kernel), where a block's score rows fit
// its shared memory, as the TPU kernel holds its (L, L) score block in VMEM:
// a block of 256 threads takes HELD_ROWS = 64 query rows of one (b, h) and
// keeps their fp32 scores over all keys (Lk rounded up to 64-key tiles, the
// row stride that plus 8 floats) in dynamic shared memory.
//   q . k^T  once: each step takes two 64-key K tiles; each thread computes
//            8 rows x 4 keys (rows rg + 8 i, keys kg + 32 j; a warp is 4
//            rows x 8 keys), the same fmaf chain over dh in order as the
//            two-pass route, then the scale, bias, mask and -inf past Lk
//            (the bias and mask loaded before the dots); it writes s into
//            the score rows and keeps its rows' max;
//   softmax  the rows' max across the block, then p = exp(s - m) written
//            over s in place (__fsub_rn, expf) with each row's sum: warp w
//            takes rows 8 w .. 8 w + 7, lane l float4 column l of each step,
//            the first step's before P . V and step t + 1's during step t's
//            P . V (loaded before the product, stored after it, so that the
//            exponentials run under it);
//   P . V    each step takes two 64-key V tiles; the two halves of the block
//            take keys 0-31 and 32-63 of each tile, each thread 8 rows x 4
//            dims (8 x 8 at dh 128); the halves' sums are added once at the
//            end, then divided by the row's sum.
// Q, K and V come by cp.async (16 bytes a thread, zero-filled past Lq and
// Lk) into a ring of four 64-key slots: a step's two tiles are copied while
// the step before runs (the first V tiles while the softmax starts). Tiles
// are stored unpadded, 16-byte chunk c of row r at c ^ (r & 7), so that the
// 8 keys (or rows) a warp reads at one chunk fall in 8 distinct bank groups.
// So the scores, the max and every p are bit for bit the two-pass route's;
// only the order of the denominator's sum and of P . V differ.
//
// Shared memory: 4 (64 dh + 4 x 64 dh + 64 (Lk_pad + 8)) bytes, at most
// MAX_SMEM = 232,448 (the most an H100 gives a block): Lk <= 576 at dh 64,
// Lk <= 256 at dh 128. One block an SM.
//
// The held route with K in the score rows (attention_f32_held_kernel<64,
// true>; Lk <= 640): q . k^T, the max and every p as the held route's, each
// step's K tiles copied into the score columns that the step then writes, Q's
// 64 KB region free after it. E . V runs on the tensor cores, the two
// warpgroups on their own: warpgroup g takes tiles g, g + 2, ...; a tile's V
// comes from global memory into registers (the next one loaded while the tile
// runs), is split into three exact bf16 planes (E . V below) in the
// warpgroup's 24 KB slot of Q's region (128-byte swizzle, an MN-major B), and
// its p = exp(s - m) is computed at the warpgroup's A-fragment places and
// split in registers; the six plane products, 24 m64n64k16 wgmma over the
// tile's four k steps, go into a fresh accumulator set, added into o with
// __fadd_rn; the two halves of o are added at the end and divided by the
// row's sum. Its grid is (query tile, h, b), the query tiles of one (b, h)
// side by side, so that their K and V tiles come from L2 (3 % less time than
// (b, query tile, h), the other routes' order, which keeps a head's T5 bias
// in L2). Barriers 3 and 4 make the warpgroups' products take turns, so that
// each one's exponentials and planes run under the other's products. The row
// sums keep the held route's order: each lane-slot (4 keys of a step, as a
// warp's lane sums them there) summed in order by the thread pair that holds
// its keys (a shuffle), the 32 slot sums of a row added as that warp's
// shuffle tree adds them; so the denominator is bit for bit the held route's.
// Only o's sums differ: wgmma adds each 16-key step into its fp32 accumulator
// and truncates, which the fresh set a tile keeps near the tile's own sum
// (tests/test_torch_vit_f32_planes.py models it). Shared memory: 4 (4 x 64 x
// 64 + 64 (Lk_pad + 8)) + 1,024 bytes (the planes start on the swizzle's
// 1,024-byte period).
//
// The two-pass route (attention_f32_kernel), for any longer Lk: a block of
// 256 threads takes 64 query rows, Q in shared memory; key tiles of 64 keys
// (K and V, in shared memory, zero past Lk) stream through it.
//   pass 1  each thread computes 4 rows x 4 keys of s (rows ty + 16 i, keys
//           tx + 16 j, ty and tx of 16), fed by float4 reads of Q's and K's
//           rows (a 68-float row stride: conflict-free), keeps its rows'
//           running max, then the max of the half-warp that shares its rows
//           by shuffles;
//   pass 2  recomputes the same s bit for bit, p = exp(s - m), sums p, puts
//           p in shared memory, then each thread accumulates 4 rows x 4
//           dims of o (dims 4 tx + 64 g) from float4s of P and V.
//
// Keys past Lk take no part (s = -inf, p = 0); rows past Lq are not stored.
// The grid is (b, query tile, head), b fastest, so that the blocks at work
// share one head's bias tile in L2.
//
// What bounds it (H100 SXM, 67 TFLOP/s fp32 outside the tensor cores): the
// function does 4 B H Lq Lk dh operations (q . k^T and p . v). At T5's
// B = 32, L = 557, 32 heads of 64 that is 81.3 GFLOP (1.21 ms); the held
// route computes on whole 64-row and 64-key tiles, 576 x 576 (87.0 GFLOP,
// 1.30 ms); the two-pass route does q . k^T twice, 6 B H Lq Lk dh (122
// GFLOP, 1.82 ms). The bytes (q, k, v, out, 73 MB each, and the 40 MB bias)
// take 0.1 ms. Bound by operations. What feeds the FMA pipes: per 4 dims a
// warp of the held route makes 12 shared-memory loads of 16 bytes a
// thread, each one wavefront (the 8 lanes of a row, or of a key, read one
// address), against 128 FFMA instructions: each word a thread reads feeds 4
// (Q, P) or 8 (K, V) FMAs, and the loads take 37.5 % of the FMA pipes' time
// (the two-pass route's 4 x 4 tiles: 12 wavefronts against 64 FFMAs, 75 %).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W at those shapes: the held
// route 3.11 ms, the two-pass route 5.16 ms and fp32
// scaled_dot_product_attention 5.02 ms in the same call (chip_smoke.py's
// fp32_kernels); by part (tools/kernel_probe.py --f32-split) the dots of
// q . k^T add 1.00 ms (65 % of their share of the FMA rate), P . V 0.83 ms
// (78 %), the bias 0.11, the key mask 0.10 and the exponentials 0.07 ms
// (under P . V); the rest, 0.91 ms, is the copies, barriers, score stores
// and each block's start and end with one block an SM. The scores on the
// tensor cores as six bf16-plane products (the variant that
// tools/kernel_probe.py --f32-variants timed) took 3.21 ms against this
// route's 3.01 in the same call. At ViT-L/14@336's attention (B = 256, L =
// 577, 16 heads of 64; same card, tools/kernel_probe.py --vit-f32-variants,
// forms of this route in turns within one call): E . V on the tensor cores
// with the (b, query tile, h) grid 12.799 / 12.776 ms for attention_core
// against 13.923 / 13.535 with E . V on the CUDA cores as the held route
// does it, flash_attention's fp32 form 13.124 / 13.121 against 14.791 /
// 14.665, fp32 scaled_dot_product_attention 12.353 - 12.402; in another
// call the (query tile, h, b) grid 12.372 / 12.335 against 12.897 / 12.785,
// flash_attention 12.894 / 12.991 against 13.270 / 13.212. Each output
// within 4.1e-6 of the plain version (3.6e-6 with E . V on the CUDA cores).
// By part (--vit-f32-split, on flash_attention's form, same card) the dots
// of q . k^T add 5.56 ms, the exponentials 0.54, V's planes 0.47 and their
// loads 0.24, the plane products 0.15 (beside the CUDA cores' work). The function does 4 B
// H L^2 dh = 349.1 GFLOP: 5.21 ms at the fp32 rate, 2.12 ms as the twelve
// bf16-plane products of both dots at 989 TFLOP/s, the least the card takes
// for it exactly; this route 2 B H Lp^2 dh on the fp32 FMAs (Lp = 640 keys
// on whole tiles, 3.21 ms) and 12 B H Lp^2 dh of plane products at 989
// TFLOP/s (1.30 ms): 4.51 ms one after the other.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "hopper_async.cuh"

namespace attention_f32 {

constexpr int BQ = 64;     // query rows a block
constexpr int BKEYS = 64;  // keys a tile
constexpr int NT = 256;    // threads a block: 16 x 16
constexpr float MASK_NEG = -1e9f;

struct Args {
  const float* q;  // (B, Lq) rows, ldq apart; head h at h * DH
  const float* k;  // (B, Lk) rows, ldk apart
  const float* v;  // as k
  // where non-null: element (b, h, i, j) at b bias_b + h bias_h + i bias_row
  // + j (a stride of 0 broadcasts)
  const float* bias;
  long long bias_b, bias_h, bias_row;
  const int* mask;  // where non-null: (B, Lk), 0 masks key j
  float* out;       // (B, Lq) rows, ldo apart (unused with planes)
  int B, Lq, Lk, H, ldq, ldk, ldo;
  float scale;
  // where non-null: o as three bf16 planes, row r's lo | mid | hi at
  // planes + 3 ldo r + {0, ldo, 2 ldo}, in place of out
  __nv_bfloat16* planes;
  int fast_exp;  // not 0: p = exp(bf16(s - m))
};

// flash_attention's form, in kernels of its own (the two fields below, read
// at run time in every form, slowed t5_attention_core's held route by 8 %
// on an H100; the forms that take Args compile as before): the bias's
// stride along the keys (0 broadcasts), and n_pad keys past Lk of score
// exactly MASK_NEG and value 0 (its padding), which join each row's max
// and add n_pad exp(MASK_NEG - m) to its denominator.
struct FlashArgs : Args {
  long long bias_key;
  int n_pad;
};

template <class A>
constexpr bool kFlash = std::is_same<A, FlashArgs>::value;

// p = exp(s - m), or with fast_exp the exponential of bf16(s - m) (the
// Pallas kernel's exp of a bf16 argument, which XLA evaluates in fp32 and
// keeps unrounded where an fp32 value is used).
__device__ inline float shifted_exp(float s, float m, int fast_exp) {
  const float d = __fsub_rn(s, m);
  return expf(fast_exp ? __bfloat162float(__float2bfloat16(d)) : d);
}

// The padded keys' share of a row's denominator, n_pad exp(MASK_NEG - m)
// (FlashArgs), or nothing to add (Args).
template <class A>
__device__ inline bool has_pad(const A& a) {
  if constexpr (kFlash<A>) {
    return a.n_pad > 0;
  } else {
    return false;
  }
}

template <class A>
__device__ inline float pad_share(const A& a, float m) {
  if constexpr (kFlash<A>) {
    return __fmul_rn(static_cast<float>(a.n_pad),
                     shifted_exp(MASK_NEG, m, a.fast_exp));
  } else {
    return 0.0f;
  }
}

// Key `key`'s offset in a bias row: by the bias's key stride (FlashArgs),
// else the key itself.
template <class A>
__device__ inline auto key_offset(const A& a, int key) {
  if constexpr (kFlash<A>) {
    return key * a.bias_key;
  } else {
    return key;
  }
}

// Four bf16 values at p, as one 8-byte store.
__device__ inline void store_bf16x4(__nv_bfloat16* p, float a, float b,
                                    float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&lo);
  t.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = t;
}

// Four outputs of row `row` (of the B Lq rows) from column `col`: fp32 into
// out, or their three bf16 planes.
__device__ inline void store_out4(const Args& a, long long row, int col,
                                  float4 o) {
  if (a.planes == nullptr) {
    *reinterpret_cast<float4*>(a.out + row * a.ldo + col) = o;
    return;
  }
  const float x[4] = {o.x, o.y, o.z, o.w};
  float hi[4], mid[4], lo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = __bfloat162float(__float2bfloat16(x[e]));
    const float rest = __fsub_rn(x[e], hi[e]);
    mid[e] = __bfloat162float(__float2bfloat16(rest));
    lo[e] = __fsub_rn(rest, mid[e]);
  }
  __nv_bfloat16* dst = a.planes + row * 3 * a.ldo + col;
  store_bf16x4(dst, lo[0], lo[1], lo[2], lo[3]);
  store_bf16x4(dst + a.ldo, mid[0], mid[1], mid[2], mid[3]);
  store_bf16x4(dst + 2 * a.ldo, hi[0], hi[1], hi[2], hi[3]);
}

template <int DH>
__host__ __device__ constexpr int row_stride() {
  return DH + 4;  // 16-byte rows whose float4s fall in distinct bank groups
}

template <int DH>
__host__ __device__ constexpr size_t smem_bytes() {
  // Q, K, V and P tiles (P has BKEYS columns, at most DH + 4 floats a row)
  return static_cast<size_t>(4) * 64 * row_stride<DH>() * sizeof(float);
}

// `rows` rows of a (.., DH) fp32 operand from global rows ld apart into
// shared rows row_stride<DH>() apart, zero past `valid` rows.
template <int DH>
__device__ inline void load_tile(float* dst, const float* src, long long ld,
                                 int valid) {
  constexpr int C4 = DH / 4;
  constexpr int LD = row_stride<DH>();
  for (int idx = threadIdx.x; idx < 64 * C4; idx += NT) {
    const int r = idx / C4, c = 4 * (idx % C4);
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) t = *reinterpret_cast<const float4*>(src + r * ld + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = t;
  }
}

// This thread's 4 x 4 scores of key tile k0 (Q and K in shared memory):
// the dots, the scale, the bias, the key mask, -inf past Lk.
template <int DH, class A>
__device__ inline void scores(const A& a, const float* Qs, const float* Ks,
                              int b, int h, int q0, int k0, int ty, int tx,
                              float (&s)[4][4]) {
  constexpr int LD = row_stride<DH>();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
  }
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    float4 qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = s[i][j];
        t = fmaf(qv[i].x, kv[j].x, t);
        t = fmaf(qv[i].y, kv[j].y, t);
        t = fmaf(qv[i].z, kv[j].z, t);
        t = fmaf(qv[i].w, kv[j].w, t);
        s[i][j] = t;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + tx + 16 * j;
    const bool in = key < a.Lk;
    const float key_bias =
        (in && a.mask != nullptr && a.mask[static_cast<long long>(b) * a.Lk +
                                           key] <= 0)
            ? MASK_NEG
            : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float t = __fmul_rn(s[i][j], a.scale);
      if (a.bias != nullptr && in && row < a.Lq) {
        t = __fadd_rn(t, a.bias[b * a.bias_b + h * a.bias_h +
                                row * a.bias_row +
                                key_offset(a, key)]);
      }
      if (a.mask != nullptr) t = __fadd_rn(t, key_bias);
      s[i][j] = in ? t : -INFINITY;
    }
  }
}

template <int DH, class A>
__global__ void __launch_bounds__(NT)
attention_f32_kernel(const A a) {
  constexpr int LD = row_stride<DH>();
  constexpr int G = DH / 64;  // float4 groups of o's dims a thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + 64 * LD;
  float* Vs = Ks + 64 * LD;
  float* Ps = Vs + 64 * LD;

  const int b = blockIdx.x, q0 = blockIdx.y * BQ, h = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* qb = a.q + (static_cast<long long>(b) * a.Lq + q0) * a.ldq +
                    h * DH;
  const float* kb = a.k + static_cast<long long>(b) * a.Lk * a.ldk + h * DH;
  const float* vb = a.v + static_cast<long long>(b) * a.Lk * a.ldk + h * DH;
  load_tile<DH>(Qs, qb, a.ldq, a.Lq - q0);

  // pass 1: each row's max over every key
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float s[4][4];
  for (int k0 = 0; k0 < a.Lk; k0 += BKEYS) {
    __syncthreads();  // the previous tile is no longer read
    load_tile<DH>(Ks, kb + static_cast<long long>(k0) * a.ldk, a.ldk,
                  a.Lk - k0);
    __syncthreads();
    scores<DH>(a, Qs, Ks, b, h, q0, k0, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) m[i] = fmaxf(m[i], s[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], off));
    }
    if (has_pad(a)) m[i] = fmaxf(m[i], MASK_NEG);
  }

  // pass 2: p = exp(s - m), its sum, and p . v
  float denom[4] = {0.f, 0.f, 0.f, 0.f};
  float o[4][G][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][g][e] = 0.0f;
    }
  }
  for (int k0 = 0; k0 < a.Lk; k0 += BKEYS) {
    __syncthreads();
    load_tile<DH>(Ks, kb + static_cast<long long>(k0) * a.ldk, a.ldk,
                  a.Lk - k0);
    load_tile<DH>(Vs, vb + static_cast<long long>(k0) * a.ldk, a.ldk,
                  a.Lk - k0);
    __syncthreads();
    scores<DH>(a, Qs, Ks, b, h, q0, k0, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = shifted_exp(s[i][j], m[i], a.fast_exp);
        denom[i] = __fadd_rn(denom[i], p);
        Ps[(ty + 16 * i) * LD + tx + 16 * j] = p;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < BKEYS; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * LD + kk);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vs + (kk + e) * LD + 64 * g + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = e == 0 ? pv[i].x
                            : e == 1 ? pv[i].y
                            : e == 2 ? pv[i].z
                                     : pv[i].w;
            o[i][g][0] = fmaf(p, vv.x, o[i][g][0]);
            o[i][g][1] = fmaf(p, vv.y, o[i][g][1]);
            o[i][g][2] = fmaf(p, vv.z, o[i][g][2]);
            o[i][g][3] = fmaf(p, vv.w, o[i][g][3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      denom[i] = __fadd_rn(denom[i],
                           __shfl_xor_sync(0xffffffffu, denom[i], off));
    }
    if (has_pad(a)) denom[i] = __fadd_rn(denom[i], pad_share(a, m[i]));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Lq) continue;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      store_out4(a, static_cast<long long>(b) * a.Lq + row,
                 h * DH + 64 * g + 4 * tx,
                 make_float4(__fdiv_rn(o[i][g][0], denom[i]),
                             __fdiv_rn(o[i][g][1], denom[i]),
                             __fdiv_rn(o[i][g][2], denom[i]),
                             __fdiv_rn(o[i][g][3], denom[i])));
    }
  }
}

template <int DH, class A>
int launch(const A& a, cudaStream_t stream) {
  const int tiles = (a.Lq + BQ - 1) / BQ;
  if (a.B <= 0 || a.Lq <= 0 || a.Lk <= 0 || a.H <= 0 || tiles > 65535 ||
      a.H > 65535 || a.ldq % 4 || a.ldk % 4 || a.ldo % 4) {
    return cudaErrorInvalidValue;
  }
  const auto kernel = attention_f32_kernel<DH, A>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<DH>()));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.B, tiles, a.H), NT, smem_bytes<DH>(), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The head sizes it takes (a whole number of 64-dim groups a head).
template <class A>
int attention(const A& a, int dh, cudaStream_t stream) {
  switch (dh) {
    case 64: return launch<64>(a, stream);
    case 128: return launch<128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// --- the held route ---------------------------------------------------------

constexpr int HELD_ROWS = 64;    // query rows a block
constexpr int HELD_TILE = 64;    // keys a ring slot
constexpr int HELD_SLOTS = 4;    // ring slots: a step's two tiles, the next's
constexpr int HELD_PAD = 8;      // floats past Lk_pad a score row: 4 rows of
                                 // one column fall in 4 distinct bank groups
constexpr size_t MAX_SMEM = 232448;  // the most an H100 gives a block

// The held route's dynamic shared memory for Lk keys at head size dh: Q,
// the ring and the score rows (Lk rounded up to whole tiles, plus the pad).
__host__ __device__ constexpr size_t held_smem_bytes(int lk, int dh) {
  return sizeof(float) *
         (static_cast<size_t>(HELD_ROWS) * dh +
          static_cast<size_t>(HELD_SLOTS) * HELD_TILE * dh +
          static_cast<size_t>(HELD_ROWS) *
              ((lk + HELD_TILE - 1) / HELD_TILE * HELD_TILE + HELD_PAD));
}

// The held route with K in the score rows (head size 64 only; the held
// kernel's KS form): a K tile (64 keys x 64 dims) is the size of one
// 64-column block of the 64 score rows, so each step's K tiles are copied
// into the score columns that the step then writes (a barrier between its
// dots and its score stores), and one 64 KB region holds Q during q . k^T
// and, for E . V, a plane slot for each warpgroup and the rows' lane-slot
// sums (EV_*); the row maxima and sums go to the rows' pad. Its dynamic
// shared memory: that region, the score rows and EV_ALIGN bytes to start
// the region on the planes' swizzle period, which fit Lk <= 640
// (ViT-L/14@336's 577 keys among them, one past the held route's 576).
constexpr int EV_PLANE = HELD_TILE * 64 * 2;  // bytes: a V tile's bf16 plane
constexpr int EV_SLOT = 3 * EV_PLANE;         // its hi, mid and lo planes
constexpr int EV_SUM_LD = 33;                 // floats a row of lane-slot sums
constexpr int EV_SUMS = HELD_ROWS * EV_SUM_LD * 4;  // 32 sums a row
constexpr size_t EV_ALIGN = 1024;             // the 128-byte swizzle's period
static_assert(2 * EV_SLOT + EV_SUMS <= HELD_SLOTS * HELD_TILE * 64 * 4,
              "two plane slots and the sums fit Q's region");

__host__ __device__ constexpr size_t held_ks_smem_bytes(int lk) {
  return sizeof(float) *
             (static_cast<size_t>(HELD_SLOTS) * HELD_TILE * 64 +
              static_cast<size_t>(HELD_ROWS) *
                  ((lk + HELD_TILE - 1) / HELD_TILE * HELD_TILE +
                   HELD_PAD)) +
         EV_ALIGN;
}

__device__ inline void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// `rows` rows of a (.., DH) fp32 operand, global row r0 + r from src (rows
// ld apart) into shared row r (rows dld floats apart), 16-byte chunk c at
// c ^ (r & 7); zero from global row `valid` on. A thread copies chunk
// threadIdx.x % (DH / 4) of every NT / (DH / 4)-th row: a multiple of 8
// rows, so one swizzle.
template <int DH>
__device__ inline void copy_rows(float* dst, const float* src, long long ld,
                                 int rows, int r0, int valid, int dld = DH) {
  constexpr int C4 = DH / 4, RSTEP = NT / C4;
  static_assert(RSTEP % 8 == 0, "a thread's rows share one swizzle");
  const int c = threadIdx.x % C4;
  int r = threadIdx.x / C4;
  const float* from = src + static_cast<long long>(r0 + r) * ld + 4 * c;
  float* to = dst + r * dld + 4 * (c ^ (r & 7));
  for (; r < rows; r += RSTEP, from += RSTEP * ld, to += RSTEP * dld) {
    const bool in = r0 + r < valid;
    cp_async16(to, in ? from : src, in);
  }
}

// q . k^T of one step (keys k0 .. k0 + 32 NJ - 1; NJ = 4: two tiles, 2: the
// last, odd one) for this thread's 8 rows x NJ keys (rows rg + 8 i, keys
// kg + 32 j), each an fmaf chain over dh in order; then the scale, the
// bias, the key mask and -inf past Lk; s into the score rows S, the rows'
// running max into mx. The step's K tiles: key r of tile u at Kp + u ktile
// + r kld. bias: this thread's first row of the (b, h) bias (null without
// one), its rows brow floats apart; mask: row b of the key mask (or null);
// rows: how many of the thread's rows lie before Lq. KS (the K tiles in
// the score columns this step writes): a barrier between the dots and the
// stores.
template <int DH, int NJ, bool KS, class A>
__device__ inline void held_scores(const A& a, const float* Qs,
                                   const float* Kp, int kld, int ktile,
                                   float* S, int sld,
                                   const float* bias, int brow,
                                   const int* mask, int rows, int k0, int rg,
                                   int kg, float (&mx)[8]) {
  constexpr int C4 = DH / 4;
  // the bias and the key mask first, so that their loads run under the dots
  bool in[NJ];
  float key_bias[NJ], bv[8][NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int key = k0 + kg + 32 * j;
    in[j] = key < a.Lk;
    key_bias[j] =
        (in[j] && mask != nullptr && mask[key] <= 0) ? MASK_NEG : 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      bv[i][j] = (bias != nullptr && in[j] && i < rows)
                     ? bias[8 * i * brow + key_offset(a, key)]
                     : 0.0f;
    }
  }
  float s[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = 0.0f;
  }
  const float* Qr = Qs + rg * DH;   // rows rg + 8 i: (row & 7) == rg
  const float* Kr = Kp + kg * kld;  // keys kg + 32 j: (key & 7) == kg & 7
  const int xk = kg & 7;
#pragma unroll 8
  for (int c = 0; c < C4; ++c) {
    float4 qv[8], kv[NJ];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      qv[i] = *reinterpret_cast<const float4*>(Qr + 8 * i * DH +
                                               4 * (c ^ rg));
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      kv[j] = *reinterpret_cast<const float4*>(
          Kr + 32 * (j % 2) * kld + (j / 2) * ktile + 4 * (c ^ xk));
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float t = s[i][j];
        t = fmaf(qv[i].x, kv[j].x, t);
        t = fmaf(qv[i].y, kv[j].y, t);
        t = fmaf(qv[i].z, kv[j].z, t);
        t = fmaf(qv[i].w, kv[j].w, t);
        s[i][j] = t;
      }
    }
  }
  if constexpr (KS) __syncthreads();  // every thread's dots read K
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float t = __fmul_rn(s[i][j], a.scale);
      if (bias != nullptr && in[j] && i < rows) t = __fadd_rn(t, bv[i][j]);
      if (mask != nullptr) t = __fadd_rn(t, key_bias[j]);
      t = in[j] ? t : -INFINITY;
      mx[i] = fmaxf(mx[i], t);
      S[(rg + 8 * i) * sld + k0 + kg + 32 * j] = t;
    }
  }
}

// p = exp(s - m) of a warp's 8 score rows, one float4 column of each (P
// holds the first row's), loaded, computed, then stored: the loads come
// before a product and the stores after it, so that the exponentials run
// under the product.
__device__ inline void load_p4(const float* P, int sld, float4 (&x)[8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    x[r] = *reinterpret_cast<const float4*>(P + r * sld);
  }
}

__device__ inline void exp_p4(const float (&m)[8], int fast_exp,
                              float4 (&x)[8], float (&sum)[8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    x[r].x = shifted_exp(x[r].x, m[r], fast_exp);
    x[r].y = shifted_exp(x[r].y, m[r], fast_exp);
    x[r].z = shifted_exp(x[r].z, m[r], fast_exp);
    x[r].w = shifted_exp(x[r].w, m[r], fast_exp);
    sum[r] = __fadd_rn(
        __fadd_rn(__fadd_rn(__fadd_rn(sum[r], x[r].x), x[r].y), x[r].z),
        x[r].w);
  }
}

__device__ inline void store_p4(float* P, int sld, const float4 (&x)[8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    *reinterpret_cast<float4*>(P + r * sld) = x[r];
  }
}

// o += P . V over keys 32 half .. 32 half + 31 of one V tile (Vt, shared)
// for this thread's 8 rows x 4 G dims; P holds the tile's columns of the
// thread's first row.
template <int DH>
__device__ inline void held_pv(const float* P, const float* Vt, int sld,
                               int half, int dg,
                               float (&o)[8][DH / 64][4]) {
  constexpr int G = DH / 64;
  const float* Pr = P + 32 * half;
  const float* Vr = Vt + 32 * half * DH;
#pragma unroll
  for (int kk = 0; kk < 32; kk += 4) {
    float4 pv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      pv[i] = *reinterpret_cast<const float4*>(Pr + 8 * i * sld + kk);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kk + e;  // (key & 7) is the row's swizzle
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(
            Vr + key * DH + 4 * ((dg + 16 * g) ^ (key & 7)));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float p = e == 0 ? pv[i].x
                          : e == 1 ? pv[i].y
                          : e == 2 ? pv[i].z
                                   : pv[i].w;
          o[i][g][0] = fmaf(p, vv.x, o[i][g][0]);
          o[i][g][1] = fmaf(p, vv.y, o[i][g][1]);
          o[i][g][2] = fmaf(p, vv.z, o[i][g][2]);
          o[i][g][3] = fmaf(p, vv.w, o[i][g][3]);
        }
      }
    }
  }
}

// ---- E . V on the tensor cores (the KS form) --------------------------------
//
// e (the score rows' p) and V, each as three bf16 planes, hi = bf16(x),
// mid = bf16(x - hi), lo = bf16(x - hi - mid), whose sum is x exactly
// (only below about 2^-110, where lo is a bf16 subnormal, may it drop bits:
// at most 2^-134 a term), and six of the nine plane products, smallest
// first: lo.hi, mid.mid, hi.lo, mid.hi, hi.mid, hi.hi (the three left out
// are below 2^-25 of the product). Each bf16 product is exact; wgmma sums
// them in fp32.

// Two values' planes as packed bf16 pairs (x0 in the low half).
__device__ inline void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                              uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = __fsub_rn(x0, hf.x), r1 = __fsub_rn(x1, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(r0, mf.x), __fsub_rn(r1, mf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// A V tile's 64 keys x 64 dims in fp32 from global memory (key `key` at
// vb + key ld) into registers, zero past Lk: warpgroup thread t takes keys
// key0 + t / 8 + 16 i (i = 0 .. 3), dims 8 (t % 8) .. 8 (t % 8) + 7.
__device__ inline void load_v_tile(const float* vb, int ld, int key0, int lk,
                                   int t, float4 (&x)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = key0 + t / 8 + 16 * i;
    const float4* src = reinterpret_cast<const float4*>(
        vb + static_cast<long long>(key) * ld + 8 * (t % 8));
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    x[2 * i] = key < lk ? src[0] : zero;
    x[2 * i + 1] = key < lk ? src[1] : zero;
  }
}

// Those registers' three planes into `slot`, hi | mid | lo EV_PLANE bytes
// apart, each 64 keys of 128 bytes with 16-byte chunk u of key r at u ^ (r
// & 7) (the 128-byte swizzle of an MN-major B); then the fence that orders
// these stores before the products' reads (a barrier comes between).
__device__ inline void store_v_planes(const float4 (&x)[8],
                                      unsigned char* slot, int t) {
  const int u = t % 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = t / 8 + 16 * i;
    const float4 x0 = x[2 * i], x1 = x[2 * i + 1];
    uint4 hi, mid, lo;
    split3(x0.x, x0.y, hi.x, mid.x, lo.x);
    split3(x0.z, x0.w, hi.y, mid.y, lo.y);
    split3(x1.x, x1.y, hi.z, mid.z, lo.z);
    split3(x1.z, x1.w, hi.w, mid.w, lo.w);
    unsigned char* dst = slot + r * 128 + 16 * (u ^ (r & 7));
    *reinterpret_cast<uint4*>(dst) = hi;
    *reinterpret_cast<uint4*>(dst + EV_PLANE) = mid;
    *reinterpret_cast<uint4*>(dst + 2 * EV_PLANE) = lo;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// k step kk (keys 16 kk .. 16 kk + 15) of a plane (shared address `plane`)
// as the MN-major B of e . v: 8-key groups 1024 bytes apart, one panel.
__device__ inline uint64_t plane_desc(uint32_t plane, int kk) {
  return hopper_async::gmma_desc(plane + kk * 16 * 128, EV_PLANE, 8 * 128,
                                 1);
}

// The (e plane, V plane) of product pp, smallest first: lo.hi, mid.mid,
// hi.lo, mid.hi, hi.mid, hi.hi (planes 0 hi, 1 mid, 2 lo).
__host__ __device__ constexpr int ev_e_plane(int pp) {
  return pp == 0 ? 2 : (pp == 1 || pp == 3) ? 1 : 0;
}
__host__ __device__ constexpr int ev_v_plane(int pp) {
  return pp == 2 ? 2 : (pp == 1 || pp == 4) ? 1 : 0;
}

// p = exp(s - m) of one 64-key tile at warpgroup thread (wi, l)'s A-fragment
// places (rows r0 = 16 wi + l / 4 and r0 + 8, keys 16 kk + 8 h + 2 (l % 4)
// and the next, kk 0 .. 3, h 0 .. 1; S: the tile's first key of row r0,
// m0 and m1 the two rows' maxima), split into the A fragments pa, and
// added into the row sums in the order of the CUDA-core route's lanes
// (lane-slot s of a tile, keys 4 s .. 4 s + 3, summed in order into its
// own running sum across the tiles): lanes l and l ^ 1 hold a slot's two
// key pairs, so the even lane sums row r0's slots 4 kk + 2 h + (l % 4) / 2
// and the odd one row r0 + 8's, each with the other's pair by a shuffle.
__device__ inline void tile_exps(const float* S, int sld, float m0, float m1,
                                 int fast_exp, int l, float (&part)[4][2],
                                 uint32_t (&pa)[3][4][4]) {
  const bool odd = l & 1;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 e[2];  // rows r0, r0 + 8
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 s = *reinterpret_cast<const float2*>(
            S + 8 * i * sld + 16 * kk + 8 * h);
        const float m = i ? m1 : m0;
        e[i] = make_float2(shifted_exp(s.x, m, fast_exp),
                           shifted_exp(s.y, m, fast_exp));
        split3(e[i].x, e[i].y, pa[0][kk][2 * h + i], pa[1][kk][2 * h + i],
               pa[2][kk][2 * h + i]);
      }
      const float2 send = odd ? e[0] : e[1];
      const float2 got =
          make_float2(__shfl_xor_sync(0xffffffffu, send.x, 1),
                      __shfl_xor_sync(0xffffffffu, send.y, 1));
      const float2 first = odd ? got : e[0], second = odd ? e[1] : got;
      part[kk][h] = __fadd_rn(
          __fadd_rn(__fadd_rn(__fadd_rn(part[kk][h], first.x), first.y),
                    second.x),
          second.y);
    }
  }
}

// acc = e . v over one tile's 64 keys for a warpgroup's 64 rows x 64 dims,
// the six plane products over the four k steps, issued and committed, not
// waited for (the products own pa and acc until then); V's planes at
// shared address `slot`.
__device__ inline void issue_ev(uint32_t slot, uint32_t (&pa)[3][4][4],
                                float (&acc)[32]) {
  hopper_async::fence_operands(acc);
#pragma unroll
  for (int e = 0; e < 3; ++e) hopper_async::fence_operands(pa[e]);
  hopper_async::wgmma_fence();
#pragma unroll
  for (int pp = 0; pp < 6; ++pp) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper_async::wgmma_rs<1>(
          acc, pa[ev_e_plane(pp)][kk],
          plane_desc(slot + ev_v_plane(pp) * EV_PLANE, kk), pp + kk > 0);
    }
  }
  hopper_async::wgmma_commit();
}

// The 32 lane-slot sums of a row (sum[l]) added as the CUDA-core route's
// warp adds its lanes' (shuffles xor 16, 8, 4, 2, 1; each lane ends with
// this value, the additions commuting).
__device__ inline float lane_tree(const float* sum) {
  float v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = __fadd_rn(sum[i], sum[i + 16]);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(v[i], v[i + 8]);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __fadd_rn(v[i], v[i + 4]);
  return __fadd_rn(__fadd_rn(v[0], v[2]), __fadd_rn(v[1], v[3]));
}

template <int DH, bool KS, class A>
__global__ void __launch_bounds__(NT, 1)
attention_f32_held_kernel(const A a) {
  static_assert(!KS || DH == HELD_TILE, "K in the score rows: dh 64 only");
  constexpr int G = DH / 64;
  constexpr int SLOT = HELD_TILE * DH;  // floats a ring slot
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  if constexpr (KS) {  // Q's region starts on the planes' swizzle period
    Qs += (EV_ALIGN - hopper_async::smem_addr(smem4) % EV_ALIGN) %
          EV_ALIGN / sizeof(float);
  }
  float* ring = KS ? Qs : Qs + HELD_ROWS * DH;  // KS: V's tiles in Q's place
  float* S = ring + HELD_SLOTS * SLOT;
  const int tiles = (a.Lk + HELD_TILE - 1) / HELD_TILE;
  const int sld = tiles * HELD_TILE + HELD_PAD;
  const int steps = (tiles + 1) / 2;  // steps of two tiles, each product

  // KS: the grid is (query tile, h, b), so that the blocks at work on one
  // (b, h) read its K and V from L2 (launch_held)
  const int b = KS ? blockIdx.z : blockIdx.x;
  const int q0 = (KS ? blockIdx.x : blockIdx.y) * HELD_ROWS;
  const int h = KS ? blockIdx.y : blockIdx.z;
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  const float* kb = a.k + static_cast<long long>(b) * a.Lk * a.ldk + h * DH;
  const float* vb = a.v + static_cast<long long>(b) * a.Lk * a.ldk + h * DH;

  // copy t < steps holds K tiles 2t, 2t + 1, copy steps + t the V tiles
  // 2t, 2t + 1, in slots 2 (t % 2) and 2 (t % 2) + 1; KS: the K tiles in
  // the score columns 2t HELD_TILE on (the last step's one tile, where
  // tiles is odd), and no V copy (E . V loads its own tiles)
  auto copy_step = [&](int t) {
    const bool is_v = t >= steps;
    const int key0 = 2 * HELD_TILE * (is_v ? t - steps : t);
    if constexpr (KS) {
      for (int u = 0; u < 2 && 2 * t + u < tiles; ++u) {
        copy_rows<DH>(S + key0 + u * HELD_TILE, kb, a.ldk, HELD_TILE,
                      key0 + u * HELD_TILE, a.Lk, sld);
      }
    } else {
      copy_rows<DH>(ring + 2 * (t % 2) * SLOT, is_v ? vb : kb, a.ldk,
                    2 * HELD_TILE, key0, a.Lk);
    }
  };

  copy_rows<DH>(Qs,
                a.q + static_cast<long long>(b) * a.Lq * a.ldq + h * DH,
                a.ldq, HELD_ROWS, q0, a.Lq);
  copy_step(0);
  cp_async_commit();

  // q . k^T: 8 rows x 4 keys a thread, a warp 4 rows x 8 keys
  const int rg = 4 * (w % 2) + l / 8, kg = 8 * (w / 2) + l % 8;
  const int rows = a.Lq - q0 - rg <= 0 ? 0 : (a.Lq - q0 - rg + 7) / 8;
  const int brow = static_cast<int>(a.bias_row);
  const float* bias =
      a.bias == nullptr
          ? nullptr
          : a.bias + b * a.bias_b + h * a.bias_h +
                static_cast<long long>(q0 + rg) * a.bias_row;
  const int* mask =
      a.mask == nullptr ? nullptr
                        : a.mask + static_cast<long long>(b) * a.Lk;
  float mx[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) mx[i] = -INFINITY;
  const int kld = KS ? sld : DH, ktile = KS ? HELD_TILE : SLOT;
  for (int t = 0; t < steps; ++t) {
    cp_async_wait_all();
    __syncthreads();  // step t's tiles are in; step t - 1's slots are free
    if (!KS || t + 1 < steps) copy_step(t + 1);
    cp_async_commit();
    const int k0 = 2 * HELD_TILE * t;
    const float* Kp = KS ? S + k0 : ring + 2 * (t % 2) * SLOT;
    if (k0 + HELD_TILE < a.Lk) {
      held_scores<DH, 4, KS>(a, Qs, Kp, kld, ktile, S, sld, bias, brow,
                             mask, rows, k0, rg, kg, mx);
    } else {
      held_scores<DH, 2, KS>(a, Qs, Kp, kld, ktile, S, sld, bias, brow,
                             mask, rows, k0, rg, kg, mx);
    }
  }

  // KS: the first V tile of this thread's warpgroup, into registers
  float4 vx[8];
  if constexpr (KS) load_v_tile(vb, a.ldk, (w / 4) * HELD_TILE, a.Lk,
                                threadIdx.x % 128, vx);

  // each row's max (Q's buffer holds the 4 key columns' maxima, then the
  // rows' sums; KS: the score rows' pad)
  const int pad0 = tiles * HELD_TILE;
  auto red = [&](int j, int row) -> float& {
    return KS ? S[row * sld + pad0 + j] : Qs[j * HELD_ROWS + row];
  };
  auto denom = [&](int row) -> float& {
    return KS ? S[row * sld + pad0 + 4] : Qs[4 * HELD_ROWS + row];
  };
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
    }
  }
  __syncthreads();  // Q is no longer read
  if (l % 8 == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) red(w / 2, rg + 8 * i) = mx[i];
  }
  __syncthreads();
  // P . V in two halves, whose sums meet in the ring (part)
  const int half = w / 4, wh = w % 4;
  float* part = ring + half * HELD_ROWS * DH;
  auto row_max = [&](int row) {
    const float mr = fmaxf(fmaxf(red(0, row), red(1, row)),
                           fmaxf(red(2, row), red(3, row)));
    return has_pad(a) ? fmaxf(mr, MASK_NEG) : mr;
  };
  if constexpr (KS) {
    // On the tensor cores, each warpgroup on its own: warpgroup `half`
    // takes tiles half, half + 2, ...; for each, V's planes from the
    // registers its threads loaded into its plane slot, p of the tile at
    // its A-fragment places with the row sums, the six plane products into
    // a fresh accumulator set, added into o in fp32 (element i: row 16 wh
    // + l / 4 + 8 ((i / 2) % 2), dim 8 (i / 4) + 2 (l % 4) + i % 2), the
    // next V tile loaded under them. Named barrier 1 + half: the warpgroup;
    // 3 and 4: the turns of the warpgroups' products (warpgroup 0 first).
    const int t128 = threadIdx.x % 128, r0 = 16 * wh + l / 4;
    unsigned char* slot =
        reinterpret_cast<unsigned char*>(ring) + half * EV_SLOT;
    const uint32_t slot_at = hopper_async::smem_addr(slot);
    const float m0 = row_max(r0), m1 = row_max(r0 + 8);
    float o[32], acc[32], psum[4][2];
    uint32_t pa[3][4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) psum[kk][0] = psum[kk][1] = 0.0f;
    if (half == 1) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
    for (int j = half; j < tiles; j += 2) {
      store_v_planes(vx, slot, t128);
      if (j + 2 < tiles) {
        load_v_tile(vb, a.ldk, (j + 2) * HELD_TILE, a.Lk, t128, vx);
      }
      tile_exps(S + r0 * sld + j * HELD_TILE + 2 * (l % 4), sld, m0, m1,
                a.fast_exp, l, psum, pa);
      // the warpgroups' products take turns, each warpgroup's exponentials
      // and planes under the other's products: barrier 3 + half waits for
      // this warpgroup's 128 threads (its planes stored) and for the other
      // warpgroup's arrival once it has issued its products
      asm volatile("bar.sync %0, 256;\n" ::"r"(3 + half) : "memory");
      issue_ev(slot_at, pa, acc);
      if (j + 1 < tiles) {
        asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - half) : "memory");
      }
      hopper_async::wgmma_wait<0>();
      hopper_async::fence_operands(acc);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = __fadd_rn(o[i], acc[i]);
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + half) : "memory");
    }
    // the lane-slot sums (row r0 or r0 + 8, slot 16 half + 4 kk + 2 h +
    // (l % 4) / 2) past the plane slots, EV_SUM_LD floats a row (a column's
    // rows in distinct banks)
    float* sums = reinterpret_cast<float*>(
        reinterpret_cast<unsigned char*>(ring) + 2 * EV_SLOT);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sums[(r0 + 8 * (l & 1)) * EV_SUM_LD + 16 * half + 4 * kk + 2 * h +
             (l % 4) / 2] = psum[kk][h];
      }
    }
    __syncthreads();  // every product is done; every slot sum is in
    if (threadIdx.x < HELD_ROWS) {
      const int row = threadIdx.x;
      const float s = lane_tree(sums + row * EV_SUM_LD);
      denom(row) = has_pad(a) ? __fadd_rn(s, pad_share(a, row_max(row))) : s;
    }
    // float2 column c of row r at c ^ 8 (r & 7): a warp's 8 rows in
    // distinct bank groups
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = r0 + 8 * ((i / 2) % 2);
      const int c = 8 * (i / 4) + 2 * (l % 4);
      *reinterpret_cast<float2*>(part + r * DH + (c ^ (8 * (r & 7)))) =
          make_float2(o[i], o[i + 1]);
    }
  } else {
    // On the CUDA cores: warp w takes rows 8 w .. 8 w + 7 of p, float4
    // column l of each step, the first step's now and step t + 1's under
    // step t's P . V; half 0 (warps 0-3) takes keys 0-31 of each tile, half
    // 1 keys 32-63; a thread 8 rows x 4 G dims, a warp 4 rows x 8 float4
    // columns
    float m[8], sum[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      m[r] = row_max(8 * w + r);
      sum[r] = 0.0f;
    }
    float* Pw = S + 8 * w * sld + 4 * l;  // this lane's column of step 0
    if (4 * l < (tiles < 2 ? tiles : 2) * HELD_TILE) {
      float4 x[8];
      load_p4(Pw, sld, x);
      exp_p4(m, a.fast_exp, x, sum);
      store_p4(Pw, sld, x);
    }
    const int pr = 4 * (wh % 2) + l / 8, dg = 8 * (wh / 2) + l % 8;
    float o[8][G][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][g][e] = 0.0f;
      }
    }
    for (int t = 0; t < steps; ++t) {
      cp_async_wait_all();
      __syncthreads();  // step t's V tiles and p are in
      if (t + 1 < steps) copy_step(steps + t + 1);
      cp_async_commit();
      // p of step t + 1 (its columns 2 HELD_TILE (t + 1) + 4 l)
      const int next = 2 * HELD_TILE * (t + 1) + 4 * l;
      const bool exp_next = next < tiles * HELD_TILE;
      float4 x[8];
      if (exp_next) {
        load_p4(Pw + 2 * HELD_TILE * (t + 1), sld, x);
        exp_p4(m, a.fast_exp, x, sum);
      }
      const float* Vp = ring + 2 * ((steps + t) % 2) * SLOT;
      const int tile = 2 * t;
      held_pv<DH>(S + pr * sld + tile * HELD_TILE, Vp, sld, half, dg, o);
      if (tile + 1 < tiles) {
        held_pv<DH>(S + pr * sld + (tile + 1) * HELD_TILE, Vp + SLOT, sld,
                    half, dg, o);
      }
      if (exp_next) store_p4(Pw + 2 * HELD_TILE * (t + 1), sld, x);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum[r] =
            __fadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], off));
      }
    }
    if (l == 0) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        denom(8 * w + r) =
            has_pad(a) ? __fadd_rn(sum[r], pad_share(a, m[r])) : sum[r];
      }
    }
    __syncthreads();  // the ring is no longer read; every row's sum is in
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        *reinterpret_cast<float4*>(part + (pr + 8 * i) * DH +
                                   4 * (dg + 16 * g)) =
            make_float4(o[i][g][0], o[i][g][1], o[i][g][2], o[i][g][3]);
      }
    }
  }
  __syncthreads();
  constexpr int C4 = DH / 4;
  for (int idx = threadIdx.x; idx < HELD_ROWS * C4; idx += NT) {
    const int r = idx / C4, c = idx % C4;
    if (q0 + r >= a.Lq) break;
    const int col = KS ? (4 * c) ^ (8 * (r & 7)) : 4 * c;  // KS: as stored
    const float4 x = *reinterpret_cast<const float4*>(ring + r * DH + col);
    const float4 y = *reinterpret_cast<const float4*>(
        ring + (HELD_ROWS + r) * DH + col);
    const float d = denom(r);
    store_out4(a, static_cast<long long>(b) * a.Lq + q0 + r, h * DH + 4 * c,
               make_float4(__fdiv_rn(__fadd_rn(x.x, y.x), d),
                           __fdiv_rn(__fadd_rn(x.y, y.y), d),
                           __fdiv_rn(__fadd_rn(x.z, y.z), d),
                           __fdiv_rn(__fadd_rn(x.w, y.w), d)));
  }
}

// cudaErrorInvalidValue, and nothing launched, where the score rows do not
// fit (held_smem_bytes(Lk, DH), or with KS held_ks_smem_bytes(Lk), >
// MAX_SMEM) or the arguments are out of range (with KS the batch is the
// grid's z, at most 65,535; without, its x).
template <int DH, bool KS = false, class A>
int launch_held(const A& a, cudaStream_t stream) {
  const int tiles = (a.Lq + HELD_ROWS - 1) / HELD_ROWS;
  const size_t bytes =
      KS ? held_ks_smem_bytes(a.Lk) : held_smem_bytes(a.Lk, DH);
  if (a.B <= 0 || a.Lq <= 0 || a.Lk <= 0 || a.H <= 0 || tiles > 65535 ||
      a.H > 65535 || (KS && a.B > 65535) || a.ldq % 4 || a.ldk % 4 ||
      a.ldo % 4 || bytes > MAX_SMEM) {
    return cudaErrorInvalidValue;
  }
  const auto kernel = attention_f32_held_kernel<DH, KS, A>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<KS ? dim3(tiles, a.H, a.B) : dim3(a.B, tiles, a.H), NT, bytes,
           stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class A>
int attention_held(const A& a, int dh, cudaStream_t stream) {
  switch (dh) {
    case 64: return launch_held<64>(a, stream);
    case 128: return launch_held<128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The held route with K in the score rows (head size 64).
template <class A>
int attention_held_ks(const A& a, int dh, cudaStream_t stream) {
  return dh == HELD_TILE ? launch_held<64, true>(a, stream)
                         : cudaErrorInvalidValue;
}

// The routes by number (the ViT wrappers' vit_f32_route): 0 two passes (any
// Lk), 1 the held route, 2 the held route with K in the score rows; the
// held ones refuse an Lk whose score rows do not fit. A: Args, or
// FlashArgs (flash_attention's form).
template <class A>
int by_route(const A& a, int dh, int route, cudaStream_t stream) {
  switch (route) {
    case 0: return attention(a, dh, stream);
    case 1: return attention_held(a, dh, stream);
    case 2: return attention_held_ks(a, dh, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Self-attention over fp32 q (pre-scaled), k, v (B, L, H dh) with no bias,
// no mask and a scale of 1, by `route` (by_route's): o into out (fp32) or,
// with planes, as three bf16 planes (B L, 3 H dh). The ViT kernels'
// (attention_core, attention_core_oproj, fused_attention_block above 128
// tokens).
inline int self_attention(const void* q, const void* k, const void* v,
                          void* out, void* planes, int B, int L, int H,
                          int dh, int fast_exp, int route,
                          cudaStream_t stream) {
  const int D = H * dh;
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out);
  a.planes = static_cast<__nv_bfloat16*>(planes);
  a.B = B;
  a.Lq = a.Lk = L;
  a.H = H;
  a.ldq = a.ldk = a.ldo = D;
  a.scale = 1.0f;
  a.fast_exp = fast_exp;
  return by_route(a, dh, route, stream);
}

}  // namespace attention_f32
