// fp32 attention on the CUDA cores, in the Pallas kernels' order, for NVIDIA
// Hopper (sm_90a): t5_attention_core's fp32 form (t5_attention_core.cu),
// written to be reused by the other fp32 attentions (an optional scale, an
// optional additive bias with strides, an optional key mask, Lq != Lk).
//
// For batch row b, head h, query row i and key j, in this order:
//
//   s     = (q_i . k_j) * scale        the dot over dh in order (fmaf), fp32
//   s     = s + bias[b, h, i, j]       where there is a bias
//   s     = s + (mask[b, j] > 0 ? 0 : -1e9)   where there is a key mask
//   m     = max_j s                    the WHOLE row's max before any exp
//   p     = exp(s - m)                 fp32, never rounded
//   denom = sum_j p                    unnormalised
//   o     = (sum_j p v_j) / denom      the division after P . V
//
// which is JAX's _make_t5_core_kernel (ops/fused_attention_block.py:1105-1131)
// on fp32 operands: no online-softmax rescale, whose order differs. Every
// multiply and add outside the dots is __fmul_rn / __fadd_rn, so that nvcc
// contracts nothing the plain PyTorch version does not have.
//
// Design (simple and right first): two passes over the keys, so any Lq and
// Lk (no score row is held whole). A block of 256 threads takes 64 query
// rows of one (b, h), Q in shared memory; key tiles of 64 keys (K and V, in
// shared memory, zero past Lk) stream through it.
//   pass 1  each thread computes 4 rows x 4 keys of s (rows ty + 16 i, keys
//           tx + 16 j, ty and tx of 16), fed by float4 reads of Q's and K's
//           rows (a 68-float row stride: conflict-free), keeps its rows'
//           running max, then the max of the half-warp that shares its rows
//           by shuffles;
//   pass 2  recomputes the same s bit for bit, p = exp(s - m), sums p, puts
//           p in shared memory, then each thread accumulates 4 rows x 4
//           dims of o (dims 4 tx + 64 g) from float4s of P and V.
// Keys past Lk take no part (s = -inf, p = 0); rows past Lq are not stored.
// The grid is (b, query tile, head), b fastest, so that the blocks at work
// share one head's bias tile in L2.
//
// What bounds it (H100 SXM, 67 TFLOP/s fp32 outside the tensor cores): the
// function does 4 B H Lq Lk dh operations (q . k^T and p . v); this route
// does q . k^T twice, 6 B H Lq Lk dh. At T5's B = 32, L = 557, 32 heads of
// 64 that is 81.3 GFLOP (1.21 ms) for the function and 122 GFLOP (1.82 ms)
// for the route; the bytes (q, k, v, out, 73 MB each, and the 40 MB bias)
// take 0.1 ms. Bound by operations.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

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
  float* out;       // (B, Lq) rows, ldo apart
  int B, Lq, Lk, H, ldq, ldk, ldo;
  float scale;
};

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
template <int DH>
__device__ inline void scores(const Args& a, const float* Qs, const float* Ks,
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
                                row * a.bias_row + key]);
      }
      if (a.mask != nullptr) t = __fadd_rn(t, key_bias);
      s[i][j] = in ? t : -INFINITY;
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(NT)
attention_f32_kernel(const Args a) {
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
        const float p = expf(__fsub_rn(s[i][j], m[i]));
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
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Lq) continue;
    float* dst = a.out + (static_cast<long long>(b) * a.Lq + row) * a.ldo +
                 h * DH + 4 * tx;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      *reinterpret_cast<float4*>(dst + 64 * g) = make_float4(
          __fdiv_rn(o[i][g][0], denom[i]), __fdiv_rn(o[i][g][1], denom[i]),
          __fdiv_rn(o[i][g][2], denom[i]), __fdiv_rn(o[i][g][3], denom[i]));
    }
  }
}

template <int DH>
int launch(const Args& a, cudaStream_t stream) {
  const int tiles = (a.Lq + BQ - 1) / BQ;
  if (a.B <= 0 || a.Lq <= 0 || a.Lk <= 0 || a.H <= 0 || tiles > 65535 ||
      a.H > 65535 || a.ldq % 4 || a.ldk % 4 || a.ldo % 4) {
    return cudaErrorInvalidValue;
  }
  const auto kernel = attention_f32_kernel<DH>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<DH>()));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.B, tiles, a.H), NT, smem_bytes<DH>(), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The head sizes it takes (a whole number of 64-dim groups a head).
inline int attention(const Args& a, int dh, cudaStream_t stream) {
  switch (dh) {
    case 64: return launch<64>(a, stream);
    case 128: return launch<128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attention_f32
