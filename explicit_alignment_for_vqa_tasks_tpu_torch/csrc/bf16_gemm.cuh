// The bf16 mma.sync GEMM main loop of block_stages.cuh (attention_core_oproj's
// out-projection), for NVIDIA Hopper (sm_90a). The other bf16 products run
// on bf16_gemm_tma.cuh.
//
// One 128 x 128 output tile per block of eight warps on the tensor cores
// with mma.sync m16n8k16 (bf16 in, fp32 accumulate). A 4-slot cp.async ring
// stages 32-deep k steps of A (row-major (M, K)) and B (the JAX (K, N)
// layout as it is: ldmatrix.trans gives the B fragments, so the weights
// need no transpose); the shared rows are padded by 16 bytes so that
// ldmatrix reads are free of bank conflicts.
//
// Each kernel that includes this file writes its own epilogue from the
// accumulators: acc[mt][s][e] of warp w (warp_m = w / 4, warp_n = w % 4)
// and lane l (gid = l / 4, tig = l % 4) is row
//   m0 + 64 warp_m + 16 mt + gid + 8 (e / 2)
// and column
//   n0 + 32 warp_n + 8 s + 2 tig + e % 2.
// The caller guarantees K % BK == 0 and N % B_COLS == 0; rows at or past M
// are zero-filled and must not be stored.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace bf16_gemm {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;  // threads per block
constexpr int BM = 128, BK = 32;  // block rows and k step
constexpr int B_COLS = 128;       // B tile columns
constexpr int STAGES = 4;         // cp.async ring slots
constexpr int A_LD = BK + 8;      // padded shared row of A (elements)
constexpr int B_LD = B_COLS + 8;  // padded shared row of B (elements)
constexpr int A_TILE = BM * A_LD;
constexpr int B_TILE = BK * B_LD;
constexpr int STAGE_ELEMS = A_TILE + B_TILE;
constexpr int GEMM_SMEM = STAGES * STAGE_ELEMS * 2;

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ inline void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b for one m16n8k16 tile: bf16 in, fp32 accumulate
__device__ inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc = A[m0 : m0 + BM] . B[:, n0 : n0 + B_COLS], in the fragment layout
// described above. `smem` holds GEMM_SMEM bytes of dynamic shared memory.
__device__ __forceinline__ void mainloop(bf16* smem, const bf16* a,
                                         const bf16* b, int M, int K, int N,
                                         int m0, int n0,
                                         float (&acc)[4][4][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int steps = K / BK;

  auto load_step = [&](int step, int slot) {
    bf16* sa = smem + slot * STAGE_ELEMS;
    bf16* sb = sa + A_TILE;
    const int k0 = step * BK;
#pragma unroll
    for (int u = 0; u < BM * (BK / 8) / NT; ++u) {
      const int idx = threadIdx.x + u * NT;
      const int r = idx / (BK / 8), c = idx % (BK / 8);
      const bool valid = m0 + r < M;
      const bf16* src =
          a + static_cast<size_t>(valid ? m0 + r : 0) * K + k0 + c * 8;
      cp_async16(sa + r * A_LD + c * 8, src, valid);
    }
#pragma unroll
    for (int u = 0; u < BK * (B_COLS / 8) / NT; ++u) {
      const int idx = threadIdx.x + u * NT;
      const int r = idx / (B_COLS / 8), c = idx % (B_COLS / 8);
      const bf16* src = b + static_cast<size_t>(k0 + r) * N + n0 + c * 8;
      cp_async16(sb + r * B_LD + c * 8, src, true);
    }
  };

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_step(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int step = 0; step < steps; ++step) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();  // everyone's copies of this step are in; the slot
                      // refilled below was last read in the previous step
    if (step + STAGES - 1 < steps) {
      load_step(step + STAGES - 1, (step + STAGES - 1) % STAGES);
    }
    asm volatile("cp.async.commit_group;\n" ::);

    const bf16* sa = smem + (step % STAGES) * STAGE_ELEMS;
    const bf16* sb = sa + A_TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = warp_m * 64 + mt * 16 + (lane % 16);
        ldmatrix_x4(af[mt], sa + r * A_LD + kk * 16 + (lane / 16) * 8);
      }
      uint32_t bfr[4][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t t[4];
        ldmatrix_x4_trans(t, sb + (kk * 16 + (lane % 16)) * B_LD +
                                 warp_n * 32 + 16 * j + (lane / 16) * 8);
        bfr[2 * j][0] = t[0];
        bfr[2 * j][1] = t[1];
        bfr[2 * j + 1][0] = t[2];
        bfr[2 * j + 1][1] = t[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int s = 0; s < 4; ++s)
          mma_bf16(acc[mt][s], af[mt], bfr[s][0], bfr[s][1]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

}  // namespace bf16_gemm
