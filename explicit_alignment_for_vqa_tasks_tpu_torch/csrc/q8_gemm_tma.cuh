// The s8 GEMM main loop on TMA and asynchronous wgmma, for NVIDIA Hopper
// (sm_90a): every int8 product of the port, those of fused_t5_ln_qkv_q8,
// fused_oproj_residual_q8 and fused_t5_ffn_q8 (csrc/int8_encoder.cu) and of
// fused_qkv_q8, fused_mlp_block_q8 and fused_vit_block_q8
// (csrc/vit_block_q8.cu).
//
//   acc = sum over g, in order, of (float(P_g) * hs_g) * s_g
//
// P_g the exact int32 product of contraction group g of a (M, K) int8
// activation codes with (M, G) row scales hs and b (N, K) int8 weights
// (K-major, as int8 wgmma takes both operands) with (G, N) scales s: the
// plain versions' sums, products and order of rounding (the int32 products
// are exact, so the order of the k steps does not matter), hence their
// bits. Each kernel that includes this file brings its own epilogue,
// called once a tile with acc in q8_gemm.cuh's fragment layout.
//
// Design (the hopper-kernels guide's fast shape):
//   grid      persistent: one block an SM walks over the output tiles, N
//             tiles fastest within a band of 128 rows, tile i on block i
//             mod the grid, so that the blocks at work share their A bands
//             and the weights stay in L2.
//   loads     a producer warpgroup hands its registers back (setmaxnreg)
//             and one of its threads keeps a ring of STAGES k steps in
//             flight with TMA on mbarriers (full: the bytes have landed;
//             empty: every consumer warp is done with the slot). 2-D tensor
//             maps over a (M, K) and b (N, K), a k step of BK bytes = one
//             swizzle row (128-byte swizzle; 64 where a group is only 64
//             deep), rows past M zero-filled by TMA.
//   products  two consumer warpgroups of 64 rows each issue the k step's
//             BK / 32 wgmma.m64nBNk32.s32.s8.s8 through swizzled
//             descriptors (the start address 32 bytes further each), then
//             wait_group 1: the previous step's products are settled while
//             this step's run, and only then is its slot released. Every
//             wait counts the same groups on every path, and no register
//             an in-flight product reads is rewritten, so ptxas keeps the
//             products asynchronous.
//   tiles     G = 1: one int32 accumulator set, folded once after the last
//             step, 128 x 256 (128 registers a thread) where N % 256 == 0,
//             else 128 x 128. G > 1: 128 x 128 with two int32 sets that
//             alternate by group parity: group g's fold into the fp32 acc
//             runs while group g + 1's first products are in flight (64 +
//             64 + 64 registers; the consumers take 240 a thread, the
//             producer keeps 24).
//   epilogue  the kernel's own, from registers, while the producer fills
//             the next tile's stages; it reads a chunk's bias and residual
//             before storing any of it (a load after a store that may
//             alias it waits for that store's memory round trip).
// Shapes: any M, groups of any multiple of 64 bytes, N a multiple of 128
// (q8_gemm::shape_ok). An mbarrier wait that lasts seconds traps.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_async.cuh"
#include "q8_gemm.cuh"

namespace q8_gemm_tma {

namespace ha = hopper_async;

constexpr int BM = 128;                    // rows a tile, 64 a warpgroup
constexpr int CONSUMERS = 2;               // consumer warpgroups
constexpr int NT = (CONSUMERS + 1) * 128;  // and the producer warpgroup
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 64,512 in all
constexpr int RING_BYTES = 192 * 1024;     // of the 227 KB a block may use

template <int BN_, int BK_, int SETS_>
struct Tiles {
  static constexpr int BN = BN_;  // 256 (one accumulator set) or 128
  static constexpr int BK = BK_;  // bytes of a k step: 128 or 64
  static constexpr int SETS = SETS_;  // int32 accumulator sets: 1 (G = 1)
                                      // or 2 (G > 1, BN = 128)
  static constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES =
      RING_BYTES / STAGE_BYTES < 8 ? RING_BYTES / STAGE_BYTES : 8;
  static constexpr int ACC = BN / 2;  // accumulator elements a thread
  static constexpr uint64_t LAYOUT = BK == 128 ? 1 : 2;  // wgmma's swizzle
  static constexpr size_t SMEM =
      static_cast<size_t>(STAGES) * STAGE_BYTES +
      2 * STAGES * sizeof(uint64_t) + 1024;  // the ring, barriers, slack
};

// The scales and shape of one product.
struct Problem {
  const float* a_scale;  // (M, G)
  const float* b_scale;  // (G, N)
  int M, K, N, G;
};

// The columns of the tiles the loop takes for N columns in G groups: 256
// with one group where N allows, else 128 (see gemm below).
inline int tile_width(int N, int G) {
  return G == 1 && N % 256 == 0 ? 256 : 128;
}

#define Q8_TMA_D8(i)                                                     \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),            \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (+)= A . B^T for a 64 x 128 x 32 step of a warpgroup: int8 in, int32
// accumulate (exact); d is overwritten when accumulate is 0
__device__ inline void wgmma_s8(int (&d)[64], uint64_t desc_a,
                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : Q8_TMA_D8(0), Q8_TMA_D8(8), Q8_TMA_D8(16), Q8_TMA_D8(24),
        Q8_TMA_D8(32), Q8_TMA_D8(40), Q8_TMA_D8(48), Q8_TMA_D8(56)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (+)= A . B^T for a 64 x 256 x 32 step of a warpgroup: int8 in, int32
// accumulate (exact); d is overwritten when accumulate is 0
__device__ inline void wgmma_s8(int (&d)[128], uint64_t desc_a,
                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, "
      "%107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : Q8_TMA_D8(0), Q8_TMA_D8(8), Q8_TMA_D8(16), Q8_TMA_D8(24),
        Q8_TMA_D8(32), Q8_TMA_D8(40), Q8_TMA_D8(48), Q8_TMA_D8(56),
        Q8_TMA_D8(64), Q8_TMA_D8(72), Q8_TMA_D8(80), Q8_TMA_D8(88),
        Q8_TMA_D8(96), Q8_TMA_D8(104), Q8_TMA_D8(112), Q8_TMA_D8(120)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#undef Q8_TMA_D8

// acc (+)= (float(d) * hs_g) * s_g for group g (acc is set, not added to,
// at g = 0); row0 is the thread's first fragment row, n0 the tile's first
// column.
template <bool FIRST, int ACC>
__device__ inline void fold(const Problem& p, const int (&d)[ACC],
                            float (&acc)[ACC], int row0, int n0, int g) {
  const int tig = threadIdx.x % 4;
  const float hs0 =
      row0 < p.M ? p.a_scale[static_cast<size_t>(row0) * p.G + g] : 0.0f;
  const float hs1 =
      row0 + 8 < p.M ? p.a_scale[static_cast<size_t>(row0 + 8) * p.G + g]
                     : 0.0f;
#pragma unroll
  for (int j = 0; j < ACC / 4; ++j) {
    const float2 sc = __ldg(reinterpret_cast<const float2*>(
        p.b_scale + static_cast<size_t>(g) * p.N + n0 + 8 * j + 2 * tig));
    const float hs[4] = {hs0, hs0, hs1, hs1};
    const float sw[4] = {sc.x, sc.y, sc.x, sc.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float t = __fmul_rn(
          __fmul_rn(static_cast<float>(d[4 * j + e]), hs[e]), sw[e]);
      acc[4 * j + e] = FIRST ? t : __fadd_rn(acc[4 * j + e], t);
    }
  }
}

template <int ACC>
__device__ __forceinline__ void fold_group(const Problem& p,
                                           const int (&d)[ACC],
                                           float (&acc)[ACC], int row0,
                                           int n0, int g) {
  if (g == 0) fold<true>(p, d, acc, row0, n0, g);
  else fold<false>(p, d, acc, row0, n0, g);
}

// The product over the tiles of the grid. Epi::store<BN>(args, acc, row0,
// n0) writes one tile from its fragments (rows at or past M are the
// epilogue's to skip).
template <int BN, int BK, int SETS, class Epi>
__global__ void __launch_bounds__(NT, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b, const Problem p,
            const __grid_constant__ typename Epi::Args args) {
  using T = Tiles<BN, BK, SETS>;
  static_assert(SETS == 1 || BN == 128, "two sets fit 128 columns only");
  constexpr int STAGES = T::STAGES;
  extern __shared__ unsigned char q8_tma_smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(q8_tma_smem_raw) + 1023) &
      ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * T::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int tiles_n = p.N / BN;
  const int tiles = (p.M + BM - 1) / BM * tiles_n;
  const int steps = p.K / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      ha::mbar_init(&full[s], 1);
      ha::mbar_init(&empty[s], CONSUMERS * 4);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {  // the producer: one thread issues every load
    ha::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != CONSUMERS * 128) return;
    int t = 0;  // k steps loaded
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
      for (int s = 0; s < steps; ++s, ++t) {
        const int slot = t % STAGES;
        if (t >= STAGES) ha::mbar_wait(&empty[slot], (t / STAGES - 1) & 1);
        ha::mbar_expect_tx(&full[slot], T::STAGE_BYTES);
        unsigned char* sa = ring + slot * T::STAGE_BYTES;
        ha::tma_load_2d(sa, &map_a, &full[slot], s * BK, m0);
        ha::tma_load_2d(sa + T::A_BYTES, &map_b, &full[slot], s * BK, n0);
      }
    }
    return;
  }

  // ---- a consumer warpgroup: rows m0 + 64 wg .. + 63 of each tile ---------
  ha::setmaxnreg_inc<CONSUMER_REGS>();
  const int lane = threadIdx.x % 32;
  const uint32_t ring_addr = ha::smem_addr(ring);
  int t = 0;  // k steps consumed
  auto release = [&](int tt) {
    if (lane == 0) ha::mbar_arrive(&empty[tt % STAGES]);
  };
  // k step tt's products into d, asynchronously (one committed group);
  // `first` overwrites d
  auto issue = [&](int (&d)[T::ACC], int tt, bool first) {
    const int slot = tt % STAGES;
    ha::mbar_wait(&full[slot], (tt / STAGES) & 1);
    const uint32_t a = ring_addr + slot * T::STAGE_BYTES + wg * 64 * BK;
    const uint32_t b = ring_addr + slot * T::STAGE_BYTES + T::A_BYTES;
    ha::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      wgmma_s8(d, ha::gmma_desc(a + 32 * kk, 16, 8 * BK, T::LAYOUT),
               ha::gmma_desc(b + 32 * kk, 16, 8 * BK, T::LAYOUT),
               (!first || kk > 0) ? 1 : 0);
    }
    ha::wgmma_commit();
  };

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
    const int row0 = q8_gemm::fragment_row0(m0);
    float acc[T::ACC];
    if constexpr (SETS == 1) {  // G = 1
      int d[T::ACC];
      ha::fence_operands(d);
      issue(d, t, true);
      for (int s = 1; s < steps; ++s) {
        issue(d, t + s, false);
        ha::wgmma_wait<1>();
        release(t + s - 1);
      }
      ha::wgmma_wait<0>();
      ha::fence_operands(d);
      release(t + steps - 1);
      t += steps;
      fold<true>(p, d, acc, row0, n0, 0);
    } else {
      int d0[T::ACC], d1[T::ACC];
      const int group_steps = steps / p.G;
      // group g's k steps into d; once its first step is issued, the
      // previous group's (in prev) are settled and folded
      auto group = [&](int (&d)[T::ACC], int (&prev)[T::ACC], int g) {
        ha::fence_operands(d);
        issue(d, t, true);
        ha::wgmma_wait<1>();
        if (g > 0) {
          release(t - 1);
          ha::fence_operands(prev);
          fold_group(p, prev, acc, row0, n0, g - 1);
        }
        for (int s = 1; s < group_steps; ++s) {
          issue(d, t + s, false);
          ha::wgmma_wait<1>();
          release(t + s - 1);
        }
        t += group_steps;
      };
      for (int g = 0; g < p.G; g += 2) {
        group(d0, d1, g);
        if (g + 1 < p.G) group(d1, d0, g + 1);
      }
      ha::wgmma_wait<0>();
      release(t - 1);
      if (p.G % 2) {
        ha::fence_operands(d0);
        fold_group(p, d0, acc, row0, n0, p.G - 1);
      } else {
        ha::fence_operands(d1);
        fold_group(p, d1, acc, row0, n0, p.G - 1);
      }
    }
    Epi::template store<BN>(args, acc, row0, n0);
  }
}

// ---- the host side ---------------------------------------------------------

// The tensor map of a (rows, K) int8 operand with a box of (BK, box_rows),
// swizzled by BK bytes; rows past the end read as zeros.
inline bool encode_operand(CUtensorMap* map, const void* base, int rows,
                           int K, int box_rows, int BK) {
  const auto encode = ha::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                BK == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int BK, int SETS, class Epi>
int launch(const void* a, const void* b, const Problem& p,
           const typename Epi::Args& args, cudaStream_t stream) {
  using T = Tiles<BN, BK, SETS>;
  CUtensorMap map_a, map_b;
  if (!encode_operand(&map_a, a, p.M, p.K, BM, BK) ||
      !encode_operand(&map_b, b, p.N, p.K, BN, BK)) {
    return cudaErrorInvalidValue;
  }
  const auto kernel = gemm_kernel<BN, BK, SETS, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::SMEM));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles =
      static_cast<long long>((p.M + BM - 1) / BM) * (p.N / BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, NT, T::SMEM, stream>>>(map_a, map_b, p, args);
  return static_cast<int>(cudaGetLastError());
}

// The product of a (M, K) codes with a_scale (M, G) and b (N, K) weights
// with b_scale (G, N), each 16-byte aligned, at the tiles its shape takes:
// G = 1 on one accumulator set, 256 columns a tile where N allows; G > 1 on
// two sets of 128 columns. With ANY_GROUPS false only one group of a
// multiple of 128 (fewer kernels to build where the caller never has
// others). Returns the launch's cudaError_t (0 on success).
template <class Epi, bool ANY_GROUPS = true>
int gemm(const void* a, const void* a_scale, const void* b,
         const void* b_scale, int M, int K, int N, int G,
         const typename Epi::Args& args, cudaStream_t stream) {
  if (!q8_gemm::shape_ok(M, K, N, G)) return cudaErrorInvalidValue;
  const Problem p{static_cast<const float*>(a_scale),
                  static_cast<const float*>(b_scale), M, K, N, G};
  const bool wide = tile_width(N, G) == 256;
  if constexpr (!ANY_GROUPS) {
    if (G != 1 || K % 128 != 0) return cudaErrorInvalidValue;
    return wide ? launch<256, 128, 1, Epi>(a, b, p, args, stream)
                : launch<128, 128, 1, Epi>(a, b, p, args, stream);
  } else {
    const bool deep = (K / G) % 128 == 0;
    if (G == 1 && wide) {
      return deep ? launch<256, 128, 1, Epi>(a, b, p, args, stream)
                  : launch<256, 64, 1, Epi>(a, b, p, args, stream);
    }
    if (G == 1) {
      return deep ? launch<128, 128, 1, Epi>(a, b, p, args, stream)
                  : launch<128, 64, 1, Epi>(a, b, p, args, stream);
    }
    return deep ? launch<128, 128, 2, Epi>(a, b, p, args, stream)
                : launch<128, 64, 2, Epi>(a, b, p, args, stream);
  }
}

}  // namespace q8_gemm_tma
