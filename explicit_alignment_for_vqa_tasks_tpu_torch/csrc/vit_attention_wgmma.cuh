// The CLIP ViT attention core of attention_core and attention_core_oproj on
// NVIDIA Hopper (sm_90a), with wgmma and TMA: softmax(q k^T) v per image
// and head over pre-scaled bf16 q, k, v in the (B, L, H dh) layout (no
// bias, no mask), in the order of rounding of two Pallas kernels of
// explicit_alignment_for_vqa_tasks_tpu/ops/fused_attention_block.py,
//   attention_core         _make_core_kernel (:161-200), pallas_call :225
//   attention_core_oproj   _make_core_oproj_kernel (:301-342), its
//                          attention; pallas_call :366
// (csrc/vit_block.cu adds the out-projection after it). With s = q . k^T in
// fp32 and m the max of the WHOLE row of s:
//   kBf16Sum   p = bf16(expf(s - m)), denom = sum(float(p))
//   kFastExp   e = expf(float(bf16(s - m))), p = bf16(e), denom = sum(e)
// then o = (p . v) in fp32, __fdiv_rn(o, denom), stored in bf16. The
// subtraction is __fsub_rn and the exponential expf (no exp2 with a log2(e)
// pre-scale, no --use_fast_math): both would move the bf16 roundings of p.
// Only the order of the fp32 sums differs from the plain version's.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s; 132
// SMs at 16 exponentials a clock each). At ViT-L/14@336 with B = 256
// (L = 577, D = 1024, 16 heads of 64), this route computes q . k^T twice:
//   6 B L^2 D = 523.7 GFLOP = 0.530 ms of tensor-core time
//   B H L^2   = 1.364 G exponentials, about 0.33 ms of MUFU time
//   4 B L D bf16 = 1.21 GB = 0.361 ms of device memory
// so its bound is 0.53 ms, by operations (the one-pass function's bound
// is 0.361 ms, by bytes). The fp32 work around each exponential (the
// subtraction, expf's range reduction, the bf16 packing and the sum) is
// the same order of time on the CUDA cores, so the design overlaps it
// with the tensor cores.
//
// Design. The Pallas order forbids FlashAttention's online softmax:
// bf16(exp(s - m_partial)) exp(m_partial - m) does not round as
// bf16(exp(s - m)) does. So the kernel makes two passes over the keys:
//   grid      persistent: one block an SM walks over the (128-query tile,
//             head, image) items, query tiles fastest, item i on block i
//             mod the grid, so that the blocks at work hold neighbouring
//             items (the tiles of one (image, head) together, finding its
//             K and V in L2), and the loads of the next item overlap the
//             end of this one. Two consumer warpgroups of 64 query rows
//             each and one producer warp (288 threads).
//   loads     the producer's one thread keeps a ring of STAGES tiles of 64
//             keys x dh in flight with TMA on mbarriers (full: the bytes
//             have landed; empty: both warpgroups are done with the slot),
//             in the order the consumers take them: per item its Q (two
//             buffers), K_0 .. K_n-1 for pass 1, then K_0, V_0, K_1, V_1,
//             ... for pass 2. A 3-D tensor map over (B, L, H dh) with a box
//             of (1, 64, PC), PC = min(dh, 64) columns, swizzled by PC * 2
//             bytes (128 at dh = 64): rows past L come in as zeros and
//             never hold the next image's. dh = 128 takes two boxes a tile.
//   Q         each warpgroup reads its 64 rows once into registers, as the
//             A fragments of q . k^T, and frees the buffer: the products
//             then read only K and V from shared memory.
//   pass 1    S = Q . K^T with wgmma.m64n64k16 (the K tile a K-major B),
//             two tiles a round back to back, a max over the accumulators
//             of the keys below L (a zero-filled key row scores 0 and must
//             not join it), then across the quad of threads of a row.
//   pass 2    S again, tile by tile; e from it as above (keys at or past L
//             get exactly 0) and the fp32 row sums in registers; p = bf16(e)
//             packed straight into the A fragments of the P . V wgmma (the
//             m64n64 accumulator layout is the m64k16 A layout), O += P . V
//             with the V tile as an MN-major B.
//   overlap   wgmma stays asynchronous: the next tile's Q . K^T and this
//             tile's P . V are issued together, and the next tile's
//             exponentials run (in place, in its accumulators) while P . V
//             does; each wait counts the same groups on every path, so that
//             ptxas keeps the products asynchronous (no C7513 / C7514
//             serialization). The two warpgroups overlap each other's waits.
//   epilogue  the sums across the quad, __fdiv_rn, bf16; rows past L are
//             not stored.
// Any L >= 1 (no shared-memory limit on L) and dh of 16, 32, 64 or 128.
// An mbarrier wait that lasts seconds traps (a deadlock fails the launch
// instead of hanging the card).
// The tensor map's encoder and the PTX wrappers are hopper_async.cuh's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "hopper_async.cuh"

namespace vit_attention_wgmma {

using bf16 = __nv_bfloat16;

enum Softmax : int { kBf16Sum = 0, kFastExp = 1 };

constexpr int ROWS = 64;                  // query rows a warpgroup; keys a tile
constexpr int CONSUMERS = 2;              // consumer warpgroups
constexpr int BQ = CONSUMERS * ROWS;      // query rows a block
constexpr int NT = CONSUMERS * 128 + 32;  // and one producer warp
constexpr int STAGES = 6;                 // K / V tiles in flight

// One 64-row tile of dh columns in shared memory: PANELS panels of PC
// columns, each as TMA writes a box, rows of PC * 2 bytes swizzled by that
// span (wgmma's layout type LAYOUT).
template <int DH>
struct Tile {
  static constexpr int PC = DH < 64 ? DH : 64;
  static constexpr int PANELS = DH / PC;
  static constexpr int ROW_BYTES = PC * 2;  // 32, 64 or 128
  static constexpr int PANEL_BYTES = ROWS * ROW_BYTES;
  static constexpr int BYTES = PANELS * PANEL_BYTES;
  static constexpr uint64_t LAYOUT =
      ROW_BYTES == 128 ? 1 : (ROW_BYTES == 64 ? 2 : 3);
  // the swizzle repeats every 8 rows: tiles start on that boundary (and
  // on 1024 bytes, the largest)
  static constexpr int ALIGN = 1024;
};

template <int DH>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(2 * CONSUMERS + STAGES) * Tile<DH>::BYTES
         + (2 * STAGES + 4) * sizeof(uint64_t)  // barriers
         + Tile<DH>::ALIGN;                      // slack
}

// The attention grid: (query tiles, H, B), within CUDA's limits.
inline bool shape_ok(int B, int L, int H) {
  return B > 0 && L > 0 && H > 0 && B <= 65535 && H <= 65535 &&
         static_cast<long long>(B) * L <= 0x7fffffff;
}

// ---- PTX: shared-memory addresses, mbarriers, TMA, wgmma (hopper_async.cuh)

using hopper_async::fence_operands;
using hopper_async::gmma_desc;
using hopper_async::mbar_arrive;
using hopper_async::mbar_expect_tx;
using hopper_async::mbar_init;
using hopper_async::mbar_wait;
using hopper_async::smem_addr;
using hopper_async::tma_load_3d;
using hopper_async::wgmma_commit;
using hopper_async::wgmma_fence;
using hopper_async::wgmma_wait;

// The byte offset of (row, byte) in a panel of rows of ROW_BYTES bytes as
// TMA swizzles it: the 16-byte chunks of a row XORed with bits 7 and up of
// the offset (the tiles start on 1024 bytes).
template <int DH>
__device__ inline int swizzled(int row, int byte) {
  using T = Tile<DH>;
  const int o = row * T::ROW_BYTES + byte;
  return o ^ (((o >> 7) & (T::ROW_BYTES / 16 - 1)) << 4);
}

// k step kk (columns 16 kk .. 16 kk + 15) of a K-major tile (K as the B of
// q . k^T): 8-row groups SBO apart, the step's 32 bytes inside a
// swizzled row (the leading offset is unused there).
template <int DH>
__device__ inline uint64_t k_major_desc(uint32_t tile, int kk) {
  using T = Tile<DH>;
  const int col = kk * 16;
  return gmma_desc(tile + (col / T::PC) * T::PANEL_BYTES + (col % T::PC) * 2,
                   16, 8 * T::ROW_BYTES, T::LAYOUT);
}

// k step kk (keys 16 kk .. 16 kk + 15) of the V tile as the MN-major B of
// p . v: 8-key groups SBO apart, dh panels LBO apart.
template <int DH>
__device__ inline uint64_t mn_major_desc(uint32_t tile, int kk) {
  using T = Tile<DH>;
  return gmma_desc(tile + kk * 16 * T::ROW_BYTES, T::PANEL_BYTES,
                   8 * T::ROW_BYTES, T::LAYOUT);
}

// d (+)= A . B for one 64 x 16 x 16 step of a warpgroup: A from registers
// (the m64k16 bf16 fragment), B in shared memory (its descriptor), K-major
// (TRANS_B 0) or MN-major (1); d is overwritten when accumulate is 0
template <int TRANS_B>
__device__ inline void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate), "n"(TRANS_B));
}

// d (+)= A . B for one 64 x 32 x 16 step of a warpgroup: A from registers
// (the m64k16 bf16 fragment), B in shared memory (its descriptor), K-major
// (TRANS_B 0) or MN-major (1); d is overwritten when accumulate is 0
template <int TRANS_B>
__device__ inline void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate), "n"(TRANS_B));
}

// d (+)= A . B for one 64 x 64 x 16 step of a warpgroup: A from registers
// (the m64k16 bf16 fragment), B in shared memory (its descriptor), K-major
// (TRANS_B 0) or MN-major (1); d is overwritten when accumulate is 0
template <int TRANS_B>
__device__ inline void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate), "n"(TRANS_B));
}

// d (+)= A . B for one 64 x 128 x 16 step of a warpgroup: A from registers
// (the m64k16 bf16 fragment), B in shared memory (its descriptor), K-major
// (TRANS_B 0) or MN-major (1); d is overwritten when accumulate is 0
template <int TRANS_B>
__device__ inline void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate), "n"(TRANS_B));
}

// ---- the kernel -------------------------------------------------------------

template <int DH, int MODE>
__global__ void __launch_bounds__(NT, 1)
attention_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 bf16* __restrict__ out, int B, int L, int H) {
  using T = Tile<DH>;
  const int tiles = (L + ROWS - 1) / ROWS;  // key tiles
  const int q_tiles = (L + BQ - 1) / BQ;
  const int items = q_tiles * H * B;  // (query tile, head, image), the
                                      // query tile fastest
  extern __shared__ unsigned char att_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(att_smem_raw) + T::ALIGN - 1) &
      ~static_cast<uintptr_t>(T::ALIGN - 1));
  // two Q buffers of one tile a warpgroup, then the ring
  unsigned char* qs = smem;
  unsigned char* ring = smem + 2 * CONSUMERS * T::BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * T::BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;  // two of each
  uint64_t* q_empty = q_full + 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {  // the producer warp: one thread issues every load
    if (threadIdx.x % 32 != 0) return;
    int t = 0;  // loads issued
    int n = 0;  // items begun
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const int q0 = item % q_tiles * BQ;
      const int h = item / q_tiles % H, b = item / (q_tiles * H);
      const int col0 = h * DH;
      uint64_t* qbar = &q_full[n % 2];
      if (n >= 2) mbar_wait(&q_empty[n % 2], (n / 2 - 1) & 1);
      mbar_expect_tx(qbar, CONSUMERS * T::BYTES);
      for (int w = 0; w < CONSUMERS; ++w) {
        for (int p = 0; p < T::PANELS; ++p) {
          tma_load_3d(qs + ((n % 2) * CONSUMERS + w) * T::BYTES +
                          p * T::PANEL_BYTES,
                      &map_q, qbar, col0 + p * T::PC, q0 + w * ROWS, b);
        }
      }
      auto load = [&](const CUtensorMap* map, int j) {
        const int slot = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[slot], (t / STAGES - 1) & 1);
        mbar_expect_tx(&full[slot], T::BYTES);
        for (int p = 0; p < T::PANELS; ++p) {
          tma_load_3d(ring + slot * T::BYTES + p * T::PANEL_BYTES, map,
                      &full[slot], col0 + p * T::PC, j * ROWS, b);
        }
        ++t;
      };
      for (int j = 0; j < tiles; ++j) load(&map_k, j);
      for (int j = 0; j < tiles; ++j) {
        load(&map_k, j);
        load(&map_v, j);
      }
    }
    return;
  }

  // ---- a consumer warpgroup: query rows q0 + 64 wg .. + 63 ----------------
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  // this thread's accumulator elements: rows r and r + 8 of the warpgroup's
  // 64; element i is column 8 (i / 4) + c2 + i % 2 of row r + 8 ((i / 2) % 2)
  const int r = 16 * (tid / 32) + lane / 4;
  const int c2 = 2 * (lane % 4);
  int t0 = 0;  // the first load of this item
  int n = 0;   // items begun
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int q0 = item % q_tiles * BQ;
    const int h = item / q_tiles % H, b = item / (q_tiles * H);
    const unsigned char* q_buf = qs + ((n % 2) * CONSUMERS + wg) * T::BYTES;
    // this warpgroup's Q as the A fragments of q . k^T, in registers for
    // the whole item; then its buffer is free for the item after next
    mbar_wait(&q_full[n % 2], (n / 2) & 1);
    uint32_t qa[DH / 16][4];
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) {
        const int col = 16 * kk + 8 * (hh / 2) + c2;
        qa[kk][hh] = *reinterpret_cast<const uint32_t*>(
            q_buf + (col / T::PC) * T::PANEL_BYTES +
            swizzled<DH>(r + 8 * (hh % 2), (col % T::PC) * 2));
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (tid == 0) {
      // the generic reads above come before the next TMA write
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&q_empty[n % 2]);
    }
    auto slot_of = [](int t) { return t % STAGES; };
    // loads are counted from this item's first: t is t0 + t in the ring
    auto wait_full = [&](int t) {
      mbar_wait(&full[slot_of(t0 + t)], ((t0 + t) / STAGES) & 1);
    };
    auto release = [&](int t) {
      if (tid == 0) mbar_arrive(&empty[slot_of(t0 + t)]);
    };
    auto tile_addr = [&](int t) {
      return smem_addr(ring + slot_of(t0 + t) * T::BYTES);
    };
    // s = Q . K^T for the K tile of load t, asynchronously (the caller
    // commits the group)
    auto issue_scores = [&](float(&s)[32], int t) {
      wait_full(t);
      const uint32_t k_tile = tile_addr(t);
      fence_operands(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wgmma_rs<0>(s, qa[kk], k_major_desc<DH>(k_tile, kk), kk > 0);
      }
    };

    // Every wgmma wait below waits for a fixed number of groups on every
    // path, so that ptxas can see which accumulators are settled and keeps
    // the products asynchronous.

    // ---- pass 1: the row max over the keys below L -------------------------
    float sa[32], sb[32];
    float m0 = -INFINITY, m1 = -INFINITY;
    auto row_max = [&](const float(&s)[32], int j) {
      const int lim = L - j * ROWS;  // keys of this tile below L
      if (lim >= ROWS) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if ((i / 2) % 2) m1 = fmaxf(m1, s[i]);
          else m0 = fmaxf(m0, s[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (8 * (i / 4) + c2 + i % 2 >= lim) continue;
          if ((i / 2) % 2) m1 = fmaxf(m1, s[i]);
          else m0 = fmaxf(m0, s[i]);
        }
      }
    };
    // two tiles' scores a round, back to back on the tensor cores
    int j = 0;
    for (; j + 1 < tiles; j += 2) {
      issue_scores(sa, j);
      issue_scores(sb, j + 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sa);
      fence_operands(sb);
      release(j);
      release(j + 1);
      row_max(sa, j);
      row_max(sb, j + 1);
    }
    if (j < tiles) {
      issue_scores(sa, j);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sa);
      release(j);
      row_max(sa, j);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }

    // ---- pass 2: p, its row sums and O = P . V -----------------------------
    // load t of K_j is tiles + 2 j, of V_j the one after
    auto k_load = [&](int jj) { return tiles + 2 * jj; };
    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
    uint32_t pa[4][4];  // P of a tile as the A fragments of 4 k steps
    float sum0 = 0.0f, sum1 = 0.0f;
    // e of one score (keys at or past L: dropped, exactly 0; p is bf16(e))
    // and its share of the row's denominator
    auto expo = [&](float s, float m, bool dropped, float& share) {
      if (dropped) {
        share = 0.0f;
        return 0.0f;
      }
      if (MODE == kFastExp) {
        const float e =
            expf(__bfloat162float(__float2bfloat16(__fsub_rn(s, m))));
        share = e;
        return e;
      }
      const float e = expf(__fsub_rn(s, m));
      share = __bfloat162float(__float2bfloat16(e));
      return e;
    };
    // tile jj's scores become their e, in place, and the shares go into the
    // sums; with a TAIL, the keys from lim on are past L
    auto exponentials = [&](float(&s)[32], int lim, auto tail) {
      constexpr bool TAIL = decltype(tail)::value;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + c2 + i % 2;
        float share;
        s[i] = expo(s[i], (i / 2) % 2 ? m1 : m0, TAIL && col >= lim, share);
        float& sum = (i / 2) % 2 ? sum1 : sum0;
        sum = __fadd_rn(sum, share);
      }
    };
    auto tile_exponentials = [&](float(&s)[32], int jj) {
      const int lim = L - jj * ROWS;
      if (lim >= ROWS) exponentials(s, lim, std::false_type());
      else exponentials(s, lim, std::true_type());
    };
    // p = bf16(e) into the A fragments: k step kk's are the elements
    // 8 kk .. 8 kk + 7 of the accumulator, in order
    auto pack = [&](const float(&e)[32]) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int hh = 0; hh < 4; ++hh) {
          const int i = 8 * kk + 2 * hh;
          const __nv_bfloat162 p = __floats2bfloat162_rn(e[i], e[i + 1]);
          pa[kk][hh] = *reinterpret_cast<const uint32_t*>(&p);
        }
      }
    };
    // O += P . V_j, asynchronously (one group)
    auto issue_pv = [&](int jj) {
      const int v_load = k_load(jj) + 1;
      wait_full(v_load);
      const uint32_t v_tile = tile_addr(v_load);
      fence_operands(o);
      fence_operands(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<1>(o, pa[kk], mn_major_desc<DH>(v_tile, kk), 1);
      }
      wgmma_commit();
    };

    issue_scores(sa, k_load(0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sa);
    release(k_load(0));
    tile_exponentials(sa, 0);
    pack(sa);
    for (j = 0; j + 1 < tiles; ++j) {
      // the next tile's scores, then this tile's P . V behind them; the
      // next tile's exponentials run while P . V does, and become its P
      // (the A registers) once P . V is done with them
      issue_scores(sa, k_load(j + 1));
      wgmma_commit();
      issue_pv(j);
      wgmma_wait<1>();
      fence_operands(sa);
      release(k_load(j + 1));
      tile_exponentials(sa, j + 1);
      wgmma_wait<0>();
      fence_operands(o);
      fence_operands(pa);
      release(k_load(j) + 1);
      pack(sa);
    }
    issue_pv(tiles - 1);
    wgmma_wait<0>();
    fence_operands(o);
    fence_operands(pa);
    release(k_load(tiles - 1) + 1);

    // ---- the division after PV and the store -------------------------------
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 = __fadd_rn(sum0, __shfl_xor_sync(0xffffffffu, sum0, off));
      sum1 = __fadd_rn(sum1, __shfl_xor_sync(0xffffffffu, sum1, off));
    }
    const int HD = H * DH;
    const int row0 = q0 + wg * ROWS + r;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = row0 + 8 * half;
      if (qi >= L) continue;
      const float denom = half ? sum1 : sum0;
      bf16* dst = out + (static_cast<size_t>(b) * L + qi) * HD + h * DH + c2;
#pragma unroll
      for (int g = 0; g < DH / 8; ++g) {
        const int i = 4 * g + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * g) = __floats2bfloat162_rn(
            __fdiv_rn(o[i], denom), __fdiv_rn(o[i + 1], denom));
      }
    }
    t0 += 3 * tiles;
  }
}

// ---- the host side ---------------------------------------------------------

// The tensor map of a (B, L, H dh) bf16 tensor with a box of (1, 64, PC).
template <int DH>
bool encode_map(CUtensorMap* map, const void* base, int B, int L, int H) {
  using T = Tile<DH>;
  const auto encode = hopper_async::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t HD = static_cast<cuuint64_t>(H) * DH;
  const cuuint64_t dims[3] = {HD, static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {HD * sizeof(bf16), L * HD * sizeof(bf16)};
  const cuuint32_t box[3] = {T::PC, ROWS, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      T::ROW_BYTES == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : T::ROW_BYTES == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH, int MODE>
int attention(const void* q, const void* k, const void* v, void* out, int B,
              int L, int H, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    if (!encode_map<DH>(&maps[i], bases[i], B, L, H)) {
      return cudaErrorInvalidValue;
    }
  }
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<DH, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>((L + BQ - 1) / BQ) * H * B;
  const int grid = static_cast<int>(items < sms ? items : sms);
  attention_kernel<DH, MODE><<<grid, NT, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(out), B, L, H);
  return static_cast<int>(cudaGetLastError());
}

// The attention of head size dh (16, 32, 64 or 128) in softmax order MODE
// over q, k, v and out (B, L, H dh) bf16, each 16-byte aligned; returns its
// launch's cudaError_t (0 on success).
template <int MODE>
int attention_dh(const void* q, const void* k, const void* v, void* out,
                 int B, int L, int H, int dh, cudaStream_t stream) {
  if (!shape_ok(B, L, H)) return cudaErrorInvalidValue;
  switch (dh) {
    case 16: return attention<16, MODE>(q, k, v, out, B, L, H, stream);
    case 32: return attention<32, MODE>(q, k, v, out, B, L, H, stream);
    case 64: return attention<64, MODE>(q, k, v, out, B, L, H, stream);
    case 128: return attention<128, MODE>(q, k, v, out, B, L, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace vit_attention_wgmma
