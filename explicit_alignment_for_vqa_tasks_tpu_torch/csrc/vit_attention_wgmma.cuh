// The attention cores of the CLIP ViT and of the T5 encoder, and the fp32
// attention of the CLIP encoder's use_pallas option, on NVIDIA Hopper
// (sm_90a), with wgmma and TMA: softmax(s) v per image (or batch row) and
// head over bf16 q, k, v in the (B, L, H dh) layout, in the order of
// rounding of four Pallas kernels: of
// explicit_alignment_for_vqa_tasks_tpu/ops/fused_attention_block.py,
//   attention_core         _make_core_kernel (:161-200), pallas_call :225
//   attention_core_oproj   _make_core_oproj_kernel (:301-342), its
//                          attention; pallas_call :366
//   t5_attention_core      _make_t5_core_kernel (:1105-1131), pallas_call
//                          :1168
// and of explicit_alignment_for_vqa_tasks_tpu/ops/attention.py,
//   flash_attention        _attn_kernel(_bias) (:29-63), pallas_call :142
// (csrc/vit_block.cu adds the out-projection after the second;
// csrc/t5_attention_core.cu launches the third, csrc/flash_attention.cu
// the fourth). With s = q . k^T in fp32 (ViT: q pre-scaled, no bias, no
// mask) and m the max of the WHOLE row of s over the keys below Lk:
//   kBf16Sum   p = bf16(expf(s - m)), denom = sum(float(p))
//   kFastExp   e = expf(float(bf16(s - m))), p = bf16(e), denom = sum(e)
//   kT5        kBf16Sum's order on s = (s + bias[h][i][j]) + key_bias[b][j]
//              (q unscaled; bias (H, L, L) fp32, read in the tiled order
//              of ops/fused_attention_block.py::t5_bias_tiles; key_bias 0,
//              or -1e9 where the (B, L) int32 mask is not > 0). Masked
//              keys inside L take part like any other: a fully masked row
//              comes out as the mean of v over all L keys (s + bias - 1e9
//              rounds to -1e9 for every key, so every e is 1).
//   kF32Planes flash_attention: s = s + bias[b sb + h sh + i sq + j sk]
//              where a bias is given (fp32, any broadcast strides); Lq
//              queries and Lk keys; e = expf(s - m) stays fp32, never
//              rounded, denom = sum(e); P . V as three exact bf16 products,
//              e split in registers into hi = bf16(e), mid = bf16(e - hi),
//              lo = bf16(e - hi - mid) (hi + mid + lo = e). JAX pads Lk with
//              n_pad keys scored exactly -1e9 whose v is 0: they are not
//              stored, and join the max as -1e9 and the denominator as
//              n_pad expf(-1e9 - m) (they matter only in a row whose bias
//              masks every key).
// then o = (p . v) in fp32, __fdiv_rn(o, denom), stored in bf16. The
// subtraction is __fsub_rn and the exponential expf (no exp2 with a log2(e)
// pre-scale, no --use_fast_math): both would move the bf16 roundings of p
// (and kF32Planes' e). Only the order of the fp32 sums differs from the
// plain version's.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s; 132
// SMs at 16 exponentials a clock each). At ViT-L/14@336 with B = 256
// (L = 577, D = 1024, 16 heads of 64), this route computes q . k^T twice:
//   6 B L^2 D = 523.7 GFLOP = 0.530 ms of tensor-core time
//   B H L^2   = 1.364 G exponentials, about 0.33 ms of MUFU time
//   4 B L D bf16 = 1.21 GB = 0.361 ms of device memory
// so its bound is 0.53 ms, by operations (the one-pass function's bound
// is 0.361 ms, by bytes). kF32Planes at the same shape (flash_attention's
// caller) adds two P . V products: 10 B L^2 D = 873 GFLOP = 0.883 ms (its
// function's bound stays 0.361 ms, by bytes). kT5 at T0-3B's encoder (B =
// 32, L = 557, 32
// heads of 64): 6 B H L^2 dh = 122 GFLOP = 0.123 ms, 318 M exponentials
// = 0.076 ms, and q, k, v, o, the bias and the mask, 332 MB = 0.099 ms,
// so 0.123 ms by operations; the bias is read in both passes, from L2
// after its first (2 x B x 47 MB of tiles = 3.0 GB of L2 reads a launch).
// The fp32 work around each exponential (the subtraction, expf's range
// reduction, the bf16 packing and the sum) is the same order of time on
// the CUDA cores, so the design overlaps it with the tensor cores.
//
// Design. The Pallas order forbids FlashAttention's online softmax:
// bf16(exp(s - m_partial)) exp(m_partial - m) does not round as
// bf16(exp(s - m)) does (nor, in kF32Planes, as the fp32 exp(s - m)). So
// the kernel makes two passes over the keys:
//   grid      persistent: one block an SM walks over the (128-query tile,
//             head, image) items, query tiles fastest, item i on block i
//             mod the grid, so that the blocks at work hold neighbouring
//             items (the tiles of one (image, head) together, finding its
//             K and V in L2), and the loads of the next item overlap the
//             end of this one. kT5 orders them (query tile, batch row,
//             head): the blocks at work then share one head's (L, L) bias
//             in L2 as well. Two consumer warpgroups of 64 query rows each
//             and one producer warp (288 threads).
//   loads     the producer's one thread keeps a ring of STAGES tiles of 64
//             keys x dh in flight with TMA on mbarriers (full: the bytes
//             have landed; empty: both warpgroups are done with the slot),
//             in the order the consumers take them: per item its Q (two
//             buffers), K_0 .. K_n-1 for pass 1, then K_0, V_0, K_1, V_1,
//             ... for pass 2. A 3-D tensor map over (B, L, H dh) with a box
//             of (1, 64, PC), PC = min(dh, 64) columns, swizzled by PC * 2
//             bytes (128 at dh = 64): rows past L come in as zeros and
//             never hold the next image's. dh = 128 takes two boxes a tile.
//             Q has a map (and a length) of its own, K and V theirs.
//   Q         each warpgroup reads its 64 rows once into registers, as the
//             A fragments of q . k^T, and frees the buffer: the products
//             then read only K and V from shared memory.
//   pass 1    S = Q . K^T with wgmma.m64n64k16 (the K tile a K-major B),
//             two tiles a round back to back, a max over the accumulators
//             of the keys below Lk (a zero-filled key row scores 0 and must
//             not join it), then across the quad of threads of a row.
//   kT5 terms the bias comes tiled (t5_bias_tiles, once an encode): for
//             each head, 64-query block and 64-key tile, a 16 KB block
//             holding each consumer thread's 32 values of the tile, in its
//             accumulators' order, 16 bytes apart from its neighbours'. The
//             producer's lane 0 copies each key tile's two blocks (one a
//             warpgroup) into a ring of their own with one bulk copy each,
//             after the tile's K in both passes, and its 32 lanes make the
//             tile's 64 key-mask bits (a coalesced load and two ballots;
//             keys past L, never used, count as kept); the consumer
//             threads read their values with eight conflict-free 16-byte
//             loads and add them, and the masked keys' -1e9, in the same
//             order in both passes, so both see the same s. A tile whose
//             keys the mask all keeps skips the + 0 (only a -0 would become
//             +0, which changes neither the max nor the exponentials). (On
//             an H100 the kernel took 2.64 ms reading the (H, L, L) bias
//             with 4-byte loads in the accumulator layout, 8 cache lines a
//             warp load; 1.53 with the mask read a column at a time; 0.95
//             with the bias in swizzled TMA boxes, two 8-byte loads with
//             2-way bank conflicts where one 16-byte load does now.)
//   kF32Planes terms  the optional bias by plain 4-byte loads through its
//             strides, added in both passes in the same order (no shipped
//             caller passes one; the CLIP tower's has none).
//   pass 2    S again, tile by tile; e from it as above (keys at or past Lk
//             get exactly 0) and the fp32 row sums in registers; p = bf16(e)
//             packed straight into the A fragments of the P . V wgmma (the
//             m64n64 accumulator layout is the m64k16 A layout), O += P . V
//             with the V tile as an MN-major B. kF32Planes packs e's three
//             planes into three sets of A fragments and issues three P . V
//             products against the same V tile into ONE set of
//             accumulators, lo, mid, then hi within each tile. (Three sets,
//             lo, mid and hi apart, added (lo + mid) + hi at the end, keep
//             more of lo's small products, which the tensor cores truncate
//             against a larger running sum; but with the exponentials'
//             tile, Q and the planes they need 192 of the 168 registers a
//             thread has at dh = 64. On an H100 at ViT-L/14@336, B = 256:
//             three sets spilled and took 5.6 ms, two 4.3, one 3.05; the
//             outputs that differ from the plain version at all went from
//             0.046 % to 0.113 % of 16 images', every one within one ulp.)
//   overlap   wgmma stays asynchronous: the next tile's Q . K^T and this
//             tile's P . V are issued together, and the next tile's
//             exponentials run (in place, in its accumulators) while P . V
//             does; each wait counts the same groups on every path, so that
//             ptxas keeps the products asynchronous (no C7513 / C7514
//             serialization). The two warpgroups overlap each other's waits.
//   epilogue  the sums across the quad, __fdiv_rn, bf16; rows past Lq are
//             not stored.
// Any Lq, Lk >= 1 (no shared-memory limit on either) and dh of 16, 32, 64
// or 128. An mbarrier wait that lasts seconds traps (a deadlock fails the
// launch instead of hanging the card).
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

enum Softmax : int { kBf16Sum = 0, kFastExp = 1, kT5 = 2, kF32Planes = 3 };

constexpr float MASK_NEG = -1e9f;  // kT5's score of a masked key, added
constexpr float PAD_SCORE = -1e9f;  // kF32Planes: JAX's padded keys' score

// kF32Planes' terms: the fp32 bias at b sb + h sh + i sq + j sk (strides in
// elements, 0 on broadcast axes), or null; JAX's n_pad padded keys.
struct FlashTerms {
  const float* bias;
  long long sb, sh, sq, sk;
  int n_pad;
};

constexpr int ROWS = 64;                  // query rows a warpgroup; keys a tile
constexpr int CONSUMERS = 2;              // consumer warpgroups
constexpr int BQ = CONSUMERS * ROWS;      // query rows a block
constexpr int NT = CONSUMERS * 128 + 32;  // and one producer warp
constexpr int STAGES = 6;                 // K / V tiles in flight

// kT5's bias tiles: 128 query rows x 64 keys of fp32, a 16 KB block of
// t5_bias_tiles a warpgroup, in a ring of their own (fewer stages at dh =
// 128, to fit the block's 227 KB).
constexpr int BIAS_BLOCK_BYTES = ROWS * ROWS * 4;  // 16 KB
constexpr int BIAS_TILE_BYTES = CONSUMERS * BIAS_BLOCK_BYTES;  // 32 KB

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

template <int DH, int MODE>
__host__ __device__ constexpr int bias_stages() {
  return MODE != kT5 ? 0 : (DH == 128 ? 2 : 4);
}

template <int DH, int MODE>
constexpr size_t smem_bytes() {
  constexpr int NB = bias_stages<DH, MODE>();
  return static_cast<size_t>(2 * CONSUMERS + STAGES) * Tile<DH>::BYTES
         + static_cast<size_t>(NB) * BIAS_TILE_BYTES
         + (2 * STAGES + 4 + 3 * NB) * sizeof(uint64_t)  // barriers, keep
         + Tile<DH>::ALIGN;                               // slack
}

// The attention grid: (query tiles, H, B), within CUDA's limits.
inline bool shape_ok(int B, int L, int H) {
  return B > 0 && L > 0 && H > 0 && B <= 65535 && H <= 65535 &&
         static_cast<long long>(B) * L <= 0x7fffffff;
}

// ---- PTX: shared-memory addresses, mbarriers, TMA, wgmma (hopper_async.cuh)

using hopper_async::bulk_load;
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
using hopper_async::wgmma_rs;
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

// ---- the kernel -------------------------------------------------------------

template <int DH, int MODE>
__global__ void __launch_bounds__(NT, 1)
attention_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 bf16* __restrict__ out, int B, int Lq, int Lk, int H,
                 const float* __restrict__ bias_tiles,
                 const int* __restrict__ mask, const FlashTerms flash) {
  using T = Tile<DH>;
  constexpr bool T5 = MODE == kT5;
  constexpr bool PLANES = MODE == kF32Planes;
  constexpr int NB = bias_stages<DH, MODE>();
  const int tiles = (Lk + ROWS - 1) / ROWS;  // key tiles
  const int q_tiles = (Lq + BQ - 1) / BQ;
  const int items = q_tiles * H * B;  // the query tile fastest
  // item -> its first query row, head and image: (query tile, head,
  // image), kT5 (query tile, batch row, head)
  auto coords = [&](int item, int& q0, int& h, int& b) {
    q0 = item % q_tiles * BQ;
    if (T5) {
      b = item / q_tiles % B;
      h = item / (q_tiles * B);
    } else {
      h = item / q_tiles % H;
      b = item / (q_tiles * H);
    }
  };
  extern __shared__ unsigned char att_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(att_smem_raw) + T::ALIGN - 1) &
      ~static_cast<uintptr_t>(T::ALIGN - 1));
  // two Q buffers of one tile a warpgroup, then the ring
  unsigned char* qs = smem;
  unsigned char* ring = smem + 2 * CONSUMERS * T::BYTES;
  // kT5: the bias ring after the K / V ring (both on 1024 bytes)
  unsigned char* bias_ring = ring + STAGES * T::BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_ring +
                                               NB * BIAS_TILE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;  // two of each
  uint64_t* q_empty = q_full + 2;
  uint64_t* b_full = q_empty + 2;  // kT5: NB of each
  uint64_t* b_empty = b_full + NB;
  uint64_t* b_keep = b_empty + NB;  // kT5: each slot's key-mask bits

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], CONSUMERS);
    }
    for (int s = 0; s < NB; ++s) {
      mbar_init(&b_full[s], 2);  // the copies' bytes and the keep bits
      mbar_init(&b_empty[s], CONSUMERS * 4);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {  // the producer warp: its lane 0 issues every load
    // (kT5: all its lanes read each bias tile's key mask)
    const int lane = threadIdx.x % 32;
    if (!T5 && lane != 0) return;
    int t = 0;   // loads issued
    int bt = 0;  // kT5: bias tiles issued
    int n = 0;   // items begun
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      int q0, h, b;
      coords(item, q0, h, b);
      const int col0 = h * DH;
      uint64_t* qbar = &q_full[n % 2];
      if (lane == 0) {
        if (n >= 2) mbar_wait(&q_empty[n % 2], (n / 2 - 1) & 1);
        mbar_expect_tx(qbar, CONSUMERS * T::BYTES);
        for (int w = 0; w < CONSUMERS; ++w) {
          for (int p = 0; p < T::PANELS; ++p) {
            tma_load_3d(qs + ((n % 2) * CONSUMERS + w) * T::BYTES +
                            p * T::PANEL_BYTES,
                        &map_q, qbar, col0 + p * T::PC, q0 + w * ROWS, b);
          }
        }
      }
      auto load = [&](const CUtensorMap* map, int j) {
        const int slot = t % STAGES;
        if (lane == 0) {
          if (t >= STAGES) mbar_wait(&empty[slot], (t / STAGES - 1) & 1);
          mbar_expect_tx(&full[slot], T::BYTES);
          for (int p = 0; p < T::PANELS; ++p) {
            tma_load_3d(ring + slot * T::BYTES + p * T::PANEL_BYTES, map,
                        &full[slot], col0 + p * T::PC, j * ROWS, b);
          }
        }
        ++t;
      };
      // kT5: key tile j's bias rows of the item's 128 queries, after its
      // K, and which of its 64 keys the batch row's mask keeps (bit c for
      // key 64 j + c; keys at or past L, never used, count as kept, so
      // that a last tile with all its keys kept takes the fast path)
      const int* mask_b = T5 ? mask + static_cast<size_t>(b) * Lk : nullptr;
      auto load_bias = [&](int j) {
        if constexpr (T5) {
          const int slot = bt % NB;
          if (lane == 0) {
            if (bt >= NB) mbar_wait(&b_empty[slot], (bt / NB - 1) & 1);
            mbar_expect_tx(&b_full[slot], BIAS_TILE_BYTES);
            for (int w = 0; w < CONSUMERS; ++w) {
              // block (h, 64-query block q0 / 64 + w, key tile j)
              const size_t blk =
                  (static_cast<size_t>(h) * 2 * q_tiles + q0 / ROWS + w) *
                      tiles + j;
              bulk_load(bias_ring + slot * BIAS_TILE_BYTES +
                            w * BIAS_BLOCK_BYTES,
                        bias_tiles + blk * (BIAS_BLOCK_BYTES / 4),
                        BIAS_BLOCK_BYTES, &b_full[slot]);
            }
          }
          const int k0 = j * ROWS + lane;
          const bool lo = k0 >= Lk || __ldg(mask_b + k0) > 0;
          const bool hi = k0 + 32 >= Lk || __ldg(mask_b + k0 + 32) > 0;
          const uint64_t keep =
              static_cast<uint64_t>(__ballot_sync(0xffffffffu, lo)) |
              static_cast<uint64_t>(__ballot_sync(0xffffffffu, hi)) << 32;
          if (lane == 0) {  // after the slot's wait above
            b_keep[slot] = keep;
            mbar_arrive(&b_full[slot]);
          }
          ++bt;
        }
      };
      for (int j = 0; j < tiles; ++j) {
        load(&map_k, j);
        load_bias(j);
      }
      for (int j = 0; j < tiles; ++j) {
        load(&map_k, j);
        load(&map_v, j);
        load_bias(j);
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
  int b0 = 0;  // kT5: the first bias tile of this item
  int n = 0;   // items begun
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    int q0, h, b;
    coords(item, q0, h, b);
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

    // kT5: s = (s + bias) + key_bias in place for bias tile u of the item
    // (pass 1's key tiles, then pass 2's), both from its ring slot: the
    // thread's 32 bias values (t5_bias_tiles' order: its accumulators',
    // 16 bytes apart from its neighbours') and the key-mask bits; then this
    // warp's arrival frees the slot
    auto add_bias = [&](float(&s)[32], int u) {
      const int slot = (b0 + u) % NB;
      mbar_wait(&b_full[slot], ((b0 + u) / NB) & 1);
      const uint64_t keep = b_keep[slot];
      const float4* mine = reinterpret_cast<const float4*>(
                               bias_ring + slot * BIAS_TILE_BYTES +
                               wg * BIAS_BLOCK_BYTES) +
                           tid;
      // a tile whose keys the mask all keeps (the warp's common case)
      // skips the + 0
      auto terms = [&](auto masked) {
        constexpr bool MASKED = decltype(masked)::value;
#pragma unroll
        for (int g = 0; g < 8; ++g) {  // n8 group g: elements 4 g .. + 3
          const float4 bv = mine[g * 128];
          const float add[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * g + e;
            s[i] = __fadd_rn(s[i], add[e]);
            if (MASKED) {
              const int col = 8 * g + c2 + e % 2;
              s[i] = __fadd_rn(s[i], (keep >> col) & 1 ? 0.0f : MASK_NEG);
            }
          }
        }
      };
      if (keep == ~0ull) terms(std::false_type());
      else terms(std::true_type());
      __syncwarp();
      if (lane == 0) {
        // the generic reads above come before the next bulk copy's writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&b_empty[slot]);
      }
    };

    // kF32Planes: s = s + bias in place for key tile jj (rows past Lq and
    // keys past Lk, never used, take none)
    const int qi = q0 + wg * ROWS + r;  // the thread's first query row
    auto add_flash_bias = [&](float(&s)[32], int jj) {
      if (!PLANES || flash.bias == nullptr) return;
      const float* brow = flash.bias + b * flash.sb + h * flash.sh +
                          qi * flash.sq + jj * ROWS * flash.sk;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + c2 + i % 2;
        const int half = (i / 2) % 2;
        if (qi + 8 * half < Lq && jj * ROWS + col < Lk) {
          s[i] = __fadd_rn(
              s[i], __ldg(brow + 8 * half * flash.sq + col * flash.sk));
        }
      }
    };

    // ---- pass 1: the row max over the keys below Lk ------------------------
    float sa[32], sb[32];
    // JAX's padded keys score -1e9
    float m0 = PLANES && flash.n_pad > 0 ? PAD_SCORE : -INFINITY;
    float m1 = m0;
    auto row_max = [&](const float(&s)[32], int j) {
      const int lim = Lk - j * ROWS;  // keys of this tile below Lk
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
      if constexpr (T5) {
        add_bias(sa, j);
        add_bias(sb, j + 1);
      }
      add_flash_bias(sa, j);
      add_flash_bias(sb, j + 1);
      row_max(sa, j);
      row_max(sb, j + 1);
    }
    if (j < tiles) {
      issue_scores(sa, j);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sa);
      release(j);
      if constexpr (T5) add_bias(sa, j);
      add_flash_bias(sa, j);
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
    // kF32Planes: e's lo and mid planes as A fragments of their own (pa
    // holds hi)
    uint32_t pa_low[2][PLANES ? 4 : 1][4];
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
      if (PLANES) {  // e itself, fp32
        const float e = expf(__fsub_rn(s, m));
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
      const int lim = Lk - jj * ROWS;
      if (lim >= ROWS) exponentials(s, lim, std::false_type());
      else exponentials(s, lim, std::true_type());
    };
    // p = bf16(e) into the A fragments: k step kk's are the elements
    // 8 kk .. 8 kk + 7 of the accumulator, in order (kF32Planes: e's hi
    // plane there, mid and lo into pa_low)
    auto pack = [&](const float(&e)[32]) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int hh = 0; hh < 4; ++hh) {
          const int i = 8 * kk + 2 * hh;
          const __nv_bfloat162 p = __floats2bfloat162_rn(e[i], e[i + 1]);
          pa[kk][hh] = *reinterpret_cast<const uint32_t*>(&p);
          if constexpr (PLANES) {
            const float2 hi = __bfloat1622float2(p);
            const float r0 = __fsub_rn(e[i], hi.x);
            const float r1 = __fsub_rn(e[i + 1], hi.y);
            const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
            const float2 mf = __bfloat1622float2(mid);
            const __nv_bfloat162 lo = __floats2bfloat162_rn(
                __fsub_rn(r0, mf.x), __fsub_rn(r1, mf.y));
            pa_low[0][kk][hh] = *reinterpret_cast<const uint32_t*>(&lo);
            pa_low[1][kk][hh] = *reinterpret_cast<const uint32_t*>(&mid);
          }
        }
      }
    };
    auto fence_pv = [&]() {
      fence_operands(o);
      fence_operands(pa);
      if constexpr (PLANES) {
        fence_operands(pa_low[0]);
        fence_operands(pa_low[1]);
      }
    };
    // O += P . V_j, asynchronously (one group); kF32Planes: lo, mid, then
    // hi against the same V tile, into the same accumulators
    auto issue_pv = [&](int jj) {
      const int v_load = k_load(jj) + 1;
      wait_full(v_load);
      const uint32_t v_tile = tile_addr(v_load);
      fence_pv();
      wgmma_fence();
      if constexpr (PLANES) {
#pragma unroll
        for (int pl = 0; pl < 2; ++pl) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_rs<1>(o, pa_low[pl][kk], mn_major_desc<DH>(v_tile, kk), 1);
          }
        }
      }
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
    if constexpr (T5) add_bias(sa, tiles);
    add_flash_bias(sa, 0);
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
      if constexpr (T5) add_bias(sa, tiles + j + 1);
      add_flash_bias(sa, j + 1);
      tile_exponentials(sa, j + 1);
      wgmma_wait<0>();
      fence_pv();
      release(k_load(j) + 1);
      pack(sa);
    }
    issue_pv(tiles - 1);
    wgmma_wait<0>();
    fence_pv();
    release(k_load(tiles - 1) + 1);

    // ---- the division after PV and the store -------------------------------
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 = __fadd_rn(sum0, __shfl_xor_sync(0xffffffffu, sum0, off));
      sum1 = __fadd_rn(sum1, __shfl_xor_sync(0xffffffffu, sum1, off));
    }
    if (PLANES && flash.n_pad > 0) {  // the padded keys' exp(-1e9 - m)
      const float pad = static_cast<float>(flash.n_pad);
      sum0 = __fadd_rn(sum0, __fmul_rn(pad, expf(__fsub_rn(PAD_SCORE, m0))));
      sum1 = __fadd_rn(sum1, __fmul_rn(pad, expf(__fsub_rn(PAD_SCORE, m1))));
    }
    const int HD = H * DH;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = qi + 8 * half;
      if (row >= Lq) continue;
      const float denom = half ? sum1 : sum0;
      bf16* dst = out + (static_cast<size_t>(b) * Lq + row) * HD + h * DH + c2;
#pragma unroll
      for (int g = 0; g < DH / 8; ++g) {
        const int i = 4 * g + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * g) = __floats2bfloat162_rn(
            __fdiv_rn(o[i], denom), __fdiv_rn(o[i + 1], denom));
      }
    }
    t0 += 3 * tiles;
    b0 += T5 ? 2 * tiles : 0;
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
              int Lq, int Lk, int H, const float* bias_tiles, const int* mask,
              const FlashTerms& flash, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    if (!encode_map<DH>(&maps[i], bases[i], B, i == 0 ? Lq : Lk, H)) {
      return cudaErrorInvalidValue;
    }
  }
  constexpr size_t smem = smem_bytes<DH, MODE>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<DH, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>((Lq + BQ - 1) / BQ) * H * B;
  const int grid = static_cast<int>(items < sms ? items : sms);
  attention_kernel<DH, MODE><<<grid, NT, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(out), B, Lq, Lk, H,
      bias_tiles, mask, flash);
  return static_cast<int>(cudaGetLastError());
}

// The attention of head size dh (16, 32, 64 or 128) in softmax order MODE
// (not kF32Planes) over q, k, v and out (B, L, H dh) bf16, each 16-byte
// aligned; kT5 also over the (H, L, L) fp32 bias in t5_bias_tiles' order
// (16-byte aligned) and mask (B, L) int32 (null otherwise). Returns its
// launch's cudaError_t (0 on success).
template <int MODE>
int attention_dh(const void* q, const void* k, const void* v, void* out,
                 int B, int L, int H, int dh, cudaStream_t stream,
                 const void* bias_tiles = nullptr,
                 const void* mask = nullptr) {
  static_assert(MODE != kF32Planes, "flash_dh launches kF32Planes");
  if (!shape_ok(B, L, H)) return cudaErrorInvalidValue;
  if (MODE == kT5 && (bias_tiles == nullptr || mask == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const float* bt = static_cast<const float*>(bias_tiles);
  const int* ms = static_cast<const int*>(mask);
  const FlashTerms none{nullptr, 0, 0, 0, 0, 0};
  switch (dh) {
    case 16:
      return attention<16, MODE>(q, k, v, out, B, L, L, H, bt, ms, none,
                                 stream);
    case 32:
      return attention<32, MODE>(q, k, v, out, B, L, L, H, bt, ms, none,
                                 stream);
    case 64:
      return attention<64, MODE>(q, k, v, out, B, L, L, H, bt, ms, none,
                                 stream);
    case 128:
      return attention<128, MODE>(q, k, v, out, B, L, L, H, bt, ms, none,
                                  stream);
    default: return cudaErrorInvalidValue;
  }
}

// kF32Planes (flash_attention) of head size dh (16, 32, 64 or 128) over q
// and out (B, Lq, H dh), k and v (B, Lk, H dh) bf16, each 16-byte aligned,
// with `flash`'s bias and padded keys. Returns its launch's cudaError_t (0
// on success).
inline int flash_dh(const void* q, const void* k, const void* v, void* out,
                    int B, int Lq, int Lk, int H, int dh,
                    const FlashTerms& flash, cudaStream_t stream) {
  if (!shape_ok(B, Lq, H) || !shape_ok(B, Lk, H) || flash.n_pad < 0) {
    return cudaErrorInvalidValue;
  }
  switch (dh) {
    case 16:
      return attention<16, kF32Planes>(q, k, v, out, B, Lq, Lk, H, nullptr,
                                       nullptr, flash, stream);
    case 32:
      return attention<32, kF32Planes>(q, k, v, out, B, Lq, Lk, H, nullptr,
                                       nullptr, flash, stream);
    case 64:
      return attention<64, kF32Planes>(q, k, v, out, B, Lq, Lk, H, nullptr,
                                       nullptr, flash, stream);
    case 128:
      return attention<128, kF32Planes>(q, k, v, out, B, Lq, Lk, H, nullptr,
                                        nullptr, flash, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace vit_attention_wgmma
