// The bf16 GEMM main loop on TMA and asynchronous wgmma, for NVIDIA Hopper
// (sm_90a): every product of fused_ln_qkv and fused_mlp_block
// (csrc/vit_block.cu), of fused_vit_block (csrc/vit_whole_block.cu), of
// fused_attention_block (csrc/attention_block.cu), of fused_t5_ffn
// (csrc/t5_ffn.cu) and of fused_gpt2_block (csrc/gpt2_block.cu). The bf16
// counterpart of q8_gemm_tma.cuh, with its design:
//
//   acc = a . b     a (M, K) bf16, K contiguous; b (K, N) bf16 in the JAX
//                   layout, N contiguous; fp32 accumulation
//
// The product's columns may come from up to three weights of n_split
// columns each (b_0 | b_1 | b_2, each (K, n_split), their rows ldb >=
// n_split elements apart), one tensor map each, and go to as many outputs
// (c_0 | c_1 | c_2, each (M, n_split)), so that q, k and v are one product
// over three separate weights, or over the column thirds of one fused (D,
// 3 D) weight (ldb = 3 D), with no copy. B may also hold fewer rows than
// K (b_rows, a multiple of 64 that divides K): its k coordinate then wraps,
// so that a (M, 3 D) . (3 D, D) product reads one (D, D) weight three
// times along K (an out-projection over three bf16 planes) with no
// stacked copy. In general (gemm_planes) A holds planes of `seg` columns
// side by side and B planes of `seg` rows one under the other, and K runs
// over up to eight segments, each the product of one A plane with one B
// plane, in the order of a table: fp32 operands split into three bf16
// planes each (hi + mid + lo = the fp32 value) give a product of fp32
// operands as exact bf16 products (attention_block.cu). The paired form
// (gemm_paired) computes two products over the same a, a . b_0 and a . b_1,
// into one output: a 256-column B tile is 128 columns of b_0 and the same
// 128 of b_1, so that n8 group j and group j + 16 of a thread's
// accumulators are the same output column of the two products (T5's gate,
// gelu(a . wi_0) * (a . wi_1), with no weight copy). Each kernel that
// includes this file brings its own epilogue arithmetic (Epi::chunk), given
// acc in the wgmma accumulator layout (element 4 j + e of a consumer thread
// is row 64 wg + 16 warp + lane / 4 + 8 (e / 2) of the tile and column 8 j
// + 2 (lane % 4) + e % 2 of its B tile); ResidualEpilogue, QkvEpilogueOf,
// BiasEpilogueOf and BiasQuickGeluEpilogueOf below are the ones they share.
// The outputs are bf16, or fp32 where the epilogue names `using Out =
// float` (the whole blocks' residual r1, fused_attention_block's fp32 q, k
// and v).
//
// Design (persistent and warp-specialised, on TMA and asynchronous wgmma):
//   grid      persistent: one block an SM walks over the output tiles, N
//             tiles fastest within a band of 128 rows, tile i on block i
//             mod the grid, so that the blocks at work share their A bands
//             and the weights stay in L2.
//   loads     a producer warpgroup hands its registers back (setmaxnreg)
//             and one of its threads keeps a ring of STAGES k steps in
//             flight with TMA on mbarriers (full: the bytes have landed;
//             empty: every consumer warp is done with the slot). A k step
//             is 64 elements, one 128-byte swizzle row: A as one box of
//             (64, 128 rows), K-major; B as BN / 64 boxes of (64 columns,
//             64 k rows), each a 64-column panel of the tile, 128-byte
//             swizzled. Rows past M are zero-filled by TMA.
//   products  two consumer warpgroups of 64 rows each issue the k step's
//             four wgmma.m64nBNk16.f32.bf16.bf16 through swizzled
//             descriptors: A K-major (32 bytes further a k16 step), B
//             MN-major (the transpose bit; 16 k rows = 2048 bytes further a
//             step, the 64-column panels LBO = 8192 bytes apart, 8-row
//             groups SBO = 1024 apart), then wait_group 1: the previous
//             step's products are settled while this step's run, and only
//             then is its slot released. Every wait counts the same groups
//             on every path, and no register an in-flight product reads is
//             rewritten, so ptxas keeps the products asynchronous.
//   tiles     128 x 256 (128 fp32 accumulators a thread) where n_split %
//             256 == 0 and the grid of such tiles has one for every SM,
//             or the product is paired (128 output columns), else 128 x
//             128 (GPT-2's out-projection and down product at M = 2,048:
//             48 wide tiles for 132 SMs, 96 narrow ones); either width sums
//             each output's k steps in the same order. The consumers take
//             240 registers a thread (setmaxnreg), the producer keeps 24,
//             though ptxas compiles the whole kernel within 168 (384
//             threads, one block an SM), 128 of them the accumulators. The
//             ring and the epilogue's buffers take 224 KB of shared memory.
//   epilogue  the kernel's arithmetic from registers, 64 columns at a
//             time, into shared memory (two 8 KB buffers a warpgroup,
//             128-byte swizzled rows: the writes are free of bank
//             conflicts), then TMA stores, which drain while the warpgroup
//             goes on (rows past M are not written); the producer fills the
//             next tile's stages meanwhile. A bf16 chunk is one 64 x 64 box
//             in one buffer, the chunks alternating; an fp32 chunk is two
//             64 x 32 boxes (128-byte rows too) in both buffers, so that it
//             waits for the previous chunk's stores to have read them.
//             (Stored straight from registers, 4 bytes a thread, the
//             epilogue took 0.6 of fused_ln_qkv's 1.7 ms GEMM on an H100.)
//             Nothing overlaps the epilogue's arithmetic with the
//             warpgroup's next products; only the producer runs ahead.
// Shapes: any M, K a multiple of 64, n_split a multiple of 128, one to
// three weights, or two paired (shape_ok). An mbarrier wait that lasts
// seconds traps. Built with BF16_GEMM_TMA_BARE_EPILOGUE defined, every
// epilogue only rounds acc (the first product's, when paired) to its
// output type: a measurement of the loop without its epilogue's arithmetic
// and reads (tools/kernel_probe.py --epilogue-cost), whose outputs are not
// the function's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "activations.cuh"
#include "hopper_async.cuh"

namespace bf16_gemm_tma {

namespace ha = hopper_async;

constexpr int BM = 128;                    // rows a tile, 64 a warpgroup
constexpr int BK = 64;                     // elements of a k step
constexpr int PANEL = 64;                  // columns of a B box
constexpr int CONSUMERS = 2;               // consumer warpgroups
constexpr int NT = (CONSUMERS + 1) * 128;  // and the producer warpgroup
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 64,512 in all
constexpr int RING_BYTES = 192 * 1024;     // of the 227 KB a block may use
constexpr int MAX_B = 3;                   // weights of one product
constexpr int OUT_BOX = 64;                // rows and bf16 columns of a box
constexpr int OUT_BOX_BYTES = OUT_BOX * OUT_BOX * 2;  // 8 KB, 128 B a row
constexpr int OUT_BYTES = CONSUMERS * 2 * OUT_BOX_BYTES;  // two a warpgroup

template <int BN_>
struct Tiles {
  static constexpr int BN = BN_;                      // 256 or 128
  static constexpr int A_BYTES = BM * BK * 2;         // 16 KB
  static constexpr int PANEL_BYTES = BK * PANEL * 2;  // 8 KB
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES =
      RING_BYTES / STAGE_BYTES < 8 ? RING_BYTES / STAGE_BYTES : 8;
  static constexpr int ACC = BN / 2;  // accumulator elements a thread
  static constexpr size_t SMEM =
      static_cast<size_t>(STAGES) * STAGE_BYTES + OUT_BYTES +
      2 * STAGES * sizeof(uint64_t) + 1024;  // ring, stores, barriers, slack
};

// The tensor maps of the weights (and of the outputs): column c of the
// product is column c % n_split of weight (output) c / n_split.
struct BMaps {
  CUtensorMap map[MAX_B];
};

// N output columns, each output (and weight) n_split of them. K runs over
// K / seg segments (at most MAX_SEGMENTS); segment i reads A's columns from
// a_plane(i) seg on and the weights' rows from b_plane(i) seg on, its
// planes 4 bits each at bits 4 i of a_planes and b_planes. A has a_cols
// columns and each weight b_rows rows (the host's tensor maps).
struct Problem {
  int M, K, N, n_split, seg;
  uint32_t a_planes, b_planes;
  int a_cols, b_rows;
};
constexpr int MAX_SEGMENTS = 8;
constexpr uint32_t IDENTITY_PLANES = 0x76543210u;  // segment i, plane i

// The output type of an epilogue: Epi::Out where it names one (fp32), else
// bf16.
template <class Epi, class = void>
struct OutOf {
  using type = __nv_bfloat16;
};
template <class Epi>
struct OutOf<Epi, std::void_t<typename Epi::Out>> {
  using type = typename Epi::Out;
};

// One of the first three maps of `maps` (a dynamic index into a
// __grid_constant__ array would copy it to local memory).
__device__ inline const CUtensorMap* pick(const BMaps& maps, int i) {
  return i == 0 ? &maps.map[0] : (i == 1 ? &maps.map[1] : &maps.map[2]);
}

// The columns of the tiles the loop takes for an (M, N) product of weights
// of n_split columns on `sms` SMs: 256 where n_split allows and the grid of
// such tiles has one for every SM, else 128.
inline int tile_width(int M, int N, int n_split, int sms) {
  if (n_split % 256 != 0) return 128;
  const long long wide = static_cast<long long>((M + BM - 1) / BM) * (N / 256);
  return wide < sms ? 128 : 256;
}

// Two neighbouring elements as they lie in memory (bf16 or fp32), and as
// floats: loads of a chunk keep them packed until used (the registers left
// beside the accumulators are few).
template <typename T>
struct Pair {
  using type = __nv_bfloat162;
};
template <>
struct Pair<float> {
  using type = float2;
};
template <typename T>
__device__ inline typename Pair<T>::type load_pair(const T* p) {
  return *reinterpret_cast<const typename Pair<T>::type*>(p);
}
__device__ inline float2 to_float2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}
__device__ inline float2 to_float2(float2 v) { return v; }

__device__ inline uint32_t pack_bf16(float v0, float v1) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

// Two neighbouring outputs as an epilogue hands them to put: packed bf16,
// or an fp32 pair.
template <typename Out>
struct OutPair {
  using type = uint32_t;
};
template <>
struct OutPair<float> {
  using type = float2;
};
template <typename Out>
__device__ inline typename OutPair<Out>::type pack_out(float v0, float v1) {
  if constexpr (std::is_same<Out, float>::value) {
    return make_float2(v0, v1);
  } else {
    return pack_bf16(v0, v1);
  }
}

#ifdef BF16_GEMM_TMA_BARE_EPILOGUE
// acc's chunk rounded to the output type and nothing else (see the file's
// head)
template <typename Out, int ACC, class Put>
__device__ inline void bare_chunk(const float (&acc)[ACC], int j0,
                                  const Put& put) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 4 * (j0 + jj) + 2 * half;
      put(jj, half, pack_out<Out>(acc[i], acc[i + 1]));
    }
  }
}
#endif

// (weights = 2 also for the paired form)
inline bool shape_ok(int M, int K, int n_split, int weights) {
  return M > 0 && K > 0 && K % BK == 0 && n_split > 0 &&
         n_split % 128 == 0 && weights >= 1 && weights <= MAX_B &&
         static_cast<long long>(n_split) * weights <= 0x7fffffff;
}

// The product over the tiles of the grid (PRODUCTS = 2: paired, BN / 2
// output columns a tile). Epi::chunk(args, which, row, col, acc, j0, put)
// gives the output pairs (pack_out<Out>) of one 64-column chunk of a
// thread's fragments, each by put(jj, half, pair) (a write to shared
// memory, so that a pair holds no register once made): for its n8 group j0
// + jj (columns col + 8 jj + 2 (lane % 4) and the next of output `which`;
// when paired, also group j0 + jj + BN / 16 of the second product) and row
// `row` + 8 half, `row` the thread's first; rows at or past M are never
// stored.
template <int BN, int PRODUCTS, class Epi>
__global__ void __launch_bounds__(NT, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ BMaps maps_b,
            const __grid_constant__ BMaps maps_c, const Problem p,
            const __grid_constant__ typename Epi::Args args) {
  using T = Tiles<BN>;
  using Out = typename OutOf<Epi>::type;
  constexpr int STAGES = T::STAGES;
  constexpr int OUT_N = BN / PRODUCTS;        // output columns a tile
  constexpr int PANELS = BN / PANEL / PRODUCTS;  // B boxes a product
  // a chunk's store boxes of 128-byte rows: one of 64 bf16 columns, or two
  // of 32 fp32 ones (both of the warpgroup's buffers); the chunks whose
  // stores may still read the buffers when the next one is written
  constexpr bool F32_OUT = std::is_same<Out, float>::value;
  constexpr int BOXES = F32_OUT ? 2 : 1;
  constexpr int BOX_COLS = OUT_BOX / BOXES;
  constexpr int IN_FLIGHT = 2 / BOXES;
  extern __shared__ unsigned char bf16_tma_smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(bf16_tma_smem_raw) + 1023) &
      ~static_cast<uintptr_t>(1023));
  unsigned char* out_buf = ring + STAGES * T::STAGE_BYTES;  // 1024-aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(out_buf + OUT_BYTES);
  uint64_t* empty = full + STAGES;
  const int tiles_n = p.N / OUT_N;
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
      const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * OUT_N;
      // a tile's columns lie in one weight (n_split % OUT_N == 0); paired,
      // the same columns of weights 0 and 1
      const int which = n0 / p.n_split;
      const int nb = n0 - which * p.n_split;
      // step s's segment and its k offset in the segment's planes
      int segment = 0, off = 0;
      for (int s = 0; s < steps; ++s, ++t) {
        const int slot = t % STAGES;
        if (t >= STAGES) ha::mbar_wait(&empty[slot], (t / STAGES - 1) & 1);
        ha::mbar_expect_tx(&full[slot], T::STAGE_BYTES);
        unsigned char* sa = ring + slot * T::STAGE_BYTES;
        const int ka = ((p.a_planes >> (4 * segment)) & 15) * p.seg + off;
        const int kb = ((p.b_planes >> (4 * segment)) & 15) * p.seg + off;
        ha::tma_load_2d(sa, &map_a, &full[slot], ka, m0);
#pragma unroll
        for (int pn = 0; pn < BN / PANEL; ++pn) {
          ha::tma_load_2d(sa + T::A_BYTES + pn * T::PANEL_BYTES,
                          pick(maps_b, PRODUCTS == 2 ? pn / PANELS : which),
                          &full[slot], nb + pn % PANELS * PANEL, kb);
        }
        off += BK;
        if (off == p.seg) {
          off = 0;
          ++segment;
        }
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
  auto issue = [&](float (&d)[T::ACC], int tt, bool first) {
    const int slot = tt % STAGES;
    ha::mbar_wait(&full[slot], (tt / STAGES) & 1);
    const uint32_t a = ring_addr + slot * T::STAGE_BYTES + wg * 64 * BK * 2;
    const uint32_t b = ring_addr + slot * T::STAGE_BYTES + T::A_BYTES;
    ha::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      ha::wgmma_ss<1>(d, ha::gmma_desc(a + 32 * kk, 16, 8 * BK * 2, 1),
                      ha::gmma_desc(b + kk * 16 * PANEL * 2, T::PANEL_BYTES,
                                    8 * PANEL * 2, 1),
                      (!first || kk > 0) ? 1 : 0);
    }
    ha::wgmma_commit();
  };

  const int wtid = threadIdx.x % 128;
  const int row = wtid / 32 * 16 + lane / 4;  // the thread's first, of 64
  int chunks = 0;  // epilogue chunks this warpgroup has stored
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * OUT_N;
    float acc[T::ACC];
    ha::fence_operands(acc);
    issue(acc, t, true);
    for (int s = 1; s < steps; ++s) {
      issue(acc, t + s, false);
      ha::wgmma_wait<1>();
      release(t + s - 1);
    }
    ha::wgmma_wait<0>();
    ha::fence_operands(acc);
    release(t + steps - 1);
    t += steps;

    // the epilogue: 64 columns at a time into swizzled buffers, then TMA
    // stores of the warpgroup's 64-row boxes
    const int which = n0 / p.n_split;
    const int col0 = n0 - which * p.n_split;
    const CUtensorMap* map_c = pick(maps_c, which);
#pragma unroll
    for (int c = 0; c < OUT_N / OUT_BOX; ++c, ++chunks) {
      unsigned char* buf =
          out_buf + (2 * wg + (F32_OUT ? 0 : chunks % 2)) * OUT_BOX_BYTES;
      if (chunks >= IN_FLIGHT) {  // the stores that last used buf read it
        if (wtid == 0) ha::bulk_wait_read<IN_FLIGHT - 1>();
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      }
      // the pair of n8 group jj of the chunk, row `row` + 8 half, into its
      // place in the swizzled box, as soon as the epilogue has it: bf16,
      // 4 bytes in 16-byte unit jj of the row; fp32, 8 bytes in unit 2 (jj
      // % 4) + (lane % 4) / 2 of box jj / 4
      const auto put = [&](int jj, int half,
                           typename OutPair<Out>::type pair) {
        const int r = row + 8 * half;
        if constexpr (F32_OUT) {
          const int u = 2 * (jj % 4) + (lane % 4) / 2;
          *reinterpret_cast<float2*>(buf + (jj / 4) * OUT_BOX_BYTES +
                                     r * 128 + ((u ^ (r % 8)) << 4) +
                                     8 * (lane % 2)) = pair;
        } else {
          *reinterpret_cast<uint32_t*>(buf + r * 128 +
                                       ((jj ^ (r % 8)) << 4) +
                                       4 * (lane % 4)) = pair;
        }
      };
#ifdef BF16_GEMM_TMA_BARE_EPILOGUE
      bare_chunk<Out>(acc, 8 * c, put);
#else
      Epi::chunk(args, which, m0 + 64 * wg + row, col0 + OUT_BOX * c, acc,
                 8 * c, put);
#endif
      // the generic writes above come before the TMA's reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      if (wtid == 0) {
#pragma unroll
        for (int b = 0; b < BOXES; ++b) {
          ha::tma_store_2d(map_c, buf + b * OUT_BOX_BYTES,
                           col0 + OUT_BOX * c + BOX_COLS * b, m0 + 64 * wg);
        }
        ha::bulk_commit();
      }
    }
  }
  if (wtid == 0) ha::bulk_wait<0>();  // shared memory outlives the stores
}

// out = res + (acc + bias) (BIAS) or res + acc, the sums in fp32, rounded
// once to OutT (bf16, or fp32: not rounded): res (M, ld) of ResT (bf16 or
// fp32), bias (n_split,) of BiasT (bf16, or fp32: the GPT-2 block's fp32
// form, whose fp32 parameters JAX adds unrounded). The whole blocks'
// out-projection writes their fp32 r1 (ResT bf16, OutT fp32), their down
// product adds it (ResT fp32, OutT bf16). A chunk's bias and residual are
// all read, packed, before its arithmetic and its stores: loads issued one
// at a time between stores, each waiting for memory in turn, took longer
// than a tile's products (q8_gemm_tma.cuh's epilogues, on an H100); its
// pairs go to shared memory at the end, which kept the 256-wide tiles free
// of spills. (Loading the residual's 64 x 64
// box by TMA into the staging buffer instead took the same time.)
template <typename ResT, bool BIAS, typename OutT = __nv_bfloat16,
          typename BiasT = __nv_bfloat16>
struct ResidualEpilogue {
  using Out = OutT;
  struct Args {
    const BiasT* bias;  // BIAS only
    const ResT* residual;
    int M, ld;
  };
  template <int ACC, class Put>
  __device__ static void chunk(const Args& args, int /*which*/, int row,
                               int col, const float (&acc)[ACC], int j0,
                               const Put& put) {
    using RawRes = typename Pair<ResT>::type;
    const int c = col + 2 * (threadIdx.x % 4);
    typename Pair<BiasT>::type bv[8];
    RawRes rv[2][8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      if (BIAS) bv[jj] = load_pair(args.bias + c + 8 * jj);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // rows past M read the last row's values, which are never stored
      const int r = min(row + 8 * half, args.M - 1);
      const ResT* res = args.residual + static_cast<size_t>(r) * args.ld + c;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) rv[half][jj] = load_pair(res + 8 * jj);
    }
    typename OutPair<OutT>::type out[16];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * (j0 + jj) + 2 * half;
        float v0 = acc[i], v1 = acc[i + 1];
        if (BIAS) {
          const float2 b = to_float2(bv[jj]);
          v0 = __fadd_rn(v0, b.x);
          v1 = __fadd_rn(v1, b.y);
        }
        const float2 r = to_float2(rv[half][jj]);
        out[2 * jj + half] =
            pack_out<OutT>(__fadd_rn(r.x, v0), __fadd_rn(r.y, v1));
      }
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      put(jj, 0, out[2 * jj]);
      put(jj, 1, out[2 * jj + 1]);
    }
  }
};

// The q | k | v product's epilogue, weights (and outputs) 0, 1, 2 for q, k
// and v: OutT((acc + bias) * scale) for q, OutT(acc + bias) for k and v
// (fused_ln_qkv's and the GPT-2 block's in bf16, fused_attention_block's in
// fp32); with ROUND_FIRST, q = bf16(bf16(acc + bias) * scale), the scale
// bf16 too (fused_attention_block's bf16 compute_dtype, whose Pallas kernel
// scales the bf16 q by a bf16 scale). The biases are of BiasT (bf16, or
// fp32 in the GPT-2 block's fp32 form).
template <typename OutT = __nv_bfloat16, bool ROUND_FIRST = false,
          typename BiasT = __nv_bfloat16>
struct QkvEpilogueOf {
  using Out = OutT;
  struct Args {
    const BiasT* bias[3];  // bq, bk, bv (n_split,)
    float scale;           // the factor of the q columns
  };
  template <int ACC, class Put>
  __device__ static void chunk(const Args& args, int which, int /*row*/,
                               int col, const float (&acc)[ACC], int j0,
                               const Put& put) {
    const BiasT* bias =
        which == 0 ? args.bias[0] : (which == 1 ? args.bias[1] : args.bias[2]);
    const int c = col + 2 * (threadIdx.x % 4);
    float2 bv[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      bv[jj] = to_float2(load_pair(bias + c + 8 * jj));
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * (j0 + jj) + 2 * half;
        float v0 = __fadd_rn(acc[i], bv[jj].x);
        float v1 = __fadd_rn(acc[i + 1], bv[jj].y);
        if (which == 0) {
          if (ROUND_FIRST) {
            v0 = __bfloat162float(__float2bfloat16(v0));
            v1 = __bfloat162float(__float2bfloat16(v1));
          }
          v0 = __fmul_rn(v0, args.scale);
          v1 = __fmul_rn(v1, args.scale);
        }
        put(jj, half, pack_out<OutT>(v0, v1));
      }
    }
  }
};
using QkvEpilogue = QkvEpilogueOf<>;

// out = OutT(acc + bias), bias (n_split,) of BiasT (fused_attention_block's
// out-projection: bf16 or fp32 out and bias).
template <typename OutT = __nv_bfloat16, typename BiasT = __nv_bfloat16>
struct BiasEpilogueOf {
  using Out = OutT;
  struct Args {
    const BiasT* bias;
  };
  template <int ACC, class Put>
  __device__ static void chunk(const Args& args, int /*which*/, int /*row*/,
                               int col, const float (&acc)[ACC], int j0,
                               const Put& put) {
    const int c = col + 2 * (threadIdx.x % 4);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 b = to_float2(load_pair(args.bias + c + 8 * jj));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * (j0 + jj) + 2 * half;
        put(jj, half, pack_out<OutT>(__fadd_rn(acc[i], b.x),
                                     __fadd_rn(acc[i + 1], b.y)));
      }
    }
  }
};
using BiasEpilogue = BiasEpilogueOf<>;

// The ViT MLP's up product: hid = bf16(quickGELU(acc + bias)), the bias
// bf16 or fp32, the sigmoid's reciprocal branch-free (activations.cuh's
// quick_gelu_fast) where every z of the thread's chunk is at least
// QUICK_GELU_FAST_FLOOR, else (rare) with quick_gelu's correctly rounded
// division. The test comes first, so that no accumulator outlives its use
// (a redo after the fast pass kept the chunk's 32 alive: 0.2 of a 2.6 ms
// up-GEMM at ViT-L, B=256, on an H100).
template <typename BiasT>
struct BiasQuickGeluEpilogueOf {
  struct Args {
    const BiasT* bias;  // (F,)
  };
  template <int ACC, class Put>
  __device__ static void chunk(const Args& args, int, int, int col,
                               const float (&acc)[ACC], int j0,
                               const Put& put) {
    namespace act = activations;
    const BiasT* bias = args.bias + col + 2 * (threadIdx.x % 4);
    float z[8][4];  // z[jj][2 half + e], in place of the chunk's acc
    bool low = false;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 b = to_float2(load_pair(bias + 8 * jj));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        z[jj][e] = __fadd_rn(acc[4 * (j0 + jj) + e], e % 2 ? b.y : b.x);
        low |= !(z[jj][e] >= act::QUICK_GELU_FAST_FLOOR);  // NaN too
      }
    }
    if (low) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          put(jj, half, pack_bf16(act::quick_gelu(z[jj][2 * half]),
                                  act::quick_gelu(z[jj][2 * half + 1])));
        }
      }
      return;
    }
    bool unused = false;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        put(jj, half,
            pack_bf16(act::quick_gelu_fast(z[jj][2 * half], unused),
                      act::quick_gelu_fast(z[jj][2 * half + 1], unused)));
      }
    }
  }
};

// ---- the host side ---------------------------------------------------------

// The tensor map of a (rows, cols) row-major matrix of bf16 (or fp32)
// elements whose rows lie ld elements apart (16-byte multiples), with a box
// of (128 bytes of columns, box_rows), swizzled by 128 bytes; reads past
// the end are zeros, writes past it are dropped.
inline bool encode_operand(CUtensorMap* map, const void* base, int rows,
                           int cols, int ld, int box_rows,
                           bool f32 = false) {
  const auto encode = ha::encode_tiled();
  if (encode == nullptr) return false;
  const int bytes = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map,
                f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The current device's SMs.
inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

template <int BN, int PRODUCTS, class Epi>
int launch(const void* a, const void* const* b, int ldb, int weights,
           void* const* c, int outputs, const Problem& p,
           const typename Epi::Args& args, int sms, cudaStream_t stream) {
  using T = Tiles<BN>;
  constexpr bool f32_out =
      std::is_same<typename OutOf<Epi>::type, float>::value;
  CUtensorMap map_a;
  BMaps maps_b, maps_c;
  if (!encode_operand(&map_a, a, p.M, p.a_cols, p.a_cols, BM)) {
    return cudaErrorInvalidValue;
  }
  for (int i = 0; i < MAX_B; ++i) {
    // unused maps repeat the last weight's and output's (never used)
    const int kb = i < weights ? i : weights - 1;
    const int kc = i < outputs ? i : outputs - 1;
    if (!encode_operand(&maps_b.map[i], b[kb], p.b_rows, p.n_split, ldb,
                        BK) ||
        !encode_operand(&maps_c.map[i], c[kc], p.M, p.n_split, p.n_split,
                        OUT_BOX, f32_out)) {
      return cudaErrorInvalidValue;
    }
  }
  const auto kernel = gemm_kernel<BN, PRODUCTS, Epi>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::SMEM));
  if (err != cudaSuccess) return err;
  const long long tiles =
      static_cast<long long>((p.M + BM - 1) / BM) * (p.N / (BN / PRODUCTS));
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, NT, T::SMEM, stream>>>(map_a, maps_b, maps_c, p, args);
  return static_cast<int>(cudaGetLastError());
}

// The product of a (M, K) with `weights` (K, n_split) weights b[0 ..
// weights - 1], their rows ldb elements apart (n_split when 0), side by
// side (N = weights x n_split columns), into as many (M, n_split) outputs
// c[0 ..] of the epilogue's type, each 16-byte aligned, at tile_width's
// columns a tile; with b_rows (a multiple of 64 dividing K; K when 0), the
// weights are (b_rows, n_split), read K / b_rows times along K. Returns the
// launch's cudaError_t (0 on success).
template <class Epi>
int launch_product(const void* a, const void* const* b, void* const* c,
                   int weights, const Problem& p,
                   const typename Epi::Args& args, cudaStream_t stream,
                   int ldb) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  return tile_width(p.M, p.N, p.n_split, sms) == 256
             ? launch<256, 1, Epi>(a, b, ldb, weights, c, weights, p, args,
                                   sms, stream)
             : launch<128, 1, Epi>(a, b, ldb, weights, c, weights, p, args,
                                   sms, stream);
}

template <class Epi>
int gemm(const void* a, const void* const* b, void* const* c, int weights,
         int M, int K, int n_split, const typename Epi::Args& args,
         cudaStream_t stream, int ldb = 0, int b_rows = 0) {
  b_rows = b_rows != 0 ? b_rows : K;
  if (!shape_ok(M, K, n_split, weights) || (ldb != 0 && ldb < n_split) ||
      b_rows <= 0 || b_rows % BK != 0 || K % b_rows != 0 ||
      K / b_rows > MAX_SEGMENTS) {
    return cudaErrorInvalidValue;
  }
  const Problem p{M, K, n_split * weights, n_split, b_rows,
                  IDENTITY_PLANES, 0u, K, b_rows};
  return launch_product<Epi>(a, b, c, weights, p, args, stream,
                             ldb != 0 ? ldb : n_split);
}

// The plane pairs of a product: `segments` (at most MAX_SEGMENTS) pairs,
// segment i the product of A plane a[i] with B plane b[i], in this order;
// A holds a_count planes, each weight b_count.
struct Planes {
  int a_count, b_count, segments;
  int a[MAX_SEGMENTS], b[MAX_SEGMENTS];
};

// The product over plane pairs: a (M, a_count seg) holds A's planes side by
// side, each (M, seg); each of the `weights` b[i] (b_count seg, n_split)
// holds its planes one under the other, each (seg, n_split); K = segments
// seg. Outputs as gemm's. Returns the launch's cudaError_t (0 on success).
template <class Epi>
int gemm_planes(const void* a, const void* const* b, void* const* c,
                int weights, int M, int seg, int n_split, const Planes& pl,
                const typename Epi::Args& args, cudaStream_t stream) {
  const int K = seg * pl.segments;
  if (!shape_ok(M, K, n_split, weights) || seg % BK != 0 ||
      pl.segments <= 0 || pl.segments > MAX_SEGMENTS) {
    return cudaErrorInvalidValue;
  }
  uint32_t a_planes = 0, b_planes = 0;
  for (int i = 0; i < pl.segments; ++i) {
    if (pl.a[i] < 0 || pl.a[i] >= pl.a_count || pl.b[i] < 0 ||
        pl.b[i] >= pl.b_count) {
      return cudaErrorInvalidValue;
    }
    a_planes |= static_cast<uint32_t>(pl.a[i]) << (4 * i);
    b_planes |= static_cast<uint32_t>(pl.b[i]) << (4 * i);
  }
  const Problem p{M, K, n_split * weights, n_split, seg, a_planes, b_planes,
                  pl.a_count * seg, pl.b_count * seg};
  return launch_product<Epi>(a, b, c, weights, p, args, stream, n_split);
}

// The paired product: c (M, N) bf16 = Epi(a . b0, a . b1) for a (M, K) and
// b0, b1 (K, N) in the JAX layout, 128 columns of each a tile (N a
// multiple of 128). Returns the launch's cudaError_t (0 on success).
template <class Epi>
int gemm_paired(const void* a, const void* b0, const void* b1, void* c,
                int M, int K, int N, const typename Epi::Args& args,
                cudaStream_t stream) {
  if (!shape_ok(M, K, N, 2)) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const void* const b[2] = {b0, b1};
  void* const out[1] = {c};
  return launch<256, 2, Epi>(a, b, N, 2, out, 1,
                             Problem{M, K, N, N, K, 0u, 0u, K, K}, args, sms,
                             stream);
}

}  // namespace bf16_gemm_tma
