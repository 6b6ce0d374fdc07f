// int8 T5 encoder kernels for NVIDIA Hopper (sm_90a): the bulk-eval mode's
// attention projections and FFN, every product int8 on the tensor cores.
//
// Replaces, in explicit_alignment_for_vqa_tasks_tpu/ops/fused_attention_block.py:
//   fused_t5_ln_qkv_q8       (pallas_call at :1666, body :1614-1631)
//   fused_oproj_residual_q8  (pallas_call at :1715, body :1680-1691)
//   fused_t5_ffn_q8          (pallas_call at :1595, body :1500-1538)
//
// What they compute, in the Pallas kernels' order of rounding (x, the
// residual and the outputs bf16; weights int8 (K, N) with fp32 (G, N)
// per-(contraction group, output column) scales):
//
//   h      = (x * rsqrt(mean(x^2) + eps)) * w        fp32 RMSNorm (not for
//                                                    the out-projection)
//   hs     = max(amax(|h| over the group), 1e-6) * (1/127)  per (row, group);
//            the JAX kernels divide by 127.0, which XLA compiles into this
//            product with the fp32 reciprocal
//   hq     = clip(rint(h / hs), -127, 127)           IEEE division, ties even
//   acc    = sum over g = 0..G-1, in order, of (float(P_g) * hs_g) * s_g
//            where P_g is the group's exact int32 product hq_g . W_g
//   qkv    : q, k, v = bf16(acc_q), bf16(acc_k), bf16(acc_v), one shared hq
//   oproj  : out = bf16(float(residual) + acc)
//   ffn    : hid = gelu_tanh(acc_0) * acc_1  (fp32, never rounded to bf16),
//            requantized per (row, g_hid group), out = bf16(x + acc_o)
//
// Every multiply and add of the fp32 epilogues is written with __fmul_rn /
// __fadd_rn so that nvcc cannot contract them into FMAs: the plain PyTorch
// version rounds after each operation, and so must the kernel. The build has
// no --use_fast_math.
//
// What bounds them on an H100 SXM (1,979 TOP/s int8 dense, 3.35 TB/s): at
// the main path's M = 32 x 557 = 17,824 rows and T0-3B widths (D = inner =
// 2048, F = 5120, 8 groups) the work is 2 M K N operations per product:
// 448.6 G for q/k/v (0.227 ms), 149.5 G for the out-projection (0.076 ms),
// 1,121.4 G for the FFN (0.567 ms), while the bytes each must move (bf16
// activations in and out, int8 weights, fp32 scales) take 0.05-0.09 ms. All
// three are bound by operations.
//
// Design (simple and right before fast). A wrapper runs two kinds of CUDA
// kernel:
//   row_quant: one block per row. The fp32 row (normalised where the op
//     norms) sits in shared memory; each group's amax is a block reduction;
//     the codes and the row's G scales go to device memory.
//   gemm_q8: a 128 x 128 output tile per block of two warpgroups, each
//     taking 64 rows with wgmma.m64n128k32.s32.s8.s8 (int8 wgmma needs
//     both operands K-major, so the wrapper passes the weights transposed,
//     (N, K)). A 4-slot cp.async ring stages 64-deep k steps of A and B in
//     shared memory as wgmma's no-swizzle core matrices (8 rows x 16 bytes,
//     contiguous), addressed by matrix descriptors. Each k step ends with
//     the wgmma group waited for; at the end of each contraction group the
//     exact int32 accumulators are folded into fp32 registers with the row
//     and column scales, groups in order. The last fold applies the
//     epilogue: bf16 store, residual add, gelu to an fp32 hidden, or the
//     gate's product into that hidden.
// q, k and v are one gemm_q8 launch (grid z = 3) over one shared
// quantization. The FFN runs row_quant, gemm (gelu), gemm (times the gate),
// row_quant of the fp32 hidden, gemm (+ residual); the hidden makes one
// round trip through device memory (365 MB at the main shape), which a
// later version can fuse into the up-products' epilogue.
//
// Measured (PERF.md): the gemm runs at about a tenth of the int8 peak and
// three times cuBLASLt's time; a WMMA version and an mma.sync
// version with the same tiles and staging ran within 1.5x of it, and
// neither deeper k steps nor padding the staging against bank conflicts
// moved it. What holds it is not known yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;  // threads per block, both kernels
constexpr int NWARPS = NT / 32;
constexpr int BM = 128, BN = 128, BK = 64;  // block tile and k step
constexpr int STAGES = 4;                   // cp.async ring slots
constexpr int KCH = BK / 16;                // 16-byte k chunks of a tile row
constexpr int GEMM_SMEM = STAGES * KCH * (BM + BN) * 16;
constexpr int MAX_PRODUCTS = 3;

enum Epilogue : int { kBf16 = 0, kResidualBf16 = 1, kGeluF32 = 2, kMulF32 = 3 };

__device__ inline float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ inline float to_f32(float v) { return v; }

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// Block-wide sum or max of one value per thread; every thread gets the
// result. `red` holds NWARPS + 1 floats.
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = MAX ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < NWARPS ? red[lane] : 0.0f;  // |h| >= 0, so 0 is neutral
    t = MAX ? warp_max(t) : warp_sum(t);
    if (lane == 0) red[NWARPS] = t;
  }
  __syncthreads();
  const float r = red[NWARPS];
  __syncthreads();  // red is free for the next reduction
  return r;
}

// One block per row of x (K wide): optional fp32 RMSNorm, then per-(row,
// group) symmetric int8 quantization into codes (M, K) and scales (M, G).
template <typename T, bool NORM>
__global__ void __launch_bounds__(NT)
row_quant_kernel(const T* __restrict__ x, const bf16* __restrict__ lnw,
                 int8_t* __restrict__ codes, float* __restrict__ scales,
                 int K, int G, float eps) {
  extern __shared__ float h[];  // the row, K floats
  __shared__ float red[NWARPS + 1];
  const size_t row = blockIdx.x;
  const T* xr = x + row * K;
  float ss = 0.0f;
  for (int i = threadIdx.x; i < K; i += NT) {
    const float v = to_f32(xr[i]);
    h[i] = v;
    if (NORM) ss = __fadd_rn(ss, __fmul_rn(v, v));
  }
  if (NORM) {
    const float var =
        __fdiv_rn(block_reduce<false>(ss, red), static_cast<float>(K));
    const float r = rsqrtf(__fadd_rn(var, eps));
    for (int i = threadIdx.x; i < K; i += NT) {  // this thread's own h[i]
      h[i] = __fmul_rn(__fmul_rn(h[i], r), __bfloat162float(lnw[i]));
    }
  }
  __syncthreads();
  const int kg = K / G;
  for (int g = 0; g < G; ++g) {
    const float* hg = h + g * kg;
    float amax = 0.0f;
    for (int i = threadIdx.x; i < kg; i += NT) amax = fmaxf(amax, fabsf(hg[i]));
    amax = block_reduce<true>(amax, red);
    const float scale = __fmul_rn(fmaxf(amax, 1e-6f), 1.0f / 127.0f);
    int8_t* cg = codes + row * K + g * kg;
    for (int i = threadIdx.x; i < kg; i += NT) {
      const float q = rintf(__fdiv_rn(hg[i], scale));
      cg[i] = static_cast<int8_t>(fminf(fmaxf(q, -127.0f), 127.0f));
    }
    if (threadIdx.x == 0) scales[row * G + g] = scale;
  }
}

struct GemmArgs {
  const int8_t* a;        // (M, K) activation codes, K contiguous
  const float* a_scale;   // (M, G) per-(row, group) scales
  const int8_t* b[MAX_PRODUCTS];        // (N, K) int8 weights, K contiguous
  const float* b_scale[MAX_PRODUCTS];   // (G, N) fp32 scales
  void* out[MAX_PRODUCTS];              // (M, N) bf16 or fp32
  const bf16* residual;   // (M, N) for kResidualBf16
  int M, K, N, G;
};

__device__ inline float tanh_gelu(float x) {
  // 0.5 * x * (1 + tanh(0.7978845608028654 * (x + 0.044715 * x * x * x)))
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(x, cube));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// A wgmma shared-memory matrix descriptor, no swizzle: the operand is
// made of 8-row x 16-byte core matrices, each 128 contiguous bytes; `lbo`
// is the byte step between core matrices along K, `sbo` along M or N.
__device__ inline uint64_t gmma_desc(const void* p, uint32_t lbo,
                                     uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// d (+)= A . B^T for a 64 x 128 x 32 tile of one warpgroup: int8 in, int32
// accumulate (exact); d is overwritten when accumulate is 0
__device__ inline void wgmma_s8_m64n128k32(int (&d)[64], uint64_t desc_a,
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ inline void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ inline void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// out[z] = epilogue(sum_g (float(A_g . B[z]_g^T) * a_scale_g) * b_scale[z]_g)
// for the 128 x 128 tile (blockIdx.y, blockIdx.x) of product z = blockIdx.z.
// Shared memory: STAGES ring slots, each an A and a B tile of BK bytes per
// row kept as [16-byte k chunk][row][16], i.e. wgmma's core matrices
// (8 rows x 16 bytes) contiguous. Warpgroup wg takes rows 64 wg .. 64 wg + 63.
template <int EPI>
__global__ void __launch_bounds__(NT)
gemm_q8_kernel(const GemmArgs args) {
  extern __shared__ __align__(128) int8_t smem[];
  constexpr int TILE_A = KCH * BM * 16, TILE_B = KCH * BN * 16;
  constexpr int STAGE_BYTES = TILE_A + TILE_B;

  const int z = blockIdx.z;
  const int8_t* __restrict__ a = args.a;
  const int8_t* __restrict__ b = args.b[z];
  const float* __restrict__ b_scale = args.b_scale[z];
  const int M = args.M, K = args.K, N = args.N, G = args.G;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int steps_per_group = K / G / BK, steps = K / BK;

  // one k step's A and B tiles into ring slot `stage`
  auto load_step = [&](int step, int stage) {
    int8_t* sa = smem + stage * STAGE_BYTES;
    int8_t* sb = sa + TILE_A;
    const int k0 = step * BK;
#pragma unroll
    for (int u = 0; u < BM * KCH / NT; ++u) {
      const int idx = threadIdx.x + u * NT;
      const int r = idx / KCH, c = idx % KCH;
      const bool valid = m0 + r < M;
      const int8_t* src =
          a + static_cast<size_t>(valid ? m0 + r : 0) * K + k0 + c * 16;
      cp_async16(sa + (c * BM + r) * 16, src, valid);
    }
#pragma unroll
    for (int u = 0; u < BN * KCH / NT; ++u) {
      const int idx = threadIdx.x + u * NT;
      const int r = idx / KCH, c = idx % KCH;
      cp_async16(sb + (c * BN + r) * 16,
                 b + static_cast<size_t>(n0 + r) * K + k0 + c * 16, true);
    }
  };

  // this thread's accumulator elements: for n8 chunk j, d[4j + e] is row
  // (gid + 8 * (e >> 1)) of the warp's 16-row slice, column 8j + 2 tig +
  // (e & 1) of the tile
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = m0 + wg * 64 + warp * 16 + gid;
  int d[64];
  float acc[64];

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_step(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int step = 0; step < steps; ++step) {
    const int g = step / steps_per_group;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    // this thread's copies are visible to the tensor cores' async proxy,
    // then everyone's are
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (step + STAGES - 1 < steps) {
      load_step(step + STAGES - 1, (step + STAGES - 1) % STAGES);
    }
    asm volatile("cp.async.commit_group;\n" ::);

    const int8_t* sa = smem + (step % STAGES) * STAGE_BYTES;
    const int8_t* sb = sa + TILE_A;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      const uint64_t da =
          gmma_desc(sa + (2 * kk * BM + wg * 64) * 16, BM * 16, 128);
      const uint64_t db = gmma_desc(sb + 2 * kk * BN * 16, BN * 16, 128);
      wgmma_s8_m64n128k32(d, da, db,
                          (step % steps_per_group != 0 || kk > 0) ? 1 : 0);
    }
    wgmma_commit_and_wait();

    if ((step + 1) % steps_per_group == 0) {
      // fold group g: acc += (float(P_g) * hs_g) * s_g, groups in order
      const float hs0 =
          row0 < M ? args.a_scale[static_cast<size_t>(row0) * G + g] : 0.0f;
      const float hs1 =
          row0 + 8 < M ? args.a_scale[static_cast<size_t>(row0 + 8) * G + g]
                       : 0.0f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 sc = __ldg(reinterpret_cast<const float2*>(
            b_scale + static_cast<size_t>(g) * N + n0 + 8 * j + 2 * tig));
        const float hs[4] = {hs0, hs0, hs1, hs1};
        const float sw[4] = {sc.x, sc.y, sc.x, sc.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float t = __fmul_rn(
              __fmul_rn(static_cast<float>(d[4 * j + e]), hs[e]), sw[e]);
          acc[4 * j + e] = g == 0 ? t : __fadd_rn(acc[4 * j + e], t);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // epilogue: two consecutive columns of rows row0 and row0 + 8 per chunk
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * tig;
      const size_t off = static_cast<size_t>(row) * N + col;
      float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if (EPI == kBf16 || EPI == kResidualBf16) {
        if (EPI == kResidualBf16) {
          const __nv_bfloat162 r =
              *reinterpret_cast<const __nv_bfloat162*>(args.residual + off);
          v0 = __fadd_rn(__low2float(r), v0);
          v1 = __fadd_rn(__high2float(r), v1);
        }
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(args.out[z]) +
                                           off) = __floats2bfloat162_rn(v0, v1);
      } else {
        float2* o =
            reinterpret_cast<float2*>(static_cast<float*>(args.out[z]) + off);
        if (EPI == kGeluF32) {
          *o = make_float2(tanh_gelu(v0), tanh_gelu(v1));
        } else {  // kMulF32: the hidden already holds gelu(a0)
          const float2 h = *o;
          *o = make_float2(__fmul_rn(h.x, v0), __fmul_rn(h.y, v1));
        }
      }
    }
  }
}

bool shape_ok(int M, int K, int N, int G) {
  return M > 0 && K > 0 && N > 0 && G > 0 && K % G == 0 &&
         (K / G) % BK == 0 && N % BN == 0 && (M + BM - 1) / BM <= 65535;
}

template <typename T, bool NORM>
int row_quant(const void* x, const void* lnw, void* codes, void* scales,
              int M, int K, int G, float eps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(K) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      row_quant_kernel<T, NORM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  row_quant_kernel<T, NORM><<<M, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const bf16*>(lnw),
      static_cast<int8_t*>(codes), static_cast<float*>(scales), K, G, eps);
  return static_cast<int>(cudaGetLastError());
}

template <int EPI>
int gemm(const GemmArgs& args, int products, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_q8_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      GEMM_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(args.N / BN, (args.M + BM - 1) / BM, products);
  gemm_q8_kernel<EPI><<<grid, NT, GEMM_SMEM, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

GemmArgs gemm_args(const void* a, const void* a_scale, int M, int K, int N,
                   int G) {
  GemmArgs args{};
  args.a = static_cast<const int8_t*>(a);
  args.a_scale = static_cast<const float*>(a_scale);
  args.M = M;
  args.K = K;
  args.N = N;
  args.G = G;
  return args;
}

void set_product(GemmArgs& args, int z, const void* w, const void* s,
                 void* out) {
  args.b[z] = static_cast<const int8_t*>(w);
  args.b_scale[z] = static_cast<const float*>(s);
  args.out[z] = out;
}

}  // namespace

// Each launcher runs on `stream` and returns the first cudaError_t of its
// launches (0 on success). Scratch (codes, scales, the FFN hidden) is the
// caller's. Weights come K-major: wq etc. are (N, K), the transpose of the
// JAX layout's (K, N).

// q, k, v (M, N) bf16 = RMSNorm(x (M, D)) through wq, wk, wv (N, D).
extern "C" int fused_t5_ln_qkv_q8_launch(
    const void* x, const void* lnw, const void* wq, const void* sq,
    const void* wk, const void* sk, const void* wv, const void* sv,
    void* codes, void* row_scales, void* q, void* k, void* v, int M, int D,
    int N, int G, float eps, void* stream) {
  if (!shape_ok(M, D, N, G)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = row_quant<bf16, true>(x, lnw, codes, row_scales, M, D, G, eps, s);
  if (rc != 0) return rc;
  GemmArgs args = gemm_args(codes, row_scales, M, D, N, G);
  set_product(args, 0, wq, sq, q);
  set_product(args, 1, wk, sk, k);
  set_product(args, 2, wv, sv, v);
  return gemm<kBf16>(args, 3, s);
}

// out (M, N) bf16 = residual + attn (M, K) through wo (N, K).
extern "C" int fused_oproj_residual_q8_launch(
    const void* residual, const void* attn, const void* wo, const void* so,
    void* codes, void* row_scales, void* out, int M, int K, int N, int G,
    void* stream) {
  if (!shape_ok(M, K, N, G)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = row_quant<bf16, false>(attn, nullptr, codes, row_scales, M, K, G,
                                  0.0f, s);
  if (rc != 0) return rc;
  GemmArgs args = gemm_args(codes, row_scales, M, K, N, G);
  set_product(args, 0, wo, so, out);
  args.residual = static_cast<const bf16*>(residual);
  return gemm<kResidualBf16>(args, 1, s);
}

// out (M, D) bf16 = x + FFN(RMSNorm(x)); w1 and s1 are null for the
// non-gated FFN; w0, w1 are (F, D), wo is (D, F). hidden is fp32 (M, F).
extern "C" int fused_t5_ffn_q8_launch(
    const void* x, const void* lnw, const void* w0, const void* s0,
    const void* w1, const void* s1, const void* wo, const void* so,
    void* codes_in, void* scales_in, void* hidden, void* codes_hid,
    void* scales_hid, void* out, int M, int D, int F, int G_in, int G_hid,
    float eps, void* stream) {
  if (!shape_ok(M, D, F, G_in) || !shape_ok(M, F, D, G_hid)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = row_quant<bf16, true>(x, lnw, codes_in, scales_in, M, D, G_in, eps,
                                 s);
  if (rc != 0) return rc;
  GemmArgs up = gemm_args(codes_in, scales_in, M, D, F, G_in);
  set_product(up, 0, w0, s0, hidden);
  rc = gemm<kGeluF32>(up, 1, s);
  if (rc != 0) return rc;
  if (w1 != nullptr) {
    set_product(up, 0, w1, s1, hidden);
    rc = gemm<kMulF32>(up, 1, s);
    if (rc != 0) return rc;
  }
  rc = row_quant<float, false>(hidden, nullptr, codes_hid, scales_hid, M, F,
                               G_hid, 0.0f, s);
  if (rc != 0) return rc;
  GemmArgs down = gemm_args(codes_hid, scales_hid, M, F, D, G_hid);
  set_product(down, 0, wo, so, out);
  down.residual = static_cast<const bf16*>(x);
  return gemm<kResidualBf16>(down, 1, s);
}
