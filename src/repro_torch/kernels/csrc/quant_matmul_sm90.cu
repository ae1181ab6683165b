// Hopper (sm_90a) kernels of the int8-weight matrix product for bf16 x:
// out = x (M, K) @ (codes (K, N) int8 * scale (N,)), the scale taken out
// of the sum and applied once in the epilogue, one cast to the output dtype.
//
// Replace the Pallas TPU kernel src/repro/kernels/quant_matmul.py:40
// (quant_matmul, pallas_call at :62) for bf16 x; f32 x keeps the
// three-term mma.sync design of quant_matmul.cu.  The wrapper
// (kernels/quant_matmul.py) picks one of two designs by M:
//
// 1. Small M (a decode step, M <= 32): bound by bytes, the codes read
//    once (22.5 MB for one 2048 x 11008 MLP matrix of qwen2.5-3b, 0.0068
//    ms at 3.35 TB/s).  The mma.sync design before this one ran 16 blocks
//    of 344 serial k steps at the down projection.  Here the product is
//    turned around, out^T (N x M) = codes^T . x^T, so the codes fill the
//    16-row A operand of mma.sync m16n8k16 (converted from int8 in
//    registers; codes -127..127 are exact in bf16) and x's M <= 8 rows per
//    n8 tile fill B: no tensor-core row is wasted at M = 8.  K is split
//    into slices (kernels/quant_matmul.py splitk_plan) so the grid holds
//    at least 4 blocks per SM; each block streams its (slice, 128 columns)
//    of codes and x through a 4-stage cp.async ring of 64-deep k chunks
//    (8 KB of codes a stage, 16-byte copies), and writes an f32 partial to
//    a workspace the wrapper allocates.  A second kernel adds the slices
//    in a fixed order, scales and casts: the result does not depend on
//    the order blocks run in (no float atomics).
// 2. Large M (a prefill): bound by operations (1.85e11 flop at M = 4096,
//    0.187 ms at the dense bf16 rate).  128 x 128 output tiles, two
//    consumer warpgroups of 64 rows, wgmma m64n128k16 from shared memory.
//    wgmma reads B only from shared memory and only in 16-bit types, so x
//    stays the A operand (K-major, 128-byte swizzle) and the int8 codes,
//    staged raw by cp.async in a 3-stage ring, are converted by the same
//    warpgroups into a double-buffered bf16 tile laid out MN-major (the
//    codes' own (k, n) order, which 16-bit wgmma may read transposed).
//    The conversion of chunk c+1 runs while wgmma multiplies chunk c.
//    Chosen over swapping the operands (codes^T as a register A operand):
//    the output stays row-major in registers, so the epilogue's stores are
//    coalesced along N without a transpose through shared memory.  Two
//    blocks share an SM.  What holds it back (PERF.md): loads, conversion
//    and the two barriers of each 64-deep chunk all sit on its critical
//    path; a warp-specialized variant (one producer warpgroup converting
//    for two consumer warpgroups) was slower in a development build,
//    because one warpgroup cannot convert as fast as two consume.
// Both take any M, K and N: loads past the edges read zeros (cp.async
// zero fill, or scalar loads where rows are not 16-byte aligned) and
// stores are masked.  Measured times on the card: PERF.md.

#include <algorithm>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <c10/cuda/CUDAException.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace repro_torch {

namespace {

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// byte B of each of two words of int8 codes (pre-xored with 0x80808080) as
// one bf16 pair, wa's in the low half: 2^23 + (c + 128) as f32 bits, minus
// 2^23 + 128, is c exactly
template <int B>
__device__ __forceinline__ uint32_t codes_pair(uint32_t wa, uint32_t wb) {
  const float a = __int_as_float(__byte_perm(wa, 0x4B000000u, 0x7650 + B)) - 8388736.f;
  const float b = __int_as_float(__byte_perm(wb, 0x4B000000u, 0x7650 + B)) - 8388736.f;
  return mma::pack(a, b);
}

// ------------------------------------------------------ small M: split K
constexpr int kSkBN = 128;            // columns per block: 4 warps x 32
constexpr int kSkBK = 64;             // k rows per stage
constexpr int kSkStages = 4;
constexpr int kSkCodeLd = kSkBN + 16; // bytes per staged k row: conflict-free fragment reads
constexpr int kSkXLd = kSkBK + 8;     // bf16 per staged x row
constexpr int kSkThreads = 128;

template <int MT>
__host__ __device__ constexpr int splitk_stage_bytes() {
  return kSkBK * kSkCodeLd + 8 * MT * kSkXLd * 2;
}

// k chunk [kc, kc + 64) of the block's columns (codes) and of x's rows into
// one stage; zeros past the slice end ke, past N and past M
template <int MT>
__device__ __forceinline__ void splitk_load(uint8_t* st, const __nv_bfloat16* __restrict__ x,
                                            const int8_t* __restrict__ codes, int m, int n,
                                            int k, int n0, int kc, int ke, bool x_vec,
                                            bool c_vec) {
  for (int e = threadIdx.x; e < kSkBK * (kSkBN / 16); e += kSkThreads) {
    const int r = e / (kSkBN / 16);
    const int c = e % (kSkBN / 16);
    const int gk = kc + r;
    const int gn = n0 + c * 16;
    uint8_t* dst = st + r * kSkCodeLd + c * 16;
    if (c_vec) {
      const bool ok = gk < ke && gn < n;
      sm90::cp_async16(sm90::smem_addr(dst), codes + (ok ? static_cast<size_t>(gk) * n + gn : 0),
                       ok ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        dst[i] = (gk < ke && gn + i < n) ? codes[static_cast<size_t>(gk) * n + gn + i] : 0;
      }
    }
  }
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st + kSkBK * kSkCodeLd);
  for (int e = threadIdx.x; e < 8 * MT * (kSkBK / 8); e += kSkThreads) {
    const int r = e / (kSkBK / 8);
    const int c = e % (kSkBK / 8);
    const int gk = kc + c * 8;
    __nv_bfloat16* dst = xs + r * kSkXLd + c * 8;
    if (x_vec) {
      const bool ok = r < m && gk < ke;
      sm90::cp_async16(sm90::smem_addr(dst), x + (ok ? static_cast<size_t>(r) * k + gk : 0),
                       ok ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        dst[i] = (r < m && gk + i < ke) ? x[static_cast<size_t>(r) * k + gk + i]
                                        : __float2bfloat16_rn(0.f);
      }
    }
  }
}

// grid (column tiles, K slices).  Warp w owns columns n0 + 32w .. +31 as
// two A tiles of 16: row g of tile i is column 4g + i, row g + 8 column
// 4g + 2 + i, so one 32-bit shared load of a k row feeds both tiles.
template <int MT>
__global__ void __launch_bounds__(kSkThreads)
    quant_matmul_splitk_kernel(const __nv_bfloat16* __restrict__ x,
                               const int8_t* __restrict__ codes, float* __restrict__ ws, int m,
                               int n, int k, int slice_k, bool x_vec, bool c_vec) {
  extern __shared__ uint4 sk_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(sk_smem);
  constexpr int kSkStage = splitk_stage_bytes<MT>();
  const int n0 = blockIdx.x * kSkBN;
  const int kb = blockIdx.y * slice_k;
  const int ke = min(k, kb + slice_k);
  const int chunks = (ke - kb + kSkBK - 1) / kSkBK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  float acc[MT][2][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) acc[j][i][0] = acc[j][i][1] = acc[j][i][2] = acc[j][i][3] = 0.f;

#pragma unroll
  for (int c = 0; c < kSkStages - 1; ++c) {
    if (c < chunks) {
      splitk_load<MT>(smem + c * kSkStage, x, codes, m, n, k, n0, kb + c * kSkBK, ke, x_vec,
                      c_vec);
    }
    sm90::cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    sm90::cp_async_wait<kSkStages - 2>();  // chunk c landed
    __syncthreads();                       // ... for every thread; chunk c - 1 is done
    const int nc = c + kSkStages - 1;
    if (nc < chunks) {
      splitk_load<MT>(smem + (nc % kSkStages) * kSkStage, x, codes, m, n, k, n0, kb + nc * kSkBK,
                      ke, x_vec, c_vec);
    }
    sm90::cp_async_commit();

    const uint8_t* cs = smem + (c % kSkStages) * kSkStage + warp * 32 + 4 * g;
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(smem + (c % kSkStages) * kSkStage + kSkBK * kSkCodeLd);
#pragma unroll
    for (int kk = 0; kk < kSkBK / 16; ++kk) {
      const uint8_t* p = cs + (kk * 16 + 2 * t) * kSkCodeLd;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + kSkCodeLd) ^ 0x80808080u;
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(p + 8 * kSkCodeLd) ^ 0x80808080u;
      const uint32_t w9 = *reinterpret_cast<const uint32_t*>(p + 9 * kSkCodeLd) ^ 0x80808080u;
      const uint32_t a0[4] = {codes_pair<0>(w0, w1), codes_pair<2>(w0, w1),
                              codes_pair<0>(w8, w9), codes_pair<2>(w8, w9)};
      const uint32_t a1[4] = {codes_pair<1>(w0, w1), codes_pair<3>(w0, w1),
                              codes_pair<1>(w8, w9), codes_pair<3>(w8, w9)};
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const __nv_bfloat16* xp = xs + (8 * j + g) * kSkXLd + kk * 16 + 2 * t;
        const uint32_t b0 = mma::ld32(xp);
        const uint32_t b1 = mma::ld32(xp + 8);
        mma::mma_bf16(acc[j][0], a0, b0, b1);
        mma::mma_bf16(acc[j][1], a1, b0, b1);
      }
    }
  }
  sm90::cp_async_wait<0>();

  // partial out^T tile: d0, d1 (column 4g + i, rows 8j + 2t, +1), d2, d3 (column 4g + 2 + i)
  float* part = ws + static_cast<size_t>(blockIdx.y) * m * n;
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const int row = 8 * j + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + warp * 32 + 4 * g + 2 * h + i;
        if (col >= n) continue;
        if (row < m) part[static_cast<size_t>(row) * n + col] = acc[j][i][2 * h];
        if (row + 1 < m) part[static_cast<size_t>(row + 1) * n + col] = acc[j][i][2 * h + 1];
      }
    }
  }
}

// out = scale * (sum of the slices' partials in slice order), one cast
template <typename Tout>
__global__ void splitk_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ scale,
                                     Tout* __restrict__ out, int m, int n, int slices) {
  const size_t size = static_cast<size_t>(m) * n;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; e < size;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float sum = 0.f;  // slice order; the loads of 8 slices are issued together
#pragma unroll 8
    for (int s = 0; s < slices; ++s) sum += ws[s * size + e];
    store(out + e, sum * scale[e % n]);
  }
}

// ------------------------------------------------------ large M: wgmma
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kStages = 3;          // raw stages: chunks c .. c + kStages - 1 resident
constexpr int kBlocksPerSm = 2;
constexpr int kThreads = 256;
constexpr int kXTile = kBM * 128;          // bytes: 128 rows x 64 bf16, swizzled
constexpr int kRawLd = kBN + 16;           // bytes per raw code row: conflict-free reads
constexpr int kRawTile = kBK * kRawLd;
constexpr int kStage = kXTile + kRawTile;  // multiple of 1024
constexpr int kBRegion = kBK * 128;        // bytes: 64 k rows x 64 bf16 columns
constexpr int kBTile = 2 * kBRegion;       // bf16 codes, MN-major, two column blocks
constexpr int kSmem = kStages * kStage + 2 * kBTile + 1024;

__device__ __forceinline__ void tile_load(uint32_t st, const __nv_bfloat16* __restrict__ x,
                                          const int8_t* __restrict__ codes, int m, int n, int k,
                                          int m0, int n0, int k0, bool x_vec, bool c_vec) {
  // x rows m0.. , columns k0.. : 128 rows x 8 chunks, swizzled (K-major A)
#pragma unroll
  for (int i = 0; i < kBM * 8 / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / 8;
    const int c = e % 8;
    const int gm = m0 + r;
    const int gk = k0 + c * 8;
    const uint32_t dst = st + sm90::swizzle(r, c);
    if (x_vec) {
      const bool ok = gm < m && gk < k;
      sm90::cp_async16(dst, x + (ok ? static_cast<size_t>(gm) * k + gk : 0), ok ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float a = (gm < m && gk + 2 * j < k)
                            ? __bfloat162float(x[static_cast<size_t>(gm) * k + gk + 2 * j]) : 0.f;
        const float b = (gm < m && gk + 2 * j + 1 < k)
                            ? __bfloat162float(x[static_cast<size_t>(gm) * k + gk + 2 * j + 1])
                            : 0.f;
        w[j] = mma::pack(a, b);  // exact: the values came from bf16
      }
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(w[0]),
                   "r"(w[1]), "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
  // raw codes rows k0.., columns n0..: 64 rows x 8 chunks of 16 bytes
#pragma unroll
  for (int i = 0; i < kBK * 8 / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / 8;
    const int c = e % 8;
    const int gk = k0 + r;
    const int gn = n0 + c * 16;
    const uint32_t dst = st + kXTile + r * kRawLd + c * 16;
    if (c_vec) {
      const bool ok = gk < k && gn < n;
      sm90::cp_async16(dst, codes + (ok ? static_cast<size_t>(gk) * n + gn : 0), ok ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int col = gn + 4 * j + b;
          const uint32_t byte =
              (gk < k && col < n) ? static_cast<uint8_t>(codes[static_cast<size_t>(gk) * n + col])
                                  : 0u;
          word |= byte << (8 * b);
        }
        w[j] = word;
      }
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(w[0]),
                   "r"(w[1]), "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

// raw int8 codes of a stage -> bf16 tile (MN-major, swizzled).  Thread ->
// k row r = e % 64 and 16 columns q = e / 64: 8 threads of a phase read 8
// rows of the padded raw tile and write 8 rows of the swizzled one, both
// without bank conflicts.
__device__ __forceinline__ void convert_codes(uint32_t raw, uint32_t b_tile) {
#pragma unroll
  for (int i = 0; i < kBK * 8 / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e % kBK;
    const int q = e / kBK;  // columns 16q .. 16q + 15
    uint32_t w[4];
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                 : "r"(raw + r * kRawLd + q * 16));
    uint32_t o[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t x = w[j] ^ 0x80808080u;
      o[2 * j] = codes_pair<0>(x, x >> 8);      // columns 4j, 4j + 1
      o[2 * j + 1] = codes_pair<2>(x, x >> 8);  // columns 4j + 2, 4j + 3
    }
    const uint32_t region = b_tile + (q / 4) * kBRegion;
    const int c = (q % 4) * 2;  // first of the two 16-byte chunks (8 columns each)
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(region + sm90::swizzle(r, c)),
                 "r"(o[0]), "r"(o[1]), "r"(o[2]), "r"(o[3])
                 : "memory");
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(region +
                                                                   sm90::swizzle(r, c + 1)),
                 "r"(o[4]), "r"(o[5]), "r"(o[6]), "r"(o[7])
                 : "memory");
  }
}

// grid (column tiles, row tiles), two warpgroups of 64 rows each
template <typename Tout>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    quant_matmul_sm90_kernel(const __nv_bfloat16* __restrict__ x,
                             const int8_t* __restrict__ codes, const float* __restrict__ scale,
                             Tout* __restrict__ out, int m, int n, int k, bool x_vec,
                             bool c_vec) {
  extern __shared__ uint8_t qm_smem[];
  const uint32_t base = (sm90::smem_addr(qm_smem) + 1023u) & ~1023u;
  const uint32_t b_s = base + kStages * kStage;  // two bf16 code tiles
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int chunks = (k + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) tile_load(base + c * kStage, x, codes, m, n, k, m0, n0, c * kBK, x_vec, c_vec);
    sm90::cp_async_commit();
  }
  sm90::cp_async_wait<kStages - 2>();  // chunk 0 landed
  __syncthreads();
  convert_codes(base + kXTile, b_s);
  sm90::fence_proxy_async();

  for (int c = 0; c < chunks; ++c) {
    // x of chunk c and its bf16 codes are in place for every thread, and
    // every warpgroup's products of chunk c - 1 are done
    __syncthreads();
    const uint32_t x_st = base + (c % kStages) * kStage;
    const uint32_t b_st = b_s + (c % 2) * kBTile;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      sm90::wgmma_ss<kBN, 1>(acc, sm90::desc(x_st + wg * 64 * 128 + kk * 32, 0),
                             sm90::desc(b_st + kk * 16 * 128, kBRegion), 1);
    }
    sm90::wgmma_commit();
    const int nc = c + kStages - 1;  // into the stage chunk c - 1 used
    if (nc < chunks) {
      tile_load(base + (nc % kStages) * kStage, x, codes, m, n, k, m0, n0, nc * kBK, x_vec, c_vec);
    }
    sm90::cp_async_commit();
    if (c + 1 < chunks) {  // convert chunk c + 1 while the products of chunk c run
      sm90::cp_async_wait<kStages - 2>();
      sm90::fence_proxy_async();
      __syncthreads();
      convert_codes(base + ((c + 1) % kStages) * kStage + kXTile, b_s + ((c + 1) % 2) * kBTile);
      sm90::fence_proxy_async();
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
  }
  sm90::cp_async_wait<0>();

  // epilogue: the column's scale once, one cast, masked stores
  const int row0 = m0 + wg * 64 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * t;
    const float s0 = col < n ? scale[col] : 0.f;
    const float s1 = col + 1 < n ? scale[col + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= m) continue;
      Tout* o = out + static_cast<size_t>(row) * n + col;
      if (col < n) store(o, acc[4 * j + 2 * h] * s0);
      if (col + 1 < n) store(o + 1, acc[4 * j + 2 * h + 1] * s1);
    }
  }
}

template <int MT>
void launch_splitk_mt(const __nv_bfloat16* x, const int8_t* codes, float* ws, int m, int n,
                      int k, int slice_k, int slices, bool x_vec, bool c_vec,
                      cudaStream_t stream) {
  constexpr int kSmemSk = kSkStages * splitk_stage_bytes<MT>();
  auto kernel = quant_matmul_splitk_kernel<MT>;
  sm90::allow_smem<quant_matmul_splitk_kernel<MT>>(kSmemSk);
  const dim3 grid((n + kSkBN - 1) / kSkBN, slices);
  kernel<<<grid, kSkThreads, kSmemSk, stream>>>(x, codes, ws, m, n, k, slice_k, x_vec, c_vec);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

template <typename Tout>
void launch_splitk(const __nv_bfloat16* x, const int8_t* codes, const float* scale, float* ws,
                   Tout* out, int m, int n, int k, int slice_k, int slices,
                   cudaStream_t stream) {
  // 16-byte copies need 16-byte aligned rows of x and of the codes
  const bool x_vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && k % 8 == 0;
  const bool c_vec = reinterpret_cast<uintptr_t>(codes) % 16 == 0 && n % 16 == 0;
  switch ((m + 7) / 8) {
    case 1:
      launch_splitk_mt<1>(x, codes, ws, m, n, k, slice_k, slices, x_vec, c_vec, stream);
      break;
    case 2:
      launch_splitk_mt<2>(x, codes, ws, m, n, k, slice_k, slices, x_vec, c_vec, stream);
      break;
    case 3:
      launch_splitk_mt<3>(x, codes, ws, m, n, k, slice_k, slices, x_vec, c_vec, stream);
      break;
    case 4:
      launch_splitk_mt<4>(x, codes, ws, m, n, k, slice_k, slices, x_vec, c_vec, stream);
      break;
    default:
      TORCH_CHECK(false, "quant_matmul split-K: M=", m, " above 32");
  }
  const int size = m * n;
  const int blocks = std::min((size + 255) / 256, 132 * 16);
  splitk_reduce_kernel<Tout><<<blocks, 256, 0, stream>>>(ws, scale, out, m, n, slices);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

template <typename Tout>
void launch_sm90(const __nv_bfloat16* x, const int8_t* codes, const float* scale, Tout* out,
                 int m, int n, int k, cudaStream_t stream) {
  const bool x_vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && k % 8 == 0;
  const bool c_vec = reinterpret_cast<uintptr_t>(codes) % 16 == 0 && n % 16 == 0;
  auto kernel = quant_matmul_sm90_kernel<Tout>;
  sm90::allow_smem<quant_matmul_sm90_kernel<Tout>>(kSmem);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  kernel<<<grid, kThreads, kSmem, stream>>>(x, codes, scale, out, m, n, k, x_vec, c_vec);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

void launch_quant_matmul_splitk(const void* x, const int8_t* codes, const float* scale,
                                float* ws, void* out, int m, int n, int k, int slice_k,
                                int slices, bool out_bf16, cudaStream_t stream) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  if (out_bf16) {
    launch_splitk(xb, codes, scale, ws, static_cast<__nv_bfloat16*>(out), m, n, k, slice_k,
                  slices, stream);
  } else {
    launch_splitk(xb, codes, scale, ws, static_cast<float*>(out), m, n, k, slice_k, slices,
                  stream);
  }
}

void launch_quant_matmul_sm90(const void* x, const int8_t* codes, const float* scale, void* out,
                              int m, int n, int k, bool out_bf16, cudaStream_t stream) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  if (out_bf16) {
    launch_sm90(xb, codes, scale, static_cast<__nv_bfloat16*>(out), m, n, k, stream);
  } else {
    launch_sm90(xb, codes, scale, static_cast<float*>(out), m, n, k, stream);
  }
}

}  // namespace repro_torch
