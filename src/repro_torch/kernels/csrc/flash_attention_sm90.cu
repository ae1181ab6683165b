// Hopper (sm_90a) kernel of prefill attention for bf16 inputs, head dim 64
// or 128: causal / windowed / offset online-softmax attention with GQA,
// f32 out, on wgmma with a pipelined K/V ring.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:84
// (flash_attention, pallas_call at :108) for those inputs; f32 inputs and
// head dim 32 keep the mma.sync design of flash_attention.cu.
//
// What bounds it on this card: operations.  A 4096-token causal prefill of
// qwen2.5-3b (16 q heads over 2 kv heads, hd 128) needs 6.9e10 flop of
// useful work against 54.5 MB of bf16 q/k/v read and f32 output written:
// 0.069 ms at the dense bf16 tensor-core rate, 0.016 ms for the bytes.
// The mma.sync design before this one reached 106 TFLOP/s: warp-level
// products, synchronous K/V loads between two barriers, 64-row q tiles.
//
// Design.  One block of two warpgroups (256 threads) owns 128 q rows of
// one q head, 64 rows per warpgroup, and walks the k tiles of its kv head
// (bh / groups, as in the TPU index map) 128 keys at a time:
// * Loads: Q once, then K and V tiles through a 3-stage ring of cp.async
//   copies (16 bytes a thread, zero fill past Sk or Sq) into the 128-byte
//   swizzled layout of wgmma.cuh; tile j+1 is in flight while tile j is
//   multiplied.  mbarriers, not block-wide barriers, say when a stage is
//   full (cp.async's own arrive) and when all 8 warps are done with it, so
//   the warpgroups run out of step with each other.
// * Products: S = Q.K^T as wgmma m64n128k16 with both operands in shared
//   memory (K-major); O += P.V as wgmma m64n{hd}k16 with P from registers
//   (the S accumulator converts to A fragments in place) and V read
//   MN-major (transposed) from the same swizzled tile.
// * Pipeline inside a warpgroup: tile j's Q.K^T and tile j-1's P.V are
//   issued together; the softmax of tile j runs while P.V is on the tensor
//   cores.  The two warpgroups are not made to take turns at issuing (as
//   FlashAttention-3 does): in a development build that was not faster.
// * p is carried into P.V as two bf16 terms (p_hi + p_lo, within 2^-16 of
//   the f32 p): one term costs 2^-8 a product, about 1e-3 on rows with
//   few keys.  That is 1.5x the tensor-core work of a single bf16 p.
// * Kept from the mma.sync design: tiles that the causal or window mask
//   removes for the whole block are never loaded; latest q tiles are
//   issued first; the log2-domain online softmax with the m == -1e30
//   alpha guard; max(l, 1e-20), so rows with no valid key give 0; masking
//   of any Sq and Sk, nothing padded by the caller (tiles inside every
//   mask skip the masking).  Scores are q.k in f32 scaled afterwards by
//   1/sqrt(hd), as the oracle does; every bf16 product is exact in f32.
// Measured times on the card: PERF.md.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <c10/cuda/CUDAException.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace repro_torch {

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 128;         // q rows per block: two warpgroups of 64
constexpr int kKeys = 128;         // keys per k tile
constexpr int kThreads = 256;
constexpr int kStages = 3;         // K/V ring depth
constexpr int kRegion = 128 * 128; // bytes of one 64-wide column block of a 128-row tile

// rows [r0, r0 + 128) of a (len, HD) bf16 matrix into a swizzled tile at
// dst (HD / 64 regions); rows at or past len are zero
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, int r0,
                                          int len) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < 128 * kChunks / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kChunks;
    const int c = e % kChunks;
    const bool ok = r0 + r < len;
    const __nv_bfloat16* p = src + static_cast<size_t>(ok ? r0 + r : 0) * HD + c * 8;
    sm90::cp_async16(dst + (c / 8) * kRegion + sm90::swizzle(r, c % 8), p, ok ? 16 : 0);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one thread's share of a 64 x 128 score tile (rows g and
// g + 8 of its warp, accumulator layout of wgmma.cuh), in the log2 domain:
// m is the running max of the scaled scores, l this thread's part of the
// running sum.  update() masks the tile where it crosses an edge, leaves
// p in place of the scores and returns the factors the accumulator of
// each row is rescaled by.
struct Softmax {
  float m0 = kNegInf, m1 = kNegInf;
  float l0 = 0.f, l1 = 0.f;

  template <int N>
  __device__ __forceinline__ void update(float (&s)[N], bool edge, int k0, int t, int pos0,
                                         int pos1, int sk, bool causal, int window,
                                         float scale_log2, float& alpha0, float& alpha1) {
    float mx0 = kNegInf, mx1 = kNegInf;
    if (edge) {  // scale, and -1e30 where masked
#pragma unroll
      for (int n = 0; n < N / 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          const int pos = e < 2 ? pos0 : pos1;
          bool ok = key < sk;
          if (causal) ok = ok && key <= pos;
          if (window != 0) ok = ok && key > pos - window;
          s[4 * n + e] = ok ? s[4 * n + e] * scale_log2 : kNegInf;
        }
        mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
    } else {  // every score valid: the max of the raw scores, scaled once
#pragma unroll
      for (int n = 0; n < N / 4; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
      mx0 *= scale_log2;
      mx1 *= scale_log2;
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {  // the 4 threads of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    // rows with no valid key yet keep m == kNegInf: guard the rescale
    alpha0 = m0 == kNegInf ? 0.f : ex2(m0 - mn0);
    alpha1 = m1 == kNegInf ? 0.f : ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
    if (edge) {
#pragma unroll
      for (int n = 0; n < N / 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mn = e < 2 ? mn0 : mn1;
          s[4 * n + e] = s[4 * n + e] == kNegInf ? 0.f : ex2(s[4 * n + e] - mn);
        }
        ps0 += s[4 * n] + s[4 * n + 1];
        ps1 += s[4 * n + 2] + s[4 * n + 3];
      }
    } else {
#pragma unroll
      for (int n = 0; n < N / 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * n + e] = ex2(fmaf(s[4 * n + e], scale_log2, e < 2 ? -mn0 : -mn1));
        }
        ps0 += s[4 * n] + s[4 * n + 1];
        ps1 += s[4 * n + 2] + s[4 * n + 3];
      }
    }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
  }
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_sm90_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v, float* __restrict__ out,
                                int sq, int sk, int groups, float scale_log2, bool causal,
                                int window, int q_offset) {
  constexpr int kTile = (HD / 64) * kRegion;  // bytes of a Q, K or V tile
  constexpr int kSteps = HD / 16;             // k16 steps of Q.K^T
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + kTile;  // stage s: K at kv_s + 2 s kTile, V after it

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // latest q tiles first
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const __nv_bfloat16* k_head = k + static_cast<size_t>(bh / groups) * sk * HD;
  const __nv_bfloat16* v_head = v + static_cast<size_t>(bh / groups) * sk * HD;
  const int row0 = q0 + wg * 64 + warp * 16 + g;  // this thread's two query rows
  const int row1 = row0 + 8;
  const int pos0 = q_offset + row0;
  const int pos1 = q_offset + row1;

  // keys any row of the block may see, and any row of this warpgroup
  const int pos_lo = q_offset + q0;
  const int pos_hi = q_offset + min(q0 + kRows, sq) - 1;
  const int k_end = causal ? min(sk, pos_hi + 1) : sk;
  const int k_begin = window != 0 ? max(0, pos_lo - window + 1) : 0;
  const int t_begin = k_begin / kKeys;
  const int n_tiles = k_end > t_begin * kKeys ? (k_end - t_begin * kKeys + kKeys - 1) / kKeys : 0;
  const int w_lo = q_offset + q0 + wg * 64;
  const int w_hi = q_offset + min(q0 + wg * 64 + 64, sq) - 1;  // < w_lo: no rows

  // the ring: tile j sits in stage j % kStages; full[s] completes when
  // every thread's copies into s have landed, empty[s] when the 8 warps
  // are done reading it
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  const uint32_t full = sm90::smem_addr(bars);
  const uint32_t empty = full + 8 * kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      sm90::mbar_init(full + 8 * i, kThreads);
      sm90::mbar_init(empty + 8 * i, kThreads / 32);
    }
  }
  __syncthreads();

  load_tile<HD>(q_s, q + static_cast<size_t>(bh) * sq * HD, q0, sq);
  if (n_tiles > 0) {
    load_tile<HD>(kv_s, k_head, t_begin * kKeys, sk);
    load_tile<HD>(kv_s + kTile, v_head, t_begin * kKeys, sk);
  }
  sm90::cp_async_mbar_arrive(full);  // tile 0's phase also covers Q

  float o[HD / 2];
  float s[kKeys / 2];
  uint32_t ph[kKeys / 16][4], pl[kKeys / 16][4];  // P of the previous tile, two bf16 terms
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
  Softmax sm;

  // S = Q.K^T of the tile in stage st (64 rows x 128 keys per warpgroup)
  auto issue_s = [&](int st) {
    const uint32_t k_st = kv_s + st * 2 * kTile;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint32_t off = (kk / 4) * kRegion + (kk % 4) * 32;
      sm90::wgmma_ss<kKeys, 0>(s, sm90::desc(q_s + off + wg * 64 * 128, 0),
                               sm90::desc(k_st + off, 0), kk > 0);
    }
    sm90::wgmma_commit();
  };
  // O += P.V of the tile in stage st: P's A fragments of keys 16kk.. are
  // step kk's, V is read MN-major
  auto issue_pv = [&](int st) {
    const uint32_t v_st = kv_s + st * 2 * kTile + kTile;
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint64_t dv = sm90::desc(v_st + kk * 16 * 128, kRegion);
      sm90::wgmma_rs<HD, 1>(o, ph[kk], dv, 1);
      sm90::wgmma_rs<HD, 1>(o, pl[kk], dv, 1);
    }
    sm90::wgmma_commit();
  };
  // the S accumulator of keys 16kk..16kk+15 as the A fragment of step kk
  auto split_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mma::split(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], ph[kk][i], pl[kk][i]);
      }
    }
  };
  auto fence_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      sm90::fence_regs(ph[kk]);
      sm90::fence_regs(pl[kk]);
    }
  };
  // registers the next products read or write, pinned before wgmma.fence
  auto fence_operands = [&]() {
    sm90::fence_regs(s);
    sm90::fence_regs(o);
    fence_p();
  };
  // does the tile starting at key k0 cross a mask edge for this warpgroup?
  auto edge = [&](int k0) {
    return k0 + kKeys > sk || (causal && k0 + kKeys - 1 > w_lo) ||
           (window != 0 && k0 <= w_hi - window);
  };

  // tile j + 1 into its stage once both warpgroups are done with the tile
  // that held it; in flight while tile j is multiplied
  auto prefetch = [&](int j) {
    if (j + 1 >= n_tiles) return;
    const int nx = (j + 1) % kStages;
    if (j + 1 >= kStages) sm90::mbar_wait(empty + 8 * nx, ((j + 1) / kStages - 1) & 1);
    const uint32_t nxt = kv_s + nx * 2 * kTile;
    const int k1 = (t_begin + j + 1) * kKeys;
    load_tile<HD>(nxt, k_head, k1, sk);
    load_tile<HD>(nxt + kTile, v_head, k1, sk);
    sm90::cp_async_mbar_arrive(full + 8 * nx);
  };
  auto rescale_o = [&](float alpha0, float alpha1) {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[4 * n] *= alpha0;
      o[4 * n + 1] *= alpha0;
      o[4 * n + 2] *= alpha1;
      o[4 * n + 3] *= alpha1;
    }
  };

  // Software pipeline inside each warpgroup: tile j's scores and tile
  // j-1's P.V are issued together, and tile j's softmax runs while P.V is
  // on the tensor cores.  Tile 0 is peeled off, so the loop body always
  // has the same groups in flight (the compiler would otherwise serialize
  // the products).
  if (n_tiles > 0) {
    float alpha0, alpha1;
    prefetch(0);
    sm90::mbar_wait(full, 0);
    sm90::fence_proxy_async();
    fence_operands();
    sm90::wgmma_fence();
    issue_s(0);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm.update(s, edge(t_begin * kKeys), t_begin * kKeys, t, pos0, pos1, sk, causal, window,
              scale_log2, alpha0, alpha1);
    split_p();
    for (int j = 1; j < n_tiles; ++j) {
      const int k0 = (t_begin + j) * kKeys;
      prefetch(j);
      sm90::mbar_wait(full + 8 * (j % kStages), (j / kStages) & 1);
      sm90::fence_proxy_async();
      fence_operands();
      sm90::wgmma_fence();
      issue_s(j % kStages);
      sm90::wgmma_fence();
      issue_pv((j - 1) % kStages);
      sm90::wgmma_wait<1>();  // the scores; P.V still runs
      sm90::fence_regs(s);
      sm.update(s, edge(k0), k0, t, pos0, pos1, sk, causal, window, scale_log2, alpha0, alpha1);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      fence_p();
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty + 8 * ((j - 1) % kStages));  // tile j-1 done
      rescale_o(alpha0, alpha1);
      split_p();
    }
    fence_operands();  // the last tile's P.V
    sm90::wgmma_fence();
    issue_pv((n_tiles - 1) % kStages);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    fence_p();
  }
  float l0 = sm.l0, l1 = sm.l1;
  sm90::cp_async_wait<0>();  // (with no k tile, Q's copies were never waited for)

#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float d0 = fmaxf(l0, 1e-20f);
  const float d1 = fmaxf(l1, 1e-20f);
  float* out_head = out + static_cast<size_t>(bh) * sq * HD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < sq) {
      *reinterpret_cast<float2*>(out_head + static_cast<size_t>(row0) * HD + col) =
          make_float2(o[4 * n] / d0, o[4 * n + 1] / d0);
    }
    if (row1 < sq) {
      *reinterpret_cast<float2*>(out_head + static_cast<size_t>(row1) * HD + col) =
          make_float2(o[4 * n + 2] / d1, o[4 * n + 3] / d1);
    }
  }
}

template <int HD>
void launch_hd(const void* q, const void* k, const void* v, float* out, int bh, int sq, int sk,
               int groups, bool causal, int window, int q_offset, cudaStream_t stream) {
  // Q, then the stages of K and V; 1024 bytes to align the swizzled regions
  constexpr int kSmem = (1 + 2 * kStages) * (HD / 64) * kRegion + 1024;
  auto kernel = flash_attention_sm90_kernel<HD>;
  sm90::allow_smem<flash_attention_sm90_kernel<HD>>(kSmem);
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(HD));
  const dim3 grid((sq + kRows - 1) / kRows, bh);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), out, sq, sk, groups, scale_log2, causal, window,
      q_offset);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

void launch_flash_attention_sm90(const void* q, const void* k, const void* v, float* out,
                                 int bh, int sq, int sk, int groups, int head_dim, bool causal,
                                 int window, int q_offset, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch_hd<64>(q, k, v, out, bh, sq, sk, groups, causal, window, q_offset, stream);
    case 128:
      return launch_hd<128>(q, k, v, out, bh, sq, sk, groups, causal, window, q_offset, stream);
    default:
      TORCH_CHECK(false, "flash_attention_sm90: head_dim ", head_dim, " not in {64, 128}");
  }
}

}  // namespace repro_torch
