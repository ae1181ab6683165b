// Hopper (sm_90a) kernel of prefill attention on mma.sync: causal /
// windowed / offset online-softmax attention with GQA, f32 out.  The
// wrapper (kernels/flash_attention.py) sends it f32 inputs and head dim
// 32; bf16 inputs at head dim 64 and 128 go to the wgmma design of
// flash_attention_sm90.cu.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:84
// (flash_attention, pallas_call at :108).  On the TPU the grid is
// (BH, Sq / block_q, Sk / block_k) and runs in order on one core, so the
// kernel carries the running max m, sum l and accumulator across the
// innermost k axis in its output refs, computes every (q, k) tile and masks
// it.  On Hopper blocks run in parallel and carry nothing between them:
// one block of 4 warps owns one (q head, 64-row q tile) and walks the k
// tiles itself, each warp keeping m, l and its 16 x hd accumulator in
// registers.  The kv head is bh / groups, as in the TPU index map, so K/V
// are never replicated.  k tiles that the causal or window mask removes
// entirely are never visited (the TPU kernel computes and masks them; the
// result is the same), and the block's q tiles are issued latest first so
// the long causal rows start early.  Any Sq and Sk: rows and keys past the
// end are masked here, not padded by the caller.
//
// Arithmetic.  Scores are q.k in f32 scaled afterwards by 1/sqrt(hd), as
// the oracle (repro/kernels/ref.py) does; the TPU kernel scales q first.
// q.k^T and p.v run on the tensor cores (mma.sync m16n8k16, bf16 operands,
// f32 accumulation; no TF32 anywhere):
// * bf16 inputs go in as they are: each product q*k is exact in f32.
// * f32 inputs are split into two bf16 terms x ~ hi + lo (16 of the 24
//   significand bits, mma.cuh) and q.k^T takes three products
//   (hi*hi + hi*lo + lo*hi): each product is within about 3 * 2^-16 of its
//   f32 value, against 2^-11 for TF32.
// * p (f32, in [0, 1]) is split the same way and p.v takes two products
//   (p_hi*v + p_lo*v; with f32 v a third, p_hi*v_lo): each term of the
//   value sum is within about 2^-16 of its f32 value.  Feeding p to the
//   tensor cores as one bf16 would cost 2^-8 per term, which rows with few
//   keys turn into output errors near 1e-3.
// Measured on the card against the plain version (chip_smoke.py): see
// PERF.md.  The softmax state, the masks and the final division by
// max(l, 1e-20) (rows with no valid key give 0, not NaN) are f32.
//
// What bounds it on this card: operations.  For f32 inputs the split
// products are counted at the f32 rate (the tensor cores take the bf16
// terms, so the kernel runs close to that bound: PERF.md).  The design
// keeps every score on chip (registers), reads each K/V tile once per q
// tile into shared memory, reuses the score fragments as the A operand of
// p.v without a shared-memory round trip, and reads V's B fragments with
// ldmatrix.trans.  Loads are synchronous; the bf16 path that needed a
// pipelined ring and wgmma has its own kernel (flash_attention_sm90.cu).

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <c10/cuda/CUDAException.h>

#include "mma.cuh"

namespace repro_torch {

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kBlockQ = 16 * kWarps;  // 16 query rows per warp
constexpr int kBlockK = 64;           // keys per k tile

// 8 consecutive inputs as bf16: hi (and lo = bf16(x - hi) for f32 inputs)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, uint4& hi, uint4&) {
  hi = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void load8(const float* p, uint4& hi, uint4& lo) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  mma::split(a.x, a.y, hi.x, lo.x);
  mma::split(a.z, a.w, hi.y, lo.y);
  mma::split(b.x, b.y, hi.z, lo.z);
  mma::split(b.z, b.w, hi.w, lo.w);
}

// 2 consecutive inputs as one bf16 pair (and its lo pair for f32)
__device__ __forceinline__ void load2(const __nv_bfloat16* p, uint32_t& hi, uint32_t&) {
  hi = mma::ld32(p);
}
__device__ __forceinline__ void load2(const float* p, uint32_t& hi, uint32_t& lo) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  mma::split(a.x, a.y, hi, lo);
}

// rows [k0, k0 + kBlockK) of one kv head into shared memory (row stride
// HD + 8 bf16, so the fragment reads below hit 32 distinct banks); rows at
// or past sk are zero, so masked p (0) never meets a stale or non-finite v
template <typename T, int HD>
__device__ __forceinline__ void stage(const T* __restrict__ src, int k0, int sk,
                                      __nv_bfloat16* hi, __nv_bfloat16* lo) {
  constexpr int kLd = HD + 8;
  constexpr int kPerRow = HD / 8;
  for (int e = threadIdx.x; e < kBlockK * kPerRow; e += kWarps * 32) {
    const int r = e / kPerRow;
    const int c = (e % kPerRow) * 8;
    uint4 h = make_uint4(0, 0, 0, 0);
    uint4 l = make_uint4(0, 0, 0, 0);
    if (k0 + r < sk) load8(src + static_cast<size_t>(k0 + r) * HD + c, h, l);
    *reinterpret_cast<uint4*>(hi + r * kLd + c) = h;
    if constexpr (std::is_same_v<T, float>) *reinterpret_cast<uint4*>(lo + r * kLd + c) = l;
  }
}

// grid (q tiles, BH), 4 warps; dynamic shared memory holds one k tile of
// K and V as bf16 (hi, and lo for f32 inputs)
template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, float* __restrict__ out, int sq, int sk,
                           int groups, float scale_log2, bool causal, int window,
                           int q_offset) {
  constexpr bool kSplit = std::is_same_v<T, float>;
  constexpr int kLd = HD + 8;
  constexpr int kSteps = HD / 16;    // k16 steps of q.k^T
  constexpr int kTiles = HD / 8;     // n8 tiles of the accumulator
  constexpr int kSTiles = kBlockK / 8;
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* k_hi = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_hi = k_hi + kBlockK * kLd;
  __nv_bfloat16* k_lo = v_hi + kBlockK * kLd;  // f32 inputs only
  __nv_bfloat16* v_lo = k_lo + kBlockK * kLd;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;  // latest q tiles first
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const T* q_head = q + static_cast<size_t>(bh) * sq * HD;
  const size_t kv_off = static_cast<size_t>(bh / groups) * sk * HD;
  const int row0 = q0 + warp * 16 + g;  // this thread's two query rows
  const int row1 = row0 + 8;
  const int pos0 = q_offset + row0;
  const int pos1 = q_offset + row1;

  // q fragments (A operand) for every k16 step, in registers
  uint32_t qh[kSteps][4];
  uint32_t ql[kSplit ? kSteps : 1][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (i & 1) ? row1 : row0;
      const int col = kk * 16 + 2 * t + ((i & 2) ? 8 : 0);
      uint32_t h = 0, l = 0;
      if (row < sq) load2(q_head + static_cast<size_t>(row) * HD + col, h, l);
      qh[kk][i] = h;
      if constexpr (kSplit) ql[kk][i] = l;
    }
  }

  float o[kTiles][4];
#pragma unroll
  for (int n = 0; n < kTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max (log2 domain) of rows 0 / 1
  float l0 = 0.f, l1 = 0.f;          // this thread's part of the running sums

  // keys any row of the tile may see; tiles outside are skipped
  const int pos_lo = q_offset + q0;
  const int pos_hi = q_offset + min(q0 + kBlockQ, sq) - 1;
  const int k_end = causal ? min(sk, pos_hi + 1) : sk;
  const int k_begin = window != 0 ? max(0, pos_lo - window + 1) : 0;

  for (int k0 = (k_begin / kBlockK) * kBlockK; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous tile
    stage<T, HD>(k + kv_off, k0, sk, k_hi, k_lo);
    stage<T, HD>(v + kv_off, k0, sk, v_hi, v_lo);
    __syncthreads();

    // s = q.k^T for 16 rows x 64 keys
    float s[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
        const int off = (j * 8 + g) * kLd + kk * 16 + 2 * t;
        const uint32_t b0 = mma::ld32(k_hi + off);
        const uint32_t b1 = mma::ld32(k_hi + off + 8);
        mma::mma_bf16(s[j], qh[kk], b0, b1);
        if constexpr (kSplit) {
          mma::mma_bf16(s[j], qh[kk], mma::ld32(k_lo + off), mma::ld32(k_lo + off + 8));
          mma::mma_bf16(s[j], ql[kk], b0, b1);
        }
      }
    }

    // mask, then the online softmax in the log2 domain
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const int pos = e < 2 ? pos0 : pos1;
        bool ok = key < sk;
        if (causal) ok = ok && key <= pos;
        if (window != 0) ok = ok && key > pos - window;
        s[j][e] = ok ? s[j][e] * scale_log2 : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {  // the 4 threads of a row group
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    // rows with no valid key yet keep m == kNegInf: guard the rescale
    const float alpha0 = m0 == kNegInf ? 0.f : exp2f(m0 - mn0);
    const float alpha1 = m1 == kNegInf ? 0.f : exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e < 2 ? mn0 : mn1;
        s[j][e] = s[j][e] == kNegInf ? 0.f : exp2f(s[j][e] - mn);
      }
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int n = 0; n < kTiles; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }

    // o += p.v: the score fragments of keys 16kk..16kk+15 are the A
    // fragment of step kk; V's B fragments come transposed by ldmatrix
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      mma::split(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      mma::split(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      mma::split(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      mma::split(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      // lane l addresses row (l % 8) of matrix l / 8: keys +8 for odd
      // matrices, the next n8 tile of hd for matrices 2 and 3
      const int v_off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < kTiles; n += 2) {
        uint32_t b[4];
        mma::ldmatrix_x4_trans(b, v_hi + v_off + n * 8);
        mma::mma_bf16(o[n], ph, b[0], b[1]);
        mma::mma_bf16(o[n], pl, b[0], b[1]);
        mma::mma_bf16(o[n + 1], ph, b[2], b[3]);
        mma::mma_bf16(o[n + 1], pl, b[2], b[3]);
        if constexpr (kSplit) {
          mma::ldmatrix_x4_trans(b, v_lo + v_off + n * 8);
          mma::mma_bf16(o[n], ph, b[0], b[1]);
          mma::mma_bf16(o[n + 1], ph, b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float d0 = fmaxf(l0, 1e-20f);
  const float d1 = fmaxf(l1, 1e-20f);
  float* out_head = out + static_cast<size_t>(bh) * sq * HD;
#pragma unroll
  for (int n = 0; n < kTiles; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < sq) {
      *reinterpret_cast<float2*>(out_head + static_cast<size_t>(row0) * HD + col) =
          make_float2(o[n][0] / d0, o[n][1] / d0);
    }
    if (row1 < sq) {
      *reinterpret_cast<float2*>(out_head + static_cast<size_t>(row1) * HD + col) =
          make_float2(o[n][2] / d1, o[n][3] / d1);
    }
  }
}

template <typename T, int HD>
void launch_typed(const void* q, const void* k, const void* v, float* out, int bh, int sq,
                  int sk, int groups, bool causal, int window, int q_offset,
                  cudaStream_t stream) {
  constexpr int kArrays = std::is_same_v<T, float> ? 4 : 2;  // K, V (hi, lo)
  const size_t smem = sizeof(__nv_bfloat16) * kArrays * kBlockK * (HD + 8);
  auto kernel = flash_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    C10_CUDA_CHECK(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(smem)));
  }
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(HD));
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, bh);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), out, sq,
      sk, groups, scale_log2, causal, window, q_offset);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

template <typename T>
void launch_hd(const void* q, const void* k, const void* v, float* out, int bh, int sq,
               int sk, int groups, int head_dim, bool causal, int window, int q_offset,
               cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch_typed<T, 32>(q, k, v, out, bh, sq, sk, groups, causal, window, q_offset,
                                 stream);
    case 64:
      return launch_typed<T, 64>(q, k, v, out, bh, sq, sk, groups, causal, window, q_offset,
                                 stream);
    case 128:
      return launch_typed<T, 128>(q, k, v, out, bh, sq, sk, groups, causal, window,
                                  q_offset, stream);
    default:
      TORCH_CHECK(false, "flash_attention: head_dim ", head_dim, " not in {32, 64, 128}");
  }
}

}  // namespace

void launch_flash_attention(const void* q, const void* k, const void* v, float* out, int bh,
                            int sq, int sk, int groups, int head_dim, bool bf16, bool causal,
                            int window, int q_offset, cudaStream_t stream) {
  if (bf16) {  // hd 64 and 128 take flash_attention_sm90.cu
    TORCH_CHECK(head_dim == 32, "flash_attention (mma.sync): bf16 head_dim ", head_dim,
                " belongs to the wgmma kernel");
    launch_typed<__nv_bfloat16, 32>(q, k, v, out, bh, sq, sk, groups, causal, window, q_offset,
                                    stream);
  } else {
    launch_hd<float>(q, k, v, out, bh, sq, sk, groups, head_dim, causal, window, q_offset,
                     stream);
  }
}

}  // namespace repro_torch
