// Hopper (sm_90a) kernel of the int8-weight matrix product on mma.sync:
// out = x (M, K) @ (codes (K, N) int8 * scale (N,)), f32 accumulation,
// one cast to the output dtype at the end.  The wrapper
// (kernels/quant_matmul.py) sends it f32 x; bf16 x goes to the split-K and
// wgmma designs of quant_matmul_sm90.cu.
//
// Replaces the Pallas TPU kernel src/repro/kernels/quant_matmul.py:40
// (quant_matmul, pallas_call at :62).  The TPU kernel dequantizes each
// (bk, bn) block of codes to f32 inside the K loop and adds each K block's
// partial product into the output block in the output dtype (rounding at
// every K block when that is bf16).  Here the scale, being per output
// column, is taken out of the sum: sum_k x*codes*scale[n] =
// scale[n] * sum_k x*codes.  A block stages a (32 x 128) tile of codes
// into shared memory as bf16 (codes -127..127 are exact in bf16), runs
// bf16 x bf16 products on the tensor cores (mma.sync m16n8k16) into ONE
// f32 accumulator over all of K, and multiplies by scale and casts once in
// the epilogue, as the oracle (repro/kernels/ref.py) does.  No TF32: x is
// split into three bf16 terms that hold all of its significand (mma.cuh
// split3), and three products per step recover x*code exactly; only the
// f32 summation order differs from the oracle.
// Any M, K and N: loads past the edges read zeros and stores are masked,
// so the caller pads nothing (M = 8 decode steps included).
//
// What bounds it on this card: operations at a prefill's M (the three
// products per term triple the tensor-core work), bytes at a decode's.
// Block tile 64 x 128 over 4 warps (32 x 64 each), K in steps of 32; the
// codes are read once per M tile with 4-byte coalesced loads and
// transposed into (n, k) rows at staging so every fragment read is one
// conflict-free 32-bit load.  Staging is synchronous, between two
// barriers; the bf16 designs that needed a split over K and wgmma have
// their own kernels (quant_matmul_sm90.cu).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <c10/cuda/CUDAException.h>

#include "mma.cuh"

namespace repro_torch {

namespace {

constexpr int kBM = 64;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kLd = kBK + 8;  // staged row stride in bf16: conflict-free fragment reads
constexpr int kThreads = 128;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// 16 consecutive values of x (row gm, columns gk..gk+15) as f32, zeros past the edges
__device__ __forceinline__ void load_x16(const float* __restrict__ x, int m, int k, int gm,
                                         int gk, bool vec, float (&v)[16]) {
  const float* p = x + static_cast<size_t>(gm) * k + gk;
  if (gm < m && vec && gk + 16 <= k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 w = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = w.x;
      v[4 * i + 1] = w.y;
      v[4 * i + 2] = w.z;
      v[4 * i + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = (gm < m && gk + i < k) ? p[i] : 0.f;
  }
}

// grid (N tiles, M tiles), 4 warps in a 2 x 2 arrangement over the 64 x 128 tile
template <typename Tout>
__global__ void __launch_bounds__(kThreads)
    quant_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ codes,
                        const float* __restrict__ scale, Tout* __restrict__ out, int m, int n,
                        int k, bool x_vec, bool c_vec) {
  constexpr int kTerms = 3;  // bf16 terms of x
  __shared__ uint4 a_raw[kTerms][kBM * kLd / 8];
  __shared__ uint4 b_raw[kBN * kLd / 8];
  __nv_bfloat16* a_s[kTerms];
#pragma unroll
  for (int s = 0; s < kTerms; ++s) a_s[s] = reinterpret_cast<__nv_bfloat16*>(a_raw[s]);
  __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(b_raw);  // codes, (n, k) rows

  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 64;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    {  // x: thread -> row tid / 2, 16 columns
      const int r = threadIdx.x >> 1;
      const int c = (threadIdx.x & 1) * 16;
      float v[16];
      load_x16(x, m, k, m0 + r, k0 + c, x_vec, v);
      uint32_t w[kTerms][8];
#pragma unroll
      for (int i = 0; i < 8; ++i) mma::split3(v[2 * i], v[2 * i + 1], w[0][i], w[1][i], w[2][i]);
#pragma unroll
      for (int s = 0; s < kTerms; ++s) {
        uint4* dst = reinterpret_cast<uint4*>(a_s[s] + r * kLd + c);
        dst[0] = make_uint4(w[s][0], w[s][1], w[s][2], w[s][3]);
        dst[1] = make_uint4(w[s][4], w[s][5], w[s][6], w[s][7]);
      }
    }
    {  // codes: warp -> 8 k rows, lane -> 4 consecutive columns
      const int kr = warp * 8;
      const int nc = lane * 4;
      const int gn = n0 + nc;
      float c[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int gk = k0 + kr + r;
        const int8_t* p = codes + static_cast<size_t>(gk) * n + gn;
        if (gk < k && c_vec && gn + 4 <= n) {
          const char4 w = *reinterpret_cast<const char4*>(p);
          c[r][0] = w.x;
          c[r][1] = w.y;
          c[r][2] = w.z;
          c[r][3] = w.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) c[r][j] = (gk < k && gn + j < n) ? p[j] : 0;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<uint4*>(b_s + (nc + j) * kLd + kr) =
            make_uint4(mma::pack(c[0][j], c[1][j]), mma::pack(c[2][j], c[3][j]),
                       mma::pack(c[4][j], c[5][j]), mma::pack(c[6][j], c[7][j]));
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[kTerms][2][4];
#pragma unroll
      for (int s = 0; s < kTerms; ++s) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const __nv_bfloat16* p = a_s[s] + (wm + mi * 16 + g) * kLd + kk * 16 + 2 * t;
          a[s][mi][0] = mma::ld32(p);
          a[s][mi][1] = mma::ld32(p + 8 * kLd);
          a[s][mi][2] = mma::ld32(p + 8);
          a[s][mi][3] = mma::ld32(p + 8 * kLd + 8);
        }
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const __nv_bfloat16* p = b_s + (wn + ni * 8 + g) * kLd + kk * 16 + 2 * t;
        const uint32_t b0 = mma::ld32(p);
        const uint32_t b1 = mma::ld32(p + 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int s = 0; s < kTerms; ++s) mma::mma_bf16(acc[mi][ni], a[s][mi], b0, b1);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: the column's scale once, one cast, masked stores
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const int col = n0 + wn + ni * 8 + 2 * t;
    const float s0 = col < n ? scale[col] : 0.f;
    const float s1 = col + 1 < n ? scale[col + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + g + 8 * h;
        if (row >= m) continue;
        Tout* o = out + static_cast<size_t>(row) * n + col;
        if (col < n) store(o, acc[mi][ni][2 * h] * s0);
        if (col + 1 < n) store(o + 1, acc[mi][ni][2 * h + 1] * s1);
      }
    }
  }
}

template <typename Tout>
void launch_typed(const float* x, const int8_t* codes, const float* scale, void* out, int m,
                  int n, int k, cudaStream_t stream) {
  // vector loads need 16-byte aligned x rows and 4-byte aligned code rows
  const bool x_vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && k % 4 == 0;
  const bool c_vec = reinterpret_cast<uintptr_t>(codes) % 4 == 0 && n % 4 == 0;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  quant_matmul_kernel<Tout><<<grid, kThreads, 0, stream>>>(
      x, codes, scale, static_cast<Tout*>(out), m, n, k, x_vec, c_vec);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

// f32 x; bf16 x takes quant_matmul_sm90.cu
void launch_quant_matmul(const float* x, const int8_t* codes, const float* scale, void* out,
                         int m, int n, int k, bool out_bf16, cudaStream_t stream) {
  if (out_bf16) {
    launch_typed<__nv_bfloat16>(x, codes, scale, out, m, n, k, stream);
  } else {
    launch_typed<float>(x, codes, scale, out, m, n, k, stream);
  }
}

}  // namespace repro_torch
