// Hopper (sm_90a) kernels of kernel-resident paged decode.
//
// paged_attention replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention.py::paged_attention: decode attention,
// one query token per sequence, reading K/V blocks (P, bs, KH, hd) through a
// block table (B, T).  On the TPU the grid walked (sequence, table column)
// in order, with the block id scalar-prefetched into the BlockSpec index map
// and the online-softmax state carried in output refs.  Here one thread
// block owns one (sequence, kv head) and walks the live table columns in a
// loop: it reads each block id itself, stages that block's K and V rows for
// its kv head in shared memory (as f32), and keeps the running max / sum /
// accumulator in registers, one warp per query head of the GQA group.
// Columns at or past ceil(ctx / bs) are never read, so pad table entries
// (the null block) and pad lanes (ctx 1) stay inert.
//
// What bounds it: bytes.  A decode step reads every live K/V byte once and
// does 4 flops per byte-pair; at the serving shapes (B=8, ctx <= ~600,
// KH=2, hd=128) a launch moves a few MB, so it is launch- and latency-bound.
// The design keeps the loads coalesced along hd and reads each K/V element
// from device memory once per (sequence, kv head); wgmma/TMA and splitting
// long contexts across blocks are later work.
//
// paged_decode_write replaces
// src/repro/kernels/paged_attention.py::paged_decode_write: the in-place
// write of one K/V token per lane at (block_ids[b], offsets[b]).  One block
// per lane, threads over KH*hd, casting into the pool's dtype.  It moves
// 2 * B * KH * hd elements: bound by launch latency.  Pad lanes may all
// target the null block; which write wins there is unspecified by contract.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <c10/cuda/CUDAException.h>

namespace repro_torch {

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// grid (B, KH), block groups * 32 threads: warp w serves query head
// kh * groups + w.  VPT = head_dim / 32 values per lane.
template <typename T, int VPT>
__global__ void paged_attention_kernel(const T* __restrict__ q,
                                       const T* __restrict__ k_blocks,
                                       const T* __restrict__ v_blocks,
                                       const int32_t* __restrict__ tables,
                                       const int32_t* __restrict__ lens,
                                       float* __restrict__ out, int n_tab,
                                       int block_size, int kv_heads, int groups,
                                       float scale) {
  constexpr int kHd = VPT * 32;
  extern __shared__ float smem[];
  float* k_s = smem;                              // (bs, hd)
  float* v_s = k_s + block_size * kHd;            // (bs, hd)
  float* score_s = v_s + block_size * kHd;        // (groups, bs)

  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_heads = kv_heads * groups;
  const int head = kh * groups + warp;
  const int ctx = lens[b];

  float qv[VPT];
  float acc[VPT];
  const T* q_row = q + (static_cast<size_t>(b) * n_heads + head) * kHd;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    qv[i] = to_f32(q_row[lane + 32 * i]) * scale;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;
  float* my_scores = score_s + warp * block_size;

  const int n_live = min(n_tab, (ctx + block_size - 1) / block_size);
  for (int t = 0; t < n_live; ++t) {
    const int blk = tables[static_cast<size_t>(b) * n_tab + t];
    __syncthreads();  // every warp is done with the previous block
    for (int e = threadIdx.x; e < block_size * kHd; e += blockDim.x) {
      const int j = e / kHd;
      const int d = e % kHd;
      const size_t src =
          ((static_cast<size_t>(blk) * block_size + j) * kv_heads + kh) * kHd + d;
      k_s[e] = to_f32(k_blocks[src]);
      v_s[e] = to_f32(v_blocks[src]);
    }
    __syncthreads();

    float m_blk = kNegInf;
    for (int j = 0; j < block_size; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < VPT; ++i) part += qv[i] * k_s[j * kHd + lane + 32 * i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      const float s = (t * block_size + j < ctx) ? part : kNegInf;
      if (lane == 0) my_scores[j] = s;
      m_blk = fmaxf(m_blk, s);
    }
    __syncwarp();

    const float m_new = fmaxf(m, m_blk);
    const float alpha = (m == kNegInf) ? 0.f : expf(fminf(m - m_new, 0.f));
    float p_sum = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) acc[i] *= alpha;
    for (int j = 0; j < block_size; ++j) {
      const float p = (t * block_size + j < ctx) ? expf(my_scores[j] - m_new) : 0.f;
      p_sum += p;
#pragma unroll
      for (int i = 0; i < VPT; ++i) acc[i] += p * v_s[j * kHd + lane + 32 * i];
    }
    l = l * alpha + p_sum;
    m = m_new;
  }

  float* o_row = out + (static_cast<size_t>(b) * n_heads + head) * kHd;
  const float denom = fmaxf(l, 1e-20f);
#pragma unroll
  for (int i = 0; i < VPT; ++i) o_row[lane + 32 * i] = acc[i] / denom;
}

// grid B, threads over one token row of KH * hd elements
template <typename Tin, typename Tout>
__global__ void paged_decode_write_kernel(Tout* __restrict__ k_blocks,
                                          Tout* __restrict__ v_blocks,
                                          const Tin* __restrict__ new_k,
                                          const Tin* __restrict__ new_v,
                                          const int32_t* __restrict__ block_ids,
                                          const int32_t* __restrict__ offsets,
                                          int block_size, int row) {
  const int b = blockIdx.x;
  const size_t dst =
      (static_cast<size_t>(block_ids[b]) * block_size + offsets[b]) * row;
  const size_t src = static_cast<size_t>(b) * row;
  for (int e = threadIdx.x; e < row; e += blockDim.x) {
    k_blocks[dst + e] = from_f32<Tout>(to_f32(new_k[src + e]));
    v_blocks[dst + e] = from_f32<Tout>(to_f32(new_v[src + e]));
  }
}

template <typename T, int VPT>
void launch_attention_typed(const void* q, const void* k_blocks, const void* v_blocks,
                            const int32_t* tables, const int32_t* lens, float* out,
                            int batch, int n_tab, int block_size, int kv_heads,
                            int groups, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(block_size) * VPT * 32 +
                       static_cast<size_t>(groups) * block_size);
  auto kernel = paged_attention_kernel<T, VPT>;
  if (smem > 48 * 1024) {
    C10_CUDA_CHECK(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  }
  kernel<<<dim3(batch, kv_heads), groups * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_blocks),
      static_cast<const T*>(v_blocks), tables, lens, out, n_tab, block_size, kv_heads,
      groups, scale);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

template <typename T>
void launch_attention_hd(const void* q, const void* k_blocks, const void* v_blocks,
                         const int32_t* tables, const int32_t* lens, float* out,
                         int batch, int n_tab, int block_size, int kv_heads, int groups,
                         int head_dim, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch_attention_typed<T, 1>(q, k_blocks, v_blocks, tables, lens, out, batch,
                                          n_tab, block_size, kv_heads, groups, scale, stream);
    case 64:
      return launch_attention_typed<T, 2>(q, k_blocks, v_blocks, tables, lens, out, batch,
                                          n_tab, block_size, kv_heads, groups, scale, stream);
    case 128:
      return launch_attention_typed<T, 4>(q, k_blocks, v_blocks, tables, lens, out, batch,
                                          n_tab, block_size, kv_heads, groups, scale, stream);
    case 256:
      return launch_attention_typed<T, 8>(q, k_blocks, v_blocks, tables, lens, out, batch,
                                          n_tab, block_size, kv_heads, groups, scale, stream);
    default:
      TORCH_CHECK(false, "paged_attention: head_dim ", head_dim,
                  " not in {32, 64, 128, 256}");
  }
}

template <typename Tin, typename Tout>
void launch_write_typed(void* k_blocks, void* v_blocks, const void* new_k,
                        const void* new_v, const int32_t* block_ids,
                        const int32_t* offsets, int batch, int block_size, int row,
                        cudaStream_t stream) {
  const int threads = row < 256 ? ((row + 31) / 32) * 32 : 256;
  paged_decode_write_kernel<Tin, Tout><<<batch, threads, 0, stream>>>(
      static_cast<Tout*>(k_blocks), static_cast<Tout*>(v_blocks),
      static_cast<const Tin*>(new_k), static_cast<const Tin*>(new_v), block_ids, offsets,
      block_size, row);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

void launch_paged_attention(const void* q, const void* k_blocks, const void* v_blocks,
                            const int32_t* tables, const int32_t* lens, float* out,
                            int batch, int n_tab, int block_size, int kv_heads,
                            int groups, int head_dim, bool bf16, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(head_dim));
  if (bf16) {
    launch_attention_hd<__nv_bfloat16>(q, k_blocks, v_blocks, tables, lens, out, batch,
                                       n_tab, block_size, kv_heads, groups, head_dim,
                                       scale, stream);
  } else {
    launch_attention_hd<float>(q, k_blocks, v_blocks, tables, lens, out, batch, n_tab,
                               block_size, kv_heads, groups, head_dim, scale, stream);
  }
}

void launch_paged_decode_write(void* k_blocks, void* v_blocks, const void* new_k,
                               const void* new_v, const int32_t* block_ids,
                               const int32_t* offsets, int batch, int block_size,
                               int row, bool in_bf16, bool pool_bf16,
                               cudaStream_t stream) {
  if (in_bf16 && pool_bf16) {
    launch_write_typed<__nv_bfloat16, __nv_bfloat16>(k_blocks, v_blocks, new_k, new_v,
                                                     block_ids, offsets, batch,
                                                     block_size, row, stream);
  } else if (in_bf16) {
    launch_write_typed<__nv_bfloat16, float>(k_blocks, v_blocks, new_k, new_v, block_ids,
                                             offsets, batch, block_size, row, stream);
  } else if (pool_bf16) {
    launch_write_typed<float, __nv_bfloat16>(k_blocks, v_blocks, new_k, new_v, block_ids,
                                             offsets, batch, block_size, row, stream);
  } else {
    launch_write_typed<float, float>(k_blocks, v_blocks, new_k, new_v, block_ids,
                                     offsets, batch, block_size, row, stream);
  }
}

}  // namespace repro_torch
