// Hopper (sm_90a) kernels of kernel-resident paged decode.
//
// paged_attention replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention.py::paged_attention: decode attention,
// one query token per sequence, reading K/V pages (P, bs, KH, hd) through a
// block table (B, T).  On the TPU the grid walked (sequence, table column)
// in order, with the page id scalar-prefetched into the BlockSpec index map
// and the online-softmax state carried in output refs from one grid step
// to the next.
//
// What bounds it: bytes.  A decode step reads every live K/V byte once and
// does 2 flops per element of each (8 per bf16 K/V byte-pair at GQA groups
// 8, ~40% of the f32 rate at the memory rate); at qwen2.5-3b's shapes (8
// lanes, 2 kv heads, hd 128) one lane-head walks at most a few hundred
// pages, so the card fills only if the context is split across blocks and
// the page loads of a block overlap its arithmetic.  The design:
//
// * grid (B, KH, S): split s of (lane, kv head) walks table columns
//   [s * cols, (s + 1) * cols), cut at ceil(ctx / bs); a split that starts
//   past it exits at once (m = -1e30, l = 0).  The wrapper plans S and cols
//   from host-known shapes only (split_plan in paged_attention.py).
// * GQA groups up to kMaxGroups (granite-34b's MQA puts 48 q heads on one
//   kv head): the group bound is a template parameter, one instance for
//   groups <= 32 and one for <= 64, so the per-thread accumulators follow
//   the bound and a small group keeps its registers.  A split's scores
//   take groups x cols x bs x 4 bytes of shared memory; split_plan caps
//   cols so that the whole layout (split_smem) fits in kMaxSmem.
// * The split's table entries go to shared memory once; its pages stream
//   through a ring of `stages` tiles, each one page's bs rows of one kv
//   head (K pages first, then V pages), copied as 16-byte cp.async chunks
//   in the pool's own dtype; each stage's mbarrier completes when every
//   thread's copies into it have landed, so up to stages - 1 pages are in
//   flight while one computes.  Rows are padded by 16 bytes so that a warp
//   reading one chunk of 8 different rows hits 8 different bank groups.
// * The whole GQA group shares each staged page: q's `groups` heads sit in
//   shared memory as f32.  Scores: one thread per (head, key), a dot product
//   over 16-byte chunks with kVec independent partial sums and q read as a
//   broadcast, no shuffles.  The split's scores stay in shared memory, so
//   the softmax is a plain two-pass one per split (one max and one sum per
//   head, the only shuffle reductions) and P.V needs no rescaling: one
//   thread per (head, 16-byte column chunk) adds p * v over the page's keys.
//   All of it is f32 on the CUDA cores.
// * S == 1 normalises and writes the output; S > 1 writes (acc, m, l) to an
//   f32 workspace (S, B, H, hd + 2) and a second kernel combines the splits
//   that hold a live key in a fixed order (no atomics: deterministic) and
//   normalises.  A row with no valid key gives 0.
//
// Measured on an H100 (PERF.md): neither the ring's depth (2 to 8 stages)
// nor moving q.k and p.v onto mma.sync changed the time of a split, and
// warm-L2 and cold times agree, so a split is held back by its serial chain
// per page (barrier, wait, issue, arithmetic) rather than by bytes.
//
// paged_decode_write replaces
// src/repro/kernels/paged_attention.py::paged_decode_write: the in-place
// write of one K/V token per lane at (block_ids[b], offsets[b]).  It moves
// 2 * B * KH * hd elements (8 KB at the serving shape): bound by launch
// latency, so one thread per element of the B token rows casts K and V into
// the pool's dtype (a 16-byte vector path measured no faster on an H100:
// PERF.md).  One launch covers every lane.  Pad lanes may all target the
// null block; which write wins there is unspecified by contract.

#include <algorithm>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <c10/cuda/CUDAException.h>

#include "wgmma.cuh"

namespace repro_torch {

// splits of a table of n_tab columns at cols columns per split
int paged_attention_splits(int n_tab, int cols) {
  return n_tab > 0 ? (n_tab + cols - 1) / cols : 1;
}

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr int kThreads = 128;      // threads of a split block
constexpr int kWarps = kThreads / 32;
// GQA groups (q heads per kv head) an instance takes: one instance per
// bound, so a small group (qwen2.5-3b's 8) keeps the registers of 32
constexpr int kMaxGroups = 64;
constexpr int kMaxHd = 256;
constexpr int kMaxStages = 8;
constexpr int kRingBytes = 24 * 1024;  // the ring's target size
constexpr int kMaxSmem = 232448;       // 227 KB, the most a block can have

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

// a 16-byte chunk as f32: 4 floats, or 8 bf16 (bf16 -> f32 is a shift)
__device__ __forceinline__ void unpack(const uint4 raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4 raw, float (&v)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// byte offsets of a split block's dynamic shared memory
struct SplitSmem {
  int tab, ml, q, s, ring, total, row_bytes, tile_bytes;
};

__host__ __device__ inline SplitSmem split_smem(int groups, int hd, int elt, int bs,
                                                int cols, int stages) {
  SplitSmem L;
  L.row_bytes = hd * elt + 16;             // one padded K or V row
  L.tile_bytes = bs * L.row_bytes;         // one page of one kv head
  int off = kMaxStages * 8;                // the stages' mbarriers
  L.tab = off;                             // the split's table entries
  off = align16(off + cols * 4);
  L.ml = off;                              // per head max and sum
  off = align16(off + 2 * groups * 4);
  L.q = off;                               // (groups, hd) f32
  off += groups * hd * 4;
  L.s = off;                               // (groups, cols * bs) f32 scores, then p
  off = align16(off + groups * cols * bs * 4);
  L.ring = off;
  L.total = off + stages * L.tile_bytes;
  return L;
}

// grid (B, KH, S), kThreads threads.  ws (S, B, H, HD + 2): acc, m, l.
// MAXG bounds the group: each thread keeps ceil(MAXG * chunks / kThreads)
// accumulator chunks of kVec f32 in registers.
template <typename T, int HD, int MAXG>
__global__ void __launch_bounds__(kThreads)
    paged_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                                 const T* __restrict__ v_pool,
                                 const int32_t* __restrict__ tables,
                                 const int32_t* __restrict__ lens, float* __restrict__ out,
                                 float* __restrict__ ws, int n_tab, int bs, int kv_heads,
                                 int groups, int cols, int stages, float scale) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int kChunks = HD / kVec;    // chunks per row
  constexpr int kItems = (MAXG * kChunks + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const SplitSmem L = split_smem(groups, HD, sizeof(T), bs, cols, stages);
  int* tab_s = reinterpret_cast<int*>(smem + L.tab);
  float* m_s = reinterpret_cast<float*>(smem + L.ml);
  float* l_s = m_s + groups;
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  unsigned char* ring = smem + L.ring;
  const uint32_t bars = sm90::smem_addr(smem);

  const int b = blockIdx.x, kh = blockIdx.y, split = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int heads = kv_heads * groups;
  const int keys = cols * bs;  // row stride of the scores
  const int ctx = lens[b];
  const int n_live = min(n_tab, (max(ctx, 0) + bs - 1) / bs);
  const int c0 = split * cols;
  const int n = min(cols, n_live - c0);  // live columns of this split
  const size_t row0 = static_cast<size_t>(b) * heads + static_cast<size_t>(kh) * groups;
  float* part = ws + ((static_cast<size_t>(split) * gridDim.x + b) * heads +
                      static_cast<size_t>(kh) * groups) * (HD + 2);

  if (n <= 0) {  // no live key of this lane in the split
    if (splits == 1) {
      for (int e = tid; e < groups * HD; e += kThreads) out[row0 * HD + e] = 0.f;
    } else {
      for (int g = tid; g < groups; g += kThreads) {
        part[g * (HD + 2) + HD] = kNegInf;
        part[g * (HD + 2) + HD + 1] = 0.f;
      }
    }
    return;
  }

  for (int t = tid; t < n; t += kThreads) {
    tab_s[t] = tables[static_cast<size_t>(b) * n_tab + c0 + t];
  }
  const T* q_row = q + row0 * HD;
  for (int e = tid; e < groups * HD; e += kThreads) q_s[e] = to_f32(q_row[e]);
  if (tid == 0) {
    for (int st = 0; st < stages; ++st) sm90::mbar_init(bars + 8 * st, kThreads);
  }
  __syncthreads();

  // tile i < n is page tab_s[i] of K, tile n + i the same page of V
  const int tiles = 2 * n;
  const size_t row_stride = static_cast<size_t>(kv_heads) * HD;
  auto load = [&](int i) {
    const int st = i % stages;
    const T* pool = i < n ? k_pool : v_pool;
    const size_t blk = static_cast<size_t>(tab_s[i < n ? i : i - n]);
    const T* src = pool + (blk * bs * kv_heads + kh) * HD;
    const uint32_t dst = sm90::smem_addr(ring + st * L.tile_bytes);
    for (int e = tid; e < bs * kChunks; e += kThreads) {
      const int j = e / kChunks, c = e - j * kChunks;
      sm90::cp_async16(dst + j * L.row_bytes + c * 16, src + j * row_stride + c * kVec, 16);
    }
    sm90::cp_async_mbar_arrive(bars + 8 * st);  // once this thread's copies land
  };
  for (int i = 0; i < min(stages - 1, tiles); ++i) load(i);

  float acc[kItems][kVec];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
#pragma unroll
    for (int u = 0; u < kVec; ++u) acc[it][u] = 0.f;
  }

  for (int i = 0; i < tiles; ++i) {
    __syncthreads();  // every thread is done with tile i - 1: its stage refills
    if (i + stages - 1 < tiles) load(i + stages - 1);
    const int st = i % stages;
    sm90::mbar_wait(bars + 8 * st, (i / stages) & 1);
    const unsigned char* tile = ring + st * L.tile_bytes;
    const int t = i < n ? i : i - n;
    const int nv = min(bs, ctx - (c0 + t) * bs);  // valid keys of the page

    if (i < n) {  // scores of page t: one thread per (head, key)
      for (int p = tid; p < groups * bs; p += kThreads) {
        const int g = p / bs, j = p - g * bs;
        if (j >= nv) continue;
        const unsigned char* kr = tile + j * L.row_bytes;
        const float* qr = q_s + g * HD;
        float sum[kVec];
#pragma unroll
        for (int u = 0; u < kVec; ++u) sum[u] = 0.f;
#pragma unroll 4
        for (int c = 0; c < kChunks; ++c) {
          float kv[kVec];
          unpack(*reinterpret_cast<const uint4*>(kr + c * 16), kv);
#pragma unroll
          for (int u = 0; u < kVec; u += 4) {
            const float4 qq = *reinterpret_cast<const float4*>(qr + c * kVec + u);
            sum[u] += qq.x * kv[u];
            sum[u + 1] += qq.y * kv[u + 1];
            sum[u + 2] += qq.z * kv[u + 2];
            sum[u + 3] += qq.w * kv[u + 3];
          }
        }
        float s = 0.f;
#pragma unroll
        for (int u = 0; u < kVec; ++u) s += sum[u];
        s_s[g * keys + t * bs + j] = s * scale;
      }
      continue;
    }

    if (i == n) {  // every score is in: the split's softmax, one warp per head
      const int n_keys = min(n * bs, ctx - c0 * bs);
      for (int g = warp; g < groups; g += kWarps) {
        float* sr = s_s + g * keys;
        float mx = kNegInf;
        for (int j = lane; j < n_keys; j += 32) mx = fmaxf(mx, sr[j]);
        mx = warp_max(mx);
        float l = 0.f;
        for (int j = lane; j < n_keys; j += 32) {
          const float p = expf(sr[j] - mx);
          sr[j] = p;
          l += p;
        }
        l = warp_sum(l);
        if (lane == 0) {
          m_s[g] = mx;
          l_s[g] = l;
        }
      }
      __syncthreads();
    }

    // acc += p . v over page t: one thread per (head, 16-byte column chunk)
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int item = tid + it * kThreads;
      if (item >= groups * kChunks) break;
      const int g = item / kChunks, c = item - g * kChunks;
      const float* pr = s_s + g * keys + t * bs;
      const unsigned char* vc = tile + c * 16;
      for (int j = 0; j < nv; ++j) {
        const float p = pr[j];
        float vv[kVec];
        unpack(*reinterpret_cast<const uint4*>(vc + j * L.row_bytes), vv);
#pragma unroll
        for (int u = 0; u < kVec; ++u) acc[it][u] += p * vv[u];
      }
    }
  }

#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int item = tid + it * kThreads;
    if (item >= groups * kChunks) break;
    const int g = item / kChunks, c = item - g * kChunks;
    if (splits == 1) {
      const float l = l_s[g];
      float* o = out + (row0 + g) * HD + c * kVec;
#pragma unroll
      for (int u = 0; u < kVec; u += 4) {
        *reinterpret_cast<float4*>(o + u) = make_float4(
            acc[it][u] / l, acc[it][u + 1] / l, acc[it][u + 2] / l, acc[it][u + 3] / l);
      }
    } else {
      float* o = part + g * (HD + 2) + c * kVec;
#pragma unroll
      for (int u = 0; u < kVec; ++u) o[u] = acc[it][u];
    }
  }
  if (splits > 1) {
    for (int g = tid; g < groups; g += kThreads) {
      part[g * (HD + 2) + HD] = m_s[g];
      part[g * (HD + 2) + HD + 1] = l_s[g];
    }
  }
}

// grid B * H, kCombineWarps warps: the splits of one (lane, head) that hold
// a live key (the first ceil(live columns / cols)).  Warp w folds a
// contiguous range of them in order (online max, so its loads do not wait
// on one another), then the warps' partials are folded in warp order: a
// fixed order, the same on every call.
constexpr int kCombineWarps = 8;

__global__ void __launch_bounds__(kCombineWarps * 32)
    paged_attention_combine_kernel(const float* __restrict__ ws,
                                   const int32_t* __restrict__ lens, float* __restrict__ out,
                                   int rows, int heads, int hd, int n_tab, int bs, int cols) {
  constexpr int kPerLane = kMaxHd / 32;
  __shared__ float m_w[kCombineWarps], l_w[kCombineWarps];
  __shared__ float o_w[kCombineWarps][kMaxHd];
  const int r = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_live = min(n_tab, (max(lens[r / heads], 0) + bs - 1) / bs);
  const int live = (n_live + cols - 1) / cols;
  const int per = (live + kCombineWarps - 1) / kCombineWarps;
  const int s1 = min(live, (warp + 1) * per);
  const size_t stride = static_cast<size_t>(rows) * (hd + 2);
  const float* w = ws + static_cast<size_t>(r) * (hd + 2);
  float m = kNegInf, l = 0.f, o[kPerLane] = {};
  for (int s = warp * per; s < s1; ++s) {
    const float* ps = w + s * stride;
    const float mn = fmaxf(m, ps[hd]);
    const float a = expf(m - mn), c = expf(ps[hd] - mn);
    l = l * a + ps[hd + 1] * c;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      if (lane + 32 * k < hd) o[k] = o[k] * a + ps[lane + 32 * k] * c;
    }
    m = mn;
  }
  if (lane == 0) {
    m_w[warp] = m;
    l_w[warp] = l;
  }
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    if (lane + 32 * k < hd) o_w[warp][lane + 32 * k] = o[k];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < hd; d += kCombineWarps * 32) {
    float mx = kNegInf;
    for (int v = 0; v < kCombineWarps; ++v) {
      if (l_w[v] > 0.f) mx = fmaxf(mx, m_w[v]);
    }
    float lt = 0.f, ot = 0.f;
    for (int v = 0; v < kCombineWarps; ++v) {
      if (l_w[v] > 0.f) {  // a warp with no split folded nothing
        const float a = expf(m_w[v] - mx);
        lt += l_w[v] * a;
        ot += o_w[v][d] * a;
      }
    }
    out[static_cast<size_t>(r) * hd + d] = lt > 0.f ? ot / lt : 0.f;
  }
}

int ring_stages(int tile_bytes) {
  return std::max(2, std::min(kMaxStages, kRingBytes / tile_bytes));
}

template <typename T, int HD, int MAXG>
void launch_attention_typed(const void* q, const void* k_pool, const void* v_pool,
                            const int32_t* tables, const int32_t* lens, float* out, float* ws,
                            int batch, int n_tab, int block_size, int kv_heads, int groups,
                            int cols, cudaStream_t stream) {
  const int elt = static_cast<int>(sizeof(T));
  const int stages = ring_stages(block_size * (HD * elt + 16));
  const SplitSmem L = split_smem(groups, HD, elt, block_size, cols, stages);
  TORCH_CHECK_VALUE(L.total <= kMaxSmem, "paged_attention: block_size ", block_size, " with ",
                    cols, " columns per split needs ", L.total,
                    " bytes of shared memory, more than ", kMaxSmem);
  const int splits = paged_attention_splits(n_tab, cols);
  if (L.total > 48 * 1024) {
    sm90::allow_smem<paged_attention_split_kernel<T, HD, MAXG>>(kMaxSmem);
  }
  const dim3 grid(batch, kv_heads, splits);
  paged_attention_split_kernel<T, HD, MAXG><<<grid, kThreads, L.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      tables, lens, out, ws, n_tab, block_size, kv_heads, groups, cols, stages,
      1.0f / sqrtf(static_cast<float>(HD)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  if (splits > 1) {
    paged_attention_combine_kernel<<<batch * kv_heads * groups, kCombineWarps * 32, 0, stream>>>(
        ws, lens, out, batch * kv_heads * groups, kv_heads * groups, HD, n_tab, block_size,
        cols);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
  }
}

// the instance for the group bound: <= 32, else <= kMaxGroups
template <typename T, int HD>
void launch_attention_groups(const void* q, const void* k_pool, const void* v_pool,
                             const int32_t* tables, const int32_t* lens, float* out, float* ws,
                             int batch, int n_tab, int block_size, int kv_heads, int groups,
                             int cols, cudaStream_t stream) {
  if (groups <= 32) {
    launch_attention_typed<T, HD, 32>(q, k_pool, v_pool, tables, lens, out, ws, batch, n_tab,
                                      block_size, kv_heads, groups, cols, stream);
  } else {
    launch_attention_typed<T, HD, kMaxGroups>(q, k_pool, v_pool, tables, lens, out, ws, batch,
                                              n_tab, block_size, kv_heads, groups, cols,
                                              stream);
  }
}

template <typename T>
void launch_attention_hd(const void* q, const void* k_pool, const void* v_pool,
                         const int32_t* tables, const int32_t* lens, float* out, float* ws,
                         int batch, int n_tab, int block_size, int kv_heads, int groups,
                         int head_dim, int cols, cudaStream_t stream) {
  TORCH_CHECK_VALUE(groups >= 1 && groups <= kMaxGroups, "paged_attention: ", groups,
                    " q heads per kv head, more than ", kMaxGroups);
  switch (head_dim) {
    case 32:
      return launch_attention_groups<T, 32>(q, k_pool, v_pool, tables, lens, out, ws, batch,
                                            n_tab, block_size, kv_heads, groups, cols, stream);
    case 64:
      return launch_attention_groups<T, 64>(q, k_pool, v_pool, tables, lens, out, ws, batch,
                                            n_tab, block_size, kv_heads, groups, cols, stream);
    case 128:
      return launch_attention_groups<T, 128>(q, k_pool, v_pool, tables, lens, out, ws, batch,
                                             n_tab, block_size, kv_heads, groups, cols,
                                             stream);
    case 256:
      return launch_attention_groups<T, 256>(q, k_pool, v_pool, tables, lens, out, ws, batch,
                                             n_tab, block_size, kv_heads, groups, cols,
                                             stream);
    default:
      TORCH_CHECK_VALUE(false, "paged_attention: head_dim not in (32, 64, 128, 256)");
  }
}

// one thread per element, cast into the pool's dtype
template <typename Tin, typename Tout>
__global__ void paged_decode_write_kernel(Tout* __restrict__ k_pool, Tout* __restrict__ v_pool,
                                          const Tin* __restrict__ new_k,
                                          const Tin* __restrict__ new_v,
                                          const int32_t* __restrict__ block_ids,
                                          const int32_t* __restrict__ offsets, int total,
                                          int block_size, int row) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int b = idx / row;
  const size_t dst =
      (static_cast<size_t>(block_ids[b]) * block_size + offsets[b]) * row + (idx - b * row);
  k_pool[dst] = from_f32<Tout>(to_f32(new_k[idx]));
  v_pool[dst] = from_f32<Tout>(to_f32(new_v[idx]));
}

constexpr int kWriteThreads = 128;

template <typename Tin, typename Tout>
void launch_write(void* k_pool, void* v_pool, const void* new_k, const void* new_v,
                  const int32_t* block_ids, const int32_t* offsets, int batch, int block_size,
                  int row, cudaStream_t stream) {
  const int total = batch * row;
  paged_decode_write_kernel<Tin, Tout>
      <<<(total + kWriteThreads - 1) / kWriteThreads, kWriteThreads, 0, stream>>>(
          static_cast<Tout*>(k_pool), static_cast<Tout*>(v_pool),
          static_cast<const Tin*>(new_k), static_cast<const Tin*>(new_v), block_ids, offsets,
          total, block_size, row);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

void launch_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                            const int32_t* tables, const int32_t* lens, float* out, float* ws,
                            int batch, int n_tab, int block_size, int kv_heads, int groups,
                            int head_dim, int cols, bool bf16, cudaStream_t stream) {
  if (bf16) {
    launch_attention_hd<__nv_bfloat16>(q, k_pool, v_pool, tables, lens, out, ws, batch, n_tab,
                                       block_size, kv_heads, groups, head_dim, cols, stream);
  } else {
    launch_attention_hd<float>(q, k_pool, v_pool, tables, lens, out, ws, batch, n_tab,
                               block_size, kv_heads, groups, head_dim, cols, stream);
  }
}

void launch_paged_decode_write(void* k_pool, void* v_pool, const void* new_k,
                               const void* new_v, const int32_t* block_ids,
                               const int32_t* offsets, int batch, int block_size, int row,
                               bool in_bf16, bool pool_bf16, cudaStream_t stream) {
  if (in_bf16 && pool_bf16) {
    launch_write<__nv_bfloat16, __nv_bfloat16>(k_pool, v_pool, new_k, new_v, block_ids, offsets,
                                               batch, block_size, row, stream);
  } else if (in_bf16) {
    launch_write<__nv_bfloat16, float>(k_pool, v_pool, new_k, new_v, block_ids, offsets, batch,
                                       block_size, row, stream);
  } else if (pool_bf16) {
    launch_write<float, __nv_bfloat16>(k_pool, v_pool, new_k, new_v, block_ids, offsets, batch,
                                       block_size, row, stream);
  } else {
    launch_write<float, float>(k_pool, v_pool, new_k, new_v, block_ids, offsets, batch,
                               block_size, row, stream);
  }
}

}  // namespace repro_torch
