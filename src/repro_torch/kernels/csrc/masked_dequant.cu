// Hopper (sm_90a) kernel of the licensed int8 views: fused dequant + mask.
//
// masked_dequant replaces the Pallas TPU kernel
// src/repro/kernels/masked_dequant.py::masked_dequant: w = codes * scale in
// f32 (the scale per column, per row or one scalar), zeroed wherever
// lo[i] <= |w| < hi[i] for any of the 8 interval slots (lo >= hi is an inert
// slot), then cast to bf16 or f32.  The TPU kernel tiled one (R, C) slice
// into 256 x 256 blocks, and its caller looped over the unit axis of a
// stacked (U, R, C) leaf.  Here one launch takes the whole leaf: codes
// (U, R, C), a scale of (U | 1, 1, C), (U | 1, R, 1) or (U | 1, 1, 1), one
// (U, R, C) output.
//
// What bounds it: bytes.  Per element it reads 1 byte and writes 2 (bf16)
// or 4 (f32); a view of qwen2.5-3b moves 8.3 GB for a handful of operations
// per element.  So the design is about keeping the card's memory busy and
// the instruction count per element low enough never to get in the way:
//
// * Each warp owns one 512-column strip of the rows and walks down a
//   contiguous range of rows.  A thread holds 16 columns of the strip, as
//   16 / sizeof(out) columns per vector, its vectors 32 vectors apart: every
//   store instruction of a warp writes 512 contiguous bytes (a 16-byte store
//   per thread) and every load reads 256 (bf16 out) or 128 (f32 out)
//   contiguous bytes of codes, so no sector is touched twice.  Codes are
//   loaded and outputs stored with the streaming hints (ld/st.global.cs): a
//   leaf passes through the 50 MB L2 once and is never read again here.
// * Per-column scales are loaded once per (unit, strip) into 16 registers
//   and kept across the unit's rows; a per-row or scalar scale is one
//   broadcast load per row.
// * kUnroll rows' codes are loaded before any of them is converted, so each
//   warp has kUnroll x 256 (or 128) bytes of loads in flight; the grid is
//   sized by the occupancy API to one wave of resident warps (strips x row
//   ranges), and each warp then covers a contiguous row range.
//
// On an H100 a stacked (36, 2048, 11008) leaf streams at about the rate of
// a plain bf16 copy of its output's shape (PERF.md).  Development builds
// with 2 or 8 rows ahead, 128 or 512 threads a block, plain instead of
// streaming accesses, or four row ranges per warp slot ran the leaf no
// faster.
// * The live interval slots are compacted into shared memory once per
//   block, so the free tier tests one interval per element and the full
//   tier none; a matching weight is zeroed at once (a later slot can only
//   zero it again).
// * int8 -> f32 without the conversion unit (a quarter-rate instruction):
//   each code byte, biased to unsigned, is placed in the low mantissa byte
//   of 2^23 with one byte permute and the bias subtracted in f32, exact for
//   every integer in [-128, 127].  The product is __fmul_rn and the casts
//   are __floats2bfloat162_rn (round to nearest even), so the result is bit
//   for bit the plain version's (ref.masked_dequant): where() writes +0.0,
//   as here.
//
// Rows that are not whole vectors (C not a multiple of 16 / sizeof(out)) or
// codes whose base is not aligned to a vector go through a one-element-per-
// thread kernel over the whole tensor instead: the same arithmetic, any
// shape.  Offsets are int64 throughout: a stacked leaf may exceed 2^31
// elements.

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <c10/cuda/CUDAException.h>

namespace repro_torch {

namespace {

constexpr int kIntervals = 8;
constexpr int kThreads = 256;
constexpr int kColsPerThread = 16;
constexpr int kStripCols = 32 * kColsPerThread;  // columns of one warp's strip
constexpr int kUnroll = 4;                        // rows loaded ahead per warp

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

// the live slots (lo < hi) of the 8, compacted into shared memory
struct LiveIntervals {
  float lo[kIntervals];
  float hi[kIntervals];
  int n;
};

__device__ __forceinline__ void compact_intervals(const float* __restrict__ lo,
                                                  const float* __restrict__ hi,
                                                  LiveIntervals& live) {
  if (threadIdx.x < 32) {
    const int i = threadIdx.x;
    const float l = i < kIntervals ? lo[i] : 0.0f;
    const float h = i < kIntervals ? hi[i] : 0.0f;
    const bool keep = i < kIntervals && l < h;  // NaN bounds never match either
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int at = __popc(mask & ((1u << i) - 1u));
      live.lo[at] = l;
      live.hi[at] = h;
    }
    if (i == 0) live.n = __popc(mask);
  }
  __syncthreads();
}

// zero every w[j] inside a live interval, in f32
template <int N>
__device__ __forceinline__ void mask_intervals(float (&w)[N], const LiveIntervals& live,
                                               int n_live) {
  for (int i = 0; i < n_live; ++i) {
    const float l = live.lo[i], h = live.hi[i];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float mag = fabsf(w[j]);
      w[j] = (mag >= l && mag < h) ? 0.0f : w[j];
    }
  }
}

// byte k of a word of biased codes (code + 128) as the exact f32 code
__device__ __forceinline__ float code_f32(uint32_t biased, int k) {
  const uint32_t bits = __byte_perm(biased, 0x4B000000u, 0x7540u + k);  // 2^23 + byte
  return __fsub_rn(__uint_as_float(bits), 8388736.0f);                 // - (2^23 + 128)
}

template <typename Out>
struct VecTraits;

// bf16 out: 8 columns per vector (8 B of codes in, 16 B out), 2 vectors
template <>
struct VecTraits<__nv_bfloat16> {
  static constexpr int kVec = 8;
  using Codes = uint2;
  __device__ static void words(const Codes& c, uint32_t (&w)[2]) {
    w[0] = c.x;
    w[1] = c.y;
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint4 packed;
    uint32_t* q = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 two = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      q[k] = *reinterpret_cast<const uint32_t*>(&two);
    }
    __stcs(reinterpret_cast<uint4*>(p), packed);
  }
};

// f32 out: 4 columns per vector (4 B of codes in, 16 B out), 4 vectors
template <>
struct VecTraits<float> {
  static constexpr int kVec = 4;
  using Codes = uint32_t;
  __device__ static void words(const Codes& c, uint32_t (&w)[1]) { w[0] = c; }
  __device__ static void store(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

// rows [0, rows) of R-row units, C columns; scale index u * su + r * sr + c
// (kPerColumn) or u * su + r * sr (per row: sr 1; scalar: sr 0)
template <typename Out, bool kPerColumn>
__global__ void __launch_bounds__(kThreads)
    masked_dequant_vec(const int8_t* __restrict__ codes, const float* __restrict__ scale,
                       const float* __restrict__ lo, const float* __restrict__ hi,
                       Out* __restrict__ out, int64_t rows, int64_t unit_rows, int64_t cols,
                       int64_t su, int64_t sr, int strips, int64_t rows_per_warp) {
  using T = VecTraits<Out>;
  constexpr int kVec = T::kVec;
  constexpr int kNv = kColsPerThread / kVec;  // vectors per thread per row
  constexpr int kWords = kVec / 4;            // 32-bit words of codes per vector
  __shared__ LiveIntervals live;
  compact_intervals(lo, hi, live);
  const int n_live = live.n;

  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int strip = static_cast<int>(warp % strips);
  const int64_t row0 = (warp / strips) * rows_per_warp;
  const int64_t row1 = imin(rows, row0 + rows_per_warp);
  int64_t col[kNv];
  bool in[kNv];
#pragma unroll
  for (int v = 0; v < kNv; ++v) {
    col[v] = static_cast<int64_t>(strip) * kStripCols + (v * 32 + lane) * kVec;
    in[v] = col[v] < cols;  // cols is a multiple of kVec: a vector is all in or all out
  }

  for (int64_t r = row0; r < row1;) {
    const int64_t u = r / unit_rows;
    const int64_t unit_end = imin(row1, (u + 1) * unit_rows);
    float s_col[kNv][kVec];
    if constexpr (kPerColumn) {
#pragma unroll
      for (int v = 0; v < kNv; ++v) {
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          s_col[v][k] = in[v] ? __ldg(scale + u * su + col[v] + k) : 0.0f;
        }
      }
    }
    while (r < unit_end) {
      const int n_rows = static_cast<int>(imin(kUnroll, unit_end - r));
      typename T::Codes raw[kUnroll][kNv] = {};
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
#pragma unroll
        for (int v = 0; v < kNv; ++v) {
          if (i < n_rows && in[v]) {
            raw[i][v] = __ldcs(reinterpret_cast<const typename T::Codes*>(
                codes + (r + i) * cols + col[v]));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        if (i >= n_rows) break;
        const float s_row = kPerColumn ? 0.0f : __ldg(scale + u * su + (r + i - u * unit_rows) * sr);
        float w[kNv * kVec];
#pragma unroll
        for (int v = 0; v < kNv; ++v) {
          uint32_t word[kWords];
          T::words(raw[i][v], word);
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            const float c = code_f32(word[k / 4] ^ 0x80808080u, k % 4);
            w[v * kVec + k] = __fmul_rn(c, kPerColumn ? s_col[v][k] : s_row);
          }
        }
        mask_intervals(w, live, n_live);
#pragma unroll
        for (int v = 0; v < kNv; ++v) {
          if (in[v]) {
            float part[kVec];
#pragma unroll
            for (int k = 0; k < kVec; ++k) part[k] = w[v * kVec + k];
            T::store(out + (r + i) * cols + col[v], part);
          }
        }
      }
      r += n_rows;
    }
  }
}

__device__ __forceinline__ void store_one(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// any shape and alignment: one element per thread, grid-stride
template <typename Out>
__global__ void __launch_bounds__(kThreads)
    masked_dequant_scalar(const int8_t* __restrict__ codes, const float* __restrict__ scale,
                          const float* __restrict__ lo, const float* __restrict__ hi,
                          Out* __restrict__ out, int64_t n, int64_t unit_rows, int64_t cols,
                          int64_t su, int64_t sr, int64_t sc) {
  __shared__ LiveIntervals live;
  compact_intervals(lo, hi, live);
  const int n_live = live.n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int64_t row = i / cols, c = i - row * cols;
    const int64_t u = row / unit_rows, r = row - u * unit_rows;
    float w[1] = {__fmul_rn(static_cast<float>(codes[i]), scale[u * su + r * sr + c * sc])};
    mask_intervals(w, live, n_live);
    store_one(out + i, w[0]);
  }
}

// Blocks of `kernel` resident on the current device at once (occupancy x
// SMs), queried once per (kernel, device): a launch then reads a cache.
int resident_blocks(const void* kernel) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> cache;
  int device = 0;
  C10_CUDA_CHECK(cudaGetDevice(&device));
  const std::lock_guard<std::mutex> lock(mu);
  int& blocks = cache[{kernel, device}];
  if (blocks == 0) {
    int per_sm = 0, sms = 0;
    C10_CUDA_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0));
    C10_CUDA_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
    blocks = std::max(per_sm, 1) * sms;
  }
  return blocks;
}

template <typename Out, bool kPerColumn>
void launch_vec(const int8_t* codes, const float* scale, const float* lo, const float* hi,
                Out* out, int64_t rows, int64_t unit_rows, int64_t cols, int64_t su,
                int64_t sr, cudaStream_t stream) {
  auto kernel = masked_dequant_vec<Out, kPerColumn>;
  const int64_t strips = (cols + kStripCols - 1) / kStripCols;
  const int64_t resident = resident_blocks(reinterpret_cast<const void*>(kernel));
  const int64_t warps = resident * (kThreads / 32);
  const int64_t ranges = std::max<int64_t>(1, std::min(rows, warps / strips));
  const int64_t rows_per_warp = (rows + ranges - 1) / ranges;
  const int64_t used = (rows + rows_per_warp - 1) / rows_per_warp;
  const int64_t blocks = (strips * used * 32 + kThreads - 1) / kThreads;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      codes, scale, lo, hi, out, rows, unit_rows, cols, su, sr, static_cast<int>(strips),
      rows_per_warp);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

template <typename Out>
void launch_typed(const int8_t* codes, const float* scale, const float* lo, const float* hi,
                  void* out_ptr, int64_t units, int64_t unit_rows, int64_t cols, int64_t su,
                  int64_t sr, int64_t sc, cudaStream_t stream) {
  Out* out = static_cast<Out*>(out_ptr);
  const int64_t rows = units * unit_rows;
  constexpr int kVec = VecTraits<Out>::kVec;
  const bool vec = cols % kVec == 0 && reinterpret_cast<uintptr_t>(codes) % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec && sc == 1) {
    launch_vec<Out, true>(codes, scale, lo, hi, out, rows, unit_rows, cols, su, sr, stream);
  } else if (vec && sc == 0) {
    launch_vec<Out, false>(codes, scale, lo, hi, out, rows, unit_rows, cols, su, sr, stream);
  } else {
    const int64_t n = rows * cols;
    const int64_t want = (n + kThreads - 1) / kThreads;
    const int64_t cap = static_cast<int64_t>(resident_blocks(
        reinterpret_cast<const void*>(masked_dequant_scalar<Out>))) * 8;
    masked_dequant_scalar<Out><<<static_cast<unsigned>(std::min(want, cap)), kThreads, 0,
                                 stream>>>(codes, scale, lo, hi, out, n, unit_rows, cols, su,
                                           sr, sc);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
  }
}

}  // namespace

void launch_masked_dequant(const int8_t* codes, const float* scale, const float* lo,
                           const float* hi, void* out, int64_t units, int64_t unit_rows,
                           int64_t cols, int64_t su, int64_t sr, int64_t sc, bool out_bf16,
                           cudaStream_t stream) {
  if (units * unit_rows * cols == 0) return;
  if (out_bf16) {
    launch_typed<__nv_bfloat16>(codes, scale, lo, hi, out, units, unit_rows, cols, su, sr, sc,
                                stream);
  } else {
    launch_typed<float>(codes, scale, lo, hi, out, units, unit_rows, cols, su, sr, sc, stream);
  }
}

}  // namespace repro_torch
