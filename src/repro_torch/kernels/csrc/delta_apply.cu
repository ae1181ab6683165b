// Hopper (sm_90a) kernels of the weight-update path: the sparse delta scatter
// and the staged sync's one apply per step.
//
// delta_apply replaces the Pallas TPU kernel
// src/repro/kernels/delta_apply.py::delta_apply: buf[indices] = values on a
// flat parameter buffer, indices unique, out-of-range indices dropped, into a
// copy of buf.  The TPU has no scatter unit, so the Pallas kernel tiles the
// buffer and compares the whole index list against every tile's lanes:
// O(tiles x n) work.  Hopper scatters directly, so none of that is carried
// over: one thread per delta entry, in a grid-stride loop, reads its index
// and value and stores one element.  Indices are unique by the store's
// contract, so no two threads write one element and no atomics are needed.
//
// delta_apply_parts replaces delta_apply_inplace (the same pallas_call with
// the buffer aliased) together with what the JAX stager does around it in
// src/repro/serving/updates.py::_apply_part: the in-place scatter of each
// rows part and a donated dynamic_update_slice of each chunk page.  On the
// card one launch applies every part of a STAGE step, from one packed
// buffer that the host fills in pinned memory and uploads with one copy
// (kernels/delta_apply.py packs it):
//
//   [Segment table: one 64-byte entry per part or page]
//   [tile -> segment map: int32 per tile, computed on the host]
//   [payload: 16-byte aligned runs of indices, values and page bytes]
//
// A block takes one tile, reads its segment through the map (no search) and
// applies the tile's share of it:
//   * rows: up to kTileRows (index, value) entries, one a thread and four a
//     thread in all; int64 index arithmetic; entries outside [0, size) are
//     dropped (the JAX contract pads with index == size; a negative index
//     never writes); values are cast with __float2bfloat16_rn for a bf16
//     buffer, bit-identical to values.to(buf.dtype) and a plain scatter;
//   * run: kTileBytes of a contiguous run whose bytes are already in the
//     destination dtype (a chunk page), 16-byte vector loads and stores
//     where the source and destination are both 16-byte aligned, a byte
//     loop for the ragged tail (a short last page) and for odd offsets.
// Write order: the segments of one step write disjoint elements.  That is
// the store's contract: delta_since merges versions into one row per flat
// index, and pages are disjoint, fixed-size slices of a layer.  So the
// launch needs no ordering between blocks and no atomics.
//
// The single-part form, delta_apply(..., donate=True), is this kernel with
// one segment passed by value (no table, no upload), its index and value
// "offsets" absolute addresses from a payload base of 0.
//
// What bounds them: bytes.  An entry reads its index (4 or 8 B) and value
// (2 or 4 B) once and writes one element; a run reads and writes each byte
// once.  What the parts kernel takes away is the host's work around the
// scatter: before it, a STAGE step made a pageable copy and a slice copy_
// for every chunk page and two copies and a launch for every rows part.  The
// out-of-place form is a clone made by the wrapper (the TPU kernel's
// pass-through of untouched entries, a plain byte copy) followed by the
// delta_apply scatter into the copy.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <c10/cuda/CUDAException.h>

namespace repro_torch {

namespace {

template <typename T, typename V>
__device__ __forceinline__ T cast_to(V x);
template <>
__device__ __forceinline__ float cast_to<float, float>(float x) { return x; }
template <>
__device__ __forceinline__ float cast_to<float, __nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 cast_to<__nv_bfloat16, float>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 cast_to<__nv_bfloat16, __nv_bfloat16>(
    __nv_bfloat16 x) {
  return x;
}

template <typename T, typename V, typename I>
__global__ void delta_apply_kernel(T* __restrict__ buf, const I* __restrict__ indices,
                                   const V* __restrict__ values, int64_t n,
                                   int64_t size) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t j = static_cast<int64_t>(indices[i]);
    if (j >= 0 && j < size) buf[j] = cast_to<T, V>(values[i]);
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;  // 32 resident-block waves of the 132 SMs

template <typename T, typename V, typename I>
void launch_typed(void* buf, const void* indices, const void* values, int64_t n,
                  int64_t size, cudaStream_t stream) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  delta_apply_kernel<T, V, I><<<blocks, kThreads, 0, stream>>>(
      static_cast<T*>(buf), static_cast<const I*>(indices), static_cast<const V*>(values),
      n, size);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

template <typename T, typename V>
void launch_index(void* buf, const void* indices, const void* values, int64_t n,
                  int64_t size, bool idx64, cudaStream_t stream) {
  if (idx64) {
    launch_typed<T, V, int64_t>(buf, indices, values, n, size, stream);
  } else {
    launch_typed<T, V, int32_t>(buf, indices, values, n, size, stream);
  }
}

// ---------------------------------------------------------------- parts
// One entry of the segment table; kernels/delta_apply.py writes the same
// eight int64 words (SEGMENT_WORDS there).
struct Segment {
  uint64_t dst;        // address of element 0 of the flat destination
  int64_t size;        // destination elements: the rows bound
  int64_t count;       // rows entries, or run elements
  int64_t dst_offset;  // run: the first element written
  int64_t idx_off;     // rows: the indices, from the payload base
  int64_t val_off;     // rows: the values; run: its bytes, from the payload base
  int64_t tile_start;  // the segment's first tile
  int32_t kind;        // kRows or kRun
  int32_t flags;       // kDstBf16 | kValBf16 | kIdx32; a run's element bytes << 8
};
static_assert(sizeof(Segment) == 64, "the host packs 64-byte segments");

constexpr int32_t kRows = 0;
constexpr int32_t kRun = 1;
constexpr int32_t kDstBf16 = 1;
constexpr int32_t kValBf16 = 2;
constexpr int32_t kIdx32 = 4;
constexpr int kRowsPerThread = 4;
constexpr int64_t kTileRows = kThreads * kRowsPerThread;   // 1,024 entries a tile
constexpr int64_t kTileBytes = kThreads * 4 * 16;          // 16 KiB of a run a tile

template <typename T, typename V, typename I>
__device__ __forceinline__ void apply_rows(const Segment& s, int64_t tile,
                                           uint64_t payload) {
  T* dst = reinterpret_cast<T*>(s.dst);
  const I* idx = reinterpret_cast<const I*>(payload + static_cast<uint64_t>(s.idx_off));
  const V* val = reinterpret_cast<const V*>(payload + static_cast<uint64_t>(s.val_off));
  const int64_t first = tile * kTileRows + threadIdx.x;
  // every load before any store: the stores could alias the loads for all
  // the compiler knows, so interleaved they would run one after another
  int64_t j[kRowsPerThread];
  V v[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int64_t i = first + static_cast<int64_t>(k) * kThreads;
    j[k] = -1;
    if (i < s.count) {
      j[k] = static_cast<int64_t>(idx[i]);
      v[k] = val[i];
    }
  }
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    if (j[k] >= 0 && j[k] < s.size) dst[j[k]] = cast_to<T, V>(v[k]);
  }
}

template <typename T, typename V>
__device__ __forceinline__ void rows_index(const Segment& s, int64_t tile, uint64_t payload) {
  if (s.flags & kIdx32) {
    apply_rows<T, V, int32_t>(s, tile, payload);
  } else {
    apply_rows<T, V, int64_t>(s, tile, payload);
  }
}

__device__ __forceinline__ void apply_run(const Segment& s, int64_t tile, uint64_t payload) {
  const int64_t esize = (s.flags >> 8) & 0xff;
  char* dst = reinterpret_cast<char*>(s.dst) + s.dst_offset * esize;
  const char* src = reinterpret_cast<const char*>(payload + static_cast<uint64_t>(s.val_off));
  const int64_t lo = tile * kTileBytes;
  const int64_t end = s.count * esize;
  const int64_t hi = end < lo + kTileBytes ? end : lo + kTileBytes;
  int64_t b = lo;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    // lo is a multiple of 16, so every vector of the tile is aligned; a
    // tile is 4 vectors a thread, all loaded before any is stored
    const int64_t vhi = lo + ((hi - lo) & ~static_cast<int64_t>(15));
    int4 x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t v = lo + 16 * (static_cast<int64_t>(k) * kThreads + threadIdx.x);
      if (v < vhi) x[k] = *reinterpret_cast<const int4*>(src + v);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t v = lo + 16 * (static_cast<int64_t>(k) * kThreads + threadIdx.x);
      if (v < vhi) *reinterpret_cast<int4*>(dst + v) = x[k];
    }
    b = vhi;
  }
  for (int64_t i = b + threadIdx.x; i < hi; i += kThreads) dst[i] = src[i];
}

// One block a tile.  ``table`` null: every tile belongs to ``one`` (the
// single-part form).
__global__ void __launch_bounds__(kThreads)
    delta_apply_parts_kernel(const Segment* __restrict__ table,
                             const int32_t* __restrict__ tile_seg, uint64_t payload,
                             Segment one) {
  const int64_t tile = blockIdx.x;
  const Segment s = table != nullptr ? table[tile_seg[tile]] : one;
  const int64_t t = tile - s.tile_start;
  if (s.kind == kRun) {
    apply_run(s, t, payload);
  } else if (s.flags & kDstBf16) {
    if (s.flags & kValBf16) {
      rows_index<__nv_bfloat16, __nv_bfloat16>(s, t, payload);
    } else {
      rows_index<__nv_bfloat16, float>(s, t, payload);
    }
  } else if (s.flags & kValBf16) {
    rows_index<float, __nv_bfloat16>(s, t, payload);
  } else {
    rows_index<float, float>(s, t, payload);
  }
}

}  // namespace

void launch_delta_apply(void* buf, const void* indices, const void* values, int64_t n,
                        int64_t size, bool buf_bf16, bool val_bf16, bool idx64,
                        cudaStream_t stream) {
  if (n <= 0) return;
  if (buf_bf16 && val_bf16) {
    launch_index<__nv_bfloat16, __nv_bfloat16>(buf, indices, values, n, size, idx64, stream);
  } else if (buf_bf16) {
    launch_index<__nv_bfloat16, float>(buf, indices, values, n, size, idx64, stream);
  } else if (val_bf16) {
    launch_index<float, __nv_bfloat16>(buf, indices, values, n, size, idx64, stream);
  } else {
    launch_index<float, float>(buf, indices, values, n, size, idx64, stream);
  }
}

// the packed step: the table at ``packed``, the map and the payload at
// their offsets from it
void launch_delta_apply_parts(const void* packed, int64_t map_off, int64_t payload_off,
                              int64_t n_tiles, cudaStream_t stream) {
  if (n_tiles <= 0) return;
  const uint64_t base = reinterpret_cast<uint64_t>(packed);
  delta_apply_parts_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, stream>>>(
      static_cast<const Segment*>(packed),
      reinterpret_cast<const int32_t*>(base + static_cast<uint64_t>(map_off)),
      base + static_cast<uint64_t>(payload_off), Segment{});
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// the single-part form: one rows segment by value
void launch_delta_apply_one(void* buf, const void* indices, const void* values, int64_t n,
                            int64_t size, bool buf_bf16, bool val_bf16, bool idx64,
                            cudaStream_t stream) {
  if (n <= 0) return;
  Segment s{};
  s.dst = reinterpret_cast<uint64_t>(buf);
  s.size = size;
  s.count = n;
  s.idx_off = static_cast<int64_t>(reinterpret_cast<uint64_t>(indices));
  s.val_off = static_cast<int64_t>(reinterpret_cast<uint64_t>(values));
  s.kind = kRows;
  s.flags = (buf_bf16 ? kDstBf16 : 0) | (val_bf16 ? kValBf16 : 0) | (idx64 ? 0 : kIdx32);
  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  delta_apply_parts_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      nullptr, nullptr, 0, s);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace repro_torch
