// Hopper (sm_90a) kernel of the weight-update path: the sparse delta scatter.
//
// delta_apply replaces the Pallas TPU kernel
// src/repro/kernels/delta_apply.py::delta_apply (and delta_apply_inplace,
// the same pallas_call with the buffer aliased): buf[indices] = values on a
// flat parameter buffer, indices unique, out-of-range indices dropped.  The
// TPU has no scatter unit, so the Pallas kernel tiles the buffer and
// compares the whole index list against every tile's lanes: O(tiles x n)
// work.  Hopper scatters directly, so none of that is carried over: one
// thread per delta entry, in a grid-stride loop, reads its index and value
// and stores one element.  Indices are unique by the store's contract, so
// no two threads write one element and no atomics are needed.
//
// Index arithmetic is int64 throughout: indices arrive as int64 from the
// wire, and a stacked layer of the full model has 811,597,824 elements.
// Anything outside [0, size) is dropped, so the JAX contract's padding
// (index == size) is inert and a negative index never writes out of bounds.
// Values are cast to the buffer's dtype here, with __float2bfloat16_rn for a
// bf16 buffer: bit-identical to values.to(buf.dtype) followed by the plain
// scatter.
//
// What bounds it: bytes.  Each entry reads its index (4 or 8 B) and value
// (2 or 4 B) once and writes one element; there is no arithmetic to speak
// of.  The store hands deltas over in ascending index order (a full pull is
// every nonzero of the layer), so neighbouring threads write neighbouring
// addresses and the stores coalesce.  The out-of-place form is a clone made
// by the wrapper (the TPU kernel's pass-through of untouched entries, a
// plain byte copy) followed by this scatter into the copy.

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

}  // namespace repro_torch
