// Tensor-core helpers shared by flash_attention.cu and quant_matmul.cu:
// bf16 packing, the hi/lo split that carries an f32 value as two bf16
// terms, and the warp-level mma.sync / ldmatrix instructions (sm_80+).
//
// Fragment layout of mma.sync.m16n8k16 (bf16 in, f32 accumulate), with
// g = lane / 4 and t = lane % 4 (PTX ISA, "Matrix fragments for mma.m16n8k16"):
//   A (16 x 16, row-major), 4 regs of 2 bf16:  a0 (g, 2t..2t+1)   a1 (g+8, 2t..)
//                                              a2 (g, 2t+8..)     a3 (g+8, 2t+8..)
//   B (16 x 8, k x n), 2 regs of 2 bf16:       b0 (k 2t..2t+1, n g)  b1 (k 2t+8.., n g)
//   C/D (16 x 8 f32), 4 regs:                  c0,c1 (g, 2t..2t+1)  c2,c3 (g+8, 2t..)
// The lower 16 bits of a register hold the element of lower index.
#pragma once

#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>

namespace repro_torch {
namespace mma {

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// (a, b) rounded to bf16, a in the low half
__device__ __forceinline__ uint32_t pack(float a, float b) {
  return bits(__floats2bfloat162_rn(a, b));
}

// a ~ hi + lo with hi = bf16(a) and lo = bf16(a - hi): bf16 keeps 8
// significant bits, so the pair keeps 16 of f32's 24 (|a - hi - lo| <=
// 2^-16 |a|)
__device__ __forceinline__ void split(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack(a - hf.x, b - hf.y);
}

// a = hi + mid + lo exactly (three bf16 terms hold all 24 bits of an f32
// significand; values below bf16's normal range aside)
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const float ra = a - hf.x, rb = b - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = pack(ra - mf.x, rb - mf.y);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16) * b (16x8), bf16 operands, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, transposed: lane l names row
// (l % 8) of matrix l / 8 (16 contiguous bytes); register i of lane 4g + t
// then holds elements (2t, g) and (2t + 1, g) of matrix i — a B fragment
// when the matrix rows run along k.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

}  // namespace mma
}  // namespace repro_torch
