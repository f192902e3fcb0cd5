// float32-accurate products on the tensor cores (3xTF32), shared by the
// float32 attention kernels (attention_common.cuh) and the float32 MRF chain
// kernel (mrf_chain_f32.cuh).
//
// A product a.b is split as a_hi.b_lo + a_lo.b_hi + a_hi.b_hi with x_hi =
// tf32(x) and x_lo = tf32(x - x_hi) (cvt.rna's rounding), three mma.sync
// m16n8k8 TF32 products into one float32 accumulator, small terms first
// (CUTLASS's OpMultiplyAddFastF32). The dropped a_lo.b_lo and the rounding of
// x_lo leave each product within about 2^-22 of its float32 value.
//
// mma.sync m16n8k8 TF32 fragments (g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major) a0: (g, t) a1: (g+8, t) a2: (g, t+4) a3: (g+8, t+4);
//   B (8 x 8)             b0: (k t, n g) b1: (k t+4, n g);
//   C (16 x 8, float32)   c0, c1: (g, 2t..2t+1) c2, c3: (g+8, 2t..2t+1).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// cvt.rna.tf32.f32 (nearest, ties away from zero) of a finite x in two
// integer operations: ptxas expands the cvt with an infinity test and a
// select, four operations a value (inf stays inf here too)
__device__ __forceinline__ uint32_t to_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// x ~ hi + lo, both TF32 (the low 13 bits zero)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

struct FragA {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ void mma1688(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in 3xTF32, b already split (b_hi = (h0, h1), b_lo = (l0, l1))
__device__ __forceinline__ void mma3_split(float (&c)[4], const FragA& a, uint32_t h0, uint32_t h1,
                                           uint32_t l0, uint32_t l1) {
  mma1688(c, a.hi, l0, l1);
  mma1688(c, a.lo, h0, h1);
  mma1688(c, a.hi, h0, h1);
}

}  // namespace tf32x3
