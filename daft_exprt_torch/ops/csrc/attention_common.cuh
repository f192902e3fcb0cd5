// Shared pieces of the attention kernels (attention_fwd.cu, attention_bwd.cu):
// the dropout mask, the tensor-core pieces of the bf16
// kernels (cp.async tile loads, ldmatrix, mma.sync m16n8k16 and the dropout
// bits in the accumulator fragments' layout) and those of the float32 ones
// (3xTF32 on mma.sync m16n8k8).
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace attn {

using bf16 = __nv_bfloat16;

// Dropout bits: Philox-4x32-10 with key (seed, b*H + h) and counter
// (i, j / 4, 0, 0); key j of query row i takes word j % 4. The mask is a pure
// function of (seed, b, h, i, j), whatever the launch geometry, so the
// backward regenerates the forward's mask exactly.
// attention_kernels.py::dropout_bits computes the same bits with int64 tensors.
__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c1, uint32_t k0, uint32_t k1) {
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

// Dropout on the normalised weights: keep where bits >= thr, kept values
// scaled (as the TPU kernel's p * keep_scale in float32); thr == 0 is off.
// The kernels draw the bits with keep_bits below.
struct Dropout {
  uint32_t seed, bh, thr;
  float scale;
  __device__ __forceinline__ bool on() const { return thr != 0u; }
};

__device__ __forceinline__ Dropout make_dropout(const long long* seed, int bh, unsigned thr, float scale) {
  Dropout d;
  d.seed = thr ? (uint32_t)(unsigned long long)seed[0] : 0u;
  d.bh = (uint32_t)bh;
  d.thr = thr;
  d.scale = scale;
  return d;
}

// ---- the bf16 tensor-core kernels ------------------------------------------
// A block of kTcThreads = 4 warps owns kTile = 64 query rows (or keys) of one
// (b, h), 16 per warp. Tiles of 64 rows x 64 dims stream through shared
// memory in bf16 with cp.async, double-buffered; a row is padded to kLds
// elements (144 bytes) so that the 8 rows an ldmatrix phase reads start on
// distinct 4-bank groups (no bank conflicts).
//
// mma.sync m16n8k16 fragments (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major) a0: (g, 2t..2t+1) a1: (g+8, 2t..) a2: (g, 2t+8..) a3: (g+8, 2t+8..);
//   B (16 x 8)             b0: (k 2t..2t+1, n g) b1: (k 2t+8.., n g);
//   C (16 x 8, float32)    c0, c1: (g, 2t..2t+1) c2, c3: (g+8, 2t..2t+1).
// The C fragments of two neighbouring n-tiles are, packed to bf16, the A
// fragment of the next product over those 16 columns (P.V, dS.K, ...).

constexpr int kTile = 64;              // rows or keys per staged tile
constexpr int kHead = 64;              // head width D
constexpr int kLds = kHead + 8;        // padded shared-memory row (elements)
constexpr int kTileElems = kTile * kLds;
constexpr int kTcThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16, lo in the low half: two neighbouring columns
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [r0, r0 + 64) of a (T, 64) bf16 matrix into a padded tile, as cp.async
// copies of 16 bytes (8 per row); rows at or past T are zero-filled.
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int r0, int T_len) {
#pragma unroll
  for (int c = 0; c < kTile * 8 / kTcThreads; ++c) {
    const int idx = (int)threadIdx.x + c * kTcThreads;
    const int r = idx >> 3, ch = idx & 7;
    const bool in = r0 + r < T_len;
    cp_async16(s + r * kLds + ch * 8, g + (size_t)(in ? r0 + r : 0) * kHead + ch * 8, in ? 16 : 0);
  }
}

// The A fragments of 16 rows x 64 dims of a tile (rows r0.. of the tile).
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* s, int r0, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[kk], s + (r0 + (lane & 15)) * kLds + kk * 16 + (lane >> 4) * 8);
}

// acc[n][*] = A (16 x 64, fragments a) times rows 8n.. of tile s, transposed:
// the scores of 16 rows against NT * 8 tile rows (keys, or query rows).
template <int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const uint32_t (&a)[4][4], const bf16* s, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, s + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kLds + kk * 16 + ((lane >> 3) & 1) * 8);
      mma16816(acc[2 * np], a[kk], b[0], b[1]);
      mma16816(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc (16 x 64) += A (16 x 16 KK, fragments a) times tile rows r0 .. r0 + 16 KK
// (all 64 dims): P.V, dS.K, pd^T.dO, ds^T.Q. The tile is read transposed.
template <int KK>
__device__ __forceinline__ void mma_ab(float (&acc)[8][4], const uint32_t (&a)[KK][4], const bf16* s, int r0,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, s + (r0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLds + dp * 16 + (lane >> 4) * 8);
      mma16816(acc[2 * dp], a[kk], b[0], b[1]);
      mma16816(acc[2 * dp + 1], a[kk], b[2], b[3]);
    }
  }
}

// Keep bits of one Philox call: bit e for key 4 * grp + e of query row i.
__device__ __forceinline__ uint32_t keep_bits(const Dropout& d, int i, int grp) {
  const uint4 w = philox((uint32_t)i, (uint32_t)grp, d.seed, d.bh);
  return (uint32_t)(w.x >= d.thr) | (uint32_t)(w.y >= d.thr) << 1 | (uint32_t)(w.z >= d.thr) << 2 |
         (uint32_t)(w.w >= d.thr) << 3;
}

// Keep bits of a C fragment whose rows are query rows (i_g: row g of the
// fragment) and whose 8 columns are keys j8 .. j8 + 7 (j8 % 8 == 0): bit c
// for element c. Lanes 2u and 2u + 1 hold the same 4-key group for rows g
// and g + 8: each draws one of the two rows (row_draw) and they swap the
// bits (deal_rows).
__device__ __forceinline__ uint32_t row_draw(const Dropout& d, int i_g, int j8, int lane) {
  return keep_bits(d, i_g + 8 * (lane & 1), (j8 >> 2) + ((lane & 3) >> 1));
}
__device__ __forceinline__ uint32_t deal_rows(uint32_t mine, int lane) {
  const int odd = lane & 1;
  const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
  const uint32_t lo = odd ? other : mine;     // row g
  const uint32_t hi = odd ? mine : other;     // row g + 8
  const int sh = 2 * odd;                     // word of key j8 + 2t
  return (lo >> sh & 3u) | (hi >> sh & 3u) << 2;
}

// The same for a transposed C fragment: rows are keys k16 + g and k16 + g + 8
// (k16 % 16 == 0), the 8 columns query rows i8 .. i8 + 7. The fragment holds
// 4 key groups x 8 rows: lane (g, t) brings the bits of row i8 + 2t + (g & 1),
// group k16 / 4 + g / 2 (`mine`), and four shuffles deal each lane its own.
__device__ __forceinline__ uint32_t deal_cols(uint32_t mine, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t out = 0u;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int grp = (g >> 2) + 2 * (c >> 1);  // key g (c < 2) or g + 8
    const uint32_t bits = __shfl_sync(0xffffffffu, mine, 4 * (2 * grp + (c & 1)) + t);
    out |= (bits >> (g & 3) & 1u) << c;
  }
  return out;
}

// ---- the float32 tensor-core kernels (3xTF32) --------------------------------
// The bf16 kernels' blocks, tiles and passes, in float32. Every product is
// split as a.b ~ a_hi.b_lo + a_lo.b_hi + a_hi.b_hi with x_hi = tf32(x) and
// x_lo = tf32(x - x_hi) (cvt.rna's rounding), three mma.sync m16n8k8 TF32
// products into one float32 accumulator, small terms first (CUTLASS's
// OpMultiplyAddFastF32).
// The dropped a_lo.b_lo and the rounding of x_lo leave each product within
// about 2^-22 of its float32 value: the float32 band (1e-5 rel-L2) holds,
// where one TF32 product (a_hi.b_hi) leaves it by some 40x
// (tests/test_torch_attention_tf32x3.py models both).
//
// Tiles of 64 rows x 64 float32 stream through shared memory by cp.async, a
// row padded to kLdsF = 68 floats: both fragment reads below are plain 32-bit
// LDS and free of bank conflicts (row stride 4 banks: 4g + t, and 8 banks per
// two rows: 8t + g). Every operand, the blocks' own rows too, is read from
// shared memory and split where it is read: split halves are never held.
//
// The tensor cores add each product into the float32 accumulator with
// truncation, so an error that grows with the length of an accumulator's
// chain of mma: a sum over keys or query rows (p.v, ds.k, pd^T.do, ds^T.q)
// takes each 64-row tile in a fresh accumulator (24 mma) and adds it to the
// running sum with one float32 add (one chain of 3T/8 mma left the 1e-5
// band at T = 2048 on an H100).
//
// mma.sync m16n8k8 TF32 fragments (g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major) a0: (g, t) a1: (g+8, t) a2: (g, t+4) a3: (g+8, t+4);
//   B (8 x 8)             b0: (k t, n g) b1: (k t+4, n g);
//   C (16 x 8, float32)   c0, c1: (g, 2t..2t+1) c2, c3: (g+8, 2t..2t+1).
// A C fragment is the A fragment of the next product over its 8 columns with
// k permuted: k = t is column 2t and k = t + 4 column 2t + 1, so a = (c0, c2,
// c1, c3) and the B fragment of that product reads rows 2t and 2t + 1
// (mma_ab_f32); the sum over k does not care about the order.

constexpr int kLdsF = kHead + 4;       // padded shared-memory row (floats)
constexpr int kTileF = kTile * kLdsF;  // floats per staged tile

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

// c += a.b in 3xTF32, b = (b0, b1) split here
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  mma1688(c, a.hi, l0, l1);
  mma1688(c, a.lo, h0, h1);
  mma1688(c, a.hi, h0, h1);
}

// Rows [r0, r0 + 64) of a (T, 64) float32 matrix into a padded tile, as
// cp.async copies of 16 bytes (16 per row); rows at or past T are zero-filled.
__device__ __forceinline__ void load_tile_f32(float* s, const float* g, int r0, int T_len) {
#pragma unroll
  for (int c = 0; c < kTile * 16 / kTcThreads; ++c) {
    const int idx = (int)threadIdx.x + c * kTcThreads;
    const int r = idx >> 4, ch = idx & 15;
    const bool in = r0 + r < T_len;
    cp_async16(s + r * kLdsF + ch * 4, g + (size_t)(in ? r0 + r : 0) * kHead + ch * 4, in ? 16 : 0);
  }
}

// acc[n][*] = A (16 rows x 64 dims: rows 0..15 of tile sa) times rows 8n.. of
// tile s, transposed (k over the 64 dims): the scores of 16 rows against
// NT * 8 tile rows. A is read and split per 8 dims (not held in registers);
// the 8 steps unrolled by U (a kernel's registers decide: measured per kernel).
template <int NT, int U>
__device__ __forceinline__ void mma_abt_f32(float (&acc)[NT][4], const float* sa, const float* s, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float* pa = sa + (lane >> 2) * kLdsF + (lane & 3);
  const float* pb = s + (lane >> 2) * kLdsF + (lane & 3);
#pragma unroll U
  for (int kk = 0; kk < 8; ++kk) {
    const FragA fa = split_a(pa[8 * kk], pa[8 * kLdsF + 8 * kk], pa[8 * kk + 4], pa[8 * kLdsF + 8 * kk + 4]);
#pragma unroll
    for (int n = 0; n < NT; ++n) mma3(acc[n], fa, pb[8 * n * kLdsF + 8 * kk], pb[8 * n * kLdsF + 8 * kk + 4]);
  }
}

// The A fragment of 8 columns of a C fragment (values c = (g, 2t), (g, 2t+1),
// (g+8, 2t), (g+8, 2t+1)), k permuted as above.
__device__ __forceinline__ FragA c_to_a(const float (&c)[4]) { return split_a(c[0], c[2], c[1], c[3]); }

// acc (16 x 64) += A (16 x 8, from c_to_a) times tile rows r0 .. r0 + 7, all
// 64 dims: one 8-row step of P.V, dS.K, pd^T.dO, ds^T.Q.
__device__ __forceinline__ void mma_ab_f32(float (&acc)[8][4], const FragA& a, const float* s, int r0, int lane) {
  const float* p = s + (r0 + 2 * (lane & 3)) * kLdsF + (lane >> 2);
#pragma unroll
  for (int dn = 0; dn < 8; ++dn) mma3(acc[dn], a, p[8 * dn], p[kLdsF + 8 * dn]);
}

}  // namespace attn
