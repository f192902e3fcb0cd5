// Shared pieces of the attention kernels (attention_fwd.cu, attention_bwd.cu):
// type conversions, warp reductions and the dropout mask.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace attn {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }
// x rounded to T and back: where the TPU kernel casts to the input dtype
template <typename T> __device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

__device__ __forceinline__ uint32_t word(const uint4& w, int u) {
  return u == 0 ? w.x : u == 1 ? w.y : u == 2 ? w.z : w.w;
}

// Dropout on the normalised weights: keep where bits >= thr, kept values
// scaled (as the TPU kernel's p * keep_scale in float32); thr == 0 is off.
struct Dropout {
  uint32_t seed, bh, thr;
  float scale;
  __device__ __forceinline__ bool on() const { return thr != 0u; }
  // the words of keys 4 * (j / 4) .. 4 * (j / 4) + 3 of row i
  __device__ __forceinline__ uint4 bits(int i, int j) const {
    return philox((uint32_t)i, (uint32_t)(j >> 2), seed, bh);
  }
  __device__ __forceinline__ float apply(const uint4& w, int j, float x) const {
    return word(w, j & 3) >= thr ? x * scale : 0.f;
  }
};

__device__ __forceinline__ Dropout make_dropout(const long long* seed, int bh, unsigned thr, float scale) {
  Dropout d;
  d.seed = thr ? (uint32_t)(unsigned long long)seed[0] : 0u;
  d.bh = (uint32_t)bh;
  d.thr = thr;
  d.scale = scale;
  return d;
}

}  // namespace attn
