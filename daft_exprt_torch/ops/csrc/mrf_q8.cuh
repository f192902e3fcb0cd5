// The per-tile amax of the int8 MRF kernels (mrf_ptc.cu, mrf_phase_q8.cu,
// mrf_ct_q8.cu): the scale of an upsample's input or, at a level without
// upsample, of the dynamic engine's first conv, per tile segment.
#pragma once

#include "mrf_common.cuh"

namespace mrf {

constexpr int kAmaxRows = 64;

// max over a block's values of |lrelu(v)| -> atomicMax on the float bits of
// *word (non-negative floats order as their bits; the word starts at 0).
// Every thread of the block calls it.
__device__ __forceinline__ void block_amax(float m, unsigned* word) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float part[kThreads / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, part[w]);
    atomicMax(word, __float_as_uint(m));
  }
}

__device__ __forceinline__ float abs_lrelu(float v) {
  return fabsf(v >= 0.f ? v : __fmul_rn(kSlope, v));
}

// amax_bits[seg] = max of |lrelu(x)| over the tile's input window
// [t*tile_in - halo_in, ... + win_len) samples, zero outside the utterance.
__global__ void __launch_bounds__(kThreads)
    amax_kernel(const bf16* x, long long x_bs, int t_in, int C, int n_tiles, int tile_in,
                int halo_in, int win_len, unsigned* amax_bits) {
  const int seg = blockIdx.y;
  const int b = seg / n_tiles, t = seg - b * n_tiles;
  const int r0 = blockIdx.x * kAmaxRows;
  const int s0 = t * tile_in - halo_in + r0;  // input sample of row r0
  const int rows = min(kAmaxRows, win_len - r0);
  const bf16* xb = x + b * x_bs;
  float m = 0.f;
  for (int idx = threadIdx.x; idx < rows * C; idx += kThreads) {
    const int i = idx / C, c = idx - i * C;
    const int s = s0 + i;
    if (s < 0 || s >= t_in) continue;
    m = fmaxf(m, abs_lrelu(__bfloat162float(xb[(long long)s * C + c])));
  }
  block_amax(m, amax_bits + seg);
}

inline cudaError_t launch_amax(const void* x, long long x_bs, int t_in, int C, int n_tiles,
                               int tile_in, int halo_in, int win_len, void* amax_bits, int S,
                               cudaStream_t stream) {
  const dim3 grid((win_len + kAmaxRows - 1) / kAmaxRows, S);
  const bf16* xp = static_cast<const bf16*>(x);
  unsigned* ap = static_cast<unsigned*>(amax_bits);
  void* args[] = {&xp, &x_bs, &t_in, &C, &n_tiles, &tile_in, &halo_in, &win_len, &ap};
  cudaError_t e = cudaLaunchKernel(reinterpret_cast<const void*>(&amax_kernel), grid,
                                   dim3(kThreads), args, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace mrf
