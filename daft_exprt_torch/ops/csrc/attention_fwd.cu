// Masked self-attention forward for the FFT blocks, for Hopper.
//
// Replaces daft_exprt_tpu/ops/attention_kernels.py::fused_attention forward
// (Pallas body _fwd_kernel). For each (b, h) and query row:
//   s = q . k^T (q pre-scaled by D^-1/2), float32;
//   s[key >= lengths[b]] = -1e9;
//   p = exp(s - max s) / sum exp(s - max s), float32;
//   with dropout (thr > 0): p = keep ? p * scale : 0, the mask from
//   attention_common.cuh's Philox bits (the backward regenerates it);
//   p rounded to v's type; o = p . v with float32 accumulation, in q's type.
//
// Bound on the card: per (b, h) the work is 4*T^2*D FLOPs (q.k and p.v)
// against 4*T*D elements moved (q, k, v in, o out): at D = 64 in bf16 that
// is T/2 FLOPs per byte, so T = 128 is bound by bytes and T = 1024 by
// operations, on the tensor cores.
//
// bf16 (attn_fwd_tc_kernel): a block of 4 warps owns 64 query rows of one
// (b, h), 16 per warp, with their q fragments in registers. K and V stream
// through shared memory in bf16 tiles of 64 keys (cp.async, double-buffered,
// padded rows for conflict-free ldmatrix); every product is an mma.sync
// m16n8k16 with float32 accumulators. No (rows, T) logit tile is kept, so T
// has no limit. Two passes over the keys keep the TPU kernel's rounding
// point, p normalised in float32 before dropout and the cast:
//   1. s = q.k^T; each row's running max and sum of exponentials in
//      registers (the sum rescaled when the max grows);
//   2. s again; p = exp(s - max) / sum in float32, the Philox mask, p
//      rounded to bf16 in the accumulators' registers, which are the A
//      fragments of p.v; o accumulates in float32 registers.
// The second pass recomputes q.k^T: 1.5x the minimum products, for one
// rounding of p. The mask costs one Philox call per lane per 8 keys and
// row pair: lanes 2u and 2u + 1 share a 4-key group, draw a row each and
// swap the bits.
//
// float32 (attn_fwd_f32_kernel): the same block, tiles and two passes in
// float32, on the tensor cores in 3xTF32 (attention_common.cuh): each product
// is three mma.sync m16n8k8 TF32 products of the operands' split halves, which
// keeps it within the float32 band where one TF32 product would leave it. K
// and V tiles of 64 keys x 64 float32 (68-float rows: conflict-free 32-bit
// LDS) stream through shared memory, double-buffered, beside the block's q
// tile (87 KB, 2 blocks per SM); every operand is split where it is read. p
// stays in the accumulators' registers, which with the keys permuted within
// each 8-key step are the A fragments of p.v; each key tile's p.v is summed in
// its own accumulator and added to o once. Bound at (16, 2, 1024, 64):
// the 2 products at a third of the TF32 rate, 0.052 ms; the kernel issues 3
// (the second pass recomputes q.k^T), 9 TF32 products in all.
#include "attention_common.cuh"

namespace attn {

// grid: (ceil(T / 64), B * H); q, k, v, o: (B, H, T, 64) bf16 contiguous
__global__ void __launch_bounds__(kTcThreads) attn_fwd_tc_kernel(const bf16* __restrict__ q,
                                                                 const bf16* __restrict__ k,
                                                                 const bf16* __restrict__ v,
                                                                 const int* __restrict__ lengths,
                                                                 const long long* __restrict__ seed,
                                                                 bf16* __restrict__ o, int H, int T_len,
                                                                 unsigned thr, float scale) {
  __shared__ __align__(16) bf16 s_q[kTileElems];
  __shared__ __align__(16) bf16 s_k[2][kTileElems];
  __shared__ __align__(16) bf16 s_v[2][kTileElems];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int len = lengths[bh / H];
  const int i0 = blockIdx.x * kTile;
  const int rg = i0 + 16 * warp + (lane >> 2);   // this thread's rows rg and rg + 8
  const size_t base = (size_t)bh * T_len * kHead;
  const Dropout drop = make_dropout(seed, bh, thr, scale);
  const int nt = (T_len + kTile - 1) / kTile;
  const int valid = min(len, T_len);            // keys below: no mask

  load_tile(s_q, q + base, i0, T_len);
  load_tile(s_k[0], k + base, 0, T_len);
  cp_commit();

  uint32_t qf[4][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, mL[2], inv_l[2];
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // stages 0 .. nt-1: pass 1 (K tiles); nt .. 2nt-1: pass 2 (K and V tiles)
  for (int st = 0; st < 2 * nt; ++st) {
    const bool pass2 = st >= nt;
    const int j0 = (pass2 ? st - nt : st) * kTile;
    if (st + 1 < 2 * nt) {
      const int nj = (st + 1 < nt ? st + 1 : st + 1 - nt) * kTile;
      load_tile(s_k[(st + 1) & 1], k + base, nj, T_len);
      if (st + 1 >= nt) load_tile(s_v[(st + 1) & 1], v + base, nj, T_len);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (st == 0) load_a(qf, s_q, 16 * warp, lane);
    if (st == nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        mL[h] = m[h] * kLog2e;
        inv_l[h] = 1.f / l[h];
      }
    }
    float s[8][4];
    mma_abt<8>(s, qf, s_k[st & 1], lane);
    if (j0 + kTile > valid) {                    // keys past len (-1e9) or T (dropped)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + 8 * n + 2 * t + (c & 1);
          s[n][c] = j >= T_len ? -INFINITY : j >= len ? -1e9f : s[n][c];
        }
    }
    if (!pass2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[h], mx);
        const float mnL = mn * kLog2e;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          sum += exp2f(fmaf(s[n][2 * h], kLog2e, -mnL)) + exp2f(fmaf(s[n][2 * h + 1], kLog2e, -mnL));
        l[h] = l[h] * exp2f((m[h] - mn) * kLog2e) + sum;
        m[h] = mn;
      }
    } else {
      uint32_t pa[4][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint32_t keep = drop.on() ? deal_rows(row_draw(drop, rg, j0 + 8 * n, lane), lane) : 0xFu;
        float p[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          p[c] = exp2f(fmaf(s[n][c], kLog2e, -mL[c >> 1])) * inv_l[c >> 1];
          if (drop.on()) p[c] = (keep >> c & 1u) ? p[c] * drop.scale : 0.f;
        }
        pa[n >> 1][2 * (n & 1)] = pack_bf16(p[0], p[1]);
        pa[n >> 1][2 * (n & 1) + 1] = pack_bf16(p[2], p[3]);
      }
      mma_ab<4>(acc, pa, s_v[st & 1], 0, lane);
    }
    __syncthreads();
  }

  bf16* out = o + base;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int d = 8 * n + 2 * t;
    if (rg < T_len)
      *reinterpret_cast<uint32_t*>(out + (size_t)rg * kHead + d) = pack_bf16(acc[n][0], acc[n][1]);
    if (rg + 8 < T_len)
      *reinterpret_cast<uint32_t*>(out + (size_t)(rg + 8) * kHead + d) = pack_bf16(acc[n][2], acc[n][3]);
  }
}

cudaError_t launch_tc(const void* q, const void* k, const void* v, const int* lengths, const long long* seed,
                      void* o, int B, int H, int T_len, unsigned thr, float scale, cudaStream_t stream) {
  dim3 grid((T_len + kTile - 1) / kTile, B * H);
  void* args[] = {&q, &k, &v, &lengths, &seed, &o, &H, &T_len, &thr, &scale};
  cudaError_t e = cudaLaunchKernel(reinterpret_cast<const void*>(&attn_fwd_tc_kernel), grid, dim3(kTcThreads),
                                   args, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// grid: (ceil(T / 64), B * H); q, k, v, o: (B, H, T, 64) float32 contiguous;
// kFwdF32Smem bytes of dynamic shared memory: the q tile, two K and two V tiles
constexpr int kFwdF32Smem = 5 * kTileF * (int)sizeof(float);

__global__ void __launch_bounds__(kTcThreads, 2) attn_fwd_f32_kernel(const float* __restrict__ q,
                                                                     const float* __restrict__ k,
                                                                     const float* __restrict__ v,
                                                                     const int* __restrict__ lengths,
                                                                     const long long* __restrict__ seed,
                                                                     float* __restrict__ o, int H, int T_len,
                                                                     unsigned thr, float scale) {
  extern __shared__ __align__(16) float smf[];
  const float* const s_q = smf + 16 * (threadIdx.x >> 5) * kLdsF;   // this warp's 16 rows
  float* const s_k = smf + kTileF;                                   // buffer b at s_k + b * kTileF
  float* const s_v = smf + 3 * kTileF;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int len = lengths[bh / H];
  const int i0 = blockIdx.x * kTile;
  const int rg = i0 + 16 * warp + (lane >> 2);   // this thread's rows rg and rg + 8
  const size_t base = (size_t)bh * T_len * kHead;
  const Dropout drop = make_dropout(seed, bh, thr, scale);
  const int nt = (T_len + kTile - 1) / kTile;
  const int valid = min(len, T_len);            // keys below: no mask

  load_tile_f32(smf, q + base, i0, T_len);
  load_tile_f32(s_k, k + base, 0, T_len);
  cp_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, mL[2], inv_l[2];
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // stages 0 .. nt-1: pass 1 (K tiles); nt .. 2nt-1: pass 2 (K and V tiles)
  for (int st = 0; st < 2 * nt; ++st) {
    const bool pass2 = st >= nt;
    const int j0 = (pass2 ? st - nt : st) * kTile;
    const int nb = ((st + 1) & 1) * kTileF;
    if (st + 1 < 2 * nt) {
      const int nj = (st + 1 < nt ? st + 1 : st + 1 - nt) * kTile;
      load_tile_f32(s_k + nb, k + base, nj, T_len);
      if (st + 1 >= nt) load_tile_f32(s_v + nb, v + base, nj, T_len);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (st == nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        mL[h] = m[h] * kLog2e;
        inv_l[h] = 1.f / l[h];
      }
    }
    const int cb = (st & 1) * kTileF;
    float s[8][4];
    mma_abt_f32<8, 8>(s, s_q, s_k + cb, lane);
    if (j0 + kTile > valid) {                    // keys past len (-1e9) or T (dropped)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + 8 * n + 2 * t + (c & 1);
          s[n][c] = j >= T_len ? -INFINITY : j >= len ? -1e9f : s[n][c];
        }
    }
    if (!pass2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[h], mx);
        const float mnL = mn * kLog2e;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          sum += exp2f(fmaf(s[n][2 * h], kLog2e, -mnL)) + exp2f(fmaf(s[n][2 * h + 1], kLog2e, -mnL));
        l[h] = l[h] * exp2f((m[h] - mn) * kLog2e) + sum;
        m[h] = mn;
      }
    } else {
      float part[8][4];                          // this tile's p.v (see attention_common.cuh)
#pragma unroll
      for (int n = 0; n < 8; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint32_t keep = drop.on() ? deal_rows(row_draw(drop, rg, j0 + 8 * n, lane), lane) : 0xFu;
        float p[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          p[c] = exp2f(fmaf(s[n][c], kLog2e, -mL[c >> 1])) * inv_l[c >> 1];
          if (drop.on()) p[c] = (keep >> c & 1u) ? p[c] * drop.scale : 0.f;
        }
        mma_ab_f32(part, c_to_a(p), s_v + cb, 8 * n, lane);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n][c] += part[n][c];
    }
    __syncthreads();
  }

  float* out = o + base;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int d = 8 * n + 2 * t;
    if (rg < T_len) *reinterpret_cast<float2*>(out + (size_t)rg * kHead + d) = make_float2(acc[n][0], acc[n][1]);
    if (rg + 8 < T_len)
      *reinterpret_cast<float2*>(out + (size_t)(rg + 8) * kHead + d) = make_float2(acc[n][2], acc[n][3]);
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, const int* lengths, const long long* seed,
                       void* o, int B, int H, int T_len, unsigned thr, float scale, cudaStream_t stream) {
  const void* kern = reinterpret_cast<const void*>(&attn_fwd_f32_kernel);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdF32Smem);
  if (e != cudaSuccess) return e;
  dim3 grid((T_len + kTile - 1) / kTile, B * H);
  void* args[] = {&q, &k, &v, &lengths, &seed, &o, &H, &T_len, &thr, &scale};
  e = cudaLaunchKernel(kern, grid, dim3(kTcThreads), args, kFwdF32Smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace attn

// dtype: 1 = bf16, 0 = float32 (both on the tensor cores, any T). thr: the
// dropout threshold (0: off; seed, an int64 on the card, is then not read). D
// must be 64. Returns cudaGetLastError() after the launch.
extern "C" int attention_fwd(const void* q, const void* k, const void* v, const void* lengths,
                             const void* seed, void* o, int B, int H, int T_len, int D, int dtype,
                             unsigned thr, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const long long* sd = static_cast<const long long*>(seed);
  // D = 64: the FFT blocks' head width (2 heads of a 128-wide model)
  if (D != attn::kHead) return (int)cudaErrorInvalidValue;
  if (dtype == 1) return (int)attn::launch_tc(q, k, v, len, sd, o, B, H, T_len, thr, scale, s);
  return (int)attn::launch_f32(q, k, v, len, sd, o, B, H, T_len, thr, scale, s);
}
