// int8 pieces of the HiFi-GAN MRF kernels (mrf_tc_q8.cu, mrf_ptc.cu, mrf_ct_q8.cu,
// mrf_phase_q8.cu): the int8-static chain step (q8f and q8s) and the
// per-tile amax.
//
// One chain step of a ResBlock1 chain in the int8-static serving form
// (daft_exprt_tpu/ops/vocoder_kernels.py::_fused_mrf_tc_kernel, q8 branch;
// the same arithmetic as _fused_mrf_ptc_kernel's static mode):
//     q   = quantize_lrelu_static(in, inv1)              s8
//     acc = sum_tap q[n + tap*dil] . wq1[tap]            s32 (s8 x s8 dots)
//     q2  = requant_lrelu_s32(acc, b1i, m1)              s8
//     acc2 = sum_tap q2[n + tap] . wq2[tap]              s32
//     out = in + fma(acc2, sw2, b2)                      f32
// is one launch of `step_q8_kernel<C, K, false>`. The q8s form (the TPU
// kernels' round-3 boundary, _fused_mrf_ct_kernel / _fused_mrf_phase_kernel
// q8s branches: the boundary in float32, not s32) is `step_q8_kernel<C, K, true>`:
//     q   = clip(rint(lrelu(in) * inv1))                 s8 (lrelu rounded first)
//     a1  = fma(acc, sw1, b1)                            f32
//     q2  = clip(rint(lrelu(a1) * inv2))                 s8
//     out = in + fma(acc2, sw2, b2)                      f32
// Each launch is shaped like mrf_common.cuh's
// step_kernel: a block owns BM output samples of one utterance (or tile
// segment), stages the quantised conv1 input window as s8 in shared memory,
// runs conv1 with mma.sync m16n8k32 s8 (s32 accumulate), requantises into a
// second s8 tile and runs conv2 the same way; the float32 residual stream
// lives in device memory. Roundings follow the JAX order: rintf (ties to
// even), saturation at +-127, the dequant epilogue as one __fmaf_rn (how
// the JAX kernels compile it on the CPU), every other f32 operation an
// explicit _rn intrinsic so nvcc contracts nothing.
#pragma once

#include "mrf_common.cuh"

namespace mrf {

// LDA padding of s8 tiles (bytes): rows 16 bytes apart mod 128 keep the
// fragment loads of a warp on 32 distinct banks.
constexpr int kPadS8 = 16;

__device__ __forceinline__ int8_t sat_s8(float r) {
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.f), 127.f)));
}

// quantize_lrelu_static: m = x >= 0 ? inv : 0.1*inv; clip(rint(x*m))
__device__ __forceinline__ int8_t q_lrelu(float x, float inv) {
  const float m = x >= 0.f ? inv : __fmul_rn(kSlope, inv);
  return sat_s8(rintf(__fmul_rn(x, m)));
}

// q8s (quantize_static(lrelu(x), inv)): l = x >= 0 ? x : 0.1*x; clip(rint(l*inv))
__device__ __forceinline__ int8_t q_static(float x, float inv) {
  const float l = x >= 0.f ? x : __fmul_rn(kSlope, x);
  return sat_s8(rintf(__fmul_rn(l, inv)));
}

// requant_lrelu_s32: a = acc + b; m = a >= 0 ? mult : 0.1*mult; clip(rint(a*m))
__device__ __forceinline__ int8_t requant(int acc, int b, float mult) {
  const int a = acc + b;
  const float m = a >= 0 ? mult : __fmul_rn(kSlope, mult);
  return sat_s8(rintf(__fmul_rn(__int2float_rn(a), m)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out[m][n] = sum_tap sum_ci A[(m + tap*dil)*lda + ci] * W(tap, ci, n), s8
// operands, s32 sums, for m in [0, M) (M a multiple of 32), n in [0, COUT);
// epi(m, n, acc) per element. W is packed as uint2 words at
// ((tap*COUT/8 + nt)*CIN/32 + kt)*32 + lane holding the m16n8k32 B
// fragment (vocoder_kernels.pack_mma_s8): .x = W[32kt + 4t + e][8nt + g],
// .y = W[32kt + 16 + 4t + e][8nt + g], e < 4, for lane = 4g + t.
template <int CIN, int COUT, class Epi>
__device__ __forceinline__ void conv_gemm_s8(const int8_t* A, int lda, int M, int dil, int ntaps,
                                             const void* wptr, Epi&& epi) {
  static_assert(CIN % 32 == 0 && COUT % 8 == 0, "tile shape");
  constexpr int NT8 = COUT / 8;
  constexpr int NG = NT8 < 4 ? NT8 : 4;
  static_assert(NT8 % NG == 0, "n-group");
  constexpr int NGROUPS = NT8 / NG;
  constexpr int KT = CIN / 32;
  const uint2* W = static_cast<const uint2*>(wptr);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int units = (M >> 5) * NGROUPS;
  for (int u = warp; u < units; u += kThreads / 32) {
    const int m0 = (u / NGROUPS) * 32;
    const int nt0 = (u % NGROUPS) * NG;
    int acc[2][NG][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NG; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
    for (int tap = 0; tap < ntaps; ++tap) {
      const int8_t* a_base = A + (m0 + tap * dil + g) * lda + 4 * t;
      const uint2* w_base = W + ((size_t)tap * NT8 + nt0) * KT * 32 + lane;
#pragma unroll 4
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int8_t* p = a_base + mi * 16 * lda + kt * 32;
          a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
          a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * lda);
          a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
          a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * lda + 16);
        }
#pragma unroll
        for (int ni = 0; ni < NG; ++ni) {
#ifdef MRF_ABL_NOW
          const uint2 bw = make_uint2(lane + ni, kt);
#else
          const uint2 bw = __ldg(w_base + ((size_t)ni * KT + kt) * 32);
#endif
#ifndef MRF_ABL_NOMMA
          mma_s8(acc[0][ni], a[0], bw.x, bw.y);
          mma_s8(acc[1][ni], a[1], bw.x, bw.y);
#else
          acc[0][ni][0] += (int)(bw.x ^ a[0][0]);
#endif
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NG; ++ni) {
        const int r = m0 + mi * 16 + g;
        const int c = (nt0 + ni) * 8 + 2 * t;
        epi(r, c, acc[mi][ni][0]);
        epi(r, c + 1, acc[mi][ni][1]);
        epi(r + 8, c, acc[mi][ni][2]);
        epi(r + 8, c + 1, acc[mi][ni][3]);
      }
  }
}

// ---------------------------------------------------------------------------
// int8-static chain step

struct Q8Params {
  StepParams s;      // ranges, buffers, modes; s.w1 / s.w2 the packed s8 taps
  const float* inv1; // (C,) conv1 input multiplier
  const int* b1i;    // (C,) q8f: conv1 bias in s32 accumulator counts
  const float* m1;   // (C,) q8f: conv1 dequant x conv2 input multiplier
  const float* sw1;  // (C,) q8s: conv1 dequant
  const float* b1;   // (C,) q8s: conv1 bias
  const float* inv2; // (C,) q8s: conv2 input multiplier
  const float* sw2;  // (C,) conv2 dequant
  int in_f32;        // the step input is float32 (else bf16)
};

template <int C> __host__ __device__ constexpr int block_m_q8() {
  return C >= 128 ? 64 : (C == 64 ? 128 : 256);
}

template <int C, int K>
__host__ __device__ inline void step_q8_geometry(int dil, int& m1, int& rows1) {
  m1 = round_up(block_m_q8<C>() + (K - 1), 32);
  rows1 = m1 + (K - 1) * dil;
}

template <int C, int K>
inline size_t step_q8_smem(int dil) {
  int m1, rows1;
  step_q8_geometry<C, K>(dil, m1, rows1);
  return (size_t)(rows1 + m1) * (C + kPadS8);
}

__device__ __forceinline__ float load_in(const void* in, int f32, long long i) {
  return f32 ? static_cast<const float*>(in)[i]
             : __bfloat162float(static_cast<const bf16*>(in)[i]);
}

template <int C, int K, bool S>
__global__ void __launch_bounds__(kThreads) step_q8_kernel(const Q8Params q) {
  constexpr int H = (K - 1) / 2;
  constexpr int BM = block_m_q8<C>();
  constexpr int LDA = C + kPadS8;
  const StepParams& p = q.s;
  int m1, rows1;
  step_q8_geometry<C, K>(p.dil, m1, rows1);
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* a1 = reinterpret_cast<int8_t*>(smem);
  int8_t* a2 = a1 + rows1 * LDA;
  const int b = blockIdx.y;
  const int n0 = p.n_lo + blockIdx.x * BM;
  const int esz = q.in_f32 ? 4 : 2;
  const void* in = static_cast<const char*>(p.in) + (long long)b * p.in_bs * esz;

  // conv1 input: samples [n0 - H - dil*H, ...), quantize_lrelu_static
  const int s0 = n0 - H - p.dil * H;
  for (int idx = threadIdx.x; idx < rows1 * C; idx += kThreads) {
    const int i = idx / C, c = idx - i * C;
    const int s = s0 + i;
    float v = 0.f;
    if (s >= p.in_lo && s < p.in_hi) v = load_in(in, q.in_f32, (long long)(s + p.in_off) * C + c);
    a1[i * LDA + c] = S ? q_static(v, q.inv1[c]) : q_lrelu(v, q.inv1[c]);
  }
  __syncthreads();

  // conv1 (dilated) over samples [n0 - H, n0 + BM + H): requant to s8, in
  // s32 (q8f) or through the float32 dequant (q8s)
  conv_gemm_s8<C, C>(a1, LDA, m1, p.dil, K, p.w1, [&](int m, int n, int acc) {
    a2[m * LDA + n] = S ? q_static(__fmaf_rn(__int2float_rn(acc), q.sw1[n], q.b1[n]), q.inv2[n])
                        : requant(acc, q.b1i[n], q.m1[n]);
  });
  __syncthreads();

  // conv2 over the block's BM samples: dequant + bias, + residual, the mode
  float* out = p.out + b * p.out_bs;
  conv_gemm_s8<C, C>(a2, LDA, BM, 1, K, p.w2, [&](int m, int n, int acc) {
    const int s = n0 + m;
    if (s >= p.n_hi) return;
    const float res = (s >= p.in_lo && s < p.in_hi)
                          ? load_in(in, q.in_f32, (long long)(s + p.in_off) * C + n) : 0.f;
    const float v = __fadd_rn(res, __fmaf_rn(__int2float_rn(acc), q.sw2[n], p.b2[n]));
    float* o = out + (long long)(s + p.out_off) * C + n;
    if (p.mode == kWrite) {
      *o = v;
    } else if (p.mode == kAdd) {
      *o = __fadd_rn(*o, v);
    } else {
      const float tot = p.has_acc ? __fadd_rn(*o, v) : v;
      static_cast<bf16*>(p.fin)[b * p.fin_bs + (long long)s * p.fin_ns + (long long)n * p.fin_cs] =
          __float2bfloat16_rn(__fmul_rn(tot, p.scale));
    }
  });
}

template <int C, int K, bool S>
cudaError_t launch_step_q8_t(const Q8Params& q, int B, cudaStream_t stream) {
  constexpr int BM = block_m_q8<C>();
  const size_t smem = step_q8_smem<C, K>(q.s.dil);
  const void* kern = reinterpret_cast<const void*>(&step_q8_kernel<C, K, S>);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int n = q.s.n_hi - q.s.n_lo;
  if (n <= 0) return cudaSuccess;
  dim3 grid((n + BM - 1) / BM, B);
  Q8Params arg = q;
  void* args[] = {&arg};
  e = cudaLaunchKernel(kern, grid, dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int C, bool S = false>
cudaError_t launch_step_q8_c(const Q8Params& q, int K, int B, cudaStream_t s) {
  switch (K) {
    case 3: return launch_step_q8_t<C, 3, S>(q, B, s);
    case 7: return launch_step_q8_t<C, 7, S>(q, B, s);
    case 11: return launch_step_q8_t<C, 11, S>(q, B, s);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// the per-tile amax of the int8 upsample prologue (mrf_ptc.cu, mrf_phase_q8.cu)

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

// The C entry point of both libraries' q8 step launchers; the argument
// order is the one vocoder_kernels._launch_q8_step passes. The final
// output (kFinal) is bfloat16.
#define MRF_Q8_STEP_ARGS                                                                     \
  const void *in, long long in_bs, int in_off, int in_lo, int in_hi, int in_f32, void *out,  \
      long long out_bs, int out_off, void *fin, long long fin_bs, long long fin_ns,          \
      long long fin_cs, int mode, int has_acc, float scale, const void *wq1,                 \
      const void *inv1, const void *b1i, const void *m1, const void *wq2, const void *sw2,   \
      const void *b2, int C, int K, int dil, int n_lo, int n_hi, int B, void *stream
#define MRF_Q8_PARAMS(q)                                                                     \
  mrf::Q8Params q = {};                                                                      \
  q.s = mrf::make_step_params(in, in_bs, in_off, in_lo, in_hi, out, out_bs, out_off, fin,    \
                              fin_bs, fin_ns, fin_cs, mode, has_acc, scale, wq1, nullptr,    \
                              wq2, b2, dil, n_lo, n_hi);                                     \
  q.inv1 = static_cast<const float*>(inv1);                                                  \
  q.b1i = static_cast<const int*>(b1i);                                                      \
  q.m1 = static_cast<const float*>(m1);                                                      \
  q.sw2 = static_cast<const float*>(sw2);                                                    \
  q.in_f32 = in_f32

// The q8s step launchers' C entry point (mrf_ct_q8.cu, mrf_phase_q8.cu): the
// weights per conv in the JAX packing order [wq, sw, inv, b]; the argument
// order is the one vocoder_kernels._launch_q8_step passes for q8s steps.
#define MRF_Q8S_STEP_ARGS                                                                    \
  const void *in, long long in_bs, int in_off, int in_lo, int in_hi, int in_f32, void *out,  \
      long long out_bs, int out_off, void *fin, long long fin_bs, long long fin_ns,          \
      long long fin_cs, int mode, int has_acc, float scale, const void *wq1,                 \
      const void *sw1, const void *inv1, const void *b1, const void *wq2, const void *sw2,   \
      const void *inv2, const void *b2, int C, int K, int dil, int n_lo, int n_hi, int B,    \
      void *stream
#define MRF_Q8S_PARAMS(q)                                                                    \
  mrf::Q8Params q = {};                                                                      \
  q.s = mrf::make_step_params(in, in_bs, in_off, in_lo, in_hi, out, out_bs, out_off, fin,    \
                              fin_bs, fin_ns, fin_cs, mode, has_acc, scale, wq1, nullptr,    \
                              wq2, b2, dil, n_lo, n_hi);                                     \
  q.inv1 = static_cast<const float*>(inv1);                                                  \
  q.sw1 = static_cast<const float*>(sw1);                                                    \
  q.b1 = static_cast<const float*>(b1);                                                      \
  q.inv2 = static_cast<const float*>(inv2);                                                  \
  q.sw2 = static_cast<const float*>(sw2);                                                    \
  q.in_f32 = in_f32
