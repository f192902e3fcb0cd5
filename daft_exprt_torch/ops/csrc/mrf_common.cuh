// Shared pieces of the HiFi-GAN MRF kernels (mrf_ct.cu and the engines).
//
// One chain step of a ResBlock1 chain,
//     out[n] = in[n] + conv2_k(lrelu(conv1_{k,d}(lrelu(in))))[n],
// is one launch of `step_kernel`: a block owns BM output samples of one
// utterance, stages the conv1 input window (lrelu'd, in the compute type)
// and the conv1 output window in shared memory, and runs both convs as
// tap-shifted GEMMs over that window. Activations are channel-last
// (sample-major, channels contiguous), so a tap shift is a row offset.
//
// bf16 compute runs the GEMMs on the tensor cores with mma.sync m16n8k16
// (f32 accumulate); the weights come pre-packed in the B-fragment order so
// each warp reads one coalesced 8-byte word per lane per fragment. float32
// compute runs the same GEMMs with FMAs (exact f32, no TF32).
//
// The residual stream between steps is float32 in device memory.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace mrf {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr float kSlope = 0.1f;

__device__ __forceinline__ float lrelu(float x) { return x >= 0.f ? x : kSlope * x; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared-memory row padding (elements) and the GEMM's row granule.
template <typename CT> struct Tile;
template <> struct Tile<bf16> { static constexpr int pad = 8; static constexpr int mround = 32; };
template <> struct Tile<float> { static constexpr int pad = 4; static constexpr int mround = 8; };

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out[m][n] = sum_tap sum_ci A[(m + tap*dil)*lda + ci] * W(tap, ci, n) for
// m in [0, M) (M a multiple of 32), n in [0, COUT); epi(m, n, out) per
// element. W is packed as uint2 words at ((tap*COUT/8 + nt)*CIN/16 + kt)*32
// + lane holding the m16n8k16 B fragment (see vocoder_kernels._pack_mma).
template <int CIN, int COUT, class Epi>
__device__ __forceinline__ void conv_gemm(const bf16* A, int lda, int M, int dil,
                                          int ntaps, const void* wptr, Epi&& epi) {
  static_assert(CIN % 16 == 0 && COUT % 8 == 0, "tile shape");
  constexpr int NT8 = COUT / 8;
  constexpr int NG = NT8 < 4 ? NT8 : 4;
  static_assert(NT8 % NG == 0, "n-group");
  constexpr int NGROUPS = NT8 / NG;
  constexpr int KT = CIN / 16;
  const uint2* W = static_cast<const uint2*>(wptr);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int units = (M >> 5) * NGROUPS;
  for (int u = warp; u < units; u += kThreads / 32) {
    const int m0 = (u / NGROUPS) * 32;
    const int nt0 = (u % NGROUPS) * NG;
    float acc[2][NG][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NG; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    for (int tap = 0; tap < ntaps; ++tap) {
      const bf16* a_base = A + (m0 + tap * dil + g) * lda + 2 * t;
      const uint2* w_base = W + ((size_t)tap * NT8 + nt0) * KT * 32 + lane;
#pragma unroll 4
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const bf16* p = a_base + mi * 16 * lda + kt * 16;
          a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
          a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * lda);
          a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
          a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * lda + 8);
        }
#pragma unroll
        for (int ni = 0; ni < NG; ++ni) {
          const uint2 bw = __ldg(w_base + ((size_t)ni * KT + kt) * 32);
          mma_bf16(acc[0][ni], a[0], bw.x, bw.y);
          mma_bf16(acc[1][ni], a[1], bw.x, bw.y);
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

// float32 twin: W is plain [tap][ci][co]; M a multiple of 8.
template <int CIN, int COUT, class Epi>
__device__ __forceinline__ void conv_gemm(const float* A, int lda, int M, int dil,
                                          int ntaps, const void* wptr, Epi&& epi) {
  static_assert(kThreads % COUT == 0, "COUT must divide the block");
  constexpr int NGRP = kThreads / COUT;
  const float* W = static_cast<const float*>(wptr);
  const int n = threadIdx.x % COUT;
  const int grp = threadIdx.x / COUT;
  for (int m0 = grp * 8; m0 < M; m0 += NGRP * 8) {
    float acc[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r] = 0.f;
    for (int tap = 0; tap < ntaps; ++tap) {
      const float* a = A + (m0 + tap * dil) * lda;
      const float* w = W + (size_t)tap * CIN * COUT + n;
      for (int ci = 0; ci < CIN; ++ci) {
        const float wv = __ldg(w + (size_t)ci * COUT);
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[r] = fmaf(a[r * lda + ci], wv, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) epi(m0 + r, n, acc[r]);
  }
}

// ---------------------------------------------------------------------------
// chain step

enum StepMode { kWrite = 0, kAdd = 1, kFinal = 2 };

struct StepParams {
  // step input: sample n of utterance b at in + b*in_bs + (n + in_off)*C;
  // samples outside [in_lo, in_hi) read as zero
  const void* in;
  long long in_bs;
  int in_off, in_lo, in_hi;
  // float32 residual buffer written (kWrite), accumulated (kAdd) or read as
  // the running chain sum (kFinal)
  float* out;
  long long out_bs;
  int out_off;
  // kFinal: fin[b*fin_bs + n*fin_ns + c*fin_cs] = (sum + step) * scale
  void* fin;
  long long fin_bs, fin_ns, fin_cs;
  int mode, has_acc;
  float scale;
  const void* w1;
  const float* b1;
  const void* w2;
  const float* b2;
  int dil, n_lo, n_hi;
};

template <int C, typename CT> __host__ __device__ constexpr int block_m() {
  return sizeof(CT) == 2 ? (C >= 128 ? 64 : (C == 64 ? 128 : 256)) : (C >= 256 ? 32 : 64);
}

// Channels the GEMMs reduce over: the bf16 mma takes 16 input channels at a
// time, so a C = 8 level stages its activations as 16 channels whose lanes
// 8..15 are zero (its packed weights carry zero rows there); the zero lanes
// add exact zeros to every sum and are never written out.
template <int C, typename CT> __host__ __device__ constexpr int gemm_cin() {
  return (sizeof(CT) == 2 && C < 16) ? 16 : C;
}

template <int C, int K, typename CT>
__host__ __device__ inline void step_geometry(int dil, int& m1, int& rows1) {
  m1 = round_up(block_m<C, CT>() + (K - 1), Tile<CT>::mround);
  rows1 = m1 + (K - 1) * dil;
}

template <int C, int K, typename CT>
inline size_t step_smem(int dil) {
  int m1, rows1;
  step_geometry<C, K, CT>(dil, m1, rows1);
  return (size_t)(rows1 + m1) * (gemm_cin<C, CT>() + Tile<CT>::pad) * sizeof(CT);
}

template <int C, int K, typename CT, typename TIn>
__global__ void __launch_bounds__(kThreads) step_kernel(const StepParams p) {
  constexpr int H = (K - 1) / 2;
  constexpr int BM = block_m<C, CT>();
  constexpr int CP = gemm_cin<C, CT>();
  constexpr int LDA = CP + Tile<CT>::pad;
  int m1, rows1;
  step_geometry<C, K, CT>(p.dil, m1, rows1);
  extern __shared__ __align__(16) unsigned char smem[];
  CT* a1 = reinterpret_cast<CT*>(smem);
  CT* a2 = a1 + rows1 * LDA;
  const int b = blockIdx.y;
  const int n0 = p.n_lo + blockIdx.x * BM;
  const TIn* in = static_cast<const TIn*>(p.in) + b * p.in_bs;

  // conv1 input: samples [n0 - H - dil*H, ...), lrelu then the compute type
  const int s0 = n0 - H - p.dil * H;
  for (int idx = threadIdx.x; idx < rows1 * CP; idx += kThreads) {
    const int i = idx / CP, c = idx - i * CP;
    const int s = s0 + i;
    float v = 0.f;
    if (c < C && s >= p.in_lo && s < p.in_hi) v = to_f32(in[(long long)(s + p.in_off) * C + c]);
    a1[i * LDA + c] = from_f32<CT>(lrelu(v));
  }
  if constexpr (CP > C) {  // conv2's input lanes C..CP-1: zero
    for (int idx = threadIdx.x; idx < m1 * (CP - C); idx += kThreads) {
      const int i = idx / (CP - C);
      a2[i * LDA + C + idx - i * (CP - C)] = from_f32<CT>(0.f);
    }
  }
  __syncthreads();

  // conv1 (dilated) over samples [n0 - H, n0 + BM + H): +bias, lrelu
  const float* b1 = p.b1;
  conv_gemm<CP, C>(a1, LDA, m1, p.dil, K, p.w1, [&](int m, int n, float acc) {
    a2[m * LDA + n] = from_f32<CT>(lrelu(acc + b1[n]));
  });
  __syncthreads();

  // conv2 over the block's BM samples: +bias, + residual, then the mode
  const float* b2 = p.b2;
  float* out = p.out + b * p.out_bs;
  conv_gemm<CP, C>(a2, LDA, BM, 1, K, p.w2, [&](int m, int n, float acc) {
    const int s = n0 + m;
    if (s >= p.n_hi) return;
    const float res = (s >= p.in_lo && s < p.in_hi)
                          ? to_f32(in[(long long)(s + p.in_off) * C + n]) : 0.f;
    const float v = res + (acc + b2[n]);
    float* o = out + (long long)(s + p.out_off) * C + n;
    if (p.mode == kWrite) {
      *o = v;
    } else if (p.mode == kAdd) {
      *o = *o + v;
    } else {
      const float tot = p.has_acc ? *o + v : v;
      static_cast<CT*>(p.fin)[b * p.fin_bs + (long long)s * p.fin_ns + (long long)n * p.fin_cs] =
          from_f32<CT>(tot * p.scale);
    }
  });
}

template <int C, int K, typename CT, typename TIn>
cudaError_t launch_step_t(const StepParams& p, int B, cudaStream_t stream) {
  constexpr int BM = block_m<C, CT>();
  const size_t smem = step_smem<C, K, CT>(p.dil);
  const void* kern = reinterpret_cast<const void*>(&step_kernel<C, K, CT, TIn>);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int n = p.n_hi - p.n_lo;
  if (n <= 0) return cudaSuccess;
  dim3 grid((n + BM - 1) / BM, B);
  StepParams arg = p;
  void* args[] = {&arg};
  e = cudaLaunchKernel(kern, grid, dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// cdt: 1 = bf16 compute, 0 = float32 compute; in_f32: the step input is the
// float32 residual buffer (else the compute type)
template <int C, int K>
cudaError_t launch_step_ck(const StepParams& p, int B, int cdt, int in_f32, cudaStream_t s) {
  if (cdt == 1)
    return in_f32 ? launch_step_t<C, K, bf16, float>(p, B, s) : launch_step_t<C, K, bf16, bf16>(p, B, s);
  return launch_step_t<C, K, float, float>(p, B, s);
}

template <int C>
cudaError_t launch_step_c(const StepParams& p, int K, int B, int cdt, int in_f32, cudaStream_t s) {
  switch (K) {
    case 3: return launch_step_ck<C, 3>(p, B, cdt, in_f32, s);
    case 7: return launch_step_ck<C, 7>(p, B, cdt, in_f32, s);
    case 11: return launch_step_ck<C, 11>(p, B, cdt, in_f32, s);
    default: return cudaErrorInvalidValue;
  }
}

inline StepParams make_step_params(const void* in, long long in_bs, int in_off, int in_lo, int in_hi,
                                   void* out, long long out_bs, int out_off, void* fin,
                                   long long fin_bs, long long fin_ns, long long fin_cs, int mode,
                                   int has_acc, float scale, const void* w1, const void* b1,
                                   const void* w2, const void* b2, int dil, int n_lo, int n_hi) {
  StepParams p;
  p.in = in;
  p.in_bs = in_bs;
  p.in_off = in_off;
  p.in_lo = in_lo;
  p.in_hi = in_hi;
  p.out = static_cast<float*>(out);
  p.out_bs = out_bs;
  p.out_off = out_off;
  p.fin = fin;
  p.fin_bs = fin_bs;
  p.fin_ns = fin_ns;
  p.fin_cs = fin_cs;
  p.mode = mode;
  p.has_acc = has_acc;
  p.scale = scale;
  p.w1 = w1;
  p.b1 = static_cast<const float*>(b1);
  p.w2 = w2;
  p.b2 = static_cast<const float*>(b2);
  p.dil = dil;
  p.n_lo = n_lo;
  p.n_hi = n_hi;
  return p;
}

}  // namespace mrf

// The C entry point shared by both libraries' step launchers. The argument
// order is the one the Python wrapper (vocoder_kernels._launch_step) passes.
#define MRF_STEP_ARGS                                                                        \
  const void *in, long long in_bs, int in_off, int in_lo, int in_hi, int in_f32, void *out,  \
      long long out_bs, int out_off, void *fin, long long fin_bs, long long fin_ns,          \
      long long fin_cs, int mode, int has_acc, float scale, const void *w1, const void *b1,  \
      const void *w2, const void *b2, int C, int K, int dil, int n_lo, int n_hi, int B,      \
      int cdt, void *stream
#define MRF_STEP_PARAMS                                                                      \
  mrf::make_step_params(in, in_bs, in_off, in_lo, in_hi, out, out_bs, out_off, fin, fin_bs,  \
                        fin_ns, fin_cs, mode, has_acc, scale, w1, b1, w2, b2, dil, n_lo, n_hi)
