// Shared pieces of the HiFi-GAN MRF kernels: the types, the lrelu slope, the
// step modes and the parameters of one ResBlock1 chain step,
//     out[n] = in[n] + conv2_k(lrelu(conv1_{k,d}(lrelu(in))))[n],
// which the int8 step kernels (mrf_q8.cuh) launch one at a time over
// sample-major (B, T, C) buffers, the float32 residual stream between steps
// in device memory. The float levels run on the block-resident engines
// (mrf_chain_bf16.cuh, mrf_chain_f32.cuh), which keep a chain on chip.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace mrf {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr float kSlope = 0.1f;

__device__ __forceinline__ float lrelu(float x) { return x >= 0.f ? x : kSlope * x; }

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

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
