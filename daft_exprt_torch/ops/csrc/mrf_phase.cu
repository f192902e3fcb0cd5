// Upsample + MRF group (+ conv_post) of one narrow HiFi-GAN level, for Hopper.
//
// Replaces daft_exprt_tpu/ops/vocoder_kernels.py::fused_mrf_phase (Pallas
// body _fused_mrf_phase_kernel), float mode with the fused upsample
// prologue and the conv_post epilogue. The TPU kernel's phase layout fills a
// 128x128 MXU and is not carried over; the function it computes is:
//   1. lrelu(x) of the pre-upsample input, zero-extended, then the
//      ConvTranspose1d upsample (k - 2p == s) evaluated over an extended
//      sample range (bias plus edge leakage beyond the utterance), rounded
//      to the compute type  -> ups_kernel;
//   2. the MRF chains by valid convs on a float32 residual stream
//      -> mrf::step_kernel, one launch per (chain, dilation) step;
//   3. without conv_post: the chain mean in the compute type, written in
//      (B, C, T) layout by the last step; with conv_post: lrelu of the
//      unrounded float32 mean -> conv_post (C -> 1) -> tanh -> post_kernel.
// The extension covers the chains' and conv_post's receptive fields, so
// every sample, edges included, matches the TPU kernel's tile-independent
// result.
//
// The same launches replace fused_mrf_ptc's fdot mode (the bf16 tier's
// phase-tc form: unquantised bf16 dots on the shift matrices of
// pack_mrf_ptc_f_weights), which computes this function but for one
// rounding: its upsample output x0 = acc + b stays float32 (step 1 writes
// float32, `out_f32`) where the banded phase kernel rounds it to bf16.
//
// Bound on the card: operations. The MRF group's 252*B*T*C^2 FLOPs at
// C=64/32 dominate; the upsample adds 2*B*T_out*C_in*C_out*k/s.
#include "mrf_common.cuh"

namespace mrf {

struct UpsParams {
  const void* x;  // (B, C_in, T_in) through strides, compute type
  long long x_bs, x_cs, x_ts;
  int t_in;
  void* out;  // channel-last (B, N + 2E, C_out): sample n at (n + out_off)
  long long out_bs;
  int out_off;
  const void* w;  // per phase r: ntaps taps, packed like the chain weights
  const float* bias;
  int stride, ntaps, amin, span;
  int m_lo, m_hi;  // input-rate positions m: output samples stride*m + r
  int n_lo, n_hi;  // output samples kept
  int delta[8];    // phase r reads A rows delta[r] + m + tap
};

constexpr int kUpsRows = 128;

template <int CIN, int COUT, typename CT, typename TOut>
__global__ void __launch_bounds__(kThreads) ups_kernel(const UpsParams p) {
  constexpr int LDA = CIN + Tile<CT>::pad;
  const int rows = kUpsRows + p.span;
  extern __shared__ __align__(16) unsigned char smem[];
  CT* a = reinterpret_cast<CT*>(smem);
  const int b = blockIdx.y;
  const int m0 = p.m_lo + blockIdx.x * kUpsRows;
  const CT* x = static_cast<const CT*>(p.x) + b * p.x_bs;
  const int t0 = m0 + p.amin;
  if (p.x_ts == 1) {  // channel-major input: threads walk time
    for (int idx = threadIdx.x; idx < rows * CIN; idx += kThreads) {
      const int c = idx / rows, i = idx - c * rows;
      const int t = t0 + i;
      float v = 0.f;
      if (t >= 0 && t < p.t_in) v = lrelu(to_f32(x[c * p.x_cs + t]));
      a[i * LDA + c] = from_f32<CT>(v);
    }
  } else {  // channel-last input: threads walk channels
    for (int idx = threadIdx.x; idx < rows * CIN; idx += kThreads) {
      const int i = idx / CIN, c = idx - i * CIN;
      const int t = t0 + i;
      float v = 0.f;
      if (t >= 0 && t < p.t_in) v = lrelu(to_f32(x[c * p.x_cs + (long long)t * p.x_ts]));
      a[i * LDA + c] = from_f32<CT>(v);
    }
  }
  __syncthreads();
  TOut* out = static_cast<TOut*>(p.out) + b * p.out_bs;
  const float* bias = p.bias;
  const size_t phase_elems = (size_t)p.ntaps * CIN * COUT;
  for (int r = 0; r < p.stride; ++r) {
    const void* w_r = static_cast<const char*>(p.w) + r * phase_elems * sizeof(CT);
    conv_gemm<CIN, COUT>(a + p.delta[r] * LDA, LDA, kUpsRows, 1, p.ntaps, w_r,
                         [&](int m, int n, float acc) {
                           const int mm = m0 + m;
                           if (mm >= p.m_hi) return;
                           const int s = p.stride * mm + r;
                           if (s < p.n_lo || s >= p.n_hi) return;
                           out[(long long)(s + p.out_off) * COUT + n] = from_f32<TOut>(acc + bias[n]);
                         });
  }
}

template <int CIN, int COUT, typename CT, typename TOut>
cudaError_t launch_ups_t(const UpsParams& p, int B, cudaStream_t stream) {
  const size_t smem = (size_t)(kUpsRows + p.span) * (CIN + Tile<CT>::pad) * sizeof(CT);
  const void* kern = reinterpret_cast<const void*>(&ups_kernel<CIN, COUT, CT, TOut>);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int n = p.m_hi - p.m_lo;
  if (n <= 0) return cudaSuccess;
  dim3 grid((n + kUpsRows - 1) / kUpsRows, B);
  UpsParams arg = p;
  void* args[] = {&arg};
  e = cudaLaunchKernel(kern, grid, dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// cdt: 1 = bf16 compute, 0 = float32; out_f32: bf16 compute writing float32
template <int CIN, int COUT>
cudaError_t launch_ups_c(const UpsParams& p, int B, int cdt, int out_f32, cudaStream_t s) {
  if (cdt != 1) return launch_ups_t<CIN, COUT, float, float>(p, B, s);
  return out_f32 ? launch_ups_t<CIN, COUT, bf16, float>(p, B, s)
                 : launch_ups_t<CIN, COUT, bf16, bf16>(p, B, s);
}

}  // namespace mrf

extern "C" int mrf_phase_step(MRF_STEP_ARGS) {
  const mrf::StepParams p = MRF_STEP_PARAMS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return (int)mrf::launch_step_c<32>(p, K, B, cdt, in_f32, s);
    case 64: return (int)mrf::launch_step_c<64>(p, K, B, cdt, in_f32, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mrf_phase_ups(const void* x, long long x_bs, long long x_cs, long long x_ts, int t_in,
                             void* out, long long out_bs, int out_off, const void* w,
                             const void* bias, int stride, int ntaps, int amin, int span,
                             const int* delta, int m_lo, int m_hi, int n_lo, int n_hi, int c_in,
                             int c_out, int B, int cdt, int out_f32, void* stream) {
  if (stride < 1 || stride > 8) return (int)cudaErrorInvalidValue;
  mrf::UpsParams p;
  p.x = x;
  p.x_bs = x_bs;
  p.x_cs = x_cs;
  p.x_ts = x_ts;
  p.t_in = t_in;
  p.out = out;
  p.out_bs = out_bs;
  p.out_off = out_off;
  p.w = w;
  p.bias = static_cast<const float*>(bias);
  p.stride = stride;
  p.ntaps = ntaps;
  p.amin = amin;
  p.span = span;
  p.m_lo = m_lo;
  p.m_hi = m_hi;
  p.n_lo = n_lo;
  p.n_hi = n_hi;
  for (int r = 0; r < 8; ++r) p.delta[r] = r < stride ? delta[r] : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_in == 128 && c_out == 64) return (int)mrf::launch_ups_c<128, 64>(p, B, cdt, out_f32, s);
  if (c_in == 64 && c_out == 32) return (int)mrf::launch_ups_c<64, 32>(p, B, cdt, out_f32, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mrf_phase_post(const void* R, long long r_bs, int r_off, int C, float scale,
                              const void* w, float bias, int kpost, void* out, int N, int B,
                              int cdt, void* stream) {
  const dim3 grid((N + 255) / 256, B);
  void* args[] = {&R, &r_bs, &r_off, &C, &scale, &w, &bias, &kpost, &out, &N};
  const void* kern = cdt == 1 ? reinterpret_cast<const void*>(&mrf::post_kernel<mrf::bf16>)
                              : reinterpret_cast<const void*>(&mrf::post_kernel<float>);
  cudaError_t e = cudaLaunchKernel(kern, grid, dim3(256), args, 0,
                                   static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
