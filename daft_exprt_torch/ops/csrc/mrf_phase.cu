// Upsample + MRF group (+ conv_post) of one narrow HiFi-GAN level, for Hopper.
//
// Replaces daft_exprt_tpu/ops/vocoder_kernels.py::fused_mrf_phase (Pallas
// body _fused_mrf_phase_kernel), float mode with the fused upsample
// prologue and the conv_post epilogue. The TPU kernel's phase layout fills a
// 128x128 MXU and is not carried over; the function it computes is:
//   1. lrelu(x) of the pre-upsample input, zero-extended, then the
//      ConvTranspose1d upsample (k - 2p == s) evaluated over an extended
//      sample range (bias plus edge leakage beyond the utterance), rounded
//      to the compute type;
//   2. the MRF chains by valid convs on a float32 residual stream;
//   3. without conv_post: the chain mean in the compute type, in (B, C, T)
//      layout; with conv_post: lrelu of the unrounded float32 mean ->
//      conv_post (C -> 1) -> tanh.
// The extension covers the chains' and conv_post's receptive fields, so
// every sample, edges included, matches the TPU kernel's tile-independent
// result.
//
// bf16 compute: one launch of phase_bf_kernel (mrf_chain_bf16.cuh) per
// level (vocoder_kernels._phase_bf_plan). A persistent block takes items of
// bm output samples of one utterance and works on chip throughout: it
// loads its x window (lrelu, bf16), runs the polyphase upsample on wgmma
// into a bf16 tile X0 over the window [n0 - hx, n0 + bm + hx) (hx: the
// widest chain's halo + conv_post's reach), then per chain copies the
// chain's own window of X0 into the float32 residual window and its lrelu
// into the bf16 conv tile, runs the chain's three steps and adds the chain
// into a float32 sum; then writes the mean in bf16 through a transposed
// tile into (B, C, N), or runs conv_post and tanh per sample into (B, 1,
// N). Only x is read and only the level's output written.
//
// float32 compute: one launch of phase_f32_kernel (mrf_chain_f32.cuh) per
// level (vocoder_kernels._phase_f32_plan): phase_bf_kernel's blocks and
// windows with every product in 3xTF32 on the tensor cores (mma.sync), the
// conv tiles and X0 in float32 and the residual window and chain sum in an
// L2-resident scratch slice per block.
//
// The step route (ups_kernel, one mrf::step_kernel per (chain, dilation)
// step, post_kernel) serves only fused_mrf_ptc's fdot mode (the bf16 tier's
// phase-tc form: unquantised bf16 dots on the shift matrices of
// pack_mrf_ptc_f_weights), which computes this function in bf16 but for one
// rounding: its upsample output x0 = acc + b stays float32 (ups_kernel
// writes float32) where phase_bf_kernel rounds it to bf16. Only its bf16
// instantiations are built here.
//
// Bound on the card: operations. The MRF group's 252*B*T*C^2 FLOPs at
// C=64/32 dominate; the upsample adds 2*B*T_out*C_in*C_out*k/s.
#include "mrf_chain_f32.cuh"

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

// fdot's step: bf16 compute on the float32 x0 and residual buffers
template <int C>
cudaError_t launch_fdot_step(const StepParams& p, int K, int B, cudaStream_t s) {
  switch (K) {
    case 3: return launch_step_t<C, 3, bf16, float>(p, B, s);
    case 7: return launch_step_t<C, 7, bf16, float>(p, B, s);
    case 11: return launch_step_t<C, 11, bf16, float>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mrf

// fused_mrf_ptc_f's launches (bf16 compute, float32 x0: cdt 1, in_f32 1)
extern "C" int mrf_phase_step(MRF_STEP_ARGS) {
  if (cdt != 1 || in_f32 != 1) return (int)cudaErrorInvalidValue;
  const mrf::StepParams p = MRF_STEP_PARAMS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return (int)mrf::launch_fdot_step<32>(p, K, B, s);
    case 64: return (int)mrf::launch_fdot_step<64>(p, K, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mrf_phase_ups(const void* x, long long x_bs, long long x_cs, long long x_ts, int t_in,
                             void* out, long long out_bs, int out_off, const void* w,
                             const void* bias, int stride, int ntaps, int amin, int span,
                             const int* delta, int m_lo, int m_hi, int n_lo, int n_hi, int c_in,
                             int c_out, int B, void* stream) {
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
  using mrf::bf16;
  if (c_in == 128 && c_out == 64) return (int)mrf::launch_ups_t<128, 64, bf16, float>(p, B, s);
  if (c_in == 64 && c_out == 32) return (int)mrf::launch_ups_t<64, 32, bf16, float>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mrf_phase_post(const void* R, long long r_bs, int r_off, int C, float scale,
                              const void* w, float bias, int kpost, void* out, int N, int B,
                              void* stream) {
  const dim3 grid((N + 255) / 256, B);
  void* args[] = {&R, &r_bs, &r_off, &C, &scale, &w, &bias, &kpost, &out, &N};
  cudaError_t e = cudaLaunchKernel(reinterpret_cast<const void*>(&mrf::post_kernel<mrf::bf16>),
                                   grid, dim3(256), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The fields the bf16 and float32 level launches share, from the entry's
// arrays: ptrs wu, bu, wp (null without conv_post), then 4 per step of
// each chain (w1, b1, w2, b2); ints stride, ntaps, amin, span, rows_r[8],
// N, hx, P, kpost, block_m, the 5 stage ints (tps, kch, utps, ukch,
// r_smem: checked by the launch), wu_phase, n_chains, then per chain k,
// n_steps, dils[4] (vocoder_kernels._phase_args). False for a malformed
// call.
template <class Params>
static bool phase_params(Params& p, long long x_bs, long long x_cs, long long x_ts, int t_in,
                         long long out_bs, const long long* ptrs, const int* ints, float scale,
                         float post_bias, void* scratch) {
  using mrf::bfe::StepBf;
  p.x_bs = x_bs;
  p.x_cs = x_cs;
  p.x_ts = x_ts;
  p.t_in = t_in;
  p.out_bs = out_bs;
  p.wu = reinterpret_cast<const int8_t*>(ptrs[0]);
  p.bu = reinterpret_cast<const float*>(ptrs[1]);
  p.wp = reinterpret_cast<const float*>(ptrs[2]);
  p.stride = ints[0];
  p.ntaps = ints[1];
  p.amin = ints[2];
  p.span = ints[3];
  for (int r = 0; r < 8; ++r) p.rows_r[r] = ints[4 + r];
  p.N = ints[12];
  p.hx = ints[13];
  p.P = ints[14];
  p.kpost = ints[15];
  p.bm = ints[16];
  p.wu_phase = ints[22];
  p.n_chains = ints[23];
  p.bp = post_bias;
  p.scale = scale;
  p.scratch = static_cast<float*>(scratch);
  if (p.stride < 1 || p.stride > 8 || p.n_chains < 1 || p.n_chains > mrf::bfe::kMaxChains ||
      (p.kpost > 0) != (p.wp != nullptr) || (p.kpost > 0 && p.P != (p.kpost - 1) / 2) ||
      (p.kpost == 0 && p.P != 0))
    return false;
  const long long* w = ptrs + 3;
  for (int j = 0; j < p.n_chains; ++j) {
    const int* cj = ints + 24 + 6 * j;
    p.k[j] = cj[0];
    p.n_steps[j] = cj[1];
    if (p.n_steps[j] < 1 || p.n_steps[j] > mrf::bfe::kMaxSteps || p.k[j] < 1 || p.k[j] % 2 == 0)
      return false;
    for (int i = 0; i < p.n_steps[j]; ++i, w += 4)
      p.steps[j][i] = StepBf{reinterpret_cast<const int8_t*>(w[0]), reinterpret_cast<const float*>(w[1]),
                             reinterpret_cast<const int8_t*>(w[2]), reinterpret_cast<const float*>(w[3]),
                             cj[2 + i]};
  }
  return true;
}

// The bf16 level in one launch (the arrays: phase_params).
extern "C" int mrf_phase_bf(const void* x, long long x_bs, long long x_cs, long long x_ts, int t_in,
                            void* out, long long out_bs, const long long* ptrs, const int* ints,
                            float scale, float post_bias, int c_in, int C, int B, void* scratch,
                            long long scratch_floats, int slots, void* stream) {
  using namespace mrf::bfe;
  PhaseBfParams p = {};
  p.x = static_cast<const mrf::bf16*>(x);
  p.out = static_cast<mrf::bf16*>(out);
  if (!phase_params(p, x_bs, x_cs, x_ts, t_in, out_bs, ptrs, ints, scale, post_bias, scratch))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_in == 128 && C == 64)
    return (int)launch_phase_bf<128, 64>(p, B, ints + 17, scratch_floats, slots, s);
  if (c_in == 64 && C == 32)
    return (int)launch_phase_bf<64, 32>(p, B, ints + 17, scratch_floats, slots, s);
  return (int)cudaErrorInvalidValue;
}

// The float32 level in one launch (the arrays: phase_params; the taps in
// pack_stage_tf32's order).
extern "C" int mrf_phase_f32(const void* x, long long x_bs, long long x_cs, long long x_ts,
                             int t_in, void* out, long long out_bs, const long long* ptrs,
                             const int* ints, float scale, float post_bias, int c_in, int C, int B,
                             void* scratch, long long scratch_floats, int slots, void* stream) {
  using namespace mrf::f32e;
  PhaseF32Params p = {};
  p.x = static_cast<const float*>(x);
  p.out = static_cast<float*>(out);
  if (!phase_params(p, x_bs, x_cs, x_ts, t_in, out_bs, ptrs, ints, scale, post_bias, scratch))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_in == 128 && C == 64)
    return (int)launch_phase_f32<128, 64>(p, B, ints + 17, scratch_floats, slots, s);
  if (c_in == 64 && C == 32)
    return (int)launch_phase_f32<64, 32>(p, B, ints + 17, scratch_floats, slots, s);
  return (int)cudaErrorInvalidValue;
}
