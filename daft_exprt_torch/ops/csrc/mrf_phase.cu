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
// fused_mrf_ptc's fdot mode (the bf16 tier's phase-tc form:
// unquantised bf16 dots on the shift matrices of pack_mrf_ptc_f_weights,
// replacing daft_exprt_tpu/ops/vocoder_kernels.py::fused_mrf_ptc with
// fdot=True) computes the bf16 function but for one rounding: its upsample
// output x0 = acc + b stays float32. It is one launch of phase_bf_kernel
// with a float32 X0 (mrf_phase_fdot) in the block's L2-resident scratch
// slice, so that its blocks are the bf16 level's: X0 in shared memory
// would double there and shrink the blocks (at L2 from 136 to 96 samples,
// 1.18x the bf16 level's time on an H100 80GB HBM3 at 700 W;
// vocoder_kernels._phase_bf_plan with fdot).
//
// Bound on the card: operations. The MRF group's 252*B*T*C^2 FLOPs at
// C=64/32 dominate; the upsample adds 2*B*T_out*C_in*C_out*k/s.
#include "mrf_chain_f32.cuh"

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

// The bf16 level in one launch, X0 of type X0T (the arrays: phase_params).
template <typename X0T>
static int phase_bf_entry(const void* x, long long x_bs, long long x_cs, long long x_ts, int t_in,
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
    return (int)launch_phase_bf<128, 64, X0T>(p, B, ints + 17, scratch_floats, slots, s);
  if (c_in == 64 && C == 32)
    return (int)launch_phase_bf<64, 32, X0T>(p, B, ints + 17, scratch_floats, slots, s);
  return (int)cudaErrorInvalidValue;
}

// fused_mrf_phase in bf16: X0 rounded to bf16.
extern "C" int mrf_phase_bf(const void* x, long long x_bs, long long x_cs, long long x_ts, int t_in,
                            void* out, long long out_bs, const long long* ptrs, const int* ints,
                            float scale, float post_bias, int c_in, int C, int B, void* scratch,
                            long long scratch_floats, int slots, void* stream) {
  return phase_bf_entry<mrf::bf16>(x, x_bs, x_cs, x_ts, t_in, out, out_bs, ptrs, ints, scale,
                                   post_bias, c_in, C, B, scratch, scratch_floats, slots, stream);
}

// fused_mrf_ptc's fdot mode: the same launch with X0 in float32.
extern "C" int mrf_phase_fdot(const void* x, long long x_bs, long long x_cs, long long x_ts,
                              int t_in, void* out, long long out_bs, const long long* ptrs,
                              const int* ints, float scale, float post_bias, int c_in, int C,
                              int B, void* scratch, long long scratch_floats, int slots,
                              void* stream) {
  return phase_bf_entry<float>(x, x_bs, x_cs, x_ts, t_in, out, out_bs, ptrs, ints, scale,
                               post_bias, c_in, C, B, scratch, scratch_floats, slots, stream);
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
