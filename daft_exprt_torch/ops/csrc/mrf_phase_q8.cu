// Upsample + MRF group (+ conv_post) of one narrow HiFi-GAN level in the
// int8 forms of fused_mrf_phase, for Hopper.
//
// Replaces daft_exprt_tpu/ops/vocoder_kernels.py::fused_mrf_phase with
// int8_chain=True (Pallas body _fused_mrf_phase_kernel) in its q8 (dynamic),
// q8f (static, fused s32 boundary) and q8s (static, float32 boundary:
// JAX's DAFT_INT8_FUSED_EPI=0) modes, with the int8 upsample
// prologue and the bf16 conv_post epilogue. The TPU kernel's phase layout (p
// samples per phase column, p*C rows) is a reshape of the sample-major
// tensors the port keeps; its windows are whole phase columns. For each
// tile of `tile` columns:
//   1. amax_kernel (mrf_q8.cuh): the upsample input's scale over tile +
//      2*halo_in input columns;
//   2. ups_q8_kernel (mrf_q8.cuh): the int8 upsample into a float32 segment
//      of tile + 2*halo columns (dynamic mode: also its amax);
//   3. q8s: one step_q8_kernel launch (mrf_q8.cuh) per (chain, dilation),
//      the static chain being a fixed function of the segment;
//   4. the chain mean to bf16, or post_kernel (mrf_common.cuh): conv_post
//      on lrelu(mean) rounded to bf16, tanh, bf16.
// The dynamic mode at (C_in, C) = (128, 64) and (64, 32) (V1's L2/L3):
// amax_kernel, then one launch of the segment-synchronised engine
// (mrf_dyn_blk.cuh, mrf_phase_q8_blk) that runs steps 2-4 per block with
// a segment barrier per conv, each conv over the TPU kernel's column
// window (each conv shrinks it by W-1 columns and moves it by
// -dmin-dmin2). The same two entries run fused_mrf_ptc's dyn mode on the
// phase-tc tiles (mrf_ptc.cu). The q8f mode there: amax_kernel and fused_mrf_ptc's
// ptc_fused_q8_kernel (mrf_ptc_fused.cuh, mrf_phase_q8_fused) on the phase
// tiles: the static
// chains do not depend on the tile, only the upsample's input scale does,
// and amax_kernel takes it over the phase tile's window.
// Without the prologue (in_phase=False: x in (B, C, T), HiFi-GAN V2's L1 at
// C=32, p=4) the tile's window is the zero-padded x itself, columns
// [-halo, tile + halo): step 1 takes the first conv's scale over that
// window of x (amax_kernel with the window in samples), step 2 drops out,
// and the first conv of each chain reads x through its zero-padded view.
// q8f and q8s need no scale there: the static chains are the zero-padded
// valid chains of mrf_tc_q8.cu, whatever the tile.
//
// Bound on the card: operations at C=64 (252*B*T*C^2 int8 operations and
// the upsample's), device memory at C=32 for the one-launch-per-step
// forms, where ~20 float32 passes over the segments outweigh them.
#include "mrf_dyn.cuh"
#include "mrf_dyn_blk.cuh"
#include "mrf_ptc_fused.cuh"

extern "C" int mrf_phase_q8_blk(MRF_DYN_BLK_ARGS) {
  mrf::blk::DynBlkParams p;
  if (!mrf::blk::dyn_blk_params(p, x, x_bs, t_in, amax0, sync, sum, sum_bs, out, out_bs, ptrs,
                                ints, scale, post_bias, scratch, scratch_n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_in == 128 && C == 64) return mrf::blk::dyn_blk_entry<128, 64>(p, ints, slots, s);
  if (c_in == 64 && C == 32) return mrf::blk::dyn_blk_entry<64, 32>(p, ints, slots, s);
  return (int)cudaErrorInvalidValue;
}

// fused_mrf_phase_q8's q8f mode: ptc_fused_q8_kernel with the phase tiles
extern "C" int mrf_phase_q8_fused(const void* x, long long x_bs, int t_in, const void* amax,
                                  void* out, long long out_bs, const long long* ptrs,
                                  const int* ints, float scale, float post_bias, int c_in, int C,
                                  int S, int slots, void* stream) {
  return mrf::blk::ptc_fused_entry(x, x_bs, t_in, amax, out, out_bs, ptrs, ints, scale, post_bias,
                                   c_in, C, S, slots, stream);
}

extern "C" int mrf_phase_q8_amax(const void* x, long long x_bs, int t_in, int c_in, int n_tiles,
                                 int tile_in, int halo_in, int win_len, void* amax_bits, int S,
                                 void* stream) {
  return (int)mrf::launch_amax(x, x_bs, t_in, c_in, n_tiles, tile_in, halo_in, win_len, amax_bits,
                               S, static_cast<cudaStream_t>(stream));
}

extern "C" int mrf_phase_q8_ups(const void* x, long long x_bs, int t_in, const void* amax,
                                void* out, long long out_bs, const void* w, const void* sw,
                                const void* bias, int stride, int ntaps, int amin, int span,
                                const int* delta, int n_tiles, int tile_in, int halo_m, int m_len,
                                int c_in, int c_out, int S, void* amax_out, void* stream) {
  return (int)mrf::launch_ups_q8(x, x_bs, t_in, amax, out, out_bs, w, sw, bias, stride, ntaps,
                                 amin, span, delta, n_tiles, tile_in, halo_m, m_len, c_in, c_out,
                                 S, amax_out, static_cast<cudaStream_t>(stream));
}

extern "C" int mrf_phase_q8_conv(MRF_DYN_ARGS) {
  MRF_DYN_PARAMS(q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return (int)mrf::launch_conv_dyn_c<32>(q, K, S, s);
    case 64: return (int)mrf::launch_conv_dyn_c<64>(q, K, S, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mrf_phase_q8_step(MRF_Q8_STEP_ARGS) {
  MRF_Q8_PARAMS(q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return (int)mrf::launch_step_q8_c<32>(q, K, B, s);
    case 64: return (int)mrf::launch_step_q8_c<64>(q, K, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mrf_phase_q8_step_s(MRF_Q8S_STEP_ARGS) {
  MRF_Q8S_PARAMS(q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return (int)mrf::launch_step_q8_c<32, true>(q, K, B, s);
    case 64: return (int)mrf::launch_step_q8_c<64, true>(q, K, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mrf_phase_q8_post(const void* R, long long r_bs, int r_off, int C, float scale,
                                 const void* w, float bias, int kpost, void* out, int N, int S,
                                 void* stream) {
  const dim3 grid((N + 255) / 256, S);
  void* args[] = {&R, &r_bs, &r_off, &C, &scale, &w, &bias, &kpost, &out, &N};
  cudaError_t e = cudaLaunchKernel(reinterpret_cast<const void*>(&mrf::post_kernel<mrf::bf16>),
                                   grid, dim3(256), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
