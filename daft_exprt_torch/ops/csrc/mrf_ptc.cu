// Upsample + MRF group (+ conv_post) of one narrow HiFi-GAN level in the
// int8 forms of fused_mrf_ptc, for Hopper.
//
// Replaces daft_exprt_tpu/ops/vocoder_kernels.py::fused_mrf_ptc (Pallas body
// _fused_mrf_ptc_kernel) in its static and dyn modes, with its upsample
// prologue and conv_post epilogue. The TPU kernel's phase-tc layout (p phases
// x C channels in 128 lanes) is a reshape of the sample-major (B, T, C)
// tensors the port keeps, so this file computes the same function per
// sample. It is a function of the tile: for each tile of `tile` phase rows,
// one dynamic scale per (utterance, tile), the amax of lrelu(x) over the
// tile's input window [t*tile - halo_in, (t+1)*tile + halo_in) rows (zero
// outside the utterance); lrelu(x) quantised with that scale (rintf, no
// clip); the ConvTranspose1d upsample as per-phase s8 x s8 -> s32 products
// with per-(phase, channel) weight scales, dequantised with
// fma(acc, sw*sx, b) into the tile's float32 segment of tile + 2*halo rows
// (neighbouring tiles' segments overlap and differ); the chains on the
// segment; the chain mean cast to bf16, or lrelu of the f32 mean rounded
// to bf16, conv_post (C -> 1) on bf16 weights, tanh, bf16.
//
// Bound on the card: by the work, operations: the MRF group's
// 252*B*T*C^2 int8 operations at C = 64/32 and the upsample's
// 2*B*T_out*C_in*C*k/s. What bounds the static kernel is in
// mrf_chain_q8.cuh.
//
// static mode, two launches:
//   1. amax_kernel (mrf_q8.cuh): the tile scales (a tile's window, up to
//      8192 rows, is wider than a block).
//   2. ptc_fused_q8_kernel (mrf_ptc_fused.cuh, shared with the q8f mode
//      of mrf_phase_q8.cu): a block owns BM output samples of one tile
//      (BM = 128 at C = 64, 256 at C = 32) and works on chip throughout: it
//      quantises its own x window with the tile's scale into an s8 tile,
//      and for each chain runs the s8 upsample into a float32 residual
//      window over the chain's own halo (12/36/60 samples, + conv_post's
//      reach), the chain's three steps on that window (mrf_chain_q8.cuh:
//      16 warps, 4 warpgroups of wgmma, m64n64k32 at C = 64, two m64n32k32
//      row blocks at C = 32; the weight ring lags one stage, so a stage's
//      MMAs run on across the next barrier), and adds the chain into a
//      float32 sum in shared memory; then writes bf16 or runs conv_post and
//      tanh. Only x (bf16) is read and only the level's output
//      written; the samples a block reads lie inside the tile's segment
//      (the window reaches at most 64 samples past the block, the segment
//      halo*p >= 128), so every block sees exactly the segment's values.
//      A one-step-per-launch design moved ~9 float32 passes over the
//      segments through device memory, which at C = 32 took longer than the
//      operations.
// dyn mode (every conv's scale is the amax over a whole segment, which a
//   block cannot see): amax_kernel, ups_q8_kernel into a float32 segment,
//   two conv_dyn_kernel launches (mrf_dyn.cuh) per (chain, dilation), each
//   conv quantising its whole window with one scale (the TPU kernel's
//   window of a conv is all p phases of the rows it reads: it shrinks by
//   the conv's row span, _ptc_spec's smin..smax, p*span samples; the launch
//   plan mrf_int8._narrow_plan sets each launch's samples so), and
//   post_kernel (mrf_common.cuh).
#include "mrf_dyn.cuh"
#include "mrf_ptc_fused.cuh"

extern "C" int mrf_ptc_amax(const void* x, long long x_bs, int t_in, int c_in, int n_tiles,
                            int tile_in, int halo_in, int win_len, void* amax_bits, int S,
                            void* stream) {
  return (int)mrf::launch_amax(x, x_bs, t_in, c_in, n_tiles, tile_in, halo_in, win_len, amax_bits,
                               S, static_cast<cudaStream_t>(stream));
}

extern "C" int mrf_ptc_ups(const void* x, long long x_bs, int t_in, const void* amax, void* out,
                           long long out_bs, const void* w, const void* sw, const void* bias,
                           int stride, int ntaps, int amin, int span, const int* delta,
                           int n_tiles, int tile_in, int halo_m, int m_len, int c_in, int c_out,
                           int S, void* amax_out, void* stream) {
  return (int)mrf::launch_ups_q8(x, x_bs, t_in, amax, out, out_bs, w, sw, bias, stride, ntaps,
                                 amin, span, delta, n_tiles, tile_in, halo_m, m_len, c_in, c_out,
                                 S, amax_out, static_cast<cudaStream_t>(stream));
}

extern "C" int mrf_ptc_conv(MRF_DYN_ARGS) {
  MRF_DYN_PARAMS(q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return (int)mrf::launch_conv_dyn_c<32>(q, K, S, s);
    case 64: return (int)mrf::launch_conv_dyn_c<64>(q, K, S, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mrf_ptc_post(const void* R, long long r_bs, int r_off, int C, float scale,
                            const void* w, float bias, int kpost, void* out, int N, int S,
                            void* stream) {
  const dim3 grid((N + 255) / 256, S);
  void* args[] = {&R, &r_bs, &r_off, &C, &scale, &w, &bias, &kpost, &out, &N};
  cudaError_t e = cudaLaunchKernel(reinterpret_cast<const void*>(&mrf::post_kernel<mrf::bf16>),
                                   grid, dim3(256), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The static mode's fused launch (its arguments: ptc_fused_entry,
// mrf_ptc_fused.cuh).
extern "C" int mrf_ptc_fused(const void* x, long long x_bs, int t_in, const void* amax, void* out,
                             long long out_bs, const long long* ptrs, const int* ints,
                             float scale, float post_bias, int c_in, int C, int S, int slots,
                             void* stream) {
  return mrf::blk::ptc_fused_entry(x, x_bs, t_in, amax, out, out_bs, ptrs, ints, scale, post_bias,
                                   c_in, C, S, slots, stream);
}
