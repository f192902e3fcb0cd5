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
//   2. ptc_fused_q8_kernel (mrf_ptc_fused.cuh, shared with the q8f and q8s
//      modes of mrf_phase_q8.cu): a block owns BM output samples of one tile
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
//   block cannot see) runs mrf_phase_q8.cu's entries, amax_kernel and
//   one launch of the segment-synchronised engine (mrf_dyn_blk.cuh,
//   mrf_phase_q8_blk) on the phase-tc tiles: its function is the dynamic
//   fused_mrf_phase's on other tiles (the TPU kernel's window of a conv is
//   all p phases of the rows it reads, which is the phase kernel's column
//   window; mrf_int8._dyn_blk_plan with _ptc_geometry), and one library
//   builds the engine once.
#include "mrf_ptc_fused.cuh"

extern "C" int mrf_ptc_amax(const void* x, long long x_bs, int t_in, int c_in, int n_tiles,
                            int tile_in, int halo_in, int win_len, void* amax_bits, int S,
                            void* stream) {
  return (int)mrf::launch_amax(x, x_bs, t_in, c_in, n_tiles, tile_in, halo_in, win_len, amax_bits,
                               S, static_cast<cudaStream_t>(stream));
}

// The static mode's fused launch (its arguments: ptc_fused_params,
// mrf_ptc_fused.cuh; fused_mrf_ptc has no q8s mode, q8s must be 0).
extern "C" int mrf_ptc_fused(MRF_PTC_FUSED_ARGS) {
  if (q8s) return (int)cudaErrorInvalidValue;
  MRF_PTC_FUSED_PARAMS(p);
  if (c_in == 128 && C == 64)
    return mrf::blk::ptc_fused_launch<128, 64>(p, ints, S, slots, false, stream);
  if (c_in == 64 && C == 32)
    return mrf::blk::ptc_fused_launch<64, 32>(p, ints, S, slots, false, stream);
  return (int)cudaErrorInvalidValue;
}
