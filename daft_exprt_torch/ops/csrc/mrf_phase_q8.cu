// Upsample + MRF group (+ conv_post) of one narrow HiFi-GAN level in the
// int8 forms of fused_mrf_phase, for Hopper.
//
// Replaces daft_exprt_tpu/ops/vocoder_kernels.py::fused_mrf_phase with
// int8_chain=True (Pallas body _fused_mrf_phase_kernel) in its q8 (dynamic),
// q8f (static, fused s32 boundary) and q8s (static, float32 boundary:
// JAX's DAFT_INT8_FUSED_EPI=0) modes, with the int8 upsample
// prologue and the bf16 conv_post epilogue. The TPU kernel's phase layout (p
// samples per phase column, p*C rows) is a reshape of the sample-major
// tensors the port keeps; its windows are whole phase columns. Every mode
// runs at (C_in, C) = (128, 64) and (64, 32) (V1's L2/L3) in two launches:
//   1. amax_kernel (mrf_q8.cuh): the upsample input's scale per tile, over
//      tile + 2*halo_in input columns (in JAX it is per tile in every
//      mode);
//   2. q8f and q8s: fused_mrf_ptc's ptc_fused_q8_kernel (mrf_ptc_fused.cuh,
//      mrf_phase_q8_fused; q8s with its float32 boundary) on the phase
//      tiles: the static chains do not depend on the tile, only the
//      upsample's input scale does, and amax_kernel takes it over the
//      phase tile's window. Dynamic: the segment-synchronised engine
//      (mrf_dyn_blk.cuh, mrf_phase_q8_blk), which runs the upsample, the
//      chains and conv_post per block with a segment barrier per conv,
//      each conv over the TPU kernel's column window (each conv shrinks it
//      by W-1 columns and moves it by -dmin-dmin2). The same two entries
//      run fused_mrf_ptc's dyn mode on the phase-tc tiles (mrf_ptc.cu).
// Without the prologue (in_phase=False: x in (B, C, T), HiFi-GAN V2's L1 at
// C=32, p=4; C=64, p=2 where a chain level's upsample cannot fuse) the
// tile's window is the zero-padded x itself, columns [-halo, tile + halo):
// the dynamic mode takes the first conv's scale over that window of x
// (amax_kernel with the window in samples), then one launch of the engine
// (mrf_phase_q8_blk at (C, C): the ct route's x load on the phase
// kernel's column windows, the three chains and their sum on chip). q8f
// and q8s need no scale there: the static chains are the zero-padded valid
// chains of mrf_tc_q8.cu, whatever the tile, one launch of
// ptc_fused_q8_kernel without prologue (mrf_phase_q8_fused at (C, C)).
//
// Bound on the card: operations, 252*B*T*C^2 int8 operations per level
// and the upsample's.
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
  if (c_in == 64 && C == 64) return mrf::blk::dyn_blk_entry<64, 64>(p, ints, slots, s);
  if (c_in == 32 && C == 32) return mrf::blk::dyn_blk_entry<32, 32>(p, ints, slots, s);
  return (int)cudaErrorInvalidValue;
}

// fused_mrf_phase_q8's q8f and (q8s != 0) q8s modes: ptc_fused_q8_kernel
// with the phase tiles; at (C, C) without prologue
extern "C" int mrf_phase_q8_fused(MRF_PTC_FUSED_ARGS) {
  MRF_PTC_FUSED_PARAMS(p);
  if (c_in == 128 && C == 64)
    return mrf::blk::ptc_fused_launch<128, 64>(p, ints, S, slots, q8s, stream);
  if (c_in == 64 && C == 32)
    return mrf::blk::ptc_fused_launch<64, 32>(p, ints, S, slots, q8s, stream);
  if (c_in == 64 && C == 64)
    return mrf::blk::ptc_fused_launch<64, 64>(p, ints, S, slots, q8s, stream);
  if (c_in == 32 && C == 32)
    return mrf::blk::ptc_fused_launch<32, 32>(p, ints, S, slots, q8s, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mrf_phase_q8_amax(const void* x, long long x_bs, int t_in, int c_in, int n_tiles,
                                 int tile_in, int halo_in, int win_len, void* amax_bits, int S,
                                 void* stream) {
  return (int)mrf::launch_amax(x, x_bs, t_in, c_in, n_tiles, tile_in, halo_in, win_len, amax_bits,
                               S, static_cast<cudaStream_t>(stream));
}
