// MRF group of one HiFi-GAN level in the int8 serving forms of fused_mrf_ct,
// for Hopper.
//
// Replaces daft_exprt_tpu/ops/vocoder_kernels.py::fused_mrf_ct with
// int8_chain=True (Pallas body _fused_mrf_ct_kernel) in three modes:
//
// q8 (int8-dynamic, no act scales): V1's L0/L1 (C=256, 128) and V2's L0
// (C=64) in the dynamic tier, C=32 where no phase tile divides the level.
// The function is one of the tile: for each tile of `tile` samples, the
// chains run on the window [-halo, tile + halo) of the zero-padded input
// (halo = the widest chain's reach rounded to 64, then to 128), each conv
// shrinking it by its reach per side, and each conv quantises its whole
// input window with one scale. The output is the tile's samples of the
// chain mean, bf16. The tiles are segments; amax_kernel (mrf_q8.cuh)
// takes the first scale over each window of x. Design (mrf_ct_q8_blk):
// the segment-synchronised engine of mrf_dyn_blk.cuh, a segment barrier
// per conv; at C = 256 and 128 one launch per chain (1 + 3 for the V1
// group, the chain sum in float32 in device memory), at C = 64 and 32 one
// launch a level with the chain sum on chip (1 + 1).
//
// q8f (int8-static, act scales folded into the weights, the conv1 -> conv2
// boundary requantised in s32): V2's L0 (C=64) in the static tier, C=32
// where no phase tile divides the level. Static scales make the function
// the zero-padded valid chains of mrf_tc_q8.cu, whatever the tile; only the
// weights' packing (jitted, per-tap, vocoder_kernels.py:403-420) differs.
// q8s (int8-static with the round-3 boundary: dequantise, lrelu and
// requantise conv1's output in float32; JAX's DAFT_INT8_FUSED_EPI=0): the
// same function class, weights packed per conv as [wq, sw, inv, b]
// (vocoder_kernels.py:421-436). Design of both (mrf_ct_q8_fused): one
// launch a level of ptc_fused_q8_kernel without its upsample prologue
// (mrf_ptc_fused.cuh, PtcCfg<C, C>): a block of BM samples keeps each
// chain's residual window on chip, loads it from x (zero outside the
// utterance) chain by chain, and sums the three chains in shared memory.
//
// Bound on the card: operations, 252*B*T*C^2 int8 operations per level at
// 1979 TOP/s (plus the dynamic halos' recomputation, 2*halo/tile); x read
// and the output written take a fifth of that time at C = 64/32.
#include "mrf_dyn_blk.cuh"
#include "mrf_ptc_fused.cuh"

extern "C" int mrf_ct_q8_blk(MRF_DYN_BLK_ARGS) {
  mrf::blk::DynBlkParams p;
  if (c_in != C || !mrf::blk::dyn_blk_params(p, x, x_bs, t_in, amax0, sync, sum, sum_bs, out,
                                              out_bs, ptrs, ints, scale, post_bias, scratch,
                                              scratch_n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return mrf::blk::dyn_blk_entry<32, 32>(p, ints, slots, s);
    case 64: return mrf::blk::dyn_blk_entry<64, 64>(p, ints, slots, s);
    case 128: return mrf::blk::dyn_blk_entry<128, 128>(p, ints, slots, s);
    case 256: return mrf::blk::dyn_blk_entry<256, 256>(p, ints, slots, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q8f and (q8s != 0) q8s: ptc_fused_q8_kernel without prologue
extern "C" int mrf_ct_q8_fused(MRF_PTC_FUSED_ARGS) {
  MRF_PTC_FUSED_PARAMS(p);
  if (c_in == 64 && C == 64)
    return mrf::blk::ptc_fused_launch<64, 64>(p, ints, S, slots, q8s, stream);
  if (c_in == 32 && C == 32)
    return mrf::blk::ptc_fused_launch<32, 32>(p, ints, S, slots, q8s, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mrf_ct_q8_amax(const void* x, long long x_bs, int t_in, int c_in, int n_tiles,
                              int tile_in, int halo_in, int win_len, void* amax_bits, int S,
                              void* stream) {
  return (int)mrf::launch_amax(x, x_bs, t_in, c_in, n_tiles, tile_in, halo_in, win_len, amax_bits,
                               S, static_cast<cudaStream_t>(stream));
}
