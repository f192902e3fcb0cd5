// MRF group of one HiFi-GAN level in the int8 serving forms of fused_mrf_ct,
// for Hopper.
//
// Replaces daft_exprt_tpu/ops/vocoder_kernels.py::fused_mrf_ct with
// int8_chain=True (Pallas body _fused_mrf_ct_kernel) in two modes:
//
// q8 (int8-dynamic, no act scales): V1's L0/L1 (C=256, 128) and V2's L0
// (C=64) in the dynamic tier, C=32 where no phase tile divides the level.
// The function is one of the tile: for each tile of `tile` samples, the
// chains run on the window [-halo, tile + halo) of the zero-padded input
// (halo = the widest chain's reach rounded to 64, then to 128), each conv
// shrinking it by its reach per side, and each conv quantises its whole
// input window with one scale. The output is the tile's samples of the
// chain mean, bf16. The tiles are segments; amax_kernel (mrf_q8.cuh)
// takes the first scale over each window of x. Design at C = 256 and 128
// (mrf_ct_q8_blk): the segment-synchronised engine of mrf_dyn_blk.cuh,
// one launch per chain (1 + 3 for the V1 group). At C = 64 and 32: two
// launches of conv_dyn_kernel (mrf_dyn.cuh) per (chain, dilation) step,
// 1 + 18 for the V1/V2 group: conv1 writes its float32 window and reduces
// conv2's scale, conv2 adds the residual, writes the next window and
// reduces the next conv1's scale (or, at a chain's last step, writes the
// tile into the chain sum / the bf16 output).
//
// q8f (int8-static, act scales folded into the weights, the conv1 -> conv2
// boundary requantised in s32): V2's L0 (C=64) in the static tier, C=32
// where no phase tile divides the level. Static scales make the function
// the zero-padded valid chains of mrf_tc_q8.cu, whatever the tile; only the
// weights' packing (jitted, per-tap, vocoder_kernels.py:403-420) differs.
// Design: one launch of step_q8_kernel (mrf_q8.cuh) per (chain, dilation)
// step on the tc kernels' launch plan.
//
// q8s (int8-static with the round-3 boundary: dequantise, lrelu and
// requantise conv1's output in float32; JAX's DAFT_INT8_FUSED_EPI=0): the
// same function class as q8f, weights packed per conv as [wq, sw, inv, b]
// (vocoder_kernels.py:421-436). Design: step_q8_kernel<C, K, true>, one
// launch per (chain, dilation) step on the same plan.
//
// Bound on the card: operations at C=256/128 (252*B*T*C^2 int8 operations
// per level at 1979 TOP/s, plus the dynamic halos' recomputation,
// 2*halo/tile), device memory at C=64/32; the design moves ~9 (static) or
// ~20 (dynamic, conv_dyn_kernel) float32 passes over the level through
// device memory, which takes longer than the operations at every width;
// the engine keeps them on chip (mrf_dyn_blk.cuh).
#include "mrf_dyn.cuh"
#include "mrf_dyn_blk.cuh"

extern "C" int mrf_ct_q8_blk(MRF_DYN_BLK_ARGS) {
  mrf::blk::DynBlkParams p;
  if (c_in != C || !mrf::blk::dyn_blk_params(p, x, x_bs, t_in, amax0, sync, sum, sum_bs, out,
                                              out_bs, ptrs, ints, scale, post_bias, scratch,
                                              scratch_n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return mrf::blk::dyn_blk_entry<128, 128>(p, ints, slots, s);
    case 256: return mrf::blk::dyn_blk_entry<256, 256>(p, ints, slots, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mrf_ct_q8_amax(const void* x, long long x_bs, int t_in, int c_in, int n_tiles,
                              int tile_in, int halo_in, int win_len, void* amax_bits, int S,
                              void* stream) {
  return (int)mrf::launch_amax(x, x_bs, t_in, c_in, n_tiles, tile_in, halo_in, win_len, amax_bits,
                               S, static_cast<cudaStream_t>(stream));
}

extern "C" int mrf_ct_q8_conv(MRF_DYN_ARGS) {
  MRF_DYN_PARAMS(q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return (int)mrf::launch_conv_dyn_c<32>(q, K, S, s);
    case 64: return (int)mrf::launch_conv_dyn_c<64>(q, K, S, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mrf_ct_q8_step(MRF_Q8_STEP_ARGS) {
  MRF_Q8_PARAMS(q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return (int)mrf::launch_step_q8_c<32>(q, K, B, s);
    case 64: return (int)mrf::launch_step_q8_c<64>(q, K, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mrf_ct_q8_step_s(MRF_Q8S_STEP_ARGS) {
  MRF_Q8S_PARAMS(q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return (int)mrf::launch_step_q8_c<32, true>(q, K, B, s);
    case 64: return (int)mrf::launch_step_q8_c<64, true>(q, K, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
