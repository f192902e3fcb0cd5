// MRF group of one wide HiFi-GAN level in the int8-dynamic serving form,
// for Hopper.
//
// Replaces daft_exprt_tpu/ops/vocoder_kernels.py::fused_mrf_ct with
// int8_chain=True and no act scales (Pallas body _fused_mrf_ct_kernel, q8
// branch). The function is one of the tile: for each tile of `tile`
// samples, the chains run on the window [-halo, tile + halo) of the
// zero-padded input (halo = the widest chain's reach rounded to 64, then
// to 128), each conv shrinking it by its reach per side, and each conv
// quantises its whole input window with one scale. The output is the
// tile's samples of the chain mean, bf16.
//
// Design: the tiles are segments; amax_kernel (mrf_q8.cuh) takes the first
// scale over each window of x, then two launches of conv_dyn_kernel
// (mrf_dyn.cuh) per (chain, dilation) step, 1 + 18 for the V1 group: conv1
// writes its float32 window and reduces conv2's scale, conv2 adds the
// residual, writes the next window and reduces the next conv1's scale (or,
// at a chain's last step, writes the tile into the chain sum / the bf16
// output).
//
// Bound on the card: operations. 252*B*T*C^2 int8 operations per level
// (V1) at 1979 TOP/s, plus the halos' recomputation (2*halo/tile: 6-12%);
// the design moves ~20 float32 passes over the segments through device
// memory, which takes longer than the operations at these widths.
#include "mrf_dyn.cuh"

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
    case 128: return (int)mrf::launch_conv_dyn_c<128>(q, K, S, s);
    case 256: return (int)mrf::launch_conv_dyn_c<256>(q, K, S, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
