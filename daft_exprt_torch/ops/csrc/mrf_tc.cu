// MRF group of one wide HiFi-GAN level in (B, T, C) layout, for Hopper.
//
// Replaces daft_exprt_tpu/ops/vocoder_kernels.py::fused_mrf_tc (Pallas body
// _fused_mrf_tc_kernel), float mode. The function: pad x with zeros by each
// chain's receptive field once, run every ResBlock1 chain (k in {3,7,11},
// d in {1,3,5}) with valid convs on a float32 residual stream (conv inputs
// lrelu'd and cast to x's dtype, f32 accumulation + bias), average the
// chains and cast to x's dtype.
//
// Design: one launch of mrf::step_kernel per (chain, dilation) step, 9 for
// the V1 group; the Python wrapper (vocoder_kernels.fused_mrf_tc) owns the
// sample ranges, so every step computes exactly the samples the later steps
// read and the first step reads x with zero padding. The last step of each
// chain adds into a float32 chain sum and the last chain's last step writes
// the mean in x's dtype.
//
// The same step launches replace fused_resblock1 (Pallas body
// _fused_resblock_kernel): one chain (one k, its dilations), zero padding
// once, valid convs, no mean; vocoder_kernels.fused_resblock1 plans it as
// a group of one chain.
//
// Bound on the card: operations. 252*B*T*C^2 FLOPs per level (V1) against
// HBM traffic of ~9 float32 read+write passes over (B, T, C); at C=128 the
// FLOPs take ~5x the bytes' time at peak rates.
#include "mrf_common.cuh"

extern "C" int mrf_tc_step(MRF_STEP_ARGS) {
  const mrf::StepParams p = MRF_STEP_PARAMS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return (int)mrf::launch_step_c<128>(p, K, B, cdt, in_f32, s);
    case 256: return (int)mrf::launch_step_c<256>(p, K, B, cdt, in_f32, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
