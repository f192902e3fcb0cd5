// MRF group of one wide HiFi-GAN level in the int8-static serving form,
// (B, T, C) layout, for Hopper.
//
// Replaces daft_exprt_tpu/ops/vocoder_kernels.py::fused_mrf_tc with
// q8=True (Pallas body _fused_mrf_tc_kernel, q8 branch). The function: pad
// x with zeros by the chains' receptive field once, run every ResBlock1
// chain (k in {3,7,11}, d in {1,3,5}) with valid convs on a float32
// residual stream, each conv an s8 x s8 -> s32 product of statically
// quantised activations (act scales folded into the weights' input
// channels, weights quantised per output channel), the conv1 -> conv2
// boundary requantised in the s32 domain; average the chains, cast to
// bfloat16.
//
// Design: one launch of mrf::step_q8_kernel (mrf_q8.cuh) per (chain,
// dilation) step, 9 for the V1 group, on the launch plan the bf16 route
// uses (vocoder_kernels._tc_plan); the first step reads x (bf16) with zero
// padding, later steps the float32 residual buffers.
//
// Bound on the card: operations. 252*B*T*C^2 int8 operations per level (V1)
// against ~9 float32 read+write passes over (B, T, C); at C=128 the
// operations at the dense int8 rate (1979 TOPS) take about as long as
// those bytes at 3.35 TB/s, so the f32 residual traffic is the next limit.
#include "mrf_q8.cuh"

extern "C" int mrf_tc_q8_step(MRF_Q8_STEP_ARGS) {
  MRF_Q8_PARAMS(q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return (int)mrf::launch_step_q8_c<128>(q, K, B, s);
    case 256: return (int)mrf::launch_step_q8_c<256>(q, K, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
