// MRF group of one narrow HiFi-GAN level (C = 8..64) in float mode, for Hopper.
//
// Replaces two TPU kernels of daft_exprt_tpu/ops/vocoder_kernels.py that
// compute the same function:
//   - fused_mrf_ct (Pallas body _fused_mrf_ct_kernel), float modes, with
//     per-tap or merged-tap weights: HiFi-GAN V2's L0 (C=64) and the
//     levels whose length no phase tile divides (C=32, 16);
//   - fused_mrf_phase without the upsample prologue (in_phase=False, x in
//     (B, C, T); Pallas body _fused_mrf_phase_kernel), float mode: V2's
//     L1-L3 (C=32, 16, 8).
// Both pad x with zeros by a halo once per tile and run every ResBlock1
// chain by valid convs on the window, so each output sample is the
// zero-padded valid chains' value: the function of mrf_tc.cu. The tile,
// the halo, the phase layout and the merged taps change the summation order
// only.
//
// Design: one launch of mrf::step_kernel (mrf_common.cuh) per (chain,
// dilation) step, 9 for the V1/V2 group, on the tc kernel's launch plan
// (vocoder_kernels._tc_plan) over sample-major (B, T, C) tensors: the
// polyphase upsample before the level emits them. bf16 runs mma.sync
// m16n8k16, which reduces over 16 channels: C = 8 stages its activations
// as 16 channels with zero lanes 8..15 against zero weight rows
// (mrf_common.cuh gemm_cin), so 3/4 of its MMA work multiplies zeros.
// float32 runs the FMA twin.
//
// Bound on the card: device memory at these widths. 252*B*T*C^2 FLOPs per
// group against the level's input and output; the design moves ~9 float32
// read+write passes over (B, T + 2E, C) through device memory, which sets
// its pace.
#include "mrf_common.cuh"

extern "C" int mrf_ct_step(MRF_STEP_ARGS) {
  const mrf::StepParams p = MRF_STEP_PARAMS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return (int)mrf::launch_step_c<8>(p, K, B, cdt, in_f32, s);
    case 16: return (int)mrf::launch_step_c<16>(p, K, B, cdt, in_f32, s);
    case 32: return (int)mrf::launch_step_c<32>(p, K, B, cdt, in_f32, s);
    case 64: return (int)mrf::launch_step_c<64>(p, K, B, cdt, in_f32, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
