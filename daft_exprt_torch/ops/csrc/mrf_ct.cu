// MRF group of one HiFi-GAN level that takes no fused upsample (C = 64..8),
// in float mode, for Hopper.
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
// only. The port keeps the level sample-major, (B, T, C), as the polyphase
// upsample before it emits it.
//
// Design: one launch a level, all three chains on chip
// (vocoder_kernels._ct_plan). A persistent block takes items of bm output
// samples of one utterance; per chain it loads x over the chain's window
// into a float32 residual window and the conv tile, runs the chain's steps
// on them by valid convs, and adds the chain into a float32 sum; the last
// chain's last conv writes the mean. Only x is read (once per chain) and
// only the mean written.
// One kernel, ct_kernel (mrf_ct.cuh), over the chains of the input's type:
//   - bf16: CtBf, the bf16 engine's chains (mrf_chain_bf16.cuh) on wgmma
//     m64nCk16 with both operands in shared memory; at C = 8 a k16 step
//     reads a pair of taps (ConvSS::PAIR), not 16 channels with a zero
//     half. The float32 windows live in shared memory at every width.
//   - float32: CtF32, the float32 chains (mrf_chain_f32.cuh) on mma.sync
//     m16n8k8 in 3xTF32, the conv tile in float32; the windows in shared
//     memory at C <= 16 and in an L2-resident scratch slice per block at C =
//     64 and 32, where shared memory leaves a block a third of the samples.
// At the narrow widths a stage's MMAs are few and a pass short, so a
// warpgroup takes several 64-row groups a pass (CtBfCfg::MG; TcF32Cfg::MT
// in float32) and the weight ring more slots. bm is planned per level
// (vocoder_kernels.ct_block: waves of items x weight stages), which spreads
// V2's short L0 over the card. The placements and configurations are the
// ones that timed best (PERF.md, scripts/torch_ct_levels.py).
//
// Bound on the card: 252*B*T*C^2 FLOPs a level against x read and the mean
// written once, and at C <= 32 the shared-memory bytes the wgmma read (a 2
// KB A tile per m64nCk16 for C output columns) above both (PERF.md,
// section 7).
#include "mrf_ct.cuh"

// The launch's fields from the entry's arrays: ptrs 4 per step of each
// chain (w1, b1, w2, b2); ints block_m, the 3 stage ints (taps and input
// channels per stage, r_smem: checked by the launch), n_chains, then per
// chain k, n_steps, dils[4] (mrf_ct.py _ct_args). False for a malformed
// call.
template <typename E>
static bool ct_params(mrf::ct::CtParams<E>& p, const void* x, long long x_bs, int T, void* out,
                      long long out_bs, const long long* ptrs, const int* ints, float scale,
                      void* scratch) {
  using mrf::bfe::StepBf;
  p.x = static_cast<const E*>(x);
  p.x_bs = x_bs;
  p.T = T;
  p.out = static_cast<E*>(out);
  p.out_bs = out_bs;
  p.scale = scale;
  p.bm = ints[0];
  p.n_chains = ints[4];
  p.scratch = static_cast<float*>(scratch);
  if (p.n_chains < 1 || p.n_chains > mrf::bfe::kMaxChains) return false;
  const long long* w = ptrs;
  for (int j = 0; j < p.n_chains; ++j) {
    const int* cj = ints + 5 + 6 * j;
    p.k[j] = cj[0];
    p.n_steps[j] = cj[1];
    if (p.n_steps[j] < 1 || p.n_steps[j] > mrf::bfe::kMaxSteps) return false;
    for (int i = 0; i < p.n_steps[j]; ++i, w += 4)
      p.steps[j][i] = StepBf{reinterpret_cast<const int8_t*>(w[0]), reinterpret_cast<const float*>(w[1]),
                             reinterpret_cast<const int8_t*>(w[2]), reinterpret_cast<const float*>(w[3]),
                             cj[2 + i]};
  }
  return true;
}

// The level in one launch on the chains Tr<C>, C from the built widths.
template <template <int> class Tr>
static int launch_level(const void* x, long long x_bs, int T, void* out, long long out_bs,
                        const long long* ptrs, const int* ints, float scale, int C, int B,
                        void* scratch, long long scratch_floats, int slots, void* stream) {
  using namespace mrf::ct;
  CtParams<typename Tr<8>::E> p = {};
  if (!ct_params(p, x, x_bs, T, out, out_bs, ptrs, ints, scale, scratch))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 64: return (int)launch_ct<Tr<64>>(p, B, ints + 1, scratch_floats, slots, s);
    case 32: return (int)launch_ct<Tr<32>>(p, B, ints + 1, scratch_floats, slots, s);
    case 16: return (int)launch_ct<Tr<16>>(p, B, ints + 1, scratch_floats, slots, s);
    case 8: return (int)launch_ct<Tr<8>>(p, B, ints + 1, scratch_floats, slots, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 level (the taps in pack_stage_bf16's order, at C = 8
// pack_stage_bf16_pairs').
extern "C" int mrf_ct_bf(const void* x, long long x_bs, int T, void* out, long long out_bs,
                         const long long* ptrs, const int* ints, float scale, int C, int B,
                         void* scratch, long long scratch_floats, int slots, void* stream) {
  return launch_level<mrf::ct::CtBf>(x, x_bs, T, out, out_bs, ptrs, ints, scale, C, B, scratch,
                                     scratch_floats, slots, stream);
}

// The float32 level (the taps in pack_stage_tf32's order).
extern "C" int mrf_ct_f32(const void* x, long long x_bs, int T, void* out, long long out_bs,
                          const long long* ptrs, const int* ints, float scale, int C, int B,
                          void* scratch, long long scratch_floats, int slots, void* stream) {
  return launch_level<mrf::ct::CtF32>(x, x_bs, T, out, out_bs, ptrs, ints, scale, C, B, scratch,
                                      scratch_floats, slots, stream);
}
