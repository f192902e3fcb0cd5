// MRF group of one wide HiFi-GAN level in (B, T, C) layout, for Hopper.
//
// Replaces daft_exprt_tpu/ops/vocoder_kernels.py::fused_mrf_tc (Pallas body
// _fused_mrf_tc_kernel), float mode. The function: pad x with zeros by each
// chain's receptive field once, run every ResBlock1 chain (k in {3,7,11},
// d in {1,3,5}) with valid convs on a float32 residual stream (conv inputs
// lrelu'd and cast to x's dtype, f32 accumulation + bias), average the
// chains and cast to x's dtype.
//
// Design, bf16 compute: one launch of tc_bf_kernel (mrf_chain_bf16.cuh)
// per chain, 3 for the V1 group (vocoder_kernels._tc_bf_plan). A
// persistent block (one per SM) takes items of bm output samples of one
// utterance (bm per chain: the largest window the block's shared memory
// holds): it loads x over [n0 - halo, n0 + bm + halo) (zero
// outside the utterance) into the float32 residual window and its lrelu
// into the bf16 tile, runs the chain's steps on them on chip, and writes
// the chain into its own float32 buffer (WRITE) or, for the last chain,
// ((chain 0 + chain 1) + chain 2) / 3 in bf16 (FINAL), reading the earlier
// chains' buffers, which the launch does not write. The window lives in
// shared memory at C = 128 and in a per-block slice of an L2-resident
// scratch at C = 256 (TC_BF_CFG).
//
// float32 compute: one launch of tc_f32_kernel (mrf_chain_f32.cuh) per
// chain, the same blocks, windows and sinks with the window's conv input
// in a float32 tile and every product in 3xTF32 on the tensor cores
// (vocoder_kernels._tc_f32_plan). The same launches replace
// fused_resblock1 (Pallas body _fused_resblock_kernel) in both dtypes: one
// chain (one k, its dilations), zero padding once, valid convs, no mean:
// a group of one chain, a single FINAL launch with scale 1 and no chain
// buffers.
//
// Bound on the card: operations. 252*B*T*C^2 FLOPs per level (V1) at the
// bf16 tensor-core rate (float32: at a third of the TF32 rate); x read once
// and the output written once are a tenth of that time. What bounds the
// engines is in PERF.md (section 6; scripts/torch_mrf_ablation.py, section
// bf16).
#include "mrf_chain_f32.cuh"

// One chain of the bf16 group: wptrs holds 4 pointers per step (w1, b1, w2,
// b2; the taps in pack_stage_bf16's order), dils the step dilations. tps,
// kch and r_smem must be the kernel's (checked).
extern "C" int mrf_tc_bf_chain(const void* x, long long x_bs, int T, void* sum, long long sum_bs,
                               long long sum_cs, void* out, long long out_bs, int mode, int n_acc,
                               float scale,
                               const long long* wptrs, const int* dils, int n_steps, int k, int C,
                               int B, int block_m, int r_smem, int tps, int kch, void* scratch,
                               long long scratch_floats, int slots, void* stream) {
  using namespace mrf::bfe;
  if (n_steps < 1 || n_steps > kMaxSteps) return (int)cudaErrorInvalidValue;
  TcBfParams p = {};
  p.x = static_cast<const mrf::bf16*>(x);
  p.x_bs = x_bs;
  p.T = T;
  p.sum = static_cast<float*>(sum);
  p.sum_bs = sum_bs;
  p.sum_cs = sum_cs;
  p.out = static_cast<mrf::bf16*>(out);
  p.out_bs = out_bs;
  p.mode = mode;
  p.n_acc = n_acc;
  p.scale = scale;
  for (int i = 0; i < n_steps; ++i) {
    const long long* w = wptrs + 4 * i;
    p.steps[i] = StepBf{reinterpret_cast<const int8_t*>(w[0]), reinterpret_cast<const float*>(w[1]),
                        reinterpret_cast<const int8_t*>(w[2]), reinterpret_cast<const float*>(w[3]),
                        dils[i]};
  }
  p.n_steps = n_steps;
  p.k = k;
  p.bm = block_m;
  p.scratch = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return (int)launch_tc_bf<128>(p, B, tps, kch, r_smem, scratch_floats, slots, s);
    case 256: return (int)launch_tc_bf<256>(p, B, tps, kch, r_smem, scratch_floats, slots, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One chain of the float32 group (or fused_resblock1's one chain): the
// arguments of mrf_tc_bf_chain, the taps in pack_stage_tf32's order. kch
// must be the kernel's (checked).
extern "C" int mrf_tc_f32_chain(const void* x, long long x_bs, int T, void* sum, long long sum_bs,
                                long long sum_cs, void* out, long long out_bs, int mode, int n_acc,
                                float scale, const long long* wptrs, const int* dils, int n_steps,
                                int k, int C, int B, int block_m, int kch, void* scratch,
                                long long scratch_floats, int slots, void* stream) {
  using namespace mrf::f32e;
  if (n_steps < 1 || n_steps > kMaxSteps) return (int)cudaErrorInvalidValue;
  TcF32Params p = {};
  p.x = static_cast<const float*>(x);
  p.x_bs = x_bs;
  p.T = T;
  p.sum = static_cast<float*>(sum);
  p.sum_bs = sum_bs;
  p.sum_cs = sum_cs;
  p.out = static_cast<float*>(out);
  p.out_bs = out_bs;
  p.mode = mode;
  p.n_acc = n_acc;
  p.scale = scale;
  for (int i = 0; i < n_steps; ++i) {
    const long long* w = wptrs + 4 * i;
    p.steps[i] = StepBf{reinterpret_cast<const int8_t*>(w[0]), reinterpret_cast<const float*>(w[1]),
                        reinterpret_cast<const int8_t*>(w[2]), reinterpret_cast<const float*>(w[3]),
                        dils[i]};
  }
  p.n_steps = n_steps;
  p.k = k;
  p.bm = block_m;
  p.scratch = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return (int)launch_tc_f32<128>(p, B, kch, scratch_floats, slots, s);
    case 256: return (int)launch_tc_f32<256>(p, B, kch, scratch_floats, slots, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
