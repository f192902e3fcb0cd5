// Shared pieces of the HiFi-GAN MRF kernels: the types, the lrelu slope and
// the modes in which a chain's result leaves a kernel. Every level runs on
// a block-resident engine (mrf_chain_bf16.cuh, mrf_chain_f32.cuh,
// mrf_chain_q8.cuh, mrf_dyn_blk.cuh) that keeps a ResBlock1 chain,
//     out[n] = in[n] + conv2_k(lrelu(conv1_{k,d}(lrelu(in))))[n] per step,
// on chip.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace mrf {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr float kSlope = 0.1f;

__device__ __forceinline__ float lrelu(float x) { return x >= 0.f ? x : kSlope * x; }

// how a chain kernel's result leaves it: written into the float32 chain
// sum, added to it, or (the level's last chain) added and scaled into the
// output
enum StepMode { kWrite = 0, kAdd = 1, kFinal = 2 };

}  // namespace mrf
