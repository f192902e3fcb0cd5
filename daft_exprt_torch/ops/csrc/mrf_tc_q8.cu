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
// Bound on the card: by the work, operations: 252*B*T*C^2 int8 operations
// per level (V1) at the dense int8 rate (x read and the output written are
// a tenth of that time). What bounds this kernel is in mrf_chain_q8.cuh.
//
// Design: one launch of tc_chain_q8_kernel per chain, 3 for the V1 group
// (vocoder_kernels._tc_q8_plan). A persistent block (one per SM) takes
// items of BM = 128 output samples of one utterance: it loads x over
// [n0 - halo, n0 + BM + halo) (zero outside the utterance) into a float32
// residual window, quantised for the first step as it lands, and runs the
// chain's steps on it (mrf_chain_q8.cuh); 16 warps, 4 warpgroups of
// wgmma m64n128k32 over 256 rows a pass. The chain's result goes to a
// float32 chain sum (WRITE, then ADD) or, for the last chain,
// (sum + chain) / 3 to the bfloat16 output (FINAL).
//   C = 128: the residual window (up to 248 x 136 floats) lives in shared
//     memory beside the two s8 tiles and a ring of two 16 KB weight stages
//     (one tap); 227 KB, one block per SM.
//   C = 256: the window (248 x 264 floats, 262 KB) does not fit beside the
//     s8 tiles and a 2 x 32 KB ring (one tap, 128 input channels); it lives
//     in a per-block slice of a global scratch (one slice per SM, ~35 MB,
//     held in L2); two passes of 128 rows (2 column groups of 128).
#include "mrf_chain_q8.cuh"

namespace mrf {
namespace blk {

// per C: warps, output samples per block, rows per warp (16: one m64 block
// per warpgroup), taps and input channels per weight stage, ring slots and
// the ring's lag (chosen on the card)
template <int C> struct TcCfg;
template <> struct TcCfg<128> {
  static constexpr int NW = 16, BM = 128, WM = 16, TPS = 1, KCH = 128, NBUF = 2, LAG = 0;
  static constexpr bool R_SMEM = true;
};
template <> struct TcCfg<256> {
  static constexpr int NW = 16, BM = 128, WM = 16, TPS = 1, KCH = 128, NBUF = 2, LAG = 0;
  static constexpr bool R_SMEM = false;
};

struct TcChainParams {
  const bf16* x;       // (B, T, C) bfloat16
  long long x_bs;
  int T;
  float* sum;          // (B, T, C) float32 chain sum
  long long sum_bs;
  bf16* out;           // (B, T, C) bfloat16 (FINAL)
  long long out_bs;
  int mode, has_acc;
  float scale;
  Step steps[kMaxSteps];
  int n_steps, k;
  float* scratch;      // !R_SMEM: per block (BM + 2*halo) x (C + 8) floats
  int n_tiles, n_items;
};

// the weight loads one block item consumes, in order (Pipe's schedule)
template <int C>
__host__ __device__ int tc_schedule(Ld* sched, const Step* steps, int n_steps, int k, int wrows) {
  using CF = TcCfg<C>;
  using CH = Chain<C, CF::NW, CF::WM, CF::TPS, CF::KCH>;
  int n = 0, lo = 0, hi = wrows;
  for (int i = 0; i < n_steps; ++i) {
    n = CH::schedule(sched, n, lo, hi, steps[i], k);
    lo += (steps[i].dil + 1) * ((k - 1) / 2);
    hi -= (steps[i].dil + 1) * ((k - 1) / 2);
  }
  return n;
}

template <int C>
__global__ void __launch_bounds__(TcCfg<C>::NW * 32, 1) tc_chain_q8_kernel(const TcChainParams p) {
  using CF = TcCfg<C>;
  using CH = Chain<C, CF::NW, CF::WM, CF::TPS, CF::KCH>;
  constexpr int RS = CH::RS, NTH = CF::NW * 32, BM = CF::BM, STAGE = CH::CV::STAGE;
  static_assert(NTH % (C / 8) == 0, "a thread's channels stay fixed over the x load");
  const int h = chain_halo(p.k, p.steps, p.n_steps);
  const int wrows = BM + 2 * h;
  // the ring first: its stages start on 1024-byte swizzle atoms
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  unsigned char* sp = smem + CF::NBUF * STAGE;
  float* R;
  if constexpr (CF::R_SMEM) {
    R = reinterpret_cast<float*>(sp);
    sp += (size_t)wrows * RS * 4;
  } else {
    R = p.scratch + (size_t)blockIdx.x * wrows * RS;
  }
  int8_t* A1 = reinterpret_cast<int8_t*>(sp);
  int8_t* A2 = A1 + wrows * C;
  Ld* sched = reinterpret_cast<Ld*>(A2 + wrows * C);
  const int n_sched = tc_schedule<C>(nullptr, p.steps, p.n_steps, p.k, wrows);
  if (threadIdx.x == 0) tc_schedule<C>(sched, p.steps, p.n_steps, p.k, wrows);
  __syncthreads();
  Pipe<CF::NBUF, STAGE, NTH, CF::LAG> pipe;
  pipe.start(ring, sched, n_sched);
  // this thread's 8 channels of the x load and step 0's multipliers there
  const int c8 = (threadIdx.x % (C / 8)) * 8;
  float2 inv[4], neg[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    inv[e] = __ldg(reinterpret_cast<const float2*>(p.steps[0].inv1 + c8) + e);
    neg[e] = neg2(inv[e]);
  }
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const int b = item / p.n_tiles;
    const int n0 = (item - b * p.n_tiles) * BM;
    // R rows [0, wrows) <- x samples [n0 - h, n0 + BM + h), zero outside
    // [0, T); A1 <- their quantize_lrelu_static with step 0's multipliers
    const bf16* xb = p.x + b * p.x_bs;
    constexpr int U = 4;
    for (int r0 = threadIdx.x / (C / 8); r0 < wrows; r0 += U * (NTH / (C / 8))) {
      uint4 raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u * (NTH / (C / 8)), s = n0 - h + r;
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        if (r < wrows && s >= 0 && s < p.T)
          raw[u] = __ldg(reinterpret_cast<const uint4*>(xb + (long long)s * C + c8));
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u * (NTH / (C / 8));
        if (r >= wrows) break;
        const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
        float2 f[4];
        uint32_t q[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          f[e] = __bfloat1622float2(v[e]);
          q[e] = q2(f[e].x, f[e].y, inv[e], neg[e]);
        }
        float* dst = R + r * RS + c8;
        *reinterpret_cast<float4*>(dst) = make_float4(f[0].x, f[0].y, f[1].x, f[1].y);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(f[2].x, f[2].y, f[3].x, f[3].y);
        *reinterpret_cast<uint2*>(A1 + swz<C>(r, c8)) =
            make_uint2(__byte_perm(q[0], q[1], 0x5410), __byte_perm(q[2], q[3], 0x5410));
      }
    }
    __syncthreads();
    int lo = 0, hi = wrows;
    const int half = (p.k - 1) / 2;
    for (int si = 0; si < p.n_steps; ++si) {
      const Step& st = p.steps[si];
      if (si + 1 < p.n_steps) {
        CH::step(pipe, R, lo, hi, st, p.k, A1, A2, hi - lo, p.steps[si + 1].inv1,
                 [](int, int, float, float) {});
      } else {
        float* sum = p.sum + b * p.sum_bs;
        bf16* out = p.out + b * p.out_bs;
        CH::step(pipe, R, lo, hi, st, p.k, A1, A2, hi - lo, nullptr,
                 [&](int m, int n, float v0, float v1) {
          const int s = n0 + m;
          if (s >= p.T) return;
          const long long o = (long long)s * C + n;
          if (p.mode == kWrite) {
            *reinterpret_cast<float2*>(sum + o) = make_float2(v0, v1);
          } else if (p.mode == kAdd) {
            const float2 q = *reinterpret_cast<const float2*>(sum + o);
            *reinterpret_cast<float2*>(sum + o) = make_float2(__fadd_rn(q.x, v0), __fadd_rn(q.y, v1));
          } else {
            if (p.has_acc) {
              const float2 q = *reinterpret_cast<const float2*>(sum + o);
              v0 = __fadd_rn(q.x, v0);
              v1 = __fadd_rn(q.y, v1);
            }
            __nv_bfloat162 w;
            w.x = __float2bfloat16_rn(__fmul_rn(v0, p.scale));
            w.y = __float2bfloat16_rn(__fmul_rn(v1, p.scale));
            *reinterpret_cast<__nv_bfloat162*>(out + o) = w;
          }
        });
      }
      lo += (st.dil + 1) * half;
      hi -= (st.dil + 1) * half;
    }
  }
  pipe.finish();
}

// shared memory of one block and the scratch floats of one block
template <int C>
void tc_chain_sizes(const TcChainParams& p, size_t& smem, size_t& scratch) {
  using CF = TcCfg<C>;
  const int h = chain_halo(p.k, p.steps, p.n_steps);
  const size_t wrows = CF::BM + 2 * h;
  const size_t r = wrows * (C + 8);
  const int n_sched = tc_schedule<C>(nullptr, p.steps, p.n_steps, p.k, (int)wrows);
  smem = 2 * wrows * C + (size_t)CF::NBUF * CF::TPS * C * CF::KCH + sizeof(Ld) * n_sched +
         (CF::R_SMEM ? 4 * r : 0);
  scratch = CF::R_SMEM ? 0 : r;
}

template <int C>
cudaError_t launch_tc_chain(TcChainParams& p, int B, int block_m, int tps, int kch,
                            long long scratch_floats, int slots, cudaStream_t stream) {
  using CF = TcCfg<C>;
  if (block_m != CF::BM || tps != CF::TPS || kch != CF::KCH) return cudaErrorInvalidValue;
  if (p.n_steps < 1 || p.n_steps > kMaxSteps || p.k < 1 || p.k % 2 == 0 || slots < 1)
    return cudaErrorInvalidValue;
  size_t smem, scratch;
  tc_chain_sizes<C>(p, smem, scratch);
  if (smem > 232448) return cudaErrorInvalidValue;
  p.n_tiles = (p.T + CF::BM - 1) / CF::BM;
  p.n_items = p.n_tiles * B;
  if (p.n_items <= 0) return cudaSuccess;
  const int grid = p.n_items < slots ? p.n_items : slots;
  if ((long long)scratch * grid > scratch_floats) return cudaErrorInvalidValue;
  const void* kern = reinterpret_cast<const void*>(&tc_chain_q8_kernel<C>);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  void* args[] = {&p};
  e = cudaLaunchKernel(kern, dim3(grid), dim3(CF::NW * 32), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace blk
}  // namespace mrf

// One chain of the group: wptrs holds 7 pointers per step (w1, inv1, b1i,
// m1, w2, sw2, b2; the taps in pack_stage_s8's order), dils the step
// dilations. block_m, tps and kch must be the kernel's (checked).
extern "C" int mrf_tc_q8_chain(const void* x, long long x_bs, int T, void* sum, long long sum_bs,
                               void* out, long long out_bs, int mode, int has_acc, float scale,
                               const long long* wptrs, const int* dils, int n_steps, int k, int C,
                               int B, int block_m, int tps, int kch, void* scratch,
                               long long scratch_floats, int slots, void* stream) {
  using namespace mrf::blk;
  if (n_steps < 1 || n_steps > kMaxSteps) return (int)cudaErrorInvalidValue;
  TcChainParams p = {};
  p.x = static_cast<const mrf::bf16*>(x);
  p.x_bs = x_bs;
  p.T = T;
  p.sum = static_cast<float*>(sum);
  p.sum_bs = sum_bs;
  p.out = static_cast<mrf::bf16*>(out);
  p.out_bs = out_bs;
  p.mode = mode;
  p.has_acc = has_acc;
  p.scale = scale;
  for (int i = 0; i < n_steps; ++i) {
    const long long* w = wptrs + 7 * i;
    p.steps[i] = Step{reinterpret_cast<const int8_t*>(w[0]), reinterpret_cast<const float*>(w[1]),
                      reinterpret_cast<const int*>(w[2]), reinterpret_cast<const float*>(w[3]),
                      reinterpret_cast<const int8_t*>(w[4]), reinterpret_cast<const float*>(w[5]),
                      reinterpret_cast<const float*>(w[6]), dils[i]};
  }
  p.n_steps = n_steps;
  p.k = k;
  p.scratch = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return (int)launch_tc_chain<128>(p, B, block_m, tps, kch, scratch_floats, slots, s);
    case 256: return (int)launch_tc_chain<256>(p, B, block_m, tps, kch, scratch_floats, slots, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
