// The MRF group of a level without upsample in one launch (mrf_ct.cu:
// fused_mrf_ct and fused_mrf_phase without prologue, C = 64..8): one kernel,
// ct_kernel, over a traits type that names the chains it runs:
//   - CtBf<C>: the bf16 engine's chains (mrf_chain_bf16.cuh ChainBf, wgmma
//     with both operands in shared memory; at C = 8 a k16 step reads a tap
//     pair), x and out in bf16; the float32 windows in shared memory;
//   - CtF32<C>: the float32 chains (mrf_chain_f32.cuh ChainF32, mma.sync in
//     3xTF32), x and out in float32; the float32 windows in shared memory
//     at C <= 16, in the block's L2-resident scratch slice at C = 64 and 32
//     (CtF32Cfg), where shared memory leaves a block a third of the samples.
// A traits type holds what differs: the chain type, the element type, the
// window loader, the conv tile's row bytes and rows, the weight ring, the
// placement of the float32 windows, the taps the chains take and whether a
// chain's shape is made warp-uniform (the wgmma's need).
#pragma once

#include "mrf_chain_f32.cuh"

namespace mrf {
namespace ct {

using blk::Ld;
using blk::Pipe;
using bfe::chain_halo;
using bfe::kMaxChains;
using bfe::kMaxSteps;
using bfe::kSmemMax;
using bfe::StepBf;
using bfe::SumSink;

// x and out (B, T, C) sample-major, every chain of the group in one launch;
// E: bf16 or float.
template <typename E>
struct CtParams {
  const E* x;
  long long x_bs;
  int T;
  E* out;
  long long out_bs;
  float scale;
  StepBf steps[kMaxChains][kMaxSteps];
  int k[kMaxChains], n_steps[kMaxChains], n_chains;
  int bm;
  float* scratch;      // per block: CtLayout::slice floats (none in shared memory)
  int n_tiles, n_items;
};

// the weight loads one block item consumes, in order: each chain's steps on
// its own window, rows [0, bm + 2*halo) (CH: ChainBf or ChainF32)
template <class CH, typename E>
__host__ __device__ int ct_schedule(Ld* sched, const CtParams<E>& p) {
  int n = 0;
  for (int j = 0; j < p.n_chains; ++j) {
    const int k = p.k[j], half = (k - 1) / 2;
    int lo = 0, hi = p.bm + 2 * chain_halo(k, p.steps[j], p.n_steps[j]);
    for (int i = 0; i < p.n_steps[j]; ++i) {
      n = CH::schedule(sched, n, lo, hi, p.steps[j][i], k);
      lo += (p.steps[j][i].dil + 1) * half;
      hi -= (p.steps[j][i].dil + 1) * half;
    }
  }
  return n;
}

// The last chain's sink: ((the earlier chains' sum S, rows RS floats apart;
// none when first) + chain) * scale in the output type, sample-major from
// the block's first sample; len: the utterance's samples from there.
template <int C, int RS, typename O>
struct CtOutSink {
  const float* S;
  O* out;
  int len;
  bool first;
  float scale;
  __device__ __forceinline__ float2 load(int m, int n, bool valid) const {
    return first ? make_float2(0.f, 0.f)
                 : *reinterpret_cast<const float2*>(S + (valid ? m : 0) * RS + n);
  }
  __device__ __forceinline__ void store(int m, int n, float2 q, float v0, float v1,
                                        bool valid) const {
    if (!first) {
      v0 = __fadd_rn(q.x, v0);
      v1 = __fadd_rn(q.y, v1);
    }
    bfe::put_out(out + (long long)m * C + n, __fmul_rn(v0, scale), __fmul_rn(v1, scale),
                 valid && m < len);
  }
};

// bf16, per C: warps, taps (C = 8: tap pairs) and input channels per weight
// stage, ring slots, the ring's lag, 64-row groups per warpgroup and pass;
// output samples per block are the plan's (vocoder_kernels.CT_BF_CFG
// mirrors this). The narrow widths' stages are small and their passes
// short: more slots keep the copies ahead, more row groups put more MMAs
// and epilogue rows between two barriers. At C = 64 and 32 the stages are
// phase_bf_kernel's chains' (PhaseBfCfg): a chain level's weights serve its
// fallback to this kernel.
template <int C> struct CtBfCfg;
template <> struct CtBfCfg<64> {
  static constexpr int NW = 16, TPS = 2, KCH = 64, NBUF = 3, LAG = 1, MG = 2;
};
template <> struct CtBfCfg<32> {
  static constexpr int NW = 16, TPS = 3, KCH = 32, NBUF = 4, LAG = 1, MG = 2;
};
template <> struct CtBfCfg<16> {
  static constexpr int NW = 16, TPS = 3, KCH = 16, NBUF = 6, LAG = 1, MG = 4;
};
template <> struct CtBfCfg<8> {
  static constexpr int NW = 16, TPS = 2, KCH = 16, NBUF = 6, LAG = 1, MG = 4;
};

// float32, per C: whether the float32 windows (the residual and the chain
// sum) live in shared memory, else in the block's scratch slice; the
// chains' geometry is TcF32Cfg<C> (vocoder_kernels.CT_F32_R_SMEM mirrors
// this)
template <int C> struct CtF32Cfg;
template <> struct CtF32Cfg<64> {
  static constexpr bool R_SMEM = false;
};
template <> struct CtF32Cfg<32> {
  static constexpr bool R_SMEM = false;
};
template <> struct CtF32Cfg<16> {
  static constexpr bool R_SMEM = true;
};
template <> struct CtF32Cfg<8> {
  static constexpr bool R_SMEM = true;
};

template <int C>
struct CtBf {
  using CF = CtBfCfg<C>;
  using CH = bfe::ChainBf<C, CF::NW, CF::TPS, CF::KCH, CF::MG>;
  using E = bf16;
  using A_t = int8_t;
  static constexpr int WIDTH = C, NW = CF::NW, TPS = CF::TPS, KCH = CF::KCH, NBUF = CF::NBUF,
                       LAG = CF::LAG;
  static constexpr int RS = CH::RS;        // floats a window row
  static constexpr int A_ROW = 2 * C;      // bytes a conv tile row
  static constexpr bool R_SMEM = true;
  // the conv tile's rows for a chain window of w rows: its row groups'
  // granule
  __host__ __device__ static int tile(int w, int k, const StepBf* st, int n) {
    return bfe::tile_rows(w, k, st, n, 64 * CF::MG);
  }
  static bool taps_ok(int k) { return k >= 3 && k % 2 && CH::CV::vtaps(k) >= TPS; }
  // a value known to be the same across the warp (a wgmma under a branch
  // the compiler cannot prove uniform is serialised)
  static __device__ __forceinline__ int uniform(int v) { return __shfl_sync(0xffffffffu, v, 0); }
  // R rows [0, wrows) <- x samples [s0, s0 + wrows), zero outside [0, T); A
  // <- their lrelu in bf16, then visible to the wgmma's async proxy
  template <int NTH>
  static __device__ __forceinline__ void load(float* R, A_t* A, int rt, const E* xb, int s0,
                                              int wrows, int T) {
    bfe::load_window<C, RS, NTH>(R, A, rt, xb, s0, wrows, T);
    bfe::fence_async();
  }
  template <bool LAST, class P, class Sink>
  static __device__ __forceinline__ void step(P& pipe, float* R, int lo, int hi, const StepBf& st,
                                              int k, A_t* A, int rt, const Sink& sink) {
    CH::template step<LAST>(pipe, R, lo, hi, st, k, A, rt, sink);
  }
};

template <int C>
struct CtF32 {
  using CF = f32e::TcF32Cfg<C>;
  using CH = f32e::ChainF32<C>;
  using E = float;
  using A_t = float;
  static constexpr int WIDTH = C, NW = CF::NW, TPS = 1, KCH = CF::KCH, NBUF = CF::NBUF, LAG = 0;
  static constexpr int RS = C;
  static constexpr int A_ROW = CH::AS * 4;
  static constexpr bool R_SMEM = CtF32Cfg<C>::R_SMEM;
  __host__ __device__ static int tile(int w, int, const StepBf*, int) { return w; }
  static bool taps_ok(int k) { return k >= 1 && k % 2; }
  static __device__ __forceinline__ int uniform(int v) { return v; }
  template <int NTH>
  static __device__ __forceinline__ void load(float* R, A_t* A, int, const E* xb, int s0,
                                              int wrows, int T) {
    f32e::load_window_f32<C, CH::AS, NTH>(R, A, xb, s0, wrows, T);
  }
  template <bool LAST, class P, class Sink>
  static __device__ __forceinline__ void step(P& pipe, float* R, int lo, int hi, const StepBf& st,
                                              int k, A_t* A, int, const Sink& sink) {
    CH::template step<LAST>(pipe, R, lo, hi, st, k, A, sink);
  }
};

// shared memory: ring | A (rt: the chains' widest conv tile, rows of A_ROW
// bytes) | R (the widest window) and O (the chain sum, bm rows), rows of RS
// floats, when R_SMEM | schedule. Else R and O are the block's scratch
// slice. fits: the launch takes it (vocoder_kernels._ct_bf_smem and
// _ct_f32_smem mirror this; a CPU test compiles it for the host to hold
// them equal).
template <class Tr>
struct CtLayout {
  using CH = typename Tr::CH;
  int wrows, rt;
  size_t ring, a, r, o, total, slice;
  bool fits;
  __host__ __device__ CtLayout(const CtParams<typename Tr::E>& p) {
    wrows = 0;
    rt = 0;
    for (int j = 0; j < p.n_chains; ++j) {
      const int w = p.bm + 2 * chain_halo(p.k[j], p.steps[j], p.n_steps[j]);
      const int t = Tr::tile(w, p.k[j], p.steps[j], p.n_steps[j]);
      wrows = wrows > w ? wrows : w;
      rt = rt > t ? rt : t;
    }
    ring = (size_t)Tr::NBUF * CH::CV::STAGE;
    a = (size_t)rt * Tr::A_ROW;
    r = Tr::R_SMEM ? (size_t)wrows * Tr::RS * 4 : 0;
    o = Tr::R_SMEM ? (size_t)p.bm * Tr::RS * 4 : 0;
    total = ring + a + r + o + sizeof(Ld) * (size_t)ct_schedule<CH>(nullptr, p);
    slice = Tr::R_SMEM ? 0 : (size_t)(wrows + p.bm) * Tr::RS;
    fits = total <= (size_t)kSmemMax;
  }
};

// A persistent block takes items of bm output samples of one utterance. Per
// chain it loads x over the chain's window [n0 - halo, n0 + bm + halo)
// (zero outside the utterance) into the residual window R and its lrelu
// into the tile A, runs the chain's steps on them, and adds the chain into
// the sum O; the last chain's last conv writes the mean straight to out.
// Only x is read (once per chain, from L2 after the first) and only the
// mean written.
template <class Tr>
__global__ void __launch_bounds__(Tr::NW * 32, 1) ct_kernel(const CtParams<typename Tr::E> p) {
  using L_t = CtLayout<Tr>;
  using CH = typename Tr::CH;
  using E = typename Tr::E;
  using A_t = typename Tr::A_t;
  constexpr int C = Tr::WIDTH, RS = Tr::RS, NTH = Tr::NW * 32;
  const L_t L(p);
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  A_t* A = reinterpret_cast<A_t*>(smem + L.ring);
  float* R;
  if constexpr (Tr::R_SMEM) {
    R = reinterpret_cast<float*>(smem + L.ring + L.a);
  } else {
    R = p.scratch + (size_t)blockIdx.x * L.slice;
  }
  float* O = R + (size_t)L.wrows * RS;
  Ld* sched = reinterpret_cast<Ld*>(smem + L.ring + L.a + L.r + L.o);
  const int n_sched = ct_schedule<CH>(nullptr, p);
  if (threadIdx.x == 0) ct_schedule<CH>(sched, p);
  __syncthreads();
  Pipe<Tr::NBUF, CH::CV::STAGE, NTH, Tr::LAG> pipe;
  pipe.start(ring, sched, n_sched);
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const int b = item / p.n_tiles;
    const int n0 = (item - b * p.n_tiles) * p.bm;
    const E* xb = p.x + b * p.x_bs;
    for (int j = 0; j < p.n_chains; ++j) {
      const int k = Tr::uniform(p.k[j]), half = (k - 1) / 2;
      const int n_steps = Tr::uniform(p.n_steps[j]);
      const int h = chain_halo(k, p.steps[j], n_steps);
      const int wrows = p.bm + 2 * h;
      Tr::template load<NTH>(R, A, L.rt, xb, n0 - h, wrows, p.T);
      __syncthreads();
      const SumSink<RS> sum{O, j == 0};
      const CtOutSink<C, RS, E> fin{O, p.out + b * p.out_bs + (long long)n0 * C, p.T - n0, j == 0,
                                    p.scale};
      const bool last = j + 1 == p.n_chains;
      int lo = 0, hi = wrows;
      for (int si = 0; si < n_steps; ++si) {
        const StepBf& st = p.steps[j][si];
        if (si + 1 < n_steps)
          Tr::template step<false>(pipe, R, lo, hi, st, k, A, L.rt, sum);
        else if (!last)
          Tr::template step<true>(pipe, R, lo, hi, st, k, A, L.rt, sum);
        else
          Tr::template step<true>(pipe, R, lo, hi, st, k, A, L.rt, fin);
        lo += (st.dil + 1) * half;
        hi -= (st.dil + 1) * half;
      }
    }
  }
  pipe.finish();
}

// cfg: taps and input channels per weight stage and whether the float32
// windows live in shared memory (vocoder_kernels._ct_args), checked against
// the traits.
template <class Tr>
cudaError_t launch_ct(CtParams<typename Tr::E>& p, int B, const int* cfg,
                      long long scratch_floats, int slots, cudaStream_t stream) {
  using E = typename Tr::E;
  if (cfg[0] != Tr::TPS || cfg[1] != Tr::KCH || cfg[2] != (int)Tr::R_SMEM || p.bm < 8 ||
      p.bm % 8 || slots < 1 || p.n_chains < 1 || p.n_chains > kMaxChains)
    return cudaErrorInvalidValue;
  for (int j = 0; j < p.n_chains; ++j)
    if (p.n_steps[j] < 1 || p.n_steps[j] > kMaxSteps || !Tr::taps_ok(p.k[j]))
      return cudaErrorInvalidValue;
  // 16-byte rows (uint4 / float4 loads)
  if (reinterpret_cast<uintptr_t>(p.x) % 16 || p.x_bs % (16 / (long long)sizeof(E)))
    return cudaErrorInvalidValue;
  const CtLayout<Tr> L(p);
  if (!L.fits) return cudaErrorInvalidValue;
  p.n_tiles = (p.T + p.bm - 1) / p.bm;
  p.n_items = p.n_tiles * B;
  if (p.n_items <= 0) return cudaSuccess;
  const int grid = p.n_items < slots ? p.n_items : slots;
  if ((long long)L.slice * grid > scratch_floats) return cudaErrorInvalidValue;
  const void* kern = reinterpret_cast<const void*>(&ct_kernel<Tr>);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return e;
  void* args[] = {&p};
  e = cudaLaunchKernel(kern, dim3(grid), dim3(Tr::NW * 32), args, L.total, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace ct
}  // namespace mrf
