// The segment-synchronised int8-dynamic MRF engine for Hopper: the q8
// (dynamic) route of mrf_ct_q8.cu (fused_mrf_ct, C = 256/128/64/32) and of
// mrf_phase_q8.cu (fused_mrf_phase with its upsample prologue at (C_in, C)
// = (128, 64) / (64, 32), and without it at C = 64/32).
//
// The function (mrf_int8.mrf_ct_q8_plain / mrf_phase_q8_plain /
// mrf_phase_q8_noups_plain): per tile segment, the chains run on the
// segment's window X of x0 (ct: the zero-padded x over [-halo, tile +
// halo); phase: the int8 upsample of the tile's input window over
// [-halo*p, (tile + halo)*p), or without the prologue the zero-padded x
// over that window), and every conv quantises its whole input window with
// one scale, amax |lrelu(in)| / 127 over the window (the windows shrink
// conv by conv, the phase kernel's by whole phase columns:
// mrf_int8._dyn_windows). So a conv's scale depends on every sample of the
// previous conv in the segment, which no block holds alone.
//
// Design. The arithmetic per sample is the TPU kernel's:
//     q   = rint(lrelu(in) * (127/amax_in))              s8, no clip
//     v   = fma(acc, sw*amax_in/127, bias) (+ residual)  f32
// with the s32 sums exact in any order, so every output equals the plain
// version's bit for bit. What changes is where the data lives:
//   - Blocks own bm samples of X each (G blocks a segment, the last one
//     ragged) and keep a chain's residual window, their bm samples plus the
//     chain's remaining reach per side, on chip (mrf_chain_q8.cuh's Chain
//     storage: float32 R, s8 A1/A2 with the swizzle, weights streamed once
//     per block through the cp.async ring, wgmma with A by ldmatrix and B by
//     descriptor). Each conv runs over the block's rows clipped to the
//     conv's window, so the blocks of a segment together produce every
//     sample of every window (a halo sample is produced by two blocks, and
//     max is idempotent); a block reads only rows it produced itself.
//   - A segment barrier per conv in place of a launch per conv: after a
//     conv's MMAs each block reduces max |lrelu(v)| over its rows, posts it
//     (atomicMax on the float bits of the conv's word), arrives at the
//     segment's counter for that conv and waits for the segment's G
//     arrivals; then it reads the scale and quantises. One launch per chain
//     (ct at C = 256/128, the chains' sum in float32 in device memory) or
//     per level (the level form, DynTypes::LEVEL: the upsample levels, and
//     ct and the phase kernel without prologue at C = 64/32, where the
//     chain sum O fits in shared memory beside R).
//   - A conv's input cannot be quantised in the epilogue that makes it (the
//     scale is not known yet). conv1's sums stay in the accumulator
//     registers across the barrier and are quantised from there (one pass:
//     C <= 128; at C = 256 the conv takes two passes of 128 rows, and the
//     first pass's values wait in a per-block float32 slice beside R, in
//     L2: running conv1 twice would cost a third more MMAs and weight
//     traffic); conv2's output, the next residual, is stored in R anyway
//     and quantised from R after the barrier.
//   - Co-residency: the grid holds `slots` blocks, launched cooperatively
//     (the launch fails unless every block is resident), and walks the
//     segments in waves of spw = slots / G whole segments; a block waits
//     only on blocks of its own wave, which are all running. (Items dealt
//     round-robin across segments were no faster on the card: a segment
//     split over two rounds makes its first blocks wait for the second
//     round.) The launcher picks each launch's bm and G (mrf_int8.
//     _dyn_blocks): the largest blocks that fit the launch's halo, packed
//     so that few SMs idle. Every counter and scale word is used once per
//     call (the wrapper zeroes them).
// Float32 traffic to device memory: x in, the output (ct at C = 256/128:
// the chain sum in float32 across the three chain launches), and at C =
// 256 the residual window and conv1's first pass in a per-block scratch
// slice (~53 MB on 132 SMs: mostly in L2).
//
// Bound on the card: operations, 252*B*T*C^2 int8 operations per level at
// the dense int8 rate (plus the upsample's at C = 64/32). What holds the
// engine back is in PERF.md (scripts/torch_mrf_ablation.py, dyn_blk).
#pragma once

#include "mrf_chain_q8.cuh"

namespace mrf {
namespace blk {

constexpr int kDynChains = 3;
constexpr int kDynConvs = 2 * kMaxSteps;

// per (C_in, C): warps, the most rows a block holds (its bm owned samples
// plus 2*hx halo; shared memory or two MMA passes bound it), rows per warp,
// taps and input channels per weight stage (chain convs, then the
// upsample's), ring slots and lag, whether R lives in shared memory.
// C_in == C: no upsample (the ct route, and at C = 64/32 the phase kernel
// without prologue too); the narrow widths stage their chain convs as the
// upsample levels of the same width do, so one staged form serves both.
template <int CIN, int C> struct DynCfg;
template <> struct DynCfg<256, 256> {
  static constexpr int NW = 16, WROWS = 256, WM = 16, TPS = 1, KCH = 128, UTPS = 1, UKCH = 128,
                       NBUF = 2, LAG = 0;
  static constexpr bool R_SMEM = false;
};
template <> struct DynCfg<128, 128> {
  static constexpr int NW = 16, WROWS = 248, WM = 16, TPS = 1, KCH = 128, UTPS = 1, UKCH = 128,
                       NBUF = 2, LAG = 0;
  static constexpr bool R_SMEM = true;
};
template <> struct DynCfg<128, 64> {
  static constexpr int NW = 16, WROWS = 256, WM = 16, TPS = 4, KCH = 64, UTPS = 2, UKCH = 128,
                       NBUF = 3, LAG = 1;
  static constexpr bool R_SMEM = true;
};
template <> struct DynCfg<64, 32> {
  static constexpr int NW = 16, WROWS = 512, WM = 32, TPS = 8, KCH = 32, UTPS = 2, UKCH = 64,
                       NBUF = 3, LAG = 1;
  static constexpr bool R_SMEM = true;
};
template <> struct DynCfg<64, 64> {
  static constexpr int NW = 16, WROWS = 256, WM = 16, TPS = 4, KCH = 64, UTPS = 4, UKCH = 64,
                       NBUF = 3, LAG = 1;
  static constexpr bool R_SMEM = true;
};
template <> struct DynCfg<32, 32> {
  static constexpr int NW = 16, WROWS = 512, WM = 32, TPS = 8, KCH = 32, UTPS = 8, UKCH = 32,
                       NBUF = 3, LAG = 1;
  static constexpr bool R_SMEM = true;
};

// One dynamic chain step's weights (taps staged by pack_stage_s8, (C,)
// float32 vectors).
struct DynStep {
  const int8_t* w1;
  const float* sw1;
  const float* b1;
  const int8_t* w2;
  const float* sw2;
  const float* b2;
  int dil;
};

struct DynBlkParams {
  const bf16* x;        // no upsample: (B, T, C); else (B, T_in, C_in)
  long long x_bs;
  int t_in;             // no upsample: T; else T_in
  const float* amax0;   // per segment: the x window's amax (no upsample), else the upsample input's
  unsigned* sync;       // [2][n_bar][S]: scale words (float bits), then arrival counts
  int n_bar;
  float* sum;           // one launch per chain: (B, T, C) float32 chain sum
  long long sum_bs;
  bf16* out;            // (B, n_tiles*N, C), or with conv_post (B, 1, n_tiles*N)
  long long out_bs;
  int mode, has_acc;    // one launch per chain: its kWrite / kAdd / kFinal
  float scale;
  // the upsample (phase): per phase r (wu_phase bytes apart) ntaps staged taps
  const int8_t* wu;
  long long wu_phase;
  const float* swu;     // (stride, C)
  const float* bu;      // (C,)
  int stride, ntaps, amin, span, rows_r[8];
  const float* wp;      // (kpost, C) conv_post taps, or null
  float bp;
  int kpost, P;
  // segments: tile-relative samples; X = [x_lo, x_hi), tile_in input
  // samples (without upsample: samples) a tile, N output samples a tile
  int n_tiles, tile_in, N, x_lo, x_hi;
  int bm, hx;           // owned samples a block; R row 0 is the first - hx
  int G, spw, n_waves, S;  // blocks a segment, segments a wave, waves, segments
  DynStep steps[kDynChains][kMaxSteps];
  int k[kDynChains], n_steps[kDynChains], n_chains;
  int win[kDynChains][kDynConvs][2];  // each conv's output window
  int rem[kDynChains][kDynConvs + 1]; // reach still needed: [0] x0, [c + 1] after conv c
  float* scratch;       // !R_SMEM: per block (wrows + ROWS) x (C + 8) floats: R, F
  long long scratch_n;  // the floats scratch holds
};

template <int CIN, int C>
struct DynTypes {
  using CF = DynCfg<CIN, C>;
  static constexpr bool UPS = CIN != C;   // the upsample prologue
  using CV = Conv<C, C, CF::NW, CF::WM, CF::TPS, CF::KCH>;
  using UC = Conv<CIN, C, CF::NW, CF::WM, CF::UTPS, CF::UKCH>;
  static constexpr int SLOT = !UPS || CV::STAGE > UC::STAGE ? CV::STAGE : UC::STAGE;
  // conv1 fits one pass (its sums wait in registers across the barrier),
  // else two (the first pass's values wait in the F scratch slice)
  static constexpr bool ONEPASS = CF::WROWS <= CV::ROWS;
  static_assert(CF::WROWS <= 2 * CV::ROWS, "at most two passes a conv");
  static_assert(ONEPASS || !CF::R_SMEM, "F lives beside R in the scratch");
  // The level form: the launch holds every chain of the level and sums
  // them on chip (O, beside R and the s8 tiles), then writes the mean (or
  // conv_post's waveform); else (no upsample at C = 256/128, where O does
  // not fit) one launch per chain, its output into the float32 chain sum
  // p.sum by p.mode.
  static constexpr bool LEVEL = UPS || C <= 64;
};

// the rows a conv's (or the upsample's) pass count is planned for: the
// block's unclipped range, the same for every block (one schedule)
__host__ __device__ inline int dyn_full_rows(const DynBlkParams& p, int rem) {
  return p.bm + 2 * rem;
}

// the weight loads one block item consumes, in order (Pipe's schedule)
template <int CIN, int C>
__host__ __device__ int dyn_schedule(Ld* sched, const DynBlkParams& p) {
  using T = DynTypes<CIN, C>;
  int n = 0;
  for (int j = 0; j < p.n_chains; ++j) {
    const int k = p.k[j];
    if constexpr (T::UPS) {
      const int lo = p.hx - p.rem[j][0], hi = p.hx + p.bm + p.rem[j][0];
      const int mu = (hi + p.stride - 1) / p.stride - lo / p.stride;
      for (int r = 0; r < p.stride; ++r)
        n = T::UC::schedule(sched, n, p.wu + r * p.wu_phase, mu, p.ntaps);
    }
    for (int c = 0; c < 2 * p.n_steps[j]; ++c) {
      const DynStep& st = p.steps[j][c / 2];
      const int M = dyn_full_rows(p, p.rem[j][c + 1]);
      const bool conv1 = c % 2 == 0;
      n = T::CV::schedule(sched, n, conv1 ? st.w1 : st.w2, M, k);
    }
  }
  return n;
}

template <int CIN, int C>
struct DynLayout {
  using CF = DynCfg<CIN, C>;
  static constexpr int RS = C + 8;
  int wrows, xrows;
  size_t ring, r, o, a, xq, red, total;
  __host__ __device__ DynLayout(const DynBlkParams& p) {
    constexpr bool UPS = CIN != C;
    wrows = p.bm + 2 * p.hx;
    xrows = UPS ? wrows / p.stride + p.span : 0;
    ring = (size_t)CF::NBUF * DynTypes<CIN, C>::SLOT;
    r = CF::R_SMEM ? (size_t)wrows * RS * 4 : 0;
    o = DynTypes<CIN, C>::LEVEL ? (size_t)(p.bm + 2 * p.P) * RS * 4 : 0;
    a = (size_t)wrows * C;
    xq = (size_t)xrows * CIN;
    red = 16 * ((4 * (CF::NW + 1) + 15) / 16);
    total = ring + r + o + 2 * a + xq + red + sizeof(Ld) * (size_t)dyn_schedule<CIN, C>(nullptr, p);
  }
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// count += 1 with release semantics: the thread's earlier writes (the scale
// word's atomicMax) are visible to whoever acquires the count after it
__device__ __forceinline__ void red_release_add(unsigned* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(p) : "memory");
}

// The segment barrier of one conv: the block's max of mx into the conv's
// scale word, arrival at its counter, wait for the segment's G blocks;
// returns the segment's amax (clamped at 1e-30, as the plain version).
// red: NW + 1 floats of shared memory. Every thread of the block calls it.
template <int NW>
__device__ __forceinline__ float seg_sync(float mx, unsigned* word, unsigned* count, int G,
                                          float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < NW; ++w) mx = fmaxf(mx, red[w]);
    atomicMax(word, __float_as_uint(mx));
#ifndef MRF_ABL_NOBAR
    red_release_add(count);
    while (ld_acquire(count) < static_cast<unsigned>(G)) __nanosleep(8);
#endif
    red[NW] = __uint_as_float(ld_acquire(word));
  }
  __syncthreads();
  return fmaxf(red[NW], 1e-30f);
}

// the dynamic quantisation of one value: rint(lrelu(v) * inv) as the low
// byte of qbits (no clip: |lrelu(v) * inv| <= 127 inside the window)
__device__ __forceinline__ uint32_t qd(float v, float inv) {
  return qbits(__fmul_rn(v >= 0.f ? v : __fmul_rn(kSlope, v), inv));
}

// A1 rows [lo, hi) <- qd of R rows [lo, hi), 8 channels a thread
template <int C, int NTH>
__device__ __forceinline__ void quantise_rows(const float* R, int8_t* A, int lo, int hi, float inv) {
  constexpr int RS = C + 8;
  for (int i = threadIdx.x; i < (hi - lo) * (C / 8); i += NTH) {
    const int r = lo + i / (C / 8), c8 = (i % (C / 8)) * 8;
    const float4 f0 = *reinterpret_cast<const float4*>(R + r * RS + c8);
    const float4 f1 = *reinterpret_cast<const float4*>(R + r * RS + c8 + 4);
    *reinterpret_cast<uint2*>(A + swz<C>(r, c8)) = make_uint2(
        __byte_perm(pack2(qd(f0.x, inv), qd(f0.y, inv)), pack2(qd(f0.z, inv), qd(f0.w, inv)), 0x5410),
        __byte_perm(pack2(qd(f1.x, inv), qd(f1.y, inv)), pack2(qd(f1.z, inv), qd(f1.w, inv)), 0x5410));
  }
}

__device__ __forceinline__ float abs_lrelu2(float v0, float v1) {
  return fmaxf(abs_lrelu(v0), abs_lrelu(v1));
}

template <int CIN, int C>
__global__ void __launch_bounds__(DynCfg<CIN, C>::NW * 32, 1) dyn_blk_kernel(const DynBlkParams p) {
  using T = DynTypes<CIN, C>;
  using CF = typename T::CF;
  using CV = typename T::CV;
  using UC = typename T::UC;
  constexpr bool UPS = T::UPS;
  constexpr bool LEVEL = T::LEVEL;
  constexpr int RS = C + 8, NTH = CF::NW * 32;
  const int BM = p.bm;
  const DynLayout<CIN, C> L(p);
  // the ring first: its stages start on 1024-byte swizzle atoms
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  unsigned char* sp = smem + L.ring;
  float* R;
  float* F = nullptr;   // !ONEPASS: conv1's first pass, ROWS rows
  if constexpr (CF::R_SMEM) {
    R = reinterpret_cast<float*>(sp);
  } else {
    R = p.scratch + (size_t)blockIdx.x * (L.wrows + CV::ROWS) * RS;
    F = R + (size_t)L.wrows * RS;
  }
  sp += L.r;
  float* O = reinterpret_cast<float*>(sp);
  sp += L.o;
  int8_t* A1 = reinterpret_cast<int8_t*>(sp);
  int8_t* A2 = A1 + L.a;
  int8_t* Xq = A2 + L.a;
  float* red = reinterpret_cast<float*>(Xq + L.xq);
  Ld* sched = reinterpret_cast<Ld*>(reinterpret_cast<unsigned char*>(red) + L.red);
  const int n_sched = dyn_schedule<CIN, C>(nullptr, p);
  if (threadIdx.x == 0) dyn_schedule<CIN, C>(sched, p);
  __syncthreads();
  Pipe<CF::NBUF, T::SLOT, NTH, CF::LAG> pipe;
  pipe.start(ring, sched, n_sched);
  const int wrows = L.wrows;
  const int i_blk = blockIdx.x % p.G;
  for (int wave = 0; wave < p.n_waves; ++wave) {
    const int seg = wave * p.spw + blockIdx.x / p.G;
    if (blockIdx.x >= p.spw * p.G || seg >= p.S) continue;
    const int b = seg / p.n_tiles, t = seg - b * p.n_tiles;
    const int o_lo = p.x_lo + i_blk * BM, o_hi = min(o_lo + BM, p.x_hi);
    const int base = o_lo - p.hx;   // tile sample of row 0
    unsigned* words = p.sync + seg;
    int bar = 0;
    auto sync = [&](float mx) {
      const float a = seg_sync<CF::NW>(mx, words + (size_t)bar * p.S,
                                       words + (size_t)(p.n_bar + bar) * p.S, p.G, red);
      ++bar;
      return a;
    };
    const float* amax0 = p.amax0;
    float ax0 = fmaxf(amax0[seg], 1e-30f);   // x0's scale, or the upsample input's
    float inv_x0 = __fdiv_rn(127.f, ax0);
    const bf16* xb = p.x + b * p.x_bs;
    if constexpr (UPS) {
      // Xq row q <- lrelu(x) at input sample base_in + q, quantised with
      // the tile's input scale (ups_q8_kernel's arithmetic), zero outside
      // the utterance
      const int base_in = t * p.tile_in + base / p.stride + p.amin;
      for (int i = threadIdx.x; i < L.xrows * (CIN / 8); i += NTH) {
        const int q = i / (CIN / 8), c = (i - q * (CIN / 8)) * 8;
        const int s = base_in + q;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (s >= 0 && s < p.t_in) raw = __ldg(reinterpret_cast<const uint4*>(xb + (long long)s * CIN + c));
        const bf16* v = reinterpret_cast<const bf16*>(&raw);
        uint32_t w[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) w[e] = qd(__bfloat162float(v[e]), inv_x0);
        *reinterpret_cast<uint2*>(Xq + swz<CIN>(q, c)) = make_uint2(
            __byte_perm(pack2(w[0], w[1]), pack2(w[2], w[3]), 0x5410),
            __byte_perm(pack2(w[4], w[5]), pack2(w[6], w[7]), 0x5410));
      }
      __syncthreads();
    }
    const float sx_in = __fmul_rn(ax0, static_cast<float>(1.0 / 127.0));
    for (int j = 0; j < p.n_chains; ++j) {
      const int k = p.k[j], half = (k - 1) / 2;
      // x0 over rows [lo, hi): the block's rows of X for this chain
      const int lo = max(o_lo - p.rem[j][0], p.x_lo) - base;
      const int hi = min(o_hi + p.rem[j][0], p.x_hi) - base;
      if constexpr (UPS) {
        // the upsample, phase by phase (row = stride*mm + r), into R; the
        // first chain posts x0's amax, the others quantise with it
        const bool first = j == 0;
        const int mm0 = lo / p.stride, mu = (hi + p.stride - 1) / p.stride - mm0;
        const int flo = p.hx - p.rem[j][0];
        const int mu_full = (flo + dyn_full_rows(p, p.rem[j][0]) + p.stride - 1) / p.stride -
                            flo / p.stride;
        float mx = 0.f;
        for (int r = 0; r < p.stride; ++r) {
          const float* sw = p.swu + r * C;
          const int stride = p.stride;
          struct CU { float2 s, b; };
          for (int m0 = 0; m0 < UC::passes(mu_full) * UC::ROWS; m0 += UC::ROWS) {
            int acc[UC::MB][UC::WN / 2];
            UC::mma(pipe, acc, Xq, mm0 + p.rows_r[r], m0, mu, 1, p.ntaps, L.xrows);
            UC::each(acc, m0, mu,
                     [&](int n) {
                       CU c;
                       c.s = __ldg(reinterpret_cast<const float2*>(sw + n));
                       c.s = make_float2(__fmul_rn(c.s.x, sx_in), __fmul_rn(c.s.y, sx_in));
                       c.b = __ldg(reinterpret_cast<const float2*>(p.bu + n));
                       return c;
                     },
                     [&](int m, int n, int a0, int a1, const CU& c) {
                       const int row = stride * (mm0 + m) + r;
                       const float v0 = __fmaf_rn(__int2float_rn(a0), c.s.x, c.b.x);
                       const float v1 = __fmaf_rn(__int2float_rn(a1), c.s.y, c.b.y);
                       *reinterpret_cast<float2*>(R + row * RS + n) = make_float2(v0, v1);
                       if (row >= lo && row < hi) {
                         if (first)
                           mx = fmaxf(mx, abs_lrelu2(v0, v1));
                         else
                           *reinterpret_cast<uint16_t*>(A1 + swz<C>(row, n)) =
                               static_cast<uint16_t>(pack2(qd(v0, inv_x0), qd(v1, inv_x0)));
                       }
                     });
          }
        }
        __syncthreads();
        if (first) {
          ax0 = sync(mx);
          inv_x0 = __fdiv_rn(127.f, ax0);
          quantise_rows<C, NTH>(R, A1, lo, hi, inv_x0);
          __syncthreads();
        }
      } else {
        // R rows [lo, hi) <- x (zero outside the utterance), A1 <- qd
        const int g0 = t * p.tile_in + base;
        for (int i = threadIdx.x; i < (hi - lo) * (C / 8); i += NTH) {
          const int r = lo + i / (C / 8), c8 = (i % (C / 8)) * 8;
          const int s = g0 + r;
          uint4 raw = make_uint4(0u, 0u, 0u, 0u);
          if (s >= 0 && s < p.t_in) raw = __ldg(reinterpret_cast<const uint4*>(xb + (long long)s * C + c8));
          const bf16* v = reinterpret_cast<const bf16*>(&raw);
          float f[8];
          uint32_t w[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            f[e] = __bfloat162float(v[e]);
            w[e] = qd(f[e], inv_x0);
          }
          float* dst = R + r * RS + c8;
          *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
          *reinterpret_cast<float4*>(dst + 4) = make_float4(f[4], f[5], f[6], f[7]);
          *reinterpret_cast<uint2*>(A1 + swz<C>(r, c8)) = make_uint2(
              __byte_perm(pack2(w[0], w[1]), pack2(w[2], w[3]), 0x5410),
              __byte_perm(pack2(w[4], w[5]), pack2(w[6], w[7]), 0x5410));
        }
        __syncthreads();
      }
      float ax = ax0;   // the current conv input's amax
      for (int si = 0; si < p.n_steps[j]; ++si) {
        const DynStep& st = p.steps[j][si];
        const bool last = si + 1 == p.n_steps[j];
        // conv1 (dilated): rows [lo1, hi1), quantised into A2 after its barrier
        const int c1 = 2 * si;
        const int lo1 = max(o_lo - p.rem[j][c1 + 1], p.win[j][c1][0]) - base;
        const int hi1 = min(o_hi + p.rem[j][c1 + 1], p.win[j][c1][1]) - base;
        const int M1 = hi1 - lo1;
        {
          const float sx = __fmul_rn(ax, static_cast<float>(1.0 / 127.0));
          struct C1 { float2 s, b; };
          auto col = [&](int n) {
            C1 c;
            c.s = __ldg(reinterpret_cast<const float2*>(st.sw1 + n));
            c.s = make_float2(__fmul_rn(c.s.x, sx), __fmul_rn(c.s.y, sx));
            c.b = __ldg(reinterpret_cast<const float2*>(st.b1 + n));
            return c;
          };
          float mx = 0.f;
          auto amax_epi = [&](int m, int n, int a0, int a1, const C1& c) {
            mx = fmaxf(mx, abs_lrelu2(__fmaf_rn(__int2float_rn(a0), c.s.x, c.b.x),
                                      __fmaf_rn(__int2float_rn(a1), c.s.y, c.b.y)));
          };
          float inv = 0.f;
          auto q_epi = [&](int m, int n, int a0, int a1, const C1& c) {
            const float v0 = __fmaf_rn(__int2float_rn(a0), c.s.x, c.b.x);
            const float v1 = __fmaf_rn(__int2float_rn(a1), c.s.y, c.b.y);
            *reinterpret_cast<uint16_t*>(A2 + swz<C>(lo1 + m, n)) =
                static_cast<uint16_t>(pack2(qd(v0, inv), qd(v1, inv)));
          };
          const int a0 = lo1 - st.dil * half;
          const int np = CV::passes(dyn_full_rows(p, p.rem[j][c1 + 1]));
          if constexpr (T::ONEPASS) {
            int acc[CV::MB][CV::WN / 2];
            CV::mma(pipe, acc, A1, a0, 0, M1, st.dil, k, wrows);
            CV::each(acc, 0, M1, col, amax_epi);
            ax = sync(mx);
            inv = __fdiv_rn(127.f, ax);
            CV::each(acc, 0, M1, col, q_epi);
          } else {
            // two passes: the first one's values wait in the block's F
            // slice (L2), the second one's in registers
            int acc[CV::MB][CV::WN / 2];
            if (np > 1) {
              CV::mma(pipe, acc, A1, a0, 0, M1, st.dil, k, wrows);
              CV::each(acc, 0, M1, col, [&](int m, int n, int a0_, int a1_, const C1& c) {
                const float v0 = __fmaf_rn(__int2float_rn(a0_), c.s.x, c.b.x);
                const float v1 = __fmaf_rn(__int2float_rn(a1_), c.s.y, c.b.y);
                *reinterpret_cast<float2*>(F + m * RS + n) = make_float2(v0, v1);
                mx = fmaxf(mx, abs_lrelu2(v0, v1));
              });
            }
            const int m0 = (np - 1) * CV::ROWS;
            CV::mma(pipe, acc, A1, a0, m0, M1, st.dil, k, wrows);
            CV::each(acc, m0, M1, col, amax_epi);
            ax = sync(mx);
            inv = __fdiv_rn(127.f, ax);
            CV::each(acc, m0, M1, col, q_epi);
            if (np > 1) quantise_rows<C, NTH>(F - lo1 * RS, A2, lo1, lo1 + min(M1, m0), inv);
          }
          __syncthreads();
        }
        // conv2 onto the residual: rows [lo2, hi2); the next residual is
        // stored in R and quantised into A1 after its barrier, or the
        // chain's output leaves the block
        const int c2 = c1 + 1;
        const int lo2 = max(o_lo - p.rem[j][c2 + 1], p.win[j][c2][0]) - base;
        const int hi2 = min(o_hi + p.rem[j][c2 + 1], p.win[j][c2][1]) - base;
        const int M2 = hi2 - lo2;
        {
          const float sx = __fmul_rn(ax, static_cast<float>(1.0 / 127.0));
          struct C2 { float2 s, b; };
          auto col = [&](int n) {
            C2 c;
            c.s = __ldg(reinterpret_cast<const float2*>(st.sw2 + n));
            c.s = make_float2(__fmul_rn(c.s.x, sx), __fmul_rn(c.s.y, sx));
            c.b = __ldg(reinterpret_cast<const float2*>(st.b2 + n));
            return c;
          };
          float mx = 0.f;
          const int a0 = lo2 - half;
          const int np = CV::passes(dyn_full_rows(p, p.rem[j][c2 + 1]));
          for (int ps = 0; ps < np; ++ps) {
            int acc[CV::MB][CV::WN / 2];
            CV::mma(pipe, acc, A2, a0, ps * CV::ROWS, M2, 1, k, wrows);
            CV::each(acc, ps * CV::ROWS, M2, col, [&](int m, int n, int a0_, int a1_, const C2& c) {
              float* rp = R + (lo2 + m) * RS + n;
              const float2 r = *reinterpret_cast<const float2*>(rp);
              const float v0 = __fadd_rn(r.x, __fmaf_rn(__int2float_rn(a0_), c.s.x, c.b.x));
              const float v1 = __fadd_rn(r.y, __fmaf_rn(__int2float_rn(a1_), c.s.y, c.b.y));
              if (!last) {
                *reinterpret_cast<float2*>(rp) = make_float2(v0, v1);
                mx = fmaxf(mx, abs_lrelu2(v0, v1));
                return;
              }
              const int s = base + lo2 + m;   // tile sample
              if constexpr (LEVEL) {
                float2* o = reinterpret_cast<float2*>(O + (s - (o_lo - p.P)) * RS + n);
                if (j == 0) {
                  *o = make_float2(v0, v1);
                } else {
                  const float2 q = *o;
                  *o = make_float2(__fadd_rn(q.x, v0), __fadd_rn(q.y, v1));
                }
              } else {
                if (s < o_lo || s >= o_hi) return;   // a neighbour's sample
                const long long oi = (long long)(t * p.tile_in + s) * C + n;
                float* sum = p.sum + b * p.sum_bs;
                float w0 = v0, w1 = v1;
                if (p.mode == kWrite) {
                  *reinterpret_cast<float2*>(sum + oi) = make_float2(w0, w1);
                } else if (p.mode == kAdd) {
                  const float2 q = *reinterpret_cast<const float2*>(sum + oi);
                  *reinterpret_cast<float2*>(sum + oi) = make_float2(__fadd_rn(q.x, w0), __fadd_rn(q.y, w1));
                } else {
                  if (p.has_acc) {
                    const float2 q = *reinterpret_cast<const float2*>(sum + oi);
                    w0 = __fadd_rn(q.x, w0);
                    w1 = __fadd_rn(q.y, w1);
                  }
                  __nv_bfloat162 h;
                  h.x = __float2bfloat16_rn(__fmul_rn(w0, p.scale));
                  h.y = __float2bfloat16_rn(__fmul_rn(w1, p.scale));
                  *reinterpret_cast<__nv_bfloat162*>(p.out + b * p.out_bs + oi) = h;
                }
              }
            });
          }
          __syncthreads();
          if (!last) {
            ax = sync(mx);
            quantise_rows<C, NTH>(R, A1, lo2, hi2, __fdiv_rn(127.f, ax));
            __syncthreads();
          }
        }
      }
    }
    if constexpr (LEVEL) {
      // O rows [0, BM + 2P): the chain sum at tile samples [o_lo - P, o_hi + P)
      const int n_own = o_hi - o_lo;
      if (p.kpost == 0) {
        bf16* out = p.out + b * p.out_bs + ((long long)t * p.N) * C;
        for (int i = threadIdx.x; i < n_own * (C / 2); i += NTH) {
          const int m = i / (C / 2), n = (i - m * (C / 2)) * 2;
          const int s = o_lo + m;
          if (s < 0 || s >= p.N) continue;
          const float2 v = *reinterpret_cast<const float2*>(O + m * RS + n);
          __nv_bfloat162 w;
          w.x = __float2bfloat16_rn(__fmul_rn(v.x, p.scale));
          w.y = __float2bfloat16_rn(__fmul_rn(v.y, p.scale));
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)s * C + n) = w;
        }
      } else {
        // post_kernel's arithmetic: the lrelu of the scaled sum rounded to
        // bf16 (rows C + 1 floats apart in R's space), then per sample the
        // taps in order, tanh
        float* Q = R;
        const int orows = n_own + 2 * p.P;
        for (int i = threadIdx.x; i < orows * C; i += NTH) {
          const int m = i / C, n = i - m * C;
          const int s = o_lo - p.P + m;
          if (s < -p.P || s >= p.N + p.P) continue;
          Q[m * (C + 1) + n] = __bfloat162float(__float2bfloat16_rn(lrelu(O[m * RS + n] * p.scale)));
        }
        __syncthreads();
        bf16* out = p.out + b * p.out_bs + (long long)t * p.N;
        for (int m = threadIdx.x; m < n_own; m += NTH) {
          const int s = o_lo + m;
          if (s < 0 || s >= p.N) continue;
          float acc = 0.f;
          for (int tap = 0; tap < p.kpost; ++tap) {
            const float* row = Q + (m + tap) * (C + 1);
            const float* wt = p.wp + tap * C;
#pragma unroll 8
            for (int c = 0; c < C; ++c) acc = fmaf(row[c], __ldg(wt + c), acc);
          }
          out[s] = __float2bfloat16_rn(tanhf(acc + p.bp));
        }
      }
      __syncthreads();
    }
  }
  pipe.finish();
}

// Checks the plan against the kernel's geometry and launches `slots`
// blocks cooperatively (spw * G <= slots <= the card's resident blocks).
template <int CIN, int C>
cudaError_t launch_dyn_blk(DynBlkParams& p, int slots, cudaStream_t stream) {
  using CF = DynCfg<CIN, C>;
  constexpr bool UPS = CIN != C;
  if (p.hx < 0 || p.bm < 1 || p.bm + 2 * p.hx > CF::WROWS || p.G < 1 || p.spw < 1 ||
      p.spw * p.G > slots || p.n_waves * p.spw < p.S || p.G * p.bm < p.x_hi - p.x_lo ||
      (p.G - 1) * p.bm >= p.x_hi - p.x_lo ||
      p.n_chains < 1 || p.n_chains > kDynChains ||
      (!DynTypes<CIN, C>::LEVEL && p.n_chains > 1))
    return cudaErrorInvalidValue;
  if (UPS && (p.hx % p.stride || p.bm % p.stride || p.x_lo % p.stride || p.stride < 1 || p.stride > 8 ||
                p.wu_phase != (long long)((p.ntaps + CF::UTPS - 1) / CF::UTPS) * (CIN / CF::UKCH) *
                                  CF::UTPS * C * CF::UKCH))
    return cudaErrorInvalidValue;
  int bars = UPS ? 1 : 0;
  for (int j = 0; j < p.n_chains; ++j) {
    if (p.n_steps[j] < 1 || p.n_steps[j] > kMaxSteps || p.k[j] < 1 || p.k[j] % 2 == 0 ||
        p.rem[j][0] > p.hx)
      return cudaErrorInvalidValue;
    bars += 2 * p.n_steps[j] - 1;
  }
  if (bars != p.n_bar) return cudaErrorInvalidValue;
  const DynLayout<CIN, C> L(p);
  if (L.total > 232448 || (UPS && (size_t)(p.bm + 2 * p.P) * (C + 1) * 4 > L.r))
    return cudaErrorInvalidValue;
  if (!CF::R_SMEM && (p.scratch == nullptr ||
                      (long long)slots * (L.wrows + DynTypes<CIN, C>::CV::ROWS) * L.RS > p.scratch_n))
    return cudaErrorInvalidValue;
  if (p.S <= 0) return cudaSuccess;
  const void* kern = reinterpret_cast<const void*>(&dyn_blk_kernel<CIN, C>);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, CF::NW * 32, L.total);
  if (e != cudaSuccess) return e;
  if (slots > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(kern, dim3(slots), dim3(CF::NW * 32), args, L.total, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace blk
}  // namespace mrf

// The C entry point of the engine (mrf_ct_q8.cu, mrf_phase_q8.cu). ptrs: wu,
// swu, bu, wp (null without conv_post or without upsample), then 6 per step of
// each chain (w1, sw1, b1, w2, sw2, b2). ints: stride, ntaps, amin, span,
// rows_r[8], kpost, P, n_tiles, tile_in, N, x_lo, x_hi, hx, G, spw,
// n_waves, S, n_bar, mode, has_acc, bm, tps, kch, utps, ukch, wu_phase,
// n_chains, then per chain k, n_steps, dils[4], win[8][2], rem[9]
// (mrf_int8._dyn_blk_args).
#define MRF_DYN_BLK_ARGS                                                                     \
  const void *x, long long x_bs, int t_in, const void *amax0, void *sync, void *sum,          \
      long long sum_bs, void *out, long long out_bs, const long long *ptrs, const int *ints,  \
      float scale, float post_bias, void *scratch, long long scratch_n, int c_in, int C,      \
      int slots, void *stream

namespace mrf {
namespace blk {

constexpr int kDynIntsHead = 34;
constexpr int kDynIntsChain = 2 + kMaxSteps + 2 * kDynConvs + kDynConvs + 1;

// DynBlkParams from the entry point's arrays; false when they are malformed
inline bool dyn_blk_params(DynBlkParams& p, const void* x, long long x_bs, int t_in,
                           const void* amax0, void* sync, void* sum, long long sum_bs, void* out,
                           long long out_bs, const long long* ptrs, const int* ints, float scale,
                           float post_bias, void* scratch, long long scratch_n) {
  p = DynBlkParams{};
  p.x = static_cast<const bf16*>(x);
  p.x_bs = x_bs;
  p.t_in = t_in;
  p.amax0 = static_cast<const float*>(amax0);
  p.sync = static_cast<unsigned*>(sync);
  p.sum = static_cast<float*>(sum);
  p.sum_bs = sum_bs;
  p.out = static_cast<bf16*>(out);
  p.out_bs = out_bs;
  p.scale = scale;
  p.bp = post_bias;
  p.scratch = static_cast<float*>(scratch);
  p.scratch_n = scratch_n;
  p.wu = reinterpret_cast<const int8_t*>(ptrs[0]);
  p.swu = reinterpret_cast<const float*>(ptrs[1]);
  p.bu = reinterpret_cast<const float*>(ptrs[2]);
  p.wp = reinterpret_cast<const float*>(ptrs[3]);
  p.stride = ints[0];
  p.ntaps = ints[1];
  p.amin = ints[2];
  p.span = ints[3];
  for (int r = 0; r < 8; ++r) p.rows_r[r] = ints[4 + r];
  p.kpost = ints[12];
  p.P = ints[13];
  p.n_tiles = ints[14];
  p.tile_in = ints[15];
  p.N = ints[16];
  p.x_lo = ints[17];
  p.x_hi = ints[18];
  p.hx = ints[19];
  p.G = ints[20];
  p.spw = ints[21];
  p.n_waves = ints[22];
  p.S = ints[23];
  p.n_bar = ints[24];
  p.mode = ints[25];
  p.has_acc = ints[26];
  p.bm = ints[27];
  // ints[28..31]: tps, kch, utps, ukch (checked by the caller)
  p.wu_phase = ints[32];
  p.n_chains = ints[33];
  if (p.n_chains < 1 || p.n_chains > kDynChains || (p.kpost > 0) != (p.wp != nullptr) ||
      (p.kpost > 0 && p.P != (p.kpost - 1) / 2) || (p.kpost == 0 && p.P != 0))
    return false;
  const long long* w = ptrs + 4;
  for (int j = 0; j < p.n_chains; ++j) {
    const int* cj = ints + kDynIntsHead + kDynIntsChain * j;
    p.k[j] = cj[0];
    p.n_steps[j] = cj[1];
    if (p.n_steps[j] < 1 || p.n_steps[j] > kMaxSteps) return false;
    for (int i = 0; i < p.n_steps[j]; ++i, w += 6)
      p.steps[j][i] = DynStep{reinterpret_cast<const int8_t*>(w[0]), reinterpret_cast<const float*>(w[1]),
                              reinterpret_cast<const float*>(w[2]), reinterpret_cast<const int8_t*>(w[3]),
                              reinterpret_cast<const float*>(w[4]), reinterpret_cast<const float*>(w[5]),
                              cj[2 + i]};
    for (int c = 0; c < kDynConvs; ++c) {
      p.win[j][c][0] = cj[2 + kMaxSteps + 2 * c];
      p.win[j][c][1] = cj[2 + kMaxSteps + 2 * c + 1];
    }
    for (int c = 0; c <= kDynConvs; ++c) p.rem[j][c] = cj[2 + kMaxSteps + 2 * kDynConvs + c];
  }
  return true;
}

template <int CIN, int C>
int dyn_blk_entry(DynBlkParams& p, const int* ints, int slots, cudaStream_t s) {
  using CF = DynCfg<CIN, C>;
  if (ints[28] != CF::TPS || ints[29] != CF::KCH ||
      ((CIN != C) && (ints[30] != CF::UTPS || ints[31] != CF::UKCH)))
    return (int)cudaErrorInvalidValue;
  return (int)launch_dyn_blk<CIN, C>(p, slots, s);
}

}  // namespace blk
}  // namespace mrf
