// Block-resident float32 ResBlock1 chains for Hopper, on the tensor cores in
// 3xTF32: tc_f32_kernel (mrf_tc.cu), the float32 fused_mrf_tc (one launch
// per chain of the group) and fused_resblock1 (one chain, one launch),
// phase_f32_kernel (mrf_phase.cu), the float32 fused_mrf_phase (upsample,
// the three chains and conv_post, one launch per level), and mrf_ct.cuh's
// ct_kernel<CtF32> (mrf_ct.cu), the float32 fused_mrf_ct and
// fused_mrf_phase without prologue (the three chains, one launch per
// level).
//
// The function is the bf16 engine's (mrf_chain_bf16.cuh) in float32: each
// conv's input lrelu'd (no rounding), float32 sums, + bias, the residual in
// float32, res + (acc + b2) (vocoder_kernels.mrf_tc_plain,
// mrf_phase_plain). Only the order in which a conv's products are summed
// may differ, and each product is float32-accurate: three mma.sync m16n8k8
// TF32 products of the operands' split halves (tf32x3.cuh).
//
//   - A block owns bm output samples of one utterance and keeps the chain's
//     window, bm + 2*halo rows, on chip: the conv input as a float32 tile A
//     in shared memory (rows of C + 4 floats: the fragment reads are
//     conflict-free 32-bit LDS), overwritten in place as in the bf16 engine
//     (conv1 writes lrelu(acc + b1) over its input, conv2 the next step's
//     input lrelu(res + (acc + b2))), and the float32 residual window in a
//     per-block slice of a global scratch, which stays in L2: a second
//     float32 tile beside A would cut the window in half. Every step runs on
//     the window with valid convs, shrinking it, so a chain reads x once and
//     writes once.
//   - Why mma.sync and not wgmma: wgmma takes TF32 operands K-major from
//     shared memory, so a float32-accurate product needs hi and lo planes of
//     A there too, four times the bf16 tile; at C = 256 that leaves no useful
//     window. mma.sync takes A from registers: A is split as it is read, B
//     (the weights, constants) is split once on the host.
//   - Weights: per conv, stage s = tap*KC + kc holds input channels [kc*KCH,
//     (kc+1)*KCH) of one tap for every output channel, already split into
//     TF32 hi and lo planes in the B fragment order (vocoder_kernels.
//     pack_stage_tf32): [k8 step][n-tile of 8][lane][hi0, hi1, lo0, lo1], one
//     conflict-free 16-byte LDS per lane, n-tile and k8 step. The stages of
//     every conv stream through one ring by cp.async (mrf_wgmma.cuh's Pipe).
//   - Accumulation: the tensor cores truncate as they accumulate, so a long
//     chain of MMAs into one accumulator drifts (one chain of 768 left the
//     1e-5 band in the float32 attention). Each stage (one tap, KCH input
//     channels: 3*KCH/8 MMAs) sums in a fresh accumulator, which is added to
//     the conv's float32 sum in stage order with a rounded add.
//   - NW warps tile a pass of ROWS output rows x C columns, each warp WM =
//     16*MT rows x WN = 8*NT columns. A warp's rows past the conv's end read
//     its last input row (their outputs are dropped).
//
// phase_f32_kernel takes phase_bf_kernel's structure (persistent blocks over
// items of bm output samples; the x window, lrelu'd, then the polyphase
// upsample into a window X0 of bm + 2*hx rows, hx the widest chain's halo
// plus conv_post's reach; per chain its window of X0 copied into the
// residual and the conv tile, its steps, the chain added into a sum; then
// the mean through a transposed tile into (B, C, N), or conv_post and tanh
// per sample) with tc_f32_kernel's arithmetic, the upsample (C_in -> C) one
// more ConvF32 on the x tile. Shared memory holds X0 and A (rows of C + 4
// floats) and the ring; the x tile (rows of C_in + 4) lives in A's place
// until the first chain. X0 stays on chip because every chain reads it; the
// residual window R (the widest chain's, C floats a row) and the chain sum
// O (bm + 2P rows) go to a per-block slice of a global scratch, which stays
// in L2: at V1's L2 (C = 64, hx = 60) a block owns 240 samples of a
// 360-sample window so; with R beside X0 and A it would own 128 (of 248),
// with R and O 96 (of 216).
//
// ct_kernel<CtF32> (mrf_ct.cuh, mrf_ct.cu: the float32 fused_mrf_ct and
// fused_mrf_phase without prologue, HiFi-GAN V2's levels, C = 64..8) is the
// bf16 level kernel's structure (per chain the window of x loaded, its
// steps run, the chain added into a sum; the last chain writes the mean)
// with ChainF32's arithmetic: the conv tile A in shared memory, and the
// residual window R and the chain sum O in shared memory too where they fit
// beside it with a useful block (CtF32Cfg), else in the block's scratch
// slice.
//
// Bound on the card: operations, 4*k*C^2 flops per sample and dilation (and
// the upsample's 2*C_in*C*k/s per output sample) at a third of the TF32
// rate (three TF32 products per product).
//
// Ablation builds (scripts/torch_mrf_ablation.py, section f32; results
// wrong, not checked): MRF_ABL_NOW (Pipe: no weight copies), MRF_ABL_NOMMA
// (no A fragment loads, splits or mma.sync: the sums stay zero).
#pragma once

#include "mrf_chain_bf16.cuh"
#include "tf32x3.cuh"

namespace mrf {
namespace f32e {

using blk::Ld;
using blk::Pipe;
using bfe::chain_halo;
using bfe::kMaxChains;
using bfe::kMaxSteps;
using bfe::kSmemMax;
using bfe::StepBf;
using bfe::TcSink;
using tf32x3::FragA;

// per C: warps, row and column tiles of a warp (16*MT rows, 8*NT columns),
// input channels per weight stage, ring slots; the block's output samples
// are the launch plan's (vocoder_kernels.TC_F32_CFG mirrors this)
template <int C> struct TcF32Cfg;
template <> struct TcF32Cfg<128> {
  static constexpr int NW = 8, MT = 2, NT = 8, KCH = 32, NBUF = 2;
};
template <> struct TcF32Cfg<256> {
  static constexpr int NW = 8, MT = 4, NT = 8, KCH = 8, NBUF = 2;
};
// the narrow levels' chains (phase_f32_kernel, ct_kernel<CtF32>)
template <> struct TcF32Cfg<64> {
  static constexpr int NW = 8, MT = 2, NT = 8, KCH = 32, NBUF = 2;
};
template <> struct TcF32Cfg<32> {
  static constexpr int NW = 8, MT = 2, NT = 4, KCH = 32, NBUF = 2;
};
// HiFi-GAN V2's narrowest levels (ct_kernel<CtF32>): a stage (one tap) is a
// few hundred bytes of MMAs, so more row tiles a warp and more ring slots
template <> struct TcF32Cfg<16> {
  static constexpr int NW = 8, MT = 8, NT = 2, KCH = 16, NBUF = 4;
};
template <> struct TcF32Cfg<8> {
  static constexpr int NW = 8, MT = 8, NT = 1, KCH = 8, NBUF = 4;
};

__device__ __forceinline__ float lrelu1(float v) { return v >= 0.f ? v : __fmul_rn(kSlope, v); }

// R rows [0, wrows) (C floats a row) <- samples [s0, s0 + wrows) of one
// utterance of x ((T, C) float32, sample-major), zero outside [0, T); A
// rows (AS floats apart) <- their lrelu. NTH threads, 4 channels a load.
template <int C, int AS, int NTH>
__device__ __forceinline__ void load_window_f32(float* R, float* A, const float* xb, int s0,
                                                int wrows, int T) {
  constexpr int Q = C / 4, U = 4;
  for (int i0 = threadIdx.x; i0 < wrows * Q; i0 += U * NTH) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * NTH, r = i / Q, s = s0 + r;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < wrows && s >= 0 && s < T)
        v[u] = __ldg(reinterpret_cast<const float4*>(xb + (long long)s * C + (i - r * Q) * 4));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * NTH, r = i / Q, c = (i - r * Q) * 4;
      if (r >= wrows) break;
      *reinterpret_cast<float4*>(R + r * C + c) = v[u];
      *reinterpret_cast<float4*>(A + r * AS + c) =
          make_float4(lrelu1(v[u].x), lrelu1(v[u].y), lrelu1(v[u].z), lrelu1(v[u].w));
    }
  }
}

// out[m][n] = sum_tap sum_ci A[m + tap*dil][ci] * W(tap, ci, n) for m < M,
// n < COUT, A a float32 tile of CIN channels in rows AS = CIN + 4 floats
// apart, arows of them valid.
template <int CIN, int COUT, int NW, int MT, int NT, int KCH>
struct ConvF32 {
  static constexpr int WN = 8 * NT;
  static constexpr int CG = COUT / WN;
  static constexpr int RG = NW / CG;
  static constexpr int WM = 16 * MT;
  static constexpr int ROWS = RG * WM;
  static constexpr int KC = CIN / KCH;
  static constexpr int KS = KCH / 8;
  static constexpr int NT8 = COUT / 8;
  static constexpr int STAGE = KCH * COUT * 8;   // hi and lo of KCH x COUT weights
  static constexpr int AS = CIN + 4;
  static_assert(COUT % WN == 0 && NW % CG == 0 && CIN % KCH == 0 && KCH % 8 == 0, "tiles");

  __host__ __device__ static int conv_stages(int ntaps) { return ntaps * KC; }
  __host__ __device__ static int passes(int M) { return (M + ROWS - 1) / ROWS; }
  __host__ __device__ static int schedule(Ld* sched, int n, const int8_t* w, int M, int ntaps) {
    for (int ps = 0; ps < passes(M); ++ps) {
      if (sched != nullptr) sched[n] = Ld{w, STAGE, conv_stages(ntaps)};
      ++n;
    }
    return n;
  }

  // The MMAs of one pass, output rows [m0, m0 + ROWS) of M, into acc; the
  // pass takes the conv's stages from the pipe whether or not a warp has
  // rows in it (every block consumes the same schedule).
  template <class P>
  static __device__ __forceinline__ void mma(P& pipe, float (&acc)[MT][NT][4], const float* A,
                                             int arows, int m0, int M, int dil, int ntaps) {
    static_assert(STAGE <= P::slot, "pipe slot");
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rg = warp / CG, cg = warp - rg * CG;
    const int g = lane >> 2, t = lane & 3;
    const int wb = m0 + rg * WM;       // the warp's first row
    const bool active = wb < M;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    const int n_st = conv_stages(ntaps);
    for (int s = 0; s < n_st; ++s) {
      const float4* W = reinterpret_cast<const float4*>(pipe.acquire()) + cg * NT * 32 + lane;
#ifndef MRF_ABL_NOMMA
      if (!active) continue;
#else
      continue;
#endif
      const int tap = s / KC, kc = s - tap * KC;
      // the stage's A fragments, split as they are read
      FragA fa[MT][KS];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wb + 16 * mt + g + tap * dil;
        const float* p0 = A + min(r, arows - 1) * AS + kc * KCH + t;
        const float* p1 = A + min(r + 8, arows - 1) * AS + kc * KCH + t;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          fa[mt][ks] = tf32x3::split_a(p0[8 * ks], p1[8 * ks], p0[8 * ks + 4], p1[8 * ks + 4]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float4 w[KS];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) w[ks] = W[(ks * NT8 + nt) * 32];
        // the stage's sum in a fresh accumulator
        float part[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) part[mt][0] = part[mt][1] = part[mt][2] = part[mt][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            tf32x3::mma3_split(part[mt], fa[mt][ks], __float_as_uint(w[ks].x),
                               __float_as_uint(w[ks].y), __float_as_uint(w[ks].z),
                               __float_as_uint(w[ks].w));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], part[mt][e]);
      }
    }
  }

  // The epilogue of one pass's sums, IG column tiles of a row tile at a
  // time: cc = col(n) and q = pre(m, n, m < M) for each of the warp's rows m
  // first, then epi(m, n, acc[n], acc[n + 1], cc, q, m < M) (rows past M:
  // epi stores nothing). Every load of a batch is issued before its stores,
  // which the compiler would otherwise keep in program order (they may
  // alias).
  template <class Col, class Pre, class Epi>
  static __device__ __forceinline__ void each(const float (&acc)[MT][NT][4], int m0, int M,
                                              Col&& col, Pre&& pre, Epi&& epi) {
    constexpr int IG = NT < 4 ? NT : 4;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rg = warp / CG, cg = warp - rg * CG;
    const int wb = m0 + rg * WM;
    if (wb >= M) return;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = wb + 16 * mt + (lane >> 2);
      const bool v0 = r < M, v1 = r + 8 < M;
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += IG) {
        decltype(col(0)) cc[IG];
        decltype(pre(0, 0, true)) q[IG][2];
#pragma unroll
        for (int ii = 0; ii < IG; ++ii) {
          const int c = cg * WN + (n0 + ii) * 8 + 2 * (lane & 3);
          cc[ii] = col(c);
          q[ii][0] = pre(r, c, v0);
          q[ii][1] = pre(r + 8, c, v1);
        }
#pragma unroll
        for (int ii = 0; ii < IG; ++ii) {
          const int nt = n0 + ii, c = cg * WN + nt * 8 + 2 * (lane & 3);
          epi(r, c, acc[mt][nt][0], acc[mt][nt][1], cc[ii], q[ii][0], v0);
          epi(r + 8, c, acc[mt][nt][2], acc[mt][nt][3], cc[ii], q[ii][1], v1);
        }
      }
    }
  }

  // A conv with its epilogue, in place: the epilogue writes the input tile
  // once every warp has read the pass's rows.
  template <class P, class Col, class Pre, class Epi>
  static __device__ __forceinline__ void run(P& pipe, const float* A, int arows, int M, int dil,
                                             int ntaps, Col&& col, Pre&& pre, Epi&& epi) {
    for (int m0 = 0; m0 < M; m0 += ROWS) {
      float acc[MT][NT][4];
      mma(pipe, acc, A, arows, m0, M, dil, ntaps);
      __syncthreads();
      each(acc, m0, M, col, pre, epi);
    }
    __syncthreads();
  }
};

// A chain on a float32 residual window R (rows of C floats, in the scratch)
// and the float32 conv tile A.
template <int C>
struct ChainF32 {
  using CF = TcF32Cfg<C>;
  using CV = ConvF32<C, C, CF::NW, CF::MT, CF::NT, CF::KCH>;
  static constexpr int AS = CV::AS;

  // the step's loads for a schedule (conv1, then conv2)
  __host__ __device__ static int schedule(Ld* sched, int n, int lo, int hi, const StepBf& st,
                                          int k) {
    const int M1 = hi - lo - 2 * st.dil * ((k - 1) / 2);
    n = CV::schedule(sched, n, st.w1, M1, k);
    return CV::schedule(sched, n, st.w2, M1 - 2 * ((k - 1) / 2), k);
  }

  // One step on R rows [lo, hi), whose conv input A rows [0, hi - lo)
  // already hold: conv1 (dilated) +b1, lrelu into A rows [0, M1); conv2 +b2
  // onto the residual. The new value v of R row lo + r1 + r2 + m is, unless
  // LAST, stored back and its lrelu into A row m; else the sink takes it
  // (mrf_chain_bf16.cuh ChainBf::step).
  template <bool LAST, class P, class Sink>
  static __device__ __forceinline__ void step(P& pipe, float* R, int lo, int hi, const StepBf& st,
                                              int k, float* A, const Sink& sink) {
    const int half = (k - 1) / 2;
    const int r1 = st.dil * half;
    const int M1 = hi - lo - 2 * r1;
    const float* b1 = st.b1;
    CV::run(pipe, A, hi - lo, M1, st.dil, k, [&](int n) { return bfe::bias2(b1, n); },
            [](int, int, bool) { return 0; },
            [&](int m, int n, float a0, float a1, const float2& b, int, bool valid) {
              const float2 v = make_float2(lrelu1(__fadd_rn(a0, b.x)), lrelu1(__fadd_rn(a1, b.y)));
              if (valid) *reinterpret_cast<float2*>(A + m * AS + n) = v;
            });
    const int M2 = M1 - 2 * half;
    float* base = R + (lo + r1 + half) * C;
    const float* b2 = st.b2;
    CV::run(pipe, A, M1, M2, 1, k, [&](int n) { return bfe::bias2(b2, n); },
            // the residual (a row past M2 reads row M2 - 1) and the sink's
            // earlier value
            [&](int m, int n, bool valid) {
              const float2 r = *reinterpret_cast<const float2*>(base + (valid ? m : M2 - 1) * C + n);
              float2 e = make_float2(0.f, 0.f);
              if constexpr (LAST) e = sink.load(m, n, valid);
              return make_float4(r.x, r.y, e.x, e.y);
            },
            [&](int m, int n, float a0, float a1, const float2& b, const float4& q, bool valid) {
              const float v0 = __fadd_rn(q.x, __fadd_rn(a0, b.x));
              const float v1 = __fadd_rn(q.y, __fadd_rn(a1, b.y));
              if constexpr (!LAST) {
                if (valid) {
                  *reinterpret_cast<float2*>(base + m * C + n) = make_float2(v0, v1);
                  *reinterpret_cast<float2*>(A + m * AS + n) = make_float2(lrelu1(v0), lrelu1(v1));
                }
              } else {
                sink.store(m, n, make_float2(q.z, q.w), v0, v1, valid);
              }
            });
  }
};

struct TcF32Params {
  const float* x;      // (B, T, C) float32
  long long x_bs;
  int T;
  float* sum;          // (B, T, C) float32: the chain (WRITE), or the
  long long sum_bs;    // first of n_acc <= 2 earlier chains, sum_cs apart (FINAL)
  long long sum_cs;
  float* out;          // (B, T, C) float32 (FINAL)
  long long out_bs;
  int mode, n_acc;
  float scale;
  StepBf steps[kMaxSteps];  // w1/w2: pack_stage_tf32's stages
  int n_steps, k;
  int bm;
  float* scratch;      // per block (bm + 2*halo) x C floats
  int n_tiles, n_items;
};

// the weight loads one block item consumes, in order (Pipe's schedule)
template <int C>
__host__ __device__ int tc_f32_schedule(Ld* sched, const TcF32Params& p, int wrows) {
  int n = 0, lo = 0, hi = wrows;
  for (int i = 0; i < p.n_steps; ++i) {
    n = ChainF32<C>::schedule(sched, n, lo, hi, p.steps[i], p.k);
    lo += (p.steps[i].dil + 1) * ((p.k - 1) / 2);
    hi -= (p.steps[i].dil + 1) * ((p.k - 1) / 2);
  }
  return n;
}

// shared memory: ring | A (wrows rows of C + 4 floats) | schedule. fits: the
// launch takes it (vocoder_kernels._tc_f32_smem mirrors this, and a CPU test
// compiles it for the host to hold them equal).
template <int C>
struct TcF32Layout {
  using CV = typename ChainF32<C>::CV;
  int h, wrows;
  size_t ring, a, total;
  bool fits;
  __host__ __device__ TcF32Layout(const TcF32Params& p) {
    h = chain_halo(p.k, p.steps, p.n_steps);
    wrows = p.bm + 2 * h;
    ring = (size_t)TcF32Cfg<C>::NBUF * CV::STAGE;
    a = (size_t)wrows * CV::AS * 4;
    total = ring + a + sizeof(Ld) * (size_t)tc_f32_schedule<C>(nullptr, p, wrows);
    fits = total <= (size_t)kSmemMax;
  }
};

template <int C, bool FINAL>
__global__ void __launch_bounds__(TcF32Cfg<C>::NW * 32, 1) tc_f32_kernel(const TcF32Params p) {
  using CH = ChainF32<C>;
  constexpr int NTH = TcF32Cfg<C>::NW * 32, AS = CH::AS;
  const TcF32Layout<C> L(p);
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  float* A = reinterpret_cast<float*>(smem + L.ring);
  Ld* sched = reinterpret_cast<Ld*>(smem + L.ring + L.a);
  float* R = p.scratch + (size_t)blockIdx.x * L.wrows * C;
  const int n_sched = tc_f32_schedule<C>(nullptr, p, L.wrows);
  if (threadIdx.x == 0) tc_f32_schedule<C>(sched, p, L.wrows);
  __syncthreads();
  Pipe<TcF32Cfg<C>::NBUF, CH::CV::STAGE, NTH, 0> pipe;
  pipe.start(ring, sched, n_sched);
  const int half = (p.k - 1) / 2;
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const int b = item / p.n_tiles;
    const int n0 = (item - b * p.n_tiles) * p.bm;
    // R rows [0, wrows) <- x samples [n0 - h, n0 + bm + h), zero outside
    // [0, T); A <- their lrelu
    load_window_f32<C, AS, NTH>(R, A, p.x + b * p.x_bs, n0 - L.h, L.wrows, p.T);
    __syncthreads();
    int lo = 0, hi = L.wrows;
    const TcSink<C, FINAL, float> sink{p.sum + b * p.sum_bs, p.sum_cs, p.out + b * p.out_bs,
                                       p.n_acc, p.T, n0, p.scale};
    for (int si = 0; si < p.n_steps; ++si) {
      const StepBf& st = p.steps[si];
      if (si + 1 < p.n_steps)
        CH::template step<false>(pipe, R, lo, hi, st, p.k, A, sink);
      else
        CH::template step<true>(pipe, R, lo, hi, st, p.k, A, sink);
      lo += (st.dil + 1) * half;
      hi -= (st.dil + 1) * half;
    }
  }
  pipe.finish();
}

template <int C>
cudaError_t launch_tc_f32(TcF32Params& p, int B, int kch, long long scratch_floats, int slots,
                          cudaStream_t stream) {
  using CF = TcF32Cfg<C>;
  if (kch != CF::KCH || p.bm < 8 || p.bm % 8 || slots < 1 || p.n_steps < 1 ||
      p.n_steps > kMaxSteps || p.k < 1 || p.k % 2 == 0 ||
      (p.mode != kWrite && p.mode != kFinal) || p.n_acc < 0 || p.n_acc > kMaxChains - 1)
    return cudaErrorInvalidValue;
  const TcF32Layout<C> L(p);
  if (!L.fits) return cudaErrorInvalidValue;
  p.n_tiles = (p.T + p.bm - 1) / p.bm;
  p.n_items = p.n_tiles * B;
  if (p.n_items <= 0) return cudaSuccess;
  const int grid = p.n_items < slots ? p.n_items : slots;
  if ((long long)L.wrows * C * grid > scratch_floats) return cudaErrorInvalidValue;
  const void* kern = p.mode == kFinal ? reinterpret_cast<const void*>(&tc_f32_kernel<C, true>)
                                       : reinterpret_cast<const void*>(&tc_f32_kernel<C, false>);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return e;
  void* args[] = {&p};
  e = cudaLaunchKernel(kern, dim3(grid), dim3(CF::NW * 32), args, L.total, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// phase_f32_kernel: upsample + MRF group (+ conv_post) of a narrow level

using bfe::SumSink;

// per (C_in, C): input channels per weight stage of the upsample conv (C_in
// -> C, one tap a stage; its warps and tiles are the chains', TcF32Cfg<C>);
// output samples per block are the plan's (vocoder_kernels.PHASE_F32_UKCH)
template <int CIN, int C> struct PhaseF32Cfg;
template <> struct PhaseF32Cfg<128, 64> {
  static constexpr int UKCH = 32;
};
template <> struct PhaseF32Cfg<64, 32> {
  static constexpr int UKCH = 32;
};

struct PhaseF32Params {
  const float* x;       // (B, C_in, T_in) through strides: x_cs == 1 or x_ts == 1
  long long x_bs, x_cs, x_ts;
  int t_in;
  float* out;           // (B, C, N), or with conv_post (B, 1, N)
  long long out_bs;
  const int8_t* wu;     // per phase r (wu_phase bytes apart): ntaps taps, staged
  long long wu_phase;
  const float* bu;      // (C,)
  int stride, ntaps, amin, span, rows_r[8];
  int N, hx, P, kpost;
  const float* wp;      // (kpost, C) conv_post taps
  float bp, scale;
  StepBf steps[kMaxChains][kMaxSteps];  // w1/w2: pack_stage_tf32's stages
  int k[kMaxChains], n_steps[kMaxChains], n_chains;
  int bm;
  float* scratch;       // per block (arows + bm + 2P) x C floats (PhaseF32Layout)
  int n_tiles, n_items;
};

template <int CIN, int C>
struct PhaseF32Types {
  using CF = TcF32Cfg<C>;
  using CH = ChainF32<C>;
  using UC = ConvF32<CIN, C, CF::NW, CF::MT, CF::NT, PhaseF32Cfg<CIN, C>::UKCH>;
  static constexpr int SLOT = CH::CV::STAGE > UC::STAGE ? CH::CV::STAGE : UC::STAGE;
};

// the weight loads one block item consumes, in order: the upsample's
// phases, then each chain's steps on its own window (rows [0, bm + 2*halo
// + 2P))
template <int CIN, int C>
__host__ __device__ int phase_f32_schedule(Ld* sched, const PhaseF32Params& p) {
  using T = PhaseF32Types<CIN, C>;
  int n = 0;
  const int mu = (p.bm + 2 * p.hx) / p.stride;
  for (int r = 0; r < p.stride; ++r) n = T::UC::schedule(sched, n, p.wu + r * p.wu_phase, mu, p.ntaps);
  for (int j = 0; j < p.n_chains; ++j) {
    const int k = p.k[j], half = (k - 1) / 2;
    int lo = 0, hi = p.bm + 2 * chain_halo(k, p.steps[j], p.n_steps[j]) + 2 * p.P;
    for (int i = 0; i < p.n_steps[j]; ++i) {
      n = T::CH::schedule(sched, n, lo, hi, p.steps[j][i], k);
      lo += (p.steps[j][i].dil + 1) * half;
      hi -= (p.steps[j][i].dil + 1) * half;
    }
  }
  return n;
}

// shared memory: ring | X0 (wrows rows of C + 4 floats) | A (arows rows of
// C + 4 floats; first the x tile, xrows rows of C_in + 4) | schedule. The
// scratch slice: R (arows rows of C floats) | O (orows rows of C floats).
// conv_post's lrelu'd sums (rows of C + 1 floats) and the transposed output
// tile (C rows of bm + 4 floats) reuse X0 and A. fits: the launch takes it
// (vocoder_kernels._phase_f32_smem mirrors this, and a CPU test compiles it
// for the host to hold them equal).
template <int CIN, int C>
struct PhaseF32Layout {
  using T = PhaseF32Types<CIN, C>;
  static constexpr int XS = C + 4, QS = CIN + 4, TP = 4;
  int wrows, arows, xrows, orows;
  size_t ring, x0, a, total, scratch;
  bool fits;
  __host__ __device__ PhaseF32Layout(const PhaseF32Params& p) {
    wrows = p.bm + 2 * p.hx;
    arows = 0;
    for (int j = 0; j < p.n_chains; ++j) {
      const int r = p.bm + 2 * chain_halo(p.k[j], p.steps[j], p.n_steps[j]) + 2 * p.P;
      arows = arows > r ? arows : r;
    }
    xrows = wrows / p.stride + p.span;
    orows = p.bm + 2 * p.P;
    ring = (size_t)T::CF::NBUF * T::SLOT;
    x0 = (size_t)wrows * XS * 4;
    const size_t ac = (size_t)arows * XS * 4, xq = (size_t)xrows * QS * 4;
    a = ac > xq ? ac : xq;
    total = ring + x0 + a + sizeof(Ld) * (size_t)phase_f32_schedule<CIN, C>(nullptr, p);
    scratch = (size_t)(arows + orows) * C;
    fits = total <= (size_t)kSmemMax && (size_t)orows * (C + 1) * 4 <= x0 + a &&
           (size_t)C * (p.bm + TP) * 4 <= x0 + a;
  }
};

template <int CIN, int C>
__global__ void __launch_bounds__(TcF32Cfg<C>::NW * 32, 1)
    phase_f32_kernel(const PhaseF32Params p) {
  using T = PhaseF32Types<CIN, C>;
  using CH = typename T::CH;
  using UC = typename T::UC;
  using L_t = PhaseF32Layout<CIN, C>;
  constexpr int NTH = T::CF::NW * 32, XS = L_t::XS, QS = L_t::QS, AS = CH::AS;
  static_assert(AS == XS && UC::AS == QS, "tile rows");
  const L_t L(p);
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  float* X0 = reinterpret_cast<float*>(smem + L.ring);
  float* A = reinterpret_cast<float*>(smem + L.ring + L.x0);
  float* Xq = A;
  Ld* sched = reinterpret_cast<Ld*>(smem + L.ring + L.x0 + L.a);
  float* R = p.scratch + (size_t)blockIdx.x * L.scratch;
  float* O = R + (size_t)L.arows * C;
  const int n_sched = phase_f32_schedule<CIN, C>(nullptr, p);
  if (threadIdx.x == 0) phase_f32_schedule<CIN, C>(sched, p);
  __syncthreads();
  Pipe<T::CF::NBUF, T::SLOT, NTH, 0> pipe;
  pipe.start(ring, sched, n_sched);
  const int mu = L.wrows / p.stride;
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const int b = item / p.n_tiles;
    const int n0 = (item - b * p.n_tiles) * p.bm;
    // Xq row q <- lrelu(x) at input sample base_in + q, zero outside the
    // utterance (window row w = sample n0 - hx + w; position m's phase r
    // reads Xq rows m + rows_r[r] + t)
    const int base_in = (n0 - p.hx) / p.stride + p.amin;
    const float* xb = p.x + b * p.x_bs;
    if (p.x_cs == 1) {   // channel-last: 4 channels a thread
      for (int i = threadIdx.x; i < L.xrows * (CIN / 4); i += NTH) {
        const int q = i / (CIN / 4), c = (i - q * (CIN / 4)) * 4;
        const int s = base_in + q;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (s >= 0 && s < p.t_in) v = __ldg(reinterpret_cast<const float4*>(xb + (long long)s * p.x_ts + c));
        *reinterpret_cast<float4*>(Xq + q * QS + c) =
            make_float4(lrelu1(v.x), lrelu1(v.y), lrelu1(v.z), lrelu1(v.w));
      }
    } else {             // channel-major: threads walk time
      for (int i = threadIdx.x; i < L.xrows * CIN; i += NTH) {
        const int c = i / L.xrows, q = i - c * L.xrows;
        const int s = base_in + q;
        float f = 0.f;
        if (s >= 0 && s < p.t_in) f = __ldg(xb + c * p.x_cs + (long long)s * p.x_ts);
        Xq[q * QS + c] = lrelu1(f);
      }
    }
    __syncthreads();
    // X0 row stride*m + r <- the upsample, acc + bias
    for (int r = 0; r < p.stride; ++r) {
      const float* bu = p.bu;
      const int stride = p.stride;
      UC::run(pipe, Xq + p.rows_r[r] * QS, L.xrows - p.rows_r[r], mu, 1, p.ntaps,
              [&](int n) { return bfe::bias2(bu, n); }, [](int, int, bool) { return 0; },
              [&](int m, int n, float a0, float a1, const float2& c, int, bool valid) {
                const float2 v = make_float2(__fadd_rn(a0, c.x), __fadd_rn(a1, c.y));
                if (valid) *reinterpret_cast<float2*>(X0 + (stride * m + r) * XS + n) = v;
              });
    }
    for (int j = 0; j < p.n_chains; ++j) {
      const int k = p.k[j], half = (k - 1) / 2;
      const int n_steps = p.n_steps[j];
      const int h = chain_halo(k, p.steps[j], n_steps);
      // R rows [0, W) <- X0 rows [lo, lo + W), A rows [0, W) <- their lrelu
      const int lo = p.hx - h - p.P, W = p.bm + 2 * h + 2 * p.P;
      for (int i = threadIdx.x; i < W * (C / 4); i += NTH) {
        const int ra = i / (C / 4), c = (i - ra * (C / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(X0 + (lo + ra) * XS + c);
        *reinterpret_cast<float4*>(R + ra * C + c) = v;
        *reinterpret_cast<float4*>(A + ra * AS + c) =
            make_float4(lrelu1(v.x), lrelu1(v.y), lrelu1(v.z), lrelu1(v.w));
      }
      __syncthreads();
      const SumSink<C> sink{O, j == 0};
      int slo = 0, shi = W;
      for (int si = 0; si < n_steps; ++si) {
        const StepBf& st = p.steps[j][si];
        if (si + 1 < n_steps)
          CH::template step<false>(pipe, R, slo, shi, st, k, A, sink);
        else
          CH::template step<true>(pipe, R, slo, shi, st, k, A, sink);
        slo += (st.dil + 1) * half;
        shi -= (st.dil + 1) * half;
      }
    }
    // O rows [0, bm + 2P): the chain sum at samples [n0 - P, n0 + bm + P)
    if (p.kpost == 0) {
      // (B, C, N): sum * scale through a transposed tile Tt[c][m]
      float* Tt = X0;
      const int tw = p.bm + L_t::TP;
      for (int i = threadIdx.x; i < p.bm * (C / 2); i += NTH) {
        const int m = i / (C / 2), n = (i - m * (C / 2)) * 2;
        const float2 v = *reinterpret_cast<const float2*>(O + m * C + n);
        Tt[n * tw + m] = __fmul_rn(v.x, p.scale);
        Tt[(n + 1) * tw + m] = __fmul_rn(v.y, p.scale);
      }
      __syncthreads();
      float* out = p.out + b * p.out_bs + n0;
      const int len = p.N - n0 < p.bm ? p.N - n0 : p.bm;
      for (int i = threadIdx.x; i < C * (p.bm / 4); i += NTH) {
        const int c = i / (p.bm / 4), m = (i - c * (p.bm / 4)) * 4;
        if (m >= len) continue;
        const float* src = Tt + c * tw + m;
        float* dst = out + (long long)c * p.N + m;
        if (m + 4 <= len && ((p.N | n0) & 3) == 0) {
          *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
        } else {
          for (int e = 0; e < 4 && m + e < len; ++e) dst[e] = src[e];
        }
      }
    } else {
      // lrelu of the scaled sum (rows C + 1 floats apart: one bank per
      // row), then per sample the taps in order, + bias, tanh
      float* Q = X0;
      for (int i = threadIdx.x; i < L.orows * C; i += NTH) {
        const int m = i / C, n = i - m * C;
        Q[m * (C + 1) + n] = lrelu1(__fmul_rn(O[m * C + n], p.scale));
      }
      __syncthreads();
      float* out = p.out + b * p.out_bs + n0;
      for (int m = threadIdx.x; m < p.bm; m += NTH) {
        if (n0 + m >= p.N) continue;
        float acc = 0.f;
        for (int tap = 0; tap < p.kpost; ++tap) {
          const float* row = Q + (m + tap) * (C + 1);
          const float* wt = p.wp + tap * C;
#pragma unroll 8
          for (int c = 0; c < C; ++c) acc = fmaf(row[c], __ldg(wt + c), acc);
        }
        out[m] = tanhf(__fadd_rn(acc, p.bp));
      }
    }
    __syncthreads();
  }
  pipe.finish();
}

// cfg: taps and input channels per stage of the chain convs and of the
// upsample, and whether the float32 windows live in shared memory
// (vocoder_kernels._phase_args): 1, KCH, 1, UKCH, 0 here.
template <int CIN, int C>
cudaError_t launch_phase_f32(PhaseF32Params& p, int B, const int* cfg, long long scratch_floats,
                             int slots, cudaStream_t stream) {
  using CF = TcF32Cfg<C>;
  if (cfg[0] != 1 || cfg[1] != CF::KCH || cfg[2] != 1 || cfg[3] != PhaseF32Cfg<CIN, C>::UKCH ||
      cfg[4] != 0)
    return cudaErrorInvalidValue;
  int hmax = 0;
  for (int j = 0; j < p.n_chains; ++j) {
    const int h = chain_halo(p.k[j], p.steps[j], p.n_steps[j]);
    hmax = h > hmax ? h : hmax;
  }
  if (p.bm < 8 || p.bm % 8 || p.bm % p.stride || p.hx % p.stride || p.hx < hmax + p.P ||
      slots < 1 || (p.x_cs != 1 && p.x_ts != 1) || p.ntaps < 1 ||
      p.wu_phase != (long long)p.ntaps * CIN * C * 8)
    return cudaErrorInvalidValue;
  // channel-last rows of 16-byte-aligned channels (float4 loads)
  if (p.x_cs == 1 && ((p.x_ts | p.x_bs) % 4 || reinterpret_cast<uintptr_t>(p.x) % 16))
    return cudaErrorInvalidValue;
  const PhaseF32Layout<CIN, C> L(p);
  if (!L.fits) return cudaErrorInvalidValue;
  p.n_tiles = (p.N + p.bm - 1) / p.bm;
  p.n_items = p.n_tiles * B;
  if (p.n_items <= 0) return cudaSuccess;
  const int grid = p.n_items < slots ? p.n_items : slots;
  if ((long long)L.scratch * grid > scratch_floats) return cudaErrorInvalidValue;
  const void* kern = reinterpret_cast<const void*>(&phase_f32_kernel<CIN, C>);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return e;
  void* args[] = {&p};
  e = cudaLaunchKernel(kern, dim3(grid), dim3(CF::NW * 32), args, L.total, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace f32e
}  // namespace mrf
