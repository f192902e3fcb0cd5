// ptc_fused_q8_kernel, the block-resident int8-static upsample + MRF group
// (+ conv_post) of a narrow level: fused_mrf_ptc's static mode (mrf_ptc.cu)
// and fused_mrf_phase_q8's q8f mode (mrf_phase_q8.cu), which compute the
// same function on different tiles (the tile sets only the upsample's
// input scale, which amax_kernel takes before the launch), and, with S,
// fused_mrf_phase_q8's q8s mode: the same kernel with q8s's float32
// conv1 -> conv2 boundary and each step's input quantised by q_static
// (Chain::step<true>). The design is in mrf_ptc.cu's header.
//
// Without the prologue (C_in == C: PtcCfg<64, 64> and <32, 32>) the same
// kernel is one launch a level of the static levels that take no fused
// upsample: fused_mrf_ct's q8f and q8s modes (mrf_ct_q8.cu) and
// fused_mrf_phase's without prologue (mrf_phase_q8.cu). Static scales make
// those the zero-padded valid chains of mrf_tc_q8.cu whatever the tile, so
// there is no amax launch and one segment an utterance: a block loads its
// chain's x window [n0 - h, n0 + BM + h) (zero outside the utterance) into
// R, quantised for the chain's first step as it lands (tc_chain_q8_kernel's
// x load, q_in<S>), once per chain in place of the upsample.
#pragma once

#include "mrf_chain_q8.cuh"

namespace mrf {
namespace blk {

constexpr int kMaxChains = 3;

// per (C_in, C): warps, output samples per block, rows per warp (16 per
// m64 block), taps and input channels per stage of the chain convs and of
// the upsample, ring slots and the ring's lag (chosen on the card)
template <int CIN, int C> struct PtcCfg;
template <> struct PtcCfg<128, 64> {
  static constexpr int NW = 16, BM = 128, WM = 16, TPS = 4, KCH = 64, UTPS = 2, UKCH = 128,
                       NBUF = 3, LAG = 1;
};
template <> struct PtcCfg<64, 32> {
  static constexpr int NW = 16, BM = 256, WM = 32, TPS = 8, KCH = 32, UTPS = 2, UKCH = 64,
                       NBUF = 3, LAG = 1;
};
// no upsample: the chain convs' stages of the same width (the upsample's
// entries repeat them); BM the largest block whose k = 11 window (BM + 120
// rows) one MMA pass holds
template <> struct PtcCfg<64, 64> {
  static constexpr int NW = 16, BM = 136, WM = 16, TPS = 4, KCH = 64, UTPS = 4, UKCH = 64,
                       NBUF = 3, LAG = 1;
};
template <> struct PtcCfg<32, 32> {
  static constexpr int NW = 16, BM = 392, WM = 32, TPS = 8, KCH = 32, UTPS = 8, UKCH = 32,
                       NBUF = 3, LAG = 1;
};

struct PtcParams {
  const bf16* x;        // (B, T_in, C_in)
  long long x_bs;
  int t_in;
  const float* amax;    // per segment b*n_tiles + t (the upsample's input scale)
  bf16* out;            // (B, n_tiles*N, C), or with conv_post (B, 1, n_tiles*N)
  long long out_bs;
  const int8_t* wu;     // per phase r (wu_phase bytes apart): ntaps taps, staged
  long long wu_phase;
  const float* swu;     // (stride, C)
  const float* bu;      // (C,)
  int stride, ntaps, amin, span, rows_r[8];
  int n_tiles, tile_in, N, hx, P, kpost;
  const float* wp;      // (kpost, C) conv_post taps
  float bp, scale;
  Step steps[kMaxChains][kMaxSteps];
  int k[kMaxChains], n_steps[kMaxChains];
  int n_chains, blocks_per_tile, n_items;
};

template <int CIN, int C>
struct PtcTypes {
  using CF = PtcCfg<CIN, C>;
  static constexpr bool UPS = CIN != C;   // the upsample prologue
  using CH = Chain<C, CF::NW, CF::WM, CF::TPS, CF::KCH>;
  using UC = Conv<CIN, C, CF::NW, CF::WM, CF::UTPS, CF::UKCH>;
  static constexpr int SLOT = CH::CV::STAGE > UC::STAGE ? CH::CV::STAGE : UC::STAGE;
};

// the weight loads one block item consumes, in order (Pipe's schedule)
template <int CIN, int C>
__host__ __device__ int ptc_schedule(Ld* sched, const PtcParams& p) {
  using T = PtcTypes<CIN, C>;
  int n = 0;
  for (int j = 0; j < p.n_chains; ++j) {
    const int k = p.k[j], half = (k - 1) / 2;
    const int h = chain_halo(k, p.steps[j], p.n_steps[j]);
    int lo = p.hx - h - p.P, hi = p.hx + T::CF::BM + h + p.P;
    if constexpr (T::UPS) {
      const int mm0 = lo / p.stride, mu = (hi + p.stride - 1) / p.stride - mm0;
      for (int r = 0; r < p.stride; ++r)
        n = T::UC::schedule(sched, n, p.wu + r * p.wu_phase, mu, p.ntaps);
    }
    for (int i = 0; i < p.n_steps[j]; ++i) {
      n = T::CH::schedule(sched, n, lo, hi, p.steps[j][i], k);
      lo += (p.steps[j][i].dil + 1) * half;
      hi -= (p.steps[j][i].dil + 1) * half;
    }
  }
  return n;
}

template <int CIN, int C>
struct PtcLayout {
  using CF = PtcCfg<CIN, C>;
  static constexpr int RS = C + 8;
  int wrows, xrows;
  size_t r, o, a, xq, ring, total;
  __host__ __device__ PtcLayout(const PtcParams& p) {
    wrows = CF::BM + 2 * p.hx;
    xrows = PtcTypes<CIN, C>::UPS ? wrows / p.stride + p.span : 0;
    r = (size_t)wrows * RS * 4;
    o = (size_t)(CF::BM + 2 * p.P) * RS * 4;
    a = (size_t)wrows * C;
    xq = (size_t)xrows * CIN;
    ring = (size_t)CF::NBUF * PtcTypes<CIN, C>::SLOT;
    total = ring + r + o + 2 * a + xq + sizeof(Ld) * (size_t)ptc_schedule<CIN, C>(nullptr, p);
  }
};

template <int CIN, int C, bool S>
__global__ void __launch_bounds__(PtcCfg<CIN, C>::NW * 32, 1) ptc_fused_q8_kernel(const PtcParams p) {
  using CF = PtcCfg<CIN, C>;
  using CH = typename PtcTypes<CIN, C>::CH;
  using UC = typename PtcTypes<CIN, C>::UC;
  constexpr int RS = CH::RS, NTH = CF::NW * 32, BM = CF::BM;
  constexpr bool UPS = PtcTypes<CIN, C>::UPS;
  static_assert(UPS || NTH % (C / 8) == 0, "a thread's channels stay fixed over the x load");
  const PtcLayout<CIN, C> L(p);
  // the ring first: its stages start on 1024-byte swizzle atoms
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  float* R = reinterpret_cast<float*>(smem + L.ring);
  float* O = reinterpret_cast<float*>(smem + L.ring + L.r);
  int8_t* A1 = reinterpret_cast<int8_t*>(smem + L.ring + L.r + L.o);
  int8_t* A2 = A1 + L.a;
  int8_t* Xq = A2 + L.a;
  Ld* sched = reinterpret_cast<Ld*>(Xq + L.xq);
  const int n_sched = ptc_schedule<CIN, C>(nullptr, p);
  if (threadIdx.x == 0) ptc_schedule<CIN, C>(sched, p);
  __syncthreads();
  Pipe<CF::NBUF, PtcTypes<CIN, C>::SLOT, NTH, CF::LAG> pipe;
  pipe.start(ring, sched, n_sched);
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const int seg = item / p.blocks_per_tile;
    const int n0 = (item - seg * p.blocks_per_tile) * BM;
    const int b = seg / p.n_tiles, t = seg - b * p.n_tiles;
    const bf16* xb = p.x + b * p.x_bs;
    float sx = 0.f;   // the upsample input's dequant scale
    if constexpr (UPS) {
      const float amax = fmaxf(p.amax[seg], 1e-30f);
      const float inv = __fdiv_rn(127.f, amax);
      sx = __fmul_rn(amax, static_cast<float>(1.0 / 127.0));
      // Xq row q <- lrelu(x) at input sample base_in + q, quantised with the
      // tile's scale (ups_q8_kernel's arithmetic), zero outside the utterance
      const int base_in = t * p.tile_in + (n0 - p.hx) / p.stride + p.amin;
      constexpr int U = 4;
      for (int i0 = threadIdx.x; i0 < L.xrows * (CIN / 8); i0 += U * NTH) {
        uint4 raw[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * NTH;
          const int q = i / (CIN / 8), c = (i - q * (CIN / 8)) * 8;
          const int s = base_in + q;
          raw[u] = make_uint4(0u, 0u, 0u, 0u);
          if (q < L.xrows && s >= 0 && s < p.t_in)
            raw[u] = __ldg(reinterpret_cast<const uint4*>(xb + (long long)s * CIN + c));
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * NTH;
          const int q = i / (CIN / 8), c = (i - q * (CIN / 8)) * 8;
          if (q >= L.xrows) break;
          const bf16* v = reinterpret_cast<const bf16*>(&raw[u]);
          // (int8)(int)rintf(l*inv), no clip (|l*inv| <= 127 inside the
          // tile's amax window), by qbits
          uint32_t w[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float f = __bfloat162float(v[e]);
            const float l = f >= 0.f ? f : __fmul_rn(kSlope, f);
            w[e] = qbits(__fmul_rn(l, inv));
          }
          *reinterpret_cast<uint2*>(Xq + swz<CIN>(q, c)) = make_uint2(
              __byte_perm(pack2(w[0], w[1]), pack2(w[2], w[3]), 0x5410),
              __byte_perm(pack2(w[4], w[5]), pack2(w[6], w[7]), 0x5410));
        }
      }
      __syncthreads();
    }
    for (int j = 0; j < p.n_chains; ++j) {
      const int k = p.k[j], half = (k - 1) / 2;
      const int h = chain_halo(k, p.steps[j], p.n_steps[j]);
      int lo = p.hx - h - p.P, hi = p.hx + BM + h + p.P;
      if constexpr (UPS) {
        // the upsample output over R rows [lo, hi), phase by phase (row =
        // stride*mm + r; R row 0 is tile sample n0 - hx), and its
        // quantisation (q_in<S>) with the chain's step 0 multipliers into A1
        const int mm0 = lo / p.stride, mu = (hi + p.stride - 1) / p.stride - mm0;
        const float* inv0 = p.steps[j][0].inv1;
        for (int r = 0; r < p.stride; ++r) {
          const float* sw = p.swu + r * C;
          const float* bu = p.bu;
          const int stride = p.stride, lo_j = lo, hi_j = hi;
          struct CU { float2 s, b, inv, neg; };
          UC::run(pipe, Xq, mm0 + p.rows_r[r], mu, 1, p.ntaps, L.xrows,
                  [&](int n) {
                    CU c;
                    c.s = __ldg(reinterpret_cast<const float2*>(sw + n));
                    c.s = make_float2(__fmul_rn(c.s.x, sx), __fmul_rn(c.s.y, sx));
                    c.b = __ldg(reinterpret_cast<const float2*>(bu + n));
                    c.inv = __ldg(reinterpret_cast<const float2*>(inv0 + n));
                    c.neg = neg2(c.inv);
                    return c;
                  },
                  [&](int m, int n, int a0, int a1, const CU& c) {
                    const int row = stride * (mm0 + m) + r;
                    const float v0 = __fmaf_rn(__int2float_rn(a0), c.s.x, c.b.x);
                    const float v1 = __fmaf_rn(__int2float_rn(a1), c.s.y, c.b.y);
                    *reinterpret_cast<float2*>(R + row * RS + n) = make_float2(v0, v1);
                    if (row >= lo_j && row < hi_j)
                      *reinterpret_cast<uint16_t*>(A1 + swz<C>(row - lo_j, n)) =
                          static_cast<uint16_t>(q_in<S>(v0, v1, c.inv, c.neg));
                  });
        }
      } else {
        // R rows [lo, hi) <- x at tile samples n0 - hx + row, zero outside
        // the utterance; A1 <- their quantisation (q_in<S>) with the
        // chain's step 0 multipliers (tc_chain_q8_kernel's x load)
        const float* inv0 = p.steps[j][0].inv1;
        const int c8 = (threadIdx.x % (C / 8)) * 8;
        float2 inv[4], neg[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          inv[e] = __ldg(reinterpret_cast<const float2*>(inv0 + c8) + e);
          neg[e] = neg2(inv[e]);
        }
        const int s0 = t * p.tile_in + n0 - p.hx;
        for (int r = lo + threadIdx.x / (C / 8); r < hi; r += NTH / (C / 8)) {
          const int s = s0 + r;
          uint4 raw = make_uint4(0u, 0u, 0u, 0u);
          if (s >= 0 && s < p.t_in)
            raw = __ldg(reinterpret_cast<const uint4*>(xb + (long long)s * C + c8));
          const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
          float2 f[4];
          uint32_t q[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            f[e] = __bfloat1622float2(v[e]);
            q[e] = q_in<S>(f[e].x, f[e].y, inv[e], neg[e]);
          }
          float* dst = R + r * RS + c8;
          *reinterpret_cast<float4*>(dst) = make_float4(f[0].x, f[0].y, f[1].x, f[1].y);
          *reinterpret_cast<float4*>(dst + 4) = make_float4(f[2].x, f[2].y, f[3].x, f[3].y);
          *reinterpret_cast<uint2*>(A1 + swz<C>(r - lo, c8)) =
              make_uint2(__byte_perm(q[0], q[1], 0x5410), __byte_perm(q[2], q[3], 0x5410));
        }
        __syncthreads();
      }
      for (int si = 0; si < p.n_steps[j]; ++si) {
        const Step& st = p.steps[j][si];
        if (si + 1 < p.n_steps[j]) {
          CH::template step<S>(pipe, R, lo, hi, st, k, A1, A2, hi - lo,
                               p.steps[j][si + 1].inv1, [](int, int, float, float) {});
        } else {
          const bool first = j == 0;
          CH::template step<S>(pipe, R, lo, hi, st, k, A1, A2, hi - lo, nullptr,
                               [&](int m, int n, float v0, float v1) {
            float2* o = reinterpret_cast<float2*>(O + m * RS + n);
            if (first) {
              *o = make_float2(v0, v1);
            } else {
              const float2 q = *o;
              *o = make_float2(__fadd_rn(q.x, v0), __fadd_rn(q.y, v1));
            }
          });
        }
        lo += (st.dil + 1) * half;
        hi -= (st.dil + 1) * half;
      }
    }
    // O rows [0, BM + 2P): the chain sum at tile samples [n0 - P, n0 + BM + P)
    if (p.kpost == 0) {
      bf16* out = p.out + b * p.out_bs + ((long long)t * p.N + n0) * C;
      for (int i = threadIdx.x; i < BM * (C / 2); i += NTH) {
        const int m = i / (C / 2), n = (i - m * (C / 2)) * 2;
        if (n0 + m >= p.N) continue;
        const float2 v = *reinterpret_cast<const float2*>(O + m * RS + n);
        __nv_bfloat162 w;
        w.x = __float2bfloat16_rn(__fmul_rn(v.x, p.scale));
        w.y = __float2bfloat16_rn(__fmul_rn(v.y, p.scale));
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)m * C + n) = w;
      }
    } else {
      // post_kernel's arithmetic: the lrelu of the scaled sum rounded to
      // bf16 (rows C + 1 floats apart in R's space: one bank per row), then
      // per sample the taps in order, tanh
      float* Q = R;
      const int orows = BM + 2 * p.P;
      for (int i = threadIdx.x; i < orows * C; i += NTH) {
        const int m = i / C, n = i - m * C;
        Q[m * (C + 1) + n] = __bfloat162float(__float2bfloat16_rn(lrelu(O[m * RS + n] * p.scale)));
      }
      __syncthreads();
      bf16* out = p.out + b * p.out_bs + (long long)t * p.N + n0;
      for (int m = threadIdx.x; m < BM; m += NTH) {
        if (n0 + m >= p.N) continue;
        float acc = 0.f;
        for (int tap = 0; tap < p.kpost; ++tap) {
          const float* row = Q + (m + tap) * (C + 1);
          const float* wt = p.wp + tap * C;
#pragma unroll 8
          for (int c = 0; c < C; ++c) acc = fmaf(row[c], __ldg(wt + c), acc);
        }
        out[m] = __float2bfloat16_rn(tanhf(acc + p.bp));
      }
    }
    __syncthreads();
  }
  pipe.finish();
}

template <int CIN, int C, bool Q8S>
cudaError_t launch_ptc_fused(PtcParams& p, const int* ints, int S, int slots, cudaStream_t stream) {
  using CF = PtcCfg<CIN, C>;
  if (ints[18] != CF::BM || ints[19] != CF::TPS || ints[20] != CF::KCH || ints[21] != CF::UTPS ||
      ints[22] != CF::UKCH)
    return cudaErrorInvalidValue;
  int hmax = 0;
  for (int j = 0; j < p.n_chains; ++j) {
    const int h = chain_halo(p.k[j], p.steps[j], p.n_steps[j]);
    hmax = h > hmax ? h : hmax;
  }
  if (p.hx % p.stride || p.hx < hmax + p.P || CF::BM % p.stride || slots < 1)
    return cudaErrorInvalidValue;
  if (PtcTypes<CIN, C>::UPS
          ? p.wu_phase != (long long)((p.ntaps + CF::UTPS - 1) / CF::UTPS) * (CIN / CF::UKCH) *
                              CF::UTPS * C * CF::UKCH
          : p.stride != 1 || p.kpost != 0 || p.n_tiles != 1 || p.N != p.t_in)
    return cudaErrorInvalidValue;
  const PtcLayout<CIN, C> L(p);
  if (L.total > 232448 || (size_t)(CF::BM + 2 * p.P) * (C + 1) * 4 > L.r)
    return cudaErrorInvalidValue;
  p.blocks_per_tile = (p.N + CF::BM - 1) / CF::BM;
  p.n_items = p.blocks_per_tile * S;
  if (p.n_items <= 0) return cudaSuccess;
  const int grid = p.n_items < slots ? p.n_items : slots;
  const void* kern = reinterpret_cast<const void*>(&ptc_fused_q8_kernel<CIN, C, Q8S>);
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return e;
  void* args[] = {&p};
  e = cudaLaunchKernel(kern, dim3(grid), dim3(CF::NW * 32), args, L.total, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace blk
}  // namespace mrf

namespace mrf {
namespace blk {

// The static modes' fused launch: PtcParams from the entry point's arrays
// (false when they are malformed). ptrs: wu, swu, bu, wp (null without
// conv_post or without upsample), then per step of each chain 7 (q8f: w1,
// inv1, b1i, m1, w2, sw2, b2) or, q8s, 8 (w1, sw1, inv1, b1, w2, sw2, inv2,
// b2: the q8s packing order, Q8S). ints: stride, ntaps, amin, span, rows_r[8],
// n_tiles, tile_in, N, hx, P, kpost, block_m, tps, kch, utps, ukch,
// wu_phase, n_chains, then per chain k, n_steps, dils[4]
// (mrf_int8._ptc_fused_args). Without upsample: stride 1, one tile an
// utterance (n_tiles 1, N = tile_in = t_in), no amax.
template <bool Q8S>
bool ptc_fused_params(PtcParams& p, const void* x, long long x_bs, int t_in,
                      const void* amax, void* out, long long out_bs, const long long* ptrs,
                      const int* ints, float scale, float post_bias) {
  p = PtcParams{};
  p.x = static_cast<const bf16*>(x);
  p.x_bs = x_bs;
  p.t_in = t_in;
  p.amax = static_cast<const float*>(amax);
  p.out = static_cast<bf16*>(out);
  p.out_bs = out_bs;
  p.wu = reinterpret_cast<const int8_t*>(ptrs[0]);
  p.swu = reinterpret_cast<const float*>(ptrs[1]);
  p.bu = reinterpret_cast<const float*>(ptrs[2]);
  p.wp = reinterpret_cast<const float*>(ptrs[3]);
  p.stride = ints[0];
  p.ntaps = ints[1];
  p.amin = ints[2];
  p.span = ints[3];
  for (int r = 0; r < 8; ++r) p.rows_r[r] = ints[4 + r];
  p.n_tiles = ints[12];
  p.tile_in = ints[13];
  p.N = ints[14];
  p.hx = ints[15];
  p.P = ints[16];
  p.kpost = ints[17];
  p.wu_phase = ints[23];
  p.n_chains = ints[24];
  p.bp = post_bias;
  p.scale = scale;
  if (p.stride < 1 || p.stride > 8 || p.n_chains < 1 || p.n_chains > kMaxChains ||
      (p.kpost > 0) != (p.wp != nullptr) || (p.kpost > 0 && p.P != (p.kpost - 1) / 2) ||
      (p.kpost == 0 && p.P != 0))
    return false;
  const long long* w = ptrs + 4;
  for (int j = 0; j < p.n_chains; ++j) {
    const int* cj = ints + 25 + 6 * j;
    p.k[j] = cj[0];
    p.n_steps[j] = cj[1];
    if (p.n_steps[j] < 1 || p.n_steps[j] > kMaxSteps || p.k[j] < 1 || p.k[j] % 2 == 0)
      return false;
    for (int i = 0; i < p.n_steps[j]; ++i, w += Q8S ? 8 : 7) {
      Step& st = p.steps[j][i];
      auto f = [&](int e) { return reinterpret_cast<const float*>(w[e]); };
      st.w1 = reinterpret_cast<const int8_t*>(w[0]);
      st.w2 = reinterpret_cast<const int8_t*>(w[4]);
      st.sw2 = f(5);
      st.dil = cj[2 + i];
      if (Q8S) {
        st.sw1 = f(1);
        st.inv1 = f(2);
        st.b1 = f(3);
        st.inv2 = f(6);
        st.b2 = f(7);
      } else {
        st.inv1 = f(1);
        st.b1i = reinterpret_cast<const int*>(w[2]);
        st.m1 = f(3);
        st.b2 = f(6);
      }
    }
  }
  return true;
}

// the launch of one (C_in, C) in the form q8s says
template <int CIN, int C>
int ptc_fused_launch(PtcParams& p, const int* ints, int S, int slots, bool q8s, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(q8s ? launch_ptc_fused<CIN, C, true>(p, ints, S, slots, s)
                   : launch_ptc_fused<CIN, C, false>(p, ints, S, slots, s));
}

}  // namespace blk
}  // namespace mrf

// The C entry points' arguments (mrf_ptc.cu, mrf_phase_q8.cu, mrf_ct_q8.cu)
// and their PtcParams.
#define MRF_PTC_FUSED_ARGS                                                                    \
  const void *x, long long x_bs, int t_in, const void *amax, void *out, long long out_bs,     \
      const long long *ptrs, const int *ints, float scale, float post_bias, int c_in, int C,  \
      int S, int slots, int q8s, void *stream
#define MRF_PTC_FUSED_PARAMS(p)                                                               \
  mrf::blk::PtcParams p;                                                                      \
  if (!(q8s ? mrf::blk::ptc_fused_params<true>(p, x, x_bs, t_in, amax, out, out_bs, ptrs,    \
                                               ints, scale, post_bias)                       \
            : mrf::blk::ptc_fused_params<false>(p, x, x_bs, t_in, amax, out, out_bs, ptrs,   \
                                                ints, scale, post_bias)))                    \
  return (int)cudaErrorInvalidValue
