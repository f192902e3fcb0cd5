// Block-resident int8-static ResBlock1 chains for Hopper: the engine of
// mrf_tc_q8.cu (fused_mrf_tc, q8) and of ptc_fused_q8_kernel
// (mrf_ptc_fused.cuh: fused_mrf_ptc's static mode, fused_mrf_phase's q8f
// and q8s modes, and fused_mrf_ct's q8f and q8s); its chain storage and
// convs also serve the dynamic engine (mrf_dyn_blk.cuh).
//
// The arithmetic is the TPU kernels' int8-static chain step
// (vocoder_kernels.py::_fused_mrf_tc_kernel, q8 branch; the same as
// _fused_mrf_ptc_kernel's static mode), in their order:
//     q    = clip(rint(x * (x >= 0 ? inv1 : 0.1*inv1)))  s8
//     acc  = sum_tap q[n + tap*dil] . wq1[tap]          s32 (s8 x s8 dots)
//     a    = acc + b1i                                  s32
//     q2   = clip(rint(a * (a >= 0 ? m1 : 0.1*m1)))      s8
//     acc2 = sum_tap q2[n + tap] . wq2[tap]             s32
//     out  = in + fma(acc2, sw2, b2)                    f32
// or, in the q8s form (Chain::step<true>: the TPU kernels' round-3
// boundary, _fused_mrf_ct_kernel / _fused_mrf_phase_kernel q8s branches),
// q = clip(rint(lrelu(x) * inv1)) (the lrelu rounded first) and q2 =
// clip(rint(lrelu(fma(acc, sw1, b1)) * inv2)), the boundary in float32.
// Roundings: rint ties to even, saturation at +-127, the dequant as one
// __fmaf_rn (how the JAX kernels compile it on the CPU), every other f32
// operation an explicit _rn intrinsic so nvcc contracts nothing. What the
// engines change is where the data lives and how the convs run:
//
//   - A block owns BM output samples and keeps a chain's whole residual
//     window, BM + 2*halo rows x C float32, resident (shared memory, or at
//     C = 256, where it does not fit beside the s8 tiles, a per-block
//     slice of a global scratch that stays in L2). Every step of the chain
//     runs on that window with valid convs, shrinking it by the step's
//     reach, so the chain reads its input once and writes its output once.
//     The quantisation of a step's input is fused into the epilogue that
//     produces it (the x load, the upsample, the previous step's conv2).
//   - Each conv is a tap-shifted GEMM over an s8 tile in shared memory. The
//     block's weight loads (every stage of every conv, in order) stream
//     through one ring of shared-memory slots by cp.async (Pipe, in
//     mrf_wgmma.cuh with the other building blocks), across conv and item
//     boundaries, one __syncthreads per stage; all warps read the staged
//     weights.
//   - The MMA is wgmma m64nNk32 (s8, s32 accumulate) with B (the weights)
//     from shared memory through a descriptor and A from registers: a
//     tap's row offset t*d (any integer) cannot be read through an A
//     descriptor, whose swizzle repeats every 8 rows, so each warp loads
//     its A fragments with ldmatrix from per-lane row addresses. (mma.sync
//     m16n8k32, with B fragments by ldmatrix too, was slower on the card.)
//   - s8 tiles and staged weights are stored with a 16-byte-chunk XOR
//     swizzle (swz): the 8 rows of an ldmatrix land on distinct banks for
//     any row offset, and a weight tile is the canonical
//     K-major swizzled layout a wgmma descriptor reads.
//
// Bounds on the card (NVIDIA H100 80GB HBM3, 700 W; PERF.md,
// scripts/torch_mrf_ablation.py): not the int8 rate. Per level, the conv epilogues
// (requantise, dequantise, the residual update, the next step's quantise:
// ~25 dependent operations a value, run by the warps that hold the
// accumulators) take about as long as the MMAs; streaming every weight
// stage to every SM for every block (~8 GB a call at C = 128) costs about
// 15% more.
//
// Weights reach the kernels pre-packed in the staged order
// (vocoder_kernels.pack_stage_s8): per conv, stages s = g*KC + kc (tap
// group g of TPS taps, k-chunk kc of KCH input channels), each stage
// [tap in group][output channel n][KCH bytes] with the 16-byte chunks of
// row n swizzled by swz<KCH>; taps past the conv's last are zero.
#pragma once

#include "mrf_q8.cuh"
#include "mrf_wgmma.cuh"

namespace mrf {
namespace blk {

constexpr int kMaxSteps = 4;   // dilations per chain

// One chain step's weights in the staged form (vocoder_kernels.pack_stage_s8
// for the taps, (C,) vectors for the rest): q8f's conv1 -> conv2 boundary
// in s32 (b1i, m1), or q8s's in float32 (sw1, b1, inv2).
struct Step {
  const int8_t* w1;
  const float* inv1;
  const int* b1i;
  const float* m1;
  const int8_t* w2;
  const float* sw2;
  const float* b2;
  int dil;
  const float* sw1;
  const float* b1;
  const float* inv2;
};

__host__ __device__ inline int chain_halo(int k, const Step* st, int n) {
  int h = 0;
  for (int i = 0; i < n; ++i) h += (st[i].dil + 1) * ((k - 1) / 2);
  return h;
}

// The s8 value of rint(v) (ties to even) as the low byte of a float's bits,
// without the conversion unit: v + 1.5*2^23 rounds v to an integer in the
// last place (ulp 1 there), and the sum's bits are 0x4B400000 + rint(v) for
// |v| < 2^22, whose low byte is rint(v) mod 256 (0x4B400000 ends in 0x00).
// qbits_sat clamps to [-127, 127] first, which equals sat_s8(rintf(v)):
// rounding is monotonic and the bounds are integers.
__device__ __forceinline__ uint32_t qbits(float v) {
  return __float_as_uint(__fadd_rn(v, 12582912.f));
}
__device__ __forceinline__ uint32_t qbits_sat(float v) {
  return qbits(fminf(fmaxf(v, -127.f), 127.f));
}
// the low bytes of two such words as one 16-bit pair
__device__ __forceinline__ uint32_t pack2(uint32_t b0, uint32_t b1) {
  return __byte_perm(b0, b1, 0x0040);
}

// quantize_lrelu_static of two values with the negative side's multiplier
// precomputed (0.1*inv rounded once, as q_lrelu rounds it)
__device__ __forceinline__ uint32_t q2(float x0, float x1, float2 inv, float2 neg) {
  const float m0 = x0 >= 0.f ? inv.x : neg.x, m1 = x1 >= 0.f ? inv.y : neg.y;
  return pack2(qbits_sat(__fmul_rn(x0, m0)), qbits_sat(__fmul_rn(x1, m1)));
}
// q8s: quantize_static(lrelu(x), inv) of two values (q_static: the lrelu
// rounded first)
__device__ __forceinline__ uint32_t qs2(float x0, float x1, float2 inv) {
  const float l0 = x0 >= 0.f ? x0 : __fmul_rn(kSlope, x0);
  const float l1 = x1 >= 0.f ? x1 : __fmul_rn(kSlope, x1);
  return pack2(qbits_sat(__fmul_rn(l0, inv.x)), qbits_sat(__fmul_rn(l1, inv.y)));
}
// a step input's quantisation in the form S (q8s) or q8f
template <bool S>
__device__ __forceinline__ uint32_t q_in(float x0, float x1, float2 inv, float2 neg) {
  if constexpr (S) return qs2(x0, x1, inv);
  else return q2(x0, x1, inv, neg);
}
__device__ __forceinline__ float2 neg2(float2 v) {
  return make_float2(__fmul_rn(kSlope, v.x), __fmul_rn(kSlope, v.y));
}

// A chain on a float32 residual window R (row stride RS = C + 8 floats:
// rows 8 banks apart keep a half-warp's float2 accesses conflict-free),
// with the s8 conv inputs A1 (rows of the step's window, quantised) and A2.
template <int C, int NW, int WM, int TPS, int KCH>
struct Chain {
  using CV = Conv<C, C, NW, WM, TPS, KCH>;
  static constexpr int RS = C + 8;

  // the step's loads for a schedule (conv1, then conv2)
  __host__ __device__ static int schedule(Ld* sched, int n, int lo, int hi, const Step& st,
                                          int k) {
    const int M1 = hi - lo - 2 * st.dil * ((k - 1) / 2);
    n = CV::schedule(sched, n, st.w1, M1, k);
    return CV::schedule(sched, n, st.w2, M1 - 2 * ((k - 1) / 2), k);
  }

  // One step on R rows [lo, hi), whose quantised values A1 rows [0, hi -
  // lo) already hold: conv1 (dilated) requantised into A2 (S: q8s's
  // float32 boundary, else q8f's s32 one), conv2 dequantised onto the
  // residual. The new value of R row lo + r1 + r2 + m (m < hi - lo - 2*(r1
  // + r2)), the next step's row m: with inv_next (the next step's conv1
  // multiplier) it is stored back and quantised (q_in<S>) into A1 row m;
  // without (the chain's last step) it goes to out(m, n, v0, v1).
  template <bool S = false, class P, class Out>
  static __device__ __forceinline__ void step(P& pipe, float* R, int lo, int hi, const Step& st,
                                              int k, int8_t* A1, int8_t* A2, int arows,
                                              const float* inv_next, Out&& out) {
    const int half = (k - 1) / 2;
    const int r1 = st.dil * half;
    const int M1 = hi - lo - 2 * r1;
    if constexpr (S) {
      const float* sw1 = st.sw1;
      const float* b1 = st.b1;
      const float* inv2 = st.inv2;
      struct C1 { float2 s, b, inv; };
      CV::run(pipe, A1, 0, M1, st.dil, k, arows,
              [&](int n) {
                return C1{__ldg(reinterpret_cast<const float2*>(sw1 + n)),
                          __ldg(reinterpret_cast<const float2*>(b1 + n)),
                          __ldg(reinterpret_cast<const float2*>(inv2 + n))};
              },
              [&](int m, int n, int a0, int a1, const C1& c) {
                *reinterpret_cast<uint16_t*>(A2 + swz<C>(m, n)) = static_cast<uint16_t>(
                    qs2(__fmaf_rn(__int2float_rn(a0), c.s.x, c.b.x),
                        __fmaf_rn(__int2float_rn(a1), c.s.y, c.b.y), c.inv));
              });
    } else {
      const int* b1i = st.b1i;
      const float* m1 = st.m1;
      struct C1 { int2 b; float2 m, neg; };
      CV::run(pipe, A1, 0, M1, st.dil, k, arows,
              [&](int n) {
                const float2 m = __ldg(reinterpret_cast<const float2*>(m1 + n));
                return C1{__ldg(reinterpret_cast<const int2*>(b1i + n)), m, neg2(m)};
              },
              [&](int m, int n, int a0, int a1, const C1& c) {
                const int s0 = a0 + c.b.x, s1 = a1 + c.b.y;
                const float f0 = s0 >= 0 ? c.m.x : c.neg.x, f1 = s1 >= 0 ? c.m.y : c.neg.y;
                *reinterpret_cast<uint16_t*>(A2 + swz<C>(m, n)) = static_cast<uint16_t>(
                    pack2(qbits_sat(__fmul_rn(__int2float_rn(s0), f0)),
                          qbits_sat(__fmul_rn(__int2float_rn(s1), f1))));
              });
    }
    const int M2 = M1 - 2 * half;
    float* base = R + (lo + r1 + half) * RS;
    const float* sw2 = st.sw2;
    const float* b2 = st.b2;
    struct C2 { float2 s, b, inv, neg; };
    CV::run(pipe, A2, 0, M2, 1, k, M1,
            [&](int n) {
              C2 c;
              c.s = __ldg(reinterpret_cast<const float2*>(sw2 + n));
              c.b = __ldg(reinterpret_cast<const float2*>(b2 + n));
              if (inv_next != nullptr) {
                c.inv = __ldg(reinterpret_cast<const float2*>(inv_next + n));
                c.neg = neg2(c.inv);
              }
              return c;
            },
            [&](int m, int n, int a0, int a1, const C2& c) {
              float* p = base + m * RS + n;
              const float2 r = *reinterpret_cast<const float2*>(p);
              const float v0 = __fadd_rn(r.x, __fmaf_rn(__int2float_rn(a0), c.s.x, c.b.x));
              const float v1 = __fadd_rn(r.y, __fmaf_rn(__int2float_rn(a1), c.s.y, c.b.y));
              if (inv_next != nullptr) {
                *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
                *reinterpret_cast<uint16_t*>(A1 + swz<C>(m, n)) =
                    static_cast<uint16_t>(q_in<S>(v0, v1, c.inv, c.neg));
              } else {
                out(m, n, v0, v1);
              }
            });
  }
};

}  // namespace blk
}  // namespace mrf
