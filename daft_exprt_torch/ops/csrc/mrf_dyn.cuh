// The int8-dynamic conv of the HiFi-GAN MRF kernels that run one launch
// per conv (mrf_ct_q8.cu at C <= 64, mrf_phase_q8.cu without the upsample
// prologue, mrf_ptc.cu's dyn mode).
//
// In the TPU kernels' dynamic mode (vocoder_kernels.py::_fused_mrf_ct_kernel
// q8 branch, _phase_conv_q8 without act scales) every conv quantises its
// whole input window with one scale, amax(|lrelu(in)|)/127 over the window,
// so one chain step cannot be one launch: conv2's scale depends on all of
// conv1's output. One launch of `conv_dyn_kernel` is one conv over every
// tile segment (the segments are the grid's y):
//     q   = rint(lrelu(in) * (127/amax_in))            s8, no clip
//     acc = sum_tap q[n + dil*(tap - H)] . w[tap]       s32 (s8 x s8 dots)
//     v   = fma(acc, sw*amax_in/127, bias) (+ residual) f32
// written by mode (kWrite / kAdd into a float32 segment buffer, kFinal
// scaled to bf16), with max |lrelu(v)| over the launch's samples reduced
// into the segment's amax word for the next conv (atomicMax on float bits).
// Roundings follow the JAX order as in mrf_q8.cuh.
#pragma once

#include "mrf_q8.cuh"

namespace mrf {

// Sample n of tile t of utterance b at p + b*bs + t*ts + (n + off)*C
// (elements); zero unless lo <= n + t*vstep < hi. A buffer of segments has
// vstep 0; the level input x has ts = tile*C and vstep = tile.
struct SegView {
  const void* p;
  long long bs, ts;
  int off, lo, hi, vstep, f32;
};

__device__ __forceinline__ float seg_load(const SegView& v, int b, int t, int n, int c, int C) {
  const int g = n + t * v.vstep;
  if (g < v.lo || g >= v.hi) return 0.f;
  const long long i = b * v.bs + t * v.ts + (long long)(n + v.off) * C + c;
  return v.f32 ? static_cast<const float*>(v.p)[i]
               : __bfloat162float(static_cast<const bf16*>(v.p)[i]);
}

struct DynParams {
  SegView in;            // conv input
  const float* amax_in;  // per segment: amax of |lrelu(in)| over its window
  SegView res;           // residual added to the conv output (res.p null: none)
  float* out;            // float32 segments (kWrite, kAdd; read by kFinal)
  long long out_bs, out_ts;
  int out_off;
  void* fin;             // kFinal: bf16 at b*fin_bs + t*fin_ts + n*fin_ns + c*fin_cs
  long long fin_bs, fin_ts, fin_ns, fin_cs;
  int mode, has_acc;
  float scale;
  unsigned* amax_out;    // per segment, or null
  const void* w;         // s8 taps packed by pack_mma_s8
  const float* sw;       // (C,) weight scales
  const float* bias;     // (C,)
  int dil, n_lo, n_hi, n_tiles;
};

template <int C, int K>
__global__ void __launch_bounds__(kThreads) conv_dyn_kernel(const DynParams p) {
  constexpr int H = (K - 1) / 2;
  constexpr int BM = block_m_q8<C>();
  constexpr int LDA = C + kPadS8;
  const int rows = BM + (K - 1) * p.dil;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* a = reinterpret_cast<int8_t*>(smem);
  const int seg = blockIdx.y;
  const int b = seg / p.n_tiles, t = seg - b * p.n_tiles;
  const int n0 = p.n_lo + blockIdx.x * BM;
  const float amax = fmaxf(p.amax_in[seg], 1e-30f);
  const float inv = __fdiv_rn(127.f, amax);
  const float sx = __fmul_rn(amax, static_cast<float>(1.0 / 127.0));

  // conv input: samples [n0 - dil*H, n0 + BM + dil*H), quantised
  const int s0 = n0 - p.dil * H;
  for (int idx = threadIdx.x; idx < rows * C; idx += kThreads) {
    const int i = idx / C, c = idx - i * C;
    const float v = seg_load(p.in, b, t, s0 + i, c, C);
    const float l = v >= 0.f ? v : __fmul_rn(kSlope, v);
    a[i * LDA + c] = static_cast<int8_t>(static_cast<int>(rintf(__fmul_rn(l, inv))));
  }
  __syncthreads();

  float mx = 0.f;
  conv_gemm_s8<C, C>(a, LDA, BM, p.dil, K, p.w, [&](int m, int n, int acc) {
    const int s = n0 + m;
    if (s >= p.n_hi) return;
    float v = __fmaf_rn(__int2float_rn(acc), __fmul_rn(p.sw[n], sx), p.bias[n]);
    if (p.res.p != nullptr) v = __fadd_rn(seg_load(p.res, b, t, s, n, C), v);
    mx = fmaxf(mx, abs_lrelu(v));
    float* o = p.out + b * p.out_bs + t * p.out_ts + (long long)(s + p.out_off) * C + n;
    if (p.mode == kWrite) {
      *o = v;
    } else if (p.mode == kAdd) {
      *o = __fadd_rn(*o, v);
    } else {
      const float tot = p.has_acc ? __fadd_rn(*o, v) : v;
      static_cast<bf16*>(p.fin)[b * p.fin_bs + t * p.fin_ts + (long long)s * p.fin_ns +
                                (long long)n * p.fin_cs] = __float2bfloat16_rn(__fmul_rn(tot, p.scale));
    }
  });
  if (p.amax_out != nullptr) block_amax(mx, p.amax_out + seg);
}

template <int C, int K>
cudaError_t launch_conv_dyn_t(const DynParams& p, int S, cudaStream_t stream) {
  constexpr int BM = block_m_q8<C>();
  const size_t smem = (size_t)(BM + (K - 1) * p.dil) * (C + kPadS8);
  const void* kern = reinterpret_cast<const void*>(&conv_dyn_kernel<C, K>);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int n = p.n_hi - p.n_lo;
  if (n <= 0) return cudaSuccess;
  dim3 grid((n + BM - 1) / BM, S);
  DynParams arg = p;
  void* args[] = {&arg};
  e = cudaLaunchKernel(kern, grid, dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_conv_dyn_c(const DynParams& p, int K, int S, cudaStream_t s) {
  switch (K) {
    case 3: return launch_conv_dyn_t<C, 3>(p, S, s);
    case 7: return launch_conv_dyn_t<C, 7>(p, S, s);
    case 11: return launch_conv_dyn_t<C, 11>(p, S, s);
    default: return cudaErrorInvalidValue;
  }
}

inline SegView make_view(const void* p, long long bs, long long ts, int off, int lo, int hi,
                         int vstep, int f32) {
  SegView v;
  v.p = p;
  v.bs = bs;
  v.ts = ts;
  v.off = off;
  v.lo = lo;
  v.hi = hi;
  v.vstep = vstep;
  v.f32 = f32;
  return v;
}

}  // namespace mrf

// The C entry point of both libraries' dynamic conv launchers; the argument
// order is the one mrf_int8._launch_dyn passes.
#define MRF_VIEW_ARGS(x)                                                                     \
  const void *x##_p, long long x##_bs, long long x##_ts, int x##_off, int x##_lo, int x##_hi, \
      int x##_vstep, int x##_f32
#define MRF_DYN_ARGS                                                                         \
  MRF_VIEW_ARGS(in), const void *amax_in, MRF_VIEW_ARGS(res), void *out, long long out_bs,   \
      long long out_ts, int out_off, void *fin, long long fin_bs, long long fin_ts,          \
      long long fin_ns, long long fin_cs, int mode, int has_acc, float scale,                \
      void *amax_out, const void *w, const void *sw, const void *bias, int C, int K, int dil, \
      int n_lo, int n_hi, int n_tiles, int S, void *stream
#define MRF_DYN_PARAMS(q)                                                                    \
  mrf::DynParams q;                                                                          \
  q.in = mrf::make_view(in_p, in_bs, in_ts, in_off, in_lo, in_hi, in_vstep, in_f32);         \
  q.amax_in = static_cast<const float*>(amax_in);                                            \
  q.res = mrf::make_view(res_p, res_bs, res_ts, res_off, res_lo, res_hi, res_vstep, res_f32); \
  q.out = static_cast<float*>(out);                                                          \
  q.out_bs = out_bs;                                                                         \
  q.out_ts = out_ts;                                                                         \
  q.out_off = out_off;                                                                       \
  q.fin = fin;                                                                               \
  q.fin_bs = fin_bs;                                                                         \
  q.fin_ts = fin_ts;                                                                         \
  q.fin_ns = fin_ns;                                                                         \
  q.fin_cs = fin_cs;                                                                         \
  q.mode = mode;                                                                             \
  q.has_acc = has_acc;                                                                       \
  q.scale = scale;                                                                           \
  q.amax_out = static_cast<unsigned*>(amax_out);                                             \
  q.w = w;                                                                                   \
  q.sw = static_cast<const float*>(sw);                                                      \
  q.bias = static_cast<const float*>(bias);                                                  \
  q.dil = dil;                                                                               \
  q.n_lo = n_lo;                                                                             \
  q.n_hi = n_hi;                                                                             \
  q.n_tiles = n_tiles
