// Upsample + MRF group (+ conv_post) of one narrow HiFi-GAN level in the
// int8-static serving form, for Hopper.
//
// Replaces daft_exprt_tpu/ops/vocoder_kernels.py::fused_mrf_ptc, static
// mode (Pallas body _fused_mrf_ptc_kernel) with its upsample prologue and
// conv_post epilogue. The TPU kernel's phase-tc layout (p phases x C
// channels in 128 lanes) is a reshape of the sample-major (B, T, C) tensors
// the port keeps, so this file computes the same function per sample. It
// is a function of the tile: for each tile of `tile` phase rows,
//   1. amax_kernel: one dynamic scale per (utterance, tile), the amax of
//      lrelu(x) over the tile's input window [t*tile - halo_in,
//      (t+1)*tile + halo_in) rows, zero outside the utterance;
//   2. ups_q8_kernel: lrelu(x) quantised with that scale (rintf, no clip),
//      the ConvTranspose1d upsample as per-phase s8 x s8 -> s32 products
//      with per-(phase, channel) weight scales, dequantised with
//      fma(acc, sw*sx, b) into a float32 segment of tile + 2*halo rows;
//      neighbouring tiles' segments overlap and differ;
//   3. mrf::step_q8_kernel (mrf_q8.cuh): the int8-static chains on each
//      segment, one launch per (chain, dilation), segments as the batch;
//   4. without conv_post: the chain mean cast to bf16 by the last step;
//      with conv_post: mrf::post_kernel (mrf_common.cuh), lrelu of the f32
//      mean rounded to bf16, conv_post (C -> 1) on bf16 weights, tanh, bf16.
//
// Bound on the card: operations. The MRF group's 252*B*T*C^2 int8
// operations at C=64/32 and the upsample's 2*B*T_out*C_in*C_out*k/s; the
// design moves ~9 float32 passes over the segments (tiles plus halos)
// through device memory, which at C=32 takes longer than the operations.
#include "mrf_q8.cuh"

namespace mrf {

// ---- 1. per-tile amax --------------------------------------------------

constexpr int kAmaxRows = 64;

// amax_bits[seg] = max over the block's rows of |lrelu(x)| as float bits
// (non-negative floats order as their bits; the buffer starts at 0).
__global__ void __launch_bounds__(kThreads)
    amax_kernel(const bf16* x, long long x_bs, int t_in, int C, int n_tiles, int tile_in,
                int halo_in, int win_len, unsigned* amax_bits) {
  const int seg = blockIdx.y;
  const int b = seg / n_tiles, t = seg - b * n_tiles;
  const int r0 = blockIdx.x * kAmaxRows;
  const int s0 = t * tile_in - halo_in + r0;  // input sample of row r0
  const int rows = min(kAmaxRows, win_len - r0);
  const bf16* xb = x + b * x_bs;
  float m = 0.f;
  for (int idx = threadIdx.x; idx < rows * C; idx += kThreads) {
    const int i = idx / C, c = idx - i * C;
    const int s = s0 + i;
    if (s < 0 || s >= t_in) continue;
    const float v = __bfloat162float(xb[(long long)s * C + c]);
    m = fmaxf(m, fabsf(v >= 0.f ? v : __fmul_rn(kSlope, v)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float part[kThreads / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, part[w]);
    atomicMax(amax_bits + seg, __float_as_uint(m));
  }
}

// ---- 2. int8 upsample ---------------------------------------------------

struct UpsQ8Params {
  const bf16* x;  // (B, T_in, C_in) channel-last
  long long x_bs;
  int t_in;
  const float* amax;  // per segment
  float* out;         // (S, m_len * stride, C_out): segment sample stride*m + r
  long long out_bs;
  const void* w;      // per phase r: ntaps s8 taps packed by pack_mma_s8
  const float* sw;    // (stride, C_out) weight scales
  const float* bias;  // (C_out,)
  int stride, ntaps, amin, span;
  int n_tiles, tile_in, halo_m, m_len;  // segment m=0 is input t*tile_in - halo_m
  int delta[8];       // phase r reads staged rows delta[r] + m + tap
};

constexpr int kUpsRowsQ8 = 128;

template <int CIN, int COUT>
__global__ void __launch_bounds__(kThreads) ups_q8_kernel(const UpsQ8Params p) {
  constexpr int LDA = CIN + kPadS8;
  const int rows = kUpsRowsQ8 + p.span;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* a = reinterpret_cast<int8_t*>(smem);
  const int seg = blockIdx.y;
  const int b = seg / p.n_tiles, t = seg - b * p.n_tiles;
  const int m0 = blockIdx.x * kUpsRowsQ8;
  const float amax = fmaxf(p.amax[seg], 1e-30f);
  const float inv = __fdiv_rn(127.f, amax);
  const float sx = __fmul_rn(amax, static_cast<float>(1.0 / 127.0));
  const bf16* x = p.x + b * p.x_bs;
  const int g0 = t * p.tile_in - p.halo_m + m0 + p.amin;  // input sample of staged row 0
  for (int idx = threadIdx.x; idx < rows * CIN; idx += kThreads) {
    const int i = idx / CIN, c = idx - i * CIN;
    const int s = g0 + i;
    int8_t v = 0;
    if (s >= 0 && s < p.t_in) {
      const float f = __bfloat162float(x[(long long)s * CIN + c]);
      const float l = f >= 0.f ? f : __fmul_rn(kSlope, f);
      v = static_cast<int8_t>(static_cast<int>(rintf(__fmul_rn(l, inv))));
    }
    a[i * LDA + c] = v;
  }
  __syncthreads();
  float* out = p.out + seg * p.out_bs;
  const size_t phase_bytes = (size_t)p.ntaps * CIN * COUT;
  for (int r = 0; r < p.stride; ++r) {
    const void* w_r = static_cast<const char*>(p.w) + r * phase_bytes;
    const float* sw = p.sw + r * COUT;
    conv_gemm_s8<CIN, COUT>(a + p.delta[r] * LDA, LDA, kUpsRowsQ8, 1, p.ntaps, w_r,
                            [&](int m, int n, int acc) {
                              const int mm = m0 + m;
                              if (mm >= p.m_len) return;
                              out[(long long)(p.stride * mm + r) * COUT + n] = __fmaf_rn(
                                  __int2float_rn(acc), __fmul_rn(sw[n], sx), p.bias[n]);
                            });
  }
}

template <int CIN, int COUT>
cudaError_t launch_ups_q8_t(const UpsQ8Params& p, int S, cudaStream_t stream) {
  const size_t smem = (size_t)(kUpsRowsQ8 + p.span) * (CIN + kPadS8);
  const void* kern = reinterpret_cast<const void*>(&ups_q8_kernel<CIN, COUT>);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (p.m_len <= 0) return cudaSuccess;
  dim3 grid((p.m_len + kUpsRowsQ8 - 1) / kUpsRowsQ8, S);
  UpsQ8Params arg = p;
  void* args[] = {&arg};
  e = cudaLaunchKernel(kern, grid, dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace mrf

extern "C" int mrf_ptc_amax(const void* x, long long x_bs, int t_in, int c_in, int n_tiles,
                            int tile_in, int halo_in, int win_len, void* amax_bits, int S,
                            void* stream) {
  const dim3 grid((win_len + mrf::kAmaxRows - 1) / mrf::kAmaxRows, S);
  const mrf::bf16* xp = static_cast<const mrf::bf16*>(x);
  unsigned* ap = static_cast<unsigned*>(amax_bits);
  void* args[] = {&xp, &x_bs, &t_in, &c_in, &n_tiles, &tile_in, &halo_in, &win_len, &ap};
  cudaError_t e = cudaLaunchKernel(reinterpret_cast<const void*>(&mrf::amax_kernel), grid,
                                   dim3(mrf::kThreads), args, 0,
                                   static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int mrf_ptc_ups(const void* x, long long x_bs, int t_in, const void* amax, void* out,
                           long long out_bs, const void* w, const void* sw, const void* bias,
                           int stride, int ntaps, int amin, int span, const int* delta,
                           int n_tiles, int tile_in, int halo_m, int m_len, int c_in, int c_out,
                           int S, void* stream) {
  if (stride < 1 || stride > 8) return (int)cudaErrorInvalidValue;
  mrf::UpsQ8Params p;
  p.x = static_cast<const mrf::bf16*>(x);
  p.x_bs = x_bs;
  p.t_in = t_in;
  p.amax = static_cast<const float*>(amax);
  p.out = static_cast<float*>(out);
  p.out_bs = out_bs;
  p.w = w;
  p.sw = static_cast<const float*>(sw);
  p.bias = static_cast<const float*>(bias);
  p.stride = stride;
  p.ntaps = ntaps;
  p.amin = amin;
  p.span = span;
  p.n_tiles = n_tiles;
  p.tile_in = tile_in;
  p.halo_m = halo_m;
  p.m_len = m_len;
  for (int r = 0; r < 8; ++r) p.delta[r] = r < stride ? delta[r] : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_in == 128 && c_out == 64) return (int)mrf::launch_ups_q8_t<128, 64>(p, S, s);
  if (c_in == 64 && c_out == 32) return (int)mrf::launch_ups_q8_t<64, 32>(p, S, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mrf_ptc_step(MRF_Q8_STEP_ARGS) {
  MRF_Q8_PARAMS(q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return (int)mrf::launch_step_q8_c<32>(q, K, B, s);
    case 64: return (int)mrf::launch_step_q8_c<64>(q, K, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mrf_ptc_post(const void* R, long long r_bs, int r_off, int C, float scale,
                            const void* w, float bias, int kpost, void* out, int N, int S,
                            void* stream) {
  const dim3 grid((N + 255) / 256, S);
  void* args[] = {&R, &r_bs, &r_off, &C, &scale, &w, &bias, &kpost, &out, &N};
  cudaError_t e = cudaLaunchKernel(reinterpret_cast<const void*>(&mrf::post_kernel<mrf::bf16>),
                                   grid, dim3(256), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
