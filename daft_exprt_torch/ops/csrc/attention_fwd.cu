// Masked self-attention forward for the FFT blocks, for Hopper.
//
// Replaces daft_exprt_tpu/ops/attention_kernels.py::fused_attention forward
// (Pallas body _fwd_kernel), dropout off. For each (b, h) and query row:
//   s = q . k^T (q pre-scaled by D^-1/2), float32;
//   s[key >= lengths[b]] = -1e9;
//   p = exp(s - max s) / sum exp(s - max s), float32, then rounded to v's type;
//   o = p . v with float32 accumulation, written in q's type.
// Like the TPU kernel it holds whole rows: a block owns BQ query rows of one
// (b, h) and keeps their (BQ, T) float32 logits in shared memory (T <= 2048),
// so the softmax is normalised before the cast exactly as on the TPU, with
// no online rescaling. K and V stream through shared memory in BK-key chunks.
//
// Bound on the card: per (b, h) the work is 4*T^2*D FLOPs (q.k and p.v)
// against 4*T*D elements moved (q, k, v in, o out): at D = 64 in bf16 that
// is T/2 FLOPs per byte, so T = 128 is bound by bytes and T = 1024 by
// operations. This first version runs FMAs, not the tensor cores.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace attn {

using bf16 = __nv_bfloat16;
constexpr int BQ = 16;       // query rows per block
constexpr int BK = 64;       // keys per staged chunk
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

inline size_t smem_bytes(int T, int D) {
  return sizeof(float) * ((size_t)BQ * D + (size_t)D * (BK + 1) + (size_t)BQ * T);
}

// grid: (ceil(T / BQ), B * H); q, k, v, o: (B, H, T, D) contiguous
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(const T* __restrict__ q,
                                                            const T* __restrict__ k,
                                                            const T* __restrict__ v,
                                                            const int* __restrict__ lengths,
                                                            T* __restrict__ o, int H, int T_len) {
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                    // (BQ, D)
  float* s_kv = s_q + BQ * D;           // K chunk (D, BK + 1) or V chunk (BK, D)
  float* s_p = s_kv + D * (BK + 1);     // (BQ, T_len) logits, then probabilities
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const long long base = (long long)bh * T_len * D;
  const int len = lengths[b];

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int qi = q0 + r;
    s_q[i] = qi < T_len ? to_f32(q[base + (long long)qi * D + d]) : 0.f;
  }

  // logits: thread owns key j of the chunk and 8 query rows
  static_assert(kThreads == 2 * BK && BQ == 16, "logit mapping");
  const int j = tid % BK;
  const int rg = (tid / BK) * 8;
  for (int k0 = 0; k0 < T_len; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * D; i += kThreads) {
      const int jj = i / D, d = i - jj * D;
      const int kj = k0 + jj;
      s_kv[d * (BK + 1) + jj] = kj < T_len ? to_f32(k[base + (long long)kj * D + d]) : 0.f;
    }
    __syncthreads();
    float acc[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kv = s_kv[d * (BK + 1) + j];
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r] = fmaf(s_q[(rg + r) * D + d], kv, acc[r]);
    }
    const int kj = k0 + j;
    if (kj < T_len) {
#pragma unroll
      for (int r = 0; r < 8; ++r) s_p[(rg + r) * T_len + kj] = kj < len ? acc[r] : -1e9f;
    }
  }
  __syncthreads();

  // softmax over whole rows: warp w owns rows 4w .. 4w+3
  const int warp = tid >> 5, lane = tid & 31;
  for (int rr = 0; rr < BQ / (kThreads / 32); ++rr) {
    float* pr = s_p + (warp * (BQ / (kThreads / 32)) + rr) * T_len;
    float m = -3.402823466e38f;
    for (int c = lane; c < T_len; c += 32) m = fmaxf(m, pr[c]);
    m = warp_max(m);
    float sum = 0.f;
    for (int c = lane; c < T_len; c += 32) {
      const float e = expf(pr[c] - m);
      pr[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < T_len; c += 32) pr[c] = to_f32(from_f32<T>(pr[c] / sum));
  }

  // o = p . v: thread owns column d and rows rg2, rg2 + step, ...
  constexpr int RSTEP = kThreads / D;
  constexpr int NR = BQ / RSTEP;
  static_assert(kThreads % D == 0 && BQ % RSTEP == 0, "output mapping");
  const int dcol = tid % D;
  const int r0 = tid / D;
  float acc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < T_len; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * D; i += kThreads) {
      const int jj = i / D, d = i - jj * D;
      const int kj = k0 + jj;
      s_kv[jj * D + d] = kj < T_len ? to_f32(v[base + (long long)kj * D + d]) : 0.f;
    }
    __syncthreads();
    const int nk = min(BK, T_len - k0);
    for (int jj = 0; jj < nk; ++jj) {
      const float vv = s_kv[jj * D + dcol];
#pragma unroll
      for (int r = 0; r < NR; ++r) acc[r] = fmaf(s_p[(r0 + r * RSTEP) * T_len + k0 + jj], vv, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int qi = q0 + r0 + r * RSTEP;
    if (qi < T_len) o[base + (long long)qi * D + dcol] = from_f32<T>(acc[r]);
  }
}

template <typename T, int D>
cudaError_t launch_t(const void* q, const void* k, const void* v, const int* lengths, void* o,
                     int B, int H, int T_len, cudaStream_t stream) {
  const size_t smem = smem_bytes(T_len, D);
  const void* kern = reinterpret_cast<const void*>(&attn_fwd_kernel<T, D>);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((T_len + BQ - 1) / BQ, B * H);
  void* args[] = {&q, &k, &v, &lengths, &o, &H, &T_len};
  e = cudaLaunchKernel(kern, grid, dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, const int* lengths, void* o,
                     int B, int H, int T_len, int D, cudaStream_t s) {
  // D = 64: the FFT blocks' head width (2 heads of a 128-wide model)
  if (D != 64) return cudaErrorInvalidValue;
  return launch_t<T, 64>(q, k, v, lengths, o, B, H, T_len, s);
}

}  // namespace attn

// dtype: 1 = bf16, 0 = float32. Returns cudaGetLastError() after the launch.
extern "C" int attention_fwd(const void* q, const void* k, const void* v, const void* lengths,
                             void* o, int B, int H, int T_len, int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (dtype == 1) return (int)attn::launch_d<attn::bf16>(q, k, v, len, o, B, H, T_len, D, s);
  return (int)attn::launch_d<float>(q, k, v, len, o, B, H, T_len, D, s);
}
