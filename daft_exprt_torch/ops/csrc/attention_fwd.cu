// Masked self-attention forward for the FFT blocks, for Hopper.
//
// Replaces daft_exprt_tpu/ops/attention_kernels.py::fused_attention forward
// (Pallas body _fwd_kernel). For each (b, h) and query row:
//   s = q . k^T (q pre-scaled by D^-1/2), float32;
//   s[key >= lengths[b]] = -1e9;
//   p = exp(s - max s) / sum exp(s - max s), float32;
//   with dropout (thr > 0): p = keep ? p * scale : 0, the mask from
//   attention_common.cuh's Philox bits (the backward regenerates it);
//   p rounded to v's type; o = p . v with float32 accumulation, in q's type.
// Like the TPU kernel it holds whole rows: a block owns BQ query rows of one
// (b, h) and keeps their (BQ, T) float32 logits in shared memory (T <= 2048),
// so the softmax is normalised before the cast exactly as on the TPU, with
// no online rescaling. K and V stream through shared memory in BK-key chunks.
//
// Bound on the card: per (b, h) the work is 4*T^2*D FLOPs (q.k and p.v)
// against 4*T*D elements moved (q, k, v in, o out): at D = 64 in bf16 that
// is T/2 FLOPs per byte, so T = 128 is bound by bytes and T = 1024 by
// operations. This first version runs FMAs, not the tensor cores.
#include "attention_common.cuh"

namespace attn {

constexpr int BQ = 16;       // query rows per block
constexpr int BK = 64;       // keys per staged chunk
constexpr int kThreads = 128;

inline size_t smem_bytes(int T, int D) {
  return sizeof(float) * ((size_t)BQ * D + (size_t)D * (BK + 1) + (size_t)BQ * T);
}

// grid: (ceil(T / BQ), B * H); q, k, v, o: (B, H, T, D) contiguous
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(const T* __restrict__ q,
                                                            const T* __restrict__ k,
                                                            const T* __restrict__ v,
                                                            const int* __restrict__ lengths,
                                                            const long long* __restrict__ seed,
                                                            T* __restrict__ o, int H, int T_len,
                                                            unsigned thr, float scale) {
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
  const Dropout drop = make_dropout(seed, bh, thr, scale);

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
    if (!drop.on()) {
      for (int c = lane; c < T_len; c += 32) pr[c] = round_to<T>(pr[c] / sum);
      continue;
    }
    // lane owns groups of 4 keys: one Philox call gives their 4 words
    const int qi = q0 + warp * (BQ / (kThreads / 32)) + rr;
    for (int c0 = 4 * lane; c0 < T_len; c0 += 128) {
      const uint4 w = drop.bits(qi, c0);
      for (int c = c0; c < min(c0 + 4, T_len); ++c) pr[c] = round_to<T>(drop.apply(w, c, pr[c] / sum));
    }
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
cudaError_t launch_t(const void* q, const void* k, const void* v, const int* lengths,
                     const long long* seed, void* o, int B, int H, int T_len, unsigned thr, float scale,
                     cudaStream_t stream) {
  const size_t smem = smem_bytes(T_len, D);
  const void* kern = reinterpret_cast<const void*>(&attn_fwd_kernel<T, D>);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((T_len + BQ - 1) / BQ, B * H);
  void* args[] = {&q, &k, &v, &lengths, &seed, &o, &H, &T_len, &thr, &scale};
  e = cudaLaunchKernel(kern, grid, dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, const int* lengths,
                     const long long* seed, void* o, int B, int H, int T_len, int D, unsigned thr,
                     float scale, cudaStream_t s) {
  // D = 64: the FFT blocks' head width (2 heads of a 128-wide model)
  if (D != 64) return cudaErrorInvalidValue;
  return launch_t<T, 64>(q, k, v, lengths, seed, o, B, H, T_len, thr, scale, s);
}

}  // namespace attn

// dtype: 1 = bf16, 0 = float32. thr: the dropout threshold (0: off; seed,
// an int64 on the card, is then not read). Returns cudaGetLastError() after
// the launch.
extern "C" int attention_fwd(const void* q, const void* k, const void* v, const void* lengths,
                             const void* seed, void* o, int B, int H, int T_len, int D, int dtype,
                             unsigned thr, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const long long* sd = static_cast<const long long*>(seed);
  if (dtype == 1) return (int)attn::launch_d<attn::bf16>(q, k, v, len, sd, o, B, H, T_len, D, thr, scale, s);
  return (int)attn::launch_d<float>(q, k, v, len, sd, o, B, H, T_len, D, thr, scale, s);
}
