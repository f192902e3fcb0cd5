// Masked self-attention backward for the FFT blocks, for Hopper.
//
// Replaces daft_exprt_tpu/ops/attention_kernels.py::fused_attention backward
// (Pallas body _bwd_kernel). With s, p and the dropout mask of
// attention_fwd.cu, recomputed from q, k, lengths and the seed:
//   pd = keep ? p * scale : 0;  dv = round_v(pd)^T . do;
//   dpd = do . v^T (float32);   dp = keep ? dpd * scale : 0;
//   ds = p * (dp - sum_row dp * p), rounded to q's type;
//   dq = ds . k;  dk = ds^T . q;
// every product accumulated in float32; dq written in q's type, dk and dv
// summed over all query rows in float32 and then written in k's / v's type.
// sum_row dp * p comes from the recomputed rows, as on the TPU (no o-based
// shortcut: a bf16 o would shift it).
//
// Two launches, so that dk and dv are summed in one fixed order and two
// calls on the same inputs give bit-identical dq, dk and dv (no atomics):
// 1. bwd_q_kernel, one block per BQ query rows of one (b, h): holds the rows'
//    (BQ, T) logits and dpd in shared memory, writes dq and each row's max,
//    sum of exponentials and sum dp * p.
// 2. bwd_kv_kernel, one block per BKV keys of one (b, h): walks all query
//    rows in order, recomputes p from those row statistics (the same float
//    operations in the same order as launch 1, so the same bits), and sums
//    dk and dv in registers.
// Rows per block of launch 1 follow T: two float32 (BQ, T) tiles must fit
// in a block's 227 KB, so BQ = 16 up to T = 1024 and 8 up to T = 2048.
//
// Bound on the card: per (b, h) the function is five T x T x D products,
// 10*T^2*D FLOPs, against 7*T*D elements moved (q, k, v, do in; dq, dk, dv
// out): operations at T >= 128 in bf16. This first version runs FMAs, not
// the tensor cores.
#include "attention_common.cuh"

namespace attn {

constexpr int BK = 64;          // keys per staged chunk (launch 1)
constexpr int kThreadsQ = 128;  // launch 1
constexpr int BKV = 64;         // keys per block (launch 2)
constexpr int RQ = 32;          // query rows per chunk (launch 2)
constexpr int kThreadsKV = 256; // launch 2

template <int BQ>
size_t smem_q_bytes(int T, int D) {
  return sizeof(float) * (2 * (size_t)BQ * D + (size_t)D * (BK + 1) + 2 * (size_t)BQ * T);
}

inline size_t smem_kv_bytes(int D) {
  return sizeof(float) * (2 * (size_t)D * (BKV + 1) + 2 * (size_t)RQ * (D + 1) + 2 * (size_t)RQ * BKV + 3 * RQ);
}

// grid: (ceil(T / BQ), B * H); q, k, v, g (= do), dq: (B, H, T, D);
// stats: row max, row sum of exp, row sum dp * p, each (B, H, T) float32
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreadsQ) bwd_q_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ g,
    const int* __restrict__ lengths, const long long* __restrict__ seed, T* __restrict__ dq,
    float* __restrict__ row_max, float* __restrict__ row_sum, float* __restrict__ row_dot, int H, int T_len,
    unsigned thr, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                    // (BQ, D)
  float* s_g = s_q + BQ * D;            // (BQ, D)
  float* s_kv = s_g + BQ * D;           // chunk (D, BK + 1) or (BK, D)
  float* s_p = s_kv + D * (BK + 1);     // (BQ, T) logits -> p -> rounded ds
  float* s_dp = s_p + BQ * T_len;       // (BQ, T) dpd -> dp
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const long long base = (long long)bh * T_len * D;
  const int len = lengths[b];
  const Dropout drop = make_dropout(seed, bh, thr, scale);

  for (int i = tid; i < BQ * D; i += kThreadsQ) {
    const int r = i / D, d = i - r * D;
    const int qi = q0 + r;
    const bool in = qi < T_len;
    s_q[i] = in ? to_f32(q[base + (long long)qi * D + d]) : 0.f;
    s_g[i] = in ? to_f32(g[base + (long long)qi * D + d]) : 0.f;
  }

  // logits and dpd: thread owns key j of the chunk and RPT query rows; each
  // dot runs over d in order from 0 (bwd_kv_kernel repeats it bit for bit)
  constexpr int RPT = BQ / 2;
  static_assert(kThreadsQ == 2 * BK, "logit mapping");
  const int j = tid % BK;
  const int rg = (tid / BK) * RPT;
  for (int k0 = 0; k0 < T_len; k0 += BK) {
    const int kj = k0 + j;
    for (int pass = 0; pass < 2; ++pass) {
      const T* src = pass == 0 ? k : v;
      const float* lhs = pass == 0 ? s_q : s_g;
      __syncthreads();
      for (int i = tid; i < BK * D; i += kThreadsQ) {
        const int jj = i / D, d = i - jj * D;
        const int kk = k0 + jj;
        s_kv[d * (BK + 1) + jj] = kk < T_len ? to_f32(src[base + (long long)kk * D + d]) : 0.f;
      }
      __syncthreads();
      float acc[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float kv = s_kv[d * (BK + 1) + j];
#pragma unroll
        for (int r = 0; r < RPT; ++r) acc[r] = fmaf(lhs[(rg + r) * D + d], kv, acc[r]);
      }
      if (kj < T_len) {
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          if (pass == 0) s_p[(rg + r) * T_len + kj] = kj < len ? acc[r] : -1e9f;
          else s_dp[(rg + r) * T_len + kj] = acc[r];
        }
      }
    }
  }
  __syncthreads();

  // per row (warp w owns rows w, w + 4, ...): softmax, dropout, sum dp * p,
  // then ds rounded to T in place of p
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < BQ; r += kThreadsQ / 32) {
    const int qi = q0 + r;
    float* pr = s_p + r * T_len;
    float* dr = s_dp + r * T_len;
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
    float dot = 0.f;
    for (int c0 = 4 * lane; c0 < T_len; c0 += 128) {
      const uint4 w = drop.on() ? drop.bits(qi, c0) : make_uint4(0u, 0u, 0u, 0u);
      for (int c = c0; c < min(c0 + 4, T_len); ++c) {
        const float p = pr[c] / sum;
        const float dp = drop.on() ? drop.apply(w, c, dr[c]) : dr[c];
        pr[c] = p;
        dr[c] = dp;
        dot = fmaf(dp, p, dot);
      }
    }
    dot = warp_sum(dot);
    for (int c = lane; c < T_len; c += 32) pr[c] = round_to<T>(pr[c] * (dr[c] - dot));
    if (lane == 0 && qi < T_len) {
      const long long o = (long long)bh * T_len + qi;
      row_max[o] = m;
      row_sum[o] = sum;
      row_dot[o] = dot;
    }
  }

  // dq = ds . k: thread owns column d and rows r0, r0 + RSTEP, ...
  constexpr int RSTEP = kThreadsQ / D;
  constexpr int NR = BQ / RSTEP;
  static_assert(kThreadsQ % D == 0 && BQ % RSTEP == 0, "output mapping");
  const int dcol = tid % D;
  const int r0 = tid / D;
  float acc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < T_len; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * D; i += kThreadsQ) {
      const int jj = i / D, d = i - jj * D;
      const int kk = k0 + jj;
      s_kv[jj * D + d] = kk < T_len ? to_f32(k[base + (long long)kk * D + d]) : 0.f;
    }
    __syncthreads();
    const int nk = min(BK, T_len - k0);
    for (int jj = 0; jj < nk; ++jj) {
      const float kv = s_kv[jj * D + dcol];
#pragma unroll
      for (int r = 0; r < NR; ++r) acc[r] = fmaf(s_p[(r0 + r * RSTEP) * T_len + k0 + jj], kv, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int qi = q0 + r0 + r * RSTEP;
    if (qi < T_len) dq[base + (long long)qi * D + dcol] = from_f32<T>(acc[r]);
  }
}

// grid: (ceil(T / BKV), B * H); dk, dv: (B, H, T, D)
template <typename T, int D>
__global__ void __launch_bounds__(kThreadsKV) bwd_kv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ g,
    const int* __restrict__ lengths, const long long* __restrict__ seed, const float* __restrict__ row_max,
    const float* __restrict__ row_sum, const float* __restrict__ row_dot, T* __restrict__ dk,
    T* __restrict__ dv, int H, int T_len, unsigned thr, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* s_kt = smem;                      // (D, BKV + 1): the block's keys
  float* s_vt = s_kt + D * (BKV + 1);      // (D, BKV + 1): their values
  float* s_q = s_vt + D * (BKV + 1);       // (RQ, D + 1): a chunk of q rows
  float* s_g = s_q + RQ * (D + 1);         // (RQ, D + 1): their do rows
  float* s_pd = s_g + RQ * (D + 1);        // (RQ, BKV): rounded pd
  float* s_ds = s_pd + RQ * BKV;           // (RQ, BKV): rounded ds
  float* s_st = s_ds + RQ * BKV;           // (3, RQ): max, sum, sum dp * p
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int j0 = blockIdx.x * BKV;
  const long long base = (long long)bh * T_len * D;
  const int len = lengths[b];
  const Dropout drop = make_dropout(seed, bh, thr, scale);

  for (int i = tid; i < BKV * D; i += kThreadsKV) {
    const int jj = i / D, d = i - jj * D;
    const int kj = j0 + jj;
    const bool in = kj < T_len;
    s_kt[d * (BKV + 1) + jj] = in ? to_f32(k[base + (long long)kj * D + d]) : 0.f;
    s_vt[d * (BKV + 1) + jj] = in ? to_f32(v[base + (long long)kj * D + d]) : 0.f;
  }

  // score mapping: thread owns row r of the chunk and keys 4u + {0..3} and
  // 32 + 4u + {0..3}, so one Philox call serves 4 keys
  static_assert(kThreadsKV == RQ * 8 && BKV == 64, "score mapping");
  const int sr = tid / 8;
  const int su = tid % 8;
  // sum mapping: thread owns column d of 16 keys jd, jd + 4, ...
  static_assert(kThreadsKV == 4 * D && BKV % 4 == 0, "sum mapping");
  const int dcol = tid % D;
  const int jd = tid / D;
  constexpr int NJ = BKV / 4;
  float acc_k[NJ], acc_v[NJ];
#pragma unroll
  for (int u = 0; u < NJ; ++u) acc_k[u] = acc_v[u] = 0.f;

  for (int i0 = 0; i0 < T_len; i0 += RQ) {
    const int nr = min(RQ, T_len - i0);
    __syncthreads();
    for (int i = tid; i < RQ * D; i += kThreadsKV) {
      const int r = i / D, d = i - r * D;
      const bool in = r < nr;
      s_q[r * (D + 1) + d] = in ? to_f32(q[base + (long long)(i0 + r) * D + d]) : 0.f;
      s_g[r * (D + 1) + d] = in ? to_f32(g[base + (long long)(i0 + r) * D + d]) : 0.f;
    }
    for (int i = tid; i < RQ; i += kThreadsKV) {
      const long long o = (long long)bh * T_len + i0 + i;
      const bool in = i < nr;
      s_st[i] = in ? row_max[o] : 0.f;
      s_st[RQ + i] = in ? row_sum[o] : 1.f;
      s_st[2 * RQ + i] = in ? row_dot[o] : 0.f;
    }
    __syncthreads();

    const float m = s_st[sr], sum = s_st[RQ + sr], dot = s_st[2 * RQ + sr];
    const int qi = i0 + sr;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int jb = half * 32 + 4 * su;
      const uint4 w = drop.on() ? drop.bits(qi, j0 + jb) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = jb + e;
        float s = 0.f, dpd = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          s = fmaf(s_q[sr * (D + 1) + d], s_kt[d * (BKV + 1) + jj], s);
          dpd = fmaf(s_g[sr * (D + 1) + d], s_vt[d * (BKV + 1) + jj], dpd);
        }
        const int kj = j0 + jj;
        float pd = 0.f, ds = 0.f;
        if (sr < nr && kj < T_len) {
          const float p = expf((kj < len ? s : -1e9f) - m) / sum;
          pd = drop.on() ? drop.apply(w, kj, p) : p;
          const float dp = drop.on() ? drop.apply(w, kj, dpd) : dpd;
          pd = round_to<T>(pd);
          ds = round_to<T>(p * (dp - dot));
        }
        s_pd[sr * BKV + jj] = pd;
        s_ds[sr * BKV + jj] = ds;
      }
    }
    __syncthreads();

    // dv_j += pd_ij * do_i and dk_j += ds_ij * q_i, over the rows in order
    for (int r = 0; r < nr; ++r) {
      const float gv = s_g[r * (D + 1) + dcol];
      const float qv = s_q[r * (D + 1) + dcol];
#pragma unroll
      for (int u = 0; u < NJ; ++u) {
        const int jj = jd + 4 * u;
        acc_v[u] = fmaf(s_pd[r * BKV + jj], gv, acc_v[u]);
        acc_k[u] = fmaf(s_ds[r * BKV + jj], qv, acc_k[u]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < NJ; ++u) {
    const int kj = j0 + jd + 4 * u;
    if (kj < T_len) {
      dk[base + (long long)kj * D + dcol] = from_f32<T>(acc_k[u]);
      dv[base + (long long)kj * D + dcol] = from_f32<T>(acc_v[u]);
    }
  }
}

template <typename T, int D, int BQ>
cudaError_t launch_q(const void* q, const void* k, const void* v, const void* g, const int* lengths,
                     const long long* seed, void* dq, float* stats, int B, int H, int T_len, unsigned thr,
                     float scale, cudaStream_t stream) {
  const size_t smem = smem_q_bytes<BQ>(T_len, D);
  const void* kern = reinterpret_cast<const void*>(&bwd_q_kernel<T, D, BQ>);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long n = (long long)B * H * T_len;
  float* row_max = stats;
  float* row_sum = stats + n;
  float* row_dot = stats + 2 * n;
  dim3 grid((T_len + BQ - 1) / BQ, B * H);
  void* args[] = {&q, &k, &v, &g, &lengths, &seed, &dq, &row_max, &row_sum, &row_dot, &H, &T_len, &thr, &scale};
  e = cudaLaunchKernel(kern, grid, dim3(kThreadsQ), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_kv(const void* q, const void* k, const void* v, const void* g, const int* lengths,
                      const long long* seed, const float* stats, void* dk, void* dv, int B, int H, int T_len,
                      unsigned thr, float scale, cudaStream_t stream) {
  const size_t smem = smem_kv_bytes(D);
  const void* kern = reinterpret_cast<const void*>(&bwd_kv_kernel<T, D>);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long n = (long long)B * H * T_len;
  const float* row_max = stats;
  const float* row_sum = stats + n;
  const float* row_dot = stats + 2 * n;
  dim3 grid((T_len + BKV - 1) / BKV, B * H);
  void* args[] = {&q, &k, &v, &g, &lengths, &seed, &row_max, &row_sum, &row_dot, &dk, &dv, &H, &T_len,
                  &thr, &scale};
  e = cudaLaunchKernel(kern, grid, dim3(kThreadsKV), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g, const int* lengths,
                   const long long* seed, void* dq, void* dk, void* dv, float* stats, int B, int H, int T_len,
                   int D, unsigned thr, float scale, cudaStream_t s) {
  // D = 64: the FFT blocks' head width (2 heads of a 128-wide model)
  if (D != 64 || T_len > 2048) return cudaErrorInvalidValue;
  cudaError_t e = T_len <= 1024
      ? launch_q<T, 64, 16>(q, k, v, g, lengths, seed, dq, stats, B, H, T_len, thr, scale, s)
      : launch_q<T, 64, 8>(q, k, v, g, lengths, seed, dq, stats, B, H, T_len, thr, scale, s);
  if (e != cudaSuccess) return e;
  return launch_kv<T, 64>(q, k, v, g, lengths, seed, stats, dk, dv, B, H, T_len, thr, scale, s);
}

}  // namespace attn

// Two launches on ``stream``. dtype: 1 = bf16, 0 = float32. thr: the
// dropout threshold (0: off; seed, an int64 on the card, is then not read).
// stats: 3 * B * H * T float32 of scratch. Returns cudaGetLastError() after
// the launches.
extern "C" int attention_bwd(const void* q, const void* k, const void* v, const void* g,
                             const void* lengths, const void* seed, void* dq, void* dk, void* dv,
                             void* stats, int B, int H, int T_len, int D, int dtype, unsigned thr,
                             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const long long* sd = static_cast<const long long*>(seed);
  float* st = static_cast<float*>(stats);
  if (dtype == 1)
    return (int)attn::launch<attn::bf16>(q, k, v, g, len, sd, dq, dk, dv, st, B, H, T_len, D, thr, scale, s);
  return (int)attn::launch<float>(q, k, v, g, len, sd, dq, dk, dv, st, B, H, T_len, D, thr, scale, s);
}
