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
// launch 1 per block of query rows writes dq and each row's max, sum of
// exponentials and sum dp * p; launch 2 per block of keys walks all query
// rows in ascending order, forms p from those statistics (never recomputed,
// so both launches see the same bits) and sums dk and dv in registers.
//
// Bound on the card: per (b, h) the function is five T x T x D products,
// 10*T^2*D FLOPs, against 7*T*D elements moved (q, k, v, do in; dq, dk, dv
// out): operations at T >= 128 in bf16, on the tensor cores.
//
// bf16 (bwd_q_tc_kernel, bwd_kv_tc_kernel): 4 warps of 16 rows, mma.sync
// m16n8k16 with float32 accumulators, 64-row bf16 tiles through shared
// memory by cp.async, double-buffered (see attention_common.cuh). No whole
// row is held anywhere, so T has no limit.
// 1. per 64 query rows, q and do fragments in registers, K and V tiles
//    streamed twice, 32 keys at a time: (a) s = q.k^T and dpd = do.v^T give
//    the running max, the sum of exponentials and sum dp * exp(s - max),
//    rescaled together when the max grows (divided by the sum at the end);
//    (b) s and dpd again give ds, rounded to bf16 in the accumulators'
//    registers, which are the A fragments of dq += ds.k (k read through
//    ldmatrix.trans). Five products where dq needs three, for ds's one
//    rounding after the whole-row sum dp * p. Each row's statistics go to a
//    scratch as one float4 {max * log2(e), 1 / sum, sum dp * p, 0}, rows
//    padded to 64. With dropout, (a) draws the mask (one Philox call per
//    lane per 8 keys and row pair, as attention_fwd.cu) and keeps its bits
//    in a scratch, 2 words per row and 64-key tile, that (b) and launch 2
//    read: one draw per backward, not three.
// 2. per 64 keys, k and v fragments in registers, q and do tiles and their
//    rows' statistics streamed in ascending order, 32 rows at a time: s^T =
//    k.q^T and dpd^T = v.do^T, then pd^T and ds^T in bf16 registers as the
//    A fragments of dv += pd^T.do and dk += ds^T.q (q and do read through
//    ldmatrix.trans). Four products. Each lane reads one 4-bit group of the
//    mask per 8 rows x 16 keys and four shuffles deal the bits out.
// Both run 3 blocks per SM: the most their registers allow unspilled.
//
// float32 (bwd_q_f32_kernel, bwd_kv_f32_kernel): the same two launches,
// blocks, passes, statistics and mask scratch in float32, on the tensor cores
// in 3xTF32 (attention_common.cuh: three mma.sync m16n8k8 TF32 products of
// the operands' split halves per product, within the float32 band). Tiles of
// 64 rows x 64 float32 (68-float rows, conflict-free 32-bit LDS for both
// fragment reads, so no transposed copy is needed) stream through shared
// memory beside the block's own two tiles (q and do, or k and v), which are
// read from there too (104 KB, 2 blocks per SM); every operand is split where
// it is read. ds (launch 1) and pd^T, ds^T (launch 2) stay in the
// accumulators' registers, which with the 8 keys or rows of each step
// permuted are the A fragments of the next product; each 64-key (64-row)
// tile's dq (dk, dv) is summed in its own accumulator and added once. Bound
// at (16, 2, 1024, 64): the 5 products at a third of the TF32 rate, 0.130 ms;
// the kernels issue 9 (27 TF32 products).
#include "attention_common.cuh"

namespace attn {

// ---- bf16 on the tensor cores -----------------------------------------------

constexpr int kBwdBlocksPerSm = 3;   // <= 168 registers a thread, no spills

// grid: (ceil(T / 64), B * H); q, k, v, g (= do), dq: (B, H, T, 64) bf16;
// stats: per row {max * log2(e), 1 / sum of exp, sum dp * p, 0}, (B * H, Tp)
// float4 with Tp = T rounded up to 64 (rows past T: zeros); keep_words
// (dropout only): per (b, h), key tile and row, two words of mask bits
// (word h, nibble n: keys 4 * (2n + h) .. + 3 of the tile)
__global__ void __launch_bounds__(kTcThreads, kBwdBlocksPerSm) bwd_q_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v, const bf16* __restrict__ g,
    const int* __restrict__ lengths, const long long* __restrict__ seed, bf16* __restrict__ dq,
    float4* __restrict__ stats, uint32_t* __restrict__ keep_words, int H, int T_len, unsigned thr, float scale) {
  __shared__ __align__(16) bf16 s_k[2][kTileElems];   // q and do first, in the second buffers
  __shared__ __align__(16) bf16 s_v[2][kTileElems];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int len = lengths[bh / H];
  const int i0 = blockIdx.x * kTile;
  const int rg = i0 + 16 * warp + (lane >> 2);   // this thread's rows rg and rg + 8
  const size_t base = (size_t)bh * T_len * kHead;
  const Dropout drop = make_dropout(seed, bh, thr, scale);
  const int nt = (T_len + kTile - 1) / kTile;
  const int Tp = nt * kTile;
  const int valid = min(len, T_len);            // keys below: no mask
  // this lane's keep word of each key tile: the bits of its Philox calls
  // (row rg + 8 * (lane & 1), groups j0 / 4 + 2n + (t >> 1), n = 0..7)
  uint32_t* my_words = keep_words + ((size_t)bh * nt * Tp + rg + 8 * (lane & 1)) * 2 + (t >> 1);

  load_tile(s_k[1], q + base, i0, T_len);
  load_tile(s_v[1], g + base, i0, T_len);
  load_tile(s_k[0], k + base, 0, T_len);
  load_tile(s_v[0], v + base, 0, T_len);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  uint32_t qf[4][4], gf[4][4];
  load_a(qf, s_k[1], 16 * warp, lane);
  load_a(gf, s_v[1], 16 * warp, lane);
  __syncthreads();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f}, mL[2], inv_l[2], dot[2];
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // stages 0 .. nt-1: pass (a); nt .. 2nt-1: pass (b); K and V tiles each,
  // taken 32 keys at a time
  for (int st = 0; st < 2 * nt; ++st) {
    const bool pass2 = st >= nt;
    const int j0 = (pass2 ? st - nt : st) * kTile;
    if (st + 1 < 2 * nt) {
      const int nj = (st + 1 < nt ? st + 1 : st + 1 - nt) * kTile;
      load_tile(s_k[(st + 1) & 1], k + base, nj, T_len);
      load_tile(s_v[(st + 1) & 1], v + base, nj, T_len);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (st == nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], o);
          dsum[h] += __shfl_xor_sync(0xffffffffu, dsum[h], o);
        }
        mL[h] = m[h] * kLog2e;
        inv_l[h] = 1.f / l[h];
        dot[h] = dsum[h] / l[h];
      }
    }
    const bf16* sk = s_k[st & 1];
    const bf16* sv = s_v[st & 1];
    const bool full = j0 + kTile <= valid;
    uint32_t word = 0u;
    if (drop.on() && pass2) word = my_words[(size_t)(j0 / kTile) * Tp * 2];
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      float s[4][4], dpd[4][4];
      mma_abt<4>(s, qf, sk + 32 * jh * kLds, lane);
      mma_abt<4>(dpd, gf, sv + 32 * jh * kLds, lane);
      if (!full) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + 32 * jh + 8 * n + 2 * t + (c & 1);
            s[n][c] = j >= T_len ? -INFINITY : j >= len ? -1e9f : s[n][c];
          }
      }
      if (!pass2) {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) mx[c >> 1] = fmaxf(mx[c >> 1], s[n][c]);
        float mnL[2], sum[2] = {0.f, 0.f}, dps[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          mx[h] = fmaxf(m[h], mx[h]);
          mnL[h] = mx[h] * kLog2e;
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          uint32_t keep = 0xFu;
          if (drop.on()) {
            const uint32_t mine = row_draw(drop, rg, j0 + 32 * jh + 8 * n, lane);
            word |= mine << (4 * (4 * jh + n));
            keep = deal_rows(mine, lane);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float e = exp2f(fmaf(s[n][c], kLog2e, -mnL[c >> 1]));
            const float dp = drop.on() ? ((keep >> c & 1u) ? dpd[n][c] * drop.scale : 0.f) : dpd[n][c];
            sum[c >> 1] += e;
            dps[c >> 1] = fmaf(dp, e, dps[c >> 1]);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float alpha = exp2f((m[h] - mx[h]) * kLog2e);
          l[h] = l[h] * alpha + sum[h];
          dsum[h] = dsum[h] * alpha + dps[h];
          m[h] = mx[h];
        }
      } else {
        uint32_t da[2][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const uint32_t keep = drop.on() ? deal_rows(word >> (4 * (4 * jh + n)) & 0xFu, lane) : 0xFu;
          float ds[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float p = exp2f(fmaf(s[n][c], kLog2e, -mL[c >> 1])) * inv_l[c >> 1];
            const float dp = drop.on() ? ((keep >> c & 1u) ? dpd[n][c] * drop.scale : 0.f) : dpd[n][c];
            ds[c] = p * (dp - dot[c >> 1]);
          }
          da[n >> 1][2 * (n & 1)] = pack_bf16(ds[0], ds[1]);
          da[n >> 1][2 * (n & 1) + 1] = pack_bf16(ds[2], ds[3]);
        }
        mma_ab<2>(acc, da, sk, 32 * jh, lane);
      }
    }
    if (drop.on() && !pass2) my_words[(size_t)(j0 / kTile) * Tp * 2] = word;
    __syncthreads();
  }

  bf16* out = dq + base;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int d = 8 * n + 2 * t;
    if (rg < T_len)
      *reinterpret_cast<uint32_t*>(out + (size_t)rg * kHead + d) = pack_bf16(acc[n][0], acc[n][1]);
    if (rg + 8 < T_len)
      *reinterpret_cast<uint32_t*>(out + (size_t)(rg + 8) * kHead + d) = pack_bf16(acc[n][2], acc[n][3]);
  }
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = rg + 8 * h;
      stats[(size_t)bh * Tp + i] = i < T_len ? make_float4(mL[h], inv_l[h], dot[h], 0.f)
                                             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// grid: (ceil(T / 64), B * H); dk, dv: (B, H, T, 64) bf16; stats and
// keep_words as written by bwd_q_tc_kernel
__global__ void __launch_bounds__(kTcThreads, kBwdBlocksPerSm) bwd_kv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v, const bf16* __restrict__ g,
    const int* __restrict__ lengths, const long long* __restrict__ seed, const float4* __restrict__ stats,
    const uint32_t* __restrict__ keep_words, bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int T_len,
    unsigned thr, float scale) {
  __shared__ __align__(16) bf16 s_q[2][kTileElems];   // k and v first, in the second buffers
  __shared__ __align__(16) bf16 s_g[2][kTileElems];
  __shared__ __align__(16) float4 s_st[2][kTile];      // the query tile's row statistics
  __shared__ __align__(16) uint32_t s_kw[2][kTile][2];  // their keep words of this key tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lg = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int len = lengths[bh / H];
  const int j0 = blockIdx.x * kTile;
  const int kg = j0 + 16 * warp + lg;              // this thread's keys kg and kg + 8
  const bool masked[2] = {kg >= len, kg + 8 >= len};
  const size_t base = (size_t)bh * T_len * kHead;
  const Dropout drop = make_dropout(seed, bh, thr, scale);
  const int nq = (T_len + kTile - 1) / kTile;
  const int Tp = nq * kTile;
  const float4* st_bh = stats + (size_t)bh * Tp;
  const uint32_t* words = keep_words + ((size_t)bh * nq + blockIdx.x) * Tp * 2;

  // one query tile's statistics (64 copies of 16 bytes) and, with dropout,
  // its rows' keep words of this key tile (32 copies)
  auto load_stats = [&](int b, int i0) {
    const int c = threadIdx.x;
    if (c < 64) cp_async16(&s_st[b][c], st_bh + i0 + c, 16);
    else if (c < 96 && drop.on()) cp_async16(&s_kw[b][(c - 64) * 2][0], words + (size_t)i0 * 2 + (c - 64) * 4, 16);
  };
  load_tile(s_q[1], k + base, j0, T_len);
  load_tile(s_g[1], v + base, j0, T_len);
  load_tile(s_q[0], q + base, 0, T_len);
  load_tile(s_g[0], g + base, 0, T_len);
  load_stats(0, 0);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  uint32_t kf[4][4], vf[4][4];
  load_a(kf, s_q[1], 16 * warp, lane);
  load_a(vf, s_g[1], 16 * warp, lane);
  __syncthreads();

  float dka[8][4], dva[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[n][c] = dva[n][c] = 0.f;

  for (int it = 0; it < nq; ++it) {
    const int buf = it & 1;
    const int i0 = it * kTile;
    if (it + 1 < nq) {
      load_tile(s_q[buf ^ 1], q + base, i0 + kTile, T_len);
      load_tile(s_g[buf ^ 1], g + base, i0 + kTile, T_len);
      load_stats(buf ^ 1, i0 + kTile);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bool full = i0 + kTile <= T_len;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r0 = 32 * half;                   // tile rows r0 .. r0 + 31
      float s[4][4], dpd[4][4];
      mma_abt<4>(s, kf, s_q[buf] + r0 * kLds, lane);
      mma_abt<4>(dpd, vf, s_g[buf] + r0 * kLds, lane);
      uint32_t pa[2][4], da[2][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        // lane (lg, t) brings row r0 + 8n + 2t + (lg & 1), key group 4 * warp +
        // lg / 2 of the tile: nibble 2 * warp + lg / 4 of that row's word (lg / 2) & 1
        const uint32_t keep = drop.on() ? deal_cols(s_kw[buf][r0 + 8 * n + 2 * t + (lg & 1)][(lg >> 1) & 1] >>
                                                        (4 * (2 * warp + (lg >> 2))) & 0xFu, lane)
                                        : 0xFu;
        float pd[4], ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = r0 + 8 * n + 2 * t + e;           // query row i0 + r
          const float4 sr = s_st[buf][r];
          const bool in = full || i0 + r < T_len;
#pragma unroll
          for (int h = 0; h < 2; ++h) {                   // key kg + 8h
            const int c = 2 * h + e;
            const float p = exp2f(fmaf(masked[h] ? -1e9f : s[n][c], kLog2e, -sr.x)) * sr.y;
            const bool kept = (keep >> c & 1u) != 0u;
            const float pdv = drop.on() ? (kept ? p * drop.scale : 0.f) : p;
            const float dp = drop.on() ? (kept ? dpd[n][c] * drop.scale : 0.f) : dpd[n][c];
            pd[c] = in ? pdv : 0.f;
            ds[c] = in ? p * (dp - sr.z) : 0.f;
          }
        }
        // (key g, rows 2t, 2t + 1) and (key g + 8, ...): A fragments over 16 rows
        pa[n >> 1][2 * (n & 1)] = pack_bf16(pd[0], pd[1]);
        pa[n >> 1][2 * (n & 1) + 1] = pack_bf16(pd[2], pd[3]);
        da[n >> 1][2 * (n & 1)] = pack_bf16(ds[0], ds[1]);
        da[n >> 1][2 * (n & 1) + 1] = pack_bf16(ds[2], ds[3]);
      }
      mma_ab<2>(dva, pa, s_g[buf], r0, lane);
      mma_ab<2>(dka, da, s_q[buf], r0, lane);
    }
    __syncthreads();
  }

#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int d = 8 * n + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = kg + 8 * h;
      if (j < T_len) {
        const size_t o = base + (size_t)j * kHead + d;
        *reinterpret_cast<uint32_t*>(dk + o) = pack_bf16(dka[n][2 * h], dka[n][2 * h + 1]);
        *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(dva[n][2 * h], dva[n][2 * h + 1]);
      }
    }
  }
}

cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* g, const int* lengths,
                      const long long* seed, void* dq, void* dk, void* dv, float* stats, uint32_t* keep_words,
                      int B, int H, int T_len, unsigned thr, float scale, cudaStream_t stream) {
  float4* st4 = reinterpret_cast<float4*>(stats);
  dim3 grid((T_len + kTile - 1) / kTile, B * H);
  void* args_q[] = {&q, &k, &v, &g, &lengths, &seed, &dq, &st4, &keep_words, &H, &T_len, &thr, &scale};
  cudaError_t e = cudaLaunchKernel(reinterpret_cast<const void*>(&bwd_q_tc_kernel), grid, dim3(kTcThreads),
                                   args_q, 0, stream);
  if (e != cudaSuccess) return e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  void* args_kv[] = {&q, &k, &v, &g, &lengths, &seed, &st4, &keep_words, &dk, &dv, &H, &T_len, &thr, &scale};
  e = cudaLaunchKernel(reinterpret_cast<const void*>(&bwd_kv_tc_kernel), grid, dim3(kTcThreads), args_kv, 0,
                       stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---- float32 on the tensor cores (3xTF32) ------------------------------------

// dynamic shared memory: the block's own two tiles (q and do, or k and v) and
// two buffers of each streamed tile; launch 2 adds the query tile's row
// statistics and keep words
constexpr int kBwdF32Smem = 6 * kTileF * (int)sizeof(float);
constexpr int kBwdF32KvSmem = kBwdF32Smem + 2 * kTile * (int)(sizeof(float4) + 2 * sizeof(uint32_t));

// grid: (ceil(T / 64), B * H); q, k, v, g (= do), dq: (B, H, T, 64) float32;
// stats and keep_words as bwd_q_tc_kernel
__global__ void __launch_bounds__(kTcThreads, 2) bwd_q_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ g, const int* __restrict__ lengths, const long long* __restrict__ seed,
    float* __restrict__ dq, float4* __restrict__ stats, uint32_t* __restrict__ keep_words, int H, int T_len,
    unsigned thr, float scale) {
  extern __shared__ __align__(16) float smf[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* const s_q = smf + 16 * warp * kLdsF;          // this warp's 16 rows of q
  const float* const s_g = s_q + kTileF;                     // and of do
  float* const s_k = smf + 2 * kTileF;                       // buffer b at s_k + b * kTileF
  float* const s_v = smf + 4 * kTileF;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int len = lengths[bh / H];
  const int i0 = blockIdx.x * kTile;
  const int rg = i0 + 16 * warp + (lane >> 2);   // this thread's rows rg and rg + 8
  const size_t base = (size_t)bh * T_len * kHead;
  const Dropout drop = make_dropout(seed, bh, thr, scale);
  const int nt = (T_len + kTile - 1) / kTile;
  const int Tp = nt * kTile;
  const int valid = min(len, T_len);            // keys below: no mask
  uint32_t* my_words = keep_words + ((size_t)bh * nt * Tp + rg + 8 * (lane & 1)) * 2 + (t >> 1);

  load_tile_f32(smf, q + base, i0, T_len);
  load_tile_f32(smf + kTileF, g + base, i0, T_len);
  load_tile_f32(s_k, k + base, 0, T_len);
  load_tile_f32(s_v, v + base, 0, T_len);
  cp_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f}, mL[2], inv_l[2], dot[2];
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // stages 0 .. nt-1: pass (a); nt .. 2nt-1: pass (b); K and V tiles each,
  // taken 32 keys at a time
  for (int st = 0; st < 2 * nt; ++st) {
    const bool pass2 = st >= nt;
    const int j0 = (pass2 ? st - nt : st) * kTile;
    if (st + 1 < 2 * nt) {
      const int nj = (st + 1 < nt ? st + 1 : st + 1 - nt) * kTile;
      const int nb = ((st + 1) & 1) * kTileF;
      load_tile_f32(s_k + nb, k + base, nj, T_len);
      load_tile_f32(s_v + nb, v + base, nj, T_len);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (st == nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], o);
          dsum[h] += __shfl_xor_sync(0xffffffffu, dsum[h], o);
        }
        mL[h] = m[h] * kLog2e;
        inv_l[h] = 1.f / l[h];
        dot[h] = dsum[h] / l[h];
      }
    }
    const float* sk = s_k + (st & 1) * kTileF;
    const float* sv = s_v + (st & 1) * kTileF;
    const bool full = j0 + kTile <= valid;
    uint32_t word = 0u;
    if (drop.on() && pass2) word = my_words[(size_t)(j0 / kTile) * Tp * 2];
    float part[8][4];                            // this tile's ds.k (see attention_common.cuh)
#pragma unroll
    for (int n = 0; n < 8; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      float s[4][4], dpd[4][4];
      mma_abt_f32<4, 8>(s, s_q, sk + 32 * jh * kLdsF, lane);
      mma_abt_f32<4, 8>(dpd, s_g, sv + 32 * jh * kLdsF, lane);
      if (!full) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + 32 * jh + 8 * n + 2 * t + (c & 1);
            s[n][c] = j >= T_len ? -INFINITY : j >= len ? -1e9f : s[n][c];
          }
      }
      if (!pass2) {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) mx[c >> 1] = fmaxf(mx[c >> 1], s[n][c]);
        float mnL[2], sum[2] = {0.f, 0.f}, dps[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          mx[h] = fmaxf(m[h], mx[h]);
          mnL[h] = mx[h] * kLog2e;
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          uint32_t keep = 0xFu;
          if (drop.on()) {
            const uint32_t mine = row_draw(drop, rg, j0 + 32 * jh + 8 * n, lane);
            word |= mine << (4 * (4 * jh + n));
            keep = deal_rows(mine, lane);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float e = exp2f(fmaf(s[n][c], kLog2e, -mnL[c >> 1]));
            const float dp = drop.on() ? ((keep >> c & 1u) ? dpd[n][c] * drop.scale : 0.f) : dpd[n][c];
            sum[c >> 1] += e;
            dps[c >> 1] = fmaf(dp, e, dps[c >> 1]);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float alpha = exp2f((m[h] - mx[h]) * kLog2e);
          l[h] = l[h] * alpha + sum[h];
          dsum[h] = dsum[h] * alpha + dps[h];
          m[h] = mx[h];
        }
      } else {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const uint32_t keep = drop.on() ? deal_rows(word >> (4 * (4 * jh + n)) & 0xFu, lane) : 0xFu;
          float ds[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float p = exp2f(fmaf(s[n][c], kLog2e, -mL[c >> 1])) * inv_l[c >> 1];
            const float dp = drop.on() ? ((keep >> c & 1u) ? dpd[n][c] * drop.scale : 0.f) : dpd[n][c];
            ds[c] = p * (dp - dot[c >> 1]);
          }
          mma_ab_f32(part, c_to_a(ds), sk, 32 * jh + 8 * n, lane);
        }
      }
    }
    if (pass2) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n][c] += part[n][c];
    } else if (drop.on()) {
      my_words[(size_t)(j0 / kTile) * Tp * 2] = word;
    }
    __syncthreads();
  }

  float* out = dq + base;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int d = 8 * n + 2 * t;
    if (rg < T_len) *reinterpret_cast<float2*>(out + (size_t)rg * kHead + d) = make_float2(acc[n][0], acc[n][1]);
    if (rg + 8 < T_len)
      *reinterpret_cast<float2*>(out + (size_t)(rg + 8) * kHead + d) = make_float2(acc[n][2], acc[n][3]);
  }
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = rg + 8 * h;
      stats[(size_t)bh * Tp + i] = i < T_len ? make_float4(mL[h], inv_l[h], dot[h], 0.f)
                                             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// grid: (ceil(T / 64), B * H); dk, dv: (B, H, T, 64) float32; stats and
// keep_words as written by bwd_q_f32_kernel
__global__ void __launch_bounds__(kTcThreads, 2) bwd_kv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ g, const int* __restrict__ lengths, const long long* __restrict__ seed,
    const float4* __restrict__ stats, const uint32_t* __restrict__ keep_words, float* __restrict__ dk,
    float* __restrict__ dv, int H, int T_len, unsigned thr, float scale) {
  extern __shared__ __align__(16) float smf[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* const s_k = smf + 16 * warp * kLdsF;          // this warp's 16 keys of k
  const float* const s_v = s_k + kTileF;                     // and of v
  float* const s_q = smf + 2 * kTileF;                       // buffer b at s_q + b * kTileF
  float* const s_g = smf + 4 * kTileF;
  float4 (*s_st)[kTile] = reinterpret_cast<float4 (*)[kTile]>(smf + 6 * kTileF);     // [2][64]
  uint32_t (*s_kw)[kTile][2] = reinterpret_cast<uint32_t (*)[kTile][2]>(s_st + 2);  // [2][64][2]
  const int lg = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int len = lengths[bh / H];
  const int j0 = blockIdx.x * kTile;
  const int kg = j0 + 16 * warp + lg;              // this thread's keys kg and kg + 8
  const bool masked[2] = {kg >= len, kg + 8 >= len};
  const size_t base = (size_t)bh * T_len * kHead;
  const Dropout drop = make_dropout(seed, bh, thr, scale);
  const int nq = (T_len + kTile - 1) / kTile;
  const int Tp = nq * kTile;
  const float4* st_bh = stats + (size_t)bh * Tp;
  const uint32_t* words = keep_words + ((size_t)bh * nq + blockIdx.x) * Tp * 2;

  // one query tile's statistics (64 copies of 16 bytes) and, with dropout,
  // its rows' keep words of this key tile (32 copies)
  auto load_stats = [&](int b, int i0) {
    const int c = threadIdx.x;
    if (c < 64) cp_async16(&s_st[b][c], st_bh + i0 + c, 16);
    else if (c < 96 && drop.on()) cp_async16(&s_kw[b][(c - 64) * 2][0], words + (size_t)i0 * 2 + (c - 64) * 4, 16);
  };
  load_tile_f32(smf, k + base, j0, T_len);
  load_tile_f32(smf + kTileF, v + base, j0, T_len);
  load_tile_f32(s_q, q + base, 0, T_len);
  load_tile_f32(s_g, g + base, 0, T_len);
  load_stats(0, 0);
  cp_commit();

  float dka[8][4], dva[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[n][c] = dva[n][c] = 0.f;

  for (int it = 0; it < nq; ++it) {
    const int buf = it & 1;
    const int i0 = it * kTile;
    if (it + 1 < nq) {
      load_tile_f32(s_q + (buf ^ 1) * kTileF, q + base, i0 + kTile, T_len);
      load_tile_f32(s_g + (buf ^ 1) * kTileF, g + base, i0 + kTile, T_len);
      load_stats(buf ^ 1, i0 + kTile);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* sq = s_q + buf * kTileF;
    const float* sg = s_g + buf * kTileF;
    const bool full = i0 + kTile <= T_len;
    float pk[8][4], pv[8][4];                     // this tile's ds^T.q and pd^T.do
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) pk[n][c] = pv[n][c] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r0 = 32 * half;                   // tile rows r0 .. r0 + 31
      float s[4][4], dpd[4][4];
      mma_abt_f32<4, 2>(s, s_k, sq + r0 * kLdsF, lane);
      mma_abt_f32<4, 2>(dpd, s_v, sg + r0 * kLdsF, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        // lane (lg, t) brings row r0 + 8n + 2t + (lg & 1), key group 4 * warp +
        // lg / 2 of the tile: nibble 2 * warp + lg / 4 of that row's word (lg / 2) & 1
        const uint32_t keep = drop.on() ? deal_cols(s_kw[buf][r0 + 8 * n + 2 * t + (lg & 1)][(lg >> 1) & 1] >>
                                                        (4 * (2 * warp + (lg >> 2))) & 0xFu, lane)
                                        : 0xFu;
        float pd[4], ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = r0 + 8 * n + 2 * t + e;           // query row i0 + r
          const float4 sr = s_st[buf][r];
          const bool in = full || i0 + r < T_len;
#pragma unroll
          for (int h = 0; h < 2; ++h) {                   // key kg + 8h
            const int c = 2 * h + e;
            const float p = exp2f(fmaf(masked[h] ? -1e9f : s[n][c], kLog2e, -sr.x)) * sr.y;
            const bool kept = (keep >> c & 1u) != 0u;
            const float pdv = drop.on() ? (kept ? p * drop.scale : 0.f) : p;
            const float dp = drop.on() ? (kept ? dpd[n][c] * drop.scale : 0.f) : dpd[n][c];
            pd[c] = in ? pdv : 0.f;
            ds[c] = in ? p * (dp - sr.z) : 0.f;
          }
        }
        // (key g, rows 2t, 2t + 1) and (key g + 8, ...): A fragments over 8 rows
        mma_ab_f32(pv, c_to_a(pd), sg, r0 + 8 * n, lane);
        mma_ab_f32(pk, c_to_a(ds), sq, r0 + 8 * n, lane);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dka[n][c] += pk[n][c];
        dva[n][c] += pv[n][c];
      }
    __syncthreads();
  }

#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int d = 8 * n + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = kg + 8 * h;
      if (j < T_len) {
        const size_t o = base + (size_t)j * kHead + d;
        *reinterpret_cast<float2*>(dk + o) = make_float2(dka[n][2 * h], dka[n][2 * h + 1]);
        *reinterpret_cast<float2*>(dv + o) = make_float2(dva[n][2 * h], dva[n][2 * h + 1]);
      }
    }
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* g, const int* lengths,
                       const long long* seed, void* dq, void* dk, void* dv, float* stats, uint32_t* keep_words,
                       int B, int H, int T_len, unsigned thr, float scale, cudaStream_t stream) {
  const void* kq = reinterpret_cast<const void*>(&bwd_q_f32_kernel);
  const void* kkv = reinterpret_cast<const void*>(&bwd_kv_f32_kernel);
  cudaError_t e = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdF32Smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdF32KvSmem);
  if (e != cudaSuccess) return e;
  float4* st4 = reinterpret_cast<float4*>(stats);
  dim3 grid((T_len + kTile - 1) / kTile, B * H);
  void* args_q[] = {&q, &k, &v, &g, &lengths, &seed, &dq, &st4, &keep_words, &H, &T_len, &thr, &scale};
  e = cudaLaunchKernel(kq, grid, dim3(kTcThreads), args_q, kBwdF32Smem, stream);
  if (e != cudaSuccess) return e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  void* args_kv[] = {&q, &k, &v, &g, &lengths, &seed, &st4, &keep_words, &dk, &dv, &H, &T_len, &thr, &scale};
  e = cudaLaunchKernel(kkv, grid, dim3(kTcThreads), args_kv, kBwdF32KvSmem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace attn

// Two launches on ``stream``. dtype: 1 = bf16, 0 = float32 (both on the
// tensor cores, any T). thr: the dropout threshold (0: off; seed, an int64 on
// the card, is then not read). stats: 4 * B * H * Tp float32 of scratch,
// 16-byte aligned, Tp = T rounded up to 64. keep: with dropout, 2 * B * H *
// Tp * Tp / 64 uint32 of scratch for the mask bits (else not read). D must be
// 64. Returns cudaGetLastError() after the launches.
extern "C" int attention_bwd(const void* q, const void* k, const void* v, const void* g,
                             const void* lengths, const void* seed, void* dq, void* dk, void* dv,
                             void* stats, void* keep, int B, int H, int T_len, int D, int dtype, unsigned thr,
                             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const long long* sd = static_cast<const long long*>(seed);
  float* st = static_cast<float*>(stats);
  // D = 64: the FFT blocks' head width (2 heads of a 128-wide model)
  if (D != attn::kHead) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)attn::launch_tc(q, k, v, g, len, sd, dq, dk, dv, st, static_cast<uint32_t*>(keep), B, H, T_len,
                                thr, scale, s);
  return (int)attn::launch_f32(q, k, v, g, len, sd, dq, dk, dv, st, static_cast<uint32_t*>(keep), B, H, T_len,
                               thr, scale, s);
}
