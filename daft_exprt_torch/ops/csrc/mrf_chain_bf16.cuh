// Block-resident bf16 ResBlock1 chains for Hopper: the engine of the bf16
// tier's MRF kernels, tc_bf_kernel (mrf_tc.cu: fused_mrf_tc, bf16 compute),
// phase_bf_kernel (mrf_phase.cu: fused_mrf_phase, bf16, with its upsample
// prologue and conv_post epilogue; with a float32 upsample output,
// fused_mrf_ptc's fdot mode) and mrf_ct.cuh's ct_kernel<CtBf> (mrf_ct.cu:
// fused_mrf_ct and fused_mrf_phase without prologue, the levels that take
// no fused upsample, C = 64..8).
//
// The function is a chain of ResBlock1 steps with their rounding points:
// each conv's input lrelu'd and rounded to bf16, float32 sums, + bias, the
// residual in float32, res + (acc + b2) (vocoder_kernels.mrf_tc_plain /
// mrf_phase_plain). Only the order in which a conv's products are summed
// may differ. What the engine decides is where the data lives and how the
// convs run (Pipe, b_desc and the wgmma helpers are the int8 engines', in
// mrf_wgmma.cuh):
//
//   - A block owns bm output samples and keeps a chain's float32 residual
//     window, bm + 2*halo rows x C, resident: in shared memory, or at C =
//     256, where it does not fit beside the bf16 tile, in a per-block slice
//     of a global scratch that stays in L2. Every step runs on that window
//     with valid convs, shrinking it by the step's reach, so a chain reads
//     its input once and writes once.
//   - One bf16 tile A holds every conv's input, in place: a valid conv's
//     output row m reads input rows m .. m + (k-1)*d >= m, so once a pass's
//     MMAs are done (a block barrier) its epilogue overwrites the rows it
//     computed, which no later pass reads. conv1 writes lrelu(acc + b1) in
//     bf16 over its own input, conv2 the next step's input lrelu(res + (acc
//     + b2)) in bf16 and the residual. One tile where the int8 engine keeps
//     two: at C = 256 the bf16 window stays as long as the int8 one.
//   - Each conv is a tap-shifted GEMM on wgmma m64nNk16 (bf16, f32
//     accumulate) with both operands read from shared memory through
//     descriptors. The tile A is stored K-major without swizzle as 16-byte
//     channel chunks, each chunk's rows 16 bytes apart (tile_off): its core
//     matrices (8 rows x 16 bytes) start at any row, so a tap's row offset
//     t*d is a 16-byte move of the descriptor's start, and no register
//     holds A. (A from ldmatrix into registers, as in the int8 engine, made
//     ptxas serialise every wgmma: "non wgmma instructions defining input
//     registers", "insufficient register resources".) B, the weights, is
//     the staged swizzled K-major layout; all weight stages of all convs
//     stream through one ring by cp.async (Pipe). At C = 256 a pass is 128
//     rows x 2 column groups of 128, to bound the accumulator registers.
//
// Weights reach the kernels pre-packed in the staged order
// (vocoder_kernels.pack_stage_bf16): per conv, stage s = g*KC + kc (tap
// group g of TPS taps, k-chunk kc of KCH input channels), each stage
// [tap in group][output channel n][KCH bf16] with the 16-byte chunks of
// row n swizzled by swz<2*KCH>. Where TPS does not divide the taps, the
// last group is the last TPS taps, those an earlier group holds zeroed:
// every stage issues the same MMAs (a wgmma under a condition is
// serialised) and reads only rows of the conv's window.
//
// C = 8: a k16 step needs 16 bf16 values of K, and a tile row is one
// 16-byte chunk (8 channels). A k16 step then reads a pair of taps: the
// descriptor's K-adjacent core matrix is the one lbo bytes on, and with lbo
// = d*16 (the tap's row offset) the step's second 8 values of K are tap
// t+1's channels of the same rows (ConvSS::PAIR). Pair v holds taps t =
// min(2v, k-2) and t+1, so an odd k's last pair repeats tap k-2 with zero
// weights and reads no row past the conv's window (whose values are
// finite: a NaN there times a zero weight would be NaN). The weights are
// staged as one tap of 16 input channels per pair
// (vocoder_kernels.pack_stage_bf16_pairs). Against 16 staged channels with
// a zero half, this halves the MMAs and the tile.
#pragma once

#include "mrf_common.cuh"
#include "mrf_wgmma.cuh"

namespace mrf {
namespace bfe {

using blk::b_desc;
using blk::Ld;
using blk::Pipe;
using blk::smem_u32;
using blk::wg_commit;
using blk::wg_fence;
using blk::wg_hold;
using blk::wg_wait;

constexpr int kMaxSteps = 4;    // dilations per chain
constexpr int kMaxChains = 3;   // chains per group
constexpr int kSmemMax = 232448;

// One chain step's weights: staged bf16 taps (as bytes), float32 biases.
struct StepBf {
  const int8_t* w1;
  const float* b1;
  const int8_t* w2;
  const float* b2;
  int dil;
};

__host__ __device__ inline int chain_halo(int k, const StepBf* st, int n) {
  int h = 0;
  for (int i = 0; i < n; ++i) h += (st[i].dil + 1) * ((k - 1) / 2);
  return h;
}

__host__ __device__ inline int round64(int m) { return (m + 63) / 64 * 64; }

// Rows a chain's conv tile holds on a window of wrows rows: a warpgroup's
// MMAs read g = 64*MG rows from its first (ConvSS), so a conv over M rows
// reads up to row M rounded up to g, - 1 + (k - 1)*d of the tile, past its
// input where g does not divide M (those outputs are dropped).
__host__ __device__ inline int tile_rows(int wrows, int k, const StepBf* st, int n, int g = 64) {
  const int half = (k - 1) / 2;
  int rt = wrows, cur = wrows;
  for (int i = 0; i < n; ++i) {
    const int m1 = cur - 2 * st[i].dil * half, m2 = m1 - 2 * half;
    const int r1 = (m1 + g - 1) / g * g + 2 * st[i].dil * half;
    const int r2 = (m2 + g - 1) / g * g + 2 * half;
    rt = rt > r1 ? rt : r1;
    rt = rt > r2 ? rt : r2;
    cur = m2;
  }
  return rt;
}

// Byte offset of channel c of row r in a tile of RT rows a chunk: chunk
// c / 8 holds channels [8*(c/8), 8*(c/8) + 8) of every row, 16 bytes a row.
__host__ __device__ __forceinline__ int tile_off(int RT, int r, int c) {
  return (c >> 3) * RT * 16 + r * 16 + (c & 7) * 2;
}

// bf16 of lrelu(v0), lrelu(v1) (each rounded once), v0 in the low half
__device__ __forceinline__ uint32_t lrelu2(float v0, float v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0 >= 0.f ? v0 : __fmul_rn(kSlope, v0),
                                                 v1 >= 0.f ? v1 : __fmul_rn(kSlope, v1));
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack_bf2(float v0, float v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// R row r (row stride RS floats) and tile row ra from 8 float32 values of
// channels c8..c8+7: the tile gets their lrelu in bf16
template <int RS>
__device__ __forceinline__ void put8(float* R, int r, int8_t* A, int RT, int ra, int c8,
                                     const float (&f)[8]) {
  float* dst = R + r * RS + c8;
  *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(f[4], f[5], f[6], f[7]);
  *reinterpret_cast<uint4*>(A + tile_off(RT, ra, c8)) =
      make_uint4(lrelu2(f[0], f[1]), lrelu2(f[2], f[3]), lrelu2(f[4], f[5]), lrelu2(f[6], f[7]));
}

// the 8 bf16 of a 16-byte chunk as float32
__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 t = __bfloat1622float2(v[e]);
    f[2 * e] = t.x;
    f[2 * e + 1] = t.y;
  }
}

// R rows [0, wrows) <- samples [s0, s0 + wrows) of one utterance of x ((T,
// C) bf16, sample-major), zero outside [0, T); A rows <- their lrelu in bf16
// (a tile of RT rows a chunk). NTH threads; each keeps its 8 channels.
template <int C, int RS, int NTH>
__device__ __forceinline__ void load_window(float* R, int8_t* A, int RT, const bf16* xb, int s0,
                                            int wrows, int T) {
  static_assert(NTH % (C / 8) == 0, "a thread's channels stay fixed over the x load");
  const int c8 = (threadIdx.x % (C / 8)) * 8;
  constexpr int U = 4, RSTEP = NTH / (C / 8);
  for (int r0 = threadIdx.x / (C / 8); r0 < wrows; r0 += U * RSTEP) {
    uint4 raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * RSTEP, s = s0 + r;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (r < wrows && s >= 0 && s < T)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(xb + (long long)s * C + c8));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * RSTEP;
      if (r >= wrows) break;
      float f[8];
      unpack8(raw[u], f);
      put8<RS>(R, r, A, RT, r, c8, f);
    }
  }
}

// wgmma m64nNk16 bf16 x bf16 -> f32, A and B (both K-major) from shared
// memory through descriptors; d = A*B, plus d when acc != 0.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc);
template <>
__device__ __forceinline__ void wgmma_ss<8>(float (&d)[4], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// Makes this thread's shared-memory stores visible to the async proxy,
// through which wgmma reads its operands; before the barrier that hands
// a tile written by the threads to the MMAs.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a K-major tile without swizzle at p: core matrices of 8
// rows x 16 bytes, rows 16 bytes apart; K-adjacent core matrices lbo bytes
// apart (one channel chunk), M-adjacent ones 128.
__device__ __forceinline__ uint64_t a_desc(const void* p, int lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(128 >> 4) << 32);
}

// out[m][n] = sum_tap sum_ci A[a0 + m + tap*dil][ci] * W(tap, ci, n) for
// m < M, n < COUT, A a tile of RT rows a chunk (tile_off) of CIN channels,
// the weights staged by KCH channels and TPS taps a stage (CIN = 8: TPS
// tap pairs of KCH = 16 values, PAIR). NW warps tile ROWS rows x COUT
// columns per pass, each warpgroup MG groups of 64 rows x WN (MG > 1 at the
// narrow widths: more independent MMAs and epilogue rows between a pass's
// barriers). A warpgroup's MMAs read 64*MG rows from its first: the tile
// holds the rows past the last a valid output reads (tile_rows; their
// outputs are dropped).
template <int CIN, int COUT, int NW, int TPS, int KCH, int MG = 1>
struct ConvSS {
  static constexpr bool PAIR = CIN == 8;
  static constexpr int WN = COUT < 128 ? COUT : 128;
  static constexpr int CG = COUT / WN;
  static constexpr int NWG = NW / 4;
  static constexpr int RG = NWG / CG;
  static constexpr int ROWS = RG * 64 * MG;
  static constexpr int KC = PAIR ? 1 : CIN / KCH;
  static constexpr int KS = KCH / 16;
  static constexpr int STAGE = TPS * COUT * KCH * 2;
  static_assert(PAIR ? KCH == 16 : (CIN % KCH == 0 && KCH % 16 == 0 && KCH <= 64), "k-chunk");
  static_assert(NW % 4 == 0 && NWG % CG == 0 && WN % 8 == 0, "warpgroup tile");

  // the staged taps of a conv of ntaps taps: its tap pairs when PAIR
  __host__ __device__ static int vtaps(int ntaps) { return PAIR ? (ntaps + 1) / 2 : ntaps; }
  __host__ __device__ static int conv_stages(int ntaps) { return ((vtaps(ntaps) + TPS - 1) / TPS) * KC; }
  __host__ __device__ static int passes(int M) { return (M + ROWS - 1) / ROWS; }
  __host__ __device__ static int schedule(Ld* sched, int n, const int8_t* w, int M, int ntaps) {
    for (int ps = 0; ps < passes(M); ++ps) {
      if (sched != nullptr) sched[n] = Ld{w, STAGE, conv_stages(ntaps)};
      ++n;
    }
    return n;
  }

  // The MMAs of one pass, output rows [m0, m0 + ROWS) of M, into acc; the
  // pass takes the conv's stages from the pipe whether or not a warpgroup
  // has rows in it (every block consumes the same schedule). A lagging
  // pipe leaves one stage's MMAs in flight across the next barrier: the
  // copy that barrier starts overwrites the slot of the stage before.
  template <class P>
  static __device__ __forceinline__ void mma(P& pipe, float (&acc)[MG][WN / 2], const int8_t* A,
                                             int RT, int a0, int m0, int M, int dil, int ntaps) {
    static_assert(STAGE <= P::slot, "pipe slot");
    // the warpgroup's index and the conv's shape, which the compiler then
    // knows to be the same across the warp: a wgmma under a condition it
    // cannot prove uniform is serialised
    // (the descriptors too: wgmma takes them from uniform registers)
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
    ntaps = __shfl_sync(0xffffffffu, ntaps, 0);
    M = __shfl_sync(0xffffffffu, M, 0);
    dil = __shfl_sync(0xffffffffu, dil, 0);
    a0 = __shfl_sync(0xffffffffu, a0, 0);
    RT = __shfl_sync(0xffffffffu, RT, 0);
    const int rg = wg / CG, cg = wg - rg * CG;
    const int nv = vtaps(ntaps);
    const int n_st = conv_stages(ntaps);
    const int g_last = (nv + TPS - 1) / TPS - 1;
    const int wb = m0 + rg * 64 * MG;  // the warpgroup's first row
    const bool active = wb < M;        // the same for its 4 warps
#ifdef MRF_ABL_NOMMA
#pragma unroll
    for (int mg = 0; mg < MG; ++mg)
#pragma unroll
      for (int e = 0; e < WN / 2; ++e) acc[mg][e] = 0.f;
#endif
    for (int s = 0; s < n_st; ++s) {
      const int8_t* Ws = pipe.acquire();
#ifndef MRF_ABL_NOMMA
      // only the issue depends on the rows: every warpgroup commits and
      // waits (an empty group completes at once)
      if (active) {
        const int g = s / KC, kc = s - g * KC;
        // the group's first tap: the last group is the conv's last TPS taps
        // (vocoder_kernels.stage_taps), so every group issues TPS taps
        const int t0 = g < g_last ? g * TPS : nv - TPS;
        wg_fence();
        if constexpr (PAIR) {
#pragma unroll
          for (int tp = 0; tp < TPS; ++tp) {
            // pair t0 + tp: taps t and t + 1, the second dil rows on
            const int t = min(2 * (t0 + tp), ntaps - 2);
#pragma unroll
            for (int mg = 0; mg < MG; ++mg)
              wgmma_ss<WN>(acc[mg], a_desc(A + (a0 + wb + mg * 64 + t * dil) * 16, dil * 16),
                           b_desc<32>(Ws + tp * COUT * 32 + cg * WN * 32), s | tp);
          }
        } else {
          const int8_t* Ak = A + (size_t)(kc * KCH / 8) * RT * 16 + (a0 + wb + t0 * dil) * 16;
#pragma unroll
          for (int tp = 0; tp < TPS; ++tp) {
            const int8_t* At = Ak + tp * dil * 16;
            const int8_t* Wt = Ws + tp * COUT * KCH * 2 + cg * WN * KCH * 2;
#pragma unroll
            for (int ks = 0; ks < KS; ++ks)
#pragma unroll
              for (int mg = 0; mg < MG; ++mg)
                // the pass's first product overwrites the accumulators
                wgmma_ss<WN>(acc[mg], a_desc(At + mg * 64 * 16 + ks * 2 * RT * 16, RT * 16),
                             b_desc<2 * KCH>(Wt + ks * 32), s | tp | ks);
          }
        }
      }
      wg_commit();
      if (P::lag) wg_wait<1>(); else wg_wait<0>();
#endif
    }
    wg_wait<0>();
#pragma unroll
    for (int mg = 0; mg < MG; ++mg)
#pragma unroll
      for (int e = 0; e < WN / 2; ++e) wg_hold(acc[mg][e]);
  }

  // The epilogue of one pass's sums, IG column pairs at a time: cc =
  // col(n) and q = pre(m, n, m < M) for each row m of the warp's tile
  // first, then epi(m, n, acc[n], acc[n + 1], cc, q, m < M) (rows past M:
  // epi stores nothing). Every load of a batch is issued before its
  // stores, which the compiler would otherwise keep in program order
  // (they may alias), and no row takes a branch of its own.
  template <class Col, class Pre, class Epi>
  static __device__ __forceinline__ void each(const float (&accs)[MG][WN / 2], int m0, int M,
                                              Col&& col, Pre&& pre, Epi&& epi) {
#ifndef MRF_ABL_NOEPI
    constexpr int IG = WN / 8 < 4 ? WN / 8 : 4;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wq = warp & 3, wg = warp >> 2;
    const int rg = wg / CG, cg = wg - rg * CG;
#pragma unroll
    for (int mg = 0; mg < MG; ++mg) {
      const float(&acc)[WN / 2] = accs[mg];
      const int r = m0 + (rg * MG + mg) * 64 + 16 * wq + (lane >> 2);
      if (m0 + (rg * MG + mg) * 64 >= M) return;
      const bool v0 = r < M, v1 = r + 8 < M;
#pragma unroll
      for (int i0 = 0; i0 < WN / 8; i0 += IG) {
        decltype(col(0)) cc[IG];
        decltype(pre(0, 0, true)) q[IG][2];
#pragma unroll
        for (int ii = 0; ii < IG; ++ii) {
          const int c = cg * WN + (i0 + ii) * 8 + 2 * (lane & 3);
          cc[ii] = col(c);
          q[ii][0] = pre(r, c, v0);
          q[ii][1] = pre(r + 8, c, v1);
        }
#pragma unroll
        for (int ii = 0; ii < IG; ++ii) {
          const int i = i0 + ii, c = cg * WN + i * 8 + 2 * (lane & 3);
          epi(r, c, acc[4 * i], acc[4 * i + 1], cc[ii], q[ii][0], v0);
          epi(r + 8, c, acc[4 * i + 2], acc[4 * i + 3], cc[ii], q[ii][1], v1);
        }
      }
    }
#endif
  }

  // A conv with its epilogue; in place (the epilogue writes the input
  // tile) once every warpgroup has read the pass's rows.
  template <class P, class Col, class Pre, class Epi>
  static __device__ __forceinline__ void run(P& pipe, const int8_t* A, int RT, int a0, int M,
                                             int dil, int ntaps, bool in_place, Col&& col,
                                             Pre&& pre, Epi&& epi) {
    for (int m0 = 0; m0 < M; m0 += ROWS) {
      float acc[MG][WN / 2];
      mma(pipe, acc, A, RT, a0, m0, M, dil, ntaps);
      if (in_place) __syncthreads();
      each(acc, m0, M, col, pre, epi);
    }
    fence_async();
    __syncthreads();
  }
};

__device__ __forceinline__ float2 bias2(const float* b, int n) {
  return __ldg(reinterpret_cast<const float2*>(b + n));
}
__device__ __forceinline__ void put_a(int8_t* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// A chain on a float32 residual window R (row stride RS = C + 8 floats:
// rows 8 banks apart keep a half-warp's float2 accesses conflict-free; at C
// = 8 rows of 8 floats do, where 16 would put rows g and g + 2 in one bank)
// and the bf16 tile A of RT rows a chunk, KCH input channels per weight
// stage.
template <int C, int NW, int TPS, int KCH, int MG = 1>
struct ChainBf {
  using CV = ConvSS<C, C, NW, TPS, KCH, MG>;
  static constexpr int RS = C == 8 ? 8 : C + 8;

  // the step's loads for a schedule (conv1, then conv2)
  __host__ __device__ static int schedule(Ld* sched, int n, int lo, int hi, const StepBf& st,
                                          int k) {
    const int M1 = hi - lo - 2 * st.dil * ((k - 1) / 2);
    n = CV::schedule(sched, n, st.w1, M1, k);
    return CV::schedule(sched, n, st.w2, M1 - 2 * ((k - 1) / 2), k);
  }

  // One step on R rows [lo, hi), whose conv input A rows [0, hi - lo)
  // already hold: conv1 (dilated) +b1, lrelu, bf16 into A rows [0, M1);
  // conv2 +b2 onto the residual. The new value v of R row lo + r1 + r2 + m
  // (m < hi - lo - 2*(r1 + r2)), the next step's row m: unless LAST it is
  // stored back and its lrelu in bf16 into A row m; else the sink takes
  // it: e = sink.load(m, n, m < M2) with the residual, then
  // sink.store(m, n, e, v0, v1, m < M2). (The epilogues are unrolled over
  // the warp's accumulators, so each path is compiled on its own: one body
  // with both made the code several times larger.)
  template <bool LAST, class P, class Sink>
  static __device__ __forceinline__ void step(P& pipe, float* R, int lo, int hi, const StepBf& st,
                                              int k, int8_t* A, int RT, const Sink& sink) {
    const int half = (k - 1) / 2;
    const int r1 = st.dil * half;
    const int M1 = hi - lo - 2 * r1;
    const float* b1 = st.b1;
    CV::run(pipe, A, RT, 0, M1, st.dil, k, true,
            [&](int n) { return bias2(b1, n); }, [](int, int, bool) { return 0; },
            [&](int m, int n, float a0, float a1, const float2& b, int, bool valid) {
              const uint32_t v = lrelu2(__fadd_rn(a0, b.x), __fadd_rn(a1, b.y));
              if (valid) put_a(A + tile_off(RT, m, n), v);
            });
    const int M2 = M1 - 2 * half;
    float* base = R + (lo + r1 + half) * RS;
    const float* b2 = st.b2;
    CV::run(pipe, A, RT, 0, M2, 1, k, true,
            [&](int n) { return bias2(b2, n); },
            // the residual (a row past M2 reads row M2 - 1) and the sink's
            // earlier value
            [&](int m, int n, bool valid) {
              const float2 r =
                  *reinterpret_cast<const float2*>(base + (valid ? m : M2 - 1) * RS + n);
              float2 e = make_float2(0.f, 0.f);
              if constexpr (LAST) e = sink.load(m, n, valid);
              return make_float4(r.x, r.y, e.x, e.y);
            },
            [&](int m, int n, float a0, float a1, const float2& b, const float4& q, bool valid) {
              const float v0 = __fadd_rn(q.x, __fadd_rn(a0, b.x));
              const float v1 = __fadd_rn(q.y, __fadd_rn(a1, b.y));
              if constexpr (!LAST) {
                const uint32_t w = lrelu2(v0, v1);
                if (valid) {
                  *reinterpret_cast<float2*>(base + m * RS + n) = make_float2(v0, v1);
                  put_a(A + tile_off(RT, m, n), w);
                }
              } else {
                sink.store(m, n, make_float2(q.z, q.w), v0, v1, valid);
              }
            });
  }
};

// ---------------------------------------------------------------------------
// tc_bf_kernel: one chain of a wide level's MRF group, (B, T, C) layout

// per C: warps, taps and input channels per weight stage, ring slots, the
// ring's lag, where the residual window lives; the block's output samples
// are the launch plan's (vocoder_kernels.TC_BF_CFG mirrors this)
template <int C> struct TcBfCfg;
template <> struct TcBfCfg<128> {
  static constexpr int NW = 16, TPS = 1, KCH = 64, NBUF = 3, LAG = 1;
  static constexpr bool R_SMEM = true;
};
template <> struct TcBfCfg<256> {
  static constexpr int NW = 16, TPS = 1, KCH = 32, NBUF = 4, LAG = 1;
  static constexpr bool R_SMEM = false;
};

struct TcBfParams {
  const bf16* x;       // (B, T, C) bfloat16
  long long x_bs;
  int T;
  float* sum;          // (B, T, C) float32: the chain (WRITE), or the
  long long sum_bs;    // first of n_acc <= 2 earlier chains, sum_cs apart (FINAL)
  long long sum_cs;
  bf16* out;           // (B, T, C) bfloat16 (FINAL)
  long long out_bs;
  int mode, n_acc;
  float scale;
  StepBf steps[kMaxSteps];
  int n_steps, k;
  int bm;
  float* scratch;      // !R_SMEM: per block (bm + 2*halo) x (C + 8) floats
  int n_tiles, n_items;
};

template <int C>
struct TcBfTypes {
  using CF = TcBfCfg<C>;
  using CH = ChainBf<C, CF::NW, CF::TPS, CF::KCH>;
};

// the weight loads one block item consumes, in order (Pipe's schedule)
template <int C>
__host__ __device__ int tc_bf_schedule(Ld* sched, const TcBfParams& p, int wrows) {
  using CH = typename TcBfTypes<C>::CH;
  int n = 0, lo = 0, hi = wrows;
  for (int i = 0; i < p.n_steps; ++i) {
    n = CH::schedule(sched, n, lo, hi, p.steps[i], p.k);
    lo += (p.steps[i].dil + 1) * ((p.k - 1) / 2);
    hi -= (p.steps[i].dil + 1) * ((p.k - 1) / 2);
  }
  return n;
}

// shared memory: ring | A (rt = tile_rows rows a chunk) | R (R_SMEM) |
// schedule. fits: the launch takes it (vocoder_kernels._tc_bf_smem mirrors
// this, and a CPU test compiles it for the host to hold them equal).
template <int C>
struct TcBfLayout {
  using T = TcBfTypes<C>;
  int h, wrows, rt;
  size_t ring, a, r, total;
  bool fits;
  __host__ __device__ TcBfLayout(const TcBfParams& p) {
    h = chain_halo(p.k, p.steps, p.n_steps);
    wrows = p.bm + 2 * h;
    rt = tile_rows(wrows, p.k, p.steps, p.n_steps);
    ring = (size_t)T::CF::NBUF * T::CH::CV::STAGE;
    a = (size_t)rt * 2 * C;
    r = T::CF::R_SMEM ? (size_t)wrows * T::CH::RS * 4 : 0;
    total = ring + a + r + sizeof(Ld) * (size_t)tc_bf_schedule<C>(nullptr, p, wrows);
    fits = total <= (size_t)kSmemMax;
  }
};

// the output pair of a FINAL sink, in the output's type
__device__ __forceinline__ void put_out(bf16* p, float v0, float v1, bool valid) {
  const uint32_t w = pack_bf2(v0, v1);
  if (valid) *reinterpret_cast<uint32_t*>(p) = w;
}
__device__ __forceinline__ void put_out(float* p, float v0, float v1, bool valid) {
  if (valid) *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// Where a chain's value of sample n0 + m goes: WRITE to its float32 sum;
// FINAL ((the earlier chains' sums in order) + chain) * scale in the output
// type O (bf16, or float32 for mrf_chain_f32.cuh). The earlier sums are
// read-only during the launch (ld.global.nc), so their loads can run ahead
// of the stores.
template <int C, bool FINAL, class O = bf16>
struct TcSink {
  float* sum;
  long long sum_cs;
  O* out;
  int n_acc, T, n0;
  float scale;
  __device__ __forceinline__ long long at(int m, int n) const {
    const int s = n0 + m;
    return (long long)(s < T ? s : T - 1) * C + n;
  }
  // FINAL: the earlier chains' sums, in order
  __device__ __forceinline__ float2 load(int m, int n, bool) const {
    float2 e = make_float2(0.f, 0.f);
    if constexpr (FINAL) {
      const long long o = at(m, n);
      if (n_acc > 0) e = __ldg(reinterpret_cast<const float2*>(sum + o));
      if (n_acc > 1) {
        const float2 f = __ldg(reinterpret_cast<const float2*>(sum + o + sum_cs));
        e = make_float2(__fadd_rn(e.x, f.x), __fadd_rn(e.y, f.y));
      }
    }
    return e;
  }
  __device__ __forceinline__ void store(int m, int n, float2 e, float v0, float v1,
                                        bool valid) const {
    const long long o = at(m, n);
    valid = valid && n0 + m < T;
    if constexpr (!FINAL) {
      if (valid) *reinterpret_cast<float2*>(sum + o) = make_float2(v0, v1);
    } else {
      if (n_acc > 0) {
        v0 = __fadd_rn(e.x, v0);
        v1 = __fadd_rn(e.y, v1);
      }
      put_out(out + o, __fmul_rn(v0, scale), __fmul_rn(v1, scale), valid);
    }
  }
};

template <int C, bool FINAL>
__global__ void __launch_bounds__(TcBfCfg<C>::NW * 32, 1) tc_bf_kernel(const TcBfParams p) {
  using T = TcBfTypes<C>;
  using CH = typename T::CH;
  constexpr int RS = CH::RS, NTH = T::CF::NW * 32;
  const TcBfLayout<C> L(p);
  // the ring first: its stages start on 1024-byte swizzle atoms
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  int8_t* A = reinterpret_cast<int8_t*>(smem + L.ring);
  float* R;
  if constexpr (T::CF::R_SMEM) {
    R = reinterpret_cast<float*>(smem + L.ring + L.a);
  } else {
    R = p.scratch + (size_t)blockIdx.x * L.wrows * RS;
  }
  Ld* sched = reinterpret_cast<Ld*>(smem + L.ring + L.a + L.r);
  const int n_sched = tc_bf_schedule<C>(nullptr, p, L.wrows);
  if (threadIdx.x == 0) tc_bf_schedule<C>(sched, p, L.wrows);
  __syncthreads();
  Pipe<T::CF::NBUF, CH::CV::STAGE, NTH, T::CF::LAG> pipe;
  pipe.start(ring, sched, n_sched);
  const int half = (p.k - 1) / 2;
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const int b = item / p.n_tiles;
    const int n0 = (item - b * p.n_tiles) * p.bm;
    // R rows [0, wrows) <- x samples [n0 - h, n0 + bm + h), zero outside
    // [0, T); A <- their lrelu in bf16
    load_window<C, RS, NTH>(R, A, L.rt, p.x + b * p.x_bs, n0 - L.h, L.wrows, p.T);
    fence_async();
    __syncthreads();
    int lo = 0, hi = L.wrows;
    const TcSink<C, FINAL> sink{p.sum + b * p.sum_bs, p.sum_cs, p.out + b * p.out_bs, p.n_acc,
                                p.T, n0, p.scale};
    for (int si = 0; si < p.n_steps; ++si) {
      const StepBf& st = p.steps[si];
      if (si + 1 < p.n_steps)
        CH::template step<false>(pipe, R, lo, hi, st, p.k, A, L.rt, sink);
      else
        CH::template step<true>(pipe, R, lo, hi, st, p.k, A, L.rt, sink);
      lo += (st.dil + 1) * half;
      hi -= (st.dil + 1) * half;
    }
  }
  pipe.finish();
}

template <int C>
cudaError_t launch_tc_bf(TcBfParams& p, int B, int tps, int kch, int r_smem,
                         long long scratch_floats, int slots, cudaStream_t stream) {
  using CF = TcBfCfg<C>;
  if (tps != CF::TPS || kch != CF::KCH || r_smem != (int)CF::R_SMEM || p.bm < 8 || p.bm % 8 ||
      slots < 1 || p.n_steps < 1 || p.n_steps > kMaxSteps || p.k < CF::TPS || p.k % 2 == 0 ||
      (p.mode != kWrite && p.mode != kFinal) || p.n_acc < 0 || p.n_acc > kMaxChains - 1)
    return cudaErrorInvalidValue;
  const TcBfLayout<C> L(p);
  if (!L.fits) return cudaErrorInvalidValue;
  p.n_tiles = (p.T + p.bm - 1) / p.bm;
  p.n_items = p.n_tiles * B;
  if (p.n_items <= 0) return cudaSuccess;
  const int grid = p.n_items < slots ? p.n_items : slots;
  if (!CF::R_SMEM && (long long)L.wrows * (C + 8) * grid > scratch_floats)
    return cudaErrorInvalidValue;
  const void* kern = p.mode == kFinal ? reinterpret_cast<const void*>(&tc_bf_kernel<C, true>)
                                       : reinterpret_cast<const void*>(&tc_bf_kernel<C, false>);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return e;
  void* args[] = {&p};
  e = cudaLaunchKernel(kern, dim3(grid), dim3(CF::NW * 32), args, L.total, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// phase_bf_kernel: upsample + MRF group (+ conv_post) of a narrow level

// per (C_in, C): warps, taps and input channels per stage of the chain
// convs and of the upsample, ring slots, the ring's lag, where the float32
// windows live; output samples per block are the plan's (PHASE_BF_CFG)
template <int CIN, int C> struct PhaseBfCfg;
template <> struct PhaseBfCfg<128, 64> {
  static constexpr int NW = 16, TPS = 2, KCH = 64, UTPS = 2, UKCH = 64, NBUF = 3, LAG = 1;
  static constexpr bool R_SMEM = true;
};
template <> struct PhaseBfCfg<64, 32> {
  static constexpr int NW = 16, TPS = 3, KCH = 32, UTPS = 2, UKCH = 64, NBUF = 3, LAG = 1;
  static constexpr bool R_SMEM = true;
};

struct PhaseBfParams {
  const bf16* x;        // (B, C_in, T_in) through strides: x_cs == 1 or x_ts == 1
  long long x_bs, x_cs, x_ts;
  int t_in;
  bf16* out;            // (B, C, N), or with conv_post (B, 1, N)
  long long out_bs;
  const int8_t* wu;     // per phase r (wu_phase bytes apart): ntaps taps, staged
  long long wu_phase;
  const float* bu;      // (C,)
  int stride, ntaps, amin, span, rows_r[8];
  int N, hx, P, kpost;
  const float* wp;      // (kpost, C) conv_post taps
  float bp, scale;
  StepBf steps[kMaxChains][kMaxSteps];
  int k[kMaxChains], n_steps[kMaxChains], n_chains;
  int bm;
  float* scratch;       // !R_SMEM: per block (wrows + bm + 2P) x (C + 8) floats
  int n_tiles, n_items;
};

template <int CIN, int C>
struct PhaseBfTypes {
  using CF = PhaseBfCfg<CIN, C>;
  using CH = ChainBf<C, CF::NW, CF::TPS, CF::KCH>;
  using UC = ConvSS<CIN, C, CF::NW, CF::UTPS, CF::UKCH>;
  static constexpr int SLOT = CH::CV::STAGE > UC::STAGE ? CH::CV::STAGE : UC::STAGE;
};

template <int CIN, int C>
__host__ __device__ int phase_bf_schedule(Ld* sched, const PhaseBfParams& p) {
  using T = PhaseBfTypes<CIN, C>;
  int n = 0;
  const int mu = (p.bm + 2 * p.hx) / p.stride;
  for (int r = 0; r < p.stride; ++r) n = T::UC::schedule(sched, n, p.wu + r * p.wu_phase, mu, p.ntaps);
  for (int j = 0; j < p.n_chains; ++j) {
    const int k = p.k[j], half = (k - 1) / 2;
    const int h = chain_halo(k, p.steps[j], p.n_steps[j]);
    int lo = p.hx - h - p.P, hi = p.hx + p.bm + h + p.P;
    for (int i = 0; i < p.n_steps[j]; ++i) {
      n = T::CH::schedule(sched, n, lo, hi, p.steps[j][i], k);
      lo += (p.steps[j][i].dil + 1) * half;
      hi -= (p.steps[j][i].dil + 1) * half;
    }
  }
  return n;
}

// shared memory: ring | X0 (the upsample, bf16, wrows a chunk) | A (rt
// rows a chunk) | U (the x tile, xrt rows a chunk, then R when R_SMEM) |
// O (R_SMEM) | schedule. conv_post's lrelu'd sums and the transposed
// output tile reuse X0 and A. fits: the launch takes it
// (vocoder_kernels._phase_bf_smem mirrors this; a CPU test holds them equal).
// A float32 X0 (fused_mrf_ptc's fdot mode) lives in the block's scratch
// slice instead, rows of C floats after R and O (!R_SMEM), and the X0
// region here holds only conv_post's sums and the transposed tile: the
// same layout, so the same blocks, as the bf16 level.
template <int CIN, int C>
struct PhaseBfLayout {
  using T = PhaseBfTypes<CIN, C>;
  static constexpr int RS = C + 8;
  int wrows, rt, xrows, xrt, orows;
  size_t ring, x0, a, r, xq, u, o, total;
  bool fits;
  __host__ __device__ PhaseBfLayout(const PhaseBfParams& p) {
    wrows = p.bm + 2 * p.hx;
    rt = wrows;
    for (int j = 0; j < p.n_chains; ++j) {
      const int h = chain_halo(p.k[j], p.steps[j], p.n_steps[j]);
      const int r = tile_rows(p.bm + 2 * h + 2 * p.P, p.k[j], p.steps[j], p.n_steps[j]);
      rt = rt > r ? rt : r;
    }
    xrows = wrows / p.stride + p.span;
    xrt = round64(wrows / p.stride) + p.span;
    xrt = xrt > xrows ? xrt : xrows;
    orows = p.bm + 2 * p.P;
    ring = (size_t)T::CF::NBUF * T::SLOT;
    x0 = (size_t)wrows * 2 * C;
    a = (size_t)rt * 2 * C;
    r = T::CF::R_SMEM ? (size_t)wrows * RS * 4 : 0;
    xq = (size_t)xrt * 2 * CIN;
    u = r > xq ? r : xq;
    o = T::CF::R_SMEM ? (size_t)orows * RS * 4 : 0;
    total = ring + x0 + a + u + o + sizeof(Ld) * (size_t)phase_bf_schedule<CIN, C>(nullptr, p);
    // conv_post's sums and the transposed tile fit in X0 + A
    fits = total <= (size_t)kSmemMax && (size_t)orows * (C + 1) * 4 <= x0 + a &&
           (size_t)C * (p.bm + 8) * 2 <= x0 + a;
  }
};

// floats of a block's scratch slice: R and O unless R_SMEM, then a
// float32 X0
template <int CIN, int C, typename X0T>
__host__ __device__ size_t phase_bf_slice(const PhaseBfLayout<CIN, C>& L) {
  return (PhaseBfCfg<CIN, C>::R_SMEM ? 0 : (size_t)(L.wrows + L.orows) * (C + 8)) +
         (sizeof(X0T) == 4 ? (size_t)L.wrows * C : 0);
}

// The chain sum O (rows RS floats apart) of a block: the first chain
// writes it, the others add to it (rows past the window store nothing).
template <int RS>
struct SumSink {
  float* O;
  bool first;
  __device__ __forceinline__ float2 load(int m, int n, bool valid) const {
    return first ? make_float2(0.f, 0.f)
                 : *reinterpret_cast<const float2*>(O + (valid ? m : 0) * RS + n);
  }
  __device__ __forceinline__ void store(int m, int n, float2 q, float v0, float v1,
                                        bool valid) const {
    const float2 v = first ? make_float2(v0, v1) : make_float2(__fadd_rn(q.x, v0), __fadd_rn(q.y, v1));
    if (valid) *reinterpret_cast<float2*>(O + m * RS + n) = v;
  }
};

// X0T: the upsample output's type, bf16 (fused_mrf_phase: acc + b_u
// rounded, in shared memory) or float (fused_mrf_ptc's fdot mode: kept in
// float32, in the block's L2-resident scratch slice).
template <int CIN, int C, typename X0T>
__global__ void __launch_bounds__(PhaseBfCfg<CIN, C>::NW * 32, 1)
    phase_bf_kernel(const PhaseBfParams p) {
  using T = PhaseBfTypes<CIN, C>;
  using CH = typename T::CH;
  using UC = typename T::UC;
  constexpr int RS = CH::RS, NTH = T::CF::NW * 32;
  constexpr bool kF32 = sizeof(X0T) == 4;
  const PhaseBfLayout<CIN, C> L(p);
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  int8_t* X0 = reinterpret_cast<int8_t*>(smem + L.ring);
  int8_t* A = X0 + L.x0;
  int8_t* Xq = A + L.a;
  float* R;
  float* O;
  if constexpr (T::CF::R_SMEM) {
    R = reinterpret_cast<float*>(Xq);
    O = reinterpret_cast<float*>(Xq + L.u);
  } else {
    R = p.scratch + (size_t)blockIdx.x * phase_bf_slice<CIN, C, X0T>(L);
    O = R + (size_t)L.wrows * RS;
  }
  float* X0f = p.scratch + (size_t)blockIdx.x * phase_bf_slice<CIN, C, X0T>(L) +
               (T::CF::R_SMEM ? 0 : (size_t)(L.wrows + L.orows) * RS);
  Ld* sched = reinterpret_cast<Ld*>(Xq + L.u + L.o);
  const int n_sched = phase_bf_schedule<CIN, C>(nullptr, p);
  if (threadIdx.x == 0) phase_bf_schedule<CIN, C>(sched, p);
  __syncthreads();
  Pipe<T::CF::NBUF, T::SLOT, NTH, T::CF::LAG> pipe;
  pipe.start(ring, sched, n_sched);
  const int mu = L.wrows / p.stride;
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const int b = item / p.n_tiles;
    const int n0 = (item - b * p.n_tiles) * p.bm;
    // Xq row i <- lrelu(x) in bf16 at input sample base_in + i, zero
    // outside the utterance (window row q = sample n0 - hx + q; position
    // mq's phase r reads Xq rows mq + rows_r[r] + t)
    const int base_in = (n0 - p.hx) / p.stride + p.amin;
    const bf16* xb = p.x + b * p.x_bs;
    if (p.x_cs == 1) {   // channel-last: 8 channels a thread
      for (int i = threadIdx.x; i < L.xrows * (CIN / 8); i += NTH) {
        const int q = i / (CIN / 8), c = (i - q * (CIN / 8)) * 8;
        const int s = base_in + q;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (s >= 0 && s < p.t_in)
          raw = __ldg(reinterpret_cast<const uint4*>(xb + (long long)s * p.x_ts + c));
        float f[8];
        unpack8(raw, f);
        *reinterpret_cast<uint4*>(Xq + tile_off(L.xrt, q, c)) =
            make_uint4(lrelu2(f[0], f[1]), lrelu2(f[2], f[3]), lrelu2(f[4], f[5]), lrelu2(f[6], f[7]));
      }
    } else {             // channel-major: threads walk time
      for (int i = threadIdx.x; i < L.xrows * CIN; i += NTH) {
        const int c = i / L.xrows, q = i - c * L.xrows;
        const int s = base_in + q;
        float f = 0.f;
        if (s >= 0 && s < p.t_in) f = __bfloat162float(xb[c * p.x_cs + (long long)s * p.x_ts]);
        *reinterpret_cast<bf16*>(Xq + tile_off(L.xrt, q, c)) =
            __float2bfloat16_rn(f >= 0.f ? f : __fmul_rn(kSlope, f));
      }
    }
    fence_async();
    __syncthreads();
    // X0 row stride*mq + r <- the upsample, acc + bias (rounded to bf16,
    // or float32)
    for (int r = 0; r < p.stride; ++r) {
      const float* bu = p.bu;
      const int stride = p.stride;
      UC::run(pipe, Xq, L.xrt, p.rows_r[r], mu, 1, p.ntaps, false,
              [&](int n) { return bias2(bu, n); }, [](int, int, bool) { return 0; },
              [&](int m, int n, float a0, float a1, const float2& c, int, bool valid) {
                const float v0 = __fadd_rn(a0, c.x), v1 = __fadd_rn(a1, c.y);
                if constexpr (kF32) {
                  if (valid)
                    *reinterpret_cast<float2*>(X0f + (stride * m + r) * C + n) =
                        make_float2(v0, v1);
                } else {
                  const uint32_t v = pack_bf2(v0, v1);
                  if (valid) *reinterpret_cast<uint32_t*>(X0 + tile_off(L.wrows, stride * m + r, n)) = v;
                }
              });
    }
    for (int j = 0; j < p.n_chains; ++j) {
      // the chain's shape, known to be the same across the warp (a wgmma
      // under a branch the compiler cannot prove uniform is serialised)
      const int k = __shfl_sync(0xffffffffu, p.k[j], 0), half = (k - 1) / 2;
      const int n_steps = __shfl_sync(0xffffffffu, p.n_steps[j], 0);
      const int h = chain_halo(k, p.steps[j], n_steps);
      int lo = p.hx - h - p.P, hi = p.hx + p.bm + h + p.P;
      // R rows [lo, hi) <- X0, A rows [0, hi - lo) <- its lrelu in bf16
      for (int i = threadIdx.x; i < (hi - lo) * (C / 8); i += NTH) {
        const int ra = i / (C / 8), c8 = (i - ra * (C / 8)) * 8;
        float f[8];
        if constexpr (kF32) {
          const float* src = X0f + (lo + ra) * C + c8;
          const float4 u = *reinterpret_cast<const float4*>(src);
          const float4 w = *reinterpret_cast<const float4*>(src + 4);
          f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
          f[4] = w.x; f[5] = w.y; f[6] = w.z; f[7] = w.w;
        } else {
          unpack8(*reinterpret_cast<const uint4*>(X0 + tile_off(L.wrows, lo + ra, c8)), f);
        }
        put8<RS>(R, lo + ra, A, L.rt, ra, c8, f);
      }
      fence_async();
      __syncthreads();
      const SumSink<RS> sink{O, j == 0};
      for (int si = 0; si < n_steps; ++si) {
        const StepBf& st = p.steps[j][si];
        if (si + 1 < n_steps)
          CH::template step<false>(pipe, R, lo, hi, st, k, A, L.rt, sink);
        else
          CH::template step<true>(pipe, R, lo, hi, st, k, A, L.rt, sink);
        lo += (st.dil + 1) * half;
        hi -= (st.dil + 1) * half;
      }
    }
    // O rows [0, bm + 2P): the chain sum at samples [n0 - P, n0 + bm + P)
    if (p.kpost == 0) {
      // (B, C, N): bf16 of sum * scale through a transposed tile Tt[c][m]
      constexpr int TP = 8;   // row padding (bf16)
      bf16* Tt = reinterpret_cast<bf16*>(X0);
      const int tw = p.bm + TP;
      for (int i = threadIdx.x; i < p.bm * (C / 2); i += NTH) {
        const int m = i / (C / 2), n = (i - m * (C / 2)) * 2;
        const float2 v = *reinterpret_cast<const float2*>(O + m * RS + n);
        Tt[n * tw + m] = __float2bfloat16_rn(__fmul_rn(v.x, p.scale));
        Tt[(n + 1) * tw + m] = __float2bfloat16_rn(__fmul_rn(v.y, p.scale));
      }
      __syncthreads();
      bf16* out = p.out + b * p.out_bs + n0;
      const int len = p.N - n0 < p.bm ? p.N - n0 : p.bm;
      for (int i = threadIdx.x; i < C * (p.bm / 8); i += NTH) {
        const int c = i / (p.bm / 8), m = (i - c * (p.bm / 8)) * 8;
        if (m >= len) continue;
        const bf16* src = Tt + c * tw + m;
        bf16* dst = out + (long long)c * p.N + m;
        if (m + 8 <= len && ((p.N | n0) & 7) == 0) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8 && m + e < len; ++e) dst[e] = src[e];
        }
      }
    } else {
      // lrelu of the scaled sum in bf16 (rows C + 1 floats apart: one
      // bank per row), then per sample the taps in order, + bias, tanh
      float* Q = reinterpret_cast<float*>(X0);
      for (int i = threadIdx.x; i < L.orows * C; i += NTH) {
        const int m = i / C, n = i - m * C;
        const float v = __fmul_rn(O[m * RS + n], p.scale);
        Q[m * (C + 1) + n] = __bfloat162float(__float2bfloat16_rn(v >= 0.f ? v : __fmul_rn(kSlope, v)));
      }
      __syncthreads();
      bf16* out = p.out + b * p.out_bs + n0;
      for (int m = threadIdx.x; m < p.bm; m += NTH) {
        if (n0 + m >= p.N) continue;
        float acc = 0.f;
        for (int tap = 0; tap < p.kpost; ++tap) {
          const float* row = Q + (m + tap) * (C + 1);
          const float* wt = p.wp + tap * C;
#pragma unroll 8
          for (int c = 0; c < C; ++c) acc = fmaf(row[c], __ldg(wt + c), acc);
        }
        out[m] = __float2bfloat16_rn(tanhf(__fadd_rn(acc, p.bp)));
      }
    }
    __syncthreads();
  }
  pipe.finish();
}

template <int CIN, int C, typename X0T>
cudaError_t launch_phase_bf(PhaseBfParams& p, int B, const int* cfg, long long scratch_floats,
                            int slots, cudaStream_t stream) {
  using CF = PhaseBfCfg<CIN, C>;
  if (cfg[0] != CF::TPS || cfg[1] != CF::KCH || cfg[2] != CF::UTPS || cfg[3] != CF::UKCH ||
      cfg[4] != (int)CF::R_SMEM)
    return cudaErrorInvalidValue;
  int hmax = 0;
  for (int j = 0; j < p.n_chains; ++j) {
    const int h = chain_halo(p.k[j], p.steps[j], p.n_steps[j]);
    hmax = h > hmax ? h : hmax;
    if (p.k[j] < CF::TPS) return cudaErrorInvalidValue;
  }
  if (p.bm < 8 || p.bm % 8 || p.bm % p.stride || p.hx % p.stride || p.hx < hmax + p.P ||
      slots < 1 || (p.x_cs != 1 && p.x_ts != 1) || p.ntaps < CF::UTPS ||
      p.wu_phase != (long long)((p.ntaps + CF::UTPS - 1) / CF::UTPS) * (CIN / CF::UKCH) *
                        CF::UTPS * C * CF::UKCH * 2)
    return cudaErrorInvalidValue;
  const PhaseBfLayout<CIN, C> L(p);
  if (!L.fits) return cudaErrorInvalidValue;
  p.n_tiles = (p.N + p.bm - 1) / p.bm;
  p.n_items = p.n_tiles * B;
  if (p.n_items <= 0) return cudaSuccess;
  const int grid = p.n_items < slots ? p.n_items : slots;
  if ((long long)phase_bf_slice<CIN, C, X0T>(L) * grid > scratch_floats)
    return cudaErrorInvalidValue;
  const void* kern = reinterpret_cast<const void*>(&phase_bf_kernel<CIN, C, X0T>);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return e;
  void* args[] = {&p};
  e = cudaLaunchKernel(kern, dim3(grid), dim3(CF::NW * 32), args, L.total, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace bfe
}  // namespace mrf
