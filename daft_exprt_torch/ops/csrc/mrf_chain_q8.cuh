// Block-resident int8-static ResBlock1 chains for Hopper: the engine of
// mrf_tc_q8.cu (fused_mrf_tc, q8) and of the static mode of mrf_ptc.cu
// (fused_mrf_ptc).
//
// The arithmetic is mrf_q8.cuh's step_q8_kernel's, in the same order (see
// the header there): q_lrelu, s8 x s8 -> s32 sums, requant at the conv1 ->
// conv2 boundary, the dequant as one __fmaf_rn, res + fma(...). What
// changes is where the data lives and how the convs run:
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
//     through one ring of shared-memory slots by cp.async (Pipe), across
//     conv and item boundaries, one __syncthreads per stage; all warps
//     read the staged weights.
//   - The MMA is wgmma m64nNk32 (s8, s32 accumulate) with B (the weights)
//     from shared memory through a descriptor and A from registers: a
//     tap's row offset t*d (any integer) cannot be read through an A
//     descriptor, whose swizzle repeats every 8 rows, so each warp loads
//     its A fragments with ldmatrix from per-lane row addresses. (mma.sync
//     m16n8k32, with B fragments by ldmatrix too, was slower on the card.)
//   - s8 tiles and staged weights are stored with a 16-byte-chunk XOR
//     swizzle (swz below): the 8 rows of an ldmatrix land on distinct
//     banks for any row offset, and a weight tile is the canonical
//     K-major swizzled layout a wgmma descriptor reads.
//
// Bounds on the card (NVIDIA H100 80GB HBM3, 700 W; PERF.md,
// scripts/torch_mrf_q8_ablation.py): not the int8 rate. Per level, the conv epilogues
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

namespace mrf {
namespace blk {

constexpr int kMaxSteps = 4;   // dilations per chain

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Byte offset of byte `byte` of row r in an s8 tile of ROWB bytes per row:
// 16-byte chunk c of row r is stored at chunk c ^ key(r). key spans the
// rows of 8 consecutive 16-byte bank groups, so 8 consecutive rows read at
// one logical chunk hit 8 distinct bank groups.
template <int ROWB>
__host__ __device__ constexpr int swz_key(int r) {
  return ROWB >= 128 ? (r & 7) : ((r / (128 / ROWB)) & (ROWB / 16 - 1));
}
template <int ROWB>
__device__ __forceinline__ int swz(int r, int byte) {
  return r * ROWB + (((byte >> 4) ^ swz_key<ROWB>(r)) << 4) + (byte & 15);
}

// wgmma m64nNk32 s8 x s8 -> s32, A (the warp's 16 rows x 32 k) from
// registers, B from shared memory through a descriptor, accumulating.
template <int N>
__device__ __forceinline__ void wgmma_rs(int (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_rs<32>(int (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(int (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(int (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving a register across the asynchronous MMAs
__device__ __forceinline__ void wg_hold(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// Descriptor of a K-major B tile in shared memory: rows (n) of KCH bytes
// stored with swz<KCH>, which is the canonical 128/64/32-byte swizzle of
// that row width (16-byte chunk c of row r at c ^ ((r / (128/KCH)) % ...));
// 8-row groups KCH*8 bytes apart; the tile starts on a swizzle atom (8 rows).
template <int KCH>
__device__ __forceinline__ uint64_t b_desc(const void* p) {
  constexpr uint64_t mode = KCH == 128 ? 1 : KCH == 64 ? 2 : 3;
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(8 * KCH / 16) << 32) | (mode << 62);
}

// One load of the weight stream: `bytes` (a multiple of 16) from `src`.
struct Ld {
  const int8_t* src;
  int bytes, pad;
};

// The block's weight stream: every conv stage the block consumes, in
// consumption order (the schedule, the same list for every item a launch's
// blocks walk through, so it wraps from one item to the next), copied by
// cp.async into a ring of NBUF slots of SLOT bytes. One __syncthreads per
// stage: acquire() waits for the stage's copy, synchronises the block and
// starts the copy of the stage NBUF - 1 - LAG ahead, into the slot of the
// stage 1 + LAG back. With LAG = 1 the MMAs of the previous stage may still
// be reading their slot across the barrier (wgmma, asynchronous); they
// must be done before the next acquire. Copies run across conv and item
// boundaries. Every thread of the block calls every member in the same
// order.
template <int NBUF, int SLOT, int NTH, int LAG = 0>
struct Pipe {
  static_assert(NBUF >= 2 + LAG, "ring");
  static constexpr int slot = SLOT, lag = LAG;
  int8_t* ring;
  const Ld* sched;
  int n, head, tail;

  __device__ __forceinline__ void issue() {
    const Ld e = sched[head % n];
    int8_t* dst = ring + (head % NBUF) * SLOT;
#ifndef MRF_ABL_NOW
    for (int i = threadIdx.x; i < e.bytes / 16; i += NTH) cp16(dst + 16 * i, e.src + 16 * i);
#endif
    cp_commit();
    ++head;
  }
  __device__ __forceinline__ void start(int8_t* r, const Ld* s, int len) {
    ring = r;
    sched = s;
    n = len;
    head = tail = 0;
    for (int i = 0; i < NBUF - 1 - LAG; ++i) issue();
  }
  // the next stage's weights, landed and visible to every thread
  __device__ __forceinline__ const int8_t* acquire() {
    cp_wait<NBUF - 2 - LAG>();
#ifndef MRF_ABL_NOSYNC
    __syncthreads();
#endif
    issue();
    return ring + (tail++ % NBUF) * SLOT;
  }
  __device__ __forceinline__ void finish() { cp_wait<0>(); }
};

// out[m][n] = sum_tap sum_ci A[a0 + m + tap*dil][ci] * W(tap, ci, n) for
// m < M, n < COUT. A: s8 rows of CIN bytes (swz<CIN>), rows [0, arows); the
// rows a valid output reads lie inside, the rows of a warp tile past M are
// clamped to the last (their outputs are dropped). NW warps tile ROWS rows
// x COUT columns per pass, each warp WM x WN; each pass takes the conv's
// stages from the pipe (schedule() lists them). The epilogue runs per
// column pair: cc = col(n) once, then epi(m, n, acc[n], acc[n + 1], cc) for
// each row m < M of the warp's tile.
template <int CIN, int COUT, int NW, int WM, int TPS, int KCH>
struct Conv {
  // warpgroups of 4 warps; each runs wgmma m64nWNk32 on MB row blocks of 64
  static constexpr int WN = COUT < 128 ? COUT : 128;
  static constexpr int CG = COUT / WN;
  static constexpr int NWG = NW / 4;
  static constexpr int RG = NWG / CG;
  static constexpr int MB = WM / 16;
  static constexpr int ROWS = RG * 64 * MB;
  static constexpr int KC = CIN / KCH;
  static constexpr int KS = KCH / 32;
  static constexpr int STAGE = TPS * COUT * KCH;
  static_assert(CIN % KCH == 0 && KCH % 32 == 0 && KCH <= 128, "k-chunk");
  static_assert(NW % 4 == 0 && NWG % CG == 0 && WN % 8 == 0 && WM % 16 == 0, "warpgroup tile");
  static_assert(STAGE % 16 == 0, "stage");

  __host__ __device__ static int conv_stages(int ntaps) { return ((ntaps + TPS - 1) / TPS) * KC; }
  __host__ __device__ static int passes(int M) { return (M + ROWS - 1) / ROWS; }
  __host__ __device__ static int schedule(Ld* sched, int n, const int8_t* w, int M, int ntaps) {
    for (int ps = 0; ps < passes(M); ++ps)
      for (int s = 0; s < conv_stages(ntaps); ++s) {
        if (sched != nullptr) sched[n] = Ld{w + (size_t)s * STAGE, STAGE, 0};
        ++n;
      }
    return n;
  }

  // The MMAs of one pass, output rows [m0, m0 + ROWS) of M, into acc; the
  // pass takes the conv's stages from the pipe whether or not a warpgroup
  // has rows in it (every block consumes the same schedule).
  template <class P>
  static __device__ __forceinline__ void mma(P& pipe, int (&acc)[MB][WN / 2], const int8_t* A,
                                             int a0, int m0, int M, int dil, int ntaps,
                                             int arows) {
    static_assert(STAGE <= P::slot, "pipe slot");
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wq = warp & 3, wg = warp >> 2;
    const int rg = wg / CG, cg = wg - rg * CG;
    const int n_st = conv_stages(ntaps);
    const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_byte = (lane >> 4) * 16;
    const int wb = m0 + rg * 64 * MB;   // the warpgroup's first row
    const bool active = wb < M;         // the same for its 4 warps
#pragma unroll
    for (int b = 0; b < MB; ++b)
#pragma unroll
      for (int e = 0; e < WN / 2; ++e) acc[b][e] = 0;
    uint32_t a[2][MB][KS][4];
    for (int s = 0; s < n_st; ++s) {
      const int8_t* Ws = pipe.acquire();
#ifndef MRF_ABL_NOMMA
      if (active) {
        const int g = s / KC, kc = s - g * KC;
        // with a lagging pipe the previous stage's MMAs ran on across the
        // barrier; they are done before this stage loads A
        if (P::lag) wg_wait<0>();
#pragma unroll
        for (int tp = 0; tp < TPS; ++tp) {
          const int tap = g * TPS + tp;
          if (tap >= ntaps) break;
          // the MMAs that read A set tp & 1 (two groups back) are done
          if (tp >= 2) wg_wait<1>();
#pragma unroll
          for (int b = 0; b < MB; ++b) {
            const int row = min(a0 + wb + 64 * b + 16 * wq + tap * dil + a_row, arows - 1);
#pragma unroll
            for (int ks = 0; ks < KS; ++ks)
              ldsm4(a[tp & 1][b][ks], A + swz<CIN>(row, kc * KCH + ks * 32 + a_byte));
          }
          wg_fence();
          const int8_t* Wt = Ws + tp * COUT * KCH + cg * WN * KCH;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            const uint64_t desc = b_desc<KCH>(Wt + ks * 32);
#pragma unroll
            for (int b = 0; b < MB; ++b) wgmma_rs<WN>(acc[b], a[tp & 1][b][ks], desc);
          }
          wg_commit();
        }
        // before the block frees this stage's slot (a lagging pipe frees
        // it one stage later)
        if (!P::lag) wg_wait<0>();
      }
#endif
    }
    if (active) wg_wait<0>();
#pragma unroll
    for (int b = 0; b < MB; ++b)
#pragma unroll
      for (int e = 0; e < WN / 2; ++e) wg_hold(acc[b][e]);
  }

  // The epilogue of one pass's sums: per column pair cc = col(n) once, then
  // epi(m, n, acc[n], acc[n + 1], cc) for each row m < M of the warp's tile.
  template <class Col, class Epi>
  static __device__ __forceinline__ void each(const int (&acc)[MB][WN / 2], int m0, int M,
                                              Col&& col, Epi&& epi) {
#ifndef MRF_ABL_NOEPI
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wq = warp & 3, wg = warp >> 2;
    const int rg = wg / CG, cg = wg - rg * CG;
    const int wb = m0 + rg * 64 * MB;
    if (wb >= M) return;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < WN / 8; ++i) {
      const int c = cg * WN + i * 8 + 2 * t;
      const auto cc = col(c);
#pragma unroll
      for (int b = 0; b < MB; ++b) {
        const int r = wb + 64 * b + 16 * wq + g;
        if (r < M) epi(r, c, acc[b][4 * i], acc[b][4 * i + 1], cc);
        if (r + 8 < M) epi(r + 8, c, acc[b][4 * i + 2], acc[b][4 * i + 3], cc);
      }
    }
#endif
  }

  template <class P, class Col, class Epi>
  static __device__ __forceinline__ void run(P& pipe, const int8_t* A, int a0, int M, int dil,
                                             int ntaps, int arows, Col&& col, Epi&& epi) {
    for (int m0 = 0; m0 < M; m0 += ROWS) {
      int acc[MB][WN / 2];
      mma(pipe, acc, A, a0, m0, M, dil, ntaps, arows);
      each(acc, m0, M, col, epi);
    }
    __syncthreads();
  }
};

// One chain step's weights in the staged form (vocoder_kernels.pack_stage_s8
// for the taps, (C,) vectors for the rest).
struct Step {
  const int8_t* w1;
  const float* inv1;
  const int* b1i;
  const float* m1;
  const int8_t* w2;
  const float* sw2;
  const float* b2;
  int dil;
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
  // lo) already hold: conv1 (dilated) requantised into A2, conv2
  // dequantised onto the residual. The new value of R row lo + r1 + r2 + m
  // (m < hi - lo - 2*(r1 + r2)), the next step's row m: with inv_next (the
  // next step's conv1 multiplier) it is stored back and quantised into A1
  // row m; without (the chain's last step) it goes to out(m, n, v0, v1).
  template <class P, class Out>
  static __device__ __forceinline__ void step(P& pipe, float* R, int lo, int hi, const Step& st,
                                              int k, int8_t* A1, int8_t* A2, int arows,
                                              const float* inv_next, Out&& out) {
    const int half = (k - 1) / 2;
    const int r1 = st.dil * half;
    const int M1 = hi - lo - 2 * r1;
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
                    static_cast<uint16_t>(q2(v0, v1, c.inv, c.neg));
              } else {
                out(m, n, v0, v1);
              }
            });
  }
};

}  // namespace blk
}  // namespace mrf
