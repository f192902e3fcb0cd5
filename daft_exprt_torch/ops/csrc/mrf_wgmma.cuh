// Building blocks of the block-resident MRF engines for Hopper: the int8
// engines (mrf_chain_q8.cuh, mrf_dyn_blk.cuh) and the bf16 one
// (mrf_chain_bf16.cuh). The design they serve is in mrf_chain_q8.cuh's
// header: tiles stored with a 16-byte-chunk XOR swizzle (swz), one ring of
// weight stages filled by cp.async (Pipe), weights read by wgmma through a
// descriptor (b_desc), and the int8 engines' tap-shifted GEMM with A from
// ldmatrix (Conv).
//
// Ablation builds (scripts/torch_mrf_ablation.py; results wrong, not
// checked): MRF_ABL_NOW drops the weight copies, MRF_ABL_NOSYNC the
// barrier per weight stage, MRF_ABL_NOMMA the ldmatrix and wgmma,
// MRF_ABL_NOEPI the conv epilogues.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mrf {
namespace blk {

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

// Byte offset of byte `byte` of row r in a tile of ROWB bytes per row:
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
__device__ __forceinline__ void wg_hold(float& r) { asm volatile("" : "+f"(r)::"memory"); }

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

// A run of the weight stream: n stages of `bytes` (a multiple of 16) each,
// consecutive from `src` (one pass of one conv).
struct Ld {
  const int8_t* src;
  int bytes, n;
};

// The block's weight stream: every conv stage the block consumes, in
// consumption order (the schedule: runs of stages, the same list for every
// item a launch's blocks walk through, so it wraps from one item to the
// next), copied by
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
  int n, head, tail, run, in_run;   // the next copy: stage in_run of run

  __device__ __forceinline__ void issue() {
    const Ld e = sched[run];
    const int8_t* src = e.src + (size_t)in_run * e.bytes;
    int8_t* dst = ring + (head % NBUF) * SLOT;
#ifndef MRF_ABL_NOW
    for (int i = threadIdx.x; i < e.bytes / 16; i += NTH) cp16(dst + 16 * i, src + 16 * i);
#endif
    cp_commit();
    ++head;
    if (++in_run == e.n) {
      in_run = 0;
      run = run + 1 == n ? 0 : run + 1;
    }
  }
  __device__ __forceinline__ void start(int8_t* r, const Ld* s, int len) {
    ring = r;
    sched = s;
    n = len;
    head = tail = run = in_run = 0;
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
    for (int ps = 0; ps < passes(M); ++ps) {
      if (sched != nullptr) sched[n] = Ld{w, STAGE, conv_stages(ntaps)};
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

}  // namespace blk
}  // namespace mrf
