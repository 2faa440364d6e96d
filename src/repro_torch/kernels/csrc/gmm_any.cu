// The grouped expert-tile matmul and its two backward products at bf16 and
// fp16 off gmm.cu's blocks, for Hopper (sm_90a): wgmma on the tensor cores,
// fed by TMA or by a thread-issued loader.
//
// Replaces: _gmm_kernel in src/repro/kernels/grouped_matmul/grouped_matmul.py
// (entry grouped_matmul_tiles) wherever gmm.cu cannot take a 2-byte call:
// bm not a multiple of 128 (the MoE demo's block_rows 8, any small tile), f
// not a multiple of 128, d not a multiple of 32, rows TMA cannot describe,
// and every fp16 call.  The backward's dX = dY W^T and dW[e] = X[e]^T dY[e]
// (no Pallas kernel: the reference differentiates its einsums) likewise
// where gmm_dx / gmm_dw cannot take them.  fp32 runs gmm_simt.cu.
//
// What bounds it on an H100: bytes.  At qwen3-moe's width in 8-row tiles
// (128 experts x 64 rows, d 2048, f 768) a forward does 26 GFLOP over 403
// MB of weights, 64 operations per byte, a fifth of the card's ~295, so the
// time is the weights' time; a dW writes 403 MB of gradient for the same
// operations.  The thread loader moves the same stages at about half
// TMA's rate (PERF.md): 16-byte copies where TMA would take the rows, 8 or
// 4 bytes at strides TMA cannot describe.
//
// Design (gmm.cu's producer / two-consumer shape, one template for the
// three products, T = __nv_bfloat16 or __half with its own wgmma type):
//   * Forward, persistent over the plan: CTA w of p walks steps
//     [bounds[w], bounds[w+1]) of `order`, then the dead steps n_span + w,
//     n_span + w + p, ..., so KernelTilePlan.shares() describes what ran.
//     A unit stacks the run of consecutive steps in that walk whose tiles
//     have one expert, up to 128 rows (128 / bm tiles, at most 16; one tile
//     when bm > 64, or with TMA when bm % 8 != 0), and runs every
//     256-column block of the expert's weights over it: the weights are
//     read once per run, not once per tile.  Tile j's rows land at row
//     j bm of the stage.  A tile of more than 128 rows is cut into 128-row
//     blocks, the block innermost, so its column panel is read again while
//     it is in L2.
//   * dX needs no plan: units (expert, 256-column n block of d, 128-row m
//     block of R), m innermost, dealt round-robin over min(p, units) CTAs,
//     gmm_dx's raster; w (E, d, f) is read in place as a K-major B.
//   * dW (gmm_dw's units): (expert, 128-row m block of d, 256-column n
//     block of f), n innermost, dealt round-robin; the R rows are the
//     reduction, 64 a stage in ascending order; X is read MN-major as A
//     (trans-a 1), dY as the forward reads w (MN-major, trans-b 1).
//   * Two loaders fill the same ring of 4 stages (phase bits carry across
//     units), in the layout TMA's 128-byte swizzle gives: rows of 64
//     elements (128 bytes), the 16-byte chunk q of stage row r at
//     q ^ (r % 8), each 64-row box 1024-byte aligned.
//       - TMA (route "wgmma_any"): one producer thread, where d and f are
//         multiples of 8 and the bases 16-byte aligned.  x is mapped as
//         (T, bm, d), dY as (E, R, f), X as (E, R, d) and w as (E, d, f),
//         so a box past an edge is zero-filled within its tile or expert.
//       - Threads (route "wgmma_ld"): the whole producer warpgroup, any
//         width and alignment.  Thread t copies chunk t % 8 of stage rows
//         t / 8, t / 8 + 16, ...: cp.async of 16, 8 or 4 bytes, the widest
//         that the operand's base and row stride allow (so no copy crosses
//         a row's end), zero-filled past the reduction depth and the
//         operand's width (src-size below the copy's size); where neither
//         allows 4 bytes, 2-byte loads into registers and one 16-byte
//         st.shared a chunk.  The width is a template argument of each
//         piece's copy loop (read inside the loop, it cost the f 764
//         forward half its speed on an H100), and every copy asks L2 for
//         its 256-byte block as TMA's L2_256B promotion does, so that a
//         row read along k finds its next stage in L2.  A thread's stage
//         is one cp.async group; two stages later it waits for that
//         group, fences the async proxy (its copies and st.shared before
//         wgmma's reads) and arrives on the stage's `full` barrier, so
//         three stages are in flight.
//     Consumer warpgroup c issues wgmma.m64nNk16 for rows 64 c .. 64 c + 63
//     of the unit, or, when the unit has no row there, waits for each stage
//     and hands it back.  The last column block runs the narrowest of n64 /
//     n128 / n256 that covers it.
//   * Stores are clipped at the edges: each thread writes its accumulator
//     pairs straight from registers, two 2-byte values a 32-bit store (one
//     value a store where the output width is odd), rows past the unit's
//     and columns past the width skipped.  dW on TMA, whose units write
//     64 KB of gradient for one 64-deep stage at qwen3-moe's R 64, stores
//     as gmm.cu does: swizzled staging boxes and TMA stores, so a unit's
//     stores overlap the next unit's products.  An empty reduction (d, f or R
//     0) stores zeros, apart from the accumulators.
//   * No split-k, no atomics: every output element is the same wgmma
//     sequence over the same k blocks whatever CTA, unit, loader or row
//     position computes it, so outputs are bit-identical for every schedule
//     and p.

#include <cuda_fp16.h>

#include <type_traits>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                  // rows of a unit
constexpr int BK = 64;                   // depth of a stage (128 bytes)
constexpr int BN = 256;                  // columns of a unit
constexpr int STAGES = 4;
constexpr int NTHREADS = 384;            // producer + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int MAX_RUN = 16;              // tiles of a unit (16 x 8 rows)
constexpr int A_BYTES = BM * BK * 2;     // 128 rows x 64 k
constexpr int B_BOX = 64 * 64 * 2;       // one 64 x 64 box of w
constexpr int B_BYTES = (BN / 64) * B_BOX;
constexpr int C_BOX = 64 * 64 * 2;       // dW out box: 64 rows x 64 columns
constexpr int C_BYTES = 2 * C_BOX;       // staging of one consumer: 2 boxes
constexpr int SMEM_A = 0;
constexpr int SMEM_B = SMEM_A + STAGES * A_BYTES;
constexpr int SMEM_C = SMEM_B + STAGES * B_BYTES;
constexpr int SMEM_BAR = SMEM_C + 2 * C_BYTES;
constexpr int SMEM_BYTES = SMEM_BAR + 2 * STAGES * 8 + 1024;  // + alignment

enum Mode { FWD = 0, DX = 1, DW = 2 };

// wgmma.m64nNk16 of the element type T, A and B from shared memory,
// trans-a TA, trans-b TB
template <typename T, int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 256)
    wgmma_m64n256k16_ss<TB, TA, T>(d, da, db, scale_d);
  else if constexpr (N == 128)
    wgmma_m64n128k16_ss<TB, TA, T>(d, da, db, scale_d);
  else
    wgmma_m64n64k16_ss<TB, TA, T>(d, da, db, scale_d);
}

struct Params {
  void* out;
  const void* a;            // thread loader: x (fwd), dY (dX), X (dW)
  const void* b;            // thread loader: w (fwd, dX), dY (dW)
  const int* order;         // fwd: (T,) step -> tile slot
  const int* tile_expert;   // fwd: (T,) tile slot -> expert
  const int* bounds;        // fwd: (p + 1,) live steps of each CTA
  int n_span, T, bm, max_run;
  int E, R, M;              // dX / dW: experts, rows an expert; dW: d
  int K, N;                 // the reduction (fwd d, dX f, dW R), the width
  int wa, wb;               // thread loader: copy bytes of a and b
};

// the step sequence of CTA w: its live steps, then its dead ones
struct Walk {
  int live0 = 0, nlive = 0, nsteps = 0, p = 1, w = 0, n_span = 0;
  __device__ explicit Walk(const Params& P, bool fwd) {
    if (!fwd) return;   // dX and dW have no plan (bounds is null)
    p = gridDim.x;
    w = blockIdx.x;
    live0 = P.bounds[w];
    nlive = P.bounds[w + 1] - live0;
    const int ndead =
        (P.T - P.n_span > w) ? (P.T - P.n_span - w + p - 1) / p : 0;
    nsteps = nlive + ndead;
    n_span = P.n_span;
  }
  __device__ int step(int it) const {
    return it < nlive ? live0 + it : n_span + w + (it - nlive) * p;
  }
};

// the tile of walk position `it` and the length of the run of positions
// from it whose tiles share its expert (at most max_run)
__device__ __forceinline__ int run_length(const Params& P, const Walk& wk,
                                          int it, int e) {
  int n = 1;
  while (n < P.max_run && it + n < wk.nsteps &&
         P.tile_expert[P.order[wk.step(it + n)]] == e)
    ++n;
  return n;
}

// What one unit is, as producer and consumers both derive it.  fwd: the
// run of `nrun` tiles from walk position `it` (or one tile's 128-row block
// mb), rows `rows` of them valid; dX: expert e's m block mb; dW: expert
// e's block mb of d.  `col`: the first output column.
struct Unit {
  int it, nrun, mb, e, col, rows;
};

// The units of CTA blockIdx.x in order, one per next(): fwd, the runs of
// its walk, each run's column blocks and 128-row blocks; dX and dW, units
// w, w + p, ... of their rasters.  (A cursor, not a callback: the producer
// and consumer loops stay inline in their own register regions.)
template <int MODE>
struct Units {
  const Params& P;
  const Walk& wk;
  int nnb, nmb, units, rows;
  int it = 0, nrun = 0, e = 0, nb, mb = 0, v;
  __device__ __forceinline__ Units(const Params& P_, const Walk& wk_)
      : P(P_), wk(wk_) {
    nnb = (P.N + BN - 1) / BN;
    rows = MODE == FWD ? P.bm : MODE == DX ? P.R : P.M;
    nmb = (rows + BM - 1) / BM;
    units = MODE == FWD ? 0 : P.E * nnb * nmb;
    nb = nnb;   // fwd: the first next() starts a run
    v = blockIdx.x;
  }
  __device__ __forceinline__ bool next(Unit& u) {
    if constexpr (MODE == FWD) {
      if (mb == nmb) {
        mb = 0;
        ++nb;
      }
      if (nb == nnb) {   // the next run
        it += nrun;
        if (it >= wk.nsteps) return false;
        e = P.tile_expert[P.order[wk.step(it)]];
        nrun = run_length(P, wk, it, e);
        nb = 0;
      }
      u.it = it;
      u.nrun = nrun;
      u.e = e;
      u.col = nb * BN;
      u.mb = mb;
      u.rows = P.max_run > 1 ? nrun * P.bm : min(BM, P.bm - mb * BM);
      ++mb;
    } else {
      if (v >= units) return false;
      u.it = 0;
      u.nrun = 1;
      u.e = v / (nnb * nmb);
      if constexpr (MODE == DX) {   // m innermost
        u.col = ((v / nmb) % nnb) * BN;
        u.mb = v % nmb;
      } else {                      // n innermost
        u.col = (v % nnb) * BN;
        u.mb = (v / nnb) % nmb;
      }
      u.rows = min(BM, rows - u.mb * BM);
      v += gridDim.x;
    }
    return true;
  }
};

// One unit's k loop on the consumer side (gmm.cu's mainloop): wait for each
// stage, issue its four 16-deep wgmmas, hand the previous stage back once
// its group retired.  A is K-major (TA 0) or MN-major (TA 1, dW's X^T); B
// is MN-major (TB 1, the forward's w, dW's dY) or K-major (TB 0, dX's w
// read in place).
template <typename T, int N, int TA, int TB>
__device__ __forceinline__ void mainloop(float* acc, unsigned char* smem,
                                         uint64_t* full, uint64_t* empty,
                                         int c, int nk, int& g, int lane) {
  constexpr int ASTEP = TA ? 128 : 2, BSTEP = TB ? 128 : 2;
  for (int kb = 0; kb < nk; ++kb) {
    const int s = g % STAGES;
    mbar_wait(&full[s], (g / STAGES) & 1);
    unsigned char* a = smem + SMEM_A + s * A_BYTES + c * 64 * 128;
    unsigned char* b = smem + SMEM_B + s * B_BYTES;
    const uint64_t da = TA ? smem_desc(a, 64 * 128, 1024)
                           : smem_desc(a, 16, 1024);
    const uint64_t db = TB ? smem_desc(b, B_BOX, 1024) : smem_desc(b, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss<T, N, TA, TB>(acc, da + ASTEP * kk, db + BSTEP * kk, kb | kk);
    wgmma_commit();
    if (kb > 0) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(&empty[(g - 1) % STAGES]);
    }
    ++g;
  }
  wgmma_wait<0>();
  fence_regs<N / 2>(acc);
  if (lane == 0) mbar_arrive(&empty[(g - 1) % STAGES]);
}

// a consumer with no row in the unit: each stage waited for and handed back
// (waiting keeps its arrivals in the stage's phase)
__device__ __forceinline__ void idle_loop(uint64_t* full, uint64_t* empty,
                                          int nk, int& g, int lane) {
  for (int kb = 0; kb < nk; ++kb, ++g) {
    const int s = g % STAGES;
    mbar_wait(&full[s], (g / STAGES) & 1);
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

// the row of the unit's operand A (fwd x, dX dY) and of the output that
// unit row rr (below u.rows) stands for
template <int MODE>
__device__ __forceinline__ long long unit_row(const Params& P, const Walk& wk,
                                              const Unit& u, int rr) {
  if constexpr (MODE == FWD) {
    const int bm = P.bm;
    const int j = P.max_run > 1 ? rr / bm : 0;
    const int i = P.max_run > 1 ? rr % bm : u.mb * BM + rr;
    return static_cast<long long>(P.order[wk.step(u.it + j)]) * bm + i;
  } else {
    return static_cast<long long>(u.e) * (MODE == DX ? P.R : P.M) +
           u.mb * BM + rr;
  }
}

// the output row of unit row rr (0..127), or nullptr past the unit's rows
template <int MODE, typename T>
__device__ __forceinline__ T* out_row(const Params& P, const Walk& wk,
                                      const Unit& u, int rr) {
  if (rr >= u.rows) return nullptr;
  return static_cast<T*>(P.out) + unit_row<MODE>(P, wk, u, rr) * P.N + u.col;
}

// the accumulators of consumer c's 64 rows out to memory: value pairs
// (v, v + 1) of row r and (v + 2, v + 3) of row r + 8, columns 8 (v / 4) +
// 2 (lane % 4) + {0, 1}, clipped at the unit's rows and at N (an odd N:
// one 2-byte store a value, its rows being 2-byte aligned only)
template <int MODE, typename T, int N>
__device__ __forceinline__ void store(const float* acc, const Params& P,
                                      const Walk& wk, const Unit& u, int c,
                                      int tq) {
  const int lane = tq % 32;
  const int r = 64 * c + 16 * (tq / 32) + lane / 4;
  T* p0 = out_row<MODE, T>(P, wk, u, r);
  T* p1 = out_row<MODE, T>(P, wk, u, r + 8);
  const int ncol = P.N - u.col;
  const bool pairs = P.N % 2 == 0;
#pragma unroll
  for (int q = 0; q < N / 8; ++q) {
    const int col = 8 * q + 2 * (lane % 4);
    if (col >= ncol) break;
    if (pairs) {
      if (p0) *reinterpret_cast<uint32_t*>(p0 + col) =
          pack2<T>(acc[4 * q], acc[4 * q + 1]);
      if (p1) *reinterpret_cast<uint32_t*>(p1 + col) =
          pack2<T>(acc[4 * q + 2], acc[4 * q + 3]);
    } else {
      const bool two = col + 1 < ncol;
      if (p0) {
        p0[col] = cvt<T>(acc[4 * q]);
        if (two) p0[col + 1] = cvt<T>(acc[4 * q + 1]);
      }
      if (p1) {
        p1[col] = cvt<T>(acc[4 * q + 2]);
        if (two) p1[col + 1] = cvt<T>(acc[4 * q + 3]);
      }
    }
  }
}

// dW on TMA (gmm.cu's epilogue): consumer c's 64 rows in 64-column chunks
// through its two swizzled staging boxes, one TMA store a chunk, clipped at
// d and f within the expert.  Chunk q of the consumer's whole run uses box
// q % 2, which the store of chunk q - 2 must have finished reading: the
// wait keeps one store in flight.
template <typename T, int N>
__device__ __forceinline__ void store_tma(const float* acc,
                                          unsigned char* cst,
                                          const CUtensorMap* omap,
                                          const Unit& u, int c, int tq,
                                          int& qc) {
  const int lane = tq % 32;
  const int r = 16 * (tq / 32) + lane / 4;   // and r + 8; both have r % 8
  const int sw = lane / 4;                    // == (r % 8)
#pragma unroll
  for (int q = 0; q < N / 64; ++q, ++qc) {
    unsigned char* box = cst + (qc & 1) * C_BOX;
    if (tq == 0) bulk_wait_read<1>();
    named_bar_sync(1 + c, 128);
#pragma unroll
    for (int j = 0; j < 8; ++j) {             // 8-column groups of the chunk
      const int v = (8 * q + j) * 4;
      unsigned char* p = box + ((j ^ sw) * 16) + 4 * (lane % 4);
      *reinterpret_cast<uint32_t*>(p + r * 128) = pack2<T>(acc[v], acc[v + 1]);
      *reinterpret_cast<uint32_t*>(p + (r + 8) * 128) =
          pack2<T>(acc[v + 2], acc[v + 3]);
    }
    fence_proxy_async();
    named_bar_sync(1 + c, 128);
    if (tq == 0) {
      tma_store_3d(omap, box, u.col + 64 * q, u.mb * BM + 64 * c, u.e);
      bulk_commit();
    }
  }
}

template <int MODE, typename T, int N, bool LD>
__device__ __forceinline__ void consume_n(const Params& P, const Walk& wk,
                                          const Unit& u, float* acc,
                                          unsigned char* smem, uint64_t* full,
                                          uint64_t* empty, int c, int nk,
                                          int& g, int tq,
                                          const CUtensorMap* omap, int& qc) {
  constexpr int TA = MODE == DW ? 1 : 0, TB = MODE == DX ? 0 : 1;
  mainloop<T, N, TA, TB>(acc, smem, full, empty, c, nk, g, tq % 32);
  if constexpr (MODE == DW && !LD)
    store_tma<T, N>(acc, smem + SMEM_C + c * C_BYTES, omap, u, c, tq, qc);
  else
    store<MODE, T, N>(acc, P, wk, u, c, tq);
}

// consumer c's rows of a unit of an empty reduction (d, f or R 0): zeros.
// (Apart from the accumulators: a zero-filled accumulator path beside
// wgmma's made ptxas spill them in every instantiation.)
template <int MODE, typename T>
__device__ __forceinline__ void store_zeros(const Params& P, const Walk& wk,
                                            const Unit& u, int c, int tq) {
  const int ncol = min(BN, P.N - u.col);
  for (int i = tq; i < 64 * ncol; i += 128) {
    T* row = out_row<MODE, T>(P, wk, u, 64 * c + i / ncol);
    if (row) row[i % ncol] = cvt<T>(0.f);
  }
}

template <int MODE, typename T, bool LD>
__device__ __forceinline__ void consume(const Params& P, const Walk& wk,
                                        const Unit& u, float* acc,
                                        unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, int c, int nk,
                                        int& g, int tq,
                                        const CUtensorMap* omap, int& qc) {
  if (u.rows <= 64 * c) {
    idle_loop(full, empty, nk, g, tq % 32);
    return;
  }
  const int ncol = P.N - u.col;
  if (ncol > 128)
    consume_n<MODE, T, 256, LD>(P, wk, u, acc, smem, full, empty, c, nk, g,
                                tq, omap, qc);
  else if (ncol > 64)
    consume_n<MODE, T, 128, LD>(P, wk, u, acc, smem, full, empty, c, nk, g,
                                tq, omap, qc);
  else
    consume_n<MODE, T, 64, LD>(P, wk, u, acc, smem, full, empty, c, nk, g,
                               tq, omap, qc);
}

// ---- the TMA loader: one thread ----

// the stages of one unit, filled by the producer thread
template <int MODE>
__device__ __forceinline__ void produce_tma(const Params& P, const Walk& wk,
                                            const Unit& u,
                                            const CUtensorMap* amap,
                                            const CUtensorMap* wmap,
                                            unsigned char* smem,
                                            uint64_t* full, uint64_t* empty,
                                            int nk, int box_rows, int& g) {
  const int nbox = min(BN, P.N - u.col + 63) / 64;
  // dW: X's two 64-column m boxes, the second only where the unit has rows
  const int nabox = u.rows > 64 ? 2 : 1;
  const uint32_t bytes = MODE == DW ? nabox * B_BOX + nbox * B_BOX
                                    : u.nrun * box_rows * 128 + nbox * B_BOX;
  for (int kb = 0; kb < nk; ++kb, ++g) {
    const int s = g % STAGES;
    mbar_wait(&empty[s], ((g / STAGES) & 1) ^ 1);
    mbar_expect_tx(&full[s], bytes);
    unsigned char* a = smem + SMEM_A + s * A_BYTES;
    unsigned char* b = smem + SMEM_B + s * B_BYTES;
    if constexpr (MODE == FWD) {
      for (int j = 0; j < u.nrun; ++j)
        tma_load_3d(a + j * P.bm * 128, amap, &full[s], kb * BK, u.mb * BM,
                    P.order[wk.step(u.it + j)]);
      for (int j = 0; j < nbox; ++j)
        tma_load_3d(b + j * B_BOX, wmap, &full[s], u.col + 64 * j, kb * BK,
                    u.e);
    } else if constexpr (MODE == DX) {
      tma_load_3d(a, amap, &full[s], kb * BK, u.mb * BM, u.e);
      for (int j = 0; j < nbox; ++j)
        tma_load_3d(b + j * B_BOX, wmap, &full[s], kb * BK, u.col + 64 * j,
                    u.e);
    } else {
      for (int j = 0; j < nabox; ++j)
        tma_load_3d(a + j * B_BOX, amap, &full[s], u.mb * BM + 64 * j,
                    kb * BK, u.e);
      for (int j = 0; j < nbox; ++j)
        tma_load_3d(b + j * B_BOX, wmap, &full[s], u.col + 64 * j, kb * BK,
                    u.e);
    }
  }
}

// ---- the thread loader: the producer warpgroup ----

// a cp.async of `width` bytes, zero past src_bytes; each asks L2 for the
// 256-byte block around it, as TMA's L2_256B promotion does, so that the
// next stage of a row read along k finds its bytes in L2
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int width, int src_bytes) {
  if (width == 16)
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
                 ::"r"(dst), "l"(src), "r"(src_bytes)
                 : "memory");
  else if (width == 8)
    asm volatile("cp.async.ca.shared.global.L2::256B [%0], [%1], 8, %2;\n"
                 ::"r"(dst), "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global.L2::256B [%0], [%1], 4, %2;\n"
                 ::"r"(dst), "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// at most N of this thread's cp.async groups still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The thread loader's stages in flight: a thread's stage is one cp.async
// group, and it arrives on the stage's `full` barrier once the group has
// landed, LAG stages later (after its proxy fence, which orders its copies
// and st.shared before the consumers' wgmma reads).  A stage's consumers
// hand back stage g - 4's slot only after their wgmma on stage g - 3, so
// LAG 2 lets the producer wait for that slot without a deadlock.
constexpr int LAG = 2;

struct Pending {
  int n = 0;   // stages issued and not yet arrived
  __device__ __forceinline__ void arrive(uint64_t* full, int g) {
    fence_proxy_async();
    mbar_arrive(&full[(g - n) % STAGES]);
    --n;
  }
  // after stage g - 1 was issued: arrive for what has landed beyond LAG
  __device__ __forceinline__ void issued(uint64_t* full, int g) {
    cp_async_commit();
    if (++n > LAG) {
      cp_async_wait<LAG>();
      arrive(full, g);
    }
  }
  __device__ __forceinline__ void drain(uint64_t* full, int g) {
    cp_async_wait<0>();
    while (n > 0) arrive(full, g);
  }
};

// One 16-byte chunk (8 elements) of a stage row: `nv` of them from `src`,
// zeros past them, in copies of W bytes (16, 8, 4; 2: loaded into
// registers, one st.shared); `zero` is a valid address for empty copies
template <int W>
__device__ __forceinline__ void copy_chunk(uint32_t dst, const uint16_t* src,
                                           int nv, const uint16_t* zero) {
  if constexpr (W >= 4) {
    constexpr int PER = W / 2;   // elements a copy
#pragma unroll
    for (int h = 0; h < 8; h += PER) {
      const int n = min(max(nv - h, 0), PER);
      cp_async(dst + 2 * h, n ? src + h : zero, W, 2 * n);
    }
  } else {
    uint32_t v[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const uint32_t lo = 2 * h < nv ? __ldg(src + 2 * h) : 0u;
      const uint32_t hi = 2 * h + 1 < nv ? __ldg(src + 2 * h + 1) : 0u;
      v[h] = lo | (hi << 16);
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                 "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                 : "memory");
  }
}

// the stage rows of a piece that are rows r0 + r of a 2-D operand at
// `base` (row stride `stride` elements), nullptr (zeros) at or past `lim`
struct Rows {
  const uint16_t* base;
  long long stride;
  int r0, lim;
  __device__ __forceinline__ const uint16_t* operator()(int r, int) const {
    return r0 + r < lim ? base + (r0 + r) * stride : nullptr;
  }
};

// the stage rows that are a unit's rows, this thread's fixed for the unit
struct UnitRows {
  const uint16_t* const (&p)[BM / 16];
  __device__ __forceinline__ const uint16_t* operator()(int, int i) const {
    return p[i];
  }
};

template <int NR, int W, typename RowFn>
__device__ __forceinline__ void load_rows(uint32_t base, int nrows,
                                          const RowFn& row, int off, int nv,
                                          const uint16_t* zero, int t) {
#pragma unroll
  for (int i = 0; i < NR / 16; ++i) {
    const int r = t / 8 + 16 * i;
    if (r >= nrows) break;
    const uint16_t* p = row(r, i);
    copy_chunk<W>(base + r * 128, p ? p + off : zero, p ? nv : 0, zero);
  }
}

// Rows [0, nrows) of a stage piece at S (1024-byte aligned), row r holding
// elements [i0, i0 + 64) of the row that row(r, i) returns (nullptr:
// zeros), those at or past `lim` zero; thread t copies chunk t % 8 of rows
// t / 8 + 16 i (NR: the piece's rows, a bound for the unrolled loop), in
// copies of `width` bytes
template <int NR, typename RowFn>
__device__ __forceinline__ void load_piece(unsigned char* S, int nrows,
                                           const RowFn& row, int i0, int lim,
                                           int width, const uint16_t* zero,
                                           int t) {
  const int q = t % 8;
  const int nv = min(max(lim - i0 - 8 * q, 0), 8);
  const uint32_t base = smem_u32(S) + ((q ^ ((t / 8) % 8)) << 4);
  const int off = i0 + 8 * q;
  switch (width) {
    case 16: load_rows<NR, 16>(base, nrows, row, off, nv, zero, t); break;
    case 8: load_rows<NR, 8>(base, nrows, row, off, nv, zero, t); break;
    case 4: load_rows<NR, 4>(base, nrows, row, off, nv, zero, t); break;
    default: load_rows<NR, 2>(base, nrows, row, off, nv, zero, t);
  }
}

// the stages of one unit, filled by the 128 threads of the producer
// warpgroup (thread t)
template <int MODE>
__device__ __forceinline__ void produce_ld(const Params& P, const Walk& wk,
                                           const Unit& u, unsigned char* smem,
                                           uint64_t* full, uint64_t* empty,
                                           int nk, int& g, Pending& pend,
                                           int t) {
  const uint16_t* A = static_cast<const uint16_t*>(P.a);
  const uint16_t* B = static_cast<const uint16_t*>(P.b);
  const int nbox = min(BN, P.N - u.col + 63) / 64;
  // fwd: this thread's rows of A are the run's tiles' rows, fixed for the
  // unit (dX's are rows of one expert, a Rows)
  const uint16_t* arow[BM / 16];
  if constexpr (MODE == FWD) {
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) {
      const int rr = t / 8 + 16 * i;
      arow[i] = rr < u.rows ? A + unit_row<MODE>(P, wk, u, rr) * P.K
                            : nullptr;
    }
  }
  for (int kb = 0; kb < nk; ++kb) {
    const int s = g % STAGES;
    const int k0 = kb * BK;
    mbar_wait(&empty[s], ((g / STAGES) & 1) ^ 1);
    unsigned char* a = smem + SMEM_A + s * A_BYTES;
    unsigned char* b = smem + SMEM_B + s * B_BYTES;
    if constexpr (MODE == DW) {
      // X (E, R, d): 64 k rows x 64 m a box; dY (E, R, f) likewise
      const Rows xk{A + static_cast<long long>(u.e) * P.K * P.M, P.M, k0,
                    P.K};
      const Rows yk{B + static_cast<long long>(u.e) * P.K * P.N, P.N, k0,
                    P.K};
      for (int j = 0; j < 2 && 64 * j < u.rows; ++j)
        load_piece<64>(a + j * B_BOX, 64, xk, u.mb * BM + 64 * j, P.M, P.wa,
                       A, t);
      for (int j = 0; j < nbox; ++j)
        load_piece<64>(b + j * B_BOX, 64, yk, u.col + 64 * j, P.N, P.wb, B,
                       t);
    } else {
      // A: the unit's rows, k along them
      if constexpr (MODE == FWD)
        load_piece<BM>(a, u.rows, UnitRows{arow}, k0, P.K, P.wa, A, t);
      else
        load_piece<BM>(a, u.rows,
                       Rows{A + unit_row<DX>(P, wk, u, 0) * P.K, P.K, 0,
                            u.rows},
                       k0, P.K, P.wa, A, t);
      if constexpr (MODE == FWD) {
        // w (E, d, f): 64 k rows x 64 n a box
        const Rows wk_rows{B + static_cast<long long>(u.e) * P.K * P.N, P.N,
                           k0, P.K};
        for (int j = 0; j < nbox; ++j)
          load_piece<64>(b + j * B_BOX, 64, wk_rows, u.col + 64 * j, P.N,
                         P.wb, B, t);
      } else {
        // w (E, d, f) K-major: rows n = col + r of d, k along them
        const Rows wn{B + static_cast<long long>(u.e) * P.N * P.K, P.K, u.col,
                      P.N};
        load_piece<BN>(b, 64 * nbox, wn, k0, P.K, P.wb, B, t);
      }
    }
    pend.issued(full, ++g);
  }
}

// The forward (MODE FWD): x (T, bm, d), w (E, d, f); dX (MODE DX): dY (E,
// R, f), w (E, d, f) read K-major; dW (MODE DW): X (E, R, d), dY (E, R, f),
// on TMA stored through omap (E, d, f).  LD: the thread loader (the maps
// unused), else TMA.  See the header.
template <int MODE, typename T, bool LD>
__global__ void __launch_bounds__(NTHREADS, 1)
gmm_any_kernel(const __grid_constant__ CUtensorMap amap,
               const __grid_constant__ CUtensorMap wmap,
               const __grid_constant__ CUtensorMap omap, const Params P,
               int box_rows) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SMEM_BAR);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // TMA: the producer's expect_tx; threads: one arrival each
      mbar_init(&full[s], LD ? 128 : 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int nk = (P.K + BK - 1) / BK;
  const Walk wk(P, MODE == FWD);

  if (wg == 0) {
    if constexpr (LD) {
      // ---- producer: the warpgroup's 128 threads fill the ring ----
      reg_dealloc<56>();
      int g = 0;
      Pending pend;
      Unit u;
      for (Units<MODE> us(P, wk); us.next(u);)
        produce_ld<MODE>(P, wk, u, smem, full, empty, nk, g, pend, tid);
      pend.drain(full, g);
    } else {
      // ---- producer: one thread keeps the ring full ----
      reg_dealloc<40>();
      if (tid == 0) {
        int g = 0;
        Unit u;
        for (Units<MODE> us(P, wk); us.next(u);)
          produce_tma<MODE>(P, wk, u, &amap, &wmap, smem, full, empty, nk,
                            box_rows, g);
      }
    }
  } else {
    // ---- consumers: rows 64 c .. 64 c + 63 of every unit ----
    if constexpr (LD) reg_alloc<224>(); else reg_alloc<232>();
    const int c = wg - 1;
    const int tq = tid % 128;
    float acc[BN / 2];
    int g = 0, qc = 0;
    Unit u;
    if (nk == 0) {
      for (Units<MODE> us(P, wk); us.next(u);)
        store_zeros<MODE, T>(P, wk, u, c, tq);
    } else {
      for (Units<MODE> us(P, wk); us.next(u);)
        consume<MODE, T, LD>(P, wk, u, acc, smem, full, empty, c, nk, g, tq,
                             &omap, qc);
    }
    if constexpr (MODE == DW && !LD)
      if (tq == 0) bulk_wait();
  }
}

// maps (A, B) of a 2-byte (E', rows, width) pair, boxes of 64 x `arows`
// and 64 x 64: A (E', ar, aw), B (E', br, bw); 0 or an error code
int encode_pair(CUtensorMap* amap, CUtensorMap* bmap, const void* a,
                const void* b, int dtype, int ea, int ar, int aw, int abox_r,
                int eb, int br, int bw) {
  using u64 = cuuint64_t;
  const u64 ad[3] = {(u64)aw, (u64)ar, (u64)ea};
  const u64 as[2] = {(u64)aw * 2, (u64)ar * aw * 2};
  const cuuint32_t ab[3] = {BK, (cuuint32_t)abox_r, 1};
  const u64 bd[3] = {(u64)bw, (u64)br, (u64)eb};
  const u64 bs[2] = {(u64)bw * 2, (u64)br * bw * 2};
  const cuuint32_t bb[3] = {64, 64, 1};
  const int rc = encode_tiled(amap, a, 3, ad, as, ab, dtype);
  return rc != 0 ? rc : encode_tiled(bmap, b, 3, bd, bs, bb, dtype);
}

// the thread loader's copy: the widest of 16, 8 and 4 bytes that the base
// and the row stride (`width` 2-byte elements) both allow, else 2
int copy_bytes(const void* base, long long width) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  for (int w = 16; w >= 4; w /= 2)
    if (a % w == 0 && (width * 2) % w == 0) return w;
  return 2;
}

// the kernel's tensor maps (those a launch does not use stay zero)
struct Maps {
  CUtensorMap a{}, w{}, o{};
};

template <int MODE, typename T, bool LD>
int launch_t(const Maps& m, const Params& P, int box_rows, int grid,
             void* stream) {
  auto kernel = gmm_any_kernel<MODE, T, LD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      m.a, m.w, m.o, P, box_rows);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, typename T>
int launch_ld(const Maps& m, const Params& P, int box_rows, int grid,
              bool ld, void* stream) {
  return ld ? launch_t<MODE, T, true>(m, P, box_rows, grid, stream)
            : launch_t<MODE, T, false>(m, P, box_rows, grid, stream);
}

template <int MODE>
int launch(const Maps& m, const Params& P, int box_rows, int grid,
           int dtype, bool ld, void* stream) {
  if (grid <= 0) return 0;
  return dtype == F16
             ? launch_ld<MODE, __half>(m, P, box_rows, grid, ld, stream)
             : launch_ld<MODE, __nv_bfloat16>(m, P, box_rows, grid, ld,
                                              stream);
}

bool tma_rows(int a, int b, const void* p, const void* q) {
  return a > 0 && a % 8 == 0 && b > 0 && b % 8 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

}  // namespace

// x (T, bm, d), w (E, d, f) -> out (T, bm, f): each tile times its
// expert's w, on p persistent CTAs walking the plan as gmm_launch does.
// ld: the thread loader (any d >= 0, any alignment); else TMA (d and f
// multiples of 8, every base 16-byte aligned)
extern "C" int gmm_any_launch(const void* x, const void* w, void* out,
                              const void* order, const void* tile_expert,
                              const void* bounds, int p, int n_span, int T,
                              int bm, int d, int f, int E, int dtype, int ld,
                              void* stream) {
  if (p <= 0 || T < 0 || E <= 0 || bm <= 0 || d < 0 || f <= 0 ||
      n_span < 0 || n_span > T || (dtype != BF16 && dtype != F16) ||
      (!ld && !tma_rows(d, f, x, w)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  const int box_rows = bm < BM ? bm : BM;
  Maps m;
  if (!ld) {
    // x (T, bm, d): boxes of box_rows rows x 64 d, zero past d and bm; w
    // (E, d, f): boxes of 64 d x 64 f, zero past d and f within the expert
    const int rc = encode_pair(&m.a, &m.w, x, w, dtype, T, bm, d, box_rows,
                               E, d, f);
    if (rc != 0) return rc;
  }
  Params P{};
  P.out = out; P.a = x; P.b = w;
  P.order = static_cast<const int*>(order);
  P.tile_expert = static_cast<const int*>(tile_expert);
  P.bounds = static_cast<const int*>(bounds);
  P.n_span = n_span; P.T = T; P.bm = bm;
  P.max_run = (bm <= BM && (ld || bm % 8 == 0)) ? min(BM / bm, MAX_RUN) : 1;
  P.K = d; P.N = f;
  P.wa = copy_bytes(x, d); P.wb = copy_bytes(w, f);
  return launch<FWD>(m, P, box_rows, p, dtype, ld, stream);
}

// dX (E, R, d) = dy (E, R, f) w[e]^T with w (E, d, f) read in place, on
// min(p, units) persistent CTAs over the expert-major units; ld as above
extern "C" int gmm_any_dx_launch(const void* dy, const void* w, void* dx,
                                 int E, int R, int d, int f, int p, int dtype,
                                 int ld, void* stream) {
  if (p <= 0 || E <= 0 || R < 0 || d <= 0 || f < 0 ||
      (dtype != BF16 && dtype != F16) ||
      (!ld && (R == 0 || !tma_rows(d, f, dy, w))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int box_rows = R < BM ? R : BM;
  Maps m;
  if (!ld) {
    // dy (E, R, f): boxes of box_rows rows x 64 f, zero past R and f; w
    // (E, d, f): boxes of 64 f x 64 d, zero past f and d within the expert
    const int rc = encode_pair(&m.a, &m.w, dy, w, dtype, E, R, f, box_rows,
                               E, d, f);
    if (rc != 0) return rc;
  }
  Params P{};
  P.out = dx; P.a = dy; P.b = w;
  P.E = E; P.R = R; P.K = f; P.N = d;
  P.wa = copy_bytes(dy, f); P.wb = copy_bytes(w, f);
  const int units = E * ((d + BN - 1) / BN) * ((R + BM - 1) / BM);
  return launch<DX>(m, P, box_rows, p < units ? p : units, dtype, ld,
                    stream);
}

// dW (E, d, f) = x (E, R, d)^T dy (E, R, f) per expert, the R rows summed
// in ascending order, on min(p, units) persistent CTAs; ld as above
extern "C" int gmm_any_dw_launch(const void* x, const void* dy, void* dw,
                                 int E, int R, int d, int f, int p, int dtype,
                                 int ld, void* stream) {
  if (p <= 0 || E <= 0 || R < 0 || d <= 0 || f <= 0 ||
      (dtype != BF16 && dtype != F16) ||
      (!ld && (R == 0 || !tma_rows(d, f, x, dy) ||
               reinterpret_cast<uintptr_t>(dw) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Maps m;
  if (!ld) {
    // x (E, R, d) and dy (E, R, f): boxes of 64 rows x 64 columns, zero
    // past R, d and f within the expert; dw (E, d, f): boxes of 64 rows x
    // 64 columns, stores clipped at d and f
    using u64 = cuuint64_t;
    const u64 od[3] = {(u64)f, (u64)d, (u64)E};
    const u64 os[2] = {(u64)f * 2, (u64)d * f * 2};
    const cuuint32_t ob[3] = {64, 64, 1};
    int rc = encode_pair(&m.a, &m.w, x, dy, dtype, E, R, d, 64, E, R, f);
    if (rc == 0) rc = encode_tiled(&m.o, dw, 3, od, os, ob, dtype);
    if (rc != 0) return rc;
  }
  Params P{};
  P.out = dw; P.a = x; P.b = dy;
  P.E = E; P.R = R; P.M = d; P.K = R; P.N = f;
  P.wa = copy_bytes(x, d); P.wb = copy_bytes(dy, f);
  const int units = E * ((d + BM - 1) / BM) * ((f + BN - 1) / BN);
  return launch<DW>(m, P, 64, p < units ? p : units, dtype, ld, stream);
}

extern "C" const char* gmm_any_error_string(int code) {
  return error_string(code);
}
