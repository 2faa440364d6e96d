// Grouped expert-tile matmul with a DLS-planned work list, for Hopper (sm_90a).
//
// Replaces: _gmm_kernel in src/repro/kernels/grouped_matmul/grouped_matmul.py
// (launched by grouped_matmul_tiles through one pl.pallas_call over a 1-D
// grid of row tiles, each multiplied by its expert's (d, f) weight block).
//
// What bounds it on an H100: at the main path's shapes (128 experts,
// capacity 512, 128-row tiles, wi (2048, 768) and wo (768, 2048)) the
// function does 2 T bm d f = 206 GFLOP per matmul over 771 MB of x, w and
// out (every tile, live or dead, as the TPU kernel's CostEstimate counts
// it): about 270 operations per byte, just under the card's ~295, so bytes
// bound it by a hair and the tensor cores, which only wgmma drives at their
// rate, must run near their peak as well.  In practice the weights
// dominate: a tile multiplies its expert's whole (d, f) block, 3 MB, and
// the tiles of one expert run at different times on different CTAs (the
// plan decides which and when), so each tile reads the block again from
// device memory; with the weights resident in L2 the same kernel runs at
// the rate of torch.bmm.
//
// Design (TMA + wgmma + warp specialisation):
//   * Persistent: the grid has p CTAs, one per plan worker.  CTA w first
//     walks its live share of the plan, steps [bounds[w], bounds[w+1]) of
//     `order`, in order.  The steps after n_span (the dead, all-padding
//     tiles that balance/moe.plan_tiles appends after the live ones) are
//     dealt round-robin: CTA w takes n_span + w, n_span + w + p, ...  They
//     are computed all the same, as the TPU grid computes them.  Step i
//     reads x tile order[i] and writes output tile order[i] in place, which
//     gives the reference's gather / inverse permutation without copies.
//   * A work unit is (step, 128-row block of the tile, output column block):
//     128 x 256, or 128 x 128 for the last block when f % 256 == 128.
//   * Three warpgroups.  One thread of warpgroup 0 (the producer, registers
//     cut to 40 by setmaxnreg) walks the same unit sequence as the
//     consumers and keeps a ring of 4 stages full with TMA: the x box
//     (128 rows x 64 d) and the w boxes (64 d x 64 f each), completion
//     reported to the stage's `full` mbarrier.  Its phase bits carry on
//     across units, so the loads of unit u + 1 are in flight while the
//     consumers run unit u's epilogue.
//   * Warpgroups 1 and 2 (the consumers, 232 registers) own rows 0-63 and
//     64-127 of the unit and issue wgmma.m64n256k16 (or n128), A and B from
//     shared memory, fp32 accumulators in registers.  x is K-major; w is
//     (E, d, f) with f contiguous, i.e. MN-major, read through the
//     descriptor's transpose bit.  A stage is handed back (`empty`
//     mbarrier, one arrival per consumer warp) as soon as the wgmma group
//     after it has been issued and the one reading it has retired.
//   * The d tail: x is mapped as (T, bm, d) and w as (E, d, f), so a 64-deep
//     box that runs past d is zero-filled within the tile and within the
//     expert (a 2-D map over (E d, f) would read the next expert's rows).
//   * Epilogue: fp32 -> bf16 in registers, written 64 columns at a time
//     into one of two swizzled 64 x 64 staging boxes per consumer, each
//     chunk sent out by a TMA store; a box is rewritten only after the
//     store before last has read it, so one store stays in flight.
//   * Bit-identity across schedules: every output block is computed by the
//     same instruction sequence (the same k order, no split-k, no atomics)
//     whatever CTA runs it, so outputs are bit-identical for every schedule
//     and every p.
//
// The backward's dX = dY W^T (training the ragged MoE) is gmm_dx_kernel,
// which needs no plan (the reference differentiates its einsums), so it
// takes the raster that suits the weights.  Each output block is computed
// as the forward's kernel computes one (BK 64, BN 256 or 128 at the tail, 4
// stages, the same k order and epilogue, no split-k, no atomics), with w
// (E, d, f) read in place: the stage loads w's boxes (64 k x 64 n) at
// (k, n) = (f, d) coordinates, which lay a 256-row n block out row after
// row as wgmma wants a K-major B (trans-b 0), zero-filled past f within the
// expert.  Work units are (expert, 256-column n block of d, 128-row m
// tile), numbered with the m tile innermost, then the n block, then the
// expert, and CTA w of p runs units w, w + p, ... as gmm_dw_kernel does.
// The <= 5 m tiles of one (expert, n block) then run at the same time on
// neighbouring CTAs and read one weight panel (f x 256 bf16: 384 KB for wi
// and wg, 1 MB for wo) from device memory once and from L2 after that; the
// live set, ~26 panels and their dY tiles, stays well inside the 50 MB L2.
// (Walking an expert's tiles in the forward's identity order instead, one
// span per CTA, put ~132 experts' whole weights in flight at once, ~400 MB
// a projection, so every tile streamed its 3 MB again from memory.)

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                  // rows of a unit
constexpr int BK = 64;                   // d depth of a stage (128 bytes)
constexpr int BN = 256;                  // columns of a unit (128 at the tail)
constexpr int STAGES = 4;
constexpr int NTHREADS = 384;            // producer + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int A_BYTES = BM * BK * 2;     // x box: 128 rows x 64 d
constexpr int B_BOX = BK * 64 * 2;       // w box: 64 d x 64 f
constexpr int B_BYTES = (BN / 64) * B_BOX;
constexpr int C_BOX = 64 * 64 * 2;       // out box: 64 rows x 64 f
constexpr int C_BYTES = 2 * C_BOX;       // staging of one consumer: 2 boxes
constexpr int SMEM_A = 0;
constexpr int SMEM_B = SMEM_A + STAGES * A_BYTES;
constexpr int SMEM_C = SMEM_B + STAGES * B_BYTES;
constexpr int SMEM_BAR = SMEM_C + 2 * C_BYTES;
constexpr int SMEM_BYTES = SMEM_BAR + 2 * STAGES * 8 + 1024;  // + alignment

struct GmmParams {
  const int* order;         // (T,) step -> tile slot
  const int* tile_expert;   // (T,) tile slot -> expert
  const int* bounds;        // (p + 1,) live steps of each CTA
  int n_span, T, bm, k, n;  // k: the reduction, n: the output width
};

// the unit sequence of CTA w: its live steps, then its dead ones
struct Walk {
  int live0, nlive, nsteps, p, w, n_span;
  __device__ Walk(const GmmParams& P) {
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

// One unit's k loop on the consumer side: wait for each stage, issue its
// four 16-deep wgmmas, hand the previous stage back once its group retired.
// An operand stage is K-major (trans 0: the next 16-deep step is 32 bytes on
// inside the 128-byte row) or MN-major (trans 1: 16 rows = 2048 bytes on).
// gmm: A (x) K-major, B (w (E, K, N)) MN-major; gmm_dx: A (dY) and B (w
// (E, N, K)) both K-major; gmm_dw: A (X^T) and B (dY) both MN-major.
// Consumer c's A rows start 8 KB into the stage either way: 64 of the x (or
// dY) box's 128 rows, or the second 64-row m box of X.
template <int N, int TA, int TB>
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
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (N == 256)
        wgmma_m64n256k16_ss<TB, TA>(acc, da + ASTEP * kk, db + BSTEP * kk,
                                    kb | kk);
      else
        wgmma_m64n128k16_ss<TB, TA>(acc, da + ASTEP * kk, db + BSTEP * kk,
                                    kb | kk);
    }
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

// fp32 -> bf16 in 64-column chunks through the consumer's two staging boxes
// (64 x 64, SWIZZLE_128B), one TMA store per chunk.  Chunk q of the
// consumer's whole run uses box q % 2, which the store of chunk q - 2 must
// have finished reading: the wait keeps one store in flight.
template <int N>
__device__ __forceinline__ void epilogue(const float* acc, unsigned char* cst,
                                         const CUtensorMap* omap, int t,
                                         int row, int col, int c, int tq,
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
      *reinterpret_cast<uint32_t*>(p + r * 128) = pack_bf16(acc[v], acc[v + 1]);
      *reinterpret_cast<uint32_t*>(p + (r + 8) * 128) =
          pack_bf16(acc[v + 2], acc[v + 3]);
    }
    fence_proxy_async();
    named_bar_sync(1 + c, 128);
    if (tq == 0) {
      tma_store_3d(omap, box, col + 64 * q, row, t);
      bulk_commit();
    }
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
gmm_kernel(const __grid_constant__ CUtensorMap xmap,
           const __grid_constant__ CUtensorMap wmap,
           const __grid_constant__ CUtensorMap omap, const GmmParams P) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SMEM_BAR);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const Walk walk(P);
  const int nmb = P.bm / BM;
  const int nnb = (P.n + BN - 1) / BN;
  const int nk = (P.k + BK - 1) / BK;

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    reg_dealloc<40>();
    if (tid == 0) {
      int g = 0;
      for (int it = 0; it < walk.nsteps; ++it) {
        const int t = P.order[walk.step(it)];
        const int e = P.tile_expert[t];
        for (int mb = 0; mb < nmb; ++mb) {
          for (int nbi = 0; nbi < nnb; ++nbi) {
            const int col = nbi * BN;
            const int nbox = min(BN, P.n - col) / 64;
            for (int kb = 0; kb < nk; ++kb) {
              const int s = g % STAGES;
              mbar_wait(&empty[s], ((g / STAGES) & 1) ^ 1);
              mbar_expect_tx(&full[s], A_BYTES + nbox * B_BOX);
              tma_load_3d(smem + SMEM_A + s * A_BYTES, &xmap, &full[s],
                          kb * BK, mb * BM, t);
              for (int j = 0; j < nbox; ++j)
                tma_load_3d(smem + SMEM_B + s * B_BYTES + j * B_BOX, &wmap,
                            &full[s], col + 64 * j, kb * BK, e);
              ++g;
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: rows 64 c .. 64 c + 63 of every unit ----
    reg_alloc<232>();
    const int c = wg - 1;
    const int tq = tid % 128;
    unsigned char* cst = smem + SMEM_C + c * C_BYTES;
    float acc[BN / 2];
    int g = 0;
    int qc = 0;
    for (int it = 0; it < walk.nsteps; ++it) {
      const int t = P.order[walk.step(it)];
      for (int mb = 0; mb < nmb; ++mb) {
        for (int nbi = 0; nbi < nnb; ++nbi) {
          const int col = nbi * BN;
          const int row = mb * BM + 64 * c;
          if (P.n - col >= 256) {
            mainloop<256, 0, 1>(acc, smem, full, empty, c, nk, g, tq % 32);
            epilogue<256>(acc, cst, &omap, t, row, col, c, tq, qc);
          } else {
            mainloop<128, 0, 1>(acc, smem, full, empty, c, nk, g, tq % 32);
            epilogue<128>(acc, cst, &omap, t, row, col, c, tq, qc);
          }
        }
      }
    }
    if (tq == 0) bulk_wait();
  }
}

// dX[e] = dY[e] w[e]^T: dY (E, R, f) as T = E R / 128 tiles (T, 128, f),
// w (E, d, f) -> dX (T, 128, d).  A unit is (expert, n block, m tile), the
// m tile innermost; CTA w of p runs units w, w + p, ... (see the header).
__global__ void __launch_bounds__(NTHREADS, 1)
gmm_dx_kernel(const __grid_constant__ CUtensorMap ymap,
              const __grid_constant__ CUtensorMap wmap,
              const __grid_constant__ CUtensorMap omap, int E, int nmt, int d,
              int f) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SMEM_BAR);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int nnb = (d + BN - 1) / BN;
  const int units = E * nnb * nmt;
  const int nk = (f + BK - 1) / BK;

  if (wg == 0) {
    reg_dealloc<40>();
    if (tid == 0) {
      int g = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int e = u / (nnb * nmt);
        const int col = ((u / nmt) % nnb) * BN;
        const int t = e * nmt + u % nmt;
        const int nbox = min(BN, d - col) / 64;
        for (int kb = 0; kb < nk; ++kb) {
          const int s = g % STAGES;
          mbar_wait(&empty[s], ((g / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], A_BYTES + nbox * B_BOX);
          tma_load_3d(smem + SMEM_A + s * A_BYTES, &ymap, &full[s], kb * BK,
                      0, t);
          for (int j = 0; j < nbox; ++j)
            tma_load_3d(smem + SMEM_B + s * B_BYTES + j * B_BOX, &wmap,
                        &full[s], kb * BK, col + 64 * j, e);
          ++g;
        }
      }
    }
  } else {
    reg_alloc<232>();
    const int c = wg - 1;
    const int tq = tid % 128;
    unsigned char* cst = smem + SMEM_C + c * C_BYTES;
    float acc[BN / 2];
    int g = 0;
    int qc = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int e = u / (nnb * nmt);
      const int col = ((u / nmt) % nnb) * BN;
      const int t = e * nmt + u % nmt;
      if (d - col >= 256) {
        mainloop<256, 0, 0>(acc, smem, full, empty, c, nk, g, tq % 32);
        epilogue<256>(acc, cst, &omap, t, 64 * c, col, c, tq, qc);
      } else {
        mainloop<128, 0, 0>(acc, smem, full, empty, c, nk, g, tq % 32);
        epilogue<128>(acc, cst, &omap, t, 64 * c, col, c, tq, qc);
      }
    }
    if (tq == 0) bulk_wait();
  }
}

// dW[e] = X[e]^T dY[e]: X (E, R, M), dY (E, R, N) -> dW (E, M, N).  A unit
// is (expert, 128-row m block, 256-column n block: 128 at the tail); CTA w
// of p runs units w, w + p, ...  The R rows are the reduction, 64 a stage,
// in ascending order; X arrives as two 64 m x 64 r boxes (consumer c reads
// box c, MN-major, trans-a = 1) and dY as the gmm forward's w (MN-major).
__global__ void __launch_bounds__(NTHREADS, 1)
gmm_dw_kernel(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap ymap,
              const __grid_constant__ CUtensorMap omap, int E, int R, int M,
              int N) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SMEM_BAR);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int nmb = M / BM;
  const int nnb = (N + BN - 1) / BN;
  const int units = E * nmb * nnb;
  const int nk = (R + BK - 1) / BK;

  if (wg == 0) {
    reg_dealloc<40>();
    if (tid == 0) {
      int g = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int e = u / (nmb * nnb);
        const int mb = (u / nnb) % nmb;
        const int col = (u % nnb) * BN;
        const int nbox = min(BN, N - col) / 64;
        for (int kb = 0; kb < nk; ++kb) {
          const int s = g % STAGES;
          mbar_wait(&empty[s], ((g / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], A_BYTES + nbox * B_BOX);
          for (int j = 0; j < 2; ++j)
            tma_load_3d(smem + SMEM_A + s * A_BYTES + j * 64 * 128, &xmap,
                        &full[s], mb * BM + 64 * j, kb * BK, e);
          for (int j = 0; j < nbox; ++j)
            tma_load_3d(smem + SMEM_B + s * B_BYTES + j * B_BOX, &ymap,
                        &full[s], col + 64 * j, kb * BK, e);
          ++g;
        }
      }
    }
  } else {
    reg_alloc<232>();
    const int c = wg - 1;
    const int tq = tid % 128;
    unsigned char* cst = smem + SMEM_C + c * C_BYTES;
    float acc[BN / 2];
    int g = 0;
    int qc = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int e = u / (nmb * nnb);
      const int row = ((u / nnb) % nmb) * BM + 64 * c;
      const int col = (u % nnb) * BN;
      if (N - col >= 256) {
        mainloop<256, 1, 1>(acc, smem, full, empty, c, nk, g, tq % 32);
        epilogue<256>(acc, cst, &omap, e, row, col, c, tq, qc);
      } else {
        mainloop<128, 1, 1>(acc, smem, full, empty, c, nk, g, tq % 32);
        epilogue<128>(acc, cst, &omap, e, row, col, c, tq, qc);
      }
    }
    if (tq == 0) bulk_wait();
  }
}

}  // namespace

// x (T, bm, d), w (E, d, f) -> out (T, bm, f): each tile times its
// expert's w
extern "C" int gmm_launch(const void* x, const void* w, void* out,
                          const void* order, const void* tile_expert,
                          const void* bounds, int p, int n_span, int T, int bm,
                          int d, int f, int E, void* stream) {
  if (p <= 0 || T <= 0 || E <= 0 || bm % BM != 0 || f % 128 != 0 ||
      d % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  using u64 = cuuint64_t;
  CUtensorMap xmap, wmap, omap;
  // x (T, bm, d): boxes of 128 rows x 64 d
  const u64 xd[3] = {(u64)d, (u64)bm, (u64)T};
  const u64 xs[2] = {(u64)d * 2, (u64)bm * d * 2};
  const cuuint32_t xb[3] = {BK, BM, 1};
  // w (E, d, f): boxes of 64 x 64, zero past d and f within the expert
  const u64 wd[3] = {(u64)f, (u64)d, (u64)E};
  const u64 ws[2] = {(u64)f * 2, (u64)d * f * 2};
  const cuuint32_t wb[3] = {64, 64, 1};
  // out (T, bm, f): boxes of 64 rows x 64 f
  const u64 od[3] = {(u64)f, (u64)bm, (u64)T};
  const u64 os[2] = {(u64)f * 2, (u64)bm * f * 2};
  const cuuint32_t ob[3] = {64, 64, 1};
  int rc = encode_tiled(&xmap, x, 3, xd, xs, xb, BF16);
  if (rc == 0) rc = encode_tiled(&wmap, w, 3, wd, ws, wb, BF16);
  if (rc == 0) rc = encode_tiled(&omap, out, 3, od, os, ob, BF16);
  if (rc != 0) return rc;
  GmmParams P;
  P.order = static_cast<const int*>(order);
  P.tile_expert = static_cast<const int*>(tile_expert);
  P.bounds = static_cast<const int*>(bounds);
  P.n_span = n_span; P.T = T; P.bm = bm; P.k = d; P.n = f;
  cudaError_t err = cudaFuncSetAttribute(
      gmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  gmm_kernel<<<p, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, omap, P);
  return static_cast<int>(cudaGetLastError());
}

// dX (E, R, d) = dy (E, R, f) w[e]^T with w (E, d, f) read in place, on
// p persistent CTAs over the expert-major units
extern "C" int gmm_dx_launch(const void* dy, const void* w, void* dx, int E,
                             int R, int d, int f, int p, void* stream) {
  if (p <= 0 || E <= 0 || R <= 0 || R % BM != 0 || d % 128 != 0 ||
      f % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  using u64 = cuuint64_t;
  const int nmt = R / BM;
  const u64 T = (u64)E * nmt;
  CUtensorMap ymap, wmap, omap;
  // dy as (T, 128, f): boxes of 128 rows x 64 f, zero past f
  const u64 yd[3] = {(u64)f, (u64)BM, T};
  const u64 ys[2] = {(u64)f * 2, (u64)BM * f * 2};
  const cuuint32_t yb[3] = {BK, BM, 1};
  // w (E, d, f): boxes of 64 f x 64 d, zero past f within the expert
  const u64 wd[3] = {(u64)f, (u64)d, (u64)E};
  const u64 ws[2] = {(u64)f * 2, (u64)d * f * 2};
  const cuuint32_t wb[3] = {64, 64, 1};
  // dx as (T, 128, d): boxes of 64 rows x 64 d
  const u64 od[3] = {(u64)d, (u64)BM, T};
  const u64 os[2] = {(u64)d * 2, (u64)BM * d * 2};
  const cuuint32_t ob[3] = {64, 64, 1};
  int rc = encode_tiled(&ymap, dy, 3, yd, ys, yb, BF16);
  if (rc == 0) rc = encode_tiled(&wmap, w, 3, wd, ws, wb, BF16);
  if (rc == 0) rc = encode_tiled(&omap, dx, 3, od, os, ob, BF16);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      gmm_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int units = E * ((d + BN - 1) / BN) * nmt;
  gmm_dx_kernel<<<p < units ? p : units, NTHREADS, SMEM_BYTES,
                  static_cast<cudaStream_t>(stream)>>>(ymap, wmap, omap, E,
                                                       nmt, d, f);
  return static_cast<int>(cudaGetLastError());
}

// dW (E, M, N) = x (E, R, M)^T dy (E, R, N) per expert, p persistent CTAs
extern "C" int gmm_dw_launch(const void* x, const void* dy, void* dw, int E,
                             int R, int M, int N, int p, void* stream) {
  if (p <= 0 || E <= 0 || R <= 0 || M % BM != 0 || N % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  using u64 = cuuint64_t;
  CUtensorMap xmap, ymap, omap;
  const cuuint32_t box[3] = {64, 64, 1};
  // x (E, R, M) and dy (E, R, N): boxes of 64 columns x 64 rows, zero past
  // R within the expert; dw (E, M, N): boxes of 64 rows x 64 columns
  const u64 xd[3] = {(u64)M, (u64)R, (u64)E};
  const u64 xs[2] = {(u64)M * 2, (u64)R * M * 2};
  const u64 yd[3] = {(u64)N, (u64)R, (u64)E};
  const u64 ys[2] = {(u64)N * 2, (u64)R * N * 2};
  const u64 od[3] = {(u64)N, (u64)M, (u64)E};
  const u64 os[2] = {(u64)N * 2, (u64)M * N * 2};
  int rc = encode_tiled(&xmap, x, 3, xd, xs, box, BF16);
  if (rc == 0) rc = encode_tiled(&ymap, dy, 3, yd, ys, box, BF16);
  if (rc == 0) rc = encode_tiled(&omap, dw, 3, od, os, box, BF16);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      gmm_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int units = E * (M / BM) * ((N + BN - 1) / BN);
  gmm_dw_kernel<<<p < units ? p : units, NTHREADS, SMEM_BYTES,
                  static_cast<cudaStream_t>(stream)>>>(xmap, ymap, omap, E, R,
                                                       M, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gmm_error_string(int code) {
  return error_string(code);
}
