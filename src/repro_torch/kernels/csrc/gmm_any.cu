// The grouped expert-tile matmul and its dX at bf16 and fp16 off gmm.cu's
// blocks, for Hopper (sm_90a): TMA + wgmma on the tensor cores.
//
// Replaces: _gmm_kernel in src/repro/kernels/grouped_matmul/grouped_matmul.py
// (entry grouped_matmul_tiles) wherever gmm.cu cannot take a 2-byte call:
// bm not a multiple of 128 (the MoE demo's block_rows 8, any small tile), f
// not a multiple of 128, d not a multiple of 32, and every fp16 call.  The
// backward's dX = dY W^T (no Pallas kernel: the reference differentiates
// its einsums) likewise where gmm_dx cannot take it.  What it needs: rows
// that TMA can describe, i.e. d and f multiples of 8 (16-byte row strides)
// and 16-byte aligned bases; everything else runs gmm_simt.cu.
//
// What bounds it on an H100: bytes.  At qwen3-moe's width in 8-row tiles
// (128 experts x 64 rows, d 2048, f 768) a call does 26 GFLOP over 403 MB of
// weights: 64 operations per byte, a fifth of the card's ~295, so the time
// is the weights' time.  gmm_simt read an expert's weights once per tile
// (8 times at 8-row tiles), on the CUDA cores.
//
// Design (gmm.cu's producer / two-consumer shape, one template for both
// products, T = __nv_bfloat16 or __half with its own wgmma type):
//   * Forward, persistent over the plan: CTA w of p walks steps
//     [bounds[w], bounds[w+1]) of `order`, then the dead steps n_span + w,
//     n_span + w + p, ..., so KernelTilePlan.shares() describes what ran.
//     A unit stacks the run of consecutive steps in that walk whose tiles
//     have one expert, up to 128 rows (128 / bm tiles when bm is a multiple
//     of 8; one tile otherwise), and runs every 256-column block of the
//     expert's weights over it: the weights are read once per run, not once
//     per tile.  Each tile's box (bm rows x 64 d) lands at row j bm of the
//     stage, on whole 8-row swizzle atoms (1024 bytes) when bm % 8 == 0.
//     A tile of more than 128 rows is cut into 128-row blocks, the block
//     innermost, so its column panel is read again while it is in L2.
//   * dX needs no plan: units (expert, 256-column n block of d, 128-row m
//     block of R), m innermost, dealt round-robin over min(p, units) CTAs,
//     gmm_dx's raster; w (E, d, f) is read in place as a K-major B.
//   * Loads past R, d or f read zeros: x is mapped as (T, bm, d), dY as
//     (E, R, f) and w as (E, d, f), so a box that runs past an edge is
//     zero-filled within its tile or expert, never the next one's rows.
//     The last column block loads only the 64-column boxes it needs and
//     runs the narrowest of n64 / n128 / n256 that covers them.
//   * One producer thread keeps a ring of 4 stages full (phase bits carry
//     across units); consumer warpgroup c issues wgmma.m64nNk16 for rows
//     64 c .. 64 c + 63 of the unit, or, when the unit has no row there,
//     waits for each stage and hands it back.
//   * Stores are clipped at the edges: each thread writes its accumulator
//     pairs straight from registers, two 2-byte values a 32-bit store,
//     rows past the unit's and columns past f (or d) skipped.
//   * No split-k, no atomics: every output element is the same wgmma
//     sequence over the same k blocks whatever CTA, unit or row position
//     computes it, so outputs are bit-identical for every schedule and p.

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
constexpr int SMEM_A = 0;
constexpr int SMEM_B = SMEM_A + STAGES * A_BYTES;
constexpr int SMEM_BAR = SMEM_B + STAGES * B_BYTES;
constexpr int SMEM_BYTES = SMEM_BAR + 2 * STAGES * 8 + 1024;  // + alignment

enum Mode { FWD = 0, DX = 1 };
enum DType { BF16 = 1, F16 = 2 };        // simt::DType's codes

// wgmma.m64nNk16 with fp32 accumulators, A (K-major) and B from shared
// memory, the operand type given as a PTX type name; trans-b TB
#define GMM_ANY_WGMMA_N64(TY)                                                 \
  asm volatile(                                                               \
      "{\n.reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %34, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                      \
      " %8, %9, %10, %11, %12, %13, %14, %15,"                                \
      " %16, %17, %18, %19, %20, %21, %22, %23,"                              \
      " %24, %25, %26, %27, %28, %29, %30, %31},"                             \
      " %32, %33, p, 1, 1, 0, %35;\n}\n"                                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31])                                              \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB))


#define GMM_ANY_WGMMA_N128(TY)                                                \
  asm volatile(                                                               \
      "{\n.reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %66, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "            \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                      \
      " %8, %9, %10, %11, %12, %13, %14, %15,"                                \
      " %16, %17, %18, %19, %20, %21, %22, %23,"                              \
      " %24, %25, %26, %27, %28, %29, %30, %31,"                              \
      " %32, %33, %34, %35, %36, %37, %38, %39,"                              \
      " %40, %41, %42, %43, %44, %45, %46, %47,"                              \
      " %48, %49, %50, %51, %52, %53, %54, %55,"                              \
      " %56, %57, %58, %59, %60, %61, %62, %63},"                             \
      " %64, %65, p, 1, 1, 0, %67;\n}\n"                                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB))


#define GMM_ANY_WGMMA_N256(TY)                                                \
  asm volatile(                                                               \
      "{\n.reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %130, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "            \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                      \
      " %8, %9, %10, %11, %12, %13, %14, %15,"                                \
      " %16, %17, %18, %19, %20, %21, %22, %23,"                              \
      " %24, %25, %26, %27, %28, %29, %30, %31,"                              \
      " %32, %33, %34, %35, %36, %37, %38, %39,"                              \
      " %40, %41, %42, %43, %44, %45, %46, %47,"                              \
      " %48, %49, %50, %51, %52, %53, %54, %55,"                              \
      " %56, %57, %58, %59, %60, %61, %62, %63,"                              \
      " %64, %65, %66, %67, %68, %69, %70, %71,"                              \
      " %72, %73, %74, %75, %76, %77, %78, %79,"                              \
      " %80, %81, %82, %83, %84, %85, %86, %87,"                              \
      " %88, %89, %90, %91, %92, %93, %94, %95,"                              \
      " %96, %97, %98, %99, %100, %101, %102, %103,"                          \
      " %104, %105, %106, %107, %108, %109, %110, %111,"                      \
      " %112, %113, %114, %115, %116, %117, %118, %119,"                      \
      " %120, %121, %122, %123, %124, %125, %126, %127},"                     \
      " %128, %129, p, 1, 1, 0, %131;\n}\n"                                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), \
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), \
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), \
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), \
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), \
        "+f"(d[126]), "+f"(d[127])                                            \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB))

template <typename T, int N, int TB>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  constexpr bool H = std::is_same<T, __half>::value;
  if constexpr (N == 256) {
    if constexpr (H) GMM_ANY_WGMMA_N256("f16"); else GMM_ANY_WGMMA_N256("bf16");
  } else if constexpr (N == 128) {
    if constexpr (H) GMM_ANY_WGMMA_N128("f16"); else GMM_ANY_WGMMA_N128("bf16");
  } else {
    if constexpr (H) GMM_ANY_WGMMA_N64("f16"); else GMM_ANY_WGMMA_N64("bf16");
  }
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}

struct Params {
  void* out;
  const int* order;         // fwd: (T,) step -> tile slot
  const int* tile_expert;   // fwd: (T,) tile slot -> expert
  const int* bounds;        // fwd: (p + 1,) live steps of each CTA
  int n_span, T, bm, max_run;
  int E, R;                 // dX: experts, rows an expert
  int K, N;                 // the reduction (fwd d, dX f), the output width
};

// the step sequence of CTA w: its live steps, then its dead ones
struct Walk {
  int live0 = 0, nlive = 0, nsteps = 0, p = 1, w = 0, n_span = 0;
  __device__ explicit Walk(const Params& P, bool fwd) {
    if (!fwd) return;   // dX has no plan (bounds is null)
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
// mb), rows `rows` of them valid; dX: expert e's m block mb.
struct Unit {
  int it, nrun, mb, e, col, rows;
};

// One unit's k loop on the consumer side (gmm.cu's mainloop): wait for each
// stage, issue its four 16-deep wgmmas, hand the previous stage back once
// its group retired.  A is K-major; B is MN-major (TB 1, the forward's w) or
// K-major (TB 0, dX's w read in place).
template <typename T, int N, int TB>
__device__ __forceinline__ void mainloop(float* acc, unsigned char* smem,
                                         uint64_t* full, uint64_t* empty,
                                         int c, int nk, int& g, int lane) {
  constexpr int BSTEP = TB ? 128 : 2;
  for (int kb = 0; kb < nk; ++kb) {
    const int s = g % STAGES;
    mbar_wait(&full[s], (g / STAGES) & 1);
    unsigned char* a = smem + SMEM_A + s * A_BYTES + c * 64 * 128;
    unsigned char* b = smem + SMEM_B + s * B_BYTES;
    const uint64_t da = smem_desc(a, 16, 1024);
    const uint64_t db = TB ? smem_desc(b, B_BOX, 1024) : smem_desc(b, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss<T, N, TB>(acc, da + 2 * kk, db + BSTEP * kk, kb | kk);
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

// the output row of unit row rr (0..127), or nullptr past the unit's rows
template <int MODE, typename T>
__device__ __forceinline__ T* out_row(const Params& P, const Walk& wk,
                                      const Unit& u, int rr) {
  T* out = static_cast<T*>(P.out);
  if (rr >= u.rows) return nullptr;
  long long row;
  if constexpr (MODE == FWD) {
    const int bm = P.bm;
    const int j = P.max_run > 1 ? rr / bm : 0;
    const int i = P.max_run > 1 ? rr % bm : u.mb * BM + rr;
    row = static_cast<long long>(P.order[wk.step(u.it + j)]) * bm + i;
  } else {
    row = static_cast<long long>(u.e) * P.R + u.mb * BM + rr;
  }
  return out + row * P.N + u.col;
}

// the accumulators of consumer c's 64 rows out to memory: value pairs
// (v, v + 1) of row r and (v + 2, v + 3) of row r + 8, columns 8 (v / 4) +
// 2 (lane % 4) + {0, 1}, clipped at the unit's rows and at N
template <int MODE, typename T, int N>
__device__ __forceinline__ void store(const float* acc, const Params& P,
                                      const Walk& wk, const Unit& u, int c,
                                      int tq) {
  const int lane = tq % 32;
  const int r = 64 * c + 16 * (tq / 32) + lane / 4;
  T* p0 = out_row<MODE, T>(P, wk, u, r);
  T* p1 = out_row<MODE, T>(P, wk, u, r + 8);
  const int ncol = P.N - u.col;
#pragma unroll
  for (int q = 0; q < N / 8; ++q) {
    const int col = 8 * q + 2 * (lane % 4);
    if (col >= ncol) break;
    if (p0) *reinterpret_cast<uint32_t*>(p0 + col) =
        pack2<T>(acc[4 * q], acc[4 * q + 1]);
    if (p1) *reinterpret_cast<uint32_t*>(p1 + col) =
        pack2<T>(acc[4 * q + 2], acc[4 * q + 3]);
  }
}

template <int MODE, typename T>
__device__ __forceinline__ void consume(const Params& P, const Walk& wk,
                                        const Unit& u, float* acc,
                                        unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, int c, int nk,
                                        int& g, int tq) {
  constexpr int TB = MODE == FWD ? 1 : 0;
  const int lane = tq % 32;
  if (u.rows <= 64 * c) {
    idle_loop(full, empty, nk, g, lane);
    return;
  }
  const int ncol = P.N - u.col;
  if (ncol > 128) {
    mainloop<T, 256, TB>(acc, smem, full, empty, c, nk, g, lane);
    store<MODE, T, 256>(acc, P, wk, u, c, tq);
  } else if (ncol > 64) {
    mainloop<T, 128, TB>(acc, smem, full, empty, c, nk, g, lane);
    store<MODE, T, 128>(acc, P, wk, u, c, tq);
  } else {
    mainloop<T, 64, TB>(acc, smem, full, empty, c, nk, g, lane);
    store<MODE, T, 64>(acc, P, wk, u, c, tq);
  }
}

// the stages of one unit, filled by the producer thread
template <int MODE>
__device__ __forceinline__ void produce(const Params& P, const Walk& wk,
                                        const Unit& u, const CUtensorMap* amap,
                                        const CUtensorMap* wmap,
                                        unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, int nk, int box_rows,
                                        int& g) {
  const int nbox = min(BN, P.N - u.col + 63) / 64;
  const uint32_t bytes = u.nrun * box_rows * 128 + nbox * B_BOX;
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
    } else {
      tma_load_3d(a, amap, &full[s], kb * BK, u.mb * BM, u.e);
      for (int j = 0; j < nbox; ++j)
        tma_load_3d(b + j * B_BOX, wmap, &full[s], kb * BK, u.col + 64 * j,
                    u.e);
    }
  }
}

// The forward (MODE FWD): x (T, bm, d) as amap, w (E, d, f); dX (MODE DX):
// dY (E, R, f) as amap, w (E, d, f) read K-major.  See the header.
template <int MODE, typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
gmm_any_kernel(const __grid_constant__ CUtensorMap amap,
               const __grid_constant__ CUtensorMap wmap, const Params P,
               int box_rows) {
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

  const int nk = (P.K + BK - 1) / BK;
  const int nnb = (P.N + BN - 1) / BN;
  // fwd: walk positions, runs, then column blocks and 128-row blocks;
  // dX: units u = w, w + p, ... of (expert, n block, m block)
  const Walk wk(P, MODE == FWD);
  const int nmb = MODE == FWD ? (P.bm + BM - 1) / BM : (P.R + BM - 1) / BM;
  const int units = MODE == FWD ? 0 : P.E * nnb * nmb;

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    reg_dealloc<40>();
    if (tid == 0) {
      int g = 0;
      if constexpr (MODE == FWD) {
        for (int it = 0; it < wk.nsteps;) {
          Unit u;
          u.it = it;
          u.e = P.tile_expert[P.order[wk.step(it)]];
          u.nrun = run_length(P, wk, it, u.e);
          for (int nb = 0; nb < nnb; ++nb)
            for (int mb = 0; mb < nmb; ++mb) {
              u.col = nb * BN;
              u.mb = mb;
              produce<FWD>(P, wk, u, &amap, &wmap, smem, full, empty, nk,
                           box_rows, g);
            }
          it += u.nrun;
        }
      } else {
        for (int v = blockIdx.x; v < units; v += gridDim.x) {
          Unit u;
          u.it = 0;
          u.nrun = 1;
          u.e = v / (nnb * nmb);
          u.col = ((v / nmb) % nnb) * BN;
          u.mb = v % nmb;
          produce<DX>(P, wk, u, &amap, &wmap, smem, full, empty, nk,
                      box_rows, g);
        }
      }
    }
  } else {
    // ---- consumers: rows 64 c .. 64 c + 63 of every unit ----
    reg_alloc<232>();
    const int c = wg - 1;
    const int tq = tid % 128;
    float acc[BN / 2];
    int g = 0;
    if constexpr (MODE == FWD) {
      for (int it = 0; it < wk.nsteps;) {
        Unit u;
        u.it = it;
        u.e = P.tile_expert[P.order[wk.step(it)]];
        u.nrun = run_length(P, wk, it, u.e);
        for (int nb = 0; nb < nnb; ++nb)
          for (int mb = 0; mb < nmb; ++mb) {
            u.col = nb * BN;
            u.mb = mb;
            u.rows = P.max_run > 1 ? u.nrun * P.bm : min(BM, P.bm - mb * BM);
            consume<FWD, T>(P, wk, u, acc, smem, full, empty, c, nk, g, tq);
          }
        it += u.nrun;
      }
    } else {
      for (int v = blockIdx.x; v < units; v += gridDim.x) {
        Unit u;
        u.it = 0;
        u.nrun = 1;
        u.e = v / (nnb * nmb);
        u.col = ((v / nmb) % nnb) * BN;
        u.mb = v % nmb;
        u.rows = min(BM, P.R - u.mb * BM);
        consume<DX, T>(P, wk, u, acc, smem, full, empty, c, nk, g, tq);
      }
    }
  }
}

// a 2-byte tensor map of rank 3 (sizes innermost first, byte strides of
// dims 1 and 2), SWIZZLE_128B boxes, zero fill outside the tensor
int encode(CUtensorMap* map, const void* base, int dtype,
           const cuuint64_t* dims, const cuuint64_t* strides,
           const cuuint32_t* box) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return NO_ENCODE_ERROR;
  bind_context();
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = fn(map, dtype == F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  3, const_cast<void*>(base), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR_BASE + static_cast<int>(r);
}

template <int MODE, typename T>
int launch_t(const CUtensorMap& amap, const CUtensorMap& wmap,
             const Params& P, int box_rows, int grid, void* stream) {
  auto kernel = gmm_any_kernel<MODE, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      amap, wmap, P, box_rows);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch(const CUtensorMap& amap, const CUtensorMap& wmap, const Params& P,
           int box_rows, int grid, int dtype, void* stream) {
  if (grid <= 0) return 0;
  return dtype == F16
             ? launch_t<MODE, __half>(amap, wmap, P, box_rows, grid, stream)
             : launch_t<MODE, __nv_bfloat16>(amap, wmap, P, box_rows, grid,
                                             stream);
}

}  // namespace

// x (T, bm, d), w (E, d, f) -> out (T, bm, f): each tile times its
// expert's w, on p persistent CTAs walking the plan as gmm_launch does; d
// and f multiples of 8, every base 16-byte aligned
extern "C" int gmm_any_launch(const void* x, const void* w, void* out,
                              const void* order, const void* tile_expert,
                              const void* bounds, int p, int n_span, int T,
                              int bm, int d, int f, int E, int dtype,
                              void* stream) {
  if (p <= 0 || T < 0 || E <= 0 || bm <= 0 || d <= 0 || d % 8 != 0 ||
      f <= 0 || f % 8 != 0 || n_span < 0 || n_span > T ||
      (dtype != BF16 && dtype != F16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  using u64 = cuuint64_t;
  const int box_rows = bm < BM ? bm : BM;
  CUtensorMap xmap, wmap;
  // x (T, bm, d): boxes of box_rows rows x 64 d, zero past d and bm
  const u64 xd[3] = {(u64)d, (u64)bm, (u64)T};
  const u64 xs[2] = {(u64)d * 2, (u64)bm * d * 2};
  const cuuint32_t xb[3] = {BK, (cuuint32_t)box_rows, 1};
  // w (E, d, f): boxes of 64 d x 64 f, zero past d and f within the expert
  const u64 wd[3] = {(u64)f, (u64)d, (u64)E};
  const u64 ws[2] = {(u64)f * 2, (u64)d * f * 2};
  const cuuint32_t wb[3] = {64, 64, 1};
  int rc = encode(&xmap, x, dtype, xd, xs, xb);
  if (rc == 0) rc = encode(&wmap, w, dtype, wd, ws, wb);
  if (rc != 0) return rc;
  Params P{};
  P.out = out;
  P.order = static_cast<const int*>(order);
  P.tile_expert = static_cast<const int*>(tile_expert);
  P.bounds = static_cast<const int*>(bounds);
  P.n_span = n_span; P.T = T; P.bm = bm;
  P.max_run = (bm <= BM && bm % 8 == 0) ? min(BM / bm, MAX_RUN) : 1;
  P.K = d; P.N = f;
  return launch<FWD>(xmap, wmap, P, box_rows, p, dtype, stream);
}

// dX (E, R, d) = dy (E, R, f) w[e]^T with w (E, d, f) read in place, on
// min(p, units) persistent CTAs over the expert-major units
extern "C" int gmm_any_dx_launch(const void* dy, const void* w, void* dx,
                                 int E, int R, int d, int f, int p, int dtype,
                                 void* stream) {
  if (p <= 0 || E <= 0 || R <= 0 || d <= 0 || d % 8 != 0 || f <= 0 ||
      f % 8 != 0 || (dtype != BF16 && dtype != F16))
    return static_cast<int>(cudaErrorInvalidValue);
  using u64 = cuuint64_t;
  const int box_rows = R < BM ? R : BM;
  CUtensorMap ymap, wmap;
  // dy (E, R, f): boxes of box_rows rows x 64 f, zero past R and f
  const u64 yd[3] = {(u64)f, (u64)R, (u64)E};
  const u64 ys[2] = {(u64)f * 2, (u64)R * f * 2};
  const cuuint32_t yb[3] = {BK, (cuuint32_t)box_rows, 1};
  // w (E, d, f): boxes of 64 f x 64 d, zero past f and d within the expert
  const u64 wd[3] = {(u64)f, (u64)d, (u64)E};
  const u64 ws[2] = {(u64)f * 2, (u64)d * f * 2};
  const cuuint32_t wb[3] = {64, 64, 1};
  int rc = encode(&ymap, dy, dtype, yd, ys, yb);
  if (rc == 0) rc = encode(&wmap, w, dtype, wd, ws, wb);
  if (rc != 0) return rc;
  Params P{};
  P.out = dx;
  P.E = E; P.R = R; P.K = f; P.N = d;
  const int units = E * ((d + BN - 1) / BN) * ((R + BM - 1) / BM);
  return launch<DX>(ymap, wmap, P, box_rows, p < units ? p : units, dtype,
                    stream);
}

extern "C" const char* gmm_any_error_string(int code) {
  return error_string(code);
}
