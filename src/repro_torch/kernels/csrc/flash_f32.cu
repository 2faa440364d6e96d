// Flash-attention forward in fp32 on Hopper's tensor cores (sm_90a): TMA,
// wgmma .tf32 and a three-term TF32 split, with two entry points, dense
// (causal / sliding-window) and schedule-aware.
//
// Replaces: _flash_kernel (dense, entry flash_attention_bhsd) and
// _flash_sched_kernel (ragged KV in DLS plan order, entry
// flash_attention_sched_bhsd) in src/repro/kernels/flash_attention/
// flash_attention.py for fp32 calls at a head dim that is a multiple of 8
// up to 128 with strides and alignment TMA can describe (the configs' 64,
// 80 and 128), and dense calls at head dims 136-256 likewise (the configs'
// 256, on cluster pairs, below).  fp32 schedule-aware calls past 128 and
// shapes TMA cannot describe stay on flash_simt.cu.
//
// What bounds it on an H100: operations on the tensor cores.  Each product
// is three TF32 products (tf32_common.cuh: hi hi + hi lo + lo hi, about
// 2^-20 relative error, against the gate of 1e-4 + 1e-4 |plain|), so the
// ceiling is 495 / 3 = 165 TFLOP/s of fp32-accurate products, against the
// 67 TFLOP/s of plain fp32 FMA on the CUDA cores.  At qwen3-4b's prefill
// (1 x 4096, 32 / 8 heads, hd 128, causal) that is 0.83 ms of work.
//
// Design (flash_dense.cu's shape, with fp32 tiles):
//   * One CTA per (lane, 128-row q tile), bottom tiles first; warpgroup 0's
//     thread 0 (the producer, 24 registers) loads Q once and then a ring of
//     NST = 2 stages of NKV kv columns with TMA; warpgroups 1 and 2 (240
//     registers) own q rows 0-63 and 64-127 and take turns to issue
//     S = Q K^T (named barriers 1 and 2) as flash_dense does.
//   * Before the launch, split_kernel writes K's hi and lo in K's layout
//     and V's hi and lo transposed, (b, kvh, hd, s_pad), each 8-group of kv
//     positions permuted (tf32_common.cuh): wgmma .tf32 has no transpose
//     flag, and O += P V reduces over kv.  The copies move 3x K's bytes and
//     4x V's once per call (0.04 ms of a 1.1 ms call at the prefill shape,
//     profiled on an H100) and are read from L2 by the CTAs of a KV head.
//   * Q: the raw tile from TMA; each consumer keeps the hi of its 64 rows
//     in registers (HDW / 2 a thread) and writes their lo over the tile
//     (tf32_common.cuh, split_resident).  S = Q_hi K_lo (RS) + Q_lo K_hi
//     (SS) + Q_hi K_hi (RS), HDW / 8 k steps each, one commit group: a k
//     step reads 5 KB of shared memory a warpgroup at NKV 32, where Q_hi in
//     shared memory and Q_lo in registers read 7 KB, more than the 128
//     bytes a clock shared memory gives the 48 clocks of its products.
//   * Online softmax in registers, in the log2 domain with ex2.approx, the
//     mask arithmetic only where a tile crosses the diagonal, the window
//     or s (flash_dense's rules: NEG_INF -1e30, corr = exp2(m - m_new),
//     dead rows 0).  P stays fp32: its hi and lo come straight from the
//     accumulator registers in the permuted order, and
//     O += P_lo V_hi + P_hi V_lo + P_hi V_hi with RS wgmmas (n = HDW).
//     P goes through the A fragment in registers (not shared memory)
//     because the permuted V^T copy makes the accumulator's registers the
//     fragment as they stand, and RS reads half the shared-memory bytes
//     of SS.
//   * Shared memory: Q (128 x HDP fp32, HDP = HDW rounded up to 32) and per
//     stage K hi, K lo (NKV x HDP) and V^T hi, V^T lo (HDW x NKV):
//       HDW 128, NKV 32: 64 KB + 2 x 64 KB = 192 KB
//       HDW  80, NKV 32: 48 KB + 2 x 44 KB = 136 KB
//       HDW  64, NKV 64: 32 KB + 2 x 64 KB = 160 KB
//     Registers of a consumer thread: o and Q_hi HDW / 2 each, S and P_lo
//     NKV / 2 each (160 at HDW 128).
//   * Head dims: HDW is 64 (hd <= 64), 80 (hd <= 80) or 128; TMA fills the
//     columns past hd with zeros, the products run at HDW and only the
//     columns below hd are written.  With `lse` given it also writes each
//     row's log-sum-exp (m + log2 l) ln 2, +inf for a dead row, for
//     flash_f32_bwd.cu.
//   * Every element of the output is the same sequence of wgmmas over the
//     same tiles whatever the launch, so the output is deterministic.
//
// Schedule-aware entry (flash_sched_f32): flash_sched.cu's persistent walk
// (sched_walk.cuh) on these tiles.  The split copies of K and V are made
// once per call, before the walk; then the grid has p CTAs, one per plan
// worker, and CTA w walks the descriptors [bounds[w], bounds[w+1]), its
// share of the plan, in 128-row q tiles (units), the producer and the
// consumers through the same Walk.  A unit's kv tiles start at an
// NKV-aligned column (the permuted V^T copy's 8-groups are aligned), the
// columns below its group's first and past its group's end (its last kv
// block, s, the lane's `lim`) masked; tiles dead for every row of the unit
// are never loaded.  Q is single-buffered: each unit's Q tile is split
// resident as above, and the consumers hand it back (q_empty) after the
// unit's last S, so the producer loads the next unit's Q while they run
// the last P V; the ring's phases carry on across units.  Only the unit's
// rows are written (below its q block's end and s), a row with no live
// column as 0.  A unit's result depends on the unit alone, so the output
// is bit-identical for every schedule and every p.
//
// Dense entry at head dims 136-256 (kernel flash_dense_f32_256, entry
// flash_f32_256_launch; recurrentgemma-2b's local attention, hd 256,
// window 2048): at a padded width of 256 the tiles above do not fit (Q
// 128 KB, a stage 128 KB) and a consumer would hold o and Q_hi at 128
// registers each.  So a cluster of two CTAs takes each (lane, 128-row q
// tile), flash_f32_bwd.cu's pairs: CTA r owns head-dim columns 128 r ..
// 128 r + 127 of Q, of the K hi / lo and V^T hi / lo copies and of O, and
// runs the HDW 128 tiles on that half (CL = 2).  S = Q K^T reduces over the
// whole head dim: each consumer's three-term partial S (m64n32, 16 floats a
// thread) goes to the same warpgroup of the peer through distributed shared
// memory every kv tile (tf32_common.cuh, exchange), and each CTA adds the
// two partials, p0 + p1 = p1 + p0, so both hold the same bits of S, m, l
// and P; then each runs O += P V on its own V^T half and writes its own
// output columns.  Rank 0 alone writes lse.  Every product is computed
// once, as at HDW 128, and the pair reads each tile once between them.
// Shared memory (two exchange buffers a warpgroup, so that a warpgroup
// writes tile i + 1's partial while the peer may still read tile i's):
//   64 KB Q + 2 x 64 KB stages + 4 x 8 KB exchange = 224 KB, plus 128 bytes
//   of barriers and the 1 KB alignment slack: 230,528 of 232,448 bytes,
// so NKV stays 32 and the exchange moves whole m64n32 partials.  A
// consumer thread's registers are HDW 128's (o 64, Q_hi 64, S 16, P hi / lo
// 32); the exchange reuses S's.

#include <type_traits>

#include "tf32_common.cuh"
#include "sched_walk.cuh"

namespace {

using namespace tf32;

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 128;                 // q rows of a CTA
constexpr int NTHREADS = 384;
constexpr int CONSUMER_WARPS = 8;
constexpr int NST = 2;                  // K / V stages
constexpr int TURN = 1;                 // named barriers 1, 2: the S turns
constexpr int QSPLIT = 3;               // named barriers 3, 4: Q split

// CL 2: a cluster pair's CTA, which also holds the exchange buffers (two a
// consumer warpgroup, NKV / 2 floats a thread each) and their barriers
template <int HDW, int NKV, int CL = 1>
struct Layout {
  static constexpr int HDP = (HDW + 31) / 32 * 32;
  static constexpr int QBOX = BQ * 128;              // 128 rows x 32 fp32
  static constexpr int QBYTES = HDP / 32 * QBOX;
  static constexpr int KBOX = NKV * 128;
  static constexpr int KBYTES = HDP / 32 * KBOX;     // K hi (or K lo)
  static constexpr int VBOX = HDW * 128;             // HDW rows x 32 kv
  static constexpr int VBYTES = NKV / 32 * VBOX;     // V^T hi (or lo)
  static constexpr int STAGE = 2 * KBYTES + 2 * VBYTES;
  static constexpr int XBUF = NKV / 2 * 128 * 4;    // one exchange buffer
  static constexpr int Q = 0;
  static constexpr int KV = QBYTES;
  static constexpr int XB = KV + NST * STAGE;
  static constexpr int BAR = XB + (CL == 2 ? 4 * XBUF : 0);
  // q_full, q_empty (schedule-aware), then k_full, v_full, empty a stage;
  // CL 2: xfull, xempty of each consumer's two buffers
  static constexpr int BYTES =
      BAR + (2 + 3 * NST + (CL == 2 ? 8 : 0)) * 8 + 1024;  // + align
};

struct F32Params {
  float* o;
  float* lse;         // (b, h, s) log-sum-exp of each row, or null
  long long o_sb, o_sh, o_ss;
  int lanes, nq, s, H, group, hd, causal, window;
  float scale_log2;   // softmax scale * log2(e)
};

struct SchedF32Params {
  float* o;
  long long o_sb, o_sh, o_ss;
  const int* desc;     // 6 x G int32: bi, qi, kj, first, last, lim
  const int* bounds;   // p + 1 int32: CTA w owns descriptors [b[w], b[w+1])
  int G, s, H, group, hd, block_q, block_k, causal, window;
  float scale_log2;
};

// what softmax<> masks: columns below lo or at or past end, above the
// diagonal, outside the window
struct MaskParams {
  int lo, end, causal, window;
  float scale_log2;
};

// S = Q K^T for consumer c's 64 rows on its turn: Q_hi (registers) K_lo,
// Q_lo (shared memory) K_hi, Q_hi K_hi, HDW / 8 k steps each; then hand
// the turn over and wait for the result
template <int HDW, int NKV>
__device__ __forceinline__ void issue_s(float* sacc,
                                        const uint32_t (&qhi)[HDW / 8][4],
                                        uint64_t dqlo, uint64_t dkhi,
                                        uint64_t dklo, int c) {
  using L = Layout<HDW, NKV>;
  named_bar_sync(TURN + c, 256);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HDW / 8; ++kk) {
    const int ko = (kk / 4) * (L::KBOX / 16) + (kk % 4) * 2;
    Tf32<NKV>::rs(sacc, qhi[kk], dklo + ko, kk);
    Tf32<NKV>::ss(sacc, dqlo + (kk / 4) * (L::QBOX / 16) + (kk % 4) * 2,
                  dkhi + ko, 1);
  }
#pragma unroll
  for (int kk = 0; kk < HDW / 8; ++kk)
    Tf32<NKV>::rs(sacc, qhi[kk],
                  dkhi + (kk / 4) * (L::KBOX / 16) + (kk % 4) * 2, 1);
  wgmma_commit();
  named_bar_arrive(TURN + 1 - c, 256);
  wgmma_wait<0>();
  fence_regs<NKV / 2>(sacc);
}

// scores of this thread (m64n{NKV} accumulator layout) -> P = exp2(S scale
// log2(e) - m) as hi / lo A fragments of the NKV / 8 permuted 8-groups;
// updates m, l (log2 domain) and rescales o.  MASK: the columns MaskParams
// names get NEG_INF first.
template <int HDW, bool MASK, int NKV>
__device__ __forceinline__ void softmax(float* sacc, float (&m)[2],
                                        float (&l)[2], float* o,
                                        uint32_t (&phi)[NKV / 8][4],
                                        uint32_t (&plo)[NKV / 8][4], int col0,
                                        int r_lo, int lane,
                                        const MaskParams& P) {
  float mx[2];
  if constexpr (MASK) {
    mx[0] = m[0];
    mx[1] = m[1];
#pragma unroll
    for (int v = 0; v < NKV / 2; ++v) {
      const int row = r_lo + 8 * ((v >> 1) & 1);
      const int col = col0 + 8 * (v >> 2) + 2 * (lane & 3) + (v & 1);
      bool ok = col >= P.lo && col < P.end;
      if (P.causal) ok = ok && col <= row;
      if (P.window > 0) ok = ok && (row - col) < P.window;
      const float x = ok ? sacc[v] * P.scale_log2 : NEG_INF;
      sacc[v] = x;
      mx[(v >> 1) & 1] = fmaxf(mx[(v >> 1) & 1], x);
    }
  } else {
    float raw[2] = {sacc[0], sacc[2]};
#pragma unroll
    for (int v = 0; v < NKV / 2; ++v)
      raw[(v >> 1) & 1] = fmaxf(raw[(v >> 1) & 1], sacc[v]);
    // scale > 0, so the scaled maximum is the maximum of the scaled scores
    mx[0] = fmaxf(m[0], raw[0] * P.scale_log2);
    mx[1] = fmaxf(m[1], raw[1] * P.scale_log2);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
  }
  const float corr[2] = {fast_exp2(m[0] - mx[0]), fast_exp2(m[1] - mx[1])};
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int v = 0; v < NKV / 2; ++v) {
    const float mj = mx[(v >> 1) & 1];
    const float p = MASK ? fast_exp2(sacc[v] - mj)
                         : fast_exp2(fmaf(sacc[v], P.scale_log2, -mj));
    sacc[v] = p;
    rs[(v >> 1) & 1] += p;
  }
#pragma unroll
  for (int kk = 0; kk < NKV / 8; ++kk) split_frag(sacc + 4 * kk, phi[kk], plo[kk]);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    rs[j] += __shfl_xor_sync(0xffffffffu, rs[j], 1);
    rs[j] += __shfl_xor_sync(0xffffffffu, rs[j], 2);
    l[j] = l[j] * corr[j] + rs[j];
    m[j] = mx[j];
  }
#pragma unroll
  for (int v = 0; v < HDW / 2; ++v) o[v] *= corr[(v >> 1) & 1];
}

// O += P_lo V_hi + P_hi V_lo + P_hi V_hi over the stage's NKV kv positions
// (V^T tiles: HDW rows, 32 positions a box), then wait
template <int HDW, int NKV>
__device__ __forceinline__ void issue_pv(float* o, uint32_t (&phi)[NKV / 8][4],
                                         uint32_t (&plo)[NKV / 8][4],
                                         uint64_t dvhi, uint64_t dvlo) {
  using L = Layout<HDW, NKV>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NKV / 8; ++kk) {
    const int off = (kk / 4) * (L::VBOX / 16) + (kk % 4) * 2;
    Tf32<HDW>::rs(o, plo[kk], dvhi + off, 1);
    Tf32<HDW>::rs(o, phi[kk], dvlo + off, 1);
    Tf32<HDW>::rs(o, phi[kk], dvhi + off, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<HDW / 2>(o);
  fence_regs<NKV / 2>(&phi[0][0]);
  fence_regs<NKV / 2>(&plo[0][0]);
}

// out = o / l for this thread's rows r_lo and r_lo + 8 below `rend` and
// the columns below hd; rows that never saw a live column (m <= NEG_INF /
// 2) are written as 0.  With `lse` (the lane's row) each row's
// log-sum-exp (m + log2 l) ln 2 too, +inf for a dead row.
template <int HDW>
__device__ __forceinline__ void store_rows(float* ob, long long o_ss,
                                           const float* o, const float (&m)[2],
                                           const float (&l)[2], int r_lo,
                                           int rend, int lane, int hd,
                                           float* lse) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = r_lo + 8 * j;
    if (row >= rend) continue;
    const bool alive = m[j] > NEG_INF * 0.5f;
    const float lc = fmaxf(l[j], 1e-30f);
#pragma unroll
    for (int nt = 0; nt < HDW / 8; ++nt) {
      if (nt * 8 >= hd) break;
      const int col = nt * 8 + 2 * (lane & 3);
      *reinterpret_cast<float2*>(ob + row * o_ss + col) =
          alive ? make_float2(o[4 * nt + 2 * j] / lc,
                              o[4 * nt + 2 * j + 1] / lc)
                : make_float2(0.f, 0.f);
    }
    if (lse != nullptr && (lane & 3) == 0)
      lse[row] = alive ? (m[j] + log2f(lc)) * 0.6931471805599453f
                       : __int_as_float(0x7f800000);
  }
}

// CL 1: one CTA a (lane, q tile); CL 2: a cluster pair a (lane, q tile),
// CTA r on head-dim columns HDW r .. HDW r + HDW - 1
template <int HDW, int NKV, int CL>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap khimap,
                 const __grid_constant__ CUtensorMap klomap,
                 const __grid_constant__ CUtensorMap vhimap,
                 const __grid_constant__ CUtensorMap vlomap,
                 const F32Params P) {
  using L = Layout<HDW, NKV, CL>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + NST;
  uint64_t* empty = v_full + NST;
  uint64_t* xfull = empty + NST;      // CL 2: [warpgroup][buffer]
  uint64_t* xempty = xfull + 4;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    // one arrive from each thread of the peer's warpgroup
    if constexpr (CL == 2)
      for (int i = 0; i < 8; ++i) mbar_init(&xfull[i], 128);
    fence_mbar_init();
  }
  // in a pair every thread of both CTAs waits, so that no arrive finds a
  // barrier not yet initialised
  if constexpr (CL == 2)
    cluster_sync();
  else
    __syncthreads();
  const uint32_t rank = CL == 2 ? cluster_rank() : 0;
  const int hd0 = HDW * static_cast<int>(rank);

  // bottom (longest) q tiles first
  const int unit = static_cast<int>(blockIdx.x) / CL;
  const int qt = P.nq - 1 - unit / P.lanes;
  const int lane_id = unit % P.lanes;
  const int b = lane_id / P.H;
  const int hh = lane_id % P.H;
  const int row0 = qt * BQ;
  const int c_lo = P.window > 0 ? max(0, row0 - P.window + 1) / NKV * NKV : 0;
  const int c_hi = P.causal ? min(row0 + BQ, P.s) : P.s;
  const int ntiles = (c_hi - c_lo + NKV - 1) / NKV;

  if (wg == 0) {
    // ---- producer ----
    reg_dealloc<24>();
    if (tid == 0) {
      const int kvh = hh / P.group;
      mbar_expect_tx(q_full, L::QBYTES);
      for (int j = 0; j < L::HDP / 32; ++j)
        tma_load_4d(smem + L::Q + j * L::QBOX, &qmap, q_full, hd0 + 32 * j,
                    row0, hh, b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % NST;
        const int col0 = c_lo + i * NKV;
        unsigned char* st = smem + L::KV + s * L::STAGE;
        mbar_wait(&empty[s], ((i / NST) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], 2 * L::KBYTES);
        for (int j = 0; j < L::HDP / 32; ++j) {
          tma_load_4d(st + j * L::KBOX, &khimap, &k_full[s], hd0 + 32 * j,
                      col0, kvh, b);
          tma_load_4d(st + L::KBYTES + j * L::KBOX, &klomap, &k_full[s],
                      hd0 + 32 * j, col0, kvh, b);
        }
        mbar_expect_tx(&v_full[s], 2 * L::VBYTES);
        for (int j = 0; j < NKV / 32; ++j) {
          tma_load_4d(st + 2 * L::KBYTES + j * L::VBOX, &vhimap, &v_full[s],
                      col0 + 32 * j, hd0, kvh, b);
          tma_load_4d(st + 2 * L::KBYTES + L::VBYTES + j * L::VBOX, &vlomap,
                      &v_full[s], col0 + 32 * j, hd0, kvh, b);
        }
      }
    }
  } else {
    // ---- consumers: q rows r0 .. r0 + 63 ----
    reg_alloc<240>();
    const int c = wg - 1;
    const int tq = tid % 128;
    const int lane = tid % 32;
    const int r0 = row0 + 64 * c;
    const int r_lo = r0 + 16 * (tq / 32) + lane / 4;   // and r_lo + 8

    float o[HDW / 2];
#pragma unroll
    for (int v = 0; v < HDW / 2; ++v) o[v] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};

    const MaskParams mp{0, P.s, P.causal, P.window, P.scale_log2};
    mbar_wait(q_full, 0);
    uint32_t qhi[HDW / 8][4];
    split_resident<HDW>(smem + L::Q, L::QBOX, 64 * c, qhi, tq, QSPLIT + c);
    const uint64_t dq = smem_desc(smem + L::Q + c * 64 * 128, 16, 1024);
    if (c == 1) named_bar_arrive(TURN, 256);

    for (int i = 0; i < ntiles; ++i) {
      const int s = i % NST;
      const uint32_t ph = (i / NST) & 1;
      const int col0 = c_lo + i * NKV;
      const bool mask = col0 + NKV > P.s || (P.causal && col0 + NKV - 1 > r0) ||
                        (P.window > 0 && r0 + 63 - col0 >= P.window);
      unsigned char* st = smem + L::KV + s * L::STAGE;

      float sacc[NKV / 2];
      mbar_wait(&k_full[s], ph);
      issue_s<HDW, NKV>(sacc, qhi, dq, smem_desc(st, 16, 1024),
                        smem_desc(st + L::KBYTES, 16, 1024), c);
      // the pair: S over the whole head dim, the same bits in both CTAs
      if constexpr (CL == 2)
        exchange<NKV / 2>(
            sacc, reinterpret_cast<float*>(smem + L::XB + c * 2 * L::XBUF),
            xfull + 2 * c, xempty + 2 * c, i, ntiles, tq, rank ^ 1);

      uint32_t phi[NKV / 8][4], plo[NKV / 8][4];
      if (mask)
        softmax<HDW, true, NKV>(sacc, m, l, o, phi, plo, col0, r_lo, lane, mp);
      else
        softmax<HDW, false, NKV>(sacc, m, l, o, phi, plo, col0, r_lo, lane,
                                 mp);

      mbar_wait(&v_full[s], ph);
      issue_pv<HDW, NKV>(o, phi, plo,
                         smem_desc(st + 2 * L::KBYTES, 16, 1024),
                         smem_desc(st + 2 * L::KBYTES + L::VBYTES, 16, 1024));
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // consumer 1's last hand-over is taken here, so every turn is matched
    if (c == 0) named_bar_sync(TURN, 256);

    // this CTA's output columns; the pair's rank 0 writes lse
    store_rows<HDW>(P.o + b * P.o_sb + hh * P.o_sh + hd0, P.o_ss, o, m, l,
                    r_lo, P.s, lane, P.hd - hd0,
                    P.lse == nullptr || rank != 0
                        ? nullptr
                        : P.lse + static_cast<long long>(lane_id) * P.s);
  }
}

// The schedule-aware kernel: the walk over the plan's descriptors
// (sched_walk.cuh) on flash_f32_kernel's tiles, persistent over p CTAs
template <int HDW, int NKV>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_sched_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap khimap,
                       const __grid_constant__ CUtensorMap klomap,
                       const __grid_constant__ CUtensorMap vhimap,
                       const __grid_constant__ CUtensorMap vlomap,
                       const SchedF32Params P) {
  using L = Layout<HDW, NKV>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_full + 2;
  uint64_t* v_full = k_full + NST;
  uint64_t* empty = v_full + NST;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMER_WARPS);
    for (int s = 0; s < NST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  sched_walk::Walk<BQ> w(P, blockIdx.x);
  int it = 0;   // kv tiles so far: stage it % NST, phase it / NST
  int qn = 0;   // Q tiles so far: phase qn
  if (wg == 0) {
    // ---- producer ----
    reg_dealloc<24>();
    if (tid == 0) {
      while (w.next<NKV, true>(P)) {
        if (w.ntiles == 0) continue;
        const int b = w.lane_id / P.H;
        const int hh = w.lane_id % P.H;
        const int kvh = hh / P.group;
        mbar_wait(q_empty, (qn & 1) ^ 1);
        mbar_expect_tx(q_full, L::QBYTES);
        for (int j = 0; j < L::HDP / 32; ++j)
          tma_load_4d(smem + L::Q + j * L::QBOX, &qmap, q_full, 32 * j,
                      w.row0, hh, b);
        ++qn;
        for (int i = 0; i < w.ntiles; ++i, ++it) {
          const int s = it % NST;
          const int col0 = w.tile0 + i * NKV;
          unsigned char* st = smem + L::KV + s * L::STAGE;
          mbar_wait(&empty[s], ((it / NST) & 1) ^ 1);
          mbar_expect_tx(&k_full[s], 2 * L::KBYTES);
          for (int j = 0; j < L::HDP / 32; ++j) {
            tma_load_4d(st + j * L::KBOX, &khimap, &k_full[s], 32 * j, col0,
                        kvh, b);
            tma_load_4d(st + L::KBYTES + j * L::KBOX, &klomap, &k_full[s],
                        32 * j, col0, kvh, b);
          }
          mbar_expect_tx(&v_full[s], 2 * L::VBYTES);
          for (int j = 0; j < NKV / 32; ++j) {
            tma_load_4d(st + 2 * L::KBYTES + j * L::VBOX, &vhimap, &v_full[s],
                        col0 + 32 * j, 0, kvh, b);
            tma_load_4d(st + 2 * L::KBYTES + L::VBYTES + j * L::VBOX,
                        &vlomap, &v_full[s], col0 + 32 * j, 0, kvh, b);
          }
        }
      }
    }
  } else {
    // ---- consumers: rows 64 c .. 64 c + 63 of each unit ----
    reg_alloc<240>();
    const int c = wg - 1;
    const int tq = tid % 128;
    const int lane = tid % 32;
    const uint64_t dq = smem_desc(smem + L::Q + c * 64 * 128, 16, 1024);
    // the consumers take turns to issue S = Q K^T across every unit;
    // consumer 0 goes first
    if (c == 1) named_bar_arrive(TURN, 256);

    while (w.next<NKV, true>(P)) {
      const int r0 = w.row0 + 64 * c;
      const int r_lo = r0 + 16 * (tq / 32) + lane / 4;   // and r_lo + 8
      const MaskParams mp{w.c_lo, w.c_end, P.causal, P.window, P.scale_log2};
      float o[HDW / 2];
#pragma unroll
      for (int v = 0; v < HDW / 2; ++v) o[v] = 0.f;
      float m[2] = {NEG_INF, NEG_INF};
      float l[2] = {0.f, 0.f};

      uint32_t qhi[HDW / 8][4];
      if (w.ntiles > 0) {
        mbar_wait(q_full, qn & 1);
        ++qn;
        split_resident<HDW>(smem + L::Q, L::QBOX, 64 * c, qhi, tq,
                            QSPLIT + c);
      }
      for (int i = 0; i < w.ntiles; ++i, ++it) {
        const int s = it % NST;
        const uint32_t ph = (it / NST) & 1;
        const int col0 = w.tile0 + i * NKV;
        const bool mask = col0 < w.c_lo || col0 + NKV > w.c_end ||
                          (P.causal && col0 + NKV - 1 > r0) ||
                          (P.window > 0 && r0 + 63 - col0 >= P.window);
        unsigned char* st = smem + L::KV + s * L::STAGE;

        // S = Q K^T; after the unit's last one, Q goes back to the producer
        float sacc[NKV / 2];
        mbar_wait(&k_full[s], ph);
        issue_s<HDW, NKV>(sacc, qhi, dq, smem_desc(st, 16, 1024),
                          smem_desc(st + L::KBYTES, 16, 1024), c);
        if (i == w.ntiles - 1 && lane == 0) mbar_arrive(q_empty);

        uint32_t phi[NKV / 8][4], plo[NKV / 8][4];
        if (mask)
          softmax<HDW, true, NKV>(sacc, m, l, o, phi, plo, col0, r_lo, lane,
                                  mp);
        else
          softmax<HDW, false, NKV>(sacc, m, l, o, phi, plo, col0, r_lo, lane,
                                   mp);

        mbar_wait(&v_full[s], ph);
        issue_pv<HDW, NKV>(o, phi, plo,
                           smem_desc(st + 2 * L::KBYTES, 16, 1024),
                           smem_desc(st + 2 * L::KBYTES + L::VBYTES, 16, 1024));
        if (lane == 0) mbar_arrive(&empty[s]);
      }

      // the unit's rows only; dead rows (no live column) are written as 0
      const int b = w.lane_id / P.H;
      const int hh = w.lane_id % P.H;
      store_rows<HDW>(P.o + b * P.o_sb + hh * P.o_sh, P.o_ss, o, m, l, r_lo,
                      w.rend, lane, P.hd, nullptr);
    }

    // consumer 1's last hand-over is taken here, so every turn is matched
    if (c == 0) named_bar_sync(TURN, 256);
  }
}

// a call's operands after the split copies: q in place, K hi / lo
// (b, s, kvh, hd), V^T hi / lo (b, kvh, hd, s_pad)
struct Operands {
  const float *q, *khi, *klo, *vthi, *vtlo;
  long long qs[3];   // q's (batch, head, row) strides
  int batch, s, H, kvh, hd, s_pad;
};

// validates the shape (head dims up to 128, or, wide, 136-256), writes K's
// and V's split copies into the scratch (tf32_common.cuh, split_kernel)
// and fills `ops`
int split_operands(Operands& ops, const void* q, const void* k,
                   const void* v, void* khi, void* klo, void* vthi,
                   void* vtlo, int s_pad, int batch, int s, int H, int group,
                   int hd, const long long* str, cudaStream_t st,
                   bool wide = false) {
  if (batch <= 0 || s <= 0 || H <= 0 || group <= 0 || H % group != 0 ||
      hd <= (wide ? 128 : 0) || hd > (wide ? 256 : 128) || hd % 8 != 0 ||
      s_pad < s || s_pad % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kvh = H / group;
  SplitParams sk{static_cast<const float*>(k), str[3], str[4], str[5],
                 static_cast<float*>(khi), static_cast<float*>(klo), nullptr,
                 nullptr, s, kvh, hd, s_pad};
  int rc = split_launch(sk, batch, st);
  if (rc != 0) return rc;
  SplitParams sv{static_cast<const float*>(v), str[6], str[7], str[8], nullptr,
                 nullptr, static_cast<float*>(vthi), static_cast<float*>(vtlo),
                 s, kvh, hd, s_pad};
  rc = split_launch(sv, batch, st);
  if (rc != 0) return rc;
  ops = Operands{static_cast<const float*>(q), static_cast<const float*>(khi),
                 static_cast<const float*>(klo),
                 static_cast<const float*>(vthi),
                 static_cast<const float*>(vtlo), {str[0], str[1], str[2]},
                 batch, s, H, kvh, hd, s_pad};
  return 0;
}

// the five tensor maps at width HDW: Q in 128-row boxes, K hi / lo in
// NKV-row boxes, V^T hi / lo in boxes of 32 positions x HDW rows
template <int HDW, int NKV>
int encode_maps(CUtensorMap (&m)[5], const Operands& c) {
  const long long kr = static_cast<long long>(c.kvh) * c.hd;   // row stride
  int rc = encode_rows(&m[0], c.q, c.batch, c.s, c.H, c.hd, c.qs[0], c.qs[1],
                       c.qs[2], BQ);
  if (rc == 0)
    rc = encode_rows(&m[1], c.khi, c.batch, c.s, c.kvh, c.hd, c.s * kr, c.hd,
                     kr, NKV);
  if (rc == 0)
    rc = encode_rows(&m[2], c.klo, c.batch, c.s, c.kvh, c.hd, c.s * kr, c.hd,
                     kr, NKV);
  if (rc == 0)
    rc = encode_cols(&m[3], c.vthi, c.batch, c.kvh, c.hd, c.s_pad, 32, HDW);
  if (rc == 0)
    rc = encode_cols(&m[4], c.vtlo, c.batch, c.kvh, c.hd, c.s_pad, 32, HDW);
  return rc;
}

// `grid` CTAs of the dense (P: F32Params) or the schedule-aware (P:
// SchedF32Params) kernel at width HDW, the dense one in clusters of CL
template <int HDW, int NKV, int CL = 1, typename Params>
int launch_hd(const Operands& c, const Params& P, unsigned grid,
              cudaStream_t st) {
  CUtensorMap m[5];
  const int rc = encode_maps<HDW, NKV>(m, c);
  if (rc != 0) return rc;
  constexpr int bytes = Layout<HDW, NKV, CL>::BYTES;
  void (*kern)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
               CUtensorMap, Params);
  if constexpr (std::is_same<Params, SchedF32Params>::value)
    kern = flash_sched_f32_kernel<HDW, NKV>;
  else
    kern = flash_f32_kernel<HDW, NKV, CL>;
  return launch_clusters<CL>(kern, grid, NTHREADS, bytes, st, m[0], m[1],
                             m[2], m[3], m[4], P);
}

// the width of a head dim: 64 (NKV 64), 80 or 128 (NKV 32)
template <typename Params>
int launch_width(const Operands& c, const Params& P, unsigned grid,
                 cudaStream_t st) {
  if (c.hd <= 64) return launch_hd<64, 64>(c, P, grid, st);
  if (c.hd <= 80) return launch_hd<80, 32>(c, P, grid, st);
  return launch_hd<128, 32>(c, P, grid, st);
}

// the dense entries: head dims up to 128 (one CTA a tile), or (wide)
// 136-256 on cluster pairs
int launch_dense(bool wide, const void* q, const void* k, const void* v,
                 void* o, void* lse, void* khi, void* klo, void* vthi,
                 void* vtlo, int s_pad, int batch, int s, int H, int group,
                 int hd, int causal, int window, const long long* str,
                 long long o_sb, long long o_sh, long long o_ss, float scale,
                 cudaStream_t st) {
  Operands ops;
  const int rc = split_operands(ops, q, k, v, khi, klo, vthi, vtlo, s_pad,
                                batch, s, H, group, hd, str, st, wide);
  if (rc != 0) return rc;
  F32Params P;
  P.o = static_cast<float*>(o);
  P.lse = static_cast<float*>(lse);
  P.o_sb = o_sb; P.o_sh = o_sh; P.o_ss = o_ss;
  P.lanes = batch * H;
  P.nq = (s + BQ - 1) / BQ;
  P.s = s; P.H = H; P.group = group; P.hd = hd;
  P.causal = causal; P.window = window;
  P.scale_log2 = scale * LOG2E;
  const unsigned grid = static_cast<unsigned>(P.lanes * P.nq);
  if (wide) return launch_hd<128, 32, 2>(ops, P, 2 * grid, st);
  return launch_width(ops, P, grid, st);
}

}  // namespace

// q (b, s, h, hd), k / v (b, s, kvh, hd) by element strides (batch, head,
// row) -> o (b, s, h, hd), and with `lse` each row's log-sum-exp (b, h, s).
// khi / klo: scratch of k's size, (b, s, kvh, hd); vthi / vtlo: scratch of
// (b, kvh, hd, s_pad) floats, s_pad a multiple of 32 at least s (the
// caller's, so that it sizes the scratch it passes).
extern "C" int flash_f32_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, void* khi,
    void* klo, void* vthi, void* vtlo, int s_pad, int batch, int s, int H,
    int group, int hd, int causal, int window, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, void* stream) {
  const long long str[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss};
  return launch_dense(false, q, k, v, o, lse, khi, klo, vthi, vtlo, s_pad,
                      batch, s, H, group, hd, causal, window, str, o_sb, o_sh,
                      o_ss, scale, static_cast<cudaStream_t>(stream));
}

// the same at head dims 136-256 (multiples of 8), on cluster pairs; the
// same arguments and scratch
extern "C" int flash_f32_256_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, void* khi,
    void* klo, void* vthi, void* vtlo, int s_pad, int batch, int s, int H,
    int group, int hd, int causal, int window, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, void* stream) {
  const long long str[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss};
  return launch_dense(true, q, k, v, o, lse, khi, klo, vthi, vtlo, s_pad,
                      batch, s, H, group, hd, causal, window, str, o_sb, o_sh,
                      o_ss, scale, static_cast<cudaStream_t>(stream));
}

// the schedule-aware form on `p` CTAs: the descriptors (6 x G int32) in
// plan order and each CTA's span of them (p + 1 int32); the scratch as
// flash_f32_launch's
extern "C" int flash_sched_f32_launch(
    const void* q, const void* k, const void* v, void* o, const void* desc,
    const void* bounds, void* khi, void* klo, void* vthi, void* vtlo,
    int s_pad, int G, int p, int batch, int s, int H, int group, int hd,
    int block_q, int block_k, int causal, int window, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, float scale,
    void* stream) {
  if (p <= 0 || G < 0 || block_q <= 0 || block_k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long str[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss};
  Operands ops;
  const int rc = split_operands(ops, q, k, v, khi, klo, vthi, vtlo, s_pad,
                                batch, s, H, group, hd, str, st);
  if (rc != 0) return rc;
  SchedF32Params P;
  P.o = static_cast<float*>(o);
  P.o_sb = o_sb; P.o_sh = o_sh; P.o_ss = o_ss;
  P.desc = static_cast<const int*>(desc);
  P.bounds = static_cast<const int*>(bounds);
  P.G = G; P.s = s; P.H = H; P.group = group; P.hd = hd;
  P.block_q = block_q; P.block_k = block_k;
  P.causal = causal; P.window = window;
  P.scale_log2 = scale * LOG2E;
  return launch_width(ops, P, static_cast<unsigned>(p), st);
}

extern "C" const char* flash_f32_error_string(int code) {
  return error_string(code);
}
