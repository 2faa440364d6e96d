// The dense flash-attention backward in fp32 on Hopper's tensor cores
// (sm_90a): TMA, wgmma .tf32 and a three-term TF32 split, for the calls
// flash_f32.cu computes forward (head dims up to 128) and for fp32 at head
// dims 136-256 (cluster pairs, below), whose forward is flash_simt.cu's.
// Both forwards write lse as the natural log-sum-exp of the scaled scores.
//
// Replaces no Pallas kernel: the reference differentiates _attend_flash
// (src/repro/models/attention.py:191), the pure-JAX twin of _flash_kernel,
// by autodiff, in fp32.  With S = Q K^T scale (masked), the forward's
// log-sum-exp lse (b, h, s), P = exp(S - lse) and D = rowsum(dO o O):
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),  dQ = dS K scale,
//   dK = dS^T Q scale.
// The three passes and rules of flash_simt_bwd.cu: delta (D, that file's
// delta_simt_kernel, bytes-bound), dkdv (one CTA per (64-row kv tile,
// batch, KV head), the group's q heads and their q tiles summed in
// ascending order inside it, so GQA needs no atomics), dq (one CTA per
// (64-row q tile, lane), its kv tiles ascending).  No atomics, no split:
// the gradients are bit-identical from run to run.
//
// What bounds it on an H100: operations on the tensor cores at three TF32
// products each (165 TFLOP/s of fp32-accurate products).  Both passes
// recompute S and dq recomputes dP: 7 products where the bound counts 5.
//
// Operands (tf32_common.cuh: hi, lo, K-major only, the permuted transposed
// copies written by split_kernel before each pass):
//   dkdv  S^T = K Q^T     A: K resident (hi in registers, lo in shared
//                         memory), B: Q hi / lo (b, s, h, hd) copies
//         dV += P^T dO    A: P^T (registers), B: dO^T hi / lo copies
//         dP^T = V dO^T   A: V resident, B: dO hi / lo copies
//         dK += dS^T Q    A: dS^T (registers), B: Q^T hi / lo copies
//   dq    S = Q K^T       A: Q resident, B: K hi / lo copies
//         dP = dO V^T     A: dO resident, B: V hi / lo copies
//         dQ += dS K      A: dS (registers), B: K^T hi / lo copies
// The scratch is dkdv's: Q's and dO's hi and lo in both layouts, eight
// copies of 134 MB of fp32 each, 1.07 GB at qwen3-4b's training shape
// (2 x 4096, 32 / 8 heads, hd 128), which dq reuses; all the split copies
// of a backward there take 0.6 ms of its ~15 (profiled on an H100).
//
// Design: three warpgroups.  Warpgroup 0's thread 0 (24 registers) loads
// the resident tiles once and a ring of NST stages of 16 rows (q rows in
// dkdv, kv rows in dq) with TMA.  The two consumer warpgroups (240
// registers) split the work by output, so that each holds one resident
// operand's hi (HDW / 2 registers) and one accumulator (HDW / 2):
//   dkdv: warpgroup 1 S^T -> P^T -> dV, warpgroup 2 dP^T -> dS^T -> dK;
//   dq:   warpgroup 1 S -> P,           warpgroup 2 dP -> dS -> dQ;
// P (P^T) passes from warpgroup 1 to 2 through shared memory, two buffers
// under named barriers 1-2 (full) and 3-4 (empty), each thread reading the
// values that its peer thread of the other warpgroup wrote (the two
// accumulators have the same shape).  A stage of 16 rows makes the S-like
// products m64n16 and the P V-like ones m64n{HDW}k16 (two k steps).
// Shared memory: two resident tiles (64 x HDP fp32), per stage four
// row-major tiles (16 x HDP, SWIZZLE_128B) and in dkdv four transposed
// (HDW x 16, SWIZZLE_64B), in dq two:
//   dkdv HDW 128: 64 KB + 2 x 64 KB + 8 KB = 200 KB
//   dq   HDW 128: 64 KB + 3 x 48 KB + 8 KB = 216 KB
// Head dims as flash_f32.cu: HDW 64, 80 or 128, zeros past hd.
//
// Head dims 136-256 (kernels flash_f32_bwd256_dkdv / _dq, entry points of
// their own): at a padded width of 256 that design does not fit.  A
// consumer would hold its resident operand's hi (HDW / 2 = 128 registers),
// its accumulator (128) and the stage's fresh accumulator (128), 384
// against setmaxnreg's 240, and the two resident tiles would take 128 KB
// of shared memory and a stage 128 KB.  So a cluster of two CTAs takes
// each tile: CTA r owns columns 128 r .. 128 r + 127 of the head dim, its
// resident tiles, its stages' row-major and transposed tiles and its
// output columns, and runs the HDW 128 kernel on that half (CL = 2).  S^T
// and dP^T (S and dP in dq) reduce over the whole head dim: each CTA's
// m64n16 product covers its half, the two trade halves through
// distributed shared memory every stage (st.shared::cluster into the
// peer's buffer and an mbarrier arrive at cluster scope; two buffers a
// warpgroup, handed back by an arrive once read), and each adds the two
// in the same order of operands, p0 + p1 = p1 + p0, so both CTAs hold
// the same bits.  Every product is computed once, as at HDW 128, and the
// pair reads each stage's rows once between them.  A consumer thread's
// registers are those of HDW 128 (hi 64, accumulator 64, fresh
// accumulator 64, S and P 24) plus 8 of the exchange; shared memory:
//   dkdv: 64 KB + 2 x 64 KB + 8 KB + 16 KB exchange = 216 KB
//   dq:   64 KB + 2 x 48 KB + 8 KB + 16 KB exchange = 184 KB (2 stages)
// The scratch is dkdv's as above at hd 256: 4 b h hd (s + s_pad) floats,
// 335 MB at recurrentgemma-2b's local attention (1 x 4096, 10 / 1 heads,
// hd 256, window 2048).

#include "tf32_common.cuh"

namespace {

using namespace tf32;

constexpr int NTHREADS = 384;
constexpr int CONSUMER_WARPS = 8;
constexpr int BR = 64;                  // rows of a CTA's resident tile
constexpr int NS = 16;                  // rows of a stage
constexpr int PFULL = 1, PEMPTY = 3, RSPLIT = 5;   // named barriers
constexpr int PBUF = NS / 2 * 128 * 4;  // one P buffer: 8 floats a thread

// dq's ring: 3 stages, 2 in a cluster pair (its exchange buffers take the
// third's room)
__host__ __device__ constexpr int dq_stages(int cl) { return cl == 2 ? 2 : 3; }

template <int HDW>
struct Tiles {
  static constexpr int HDP = (HDW + 31) / 32 * 32;
  static constexpr int RBOX = BR * 128;              // 64 rows x 32 fp32
  static constexpr int RBYTES = HDP / 32 * RBOX;
  static constexpr int SBOX = NS * 128;              // 16 rows x 32 fp32
  static constexpr int SBYTES = HDP / 32 * SBOX;
  static constexpr int TBYTES = HDW * 64;            // HDW rows x 16 fp32
};

// stage layout of a pass with NT transposed tiles: four row-major tiles,
// then NT transposed ones; the resident tiles first, the P buffers, in a
// cluster pair (CL 2) the exchange buffers (two a warpgroup), and the
// barriers last
template <int HDW, int NT, int NST, int CL>
struct Layout {
  using T = Tiles<HDW>;
  static constexpr int STAGE = 4 * T::SBYTES + NT * T::TBYTES;
  static constexpr int RES = 0;
  static constexpr int ST = 2 * T::RBYTES;
  static constexpr int PB = ST + NST * STAGE;
  static constexpr int XB = PB + 2 * PBUF;
  static constexpr int BAR = XB + (CL == 2 ? 4 * PBUF : 0);
  static constexpr int BYTES =
      BAR + (1 + 2 * NST + (CL == 2 ? 8 : 0)) * 8 + 1024;
};

struct BwdParams {
  const float *lse, *delta;   // (b, h, s)
  float *out0, *out1;         // dkdv: dV, dK (b, s, kvh, hd); dq: dQ
  int s, H, group, hd, causal, window, lanes, ntile;
  float scale, scale_log2;
};

__device__ __forceinline__ bool live(const BwdParams& P, int r, int c) {
  bool ok = r < P.s && c < P.s;
  if (P.causal) ok = ok && c <= r;
  if (P.window > 0) ok = ok && r - c < P.window;
  return ok;
}

// acc (64 x 16) = A B^T over HDW: A_hi (registers) B_lo, A_lo (the
// resident tile) B_hi, A_hi B_hi; A resident (64-row boxes), B a stage
// tile (16-row boxes); waits
template <int HDW>
__device__ __forceinline__ void issue_s16(float* acc,
                                          const uint32_t (&ahi)[HDW / 8][4],
                                          uint64_t dalo, uint64_t dbhi,
                                          uint64_t dblo) {
  using T = Tiles<HDW>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HDW / 8; ++kk) {
    const int bo = (kk / 4) * (T::SBOX / 16) + (kk % 4) * 2;
    Tf32<16>::rs(acc, ahi[kk], dblo + bo, kk);
    Tf32<16>::ss(acc, dalo + (kk / 4) * (T::RBOX / 16) + (kk % 4) * 2,
                 dbhi + bo, 1);
  }
#pragma unroll
  for (int kk = 0; kk < HDW / 8; ++kk)
    Tf32<16>::rs(acc, ahi[kk],
                 dbhi + (kk / 4) * (T::SBOX / 16) + (kk % 4) * 2, 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<8>(acc);
}

// acc (64 x HDW) += X B over the stage's 16 rows: X (8 accumulator values
// of this thread, m64n16 layout) split into hi / lo A fragments, B a
// transposed stage tile (HDW rows x 16 permuted positions); waits.
// The stage's six wgmmas sum into a fresh accumulator, which is then added
// to acc in fp32 (round to nearest): the tensor cores' own additions into
// an fp32 accumulator do not round to nearest, and over the thousands of
// stages of a long sequence (dK and dV sum the group's heads too) their
// one-sided error grew past the gate when acc took them all.
template <int HDW>
__device__ __forceinline__ void issue_pv16(float* acc, const float* x,
                                           uint64_t dthi, uint64_t dtlo) {
  uint32_t hi[2][4], lo[2][4];
  split_frag(x, hi[0], lo[0]);
  split_frag(x + 4, hi[1], lo[1]);
  float part[HDW / 2];
#pragma unroll
  for (int v = 0; v < HDW / 2; ++v) part[v] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    Tf32<HDW>::rs(part, lo[kk], dthi + 2 * kk, kk);
    Tf32<HDW>::rs(part, hi[kk], dtlo + 2 * kk, 1);
    Tf32<HDW>::rs(part, hi[kk], dthi + 2 * kk, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<HDW / 2>(part);
  fence_regs<8>(&hi[0][0]);
  fence_regs<8>(&lo[0][0]);
#pragma unroll
  for (int v = 0; v < HDW / 2; ++v) acc[v] += part[v];
}

// rows row0 + 16 (tq / 32) + lane / 4 (+ 8) of acc (64 x HDW) times
// `scale` into out (rows `rs` floats apart), rows below s, columns below hd
template <int HDW>
__device__ __forceinline__ void store_acc(float* out, long long rs,
                                          const float* acc, float scale,
                                          int row, int s, int hd, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = row + 8 * j;
    if (r >= s) continue;
#pragma unroll
    for (int nt = 0; nt < HDW / 8; ++nt) {
      if (nt * 8 >= hd) break;
      const int col = nt * 8 + 2 * (lane & 3);
      *reinterpret_cast<float2*>(out + r * rs + col) = make_float2(
          acc[4 * nt + 2 * j] * scale, acc[4 * nt + 2 * j + 1] * scale);
    }
  }
}

// P (warpgroup 1) to warpgroup 2 through buffer j % 2
__device__ __forceinline__ void put_p(float* pbuf, const float* p, int j,
                                      int tq) {
  if (j >= 2) named_bar_sync(PEMPTY + (j & 1), 256);
  float* buf = pbuf + (j & 1) * (PBUF / 4);
#pragma unroll
  for (int v = 0; v < 8; ++v) buf[v * 128 + tq] = p[v];
  named_bar_arrive(PFULL + (j & 1), 256);
}

__device__ __forceinline__ void get_p(const float* pbuf, float* p, int j,
                                      int total, int tq) {
  named_bar_sync(PFULL + (j & 1), 256);
  const float* buf = pbuf + (j & 1) * (PBUF / 4);
#pragma unroll
  for (int v = 0; v < 8; ++v) p[v] = buf[v * 128 + tq];
  if (j + 2 < total) named_bar_arrive(PEMPTY + (j & 1), 256);
}

// the pass's barriers: the resident tiles, the ring's full and empty and,
// in a cluster pair, each warpgroup's two exchange buffers' full and empty
// (one arrive from each thread of the peer's warpgroup); then every
// thread of the pair waits, so that no arrive finds a barrier not yet
// initialised
template <int NST, int CL>
__device__ __forceinline__ void init_barriers(uint64_t* bars, int tid) {
  if (tid == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(&bars[1 + s], 1);
      mbar_init(&bars[1 + NST + s], CONSUMER_WARPS);
    }
    if constexpr (CL == 2)
      for (int i = 0; i < 8; ++i) mbar_init(&bars[1 + 2 * NST + i], 128);
    fence_mbar_init();
  }
  if constexpr (CL == 2)
    cluster_sync();
  else
    __syncthreads();
}

// ----------------------------------------------------------------- dkdv ---
// stage tiles: Q hi, Q lo, dO hi, dO lo (16 q rows x HDP), then Q^T hi,
// Q^T lo, dO^T hi, dO^T lo (HDW x 16 permuted q positions)
template <int HDW, int CL>
__global__ void __launch_bounds__(NTHREADS, 1)
dkdv_f32_kernel(const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap qhimap,
                const __grid_constant__ CUtensorMap qlomap,
                const __grid_constant__ CUtensorMap ohimap,
                const __grid_constant__ CUtensorMap olomap,
                const __grid_constant__ CUtensorMap qthimap,
                const __grid_constant__ CUtensorMap qtlomap,
                const __grid_constant__ CUtensorMap othimap,
                const __grid_constant__ CUtensorMap otlomap,
                const BwdParams P) {
  constexpr int NST = 2;
  using T = Tiles<HDW>;
  using L = Layout<HDW, 4, NST, CL>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* res_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = res_full + 1;
  uint64_t* empty = full + NST;
  uint64_t* xfull = empty + NST;      // CL 2: [warpgroup][buffer]
  uint64_t* xempty = xfull + 4;
  float* pbuf = reinterpret_cast<float*>(smem + L::PB);
  float* xbuf = reinterpret_cast<float*>(smem + L::XB);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  init_barriers<NST, CL>(res_full, tid);
  // the head dim's columns hd0 .. hd0 + HDW - 1 of this CTA
  const uint32_t rank = CL == 2 ? cluster_rank() : 0;
  const int hd0 = HDW * static_cast<int>(rank);

  // kv tiles ascending (the longest first under the causal mask)
  const int kvh_n = P.H / P.group;
  const int unit = static_cast<int>(blockIdx.x) / CL;
  const int t = unit / P.lanes;
  const int bk = unit % P.lanes;   // b * KVH + hk
  const int b = bk / kvh_n, hk = bk % kvh_n;
  const int c0 = t * BR, c1 = min(c0 + BR, P.s);
  // the q rows that see a column of the tile
  const int r_lo = P.causal ? c0 : 0;
  const int r_hi = P.window > 0 ? min(P.s, c1 - 1 + P.window) : P.s;
  const int nqt = (r_hi - r_lo + NS - 1) / NS;
  const int total = P.group * nqt;

  if (wg == 0) {
    reg_dealloc<24>();
    if (tid == 0) {
      mbar_expect_tx(res_full, 2 * T::RBYTES);
      for (int j = 0; j < T::HDP / 32; ++j) {
        tma_load_4d(smem + L::RES + j * T::RBOX, &kmap, res_full,
                    hd0 + 32 * j, c0, hk, b);
        tma_load_4d(smem + L::RES + T::RBYTES + j * T::RBOX, &vmap, res_full,
                    hd0 + 32 * j, c0, hk, b);
      }
      for (int i = 0; i < total; ++i) {
        const int s = i % NST;
        const int h = hk * P.group + i / nqt;
        const int rq0 = r_lo + (i % nqt) * NS;
        unsigned char* st = smem + L::ST + s * L::STAGE;
        mbar_wait(&empty[s], ((i / NST) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::STAGE);
        const CUtensorMap* rows[4] = {&qhimap, &qlomap, &ohimap, &olomap};
        for (int a = 0; a < 4; ++a)
          for (int j = 0; j < T::HDP / 32; ++j)
            tma_load_4d(st + a * T::SBYTES + j * T::SBOX, rows[a], &full[s],
                        hd0 + 32 * j, rq0, h, b);
        const CUtensorMap* cols[4] = {&qthimap, &qtlomap, &othimap, &otlomap};
        for (int a = 0; a < 4; ++a)
          tma_load_4d(st + 4 * T::SBYTES + a * T::TBYTES, cols[a], &full[s],
                      rq0, hd0, h, b);
      }
    }
  } else {
    reg_alloc<240>();
    // c 0: S^T = K Q^T -> P^T -> dV += P^T dO;
    // c 1: dP^T = V dO^T -> dS^T = P^T (dP^T - D) -> dK += dS^T Q
    const int c = wg - 1;
    const int tq = tid % 128;
    const int lane = tid % 32;
    const int kv_lo = c0 + 16 * (tq / 32) + lane / 4;   // and kv_lo + 8
    unsigned char* res = smem + L::RES + c * T::RBYTES;

    float acc[HDW / 2];
#pragma unroll
    for (int v = 0; v < HDW / 2; ++v) acc[v] = 0.f;
    mbar_wait(res_full, 0);
    uint32_t ahi[HDW / 8][4];
    split_resident<HDW>(res, T::RBOX, 0, ahi, tq, RSPLIT + c);
    const uint64_t da = smem_desc(res, 16, 1024);
    // the B tiles of this warpgroup: rows (Q or dO) and columns (dO^T or
    // Q^T) of the stage
    const int brow = c == 0 ? 0 : 2 * T::SBYTES;
    const int bcol = 4 * T::SBYTES + (c == 0 ? 2 : 0) * T::TBYTES;

    for (int i = 0; i < total; ++i) {
      const int s = i % NST;
      const int h = hk * P.group + i / nqt;
      const int rq0 = r_lo + (i % nqt) * NS;
      unsigned char* st = smem + L::ST + s * L::STAGE;
      // lse log2(e) (c 0) or D (c 1) of this thread's four q columns
      const float* rowv = (c == 0 ? P.lse : P.delta) +
                          (static_cast<long long>(b) * P.H + h) * P.s;
      float cv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rq0 + 8 * (e >> 1) + 2 * (lane & 3) + (e & 1);
        cv[e] = r < P.s ? rowv[r] : 0.f;
      }
      mbar_wait(&full[s], (i / NST) & 1);
      float sacc[8];
      issue_s16<HDW>(sacc, ahi, da, smem_desc(st + brow, 16, 1024),
                     smem_desc(st + brow + T::SBYTES, 16, 1024));
      if constexpr (CL == 2)
        exchange<8>(sacc, xbuf + c * (PBUF / 2), xfull + 2 * c,
                    xempty + 2 * c, i, total, tq, rank ^ 1);
      float x[8];
      if (c == 0) {
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          const int kv = kv_lo + 8 * ((v >> 1) & 1);
          const int r = rq0 + 8 * (v >> 2) + 2 * (lane & 3) + (v & 1);
          const int e = 2 * (v >> 2) + (v & 1);
          x[v] = live(P, r, kv)
                     ? fast_exp2(fmaf(sacc[v], P.scale_log2, -cv[e] * LOG2E))
                     : 0.f;
        }
        put_p(pbuf, x, i, tq);
      } else {
        float p[8];
        get_p(pbuf, p, i, total, tq);
#pragma unroll
        for (int v = 0; v < 8; ++v)
          x[v] = p[v] * (sacc[v] - cv[2 * (v >> 2) + (v & 1)]);
      }
      issue_pv16<HDW>(acc, x, smem_desc_sw64(st + bcol),
                      smem_desc_sw64(st + bcol + T::TBYTES));
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    const int kvh_rs = kvh_n * P.hd;
    float* out = (c == 0 ? P.out0 : P.out1) +
                 static_cast<long long>(b) * P.s * kvh_rs + hk * P.hd + hd0;
    store_acc<HDW>(out, kvh_rs, acc, c == 0 ? 1.f : P.scale, kv_lo, P.s,
                   P.hd - hd0, lane);
  }
}

// ------------------------------------------------------------------- dq ---
// stage tiles: K hi, K lo, V hi, V lo (16 kv rows x HDP), then K^T hi,
// K^T lo (HDW x 16 permuted kv positions)
template <int HDW, int CL>
__global__ void __launch_bounds__(NTHREADS, 1)
dq_f32_kernel(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap omap,
              const __grid_constant__ CUtensorMap khimap,
              const __grid_constant__ CUtensorMap klomap,
              const __grid_constant__ CUtensorMap vhimap,
              const __grid_constant__ CUtensorMap vlomap,
              const __grid_constant__ CUtensorMap kthimap,
              const __grid_constant__ CUtensorMap ktlomap,
              const BwdParams P) {
  constexpr int NST = dq_stages(CL);
  using T = Tiles<HDW>;
  using L = Layout<HDW, 2, NST, CL>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* res_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = res_full + 1;
  uint64_t* empty = full + NST;
  uint64_t* xfull = empty + NST;      // CL 2: [warpgroup][buffer]
  uint64_t* xempty = xfull + 4;
  float* pbuf = reinterpret_cast<float*>(smem + L::PB);
  float* xbuf = reinterpret_cast<float*>(smem + L::XB);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  init_barriers<NST, CL>(res_full, tid);
  const uint32_t rank = CL == 2 ? cluster_rank() : 0;
  const int hd0 = HDW * static_cast<int>(rank);

  // bottom (longest) q tiles first
  const int unit = static_cast<int>(blockIdx.x) / CL;
  const int qt = P.ntile - 1 - unit / P.lanes;
  const int lane_id = unit % P.lanes;
  const int b = lane_id / P.H, h = lane_id % P.H, hk = h / P.group;
  const int r0 = qt * BR;
  const int c_lo = P.window > 0 ? max(0, r0 - P.window + 1) / NS * NS : 0;
  const int c_hi = P.causal ? min(r0 + BR, P.s) : P.s;
  const int total = (c_hi - c_lo + NS - 1) / NS;

  if (wg == 0) {
    reg_dealloc<24>();
    if (tid == 0) {
      mbar_expect_tx(res_full, 2 * T::RBYTES);
      for (int j = 0; j < T::HDP / 32; ++j) {
        tma_load_4d(smem + L::RES + j * T::RBOX, &qmap, res_full,
                    hd0 + 32 * j, r0, h, b);
        tma_load_4d(smem + L::RES + T::RBYTES + j * T::RBOX, &omap, res_full,
                    hd0 + 32 * j, r0, h, b);
      }
      for (int i = 0; i < total; ++i) {
        const int s = i % NST;
        const int col0 = c_lo + i * NS;
        unsigned char* st = smem + L::ST + s * L::STAGE;
        mbar_wait(&empty[s], ((i / NST) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::STAGE);
        const CUtensorMap* rows[4] = {&khimap, &klomap, &vhimap, &vlomap};
        for (int a = 0; a < 4; ++a)
          for (int j = 0; j < T::HDP / 32; ++j)
            tma_load_4d(st + a * T::SBYTES + j * T::SBOX, rows[a], &full[s],
                        hd0 + 32 * j, col0, hk, b);
        tma_load_4d(st + 4 * T::SBYTES, &kthimap, &full[s], col0, hd0, hk, b);
        tma_load_4d(st + 4 * T::SBYTES + T::TBYTES, &ktlomap, &full[s], col0,
                    hd0, hk, b);
      }
    }
  } else {
    reg_alloc<240>();
    // c 0: S = Q K^T -> P; c 1: dP = dO V^T -> dS = P (dP - D) -> dQ += dS K
    const int c = wg - 1;
    const int tq = tid % 128;
    const int lane = tid % 32;
    const int r_row = r0 + 16 * (tq / 32) + lane / 4;   // and r_row + 8
    unsigned char* res = smem + L::RES + c * T::RBYTES;
    // lse log2(e) (c 0) or D (c 1) of this thread's two rows
    const float* rowv = (c == 0 ? P.lse : P.delta) +
                        static_cast<long long>(lane_id) * P.s;
    float rv[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = r_row + 8 * j;
      rv[j] = r < P.s ? rowv[r] * (c == 0 ? LOG2E : 1.f) : 0.f;
    }

    mbar_wait(res_full, 0);
    uint32_t ahi[HDW / 8][4];
    split_resident<HDW>(res, T::RBOX, 0, ahi, tq, RSPLIT + c);
    const uint64_t da = smem_desc(res, 16, 1024);

    if (c == 0) {
      for (int i = 0; i < total; ++i) {
        const int s = i % NST;
        const int col0 = c_lo + i * NS;
        unsigned char* st = smem + L::ST + s * L::STAGE;
        mbar_wait(&full[s], (i / NST) & 1);
        float sacc[8];
        issue_s16<HDW>(sacc, ahi, da, smem_desc(st, 16, 1024),
                       smem_desc(st + T::SBYTES, 16, 1024));
        if (lane == 0) mbar_arrive(&empty[s]);
        if constexpr (CL == 2)
          exchange<8>(sacc, xbuf, xfull, xempty, i, total, tq, rank ^ 1);
        float p[8];
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          const int r = r_row + 8 * ((v >> 1) & 1);
          const int col = col0 + 8 * (v >> 2) + 2 * (lane & 3) + (v & 1);
          p[v] = live(P, r, col)
                     ? fast_exp2(fmaf(sacc[v], P.scale_log2, -rv[(v >> 1) & 1]))
                     : 0.f;
        }
        put_p(pbuf, p, i, tq);
      }
    } else {
      float acc[HDW / 2];
#pragma unroll
      for (int v = 0; v < HDW / 2; ++v) acc[v] = 0.f;
      for (int i = 0; i < total; ++i) {
        const int s = i % NST;
        unsigned char* st = smem + L::ST + s * L::STAGE;
        mbar_wait(&full[s], (i / NST) & 1);
        float dp[8];
        issue_s16<HDW>(dp, ahi, da, smem_desc(st + 2 * T::SBYTES, 16, 1024),
                       smem_desc(st + 3 * T::SBYTES, 16, 1024));
        if constexpr (CL == 2)
          exchange<8>(dp, xbuf + PBUF / 2, xfull + 2, xempty + 2, i, total,
                      tq, rank ^ 1);
        float p[8];
        get_p(pbuf, p, i, total, tq);
#pragma unroll
        for (int v = 0; v < 8; ++v) dp[v] = p[v] * (dp[v] - rv[(v >> 1) & 1]);
        issue_pv16<HDW>(acc, dp, smem_desc_sw64(st + 4 * T::SBYTES),
                        smem_desc_sw64(st + 4 * T::SBYTES + T::TBYTES));
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      const long long q_rs = static_cast<long long>(P.H) * P.hd;
      float* out =
          P.out0 + static_cast<long long>(b) * P.s * q_rs + h * P.hd + hd0;
      store_acc<HDW>(out, q_rs, acc, P.scale, r_row, P.s, P.hd - hd0, lane);
    }
  }
}

// a contiguous (b, s, heads, hd) tensor as 64-row (resident) or 16-row
// (stage) boxes
inline int encode_bshd(CUtensorMap* map, const void* base, int batch, int s,
                       int heads, int hd, int rows) {
  const long long rs = static_cast<long long>(heads) * hd;
  return encode_rows(map, base, batch, s, heads, hd, s * rs, hd, rs, rows);
}

template <int HDW, int CL>
int launch_dkdv(const float* const* in, float* ws, BwdParams P, int batch,
                int s_pad, cudaStream_t st) {
  // in: q, k, v, dout; ws: Q hi, Q lo, dO hi, dO lo, Q^T hi, Q^T lo,
  // dO^T hi, dO^T lo
  const int kvh = P.H / P.group;
  const long long n = static_cast<long long>(batch) * P.s * P.H * P.hd;
  const long long nt = static_cast<long long>(batch) * P.H * P.hd * s_pad;
  float* w[8];
  for (int i = 0; i < 4; ++i) w[i] = ws + i * n;
  for (int i = 0; i < 4; ++i) w[4 + i] = ws + 4 * n + i * nt;
  CUtensorMap m[10];
  int rc = encode_bshd(&m[0], in[1], batch, P.s, kvh, P.hd, BR);
  if (rc == 0) rc = encode_bshd(&m[1], in[2], batch, P.s, kvh, P.hd, BR);
  for (int i = 0; i < 4 && rc == 0; ++i)
    rc = encode_bshd(&m[2 + i], w[i], batch, P.s, P.H, P.hd, NS);
  for (int i = 0; i < 4 && rc == 0; ++i)
    rc = encode_cols(&m[6 + i], w[4 + i], batch, P.H, P.hd, s_pad, NS, HDW);
  if (rc != 0) return rc;
  P.lanes = batch * kvh;
  P.ntile = (P.s + BR - 1) / BR;
  return launch_clusters<CL>(dkdv_f32_kernel<HDW, CL>,
                             static_cast<unsigned>(CL * P.lanes * P.ntile),
                             NTHREADS, Layout<HDW, 4, 2, CL>::BYTES, st, m[0],
                             m[1], m[2], m[3], m[4], m[5], m[6], m[7], m[8],
                             m[9], P);
}

template <int HDW, int CL>
int launch_dq(const float* const* in, float* ws, BwdParams P, int batch,
              int s_pad, cudaStream_t st) {
  // in: q, k, v, dout; ws: K hi, K lo, V hi, V lo, K^T hi, K^T lo
  const int kvh = P.H / P.group;
  const long long n = static_cast<long long>(batch) * P.s * kvh * P.hd;
  const long long nt = static_cast<long long>(batch) * kvh * P.hd * s_pad;
  float* w[6];
  for (int i = 0; i < 4; ++i) w[i] = ws + i * n;
  for (int i = 0; i < 2; ++i) w[4 + i] = ws + 4 * n + i * nt;
  CUtensorMap m[8];
  int rc = encode_bshd(&m[0], in[0], batch, P.s, P.H, P.hd, BR);
  if (rc == 0) rc = encode_bshd(&m[1], in[3], batch, P.s, P.H, P.hd, BR);
  for (int i = 0; i < 4 && rc == 0; ++i)
    rc = encode_bshd(&m[2 + i], w[i], batch, P.s, kvh, P.hd, NS);
  for (int i = 0; i < 2 && rc == 0; ++i)
    rc = encode_cols(&m[6 + i], w[4 + i], batch, kvh, P.hd, s_pad, NS, HDW);
  if (rc != 0) return rc;
  P.lanes = batch * P.H;
  P.ntile = (P.s + BR - 1) / BR;
  return launch_clusters<CL>(dq_f32_kernel<HDW, CL>,
                             static_cast<unsigned>(CL * P.lanes * P.ntile),
                             NTHREADS, Layout<HDW, 2, dq_stages(CL), CL>::BYTES,
                             st, m[0], m[1], m[2], m[3], m[4], m[5], m[6],
                             m[7], P);
}

// split the pass's stage operands into ws, then run the pass: head dims up
// to 128, or (wide) 136-256 on cluster pairs
int launch(int pass, bool wide, const void* q, const void* k, const void* v,
           const void* dout, const void* lse, const void* delta, void* out0,
           void* out1, void* ws, int s_pad, int batch, int s, int H,
           int group, int hd, int causal, int window, float scale,
           void* stream) {
  if (batch <= 0 || s <= 0 || H <= 0 || group <= 0 || H % group != 0 ||
      hd <= (wide ? 128 : 0) || hd > (wide ? 256 : 128) || hd % 8 != 0 ||
      s_pad < s || s_pad % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kvh = H / group;
  const float* in[4] = {static_cast<const float*>(q),
                        static_cast<const float*>(k),
                        static_cast<const float*>(v),
                        static_cast<const float*>(dout)};
  float* w = static_cast<float*>(ws);
  // the splits: dkdv Q and dO (both layouts), dq K (both) and V (rows)
  const int heads = pass == 0 ? H : kvh;
  const long long n = static_cast<long long>(batch) * s * heads * hd;
  const long long nt = static_cast<long long>(batch) * heads * hd * s_pad;
  const long long rs = static_cast<long long>(heads) * hd;
  for (int a = 0; a < 2; ++a) {
    const float* src = pass == 0 ? in[3 * a] : in[1 + a];
    SplitParams sp{src, s * rs, hd, rs, w + 2 * a * n, w + (2 * a + 1) * n,
                   nullptr, nullptr, s, heads, hd, s_pad};
    if (pass == 0 || a == 0) {
      sp.thi = w + 4 * n + 2 * a * nt;
      sp.tlo = sp.thi + nt;
    }
    const int rc = split_launch(sp, batch, st);
    if (rc != 0) return rc;
  }
  BwdParams P{};
  P.lse = static_cast<const float*>(lse);
  P.delta = static_cast<const float*>(delta);
  P.out0 = static_cast<float*>(out0);
  P.out1 = static_cast<float*>(out1);
  P.s = s; P.H = H; P.group = group; P.hd = hd;
  P.causal = causal; P.window = window;
  P.scale = scale;
  P.scale_log2 = scale * LOG2E;
  if (pass == 0) {
    if (wide) return launch_dkdv<128, 2>(in, w, P, batch, s_pad, st);
    if (hd <= 64) return launch_dkdv<64, 1>(in, w, P, batch, s_pad, st);
    if (hd <= 80) return launch_dkdv<80, 1>(in, w, P, batch, s_pad, st);
    return launch_dkdv<128, 1>(in, w, P, batch, s_pad, st);
  }
  if (wide) return launch_dq<128, 2>(in, w, P, batch, s_pad, st);
  if (hd <= 64) return launch_dq<64, 1>(in, w, P, batch, s_pad, st);
  if (hd <= 80) return launch_dq<80, 1>(in, w, P, batch, s_pad, st);
  return launch_dq<128, 1>(in, w, P, batch, s_pad, st);
}

}  // namespace

// dK, dV (b, s, kvh, hd) of q (b, s, h, hd), k, v (b, s, kvh, hd), dout,
// the forward's lse and D (b, h, s); all contiguous fp32.  ws: scratch of
// 4 (b s h hd) + 4 (b h hd s_pad) floats, s_pad a multiple of 32 at least
// s (the caller's, so that it sizes the scratch it passes).
extern "C" int flash_f32_bwd_dkdv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, void* ws,
    int s_pad, int batch, int s, int H, int group, int hd, int causal,
    int window, float scale, void* stream) {
  return launch(0, false, q, k, v, dout, lse, delta, dv, dk, ws, s_pad,
                batch, s, H, group, hd, causal, window, scale, stream);
}

// dQ (b, s, h, hd), as dkdv; ws: scratch of 4 (b s kvh hd) + 2 (b kvh hd
// s_pad) floats
extern "C" int flash_f32_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* ws, int s_pad,
    int batch, int s, int H, int group, int hd, int causal, int window,
    float scale, void* stream) {
  return launch(1, false, q, k, v, dout, lse, delta, dq, nullptr, ws, s_pad,
                batch, s, H, group, hd, causal, window, scale, stream);
}

// the same two passes at head dims 136-256 (multiples of 8), on cluster
// pairs; the same arguments and scratch
extern "C" int flash_f32_bwd256_dkdv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, void* ws,
    int s_pad, int batch, int s, int H, int group, int hd, int causal,
    int window, float scale, void* stream) {
  return launch(0, true, q, k, v, dout, lse, delta, dv, dk, ws, s_pad, batch,
                s, H, group, hd, causal, window, scale, stream);
}

extern "C" int flash_f32_bwd256_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* ws, int s_pad,
    int batch, int s, int H, int group, int hd, int causal, int window,
    float scale, void* stream) {
  return launch(1, true, q, k, v, dout, lse, delta, dq, nullptr, ws, s_pad,
                batch, s, H, group, hd, causal, window, scale, stream);
}

extern "C" const char* flash_f32_bwd_error_string(int code) {
  return error_string(code);
}
