// The consumer side of the Hopper (sm_90a) flash-attention kernels, shared by
// flash_dense.cu (dense causal / sliding-window grid) and flash_sched.cu
// (persistent, over the DLS plan's descriptors).
//
// A CTA has three warpgroups: warpgroup 0 holds the producer thread, which
// loads a 128-row Q tile and NKV-column K / V tiles with TMA into a ring of
// NSTAGES stages (128 and 3 unless a kernel asks for others: flash_dense
// takes 64 and 2 at head dim 256); warpgroups 1 and 2 (the consumers) own q
// rows 0-63 and 64-127 of the tile.  Per kv tile a consumer runs
//   * S = Q K^T with wgmma.m64n{NKV}k16 from shared memory (Q and K K-major),
//     the two consumers taking turns to issue it on named barriers TURN and
//     TURN + 1, so that the tensor cores work for one while the other runs
//     its softmax (issue_s);
//   * the online softmax in registers in the log2 domain (softmax), with
//     the mask arithmetic only where the caller says the tile needs it;
//   * O += P V with two RS wgmmas (four at head dim 256: two n128 halves),
//     P = hi + lo in the element type kept fp32 as in the reference, V
//     MN-major through the transpose bit (issue_pv);
// and writes out = o / l from the accumulators (store_rows).  The tiles
// have a padded head dim (64, 128 or 256): columns past the real head dim
// arrive as zeros from TMA and are not written.  The products run at a
// width HDW, the padded head dim or, for head dim 80 (tiles of 128),
// exactly 80: S = Q K^T takes ceil(HDW / 16) k steps (the steps dropped
// would add only products of zeros) and O += P V one m64n80 (its columns
// are the first 80 of the m64n128), so o holds HDW / 2 floats a thread.
//
// Every piece takes the element type T of q, k, v and the output:
// __nv_bfloat16 (the default) or __half, with
// wgmma's .bf16 or .f16; the accumulators and the softmax are fp32 in both.
//
// Every block here is inline: an out-of-line block shared by the producer
// and the consumers would make ptxas compile both roles for the launch's
// register allocation, whatever setmaxnreg gives them at run time.

#pragma once

#include "hopper_common.cuh"

namespace flash_hopper {

using namespace hopper;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 128;                 // q rows of a tile
constexpr int BKV = 128;                // kv columns of a tile (default)
constexpr int NTHREADS = 384;           // producer + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int BOX = 128 * 128;          // one Q box: 128 rows x 64 T
constexpr int TURN = 1;                 // named barriers 1, 2: the turns
constexpr int STAGES = 3;               // K / V tiles in flight (default)

// Shared memory of a CTA: one Q tile, NSTAGES K and V tiles of NKV rows,
// then the mbarriers q_full, q_empty, k_full[], v_full[], empty[].  At the
// defaults a K / V tile is as large as the Q tile (TILE == KVTILE).
template <int HD, int NKV = BKV, int NSTAGES = STAGES>
struct Layout {
  static constexpr int NBOX = HD / 64;              // boxes per tile
  static constexpr int TILE = NBOX * BOX;           // the Q tile
  static constexpr int KVBOX = NKV * 128;           // NKV rows x 64 T
  static constexpr int KVTILE = NBOX * KVBOX;
  static constexpr int Q = 0;
  static constexpr int K = Q + TILE;                // NSTAGES tiles
  static constexpr int V = K + NSTAGES * KVTILE;    // NSTAGES tiles
  static constexpr int BAR = V + NSTAGES * KVTILE;
  static constexpr int BYTES = BAR + (2 + 3 * NSTAGES) * 8 + 1024;  // + align
};

// 2^x in one MUFU instruction (results below 2^-126 flush to 0; ex2(0) is 1)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// scores of this thread (m64n{NKV} accumulator layout) -> P = exp2(S scale
// log2(e) - m) as T hi / lo A fragments of the NKV / 16 16-column slices;
// updates m, l (log2 domain) and rescales o (HDW / 2 floats).  MASK:
// columns >= P.s, above
// the diagonal (P.causal) or outside the window (P.window) get NEG_INF
// first; without it the scale is folded into one FFMA per score.  MP is
// any type with the fields s, causal, window and scale_log2.
template <int HDW, bool MASK, int NKV = BKV, typename T = __nv_bfloat16,
          class MP>
__device__ __forceinline__ void softmax(float* sacc, float (&m)[2],
                                        float (&l)[2], float* o,
                                        uint32_t (&phi)[NKV / 16][4],
                                        uint32_t (&plo)[NKV / 16][4], int col0,
                                        int r_lo, int lane, const MP& P) {
  float mx[2];
  if constexpr (MASK) {
    mx[0] = m[0];
    mx[1] = m[1];
#pragma unroll
    for (int v = 0; v < NKV / 2; ++v) {
      const int row = r_lo + 8 * ((v >> 1) & 1);
      const int col = col0 + 8 * (v >> 2) + 2 * (lane & 3) + (v & 1);
      bool ok = col < P.s;
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
  for (int kk = 0; kk < NKV / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = 8 * kk + 2 * i;
      const float mj = mx[i & 1];
      const float p0 = MASK ? fast_exp2(sacc[v] - mj)
                            : fast_exp2(fmaf(sacc[v], P.scale_log2, -mj));
      const float p1 = MASK ? fast_exp2(sacc[v + 1] - mj)
                            : fast_exp2(fmaf(sacc[v + 1], P.scale_log2, -mj));
      rs[i & 1] += p0 + p1;
      // fp32 p = hi + lo, both T
      phi[kk][i] = pack2<T>(p0, p1);
      const float2 hf = unpack2<T>(phi[kk][i]);
      plo[kk][i] = pack2<T>(p0 - hf.x, p1 - hf.y);
    }
  }
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

// S = Q K^T for consumer c's 64 rows (dq: its rows of the Q tile, dk: the
// K stage of NKV rows), on its turn: wait for it (named barrier TURN + c),
// issue, hand the turn to the other consumer, wait for the result.  The K
// stage must have landed.  A 16-wide k step moves 32 bytes inside a
// 64-column box; the next box of Q is BOX bytes on, of K NKV * 128.  The
// depth is HDW columns, ceil(HDW / 16) k steps.
template <int HDW, int NKV = BKV, typename T = __nv_bfloat16>
__device__ __forceinline__ void issue_s(float* sacc, uint64_t dq, uint64_t dk,
                                        int c) {
  named_bar_sync(TURN + c, 256);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < (HDW + 15) / 16; ++kk) {
    const int off = (kk / 4) * (BOX / 16) + (kk % 4) * 2;
    const int koff = (kk / 4) * (NKV * 128 / 16) + (kk % 4) * 2;
    if constexpr (NKV == 128)
      wgmma_m64n128k16_ss<0, 0, T>(sacc, dq + off, dk + koff, kk);
    else
      wgmma_m64n64k16_ss<0, 0, T>(sacc, dq + off, dk + koff, kk);
  }
  wgmma_commit();
  named_bar_arrive(TURN + 1 - c, 256);
  wgmma_wait<0>();
  fence_regs<NKV / 2>(sacc);
}

// O += (P_hi + P_lo) V for an NKV-row V stage (dv, MN-major: 64-column
// boxes NKV * 128 bytes apart), then wait.  At HDW 256 the output is two
// n128 halves, accumulators o[0..63] (columns 0-127, boxes 0-1) and
// o[64..127] (columns 128-255, boxes 2-3): the layout of one m64n256.  At
// HDW 80 it is one n80 over box 0 and the first 16 columns of box 1.
template <int HDW, int NKV = BKV, typename T = __nv_bfloat16>
__device__ __forceinline__ void issue_pv(float* o, uint32_t (&phi)[NKV / 16][4],
                                         uint32_t (&plo)[NKV / 16][4],
                                         uint64_t dv) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NKV / 16; ++kk) {
    if constexpr (HDW == 256) {
      constexpr int half = 2 * NKV * 128 / 16;      // two boxes on
      wgmma_m64n128k16_rs<1, T>(o, phi[kk], dv + 128 * kk, 1);
      wgmma_m64n128k16_rs<1, T>(o + 64, phi[kk], dv + half + 128 * kk, 1);
      wgmma_m64n128k16_rs<1, T>(o, plo[kk], dv + 128 * kk, 1);
      wgmma_m64n128k16_rs<1, T>(o + 64, plo[kk], dv + half + 128 * kk, 1);
    } else if constexpr (HDW == 128) {
      wgmma_m64n128k16_rs<1, T>(o, phi[kk], dv + 128 * kk, 1);
      wgmma_m64n128k16_rs<1, T>(o, plo[kk], dv + 128 * kk, 1);
    } else if constexpr (HDW == 80) {
      wgmma_m64n80k16_rs<1, T>(o, phi[kk], dv + 128 * kk, 1);
      wgmma_m64n80k16_rs<1, T>(o, plo[kk], dv + 128 * kk, 1);
    } else {
      wgmma_m64n64k16_rs<1, T>(o, phi[kk], dv + 128 * kk, 1);
      wgmma_m64n64k16_rs<1, T>(o, plo[kk], dv + 128 * kk, 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<HDW / 2>(o);
  fence_regs<NKV / 4>(&phi[0][0]);
  fence_regs<NKV / 4>(&plo[0][0]);
}

// out = o / l as T for this thread's rows r_lo and r_lo + 8 that lie
// below row_end and its columns below hd, a multiple of 8 (ob: the
// (row, hd) plane of the output head, rows o_ss apart; o holds HDW
// columns); rows that never saw a live column (m <= NEG_INF / 2) are
// written as 0
template <int HDW, typename T = __nv_bfloat16>
__device__ __forceinline__ void store_rows(T* ob, long long o_ss,
                                           const float* o, const float (&m)[2],
                                           const float (&l)[2], int r_lo,
                                           int row_end, int lane, int hd) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = r_lo + 8 * j;
    if (row >= row_end) continue;
    const float inv = m[j] > NEG_INF * 0.5f
                          ? __fdividef(1.f, fmaxf(l[j], 1e-30f)) : 0.f;
#pragma unroll
    for (int nt = 0; nt < HDW / 8; ++nt) {
      if (nt * 8 >= hd) break;
      const int col = nt * 8 + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(ob + row * o_ss + col) =
          pack2<T>(o[4 * nt + 2 * j] * inv, o[4 * nt + 2 * j + 1] * inv);
    }
  }
}

// q / k / v (b, s, heads, hd) of the dtype code `dtype` (bf16 or fp16) by
// element strides -> a 4-D map with boxes of 64 hd x `rows` rows of one
// head; a box reaching past hd or s is filled with zeros (and still counts
// its full size towards expect_tx)
inline int encode_bshd(CUtensorMap* map, const void* base, int dtype,
                       int batch, int s, int heads, int hd, long long sb,
                       long long sh, long long ss, int rows = 128) {
  using u64 = cuuint64_t;
  const u64 dims[4] = {(u64)hd, (u64)s, (u64)heads, (u64)batch};
  const u64 strides[3] = {(u64)ss * 2, (u64)sh * 2, (u64)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return encode_tiled(map, base, 4, dims, strides, box, dtype);
}

}  // namespace flash_hopper
