// The consumer side of the Hopper (sm_90a) flash-attention kernels, shared by
// flash_dense.cu (dense causal / sliding-window grid) and flash_sched.cu
// (persistent, over the DLS plan's descriptors).
//
// A CTA has three warpgroups: warpgroup 0 holds the producer thread, which
// loads a 128-row Q tile and 128-column K / V tiles with TMA into a ring of
// STAGES stages; warpgroups 1 and 2 (the consumers) own q rows 0-63 and
// 64-127 of the tile.  Per kv tile a consumer runs
//   * S = Q K^T with wgmma.m64n128k16 from shared memory (Q and K K-major),
//     the two consumers taking turns to issue it on named barriers TURN and
//     TURN + 1, so that the tensor cores work for one while the other runs
//     its softmax (issue_s);
//   * the online softmax in registers in the log2 domain (softmax), with
//     the mask arithmetic only where the caller says the tile needs it;
//   * O += P V with two RS wgmmas, P = hi + lo in bf16 kept fp32 as in the
//     reference, V MN-major through the transpose bit (issue_pv);
// and writes out = o / l from the accumulators (store_rows).
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
constexpr int BKV = 128;                // kv columns of a tile
constexpr int NTHREADS = 384;           // producer + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int BOX = 128 * 128;          // one box: 128 rows x 64 bf16
constexpr int TURN = 1;                 // named barriers 1, 2: the turns
constexpr int STAGES = 3;               // K / V tiles in flight

// Shared memory of a CTA: one Q tile, STAGES K and V tiles, then the
// mbarriers q_full, q_empty, k_full[], v_full[], empty[].
template <int HD>
struct Layout {
  static constexpr int NBOX = HD / 64;              // boxes per tile
  static constexpr int TILE = NBOX * BOX;
  static constexpr int Q = 0;
  static constexpr int K = Q + TILE;                // STAGES tiles
  static constexpr int V = K + STAGES * TILE;       // STAGES tiles
  static constexpr int BAR = V + STAGES * TILE;
  static constexpr int BYTES = BAR + (2 + 3 * STAGES) * 8 + 1024;  // + align
};

// 2^x in one MUFU instruction (results below 2^-126 flush to 0; ex2(0) is 1)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// scores of this thread (m64n128 accumulator layout) -> P = exp2(S scale
// log2(e) - m) as bf16 hi / lo A fragments of the eight 16-column slices;
// updates m, l (log2 domain) and rescales o.  MASK: columns >= P.s, above
// the diagonal (P.causal) or outside the window (P.window) get NEG_INF
// first; without it the scale is folded into one FFMA per score.  MP is
// any type with the fields s, causal, window and scale_log2.
template <int HD, bool MASK, class MP>
__device__ __forceinline__ void softmax(float* sacc, float (&m)[2],
                                        float (&l)[2], float* o,
                                        uint32_t (&phi)[8][4],
                                        uint32_t (&plo)[8][4], int col0,
                                        int r_lo, int lane, const MP& P) {
  float mx[2];
  if constexpr (MASK) {
    mx[0] = m[0];
    mx[1] = m[1];
#pragma unroll
    for (int v = 0; v < 64; ++v) {
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
    for (int v = 0; v < 64; ++v)
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
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = 8 * kk + 2 * i;
      const float mj = mx[i & 1];
      const float p0 = MASK ? fast_exp2(sacc[v] - mj)
                            : fast_exp2(fmaf(sacc[v], P.scale_log2, -mj));
      const float p1 = MASK ? fast_exp2(sacc[v + 1] - mj)
                            : fast_exp2(fmaf(sacc[v + 1], P.scale_log2, -mj));
      rs[i & 1] += p0 + p1;
      // fp32 p = hi + lo, both bf16
      __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(h);
      __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
      phi[kk][i] = *reinterpret_cast<uint32_t*>(&h);
      plo[kk][i] = *reinterpret_cast<uint32_t*>(&lo);
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
  for (int v = 0; v < HD / 2; ++v) o[v] *= corr[(v >> 1) & 1];
}

// S = Q K^T for consumer c's 64 rows (dq: its rows of the Q tile, dk: the
// K stage), on its turn: wait for it (named barrier TURN + c), issue, hand
// the turn to the other consumer, wait for the result.  The K stage must
// have landed.
template <int HD>
__device__ __forceinline__ void issue_s(float* sacc, uint64_t dq, uint64_t dk,
                                        int c) {
  named_bar_sync(TURN + c, 256);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int off = (kk / 4) * (BOX / 16) + (kk % 4) * 2;
    wgmma_m64n128k16_ss<0>(sacc, dq + off, dk + off, kk);
  }
  wgmma_commit();
  named_bar_arrive(TURN + 1 - c, 256);
  wgmma_wait<0>();
  fence_regs<64>(sacc);
}

// O += (P_hi + P_lo) V for a 128-column V stage (dv, MN-major), then wait
template <int HD>
__device__ __forceinline__ void issue_pv(float* o, uint32_t (&phi)[8][4],
                                         uint32_t (&plo)[8][4], uint64_t dv) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if constexpr (HD == 128) {
      wgmma_m64n128k16_rs<1>(o, phi[kk], dv + 128 * kk, 1);
      wgmma_m64n128k16_rs<1>(o, plo[kk], dv + 128 * kk, 1);
    } else {
      wgmma_m64n64k16_rs<1>(o, phi[kk], dv + 128 * kk, 1);
      wgmma_m64n64k16_rs<1>(o, plo[kk], dv + 128 * kk, 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<HD / 2>(o);
  fence_regs<32>(&phi[0][0]);
  fence_regs<32>(&plo[0][0]);
}

// out = o / l as bf16 for this thread's rows r_lo and r_lo + 8 that lie
// below row_end (ob: the (row, hd) plane of the output head, rows o_ss
// apart); rows that never saw a live column (m <= NEG_INF / 2) are
// written as 0
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* ob, long long o_ss,
                                           const float* o, const float (&m)[2],
                                           const float (&l)[2], int r_lo,
                                           int row_end, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = r_lo + 8 * j;
    if (row >= row_end) continue;
    const float inv = m[j] > NEG_INF * 0.5f
                          ? __fdividef(1.f, fmaxf(l[j], 1e-30f)) : 0.f;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const int col = nt * 8 + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(ob + row * o_ss + col) =
          pack_bf16(o[4 * nt + 2 * j] * inv, o[4 * nt + 2 * j + 1] * inv);
    }
  }
}

// q / k / v (b, s, heads, hd) by element strides -> a 4-D map with boxes of
// 64 hd x 128 rows of one head
inline int encode_bshd(CUtensorMap* map, const void* base, int batch, int s,
                       int heads, int hd, long long sb, long long sh,
                       long long ss) {
  using u64 = cuuint64_t;
  const u64 dims[4] = {(u64)hd, (u64)s, (u64)heads, (u64)batch};
  const u64 strides[3] = {(u64)ss * 2, (u64)sh * 2, (u64)sb * 2};
  const cuuint32_t box[4] = {64, 128, 1, 1};
  return encode_bf16(map, base, 4, dims, strides, box);
}

}  // namespace flash_hopper
