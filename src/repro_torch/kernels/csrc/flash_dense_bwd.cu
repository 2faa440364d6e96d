// Dense causal / sliding-window flash-attention backward for Hopper (sm_90a).
//
// Replaces: no Pallas kernel.  The reference differentiates the pure-JAX
// twin of _flash_kernel, _attend_flash (src/repro/models/attention.py:191),
// by autodiff; this file computes the same gradients for flash_dense.cu's
// forward, at the layout and GQA that forward reads: q, o, dO (b, s, h, hd),
// k, v (b, s, kvh, hd), all contiguous bf16, and the forward's per-row
// log-sum-exp lse (b, h, s) fp32.  With S = Q K^T scale (masked),
// P = exp(S - lse), D = rowsum(dO o O):
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),
//   dK = dS^T Q scale,  dQ = dS K scale.
//
// What bounds it on an H100: operations.  Per live (row, column) pair the
// backward does five products of depth hd (S again, dP, dV, dK, dQ; S is
// recomputed in both kernels below, so the kernels run six), 2.5x the
// forward's MMA work: at qwen3-4b's shape (2 x 4096 tokens, 32 / 8 heads,
// hd 128, causal) 343.6 GFLOP a batch row, against some 190 MB of inputs and
// outputs.
//
// Design (a simple kernel that is right; warp-level MMAs):
//   * delta: one warp per (b, row, head): D = sum_d dO o O in fp32.
//   * dkdv: one CTA of 4 warps per (b, KV head, 64-row k block), warp w
//     owning k rows 16 w .. 16 w + 15.  K and V of the block are loaded
//     into shared memory once.  The CTA loops over the group's h / kvh
//     query heads and over the BN-row q tiles the causal / window mask lets
//     see the block; per tile it recomputes S^T = K Q^T and
//     P^T = exp(S^T - lse), accumulates dV += P^T dO, forms dP^T = V dO^T
//     and dS^T = P^T o (dP^T - D), and accumulates dK += dS^T Q, all in
//     fp32 registers.  dK and dV are written once, at kvh heads: no atomics,
//     so the result is deterministic and the sum over the GQA group stays
//     inside the CTA.
//   * dq: one CTA of 4 warps per (b, head, 64-row q block), looping over
//     the 64-row k tiles the mask lets it see: S, P, dP, dS as above, then
//     dQ += dS K.
//   * MMA: mma.sync.m16n8k16 bf16 -> fp32.  P and dS are rounded to bf16
//     before their products (their fp32 values are kept for dS); the
//     accumulator fragments of two adjacent 8-column tiles are the A
//     fragment of the next product, so P and dS never leave registers.
//     Operands come from shared memory tiles with rows HD + 8 elements
//     apart (the pad staggers the banks).  No TMA, no wgmma, no pipelining:
//     a tile is loaded, the CTA synchronises, computes, and synchronises
//     again.
//   * Masking: a (row, column) pair is live when both lie below s, column
//     <= row (causal) and row - column < window (window > 0); a dead pair
//     gets P = 0.  Rows past s are loaded as zeros.
//   * Head dims: 64 and 128.  At 128 dkdv walks 32-row q tiles, so that
//     the two fp32 accumulators (dK, dV: 128 registers) leave room for
//     S^T and dP^T.

#include "hopper_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hopper::pack_bf16;

constexpr int BM = 64;           // rows a CTA owns (k rows in dkdv, q in dq)
constexpr int NTHREADS = 128;    // 4 warps, 16 of those rows each
constexpr float LOG2E = 1.4426950408889634f;

struct BwdParams {
  const bf16 *q, *k, *v, *o, *dout;
  const float *lse, *delta;
  bf16 *dq, *dk, *dv;
  int batch, s, H, group, hd, causal, window;
  float scale;
};

// D (16 x 8, fp32) += A (16 x 16, bf16) B (16 x 8, bf16)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A: reg 0 (row g, cols 2t, 2t+1), reg 1 (row g+8, same), reg 2 (row g,
//      cols 2t+8, 2t+9), reg 3 (row g+8, same);
//   B: reg 0 (rows 2t, 2t+1 of column g), reg 1 (rows 2t+8, 2t+9);
//   C: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same).

// A (16 x 16) from rows r0.. and columns c0.. of a row-major tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* x,
                                       int ld, int r0, int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = x + (r0 + g) * ld + c0 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// B (16 x 8) with B(kk, n) = y[n0 + n][k0 + kk]: y holds B transposed, so a
// register's pair is contiguous
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[2], const bf16* y,
                                          int ld, int n0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = y + (n0 + g) * ld + k0 + 2 * t;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B (16 x 8) with B(kk, n) = y[k0 + kk][n0 + n]: a register's pair is two
// rows apart, read as two halves
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[2], const bf16* y,
                                          int ld, int k0, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const unsigned short* p =
      reinterpret_cast<const unsigned short*>(y) + (k0 + 2 * t) * ld + n0 + g;
  b[0] = static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[ld]) << 16);
  b[1] = static_cast<uint32_t>(p[8 * ld]) |
         (static_cast<uint32_t>(p[9 * ld]) << 16);
}

// rows [row0, row0 + rows) of one head of a contiguous (b, s, heads, hd)
// tensor into a (rows, LD) shared tile; rows past s are zeros
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int b,
                                          int head, int heads, int row0,
                                          int rows, int s) {
  constexpr int LD = HD + 8;
  constexpr int VEC = HD / 8;        // 16-byte vectors a row
  for (int i = threadIdx.x; i < rows * VEC; i += NTHREADS) {
    const int r = i / VEC, c = (i % VEC) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < s)
      val = *reinterpret_cast<const uint4*>(
          src + ((static_cast<long long>(b) * s + row) * heads + head) * HD +
          c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

__device__ __forceinline__ bool live(int row, int col, const BwdParams& P) {
  bool ok = row < P.s && col < P.s;
  if (P.causal) ok = ok && col <= row;
  if (P.window > 0) ok = ok && row - col < P.window;
  return ok;
}

// ------------------------------------------------------------- delta ---

__global__ void __launch_bounds__(NTHREADS)
delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
             float* __restrict__ delta, long long rows, int s, int H,
             int hd) {
  const long long r = static_cast<long long>(blockIdx.x) * (NTHREADS / 32) +
                      threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const bf16* op = o + r * hd;
  const bf16* dp = dout + r * hd;
  float acc = 0.f;
  for (int d = 2 * lane; d < hd; d += 64) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(op + d));
    const float2 c = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(dp + d));
    acc = fmaf(a.x, c.x, acc);
    acc = fmaf(a.y, c.y, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    // r = (b s + row) H + head -> delta[(b H + head) s + row]
    const long long bs = r / H;
    const int head = static_cast<int>(r % H);
    const long long b = bs / s;
    const int row = static_cast<int>(bs % s);
    delta[(b * H + head) * s + row] = acc;
  }
}

// -------------------------------------------------------------- dkdv ---

// BN: q rows a tile of the inner loop
template <int HD, int BN>
__global__ void __launch_bounds__(NTHREADS)
dkdv_kernel(const BwdParams P) {
  constexpr int LD = HD + 8;
  constexpr int NT = HD / 8;         // 8-column tiles of a head row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BM * LD;
  bf16* sQ = sV + BM * LD;
  bf16* sO = sQ + BN * LD;           // dO
  float* sL = reinterpret_cast<float*>(sO + BN * LD);   // lse log2(e)
  float* sD = sL + BN;

  const int kvh = P.H / P.group;
  const int lanes = P.batch * kvh;
  // low k blocks, which see the most q tiles under the causal mask, first
  const int kb = static_cast<int>(blockIdx.x) / lanes;
  const int lane_id = static_cast<int>(blockIdx.x) % lanes;
  const int b = lane_id / kvh, kh = lane_id % kvh;
  const int k0 = kb * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * warp;          // this warp's first row of the block

  load_tile<HD>(sK, P.k, b, kh, kvh, k0, BM, P.s);
  load_tile<HD>(sV, P.v, b, kh, kvh, k0, BM, P.s);

  // q rows that see the block: [q_lo, q_hi)
  const int q_lo = P.causal ? k0 : 0;
  const int q_hi = P.window > 0 ? min(P.s, k0 + BM - 1 + P.window) : P.s;
  const float sl2 = P.scale * LOG2E;

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  for (int j = 0; j < P.group; ++j) {
    const int hh = kh * P.group + j;
    const float* lse = P.lse + (static_cast<long long>(b) * P.H + hh) * P.s;
    const float* dlt = P.delta + (static_cast<long long>(b) * P.H + hh) * P.s;
    for (int q0 = q_lo / BN * BN; q0 < q_hi; q0 += BN) {
      __syncthreads();   // the previous tile is read (and K / V stored)
      load_tile<HD>(sQ, P.q, b, hh, P.H, q0, BN, P.s);
      load_tile<HD>(sO, P.dout, b, hh, P.H, q0, BN, P.s);
      for (int i = threadIdx.x; i < BN; i += NTHREADS) {
        const bool in = q0 + i < P.s;
        sL[i] = in ? lse[q0 + i] * LOG2E : 0.f;
        sD[i] = in ? dlt[q0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T (16 k rows x BN q columns a warp)
      float st[BN / 8][4];
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        load_a(a, sK, LD, wr, 16 * kk, lane);
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
          uint32_t bb[2];
          load_b_nk(bb, sQ, LD, 8 * n, 16 * kk, lane);
          mma(st[n], a, bb);
        }
      }
      // P^T = exp(S^T scale - lse) on live pairs, 0 elsewhere
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kr = k0 + wr + g + 8 * (i >> 1);
          const int qc = 8 * n + 2 * t + (i & 1);
          st[n][i] = live(q0 + qc, kr, P)
                         ? exp2f(fmaf(st[n][i], sl2, -sL[qc])) : 0.f;
        }
      // dV += P^T dO
#pragma unroll
      for (int ks = 0; ks < BN / 16; ++ks) {
        const uint32_t a[4] = {pack_bf16(st[2 * ks][0], st[2 * ks][1]),
                               pack_bf16(st[2 * ks][2], st[2 * ks][3]),
                               pack_bf16(st[2 * ks + 1][0], st[2 * ks + 1][1]),
                               pack_bf16(st[2 * ks + 1][2], st[2 * ks + 1][3])};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bb[2];
          load_b_kn(bb, sO, LD, 16 * ks, 8 * n, lane);
          mma(dv[n], a, bb);
        }
      }
      // dP^T = V dO^T
      float dpt[BN / 8][4];
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) dpt[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        load_a(a, sV, LD, wr, 16 * kk, lane);
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
          uint32_t bb[2];
          load_b_nk(bb, sO, LD, 8 * n, 16 * kk, lane);
          mma(dpt[n], a, bb);
        }
      }
      // dS^T = P^T o (dP^T - D)
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dpt[n][i] = st[n][i] * (dpt[n][i] - sD[8 * n + 2 * t + (i & 1)]);
      // dK += dS^T Q
#pragma unroll
      for (int ks = 0; ks < BN / 16; ++ks) {
        const uint32_t a[4] = {
            pack_bf16(dpt[2 * ks][0], dpt[2 * ks][1]),
            pack_bf16(dpt[2 * ks][2], dpt[2 * ks][3]),
            pack_bf16(dpt[2 * ks + 1][0], dpt[2 * ks + 1][1]),
            pack_bf16(dpt[2 * ks + 1][2], dpt[2 * ks + 1][3])};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bb[2];
          load_b_kn(bb, sQ, LD, 16 * ks, 8 * n, lane);
          mma(dk[n], a, bb);
        }
      }
    }
  }

  // dK (scaled) and dV for the rows below s, at the KV head
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = k0 + wr + g + 8 * h2;
    if (row >= P.s) continue;
    const long long base =
        ((static_cast<long long>(b) * P.s + row) * kvh + kh) * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = 8 * n + 2 * t;
      *reinterpret_cast<uint32_t*>(P.dk + base + col) = pack_bf16(
          dk[n][2 * h2] * P.scale, dk[n][2 * h2 + 1] * P.scale);
      *reinterpret_cast<uint32_t*>(P.dv + base + col) =
          pack_bf16(dv[n][2 * h2], dv[n][2 * h2 + 1]);
    }
  }
}

// ---------------------------------------------------------------- dq ---

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
dq_kernel(const BwdParams P) {
  constexpr int LD = HD + 8;
  constexpr int NT = HD / 8;
  constexpr int BN = 64;             // k rows a tile of the inner loop
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + BM * LD;           // dO
  bf16* sK = sO + BM * LD;
  bf16* sV = sK + BN * LD;

  const int lanes = P.batch * P.H;
  const int nqb = (P.s + BM - 1) / BM;
  // high q blocks, which see the most k tiles under the causal mask, first
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x) / lanes;
  const int lane_id = static_cast<int>(blockIdx.x) % lanes;
  const int b = lane_id / P.H, hh = lane_id % P.H;
  const int kh = hh / P.group, kvh = P.H / P.group;
  const int q0 = qb * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * warp;

  load_tile<HD>(sQ, P.q, b, hh, P.H, q0, BM, P.s);
  load_tile<HD>(sO, P.dout, b, hh, P.H, q0, BM, P.s);

  // this thread's rows q0 + wr + g and + 8: lse log2(e) and D
  const long long lrow = (static_cast<long long>(b) * P.H + hh) * P.s;
  float lse2[2], dlt[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = q0 + wr + g + 8 * h2;
    lse2[h2] = row < P.s ? P.lse[lrow + row] * LOG2E : 0.f;
    dlt[h2] = row < P.s ? P.delta[lrow + row] : 0.f;
  }

  // k columns the block sees: [c_lo, c_hi)
  const int c_lo = P.window > 0 ? max(0, q0 - P.window + 1) : 0;
  const int c_hi = P.causal ? min(P.s, q0 + BM) : P.s;
  const float sl2 = P.scale * LOG2E;

  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;

  for (int c0 = c_lo / BN * BN; c0 < c_hi; c0 += BN) {
    __syncthreads();   // the previous tile is read (and Q / dO stored)
    load_tile<HD>(sK, P.k, b, kh, kvh, c0, BN, P.s);
    load_tile<HD>(sV, P.v, b, kh, kvh, c0, BN, P.s);
    __syncthreads();

    // S = Q K^T and dP = dO V^T (16 q rows x BN k columns a warp)
    float sc[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4], ao[4];
      load_a(a, sQ, LD, wr, 16 * kk, lane);
      load_a(ao, sO, LD, wr, 16 * kk, lane);
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        uint32_t bk[2], bv[2];
        load_b_nk(bk, sK, LD, 8 * n, 16 * kk, lane);
        mma(sc[n], a, bk);
        load_b_nk(bv, sV, LD, 8 * n, 16 * kk, lane);
        mma(dp[n], ao, bv);
      }
    }
    // P = exp(S scale - lse) on live pairs; dS = P o (dP - D)
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h2 = i >> 1;
        const int qr = q0 + wr + g + 8 * h2;
        const int kc = c0 + 8 * n + 2 * t + (i & 1);
        const float p = live(qr, kc, P)
                            ? exp2f(fmaf(sc[n][i], sl2, -lse2[h2])) : 0.f;
        dp[n][i] = p * (dp[n][i] - dlt[h2]);
      }
    // dQ += dS K
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) {
      const uint32_t a[4] = {pack_bf16(dp[2 * ks][0], dp[2 * ks][1]),
                             pack_bf16(dp[2 * ks][2], dp[2 * ks][3]),
                             pack_bf16(dp[2 * ks + 1][0], dp[2 * ks + 1][1]),
                             pack_bf16(dp[2 * ks + 1][2], dp[2 * ks + 1][3])};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bb[2];
        load_b_kn(bb, sK, LD, 16 * ks, 8 * n, lane);
        mma(dq[n], a, bb);
      }
    }
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = q0 + wr + g + 8 * h2;
    if (row >= P.s) continue;
    const long long base =
        ((static_cast<long long>(b) * P.s + row) * P.H + hh) * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(P.dq + base + 8 * n + 2 * t) = pack_bf16(
          dq[n][2 * h2] * P.scale, dq[n][2 * h2 + 1] * P.scale);
  }
}

int check_params(const BwdParams& P) {
  if (P.batch <= 0 || P.s <= 0 || P.H <= 0 || P.group <= 0 ||
      P.H % P.group != 0 || (P.hd != 64 && P.hd != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      const void* delta, void* dq, void* dk, void* dv,
                      int batch, int s, int H, int group, int hd, int causal,
                      int window, float scale) {
  BwdParams P;
  P.q = static_cast<const bf16*>(q);
  P.k = static_cast<const bf16*>(k);
  P.v = static_cast<const bf16*>(v);
  P.o = static_cast<const bf16*>(o);
  P.dout = static_cast<const bf16*>(dout);
  P.lse = static_cast<const float*>(lse);
  P.delta = static_cast<const float*>(delta);
  P.dq = static_cast<bf16*>(dq);
  P.dk = static_cast<bf16*>(dk);
  P.dv = static_cast<bf16*>(dv);
  P.batch = batch; P.s = s; P.H = H; P.group = group; P.hd = hd;
  P.causal = causal; P.window = window; P.scale = scale;
  return P;
}

template <int HD, int BN>
int launch_dkdv(const BwdParams& P, cudaStream_t st) {
  constexpr int LD = HD + 8;
  constexpr int smem = (2 * BM + 2 * BN) * LD * 2 + 2 * BN * 4;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<HD, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = static_cast<long long>(P.batch) * (P.H / P.group) *
                         ((P.s + BM - 1) / BM);
  dkdv_kernel<HD, BN><<<static_cast<unsigned>(grid), NTHREADS, smem, st>>>(P);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dq(const BwdParams& P, cudaStream_t st) {
  constexpr int LD = HD + 8;
  constexpr int smem = (2 * BM + 2 * 64) * LD * 2;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid =
      static_cast<long long>(P.batch) * P.H * ((P.s + BM - 1) / BM);
  dq_kernel<HD><<<static_cast<unsigned>(grid), NTHREADS, smem, st>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// D (b, h, s) = rowsum(dO o O) of o, dout (b, s, h, hd), contiguous bf16
extern "C" int flash_dense_bwd_delta_launch(const void* o, const void* dout,
                                            void* delta, int batch, int s,
                                            int H, int hd, void* stream) {
  if (batch <= 0 || s <= 0 || H <= 0 || hd <= 0 || hd % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(batch) * s * H;
  const long long grid = (rows + NTHREADS / 32 - 1) / (NTHREADS / 32);
  delta_kernel<<<static_cast<unsigned>(grid), NTHREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), rows, s, H, hd);
  return static_cast<int>(cudaGetLastError());
}

// dK, dV (b, s, kvh, hd) of q, dout (b, s, H, hd), k, v (b, s, kvh, hd),
// lse and delta (b, H, s); group = H / kvh
extern "C" int flash_dense_bwd_dkdv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch, int s,
    int H, int group, int hd, int causal, int window, float scale,
    void* stream) {
  const BwdParams P = make_params(q, k, v, nullptr, dout, lse, delta, nullptr,
                                  dk, dv, batch, s, H, group, hd, causal,
                                  window, scale);
  if (int rc = check_params(P)) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd == 64 ? launch_dkdv<64, 64>(P, st) : launch_dkdv<128, 32>(P, st);
}

// dQ (b, s, H, hd) of the same inputs
extern "C" int flash_dense_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int batch, int s, int H,
    int group, int hd, int causal, int window, float scale, void* stream) {
  const BwdParams P = make_params(q, k, v, nullptr, dout, lse, delta, dq,
                                  nullptr, nullptr, batch, s, H, group, hd,
                                  causal, window, scale);
  if (int rc = check_params(P)) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd == 64 ? launch_dq<64>(P, st) : launch_dq<128>(P, st);
}

extern "C" const char* flash_dense_bwd_error_string(int code) {
  return hopper::error_string(code);
}
