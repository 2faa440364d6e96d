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
// backward does five products of depth hd (S again, dP, dV, dK, dQ; S and
// dP are recomputed in both passes below, so the kernels run seven), 2.5x
// the forward's MMA work: at qwen3-4b's shape (2 x 4096 tokens, 32 / 8
// heads, hd 128, causal) 687 GFLOP, against some 190 MB of inputs and
// outputs.  Only wgmma reaches the tensor cores' rate.
//
// Three passes, each its own launch, none with atomics, so two runs give
// the same bits:
//   * delta: one warp per (b, row, head): D = sum_d dO o O in fp32, written
//     (b, h, s_pad) beside lse log2(e), s_pad = s rounded up to 128; rows
//     past s get D = 0 and lse = +inf, so that P = exp2(S - inf) = 0 there
//     and a tile that runs past s needs no mask for its q rows.
//   * dkdv: a CTA owns a KV head's 128-row k block and walks the GQA
//     group's query heads and the 64-row q tiles the mask lets see the
//     block, so dK and dV are summed over the group inside the CTA and
//     written once.
//   * dq: a CTA owns a head's 128-row q block and walks its k tiles.
//
// Design at padded head dims 64 and 128 (TMA + wgmma + warp
// specialisation, the forward's hardware; flash_hopper.cuh):
//   * Three warpgroups.  One thread of warpgroup 0 (registers cut to 24 by
//     setmaxnreg) loads the CTA's resident tiles once (K and V of the k
//     block in dkdv, Q and dO of the q block in dq) and keeps a ring of
//     RING (3) stages full: Q and dO tiles of 64 rows with their 64 lse and D
//     values (a 1-D bulk copy each) in dkdv, K and V tiles of 64 rows in
//     dq.  q, k, v and dO are mapped as 4-D (b, s, heads, hd) tensors, so
//     GQA's KV head is read in place; rows past s and columns past the
//     real head dim arrive as zeros (hd 80 runs the 128 instantiation).
//   * Warpgroups 1 and 2 (240 registers) own rows 0-63 and 64-127 of the
//     block.  dkdv, per q tile: S^T = K Q^T and dP^T = V dO^T by SS wgmma
//     (m64n64, K and V K-major as A, the Q / dO stage K-major as B); P^T =
//     exp2(S^T scale log2 e - lse) in registers (the lse of a q column read
//     from the stage); dV += P^T dO and dK += dS^T Q by RS wgmma, P^T and
//     dS^T = P^T o (dP^T - D) converted to bf16 in registers as the A
//     operand and the stage's Q / dO read MN-major through the transpose
//     bit.  At hd 128, dK + dV take 128 fp32 registers a thread and S^T,
//     dP^T 64 beside them.  dq, per k tile: S = Q K^T and dP = dO V^T (SS),
//     P and dS in registers, dQ += dS K (RS, K MN-major).  The stage goes
//     back to the producer (one arrival per consumer warp) once its last
//     wgmma has retired.
//   * P and dS are rounded to bf16 before their products (their fp32
//     values are kept for dS); the accumulators are fp32.
//   * Masking only where a tile needs it: the causal diagonal, the
//     window's edge, and (dq) k columns past s.
//   * dK (scaled), dV and dQ (scaled) are written as bf16 straight from the
//     accumulators, rows below s and columns below the real head dim.
//
// Padded head dim 256 (recurrentgemma-2b: MQA 10 / 1, window 2048) keeps
// the simple design of warp-level mma.sync.m16n8k16 from padded
// shared-memory tiles (no TMA, no wgmma, no pipelining): dK + dV for 64
// rows at 256 columns would be 256 fp32 registers a thread, so each of its
// kernels splits the head dim of its output between two CTAs (DSPLIT),
// each recomputing S and dP over the full depth.  One CTA of 4 warps per
// (b, KV head, 64-row k block, half) in dkdv, walking 32-row q tiles; per
// (b, head, 64-row q block, half) in dq, walking 64-row k tiles.

#include "flash_hopper.cuh"

namespace {

using namespace flash_hopper;
using bf16 = __nv_bfloat16;

constexpr int BLK = 128;         // rows a wgmma CTA owns (k in dkdv, q in dq)
constexpr int BT = 64;           // rows of a ring stage (q in dkdv, k in dq)
constexpr int RING = 3;          // stages of the ring
constexpr int SPAD = 128;        // s_pad: s rounded up to this

struct BwdParams {
  const bf16 *q, *k, *v, *dout;
  const float *lse2, *delta;     // (b, h, s_pad): lse log2(e), D
  bf16 *dq, *dk, *dv;
  int batch, s, s_pad, H, group, hd, causal, window;
  float scale, scale_log2;
};

// ------------------------------------------------------------- delta ---

// one warp per (b, row, head) of the padded rows: D and lse log2(e) at
// (b, head, row); rows past s get D = 0 and lse = +inf
__global__ void __launch_bounds__(128)
delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ lse2,
             float* __restrict__ delta, int batch, int s, int s_pad, int H,
             int hd) {
  const long long r = static_cast<long long>(blockIdx.x) * 4 +
                      threadIdx.x / 32;
  if (r >= static_cast<long long>(batch) * s_pad * H) return;
  const int lane = threadIdx.x & 31;
  const int head = static_cast<int>(r % H);
  const long long bs = r / H;
  const int row = static_cast<int>(bs % s_pad);
  const long long b = bs / s_pad;
  const long long out = (b * H + head) * s_pad + row;
  if (row >= s) {
    if (lane == 0) {
      delta[out] = 0.f;
      lse2[out] = __int_as_float(0x7f800000);
    }
    return;
  }
  const long long in = ((b * s + row) * H + head) * hd;
  float acc = 0.f;
  for (int d = 2 * lane; d < hd; d += 64) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(o + in + d));
    const float2 c = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(dout + in + d));
    acc = fmaf(a.x, c.x, acc);
    acc = fmaf(a.y, c.y, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    delta[out] = acc;
    lse2[out] = lse[(b * H + head) * s + row] * LOG2E;
  }
}

// ----------------------------------------------- wgmma (hd 64, 128) ---

// Shared memory of a wgmma CTA: the resident tiles R0, R1 (BLK rows each),
// the ring's tiles T0, T1 (BT rows each) per stage, the ring's lse / D
// (dkdv: BT floats each per stage), then the mbarriers res_full, full[],
// empty[].  A tile of padded width HD is HD / 64 boxes of 64 columns.
template <int HD>
struct BwdLayout {
  static constexpr int NBOX = HD / 64;
  static constexpr int RBOX = BLK * 128;            // BLK rows x 64 bf16
  static constexpr int TBOX = BT * 128;             // BT rows x 64 bf16
  static constexpr int RTILE = NBOX * RBOX;
  static constexpr int TTILE = NBOX * TBOX;
  static constexpr int R0 = 0;
  static constexpr int R1 = R0 + RTILE;
  static constexpr int T0 = R1 + RTILE;             // RING tiles
  static constexpr int T1 = T0 + RING * TTILE;      // RING tiles
  static constexpr int LD = T1 + RING * TTILE;      // RING x (lse, D)
  static constexpr int BAR = LD + RING * 2 * BT * 4;
  static constexpr int BYTES = BAR + (1 + 2 * RING) * 8 + 1024;  // + align
};

// D (64 x HD) += A (64 x 16, registers) * B (16 x HD, smem, MN-major)
template <int HD>
__device__ __forceinline__ void rs_hd(float* d, const uint32_t* a,
                                      uint64_t db) {
  if constexpr (HD == 128)
    wgmma_m64n128k16_rs<1>(d, a, db, 1);
  else
    wgmma_m64n64k16_rs<1>(d, a, db, 1);
}

// acc (64 x 64) = A (64 x HD) B^T (HD x 64): A rows of a resident BLK-row
// tile (da: its row offset included), B a BT-row stage, both K-major
template <int HD>
__device__ __forceinline__ void ss_hd(float* acc, uint64_t da, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int aoff = (kk / 4) * (BLK * 128 / 16) + (kk % 4) * 2;
    const int boff = (kk / 4) * (BT * 128 / 16) + (kk % 4) * 2;
    wgmma_m64n64k16_ss<0>(acc, da + aoff, db + boff, kk);
  }
}

// the m64n64 accumulator value v of this thread: its row (of the 64) and
// its column
__device__ __forceinline__ int acc_row(int tq, int v) {
  return 16 * (tq / 32) + (tq % 32) / 4 + 8 * ((v >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int tq, int v) {
  return 8 * (v >> 2) + 2 * (tq & 3) + (v & 1);
}

// 16-column slice kk of a 64 x 64 fp32 accumulator as a bf16 A fragment
__device__ __forceinline__ void pack_frags(const float* x,
                                           uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// rows r_lo, r_lo + 8 (below row_end) and the columns below hd of a
// 64 x HD fp32 accumulator, times mul, as bf16 into the (row, hd) plane
// at ob, rows o_ss elements apart
template <int HD>
__device__ __forceinline__ void store_acc(bf16* ob, long long o_ss,
                                          const float* acc, float mul,
                                          int r_lo, int row_end, int lane,
                                          int hd) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = r_lo + 8 * j;
    if (row >= row_end) continue;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      if (nt * 8 >= hd) break;
      const int col = nt * 8 + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(ob + row * o_ss + col) = pack_bf16(
          acc[4 * nt + 2 * j] * mul, acc[4 * nt + 2 * j + 1] * mul);
    }
  }
}

// the pair (k row kr, q row qr) is live under the causal / window mask
__device__ __forceinline__ bool live_pair(int qr, int kr, int causal,
                                          int window) {
  return (!causal || kr <= qr) && (window <= 0 || qr - kr < window);
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
dkdv_wgmma(const __grid_constant__ CUtensorMap qmap,
           const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap,
           const __grid_constant__ CUtensorMap omap, const BwdParams P) {
  using L = BwdLayout<HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* res_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = res_full + 1;
  uint64_t* empty = full + RING;
  float* ld = reinterpret_cast<float*>(smem + L::LD);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < RING; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int kvh = P.H / P.group;
  const int lanes = P.batch * kvh;
  // low k blocks, which see the most q tiles under the causal mask, first
  const int kb = static_cast<int>(blockIdx.x) / lanes;
  const int lane_id = static_cast<int>(blockIdx.x) % lanes;
  const int b = lane_id / kvh, kh = lane_id % kvh;
  const int k0 = kb * BLK;
  // q tiles that see the block: [t_lo, t_hi)
  const int t_lo = P.causal ? k0 / BT : 0;
  const int t_hi =
      (P.window > 0 ? min(P.s, k0 + BLK - 1 + P.window) : P.s) + BT - 1;
  const int ntiles = t_hi / BT - t_lo;

  if (wg == 0) {
    // ---- producer ----
    reg_dealloc<24>();
    if (tid == 0) {
      mbar_expect_tx(res_full, 2 * L::RTILE);
      for (int j = 0; j < L::NBOX; ++j) {
        tma_load_4d(smem + L::R0 + j * L::RBOX, &kmap, res_full, 64 * j, k0,
                    kh, b);
        tma_load_4d(smem + L::R1 + j * L::RBOX, &vmap, res_full, 64 * j, k0,
                    kh, b);
      }
      int i = 0;
      for (int hj = 0; hj < P.group; ++hj) {
        const int hh = kh * P.group + hj;
        const long long lrow = (static_cast<long long>(b) * P.H + hh) * P.s_pad;
        for (int t = 0; t < ntiles; ++t, ++i) {
          const int s = i % RING;
          const int q0 = (t_lo + t) * BT;
          mbar_wait(&empty[s], ((i / RING) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * L::TTILE + 2 * BT * 4);
          for (int j = 0; j < L::NBOX; ++j) {
            tma_load_4d(smem + L::T0 + s * L::TTILE + j * L::TBOX, &qmap,
                        &full[s], 64 * j, q0, hh, b);
            tma_load_4d(smem + L::T1 + s * L::TTILE + j * L::TBOX, &omap,
                        &full[s], 64 * j, q0, hh, b);
          }
          bulk_load(ld + s * 2 * BT, P.lse2 + lrow + q0, BT * 4, &full[s]);
          bulk_load(ld + s * 2 * BT + BT, P.delta + lrow + q0, BT * 4,
                    &full[s]);
        }
      }
    }
  } else {
    // ---- consumers: k rows kr0 .. kr0 + 63 ----
    reg_alloc<240>();
    const int c = wg - 1;
    const int tq = tid % 128;
    const int lane = tid % 32;
    const int kr0 = k0 + 64 * c;

    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int v = 0; v < HD / 2; ++v) dk[v] = dv[v] = 0.f;

    const uint64_t ka = smem_desc(smem + L::R0 + c * 64 * 128, 16, 1024);
    const uint64_t va = smem_desc(smem + L::R1 + c * 64 * 128, 16, 1024);
    mbar_wait(res_full, 0);

    int i = 0;
    for (int hj = 0; hj < P.group; ++hj) {
      for (int t = 0; t < ntiles; ++t, ++i) {
        const int s = i % RING;
        const int q0 = (t_lo + t) * BT;
        unsigned char* qs = smem + L::T0 + s * L::TTILE;
        unsigned char* os = smem + L::T1 + s * L::TTILE;
        const float* lse2 = ld + s * 2 * BT;
        const float* dl = lse2 + BT;
        mbar_wait(&full[s], (i / RING) & 1);

        // S^T = K Q^T and dP^T = V dO^T, two groups
        float st[32], dpt[32];
        wgmma_fence();
        ss_hd<HD>(st, ka, smem_desc(qs, 16, 1024));
        wgmma_commit();
        ss_hd<HD>(dpt, va, smem_desc(os, 16, 1024));
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs<32>(st);

        // P^T = exp2(S^T scale log2(e) - lse) (0 where masked)
        const bool mask = (P.causal && q0 < kr0 + 63) ||
                          (P.window > 0 && q0 + BT - 1 - kr0 >= P.window);
#pragma unroll
        for (int v = 0; v < 32; ++v) {
          const int col = acc_col(tq, v);
          float p = fast_exp2(fmaf(st[v], P.scale_log2, -lse2[col]));
          if (mask && !live_pair(q0 + col, kr0 + acc_row(tq, v), P.causal,
                                 P.window))
            p = 0.f;
          st[v] = p;
        }
        uint32_t pf[4][4];
        pack_frags(st, pf);
        wgmma_wait<0>();
        fence_regs<32>(dpt);

        // dV += P^T dO
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          rs_hd<HD>(dv, pf[kk], smem_desc(os, L::TBOX, 1024) + 128 * kk);
        wgmma_commit();

        // dS^T = P^T o (dP^T - D); dK += dS^T Q
#pragma unroll
        for (int v = 0; v < 32; ++v)
          dpt[v] = st[v] * (dpt[v] - dl[acc_col(tq, v)]);
        uint32_t sf[4][4];
        pack_frags(dpt, sf);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          rs_hd<HD>(dk, sf[kk], smem_desc(qs, L::TBOX, 1024) + 128 * kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<HD / 2>(dv);
        fence_regs<HD / 2>(dk);
        fence_regs<16>(&pf[0][0]);
        fence_regs<16>(&sf[0][0]);
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }

    // dK (scaled) and dV at the KV head, rows below s
    const int r_lo = kr0 + acc_row(tq, 0);
    const long long base = static_cast<long long>(b) * P.s * kvh + kh;
    store_acc<HD>(P.dk + base * P.hd, static_cast<long long>(kvh) * P.hd, dk,
                  P.scale, r_lo, P.s, lane, P.hd);
    store_acc<HD>(P.dv + base * P.hd, static_cast<long long>(kvh) * P.hd, dv,
                  1.f, r_lo, P.s, lane, P.hd);
  }
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
dq_wgmma(const __grid_constant__ CUtensorMap qmap,
         const __grid_constant__ CUtensorMap kmap,
         const __grid_constant__ CUtensorMap vmap,
         const __grid_constant__ CUtensorMap omap, const BwdParams P) {
  using L = BwdLayout<HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* res_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = res_full + 1;
  uint64_t* empty = full + RING;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < RING; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int lanes = P.batch * P.H;
  const int nqb = (P.s + BLK - 1) / BLK;
  // high q blocks, which see the most k tiles under the causal mask, first
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x) / lanes;
  const int lane_id = static_cast<int>(blockIdx.x) % lanes;
  const int b = lane_id / P.H, hh = lane_id % P.H;
  const int kh = hh / P.group;
  const int q0 = qb * BLK;
  // k columns the block sees: tiles [t_lo, t_hi)
  const int t_lo = P.window > 0 ? max(0, q0 - P.window + 1) / BT : 0;
  const int c_hi = P.causal ? min(P.s, q0 + BLK) : P.s;
  const int ntiles = (c_hi + BT - 1) / BT - t_lo;

  if (wg == 0) {
    // ---- producer ----
    reg_dealloc<24>();
    if (tid == 0) {
      mbar_expect_tx(res_full, 2 * L::RTILE);
      for (int j = 0; j < L::NBOX; ++j) {
        tma_load_4d(smem + L::R0 + j * L::RBOX, &qmap, res_full, 64 * j, q0,
                    hh, b);
        tma_load_4d(smem + L::R1 + j * L::RBOX, &omap, res_full, 64 * j, q0,
                    hh, b);
      }
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % RING;
        const int c0 = (t_lo + i) * BT;
        mbar_wait(&empty[s], ((i / RING) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * L::TTILE);
        for (int j = 0; j < L::NBOX; ++j) {
          tma_load_4d(smem + L::T0 + s * L::TTILE + j * L::TBOX, &kmap,
                      &full[s], 64 * j, c0, kh, b);
          tma_load_4d(smem + L::T1 + s * L::TTILE + j * L::TBOX, &vmap,
                      &full[s], 64 * j, c0, kh, b);
        }
      }
    }
  } else {
    // ---- consumers: q rows qr0 .. qr0 + 63 ----
    reg_alloc<240>();
    const int c = wg - 1;
    const int tq = tid % 128;
    const int lane = tid % 32;
    const int qr0 = q0 + 64 * c;
    const int r_lo = qr0 + acc_row(tq, 0);      // and r_lo + 8
    // this thread's rows' lse log2(e) and D (rows past s: +inf and 0)
    const long long lrow = (static_cast<long long>(b) * P.H + hh) * P.s_pad;
    const float lse2[2] = {P.lse2[lrow + r_lo], P.lse2[lrow + r_lo + 8]};
    const float dl[2] = {P.delta[lrow + r_lo], P.delta[lrow + r_lo + 8]};

    float dq[HD / 2];
#pragma unroll
    for (int v = 0; v < HD / 2; ++v) dq[v] = 0.f;

    const uint64_t qa = smem_desc(smem + L::R0 + c * 64 * 128, 16, 1024);
    const uint64_t oa = smem_desc(smem + L::R1 + c * 64 * 128, 16, 1024);
    mbar_wait(res_full, 0);

    for (int i = 0; i < ntiles; ++i) {
      const int s = i % RING;
      const int c0 = (t_lo + i) * BT;
      unsigned char* ks = smem + L::T0 + s * L::TTILE;
      unsigned char* vs = smem + L::T1 + s * L::TTILE;
      mbar_wait(&full[s], (i / RING) & 1);

      // S = Q K^T and dP = dO V^T, two groups
      float sc[32], dp[32];
      wgmma_fence();
      ss_hd<HD>(sc, qa, smem_desc(ks, 16, 1024));
      wgmma_commit();
      ss_hd<HD>(dp, oa, smem_desc(vs, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs<32>(sc);

      // P = exp2(S scale log2(e) - lse) (0 where masked or past s)
      const bool mask = (P.causal && c0 + BT - 1 > qr0) ||
                        (P.window > 0 && qr0 + 63 - c0 >= P.window) ||
                        c0 + BT > P.s;
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        const int j = (v >> 1) & 1;
        float p = fast_exp2(fmaf(sc[v], P.scale_log2, -lse2[j]));
        const int kc = c0 + acc_col(tq, v);
        if (mask && (kc >= P.s || !live_pair(r_lo + 8 * j, kc, P.causal,
                                             P.window)))
          p = 0.f;
        sc[v] = p;
      }
      wgmma_wait<0>();
      fence_regs<32>(dp);

      // dS = P o (dP - D); dQ += dS K
#pragma unroll
      for (int v = 0; v < 32; ++v) dp[v] = sc[v] * (dp[v] - dl[(v >> 1) & 1]);
      uint32_t sf[4][4];
      pack_frags(dp, sf);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        rs_hd<HD>(dq, sf[kk], smem_desc(ks, L::TBOX, 1024) + 128 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<HD / 2>(dq);
      fence_regs<16>(&sf[0][0]);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    const long long base = static_cast<long long>(b) * P.s * P.H + hh;
    store_acc<HD>(P.dq + base * P.hd, static_cast<long long>(P.H) * P.hd, dq,
                  P.scale, r_lo, P.s, lane, P.hd);
  }
}

// ----------------------------------------------- mma.sync (hd 256) ---

constexpr int BM = 64;           // rows a CTA owns (k rows in dkdv, q in dq)
constexpr int MT = 128;          // 4 warps, 16 of those rows each
constexpr int DSPLIT = 2;        // CTAs sharing one block's output columns

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
// tensor into a (rows, HD + 8) shared tile; rows past s and columns past
// hd are zeros
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int b,
                                          int head, int heads, int row0,
                                          int rows, int s, int hd) {
  constexpr int LD = HD + 8;
  constexpr int VEC = HD / 8;        // 16-byte vectors a row
  for (int i = threadIdx.x; i < rows * VEC; i += MT) {
    const int r = i / VEC, c = (i % VEC) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < s && c < hd)
      val = *reinterpret_cast<const uint4*>(
          src + ((static_cast<long long>(b) * s + row) * heads + head) * hd +
          c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

__device__ __forceinline__ bool live(int row, int col, const BwdParams& P) {
  return row < P.s && col < P.s && live_pair(row, col, P.causal, P.window);
}

// BN: q rows a tile of the inner loop; blockIdx.y: the half of the head
// dim this CTA's dK and dV cover
template <int HD, int BN>
__global__ void __launch_bounds__(MT)
dkdv_mma(const BwdParams P) {
  constexpr int LD = HD + 8;
  constexpr int NT = HD / 8 / DSPLIT;   // 8-column output tiles a CTA
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BM * LD;
  bf16* sQ = sV + BM * LD;
  bf16* sO = sQ + BN * LD;           // dO
  float* sL = reinterpret_cast<float*>(sO + BN * LD);   // lse log2(e)
  float* sD = sL + BN;

  const int kvh = P.H / P.group;
  const int lanes = P.batch * kvh;
  const int kb = static_cast<int>(blockIdx.x) / lanes;
  const int lane_id = static_cast<int>(blockIdx.x) % lanes;
  const int b = lane_id / kvh, kh = lane_id % kvh;
  const int k0 = kb * BM;
  const int n_lo = static_cast<int>(blockIdx.y) * NT * 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * warp;          // this warp's first row of the block

  load_tile<HD>(sK, P.k, b, kh, kvh, k0, BM, P.s, P.hd);
  load_tile<HD>(sV, P.v, b, kh, kvh, k0, BM, P.s, P.hd);

  // q rows that see the block: [q_lo, q_hi)
  const int q_lo = P.causal ? k0 : 0;
  const int q_hi = P.window > 0 ? min(P.s, k0 + BM - 1 + P.window) : P.s;

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  for (int j = 0; j < P.group; ++j) {
    const int hh = kh * P.group + j;
    const long long lrow = (static_cast<long long>(b) * P.H + hh) * P.s_pad;
    for (int q0 = q_lo / BN * BN; q0 < q_hi; q0 += BN) {
      __syncthreads();   // the previous tile is read (and K / V stored)
      load_tile<HD>(sQ, P.q, b, hh, P.H, q0, BN, P.s, P.hd);
      load_tile<HD>(sO, P.dout, b, hh, P.H, q0, BN, P.s, P.hd);
      for (int i = threadIdx.x; i < BN; i += MT) {
        sL[i] = P.lse2[lrow + q0 + i];
        sD[i] = P.delta[lrow + q0 + i];
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
      // P^T = exp2(S^T scale log2(e) - lse) on live pairs, 0 elsewhere
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kr = k0 + wr + g + 8 * (i >> 1);
          const int qc = 8 * n + 2 * t + (i & 1);
          st[n][i] = live(q0 + qc, kr, P)
                         ? exp2f(fmaf(st[n][i], P.scale_log2, -sL[qc]))
                         : 0.f;
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
          load_b_kn(bb, sO, LD, 16 * ks, n_lo + 8 * n, lane);
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
          load_b_kn(bb, sQ, LD, 16 * ks, n_lo + 8 * n, lane);
          mma(dk[n], a, bb);
        }
      }
    }
  }

  // dK (scaled) and dV for the rows below s and the columns below hd
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = k0 + wr + g + 8 * h2;
    if (row >= P.s) continue;
    const long long base =
        ((static_cast<long long>(b) * P.s + row) * kvh + kh) * P.hd;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n_lo + 8 * n + 2 * t;
      if (col >= P.hd) break;
      *reinterpret_cast<uint32_t*>(P.dk + base + col) = pack_bf16(
          dk[n][2 * h2] * P.scale, dk[n][2 * h2 + 1] * P.scale);
      *reinterpret_cast<uint32_t*>(P.dv + base + col) =
          pack_bf16(dv[n][2 * h2], dv[n][2 * h2 + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(MT)
dq_mma(const BwdParams P) {
  constexpr int LD = HD + 8;
  constexpr int NT = HD / 8 / DSPLIT;
  constexpr int BN = 64;             // k rows a tile of the inner loop
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + BM * LD;           // dO
  bf16* sK = sO + BM * LD;
  bf16* sV = sK + BN * LD;

  const int lanes = P.batch * P.H;
  const int nqb = (P.s + BM - 1) / BM;
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x) / lanes;
  const int lane_id = static_cast<int>(blockIdx.x) % lanes;
  const int b = lane_id / P.H, hh = lane_id % P.H;
  const int kh = hh / P.group, kvh = P.H / P.group;
  const int q0 = qb * BM;
  const int n_lo = static_cast<int>(blockIdx.y) * NT * 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * warp;

  load_tile<HD>(sQ, P.q, b, hh, P.H, q0, BM, P.s, P.hd);
  load_tile<HD>(sO, P.dout, b, hh, P.H, q0, BM, P.s, P.hd);

  // this thread's rows q0 + wr + g and + 8: lse log2(e) and D
  const long long lrow = (static_cast<long long>(b) * P.H + hh) * P.s_pad;
  float lse2[2], dlt[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = q0 + wr + g + 8 * h2;
    lse2[h2] = P.lse2[lrow + row];
    dlt[h2] = P.delta[lrow + row];
  }

  // k columns the block sees: [c_lo, c_hi)
  const int c_lo = P.window > 0 ? max(0, q0 - P.window + 1) : 0;
  const int c_hi = P.causal ? min(P.s, q0 + BM) : P.s;

  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;

  for (int c0 = c_lo / BN * BN; c0 < c_hi; c0 += BN) {
    __syncthreads();   // the previous tile is read (and Q / dO stored)
    load_tile<HD>(sK, P.k, b, kh, kvh, c0, BN, P.s, P.hd);
    load_tile<HD>(sV, P.v, b, kh, kvh, c0, BN, P.s, P.hd);
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
    // P = exp2(S scale log2(e) - lse) on live pairs; dS = P o (dP - D)
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h2 = i >> 1;
        const int qr = q0 + wr + g + 8 * h2;
        const int kc = c0 + 8 * n + 2 * t + (i & 1);
        const float p = live(qr, kc, P)
                            ? exp2f(fmaf(sc[n][i], P.scale_log2, -lse2[h2]))
                            : 0.f;
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
        load_b_kn(bb, sK, LD, 16 * ks, n_lo + 8 * n, lane);
        mma(dq[n], a, bb);
      }
    }
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = q0 + wr + g + 8 * h2;
    if (row >= P.s) continue;
    const long long base =
        ((static_cast<long long>(b) * P.s + row) * P.H + hh) * P.hd;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n_lo + 8 * n + 2 * t;
      if (col >= P.hd) break;
      *reinterpret_cast<uint32_t*>(P.dq + base + col) = pack_bf16(
          dq[n][2 * h2] * P.scale, dq[n][2 * h2 + 1] * P.scale);
    }
  }
}

// ------------------------------------------------------------- host ---

int check_params(const BwdParams& P) {
  if (P.batch <= 0 || P.s <= 0 || P.H <= 0 || P.group <= 0 ||
      P.H % P.group != 0 || P.hd <= 0 || P.hd > 256 || P.hd % 8 != 0 ||
      P.s_pad != (P.s + SPAD - 1) / SPAD * SPAD)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse2, const void* delta,
                      void* dq, void* dk, void* dv, int batch, int s,
                      int s_pad, int H, int group, int hd, int causal,
                      int window, float scale) {
  BwdParams P;
  P.q = static_cast<const bf16*>(q);
  P.k = static_cast<const bf16*>(k);
  P.v = static_cast<const bf16*>(v);
  P.dout = static_cast<const bf16*>(dout);
  P.lse2 = static_cast<const float*>(lse2);
  P.delta = static_cast<const float*>(delta);
  P.dq = static_cast<bf16*>(dq);
  P.dk = static_cast<bf16*>(dk);
  P.dv = static_cast<bf16*>(dv);
  P.batch = batch; P.s = s; P.s_pad = s_pad; P.H = H; P.group = group;
  P.hd = hd; P.causal = causal; P.window = window;
  P.scale = scale; P.scale_log2 = scale * LOG2E;
  return P;
}

// the four 4-D maps of q, dO (heads H) and k, v (heads H / group), all
// contiguous (b, s, heads, hd), with boxes of 64 columns x qrows / krows
int encode_maps(CUtensorMap* m, const BwdParams& P, int qrows, int krows) {
  const long long hd = P.hd, s = P.s, H = P.H, kvh = P.H / P.group;
  int rc = encode_bshd(&m[0], P.q, P.batch, P.s, P.H, P.hd, s * H * hd, hd,
                       H * hd, qrows);
  if (rc == 0)
    rc = encode_bshd(&m[1], P.k, P.batch, P.s, kvh, P.hd, s * kvh * hd, hd,
                     kvh * hd, krows);
  if (rc == 0)
    rc = encode_bshd(&m[2], P.v, P.batch, P.s, kvh, P.hd, s * kvh * hd, hd,
                     kvh * hd, krows);
  if (rc == 0)
    rc = encode_bshd(&m[3], P.dout, P.batch, P.s, P.H, P.hd, s * H * hd, hd,
                     H * hd, qrows);
  return rc;
}

template <int HD, bool DKDV>
int launch_wgmma(const BwdParams& P, cudaStream_t st) {
  CUtensorMap m[4];
  // dkdv: q / dO in the ring (BT rows), k / v resident (BLK); dq: the other
  // way round
  int rc = DKDV ? encode_maps(m, P, BT, BLK) : encode_maps(m, P, BLK, BT);
  if (rc != 0) return rc;
  constexpr int bytes = BwdLayout<HD>::BYTES;
  auto kern = DKDV ? dkdv_wgmma<HD> : dq_wgmma<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long lanes =
      static_cast<long long>(P.batch) * (DKDV ? P.H / P.group : P.H);
  const long long grid = lanes * ((P.s + BLK - 1) / BLK);
  kern<<<static_cast<unsigned>(grid), NTHREADS, bytes, st>>>(m[0], m[1], m[2],
                                                             m[3], P);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int BN>
int launch_dkdv_mma(const BwdParams& P, cudaStream_t st) {
  constexpr int LD = HD + 8;
  constexpr int smem = (2 * BM + 2 * BN) * LD * 2 + 2 * BN * 4;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_mma<HD, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = static_cast<long long>(P.batch) * (P.H / P.group) *
                         ((P.s + BM - 1) / BM);
  dkdv_mma<HD, BN><<<dim3(static_cast<unsigned>(grid), DSPLIT), MT, smem,
                     st>>>(P);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dq_mma(const BwdParams& P, cudaStream_t st) {
  constexpr int LD = HD + 8;
  constexpr int smem = (2 * BM + 2 * 64) * LD * 2;
  cudaError_t err = cudaFuncSetAttribute(
      dq_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid =
      static_cast<long long>(P.batch) * P.H * ((P.s + BM - 1) / BM);
  dq_mma<HD><<<dim3(static_cast<unsigned>(grid), DSPLIT), MT, smem, st>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// D and lse log2(e), both (b, h, s_pad), of o, dout (b, s, h, hd), contiguous
// bf16, and the forward's lse (b, h, s)
extern "C" int flash_dense_bwd_delta_launch(const void* o, const void* dout,
                                            const void* lse, void* lse2,
                                            void* delta, int batch, int s,
                                            int s_pad, int H, int hd,
                                            void* stream) {
  if (batch <= 0 || s <= 0 || H <= 0 || hd <= 0 || hd % 2 != 0 ||
      s_pad != (s + SPAD - 1) / SPAD * SPAD)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(batch) * s_pad * H;
  delta_kernel<<<static_cast<unsigned>((rows + 3) / 4), 128, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(lse2),
      static_cast<float*>(delta), batch, s, s_pad, H, hd);
  return static_cast<int>(cudaGetLastError());
}

// dK, dV (b, s, kvh, hd) of q, dout (b, s, H, hd), k, v (b, s, kvh, hd),
// lse log2(e) and delta (b, H, s_pad); group = H / kvh
extern "C" int flash_dense_bwd_dkdv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse2, const void* delta, void* dk, void* dv, int batch, int s,
    int s_pad, int H, int group, int hd, int causal, int window, float scale,
    void* stream) {
  const BwdParams P = make_params(q, k, v, dout, lse2, delta, nullptr, dk, dv,
                                  batch, s, s_pad, H, group, hd, causal,
                                  window, scale);
  if (int rc = check_params(P)) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return launch_wgmma<64, true>(P, st);
  if (hd <= 128) return launch_wgmma<128, true>(P, st);
  return launch_dkdv_mma<256, 32>(P, st);
}

// dQ (b, s, H, hd) of the same inputs
extern "C" int flash_dense_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse2, const void* delta, void* dq, int batch, int s,
    int s_pad, int H, int group, int hd, int causal, int window, float scale,
    void* stream) {
  const BwdParams P = make_params(q, k, v, dout, lse2, delta, dq, nullptr,
                                  nullptr, batch, s, s_pad, H, group, hd,
                                  causal, window, scale);
  if (int rc = check_params(P)) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return launch_wgmma<64, false>(P, st);
  if (hd <= 128) return launch_wgmma<128, false>(P, st);
  return launch_dq_mma<256>(P, st);
}

extern "C" const char* flash_dense_bwd_error_string(int code) {
  return hopper::error_string(code);
}
