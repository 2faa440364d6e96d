// Dense causal / sliding-window flash-attention backward for Hopper (sm_90a).
//
// Replaces: no Pallas kernel.  The reference differentiates the pure-JAX
// twin of _flash_kernel, _attend_flash (src/repro/models/attention.py:191),
// by autodiff; this file computes the same gradients for flash_dense.cu's
// forward, at the layout and GQA that forward reads: q, o, dO (b, s, h, hd),
// k, v (b, s, kvh, hd), all contiguous bf16 or all fp16 (the launchers'
// dtype code 1 or 2; fp16 below), and the forward's per-row log-sum-exp lse
// (b, h, s) fp32.  With S = Q K^T scale (masked),
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
//   * dkdv: a CTA owns a KV head's 128-row k block (64 rows at padded
//     head dim 256) and walks the GQA group's query heads and the 64-row
//     q tiles the mask lets see the block, so dK and dV are summed over
//     the group inside the CTA and written once.
//   * dq: a CTA owns a head's 128-row q block (64 rows at 256) and walks
//     its k tiles.
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
//     real head dim arrive as zeros.  hd 80 keeps the tiles of 128 but
//     runs its products at their exact width (HDW 80): the depth-hd
//     products (S^T, dP^T, S, dP) in 5 k steps of 16 instead of 8, the
//     width-hd ones (dV, dK, dQ) as wgmma.m64n80k16 instead of n128, so
//     dK + dV take 80 fp32 registers a thread, not 128.  The steps dropped
//     add only products of zeros and an n80's columns are the n128's first
//     80, so the gradients keep the padded kernels' bits.
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
//     values are kept for dS; in fp16 each is split in two, below); the
//     accumulators are fp32.
//   * Masking only where a tile needs it: the causal diagonal, the
//     window's edge, and (dq) k columns past s.
//   * dK (scaled), dV and dQ (scaled) are written in the inputs' type
//     straight from the accumulators, rows below s and columns below the
//     real head dim.
//
// Padded head dim 256 (recurrentgemma-2b: MQA 10 / 1, window 2048) runs
// the same hardware in another split, since dK + dV for 64 rows at 256
// columns would be 256 fp32 registers a thread, over setmaxnreg's 240:
//   * A CTA owns a 64-row block (k in dkdv, q in dq), resident as four
//     64 x 64 boxes per tile (32 KB), and a ring of 2 stages of two 64-row
//     tiles (128 KB); every tile comes by TMA over the same 4-D maps.
//     64-row blocks also give 128 dkdv CTAs at recurrentgemma-2b's shape
//     (b 2, one KV head, s 4096) where 128-row blocks would give 64 for
//     132 SMs.
//   * dkdv splits the outputs between the consumer warpgroups, not the
//     rows: warpgroup 1 computes S^T = K Q^T (m64n64, SS) and P^T, and
//     accumulates dV += P^T dO; warpgroup 2 computes dP^T = V dO^T and
//     accumulates dK += dS^T Q, dS^T formed from warpgroup 1's fp32 P^T,
//     which passes through a 16 KB shared buffer under two named barriers
//     (full: warpgroup 1 arrives, 2 waits; empty: the other way round).
//     Each accumulator is 64 x 256 as two m64n128 RS halves, 128 fp32 a
//     thread.
//   * dq: warpgroup 1 computes S = Q K^T and P, warpgroup 2 dP = dO V^T;
//     the two swap them in fp32 through two 16 KB buffers, each forms dS
//     and accumulates its half of dQ's 256 columns (m64n128 RS).
//   * So each product is computed once a tile: 4 in dkdv and 3 in dq, the
//     7 of the narrower head dims.  No atomics: two runs give the same
//     bits.  Shared memory: ~210 KB (dkdv), ~226 KB (dq).
//
// fp16 (every kernel above at T = __half, wgmma .f16) is held to the
// reference elementwise, within 2^-10 + 2^-10 |plain|, where bf16 is held
// within 2^-6 max |plain|.  The reference computes in fp32 (q, k, v cast
// up, autodiff through fp32 O and P).  Emulating the kernels' roundings in
// fp32 at qwen3-4b's training shape (s 4096, hd 128, a GQA group of 4;
// ref.attention_bwd_f16, tests/test_torch_fp16_flash.py) gave the share of
// that gate each rounding uses, measured against fp64:
//   * D from the fp16 output O: 1.06 of the gate in dK on its own (0.71 in
//     dQ).  D = rowsum(dO o O) cancels little, and O's rounding (2^-11) goes
//     into every dS of the row.  So the forward, under autograd, also
//     writes o_lo = O - fp16(O) (flash_dense.cu) and the delta pass sums
//     dO o (O + o_lo): 0.003 of the gate.  The general kernels do the same
//     for the fp16 calls they take (flash_simt.cu, flash_simt_bwd.cu).
//   * P rounded once to fp16 before dV += P^T dO: 1.19 of the gate in dV.
//     dS rounded once before dK, dQ: 0.89 in dK, 0.42 in dQ.  Each is split
//     as the forward splits P, hi + lo in fp16 (pack_frags: NTERM 2), with
//     a wgmma for each: 0.009 of the gate.  The split takes dkdv from 4
//     products a tile to 6 and dq from 3 to 4 (10 against 7).
//   * What is left is the rounding of the outputs to fp16, at most half
//     the gate (0.39 measured).
// At hd 64 and 128 the dkdv consumer would hold dK + dV (128 fp32), S^T and
// dP^T (64) and both fragment sets of P^T (32) at once if it issued dV
// before forming dS^T as bf16 does; fp16 forms dS^T first, so that P^T's
// registers pass to its fragments.
// fp16 saturates at 65504 where bf16 does not.  dS = P (dP - D) with
// 0 <= P <= 1 is formed in fp32 and split; once |dS| >= 65520 its hi
// rounds to inf and its lo, dS - hi, is -inf, so the two wgmmas that sum
// them give NaN in dK and dQ, not inf.  |dP| <= hd max|dO| max|V| and
// |D| <= hd max|dO| max|O| <= hd max|dO| max|V|, so no input reaches it
// with hd max|dO| max|V| < 32760 (at hd 128: max|dO| max|V| < 255.9).
// Unit-scale q, k, v with dO scaled by 2^8 stays below it in practice:
// dP's spread is then 2^8 sqrt(hd), 2^11.5 at hd 128, and its largest
// value over a training shape's 2^30 pairs about six spreads, near 2^14.
// A dynamic loss scale can pass it (torch.amp.GradScaler starts at 2^16):
// the scaler reads a NaN gradient as an overflow, as it reads inf, skips
// the step and lowers the scale.  A gradient whose own value passes 65504
// is out of fp16's range for the reference too.

#include "flash_hopper.cuh"

namespace {

using namespace flash_hopper;

constexpr int BLK = 128;         // rows a wgmma CTA owns (k in dkdv, q in dq)
constexpr int BT = 64;           // rows of a ring stage (q in dkdv, k in dq)
constexpr int RING = 3;          // stages of the ring
constexpr int SPAD = 128;        // s_pad: s rounded up to this

// pointers to the element type T of the kernel (bf16 or fp16)
struct BwdParams {
  const void *q, *k, *v, *dout;
  const float *lse2, *delta;     // (b, h, s_pad): lse log2(e), D
  void *dq, *dk, *dv;
  int batch, s, s_pad, H, group, hd, causal, window;
  float scale, scale_log2;
};

// ------------------------------------------------------------- delta ---

// one warp per (b, row, head) of the padded rows: D and lse log2(e) at
// (b, head, row); rows past s get D = 0 and lse = +inf.  o_lo, where given,
// is the forward's rounding residual of O (fp16: O - fp16(O) in fp16), so
// that D is that of the fp32 O as in the reference
template <typename T>
__global__ void __launch_bounds__(128)
delta_kernel(const T* __restrict__ o, const T* __restrict__ o_lo,
             const T* __restrict__ dout, const float* __restrict__ lse,
             float* __restrict__ lse2, float* __restrict__ delta, int batch,
             int s, int s_pad, int H, int hd) {
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
    float2 a = unpack2<T>(*reinterpret_cast<const uint32_t*>(o + in + d));
    const float2 c =
        unpack2<T>(*reinterpret_cast<const uint32_t*>(dout + in + d));
    if (o_lo != nullptr) {
      const float2 r =
          unpack2<T>(*reinterpret_cast<const uint32_t*>(o_lo + in + d));
      a.x += r.x;
      a.y += r.y;
    }
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
  static constexpr int RBOX = BLK * 128;            // BLK rows x 64 T
  static constexpr int TBOX = BT * 128;             // BT rows x 64 T
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

// the terms a fp32 P or dS is split into before its product: 1 in bf16 (the
// rounding of P and dS to bf16), 2 in fp16 (hi + lo, see the note)
template <typename T>
constexpr int NTERM = is_f16<T> ? 2 : 1;

// D (64 x HDW) += A (64 x 16, registers) * B (16 x HDW, smem, MN-major)
template <int HDW, typename T>
__device__ __forceinline__ void rs_hd(float* d, const uint32_t* a,
                                      uint64_t db) {
  if constexpr (HDW == 128)
    wgmma_m64n128k16_rs<1, T>(d, a, db, 1);
  else if constexpr (HDW == 80)
    wgmma_m64n80k16_rs<1, T>(d, a, db, 1);
  else
    wgmma_m64n64k16_rs<1, T>(d, a, db, 1);
}

// acc (64 x 64) = A (64 x HDW) B^T (HDW x 64), ceil(HDW / 16) k steps: A
// rows of a resident BLK-row tile (da: its row offset included), B a
// BT-row stage, both K-major
template <int HDW, typename T>
__device__ __forceinline__ void ss_hd(float* acc, uint64_t da, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < (HDW + 15) / 16; ++kk) {
    const int aoff = (kk / 4) * (BLK * 128 / 16) + (kk % 4) * 2;
    const int boff = (kk / 4) * (BT * 128 / 16) + (kk % 4) * 2;
    wgmma_m64n64k16_ss<0, 0, T>(acc, da + aoff, db + boff, kk);
  }
}

// D (64 x HDW) += A B for the NTERM fragment sets of A (the 4 16-column
// slices of a 64 x 64 fp32 accumulator each) and B, a BT-row stage read
// MN-major (db: its descriptor, 64-column boxes L::TBOX bytes apart): one
// wgmma group, committed
template <int HDW, typename T>
__device__ __forceinline__ void rs_frags(float* d,
                                         uint32_t (&f)[NTERM<T>][4][4],
                                         uint64_t db) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NTERM<T>; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) rs_hd<HDW, T>(d, f[j][kk], db + 128 * kk);
  wgmma_commit();
}

// the m64n64 accumulator value v of this thread: its row (of the 64) and
// its column
__device__ __forceinline__ int acc_row(int tq, int v) {
  return 16 * (tq / 32) + (tq % 32) / 4 + 8 * ((v >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int tq, int v) {
  return 8 * (v >> 2) + 2 * (tq & 3) + (v & 1);
}

// 16-column slice kk of a 64 x 64 fp32 accumulator as A fragments of T:
// f[0] the rounding of x to T and, in fp16, f[1] the rounding of the rest,
// so that f[0] + f[1] keeps x's fp32 value as the reference does
template <typename T>
__device__ __forceinline__ void pack_frags(const float* x,
                                           uint32_t (&f)[NTERM<T>][4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x0 = x[8 * kk + 2 * i], x1 = x[8 * kk + 2 * i + 1];
      f[0][kk][i] = pack2<T>(x0, x1);
      if constexpr (NTERM<T> == 2) {
        const float2 h = unpack2<T>(f[0][kk][i]);
        f[1][kk][i] = pack2<T>(x0 - h.x, x1 - h.y);
      }
    }
}

// rows r_lo, r_lo + 8 (below row_end) and the columns below hd of a
// 64 x HDW fp32 accumulator, times mul, as T into the (row, hd) plane
// at ob, rows o_ss elements apart
template <int HDW, typename T>
__device__ __forceinline__ void store_acc(T* ob, long long o_ss,
                                          const float* acc, float mul,
                                          int r_lo, int row_end, int lane,
                                          int hd) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = r_lo + 8 * j;
    if (row >= row_end) continue;
#pragma unroll
    for (int nt = 0; nt < HDW / 8; ++nt) {
      if (nt * 8 >= hd) break;
      const int col = nt * 8 + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(ob + row * o_ss + col) = pack2<T>(
          acc[4 * nt + 2 * j] * mul, acc[4 * nt + 2 * j + 1] * mul);
    }
  }
}

// the pair (k row kr, q row qr) is live under the causal / window mask
__device__ __forceinline__ bool live_pair(int qr, int kr, int causal,
                                          int window) {
  return (!causal || kr <= qr) && (window <= 0 || qr - kr < window);
}

// HD: the tiles' padded head dim; HDW: the width the products run at; T:
// the element type
template <int HD, int HDW, typename T>
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

    float dk[HDW / 2], dv[HDW / 2];
#pragma unroll
    for (int v = 0; v < HDW / 2; ++v) dk[v] = dv[v] = 0.f;

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
        ss_hd<HDW, T>(st, ka, smem_desc(qs, 16, 1024));
        wgmma_commit();
        ss_hd<HDW, T>(dpt, va, smem_desc(os, 16, 1024));
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
        // dV += P^T dO (the stage's dO read MN-major): in bf16 issued here,
        // while dP^T may still run; in fp16 after dS^T is formed, so that
        // P^T's fp32 registers pass to its two fragment sets (dK + dV, S^T,
        // dP^T and both sets would not fit in 240 registers)
        const uint64_t dos = smem_desc(os, L::TBOX, 1024);
        uint32_t pf[NTERM<T>][4][4];
        if constexpr (NTERM<T> == 1) {
          pack_frags<T>(st, pf);
          wgmma_wait<0>();
          fence_regs<32>(dpt);
          rs_frags<HDW, T>(dv, pf, dos);
        } else {
          wgmma_wait<0>();
          fence_regs<32>(dpt);
        }

        // dS^T = P^T o (dP^T - D); dK += dS^T Q
#pragma unroll
        for (int v = 0; v < 32; ++v)
          dpt[v] = st[v] * (dpt[v] - dl[acc_col(tq, v)]);
        if constexpr (NTERM<T> == 2) {
          pack_frags<T>(st, pf);
          rs_frags<HDW, T>(dv, pf, dos);
        }
        uint32_t sf[NTERM<T>][4][4];
        pack_frags<T>(dpt, sf);
        rs_frags<HDW, T>(dk, sf, smem_desc(qs, L::TBOX, 1024));
        wgmma_wait<0>();
        fence_regs<HDW / 2>(dv);
        fence_regs<HDW / 2>(dk);
        fence_regs<16 * NTERM<T>>(&pf[0][0][0]);
        fence_regs<16 * NTERM<T>>(&sf[0][0][0]);
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }

    // dK (scaled) and dV at the KV head, rows below s
    const int r_lo = kr0 + acc_row(tq, 0);
    const long long base = static_cast<long long>(b) * P.s * kvh + kh;
    store_acc<HDW, T>(static_cast<T*>(P.dk) + base * P.hd,
                      static_cast<long long>(kvh) * P.hd, dk, P.scale, r_lo,
                      P.s, lane, P.hd);
    store_acc<HDW, T>(static_cast<T*>(P.dv) + base * P.hd,
                      static_cast<long long>(kvh) * P.hd, dv, 1.f, r_lo, P.s,
                      lane, P.hd);
  }
}

template <int HD, int HDW, typename T>
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

    float dq[HDW / 2];
#pragma unroll
    for (int v = 0; v < HDW / 2; ++v) dq[v] = 0.f;

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
      ss_hd<HDW, T>(sc, qa, smem_desc(ks, 16, 1024));
      wgmma_commit();
      ss_hd<HDW, T>(dp, oa, smem_desc(vs, 16, 1024));
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
      uint32_t sf[NTERM<T>][4][4];
      pack_frags<T>(dp, sf);
      rs_frags<HDW, T>(dq, sf, smem_desc(ks, L::TBOX, 1024));
      wgmma_wait<0>();
      fence_regs<HDW / 2>(dq);
      fence_regs<16 * NTERM<T>>(&sf[0][0][0]);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    const long long base = static_cast<long long>(b) * P.s * P.H + hh;
    store_acc<HDW, T>(static_cast<T*>(P.dq) + base * P.hd,
                      static_cast<long long>(P.H) * P.hd, dq, P.scale, r_lo,
                      P.s, lane, P.hd);
  }
}

// --------------------------------------------------------- wgmma (hd 256) ---

constexpr int BLK256 = 64;       // rows an hd-256 CTA owns (k in dkdv, q in dq)
constexpr int RING256 = 2;       // stages of its ring
constexpr int XCH_FULL = 1;      // named barriers of the consumers' exchange
constexpr int XCH_EMPTY = 2;

// Shared memory of an hd-256 CTA: the resident tiles R0, R1 (64 rows each),
// RING256 stages of the ring's tiles T0, T1 (64 rows each), the ring's lse
// / D (dkdv only), NX exchange buffers XB (one fp32 64 x 64 accumulator of
// a warpgroup each, value v of thread t at v * 128 + t), then the mbarriers
// res_full, full[], empty[].  A tile is 4 boxes of 64 rows x 64 columns.
template <int NX>
struct Layout256 {
  static constexpr int BOX = BLK256 * 128;
  static constexpr int TILE = 4 * BOX;                 // 32 KB
  static constexpr int XBUF = 32 * 128 * 4;            // 16 KB
  static constexpr int R0 = 0;
  static constexpr int R1 = R0 + TILE;
  static constexpr int T0 = R1 + TILE;                 // RING256 tiles
  static constexpr int T1 = T0 + RING256 * TILE;       // RING256 tiles
  static constexpr int LD = T1 + RING256 * TILE;       // RING256 x (lse, D)
  static constexpr int XB = LD + (NX == 1 ? RING256 * 2 * BT * 4 : 0);
  static constexpr int BAR = XB + NX * XBUF;
  static constexpr int BYTES = BAR + (1 + 2 * RING256) * 8 + 1024;  // + align
};

// acc (64 x 64) = A (64 x 256) B^T (256 x 64), A and B 64-row tiles, both
// K-major
template <typename T>
__device__ __forceinline__ void ss256(float* acc, uint64_t da, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const int off = (kk / 4) * (Layout256<1>::BOX / 16) + (kk % 4) * 2;
    wgmma_m64n64k16_ss<0, 0, T>(acc, da + off, db + off, kk);
  }
}

// D (64 x 128) += A (64 x 16, registers) times rows 16 kk .. 16 kk + 15 and
// columns 128 h .. 128 h + 127 of a 64-row tile read MN-major (db: the
// tile's descriptor, 64-column boxes BOX bytes apart)
template <typename T>
__device__ __forceinline__ void rs_half(float* d, const uint32_t* a,
                                        uint64_t db, int h, int kk) {
  constexpr int half = 2 * Layout256<1>::BOX / 16;     // two boxes on
  wgmma_m64n128k16_rs<1, T>(d, a, db + h * half + 128 * kk, 1);
}

// dkdv at hd 256: the CTA owns a 64-row k block.  Warpgroup 1 computes S^T
// = K Q^T, P^T, and dV += P^T dO; warpgroup 2 computes dP^T = V dO^T and,
// with warpgroup 1's fp32 P^T from the exchange buffer, dS^T and dK +=
// dS^T Q.  Each holds one 64 x 256 output (128 fp32 a thread).
template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
dkdv_wgmma_hd256(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap omap, const BwdParams P) {
  using L = Layout256<1>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* res_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = res_full + 1;
  uint64_t* empty = full + RING256;
  float* ld = reinterpret_cast<float*>(smem + L::LD);
  float* xb = reinterpret_cast<float*>(smem + L::XB);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < RING256; ++s) {
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
  const int k0 = kb * BLK256;
  // q tiles that see the block: [t_lo, t_hi), for each of the group's heads
  const int t_lo = P.causal ? k0 / BT : 0;
  const int t_hi =
      (P.window > 0 ? min(P.s, k0 + BLK256 - 1 + P.window) : P.s) + BT - 1;
  const int ntiles = t_hi / BT - t_lo;
  const int n = P.group * ntiles;

  if (wg == 0) {
    // ---- producer ----
    reg_dealloc<24>();
    if (tid == 0) {
      mbar_expect_tx(res_full, 2 * L::TILE);
      for (int j = 0; j < 4; ++j) {
        tma_load_4d(smem + L::R0 + j * L::BOX, &kmap, res_full, 64 * j, k0,
                    kh, b);
        tma_load_4d(smem + L::R1 + j * L::BOX, &vmap, res_full, 64 * j, k0,
                    kh, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % RING256;
        const int hh = kh * P.group + i / ntiles;
        const int q0 = (t_lo + i % ntiles) * BT;
        const long long lrow = (static_cast<long long>(b) * P.H + hh) * P.s_pad;
        mbar_wait(&empty[s], ((i / RING256) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * L::TILE + 2 * BT * 4);
        for (int j = 0; j < 4; ++j) {
          tma_load_4d(smem + L::T0 + s * L::TILE + j * L::BOX, &qmap,
                      &full[s], 64 * j, q0, hh, b);
          tma_load_4d(smem + L::T1 + s * L::TILE + j * L::BOX, &omap,
                      &full[s], 64 * j, q0, hh, b);
        }
        bulk_load(ld + s * 2 * BT, P.lse2 + lrow + q0, BT * 4, &full[s]);
        bulk_load(ld + s * 2 * BT + BT, P.delta + lrow + q0, BT * 4,
                  &full[s]);
      }
    }
  } else {
    // ---- consumers: c 0 owns dV, c 1 dK, both for k rows k0 .. k0 + 63 ----
    reg_alloc<240>();
    const int c = wg - 1;
    const int tq = tid % 128;
    const int lane = tid % 32;

    float acc[128];                 // two n128 halves: columns 0-127, 128-255
#pragma unroll
    for (int v = 0; v < 128; ++v) acc[v] = 0.f;

    // K (c 0) or V (c 1), the A of S^T = K Q^T or dP^T = V dO^T
    const uint64_t ra = smem_desc(smem + (c ? L::R1 : L::R0), 16, 1024);
    mbar_wait(res_full, 0);
    if (c == 1) named_bar_arrive(XCH_EMPTY, 256);   // the buffer starts empty

    for (int i = 0; i < n; ++i) {
      const int s = i % RING256;
      const int q0 = (t_lo + i % ntiles) * BT;
      unsigned char* qs = smem + L::T0 + s * L::TILE;
      unsigned char* os = smem + L::T1 + s * L::TILE;
      const float* lse2 = ld + s * 2 * BT;
      const float* dl = lse2 + BT;
      mbar_wait(&full[s], (i / RING256) & 1);

      // c 0: S^T = K Q^T; c 1: dP^T = V dO^T
      float x[32];
      wgmma_fence();
      ss256<T>(x, ra, smem_desc(c ? os : qs, 16, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(x);

      if (c == 0) {
        // P^T = exp2(S^T scale log2(e) - lse) (0 where masked), handed to
        // warpgroup 2 in fp32
        const bool mask = (P.causal && q0 < k0 + BLK256 - 1) ||
                          (P.window > 0 && q0 + BT - 1 - k0 >= P.window);
#pragma unroll
        for (int v = 0; v < 32; ++v) {
          const int col = acc_col(tq, v);
          float p = fast_exp2(fmaf(x[v], P.scale_log2, -lse2[col]));
          if (mask && !live_pair(q0 + col, k0 + acc_row(tq, v), P.causal,
                                 P.window))
            p = 0.f;
          x[v] = p;
        }
        named_bar_sync(XCH_EMPTY, 256);
#pragma unroll
        for (int v = 0; v < 32; ++v) xb[v * 128 + tq] = x[v];
        named_bar_arrive(XCH_FULL, 256);
      } else {
        // dS^T = P^T o (dP^T - D)
        named_bar_sync(XCH_FULL, 256);
#pragma unroll
        for (int v = 0; v < 32; ++v)
          x[v] = xb[v * 128 + tq] * (x[v] - dl[acc_col(tq, v)]);
        if (i + 1 < n) named_bar_arrive(XCH_EMPTY, 256);
      }

      // c 0: dV += P^T dO; c 1: dK += dS^T Q (the stage read MN-major)
      uint32_t fr[NTERM<T>][4][4];
      pack_frags<T>(x, fr);
      const uint64_t db = smem_desc(c ? qs : os, L::BOX, 1024);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NTERM<T>; ++j)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          rs_half<T>(acc, fr[j][kk], db, 0, kk);
          rs_half<T>(acc + 64, fr[j][kk], db, 1, kk);
        }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<128>(acc);
      fence_regs<16 * NTERM<T>>(&fr[0][0][0]);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // dV, or dK (scaled), at the KV head, rows below s
    const int r_lo = k0 + acc_row(tq, 0);
    const long long base = static_cast<long long>(b) * P.s * kvh + kh;
    store_acc<256, T>(static_cast<T*>(c ? P.dk : P.dv) + base * P.hd,
                      static_cast<long long>(kvh) * P.hd, acc,
                      c ? P.scale : 1.f, r_lo, P.s, lane, P.hd);
  }
}

// dq at hd 256: the CTA owns a head's 64-row q block.  Warpgroup 1
// computes S = Q K^T and P, warpgroup 2 dP = dO V^T; they swap P and dP in
// fp32 through the exchange buffers, each forms dS = P o (dP - D) (the same
// arithmetic on the same values, so the same bits) and accumulates half of
// dQ += dS K: columns 0-127 (c 0) or 128-255 (c 1), 64 fp32 a thread.
template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
dq_wgmma_hd256(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap omap, const BwdParams P) {
  using L = Layout256<2>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* res_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = res_full + 1;
  uint64_t* empty = full + RING256;
  float* xb = reinterpret_cast<float*>(smem + L::XB);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < RING256; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int lanes = P.batch * P.H;
  const int nqb = (P.s + BLK256 - 1) / BLK256;
  // high q blocks, which see the most k tiles under the causal mask, first
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x) / lanes;
  const int lane_id = static_cast<int>(blockIdx.x) % lanes;
  const int b = lane_id / P.H, hh = lane_id % P.H;
  const int kh = hh / P.group;
  const int q0 = qb * BLK256;
  // k columns the block sees: tiles [t_lo, t_lo + ntiles)
  const int t_lo = P.window > 0 ? max(0, q0 - P.window + 1) / BT : 0;
  const int c_hi = P.causal ? min(P.s, q0 + BLK256) : P.s;
  const int ntiles = (c_hi + BT - 1) / BT - t_lo;

  if (wg == 0) {
    // ---- producer ----
    reg_dealloc<24>();
    if (tid == 0) {
      mbar_expect_tx(res_full, 2 * L::TILE);
      for (int j = 0; j < 4; ++j) {
        tma_load_4d(smem + L::R0 + j * L::BOX, &qmap, res_full, 64 * j, q0,
                    hh, b);
        tma_load_4d(smem + L::R1 + j * L::BOX, &omap, res_full, 64 * j, q0,
                    hh, b);
      }
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % RING256;
        const int c0 = (t_lo + i) * BT;
        mbar_wait(&empty[s], ((i / RING256) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * L::TILE);
        for (int j = 0; j < 4; ++j) {
          tma_load_4d(smem + L::T0 + s * L::TILE + j * L::BOX, &kmap,
                      &full[s], 64 * j, c0, kh, b);
          tma_load_4d(smem + L::T1 + s * L::TILE + j * L::BOX, &vmap,
                      &full[s], 64 * j, c0, kh, b);
        }
      }
    }
  } else {
    // ---- consumers: q rows q0 .. q0 + 63, dQ columns 128 c .. ----
    reg_alloc<240>();
    const int c = wg - 1;
    const int tq = tid % 128;
    const int lane = tid % 32;
    const int r_lo = q0 + acc_row(tq, 0);       // and r_lo + 8
    // this thread's rows' lse log2(e) and D (rows past s: +inf and 0)
    const long long lrow = (static_cast<long long>(b) * P.H + hh) * P.s_pad;
    const float lse2[2] = {P.lse2[lrow + r_lo], P.lse2[lrow + r_lo + 8]};
    const float dl[2] = {P.delta[lrow + r_lo], P.delta[lrow + r_lo + 8]};
    float* mine = xb + c * 32 * 128;
    const float* other = xb + (1 - c) * 32 * 128;

    float dq[64];
#pragma unroll
    for (int v = 0; v < 64; ++v) dq[v] = 0.f;

    // Q (c 0) or dO (c 1), the A of S = Q K^T or dP = dO V^T
    const uint64_t ra = smem_desc(smem + (c ? L::R1 : L::R0), 16, 1024);
    mbar_wait(res_full, 0);

    for (int i = 0; i < ntiles; ++i) {
      const int s = i % RING256;
      const int c0 = (t_lo + i) * BT;
      unsigned char* ks = smem + L::T0 + s * L::TILE;
      unsigned char* vs = smem + L::T1 + s * L::TILE;
      mbar_wait(&full[s], (i / RING256) & 1);

      // c 0: S = Q K^T; c 1: dP = dO V^T
      float x[32];
      wgmma_fence();
      ss256<T>(x, ra, smem_desc(c ? vs : ks, 16, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(x);

      if (c == 0) {
        // P = exp2(S scale log2(e) - lse) (0 where masked or past s)
        const bool mask = (P.causal && c0 + BT - 1 > q0) ||
                          (P.window > 0 && q0 + BLK256 - 1 - c0 >= P.window) ||
                          c0 + BT > P.s;
#pragma unroll
        for (int v = 0; v < 32; ++v) {
          const int j = (v >> 1) & 1;
          float p = fast_exp2(fmaf(x[v], P.scale_log2, -lse2[j]));
          const int kc = c0 + acc_col(tq, v);
          if (mask && (kc >= P.s || !live_pair(r_lo + 8 * j, kc, P.causal,
                                               P.window)))
            p = 0.f;
          x[v] = p;
        }
      }
      // swap P and dP: the other warpgroup has read the previous tile's
      named_bar_sync(XCH_EMPTY, 256);
#pragma unroll
      for (int v = 0; v < 32; ++v) mine[v * 128 + tq] = x[v];
      named_bar_sync(XCH_FULL, 256);
      // dS = P o (dP - D)
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        const float y = other[v * 128 + tq];
        const float p = c ? y : x[v], dp = c ? x[v] : y;
        x[v] = p * (dp - dl[(v >> 1) & 1]);
      }

      // dQ[:, 128 c ..] += dS K (the stage read MN-major)
      uint32_t fr[NTERM<T>][4][4];
      pack_frags<T>(x, fr);
      const uint64_t db = smem_desc(ks, L::BOX, 1024);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NTERM<T>; ++j)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) rs_half<T>(dq, fr[j][kk], db, c, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<64>(dq);
      fence_regs<16 * NTERM<T>>(&fr[0][0][0]);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    const long long base = static_cast<long long>(b) * P.s * P.H + hh;
    store_acc<128, T>(static_cast<T*>(P.dq) + base * P.hd + 128 * c,
                      static_cast<long long>(P.H) * P.hd, dq, P.scale, r_lo,
                      P.s, lane, P.hd - 128 * c);
  }
}

// ------------------------------------------------------------- host ---

int check_params(const BwdParams& P, int dtype) {
  if (P.batch <= 0 || P.s <= 0 || P.H <= 0 || P.group <= 0 ||
      P.H % P.group != 0 || P.hd <= 0 || P.hd > 256 || P.hd % 8 != 0 ||
      P.s_pad != (P.s + SPAD - 1) / SPAD * SPAD ||
      (dtype != BF16 && dtype != F16))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse2, const void* delta,
                      void* dq, void* dk, void* dv, int batch, int s,
                      int s_pad, int H, int group, int hd, int causal,
                      int window, float scale) {
  BwdParams P;
  P.q = q; P.k = k; P.v = v; P.dout = dout;
  P.lse2 = static_cast<const float*>(lse2);
  P.delta = static_cast<const float*>(delta);
  P.dq = dq; P.dk = dk; P.dv = dv;
  P.batch = batch; P.s = s; P.s_pad = s_pad; P.H = H; P.group = group;
  P.hd = hd; P.causal = causal; P.window = window;
  P.scale = scale; P.scale_log2 = scale * LOG2E;
  return P;
}

// the four 4-D maps of q, dO (heads H) and k, v (heads H / group), all
// contiguous (b, s, heads, hd) of the dtype code dt, with boxes of 64
// columns x qrows / krows
int encode_maps(CUtensorMap* m, const BwdParams& P, int dt, int qrows,
                int krows) {
  const long long hd = P.hd, s = P.s, H = P.H, kvh = P.H / P.group;
  int rc = encode_bshd(&m[0], P.q, dt, P.batch, P.s, P.H, P.hd, s * H * hd,
                       hd, H * hd, qrows);
  if (rc == 0)
    rc = encode_bshd(&m[1], P.k, dt, P.batch, P.s, kvh, P.hd, s * kvh * hd,
                     hd, kvh * hd, krows);
  if (rc == 0)
    rc = encode_bshd(&m[2], P.v, dt, P.batch, P.s, kvh, P.hd, s * kvh * hd,
                     hd, kvh * hd, krows);
  if (rc == 0)
    rc = encode_bshd(&m[3], P.dout, dt, P.batch, P.s, P.H, P.hd, s * H * hd,
                     hd, H * hd, qrows);
  return rc;
}

template <int HD, bool DKDV, typename T, int HDW = HD>
int launch_wgmma(const BwdParams& P, cudaStream_t st) {
  CUtensorMap m[4];
  // dkdv: q / dO in the ring (BT rows), k / v resident (BLK); dq: the other
  // way round
  constexpr int dt = is_f16<T> ? F16 : BF16;
  int rc = DKDV ? encode_maps(m, P, dt, BT, BLK)
                : encode_maps(m, P, dt, BLK, BT);
  if (rc != 0) return rc;
  constexpr int bytes = BwdLayout<HD>::BYTES;
  auto kern = DKDV ? dkdv_wgmma<HD, HDW, T> : dq_wgmma<HD, HDW, T>;
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

template <bool DKDV, typename T>
int launch_wgmma_hd256(const BwdParams& P, cudaStream_t st) {
  CUtensorMap m[4];
  // resident and ring tiles are both 64 rows
  int rc = encode_maps(m, P, is_f16<T> ? F16 : BF16, BT, BLK256);
  if (rc != 0) return rc;
  constexpr int bytes = DKDV ? Layout256<1>::BYTES : Layout256<2>::BYTES;
  auto kern = DKDV ? dkdv_wgmma_hd256<T> : dq_wgmma_hd256<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long lanes =
      static_cast<long long>(P.batch) * (DKDV ? P.H / P.group : P.H);
  const long long grid = lanes * ((P.s + BLK256 - 1) / BLK256);
  kern<<<static_cast<unsigned>(grid), NTHREADS, bytes, st>>>(m[0], m[1], m[2],
                                                             m[3], P);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation of each head dim, at the element type T
template <bool DKDV, typename T>
int launch_t(const BwdParams& P, cudaStream_t st) {
  if (P.hd <= 64) return launch_wgmma<64, DKDV, T>(P, st);
  if (P.hd == 80) return launch_wgmma<128, DKDV, T, 80>(P, st);
  if (P.hd <= 128) return launch_wgmma<128, DKDV, T>(P, st);
  return launch_wgmma_hd256<DKDV, T>(P, st);
}

template <bool DKDV>
int launch(const BwdParams& P, int dtype, void* stream) {
  if (int rc = check_params(P, dtype)) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == F16 ? launch_t<DKDV, __half>(P, st)
                      : launch_t<DKDV, __nv_bfloat16>(P, st);
}

}  // namespace

// D and lse log2(e), both (b, h, s_pad), of o, dout (b, s, h, hd),
// contiguous bf16 (dtype 1) or fp16 (dtype 2), o_lo (the forward's
// rounding residual of o, the same layout; may be null) and the forward's
// lse (b, h, s)
extern "C" int flash_dense_bwd_delta_launch(const void* o, const void* o_lo,
                                            const void* dout, const void* lse,
                                            void* lse2, void* delta,
                                            int batch, int s, int s_pad,
                                            int H, int hd, int dtype,
                                            void* stream) {
  if (batch <= 0 || s <= 0 || H <= 0 || hd <= 0 || hd % 2 != 0 ||
      s_pad != (s + SPAD - 1) / SPAD * SPAD ||
      (dtype != BF16 && dtype != F16))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(batch) * s_pad * H;
  const unsigned grid = static_cast<unsigned>((rows + 3) / 4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* l2 = static_cast<float*>(lse2);
  float* d = static_cast<float*>(delta);
  if (dtype == F16)
    delta_kernel<__half><<<grid, 128, 0, st>>>(
        static_cast<const __half*>(o), static_cast<const __half*>(o_lo),
        static_cast<const __half*>(dout), l, l2, d, batch, s, s_pad, H, hd);
  else
    delta_kernel<__nv_bfloat16><<<grid, 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(o_lo),
        static_cast<const __nv_bfloat16*>(dout), l, l2, d, batch, s, s_pad, H,
        hd);
  return static_cast<int>(cudaGetLastError());
}

// dK, dV (b, s, kvh, hd) of q, dout (b, s, H, hd), k, v (b, s, kvh, hd),
// lse log2(e) and delta (b, H, s_pad); group = H / kvh; all 2-byte tensors
// of one dtype (1 bf16, 2 fp16)
extern "C" int flash_dense_bwd_dkdv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse2, const void* delta, void* dk, void* dv, int batch, int s,
    int s_pad, int H, int group, int hd, int causal, int window, int dtype,
    float scale, void* stream) {
  return launch<true>(make_params(q, k, v, dout, lse2, delta, nullptr, dk, dv,
                                  batch, s, s_pad, H, group, hd, causal,
                                  window, scale),
                      dtype, stream);
}

// dQ (b, s, H, hd) of the same inputs
extern "C" int flash_dense_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse2, const void* delta, void* dq, int batch, int s,
    int s_pad, int H, int group, int hd, int causal, int window, int dtype,
    float scale, void* stream) {
  return launch<false>(make_params(q, k, v, dout, lse2, delta, dq, nullptr,
                                   nullptr, batch, s, s_pad, H, group, hd,
                                   causal, window, scale),
                       dtype, stream);
}

extern "C" const char* flash_dense_bwd_error_string(int code) {
  return hopper::error_string(code);
}
