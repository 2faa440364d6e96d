// Dense causal / sliding-window flash-attention forward for Hopper (sm_90a).
//
// Replaces: _flash_kernel in src/repro/kernels/flash_attention/
// flash_attention.py (launched by flash_attention_bhsd through one
// pl.pallas_call over a (bh, q blocks, kv blocks) grid, kv innermost, the
// online-softmax state carried in VMEM scratch across kv steps).
//
// What bounds it on an H100: operations.  At the prefill of qwen3-4b
// (1 x 4096 tokens, 32 query heads, 8 KV heads, head_dim 128, causal) the
// function does 4 * 128 operations per live (row, column) pair, about
// 137 GFLOP, over about 84 MB of q, k, v and out: some 1,600 operations per
// byte against the card's ~295, so the tensor cores are the limit, and only
// wgmma reaches their rate.  Keeping the reference's fp32 P V (P split into
// bf16 hi + lo) makes the P V half of the tensor work twice as large: 1.5x
// the MMA work of a bf16-P kernel.  Next to the MMAs, the softmax costs two
// MUFU-class instructions per score (the exp2 and the bf16 conversions).
//
// Head dims: any multiple of 8 up to 256 (TMA wants 16-byte row strides).
// The kernel computes at a padded width HD of 64, 128 or 256: the tensor
// maps keep the real head dim, so TMA fills the columns past it with zeros,
// which change neither Q K^T nor the live columns of P V, and only the real
// columns are written.  stablelm-3b's 80 keeps the tiles of 128 (two boxes,
// zeros past column 80) but runs its products at their exact width (HDW
// 80): S = Q K^T in 5 k steps of 16 instead of 8, O += P V as one
// wgmma.m64n80k16 instead of an n128, so O is 40 registers a thread, not
// 64.  The steps dropped add only products of zeros (+0.0 to each fp32
// sum) and the n80's columns are the n128's first 80, so the output has the
// bits of the padded kernel at 0.625x its MMA work.  At HD 256
// (recurrentgemma-2b) neither the shared
// memory nor the registers of the 128-column tile fit (Q 64 KB + 3 x 128 KB
// of K / V; O alone is 128 registers a thread), so that instantiation takes
// 64-column K / V tiles in 2 stages (Q 64 KB + 2 x 64 KB; S 32, P hi + lo
// 32 registers) and runs P V as two n128 halves.
//
// Element types: bf16 and fp16 (the launcher's dtype code 1 or 2), each
// instantiated at the four tile shapes (<64,128,3>, <128,128,3,80>,
// <128,128,3>, <256,64,2>).  The reference casts q, k and v to fp32, so its
// products and its P are fp32; here q, k and v enter wgmma as they are
// (.bf16 or .f16: their products are exact in the fp32 accumulators, the
// tensor cores' rate is the same for both types) and P = hi + lo in the
// input's type.  fp16 changes only the conversions and the rounding:
//   * hi + lo keeps 2 x 11 bits of p where bf16 keeps 2 x 8, but fp16's
//     range is narrow.  lo, about 2^-11 p, goes subnormal once p < 2^-3
//     (steps of 2^-24), and an hi below fp16's smallest subnormal (2^-24,
//     about 6e-8) rounds to 0.  p = exp2(s - m) is at most 1 and l >= 1,
//     so hi + lo misses p by at most 2^-25 (half a subnormal step), about
//     3e-8 of a column's weight at most, and by 2^-22 p while lo is
//     normal (bf16's hi + lo: 2^-18 p).
//   * The output is rounded to fp16 once.  Given o_lo, the epilogue also
//     writes o - fp16(o) in fp16, the residual the backward's delta pass
//     adds back (flash_dense_bwd.cu's note says why); the Python side asks
//     for it under autograd in fp16 only.
//   * TMA moves the 2-byte elements as it does bf16 (its zero fill is +0.0
//     in both), so the tiles, the ring and the turns are the bf16 kernel's.
//
// Design (TMA + wgmma + warp specialisation):
//   * The TPU's sequential kv grid axis becomes a loop inside the CTA: one
//     CTA per (lane, 128-row q tile), walking NKV-column kv tiles (128, or
//     64 at HD 256) from the
//     first one the window reaches up to the causal diagonal.  Block x runs
//     q tile nq - 1 - x / lanes: the longest tiles of the causal triangle
//     are dispatched first and the short ones fill the tail.
//   * Three warpgroups.  One thread of warpgroup 0 (the producer, registers
//     cut to 24 by setmaxnreg) loads Q once and the K and V tiles into a
//     ring of NST stages (3, or 2 at HD 256) with TMA, each completion
//     reported to its own mbarrier
//     (so S = Q K^T can start before V has landed).  q, k and v are mapped
//     as 4-D (b, s, heads, hd) tensors from their strides, so the model
//     layout and GQA's KV head hh / (H / KVH) are read in place; rows past
//     s, and columns past the head dim, arrive as zeros.  With SWIZZLE_128B
//     a box is 64 columns wide, so a tile of padded width HD is HD / 64
//     boxes.
//   * Warpgroups 1 and 2 (the consumers, 240 registers) own q rows 0-63 and
//     64-127.  Per kv tile: S = Q K^T with wgmma.m64n128k16 from shared
//     memory (wgmma.m64n64k16 at HD 256; K is (kv, hd), hd contiguous:
//     K-major, as B wants); the
//     online softmax in registers with ex2.approx, scale * log2(e) folded
//     into the scores; O += P V with wgmma RS: P from registers as the A
//     operand, V (MN-major) from shared memory through the transpose bit.
//     P is kept fp32 as in the reference (which multiplies p, fp32, by v
//     cast to fp32): P = hi + lo in bf16, two RS wgmmas into one fp32
//     accumulator.  Both consumers read the same K / V stage and hand it
//     back to the producer with one arrival per warp.
//   * The consumers take turns to issue S = Q K^T (two named barriers), so
//     the tensor cores work for one while the other runs its softmax.
//   * Masking only where needed: a tile pays for the mask arithmetic only
//     when it crosses the causal diagonal, the window's lower edge or the
//     ragged end s for this warpgroup's rows; full tiles take one FFMA and
//     one exp2 per score.
//   * NEG_INF is -1e30 in the log2 domain, not -inf.  A row whose columns in
//     a tile are all masked before its first live column (a window narrower
//     than a tile) sees p = exp2(-1e30 - -1e30) = 1 there; the tile that
//     brings its first real column wipes that with corr = exp2(-1e30 - m) =
//     0, exactly, as on the TPU; the rule holds for a tile of any width
//     (recurrentgemma-2b's window of 2048 spans 32 of its 64-column tiles
//     plus the diagonal's).  After its live columns, a masked column
//     gives p = exp2(-1e30 - m) = 0.  Every row of a dense causal or
//     windowed grid has at least its diagonal column, so no row is dead.
//   * Only rows below s and columns below the head dim are written,
//     straight from the accumulators.  Given a pointer, the epilogue also
//     writes each row's log-sum-exp, lse = (m + log2 l) ln 2 in fp32, laid
//     out (b, h, s): the residual flash_dense_bwd.cu reads.  O does not
//     depend on it.
//   * The consumer side (softmax, the S and P V issues, the turns, the
//     epilogue) is shared with flash_sched.cu through flash_hopper.cuh.

#include "flash_hopper.cuh"

namespace {

using namespace flash_hopper;

struct DenseParams {
  void* o;            // (b, s, h, hd) of the kernel's element type
  void* o_lo;         // o's rounding residual, laid out as o, or null
  float* lse;         // (b, h, s) log-sum-exp of each row, or null
  long long o_sb, o_sh, o_ss;
  int lanes, nq, s, H, group, hd, causal, window;
  float scale_log2;   // softmax scale * log2(e)
};

// o_lo = o / l - T(o / l) as T for the rows and columns store_rows writes,
// at the same offsets: what rounding the output to T dropped, which the
// backward's delta pass adds back (its D is then the fp32 output's, as in
// the reference)
template <int HDW, typename T>
__device__ __forceinline__ void store_residual(T* ob, long long o_ss,
                                               const float* o,
                                               const float (&m)[2],
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
      const float x0 = o[4 * nt + 2 * j] * inv;
      const float x1 = o[4 * nt + 2 * j + 1] * inv;
      const float2 h = unpack2<T>(pack2<T>(x0, x1));
      *reinterpret_cast<uint32_t*>(ob + row * o_ss + col) =
          pack2<T>(x0 - h.x, x1 - h.y);
    }
  }
}

template <typename T, int HD, int NKV, int NST, int HDW>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_dense_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const DenseParams P) {
  using L = Layout<HD, NKV, NST>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + NST;
  uint64_t* empty = v_full + NST;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // bottom (longest) q tiles first
  const int qt = P.nq - 1 - static_cast<int>(blockIdx.x) / P.lanes;
  const int lane_id = static_cast<int>(blockIdx.x) % P.lanes;
  const int b = lane_id / P.H;
  const int hh = lane_id % P.H;
  const int row0 = qt * BQ;
  // live columns: from the window's reach of the first row (rounded down to
  // a tile) to the diagonal of the last row (causal) or the end
  const int c_lo = P.window > 0 ? max(0, row0 - P.window + 1) / NKV * NKV : 0;
  const int c_hi = P.causal ? min(row0 + BQ, P.s) : P.s;
  const int ntiles = (c_hi - c_lo + NKV - 1) / NKV;

  if (wg == 0) {
    // ---- producer ----
    reg_dealloc<24>();
    if (tid == 0) {
      const int kvh = hh / P.group;
      mbar_expect_tx(q_full, L::TILE);
      for (int j = 0; j < L::NBOX; ++j)
        tma_load_4d(smem + L::Q + j * BOX, &qmap, q_full, 64 * j, row0, hh, b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % NST;
        const int col0 = c_lo + i * NKV;
        mbar_wait(&empty[s], ((i / NST) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], L::KVTILE);
        for (int j = 0; j < L::NBOX; ++j)
          tma_load_4d(smem + L::K + s * L::KVTILE + j * L::KVBOX, &kmap,
                      &k_full[s], 64 * j, col0, kvh, b);
        mbar_expect_tx(&v_full[s], L::KVTILE);
        for (int j = 0; j < L::NBOX; ++j)
          tma_load_4d(smem + L::V + s * L::KVTILE + j * L::KVBOX, &vmap,
                      &v_full[s], 64 * j, col0, kvh, b);
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

    // Q of this warpgroup: rows 64 c .. of every box (K-major)
    const uint64_t dq = smem_desc(smem + L::Q + c * 64 * 128, 16, 1024);
    mbar_wait(q_full, 0);
    // the consumers take turns to issue S = Q K^T (named barrier 1 + c is
    // consumer c's turn), so that one runs its softmax while the tensor
    // cores work for the other; consumer 0 goes first
    if (c == 1) named_bar_arrive(TURN, 256);

    for (int i = 0; i < ntiles; ++i) {
      const int s = i % NST;
      const uint32_t ph = (i / NST) & 1;
      const int col0 = c_lo + i * NKV;
      const bool mask = col0 + NKV > P.s || (P.causal && col0 + NKV - 1 > r0) ||
                        (P.window > 0 && r0 + 63 - col0 >= P.window);

      // S = Q K^T
      float sacc[NKV / 2];
      const uint64_t dk = smem_desc(smem + L::K + s * L::KVTILE, 16, 1024);
      mbar_wait(&k_full[s], ph);
      issue_s<HDW, NKV, T>(sacc, dq, dk, c);

      uint32_t phi[NKV / 16][4], plo[NKV / 16][4];
      if (mask)
        softmax<HDW, true, NKV, T>(sacc, m, l, o, phi, plo, col0, r_lo, lane,
                                   P);
      else
        softmax<HDW, false, NKV, T>(sacc, m, l, o, phi, plo, col0, r_lo, lane,
                                    P);

      // O += (P_hi + P_lo) V
      const uint64_t dv = smem_desc(smem + L::V + s * L::KVTILE, L::KVBOX,
                                    1024);
      mbar_wait(&v_full[s], ph);
      issue_pv<HDW, NKV, T>(o, phi, plo, dv);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // consumer 1's last hand-over is taken here, so every turn is matched
    if (c == 0) named_bar_sync(TURN, 256);

    // out = o / l for the rows below s and the columns below hd; rows that
    // never saw a live column (m <= NEG_INF / 2) are written as 0
    store_rows<HDW, T>(static_cast<T*>(P.o) + b * P.o_sb + hh * P.o_sh,
                       P.o_ss, o, m, l, r_lo, P.s, lane, P.hd);
    if (P.o_lo != nullptr)
      store_residual<HDW, T>(
          static_cast<T*>(P.o_lo) + b * P.o_sb + hh * P.o_sh, P.o_ss, o, m,
          l, r_lo, P.s, lane, P.hd);
    // lse = (m + log2 l) ln 2 of the rows below s (+inf for a row with no
    // live column, so that the backward's exp(S - lse) is 0 there)
    if (P.lse != nullptr && (lane & 3) == 0) {
      float* lrow = P.lse + static_cast<long long>(lane_id) * P.s;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = r_lo + 8 * j;
        if (row < P.s)
          lrow[row] = m[j] > NEG_INF * 0.5f
                          ? (m[j] + log2f(l[j])) * 0.6931471805599453f
                          : __int_as_float(0x7f800000);
      }
    }
  }
}

// T: the element type; HD: the padded head dim; NKV, NST: the K / V
// tile's columns and stages; HDW: the width the products run at
template <typename T, int HD, int NKV, int NST, int HDW = HD>
int launch_hd(const void* q, const void* k, const void* v, int batch, int kvh,
              int hd, const long long* qs, const long long* ks,
              const long long* vs, const DenseParams& P, cudaStream_t st) {
  constexpr int dt = is_f16<T> ? F16 : BF16;
  CUtensorMap qm, km, vm;
  int rc = encode_bshd(&qm, q, dt, batch, P.s, P.H, hd, qs[0], qs[1], qs[2]);
  if (rc == 0)
    rc = encode_bshd(&km, k, dt, batch, P.s, kvh, hd, ks[0], ks[1], ks[2],
                     NKV);
  if (rc == 0)
    rc = encode_bshd(&vm, v, dt, batch, P.s, kvh, hd, vs[0], vs[1], vs[2],
                     NKV);
  if (rc != 0) return rc;
  constexpr int bytes = Layout<HD, NKV, NST>::BYTES;
  auto kern = flash_dense_kernel<T, HD, NKV, NST, HDW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = static_cast<long long>(P.lanes) * P.nq;
  kern<<<static_cast<unsigned>(grid), NTHREADS, bytes, st>>>(qm, km, vm, P);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation of each head dim, at the element type T
template <typename T>
int launch_t(const void* q, const void* k, const void* v, int batch, int kvh,
             int hd, const long long* qs, const long long* ks,
             const long long* vs, const DenseParams& P, cudaStream_t st) {
  if (hd <= 64)
    return launch_hd<T, 64, 128, 3>(q, k, v, batch, kvh, hd, qs, ks, vs, P,
                                    st);
  if (hd == 80)
    return launch_hd<T, 128, 128, 3, 80>(q, k, v, batch, kvh, hd, qs, ks, vs,
                                         P, st);
  if (hd <= 128)
    return launch_hd<T, 128, 128, 3>(q, k, v, batch, kvh, hd, qs, ks, vs, P,
                                     st);
  return launch_hd<T, 256, 64, 2>(q, k, v, batch, kvh, hd, qs, ks, vs, P, st);
}

}  // namespace

// q (b, s, H, hd), k / v (b, s, H / group, hd) and o (b, s, H, hd), all
// bf16 (dtype 1) or fp16 (dtype 2), by their (batch, head, row) element
// strides; o_lo (o's rounding residual, o's strides) or null; lse
// (b, H, s) fp32 or null
extern "C" int flash_dense_launch(
    const void* q, const void* k, const void* v, void* o, void* o_lo,
    void* lse, int batch, int s, int H, int group, int hd, int causal,
    int window, int dtype,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    float scale, void* stream) {
  if (batch <= 0 || s <= 0 || H <= 0 || group <= 0 || H % group != 0 ||
      hd <= 0 || hd > 256 || hd % 8 != 0 || (dtype != BF16 && dtype != F16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kvh = H / group;
  const long long qs[3] = {q_sb, q_sh, q_ss}, ks[3] = {k_sb, k_sh, k_ss},
                  vs[3] = {v_sb, v_sh, v_ss};
  DenseParams P;
  P.o = o;
  P.o_lo = o_lo;
  P.lse = static_cast<float*>(lse);
  P.o_sb = o_sb; P.o_sh = o_sh; P.o_ss = o_ss;
  P.lanes = batch * H;
  P.nq = (s + BQ - 1) / BQ;
  P.s = s; P.H = H; P.group = group; P.hd = hd;
  P.causal = causal; P.window = window;
  P.scale_log2 = scale * LOG2E;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == F16
             ? launch_t<__half>(q, k, v, batch, kvh, hd, qs, ks, vs, P, st)
             : launch_t<__nv_bfloat16>(q, k, v, batch, kvh, hd, qs, ks, vs,
                                       P, st);
}

extern "C" const char* flash_dense_error_string(int code) {
  return error_string(code);
}
