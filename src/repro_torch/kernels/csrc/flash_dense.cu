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
// Design (TMA + wgmma + warp specialisation):
//   * The TPU's sequential kv grid axis becomes a loop inside the CTA: one
//     CTA per (lane, 128-row q tile), walking 128-column kv tiles from the
//     first one the window reaches up to the causal diagonal.  Block x runs
//     q tile nq - 1 - x / lanes: the longest tiles of the causal triangle
//     are dispatched first and the short ones fill the tail.
//   * Three warpgroups.  One thread of warpgroup 0 (the producer, registers
//     cut to 24 by setmaxnreg) loads Q once and the K and V tiles into a
//     3-stage ring with TMA, each completion reported to its own mbarrier
//     (so S = Q K^T can start before V has landed).  q, k and v are mapped
//     as 4-D (b, s, heads, hd) tensors from their strides, so the model
//     layout and GQA's KV head hh / (H / KVH) are read in place; rows past
//     s arrive as zeros.  With SWIZZLE_128B a box is 64 columns wide, so an
//     hd-128 tile is two boxes.
//   * Warpgroups 1 and 2 (the consumers, 240 registers) own q rows 0-63 and
//     64-127.  Per kv tile: S = Q K^T with wgmma.m64n128k16 from shared
//     memory (K is (kv, hd), hd contiguous: K-major, as B wants); the
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
//     0, exactly, as on the TPU.  After its live columns, a masked column
//     gives p = exp2(-1e30 - m) = 0.  Every row of a dense causal or
//     windowed grid has at least its diagonal column, so no row is dead.
//   * Only rows below s are written, straight from the accumulators.
//   * The consumer side (softmax, the S and P V issues, the turns, the
//     epilogue) is shared with flash_sched.cu through flash_hopper.cuh.

#include "flash_hopper.cuh"

namespace {

using namespace flash_hopper;

struct DenseParams {
  __nv_bfloat16* o;
  long long o_sb, o_sh, o_ss;
  int lanes, nq, s, H, group, causal, window;
  float scale_log2;   // softmax scale * log2(e)
};

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_dense_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const DenseParams P) {
  using L = Layout<HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
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
  const int c_lo = P.window > 0 ? max(0, row0 - P.window + 1) / BKV * BKV : 0;
  const int c_hi = P.causal ? min(row0 + BQ, P.s) : P.s;
  const int ntiles = (c_hi - c_lo + BKV - 1) / BKV;

  if (wg == 0) {
    // ---- producer ----
    reg_dealloc<24>();
    if (tid == 0) {
      const int kvh = hh / P.group;
      mbar_expect_tx(q_full, L::TILE);
      for (int j = 0; j < L::NBOX; ++j)
        tma_load_4d(smem + L::Q + j * BOX, &qmap, q_full, 64 * j, row0, hh, b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES;
        const int col0 = c_lo + i * BKV;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], L::TILE);
        for (int j = 0; j < L::NBOX; ++j)
          tma_load_4d(smem + L::K + s * L::TILE + j * BOX, &kmap, &k_full[s],
                      64 * j, col0, kvh, b);
        mbar_expect_tx(&v_full[s], L::TILE);
        for (int j = 0; j < L::NBOX; ++j)
          tma_load_4d(smem + L::V + s * L::TILE + j * BOX, &vmap, &v_full[s],
                      64 * j, col0, kvh, b);
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

    float o[HD / 2];
#pragma unroll
    for (int v = 0; v < HD / 2; ++v) o[v] = 0.f;
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
      const int s = i % STAGES;
      const uint32_t ph = (i / STAGES) & 1;
      const int col0 = c_lo + i * BKV;
      const bool mask = col0 + BKV > P.s || (P.causal && col0 + BKV - 1 > r0) ||
                        (P.window > 0 && r0 + 63 - col0 >= P.window);

      // S = Q K^T
      float sacc[64];
      const uint64_t dk = smem_desc(smem + L::K + s * L::TILE, 16, 1024);
      mbar_wait(&k_full[s], ph);
      issue_s<HD>(sacc, dq, dk, c);

      uint32_t phi[8][4], plo[8][4];
      if (mask)
        softmax<HD, true>(sacc, m, l, o, phi, plo, col0, r_lo, lane, P);
      else
        softmax<HD, false>(sacc, m, l, o, phi, plo, col0, r_lo, lane, P);

      // O += (P_hi + P_lo) V
      const uint64_t dv = smem_desc(smem + L::V + s * L::TILE, BOX, 1024);
      mbar_wait(&v_full[s], ph);
      issue_pv<HD>(o, phi, plo, dv);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // consumer 1's last hand-over is taken here, so every turn is matched
    if (c == 0) named_bar_sync(TURN, 256);

    // out = o / l for the rows below s; rows that never saw a live column
    // (m <= NEG_INF / 2) are written as 0
    store_rows<HD>(P.o + b * P.o_sb + hh * P.o_sh, P.o_ss, o, m, l, r_lo,
                   P.s, lane);
  }
}

template <int HD>
int launch_hd(const CUtensorMap& qm, const CUtensorMap& km,
              const CUtensorMap& vm, const DenseParams& P, cudaStream_t st) {
  constexpr int bytes = Layout<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dense_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = static_cast<long long>(P.lanes) * P.nq;
  flash_dense_kernel<HD><<<static_cast<unsigned>(grid), NTHREADS, bytes, st>>>(
      qm, km, vm, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_dense_launch(
    const void* q, const void* k, const void* v, void* o, int batch, int s,
    int H, int group, int hd, int causal, int window, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, float scale,
    void* stream) {
  if (batch <= 0 || s <= 0 || H <= 0 || group <= 0 || H % group != 0 ||
      (hd != 64 && hd != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  const int kvh = H / group;
  int rc = encode_bshd(&qm, q, batch, s, H, hd, q_sb, q_sh, q_ss);
  if (rc == 0) rc = encode_bshd(&km, k, batch, s, kvh, hd, k_sb, k_sh, k_ss);
  if (rc == 0) rc = encode_bshd(&vm, v, batch, s, kvh, hd, v_sb, v_sh, v_ss);
  if (rc != 0) return rc;
  DenseParams P;
  P.o = static_cast<__nv_bfloat16*>(o);
  P.o_sb = o_sb; P.o_sh = o_sh; P.o_ss = o_ss;
  P.lanes = batch * H;
  P.nq = (s + BQ - 1) / BQ;
  P.s = s; P.H = H; P.group = group;
  P.causal = causal; P.window = window;
  P.scale_log2 = scale * LOG2E;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd == 128 ? launch_hd<128>(qm, km, vm, P, st)
                   : launch_hd<64>(qm, km, vm, P, st);
}

extern "C" const char* flash_dense_error_string(int code) {
  return error_string(code);
}
