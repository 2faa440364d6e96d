// Schedule-aware flash-attention forward for Hopper (sm_90a).
//
// Replaces: _flash_sched_kernel in src/repro/kernels/flash_attention/
// flash_attention.py (launched by flash_attention_sched_bhsd through one
// pl.pallas_call over a 1-D grid of live (lane, q block, kv block)
// descriptors in DLS plan order, the online-softmax state in VMEM scratch,
// reset on a group's `first` descriptor and written on its `last`).
//
// What bounds it on an H100: operations.  At the main path's shapes
// (32 query heads, 4 KV heads, head_dim 128, 8 ragged lanes of up to 4096,
// causal) the function does about 0.55 TFLOP over 0.56 GB, some 1,000
// operations per byte against the card's ~295, so the tensor cores are the
// limit and only wgmma reaches their rate.  The fp32 P V of the reference
// (P split into bf16 hi + lo) makes the P V half of the tensor work twice
// as large as a bf16-P kernel's.
//
// Design (flash_dense.cu's, made persistent over the plan):
//   * Persistent: the grid has p CTAs, one per plan worker.  CTA w walks
//     the descriptors [bounds[w], bounds[w+1]) in order -- exactly its
//     share of the DLS plan (KernelTilePlan.shares()[w]), so the plan's
//     worker_cost / cov / percent_imbalance describe what the card ran.
//   * A group is the run of descriptors from a `first` flag to a `last`
//     flag: one (lane, q block) and its live kv blocks, a contiguous
//     ascending run as the planner emits them; its descriptors are read
//     once.  Its units are its 128-row q tiles in ascending order, its kv
//     tiles the NKV-column tiles from the group's first kv column on.  A
//     tile dead for every row of the unit (above the diagonal, at or past
//     the lane's `lim`, below the window, or past the group's last kv
//     block) is never loaded; the live tiles of a unit are one range,
//     computed, not searched.  A unit's result depends on the unit alone,
//     so the output is bit-identical for every schedule and every p.
//   * Head dims: any multiple of 8 up to 256, instantiated as flash_dense.cu
//     is: up to 64 at a padded width of 64, 80 at its exact width on tiles
//     of 128, the others up to 128 at 128 (NKV 128-column K / V tiles, 3
//     stages), 136-256 at 256 with 64-column K / V tiles in 2 stages (Q 64
//     KB + 2 x (32 + 32) KB).  TMA fills the columns past the real head dim
//     with zeros and only the real columns are written.
//   * Three warpgroups, as in flash_dense.cu.  One thread of warpgroup 0
//     (the producer, registers cut to 24 by setmaxnreg) loads each unit's
//     Q tile and its K and V tiles into a ring of NST stages with TMA; q, k
//     and v are mapped as 4-D (b, s, heads, hd) tensors from their strides,
//     so the model layout and GQA's KV head hh / (H / KVH) are read in
//     place.  The producer and the consumers walk the same unit and tile
//     sequence through one inline iterator (Walk).
//   * Q + 3 K/V stages fill 224 KB at head dim 128, so Q is single-buffered:
//     the consumers release it on their own mbarrier (q_empty) as soon as
//     the unit's last S = Q K^T has completed, and the producer loads the
//     next unit's Q while they run the last P V and the epilogue.  The
//     ring's and Q's mbarrier phases carry on across units and groups: the
//     pipeline does not drain between units, and p = 1 wraps the ring many
//     times.
//   * Warpgroups 1 and 2 (the consumers, 240 registers) own q rows 0-63
//     and 64-127 of the unit and run flash_hopper.cuh's S = Q K^T (SS
//     wgmma, turns on named barriers), online softmax in the log2 domain
//     and O += (P_hi + P_lo) V (RS wgmma), as flash_dense.cu does.  A tile
//     pays for the mask arithmetic only where it crosses the causal
//     diagonal, the window's lower edge, the lane's `lim` or the end of
//     the group's kv blocks.
//   * The reference's _finalize: NEG_INF is -1e30 and is wiped by corr = 0
//     once a row sees its first live column; rows that never saw one
//     (m <= NEG_INF / 2) are written as 0, which covers a lane of `lim` 0
//     and a fully masked group (its single kv block dead for every row).
//   * Only the unit's rows are written: those below min(q block end, s).
//     With a q block of 64 rows the other half of the 128-row tile belongs
//     to another group (possibly another CTA): it is computed, not written.

#include "flash_hopper.cuh"

namespace {

using namespace flash_hopper;

struct SchedParams {
  __nv_bfloat16* o;
  long long o_sb, o_sh, o_ss;
  const int* desc;     // 6 x G int32: bi, qi, kj, first, last, lim
  const int* bounds;   // p + 1 int32: CTA w owns descriptors [b[w], b[w+1])
  int G, s, H, group, hd, block_q, block_k, causal, window;
  float scale_log2;    // softmax scale * log2(e)
};

// what softmax<> masks: columns >= s (here the group's column end), the
// causal diagonal and the window
struct MaskParams {
  int s, causal, window;
  float scale_log2;
};

// The unit sequence of one CTA, identical in the producer and the
// consumers.  next<NKV>() moves to the next unit (reading a new group's
// descriptors when the group is done), its live kv tiles counted in
// NKV-column tiles, and returns false at the end of the CTA's share.
struct Walk {
  int gend, gstop;                 // the next group starts at gend
  int lane_id, qb1, c_lo, c_end;   // the group: lane, row end, columns
  int row0, rend, tile0, ntiles;   // the unit: rows, live kv tiles

  __device__ __forceinline__ Walk(const SchedParams& P, int w)
      : gend(P.bounds[w]), gstop(P.bounds[w + 1]), qb1(0), row0(0) {}

  template <int NKV>
  __device__ __forceinline__ bool next(const SchedParams& P) {
    row0 += BQ;
    if (row0 >= qb1) {
      if (gend >= gstop) return false;
      const int g = gend;
      const int* kj = P.desc + 2 * P.G;
      const int* last = P.desc + 4 * P.G;
      int e = g;
      while (e < gstop - 1 && last[e] == 0) ++e;
      gend = e + 1;
      lane_id = P.desc[g];
      row0 = P.desc[P.G + g] * P.block_q;
      qb1 = min(row0 + P.block_q, P.s);
      c_lo = kj[g] * P.block_k;
      c_end = min(min((kj[e] + 1) * P.block_k, P.s), P.desc[5 * P.G + g]);
    }
    rend = min(row0 + BQ, qb1);
    // live columns of some row of the unit: [lo, hi)
    int lo = c_lo, hi = c_end;
    if (P.window > 0) lo = max(lo, row0 - P.window + 1);
    if (P.causal) hi = min(hi, rend);
    const int i0 = (lo - c_lo) / NKV;
    tile0 = c_lo + i0 * NKV;
    ntiles = hi > lo ? (hi - 1 - c_lo) / NKV - i0 + 1 : 0;
    return true;
  }
};

// HD: the padded head dim; NKV, NST: the K / V tile's columns and stages;
// HDW: the width the products run at
template <int HD, int NKV, int NST, int HDW>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_sched_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const SchedParams P) {
  using L = Layout<HD, NKV, NST>;
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

  Walk w(P, blockIdx.x);
  int it = 0;   // kv tiles so far: stage it % NST, phase it / NST
  int qn = 0;   // Q tiles so far: phase qn
  if (wg == 0) {
    // ---- producer ----
    reg_dealloc<24>();
    if (tid == 0) {
      while (w.next<NKV>(P)) {
        if (w.ntiles == 0) continue;
        const int b = w.lane_id / P.H;
        const int hh = w.lane_id % P.H;
        const int kvh = hh / P.group;
        mbar_wait(q_empty, (qn & 1) ^ 1);
        mbar_expect_tx(q_full, L::TILE);
        for (int j = 0; j < L::NBOX; ++j)
          tma_load_4d(smem + L::Q + j * BOX, &qmap, q_full, 64 * j, w.row0, hh,
                      b);
        ++qn;
        for (int i = 0; i < w.ntiles; ++i, ++it) {
          const int s = it % NST;
          const int col0 = w.tile0 + i * NKV;
          mbar_wait(&empty[s], ((it / NST) & 1) ^ 1);
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
    }
  } else {
    // ---- consumers: rows 64 c .. 64 c + 63 of each unit ----
    reg_alloc<240>();
    const int c = wg - 1;
    const int tq = tid % 128;
    const int lane = tid % 32;
    // Q of this warpgroup: rows 64 c .. of every box (K-major)
    const uint64_t dq = smem_desc(smem + L::Q + c * 64 * 128, 16, 1024);
    // the consumers take turns to issue S = Q K^T (named barrier 1 + c is
    // consumer c's turn) across every unit; consumer 0 goes first
    if (c == 1) named_bar_arrive(TURN, 256);

    while (w.next<NKV>(P)) {
      const int r0 = w.row0 + 64 * c;
      const int r_lo = r0 + 16 * (tq / 32) + lane / 4;   // and r_lo + 8
      const MaskParams mp{w.c_end, P.causal, P.window, P.scale_log2};
      float o[HDW / 2];
#pragma unroll
      for (int v = 0; v < HDW / 2; ++v) o[v] = 0.f;
      float m[2] = {NEG_INF, NEG_INF};
      float l[2] = {0.f, 0.f};

      if (w.ntiles > 0) {
        mbar_wait(q_full, qn & 1);
        ++qn;
      }
      for (int i = 0; i < w.ntiles; ++i, ++it) {
        const int s = it % NST;
        const uint32_t ph = (it / NST) & 1;
        const int col0 = w.tile0 + i * NKV;
        const bool mask = col0 + NKV > w.c_end ||
                          (P.causal && col0 + NKV - 1 > r0) ||
                          (P.window > 0 && r0 + 63 - col0 >= P.window);

        // S = Q K^T; after the unit's last one, Q goes back to the producer
        float sacc[NKV / 2];
        const uint64_t dk = smem_desc(smem + L::K + s * L::KVTILE, 16, 1024);
        mbar_wait(&k_full[s], ph);
        issue_s<HDW, NKV>(sacc, dq, dk, c);
        if (i == w.ntiles - 1 && lane == 0) mbar_arrive(q_empty);

        uint32_t phi[NKV / 16][4], plo[NKV / 16][4];
        if (mask)
          softmax<HDW, true, NKV>(sacc, m, l, o, phi, plo, col0, r_lo, lane,
                                  mp);
        else
          softmax<HDW, false, NKV>(sacc, m, l, o, phi, plo, col0, r_lo, lane,
                                   mp);

        // O += (P_hi + P_lo) V
        const uint64_t dv = smem_desc(smem + L::V + s * L::KVTILE, L::KVBOX,
                                      1024);
        mbar_wait(&v_full[s], ph);
        issue_pv<HDW, NKV>(o, phi, plo, dv);
        if (lane == 0) mbar_arrive(&empty[s]);
      }

      // the unit's rows only; dead rows (no live column) are written as 0
      const int b = w.lane_id / P.H;
      const int hh = w.lane_id % P.H;
      store_rows<HDW>(P.o + b * P.o_sb + hh * P.o_sh, P.o_ss, o, m, l, r_lo,
                      w.rend, lane, P.hd);
    }

    // consumer 1's last hand-over is taken here, so every turn is matched
    if (c == 0) named_bar_sync(TURN, 256);
  }
}

// q, k, v (b, s, heads, hd) by element strides, qs / ks / vs = (batch,
// head, row) strides; the K / V maps' boxes are NKV rows
template <int HD, int NKV = BKV, int NST = STAGES, int HDW = HD>
int launch_hd(const void* q, const void* k, const void* v, int batch,
              const long long* qs, const long long* ks, const long long* vs,
              const SchedParams& P, int p, cudaStream_t st) {
  CUtensorMap qm, km, vm;
  const int kvh = P.H / P.group;
  int rc = encode_bshd(&qm, q, batch, P.s, P.H, P.hd, qs[0], qs[1], qs[2]);
  if (rc == 0)
    rc = encode_bshd(&km, k, batch, P.s, kvh, P.hd, ks[0], ks[1], ks[2], NKV);
  if (rc == 0)
    rc = encode_bshd(&vm, v, batch, P.s, kvh, P.hd, vs[0], vs[1], vs[2], NKV);
  if (rc != 0) return rc;
  constexpr int bytes = Layout<HD, NKV, NST>::BYTES;
  auto kern = flash_sched_kernel<HD, NKV, NST, HDW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<p, NTHREADS, bytes, st>>>(qm, km, vm, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_sched_launch(
    const void* q, const void* k, const void* v, void* o, const void* desc,
    const void* bounds, int G, int p, int batch, int s, int H, int group,
    int hd, int block_q, int block_k, int causal, int window, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, float scale,
    void* stream) {
  if (p <= 0 || G < 0 || batch <= 0 || s <= 0 || H <= 0 || group <= 0 ||
      H % group != 0 || block_q <= 0 || block_k <= 0 || hd <= 0 ||
      hd > 256 || hd % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long qs[3] = {q_sb, q_sh, q_ss}, ks[3] = {k_sb, k_sh, k_ss},
                  vs[3] = {v_sb, v_sh, v_ss};
  SchedParams P;
  P.o = static_cast<__nv_bfloat16*>(o);
  P.o_sb = o_sb; P.o_sh = o_sh; P.o_ss = o_ss;
  P.desc = static_cast<const int*>(desc);
  P.bounds = static_cast<const int*>(bounds);
  P.G = G; P.s = s; P.H = H; P.group = group; P.hd = hd;
  P.block_q = block_q; P.block_k = block_k;
  P.causal = causal; P.window = window;
  P.scale_log2 = scale * LOG2E;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return launch_hd<64>(q, k, v, batch, qs, ks, vs, P, p, st);
  if (hd == 80)
    return launch_hd<128, BKV, STAGES, 80>(q, k, v, batch, qs, ks, vs, P, p,
                                           st);
  if (hd <= 128) return launch_hd<128>(q, k, v, batch, qs, ks, vs, P, p, st);
  return launch_hd<256, 64, 2>(q, k, v, batch, qs, ks, vs, P, p, st);
}

extern "C" const char* flash_sched_error_string(int code) {
  return error_string(code);
}
