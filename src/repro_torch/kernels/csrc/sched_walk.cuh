// The walk of a persistent schedule-aware flash-attention CTA over its
// share of the DLS plan, shared by flash_sched.cu (bf16) and flash_f32.cu
// (fp32 on the tensor cores).
//
// CTA w runs the descriptors [bounds[w], bounds[w+1]) in order.  A group
// is the run of descriptors from a `first` flag to a `last` flag: one
// (lane, q block) and its live kv blocks, a contiguous ascending run as the
// planner emits them; its descriptors are read once.  Its units are its
// BQ-row q tiles in ascending order, its kv tiles the NKV-column tiles from
// the group's first kv column on (ABS: from the NKV-aligned column at or
// below it, for kernels whose copies of V are permuted in aligned groups;
// the columns below the group's then count as masked).  A tile dead for
// every row of the unit (above the diagonal, at or past the lane's `lim`,
// below the window, or past the group's last kv block) is never visited;
// the live tiles of a unit are one range, computed, not searched.

#pragma once

namespace sched_walk {

// The unit sequence of one CTA, identical in the producer and the
// consumers.  next<NKV>() moves to the next unit (reading a new group's
// descriptors when the group is done), its live kv tiles counted in
// NKV-column tiles, and returns false at the end of the CTA's share.
// Params: desc (6 x G int32: bi, qi, kj, first, last, lim), bounds, G, s,
// block_q, block_k, causal, window.
template <int BQ>
struct Walk {
  int gend, gstop;                 // the next group starts at gend
  int lane_id, qb1, c_lo, c_end;   // the group: lane, row end, columns
  int row0, rend, tile0, ntiles;   // the unit: rows, live kv tiles

  template <typename Params>
  __device__ __forceinline__ Walk(const Params& P, int w)
      : gend(P.bounds[w]), gstop(P.bounds[w + 1]), qb1(0), row0(0) {}

  template <int NKV, bool ABS = false, typename Params>
  __device__ __forceinline__ bool next(const Params& P) {
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
    const int org = ABS ? c_lo / NKV * NKV : c_lo;
    const int i0 = (lo - org) / NKV;
    tile0 = org + i0 * NKV;
    ntiles = hi > lo ? (hi - 1 - org) / NKV - i0 + 1 : 0;
    return true;
  }
};

}  // namespace sched_walk
