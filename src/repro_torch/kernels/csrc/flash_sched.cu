// Schedule-aware flash-attention forward for Hopper (sm_90a).
//
// Replaces: _flash_sched_kernel in src/repro/kernels/flash_attention/
// flash_attention.py (launched by flash_attention_sched_bhsd through one
// pl.pallas_call over a 1-D grid of live (lane, q block, kv block) triples).
//
// What bounds it on an H100: operations.  At the main path's shapes
// (32 query heads, 4 KV heads, head_dim 128, 8 ragged lanes of up to 4096,
// causal) the function does about 1,000 operations per byte it must move
// (0.55 TFLOP over 0.56 GB), above the card's ~295 operations per byte, so
// the tensor cores are the limit.  K and V are re-read once per 128-row q
// sub-tile; they come from L2.  The kernel uses warp-level mma.sync
// (m16n8k16, bf16 in, fp32 accumulate) fed by ldmatrix, and cp.async
// double-buffers the K/V sub-tiles so the next one loads while the current
// one is multiplied; wgmma, TMA and a producer warp are later work.
//
// Design:
//   * Persistent: the grid has p CTAs, one per plan worker.  CTA w walks the
//     descriptors [bounds[w], bounds[w+1]) in order -- exactly its share of
//     the DLS plan (KernelTilePlan.shares()[w]).  The hardware block
//     scheduler therefore cannot reorder the plan, and the plan's
//     worker_cost / cov / percent_imbalance describe what the card ran.
//   * One CTA does one whole (lane, q block) group, its kv blocks ascending,
//     so every schedule gives a bit-identical output.
//   * 512 x 512 stays the planning unit.  A 512-row fp32 q block does not fit
//     the 227 KB of shared memory a block may use, so the group is tiled:
//     128-row q sub-tiles (8 warps x 16 rows, row state m / l / acc in
//     registers) against 64-column kv sub-tiles (K and V staged in shared
//     memory, two stages; ldmatrix.trans gives V's B fragments).  The online softmax is updated per 64-column sub-tile, the
//     TPU kernel updates it per 512-column block: the two agree within a
//     tolerance, not bitwise.
//   * The math is fp32 as on the TPU, which casts q, k and v to fp32.  bf16
//     products are exact in fp32, so Q K^T on bf16 tensor cores with fp32
//     accumulation is fp32 math.  P is fp32; it is split into two bf16 terms
//     (hi + lo, 16 significant bits) for P V, two MMAs into one fp32
//     accumulator.
//   * NEG_INF is -1e30, not -inf: a fully masked row sees
//     exp(-1e30 - -1e30) = 1 and is zeroed at the end, as on the TPU.  State
//     resets on a group's `first` descriptor and is written on its `last`;
//     rows that never saw a live column (m <= NEG_INF / 2) are written as 0.
//     A kv sub-tile that is masked for every row of the q sub-tile is
//     skipped: it would leave m, l and acc of every live row unchanged
//     exactly (p = 0, corr = 1), and dead rows are zeroed anyway.
//   * GQA: the kernel indexes KV head hh / (H / KVH); the broadcast is never
//     materialised.  Tensors are addressed through (batch, head, row)
//     strides, so the model layout (b, s, h, hd) is read in place.
//   * The sub-tile machinery (cp.async staging, ldmatrix, mma.sync, the
//     online-softmax step, the epilogue) is shared with flash_dense.cu
//     through flash_common.cuh.

#include "flash_common.cuh"

namespace {

using namespace flash;

struct FlashParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const int* desc;     // 6 x G int32: bi, qi, kj, first, last, lim
  const int* bounds;   // p + 1 int32: CTA w owns descriptors [b[w], b[w+1])
  int G, s, H, group, block_q, block_k, causal, window;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;
};

// the next kv sub-tile of the group, from (gg, c) on, that is live for some
// row of the q sub-tile [row0, rlast]; uniform across the CTA
__device__ __forceinline__ bool seek_live(const FlashParams& P,
                                          const int* kj_a, int gend, int lim,
                                          int row0, int rlast, int& gg,
                                          int& c, int& col0, int& kb1) {
  for (; gg < gend; ++gg, c = 0) {
    const int kb0 = kj_a[gg] * P.block_k;
    kb1 = min(kb0 + P.block_k, P.s);
    for (; kb0 + c < kb1; c += BK) {
      col0 = kb0 + c;
      const int clast = min(col0 + BK, kb1) - 1;
      const bool dead = col0 >= lim || (P.causal && col0 > rlast) ||
                        (P.window > 0 && row0 - clast >= P.window);
      if (!dead) return true;
    }
  }
  return false;
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_sched_kernel(const FlashParams P) {
  constexpr int TILE = BK * (HD + 8);   // one K or V sub-tile (bf16)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage s: K at smem + 2 s TILE, V right after it
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int fr = lane / 4;         // fragment row within an 8-row half
  const int fc = (lane % 4) * 2;   // fragment column pair
  const int lm = lane / 8;         // ldmatrix: which 8x8 matrix
  const int lr = lane % 8;         // ldmatrix: which row of it

  const int* bi_a = P.desc;
  const int* qi_a = P.desc + P.G;
  const int* kj_a = P.desc + 2 * P.G;
  const int* lst_a = P.desc + 4 * P.G;
  const int* lim_a = P.desc + 5 * P.G;

  int g = P.bounds[blockIdx.x];
  const int gstop = P.bounds[blockIdx.x + 1];
  while (g < gstop) {
    // the group runs from its `first` descriptor g to its `last` one
    int gend = g;
    while (gend < gstop - 1 && lst_a[gend] == 0) ++gend;
    ++gend;
    const int lane_id = bi_a[g];
    const int lim = lim_a[g];
    const int b = lane_id / P.H;
    const int hh = lane_id % P.H;
    const int kvh = hh / P.group;
    const __nv_bfloat16* qb = P.q + b * P.q_sb + hh * P.q_sh;
    const __nv_bfloat16* kb = P.k + b * P.k_sb + kvh * P.k_sh;
    const __nv_bfloat16* vb = P.v + b * P.v_sb + kvh * P.v_sh;
    __nv_bfloat16* ob = P.o + b * P.o_sb + hh * P.o_sh;
    const int qb0 = qi_a[g] * P.block_q;
    const int qb1 = min(qb0 + P.block_q, P.s);

    for (int row0 = qb0; row0 < qb1; row0 += BQ) {
      const int rlast = min(row0 + BQ, qb1) - 1;
      const int r_lo = row0 + warp * 16 + fr;
      const int r_hi = r_lo + 8;

      uint32_t qf[HD / 16][4];
      load_q<HD>(qf, qb, P.q_ss, r_lo, r_hi, qb1, fc);

      float m[2] = {NEG_INF, NEG_INF};
      float l[2] = {0.f, 0.f};
      float acc[HD / 8][4];
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt)
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

      int gg = g, c = 0, col0 = 0, kb1 = 0;
      bool have = seek_live(P, kj_a, gend, lim, row0, rlast, gg, c, col0, kb1);
      if (have)
        load_kv<HD>(smem, smem + TILE, kb, vb, P.k_ss, P.v_ss, col0, kb1, tid);
      cp_async_commit();
      int st = 0;
      while (have) {
        // start loading the next live sub-tile into the other stage
        int ngg = gg, nc = c + BK, ncol0 = 0, nkb1 = 0;
        const bool next =
            seek_live(P, kj_a, gend, lim, row0, rlast, ngg, nc, ncol0, nkb1);
        if (next) {
          __nv_bfloat16* Kn = smem + 2 * (st ^ 1) * TILE;
          load_kv<HD>(Kn, Kn + TILE, kb, vb, P.k_ss, P.v_ss, ncol0, nkb1, tid);
        }
        cp_async_commit();
        cp_async_wait<1>();   // this stage's group has landed
        __syncthreads();
        const __nv_bfloat16* Ks = smem + 2 * st * TILE;
        tile_step<HD>(Ks, Ks + TILE, qf, m, l, acc, col0, min(lim, kb1), r_lo,
                      r_hi, P.causal, P.window, P.scale, fc, lm, lr);
        __syncthreads();   // every warp is done with this stage
        gg = ngg;
        c = nc;
        col0 = ncol0;
        kb1 = nkb1;
        st ^= 1;
        have = next;
      }

      // the group's `last` descriptor: write acc / max(l, 1e-30), dead rows 0
      store_rows<HD>(ob, P.o_ss, acc, m, l, r_lo, r_hi, qb1, fc);
    }
    g = gend;
  }
}

template <int HD>
int launch_hd(const FlashParams& P, int p, cudaStream_t st) {
  constexpr int bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_sched_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_sched_kernel<HD><<<p, NTHREADS, bytes, st>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_sched_launch(
    const void* q, const void* k, const void* v, void* o, const void* desc,
    const void* bounds, int G, int p, int s, int H, int group, int hd,
    int block_q, int block_k, int causal, int window, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, float scale,
    void* stream) {
  FlashParams P;
  P.q = static_cast<const __nv_bfloat16*>(q);
  P.k = static_cast<const __nv_bfloat16*>(k);
  P.v = static_cast<const __nv_bfloat16*>(v);
  P.o = static_cast<__nv_bfloat16*>(o);
  P.desc = static_cast<const int*>(desc);
  P.bounds = static_cast<const int*>(bounds);
  P.G = G; P.s = s; P.H = H; P.group = group;
  P.block_q = block_q; P.block_k = block_k;
  P.causal = causal; P.window = window;
  P.q_sb = q_sb; P.q_sh = q_sh; P.q_ss = q_ss;
  P.k_sb = k_sb; P.k_sh = k_sh; P.k_ss = k_ss;
  P.v_sb = v_sb; P.v_sh = v_sh; P.v_ss = v_ss;
  P.o_sb = o_sb; P.o_sh = o_sh; P.o_ss = o_ss;
  P.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 128) return launch_hd<128>(P, p, st);
  if (hd == 64) return launch_hd<64>(P, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_sched_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
