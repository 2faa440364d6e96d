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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 128;       // q rows per sub-tile: 8 warps x 16
constexpr int BK = 64;        // kv columns per sub-tile
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

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

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// split fp32 pairs into bf16 hi and lo parts: x ~= hi + lo
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

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
  constexpr int KS = HD + 8;      // K / V row stride in shared memory (bf16)
  constexpr int TILE = BK * KS;   // one K or V sub-tile
  constexpr int VPR = HD / 8;     // 16-byte vectors per K/V row
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

    // K and V rows [col0, col0 + BK) into stage st; rows >= kb1 are zeros
    auto load_kv = [&](int st, int col0, int kb1) {
      __nv_bfloat16* Ks = smem + 2 * st * TILE;
      __nv_bfloat16* Vs = Ks + TILE;
      for (int idx = tid; idx < BK * VPR; idx += NTHREADS) {
        const int r = idx / VPR;
        const int c = (idx % VPR) * 8;
        const int col = col0 + r;
        const bool ok = col < kb1;
        cp_async16(Ks + r * KS + c, ok ? kb + col * P.k_ss + c : kb, ok);
        cp_async16(Vs + r * KS + c, ok ? vb + col * P.v_ss + c : vb, ok);
      }
    };

    for (int row0 = qb0; row0 < qb1; row0 += BQ) {
      const int rlast = min(row0 + BQ, qb1) - 1;
      const int r_lo = row0 + warp * 16 + fr;
      const int r_hi = r_lo + 8;

      // Q fragments (A operand, 16 rows x HD) straight from device memory
      uint32_t qf[HD / 16][4];
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = (i & 1) ? r_hi : r_lo;
          const int col = kk * 16 + fc + ((i & 2) ? 8 : 0);
          qf[kk][i] = row < qb1
              ? *reinterpret_cast<const uint32_t*>(qb + row * P.q_ss + col)
              : 0u;
        }
      }

      float m[2] = {NEG_INF, NEG_INF};
      float l[2] = {0.f, 0.f};
      float acc[HD / 8][4];
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt)
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

      int gg = g, c = 0, col0 = 0, kb1 = 0;
      bool have = seek_live(P, kj_a, gend, lim, row0, rlast, gg, c, col0, kb1);
      if (have) load_kv(0, col0, kb1);
      cp_async_commit();
      int st = 0;
      while (have) {
        // start loading the next live sub-tile into the other stage
        int ngg = gg, nc = c + BK, ncol0 = 0, nkb1 = 0;
        const bool next =
            seek_live(P, kj_a, gend, lim, row0, rlast, ngg, nc, ncol0, nkb1);
        if (next) load_kv(st ^ 1, ncol0, nkb1);
        cp_async_commit();
        cp_async_wait<1>();   // this stage's group has landed
        __syncthreads();
        const __nv_bfloat16* Ks = smem + 2 * st * TILE;
        const __nv_bfloat16* Vs = Ks + TILE;

        // S = Q K^T for this warp's 16 rows x BK columns
        float sacc[BK / 8][4];
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt)
          sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
          for (int np = 0; np < BK / 16; ++np) {
            // matrices: (n-tile 2np, d lo), (2np, d hi), (2np+1, lo), (2np+1, hi)
            uint32_t bfr[4];
            ldsm_x4(bfr, Ks + ((np * 2 + (lm >> 1)) * 8 + lr) * KS + kk * 16 +
                             (lm & 1) * 8);
            mma_bf16_16816(sacc[2 * np], qf[kk], bfr);
            mma_bf16_16816(sacc[2 * np + 1], qf[kk], bfr + 2);
          }
        }

        // scale, mask, and the row maxima
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = (i < 2) ? r_lo : r_hi;
            const int col = col0 + nt * 8 + fc + (i & 1);
            bool ok = col < lim && col < kb1;
            if (P.causal) ok = ok && col <= row;
            if (P.window > 0) ok = ok && (row - col) < P.window;
            const float x = ok ? sacc[nt][i] * P.scale : NEG_INF;
            sacc[nt][i] = x;
            mx[i >> 1] = fmaxf(mx[i >> 1], x);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
          mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
        }
        const float corr0 = expf(m[0] - mx[0]);
        const float corr1 = expf(m[1] - mx[1]);

        // P = exp(S - m_new) as bf16 hi/lo A fragments, and its row sums
        uint32_t phi[BK / 16][4];
        uint32_t plo[BK / 16][4];
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
          const float p0 = expf(sacc[nt][0] - mx[0]);
          const float p1 = expf(sacc[nt][1] - mx[0]);
          const float p2 = expf(sacc[nt][2] - mx[1]);
          const float p3 = expf(sacc[nt][3] - mx[1]);
          rs[0] += p0 + p1;
          rs[1] += p2 + p3;
          const int base = (nt & 1) * 2;
          split_bf16(p0, p1, phi[nt / 2][base], plo[nt / 2][base]);
          split_bf16(p2, p3, phi[nt / 2][base + 1], plo[nt / 2][base + 1]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          rs[j] += __shfl_xor_sync(0xffffffffu, rs[j], 1);
          rs[j] += __shfl_xor_sync(0xffffffffu, rs[j], 2);
        }
        l[0] = l[0] * corr0 + rs[0];
        l[1] = l[1] * corr1 + rs[1];
        m[0] = mx[0];
        m[1] = mx[1];

        // acc = acc * corr + P V
#pragma unroll
        for (int nt = 0; nt < HD / 8; ++nt) {
          acc[nt][0] *= corr0;
          acc[nt][1] *= corr0;
          acc[nt][2] *= corr1;
          acc[nt][3] *= corr1;
        }
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
#pragma unroll
          for (int np = 0; np < HD / 16; ++np) {
            // matrices: (kv lo, d-tile 2np), (kv hi, 2np), (lo, 2np+1), (hi, 2np+1)
            uint32_t bfr[4];
            ldsm_x4_trans(bfr, Vs + (ks * 16 + (lm & 1) * 8 + lr) * KS +
                                   (np * 2 + (lm >> 1)) * 8);
            mma_bf16_16816(acc[2 * np], phi[ks], bfr);
            mma_bf16_16816(acc[2 * np], plo[ks], bfr);
            mma_bf16_16816(acc[2 * np + 1], phi[ks], bfr + 2);
            mma_bf16_16816(acc[2 * np + 1], plo[ks], bfr + 2);
          }
        }
        __syncthreads();   // every warp is done with this stage
        gg = ngg;
        c = nc;
        col0 = ncol0;
        kb1 = nkb1;
        st ^= 1;
        have = next;
      }

      // the group's `last` descriptor: write acc / max(l, 1e-30), dead rows 0
      const bool alive0 = m[0] > NEG_INF * 0.5f;
      const bool alive1 = m[1] > NEG_INF * 0.5f;
      const float l0 = fmaxf(l[0], 1e-30f);
      const float l1 = fmaxf(l[1], 1e-30f);
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        const int col = nt * 8 + fc;
        if (r_lo < qb1) {
          *reinterpret_cast<uint32_t*>(ob + r_lo * P.o_ss + col) = pack_bf16(
              alive0 ? acc[nt][0] / l0 : 0.f, alive0 ? acc[nt][1] / l0 : 0.f);
        }
        if (r_hi < qb1) {
          *reinterpret_cast<uint32_t*>(ob + r_hi * P.o_ss + col) = pack_bf16(
              alive1 ? acc[nt][2] / l1 : 0.f, alive1 ? acc[nt][3] / l1 : 0.f);
        }
      }
    }
    g = gend;
  }
}

template <int HD>
int launch_hd(const FlashParams& P, int p, cudaStream_t st) {
  constexpr int bytes = 2 * 2 * BK * (HD + 8) * 2;   // 2 stages x (K, V)
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
