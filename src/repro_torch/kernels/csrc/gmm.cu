// Grouped expert-tile matmul with a DLS-planned work list, for Hopper (sm_90a).
//
// Replaces: _gmm_kernel in src/repro/kernels/grouped_matmul/grouped_matmul.py
// (launched by grouped_matmul_tiles through one pl.pallas_call over a 1-D
// grid of row tiles, each multiplied by its expert's (d, f) weight block).
//
// What bounds it on an H100: bytes, at the main path's shapes.  With
// 128 experts, capacity 512 and Zipf-skewed loads (about 175 live rows an
// expert), the expert weights (3 MB each in bf16) dominate: about 100
// operations per byte the function must move, below the card's ~295.  A
// tile reads its expert's weights once (an expert with four tiles reads
// them four times, the repeats mostly from L2).  The kernel uses warp-level
// mma.sync (m16n8k16, bf16 in, fp32 accumulate) fed by ldmatrix, with a
// three-stage cp.async pipeline over the d slices; wgmma, TMA and grouping
// an expert's tiles on one CTA are later work.
//
// Design:
//   * Persistent: the grid has p CTAs, one per plan worker.  CTA w first
//     walks its live share of the plan, steps [bounds[w], bounds[w+1]) of
//     `order`, in order.  The steps after n_span (the dead, all-padding
//     tiles that balance/moe.plan_tiles appends after the live ones) are
//     dealt round-robin: CTA w takes n_span + w, n_span + w + p, ...  They
//     are computed all the same, as the TPU grid computes them.
//   * The reference gathers the tiles into plan order and inverse-permutes
//     the output; here step i reads x tile order[i] and writes output tile
//     order[i] in place, which gives the same output without the copies.
//   * The reference loads the whole (d, f) expert block per grid step: 3 MB
//     in bf16 at (2048, 768), far beyond shared memory.  Each tile is cut
//     into 128 x 128 output blocks (8 warps as 2 x 4, 64 x 32 each) and the
//     d dimension into 32-wide slices staged in shared memory, three in
//     flight; ldmatrix.trans gives the weights' B fragments.
//   * Each output tile is computed by one CTA with the same instruction
//     sequence whatever the schedule, so outputs are bit-identical across
//     schedules.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;           // output rows per block
constexpr int BN = 128;           // output columns per block
constexpr int BKD = 32;           // d slice per shared-memory stage
constexpr int STAGES = 3;         // d slices in flight
constexpr int XS = BKD + 8;       // x slice row stride (bf16)
constexpr int WS = BN + 8;        // w slice row stride (bf16)
constexpr int XT = BM * XS;       // x slice elements
constexpr int WT = BKD * WS;      // w slice elements
constexpr int SMEM_BYTES = STAGES * (XT + WT) * 2;
constexpr int NTHREADS = 256;     // 8 warps: 2 (rows) x 4 (columns)

struct GmmParams {
  const __nv_bfloat16* x;     // (T, bm, d) tile slots
  const __nv_bfloat16* w;     // (E, d, f)
  __nv_bfloat16* out;         // (T, bm, f) tile slots
  const int* order;           // (T,) step -> tile slot
  const int* tile_expert;     // (T,) tile slot -> expert
  const int* bounds;          // (p + 1,) live steps of each CTA
  int n_span, T, bm, d, f;
};

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
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

// one (BM x BKD) slice of x and one (BKD x BN) slice of w into a stage:
// 512 16-byte vectors each, two per thread
__device__ __forceinline__ void load_slice(__nv_bfloat16* stage,
                                           const __nv_bfloat16* xt,
                                           const __nv_bfloat16* we, int d,
                                           int f, int kb, int tid) {
  __nv_bfloat16* Xs = stage;
  __nv_bfloat16* Ws = stage + XT;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * NTHREADS;
    const int xrow = idx / (BKD / 8);
    const int xcol = (idx % (BKD / 8)) * 8;
    cp_async16(Xs + xrow * XS + xcol, xt + (long long)xrow * d + kb + xcol);
    const int wrow = idx / (BN / 8);
    const int wcol = (idx % (BN / 8)) * 8;
    cp_async16(Ws + wrow * WS + wcol, we + (long long)(kb + wrow) * f + wcol);
  }
}

__global__ void __launch_bounds__(NTHREADS) gmm_kernel(const GmmParams P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / 4;          // warp row: 64 output rows
  const int wn = warp % 4;          // warp column: 32 output columns
  const int fr = lane / 4;
  const int fc = (lane % 4) * 2;
  const int lm = lane / 8;          // ldmatrix: which 8x8 matrix
  const int lr = lane % 8;          // ldmatrix: which row of it
  const int p = gridDim.x;
  const int w = blockIdx.x;
  const int nk = P.d / BKD;

  const int live0 = P.bounds[w];
  const int nlive = P.bounds[w + 1] - live0;
  const int ndead = (P.T - P.n_span > w) ? (P.T - P.n_span - w + p - 1) / p : 0;

  for (int it = 0; it < nlive + ndead; ++it) {
    const int step = it < nlive ? live0 + it : P.n_span + w + (it - nlive) * p;
    const int t = P.order[step];
    const int e = P.tile_expert[t];
    const __nv_bfloat16* we_base = P.w + (long long)e * P.d * P.f;

    for (int mb = 0; mb < P.bm; mb += BM) {
      const __nv_bfloat16* xt = P.x + ((long long)t * P.bm + mb) * P.d;
      __nv_bfloat16* ot = P.out + ((long long)t * P.bm + mb) * P.f;
      for (int nb = 0; nb < P.f; nb += BN) {
        const __nv_bfloat16* we = we_base + nb;
        float acc[4][4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

#pragma unroll
        for (int s = 0; s < STAGES - 1; ++s) {
          if (s < nk) load_slice(smem + s * (XT + WT), xt, we, P.d, P.f, s * BKD, tid);
          cp_async_commit();
        }
        for (int kt = 0; kt < nk; ++kt) {
          cp_async_wait<STAGES - 2>();  // slice kt has landed
          __syncthreads();              // and slice kt - 1 is consumed
          const int nxt = kt + STAGES - 1;
          if (nxt < nk)
            load_slice(smem + (nxt % STAGES) * (XT + WT), xt, we, P.d, P.f,
                       nxt * BKD, tid);
          cp_async_commit();
          const __nv_bfloat16* Xs = smem + (kt % STAGES) * (XT + WT);
          const __nv_bfloat16* Ws = Xs + XT;
#pragma unroll
          for (int ks = 0; ks < BKD / 16; ++ks) {
            uint32_t a[4][4];
            uint32_t bfr[2][4];
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)   // (rows lo, k lo), (hi, lo), (lo, hi), (hi, hi)
              ldsm_x4(a[mt], Xs + (wm * 64 + mt * 16 + (lm & 1) * 8 + lr) * XS +
                                 ks * 16 + (lm >> 1) * 8);
#pragma unroll
            for (int np = 0; np < 2; ++np)   // (k lo, n-tile 2np), (hi, 2np), (lo, 2np+1), (hi, 2np+1)
              ldsm_x4_trans(bfr[np], Ws + (ks * 16 + (lm & 1) * 8 + lr) * WS +
                                         wn * 32 + (np * 2 + (lm >> 1)) * 8);
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                mma_bf16_16816(acc[mt][nt], a[mt], bfr[nt >> 1] + (nt & 1) * 2);
          }
        }
        cp_async_wait<0>();
        __syncthreads();   // all reads done before the next block's loads

#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int row = wm * 64 + mt * 16 + fr;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int col = nb + wn * 32 + nt * 8 + fc;
            *reinterpret_cast<uint32_t*>(ot + (long long)row * P.f + col) =
                pack_bf16(acc[mt][nt][0], acc[mt][nt][1]);
            *reinterpret_cast<uint32_t*>(ot + (long long)(row + 8) * P.f + col) =
                pack_bf16(acc[mt][nt][2], acc[mt][nt][3]);
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" int gmm_launch(const void* x, const void* w, void* out,
                          const void* order, const void* tile_expert,
                          const void* bounds, int p, int n_span, int T, int bm,
                          int d, int f, void* stream) {
  if (p <= 0 || bm % BM != 0 || f % BN != 0 || d % BKD != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  GmmParams P;
  P.x = static_cast<const __nv_bfloat16*>(x);
  P.w = static_cast<const __nv_bfloat16*>(w);
  P.out = static_cast<__nv_bfloat16*>(out);
  P.order = static_cast<const int*>(order);
  P.tile_expert = static_cast<const int*>(tile_expert);
  P.bounds = static_cast<const int*>(bounds);
  P.n_span = n_span; P.T = T; P.bm = bm; P.d = d; P.f = f;
  cudaError_t err = cudaFuncSetAttribute(
      gmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  gmm_kernel<<<p, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
