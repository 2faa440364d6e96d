// The grouped expert-tile matmul and its two backward products in fp32, for
// Hopper (sm_90a), on the CUDA cores.
//
// Replaces: _gmm_kernel in src/repro/kernels/grouped_matmul/grouped_matmul.py
// for every fp32 call.  The reference's kernel is one dot_general over
// whatever block it is given, fp32 accumulation, the output in the input
// dtype.  gmm.cu takes bf16 at whole 128 / 128 / 32 blocks and gmm_any.cu
// every other bf16 and fp16 call; fp32 (the MoE demo's block_rows 8, d 64,
// f 32; an fp32 MoE model) runs here.  The backward's dX = dY W^T and
// dW[e] = X[e]^T dY[e] (no Pallas kernel: the reference differentiates its
// einsums) get the same form.
//
// What bounds it on an H100: operations on the CUDA cores.  The products
// are plain fp32 FMA, SIMT, never TF32 (the reference's fp32 dot_general
// is fp32), so the ceiling is the card's 67 TFLOP/s of fp32 FMA, not the
// tensor cores'.  Every output element is the fp32 fmaf sum of its products
// in ascending k order, so the outputs are bit for bit the plain version's
// (cuBLAS's fp32 GEMM, TF32 off, sums in the same order) for every
// schedule.
//
// The three products C[m][n] = sum_k A(m, k) B(k, n), each a pair of views:
//   forward  A = x[tile] (bm, d) row-major, B = w[e] (d, f), C = out[tile];
//   dX       A = dy[e] (R, f), B(k, n) = w[e][n][k] read in place, C = dX[e];
//   dW       A(m, k) = x[e][k][m] read in place, B = dy[e] (R, f), C = dW[e].
// An operand is k-contiguous (x, dY, dX's w) or m / n-contiguous (dW's x,
// the forward's w, dW's dY); its shared-memory stage keeps that layout, so
// a copy moves a run of global memory as it lies.
//
// The SGEMM (gmm_f32_kernel):
//   * A unit is at most 128 rows x 256 columns of C.  Its rows pick the
//     register tile: 8 rows -> 2 x 4 outputs a thread (8 x 256 in one
//     pass; not in dW), 16 -> 4 x 4, 32 -> 4 x 8, 64 -> 8 x 8 (64 x 256),
//     128 -> 8 x 8 (128 x 128, two passes), so a run of 8-row tiles does
//     not idle a 128-row block.
//     256 threads, a warp 4 thread rows x 8 thread columns; a thread's
//     k-contiguous fragments are 128-bit loads of 4 k from rows t + i G,
//     its m / n-contiguous ones 128-bit loads of 4 consecutive rows, groups
//     4 G apart (G threads along that side), so a warp's fragment load is
//     one conflict-free wavefront of 64 or 128 bytes.
//   * Stages 16 deep, a ring of 5, filled by cp.async: 16-byte copies when
//     every row stride is a multiple of 4 elements and the bases 16-byte
//     aligned, 4-byte copies otherwise; copies past M, N or K zero-fill
//     (src-size 0), and the last stage's products stop at K.  Outputs go
//     out as 128-bit stores of 4 columns where the rows allow.
//   * The forward is persistent over the plan: CTA w walks steps
//     [bounds[w], bounds[w+1]) of `order`, then the dead steps n_span + w,
//     n_span + w + p, ..., so KernelTilePlan.shares() describes what ran.
//     A unit stacks the run of consecutive steps of that walk whose tiles
//     have one expert (up to 128 rows) and every 256-column block of the
//     expert's weights runs over it: the weights are read once per run,
//     not once per tile.  A tile of more than 128 rows is cut into 128-row
//     blocks, the block innermost.
//   * dX and dW need no plan: units (expert, 256-column n block, 128-row m
//     block), m innermost, dealt round-robin over min(p, units) CTAs, as
//     gmm_dx / gmm_dw deal.
//   * No split-k, no atomics: every output is computed by the same
//     instruction sequence whatever CTA runs it, so outputs are
//     bit-identical for every schedule and every p.

#include "simt_common.cuh"

namespace {

using namespace simt;

constexpr int NT = 256;

enum Mode { FWD = 0, DX = 1, DW = 2 };

struct GmmParams {
  const void* a;            // x (fwd, dW) or dy (dX)
  const void* b;            // w (fwd, dX) or dy (dW)
  void* c;
  const int* order;         // fwd: (T,) step -> tile slot
  const int* tile_expert;   // fwd: (T,) tile slot -> expert
  const int* bounds;        // fwd: (p + 1,) live steps of each CTA
  int n_span, T;            // fwd: live steps, tiles
  int E, M, N, K;           // per unit of batch: C (M, N), depth K
  int R, d, f;              // the raw dims (fwd: R = bm)
  int max_run;              // fwd fp32: tiles a unit may stack
};

// ------------------------------------------------------------------ fp32 ---

namespace f32 {

constexpr int BK = 16;        // depth of a stage
constexpr int STAGES = 5;
constexpr int UM = 128;       // rows of a unit
constexpr int UN = 256;       // columns of a unit

template <int BM_, int BN_, int TM_, int TN_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
  static constexpr int RG = BM / TM, CG = BN / TN;   // threads down, across
  static_assert(RG * CG == NT, "256 threads a block");
  static_assert(TN % 4 == 0, "128-bit fragments");
  static_assert(RG % 4 == 0 && CG % 8 == 0, "warps of 4 x 8 threads");
};
using C8 = Cfg<8, 256, 2, 4>;
using C16 = Cfg<16, 256, 4, 4>;
using C32 = Cfg<32, 256, 4, 8>;
using C64 = Cfg<64, 256, 8, 8>;
using C128 = Cfg<128, 128, 8, 8>;

// A is k-contiguous except in dW, B only in dX
template <int MODE> constexpr bool KA = MODE != DW;
template <int MODE> constexpr bool KB = MODE == DX;

// floats of one operand's stage: X lines of BK (k-contiguous), or BK lines
// of X; rows padded by 4 floats
template <int X, bool KC>
__host__ __device__ constexpr int opnd_floats() {
  return KC ? X * (BK + 4) : BK * (X + 4);
}

template <int MODE, class C>
__host__ __device__ constexpr int stage_floats() {
  return opnd_floats<C::BM, KA<MODE>>() + opnd_floats<C::BN, KB<MODE>>();
}

template <int MODE>
__host__ __device__ constexpr int max_stage_floats() {
  constexpr int a = stage_floats<MODE, C16>(), b = stage_floats<MODE, C32>(),
                c = stage_floats<MODE, C64>(), d = stage_floats<MODE, C128>(),
                e = stage_floats<MODE, C8>();
  constexpr int ab = a > b ? a : b, cd = c > d ? c : d;
  constexpr int abcd = ab > cd ? ab : cd;
  return abcd > e ? abcd : e;
}

template <int MODE>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * max_stage_floats<MODE>() * 4;
}

// fragment index i of thread t (G threads along the side): lines t + i G
// when the operand is k-contiguous, else runs of 4 consecutive lines, 4 G
// apart, for 128-bit loads
template <int G, bool KC>
__device__ __forceinline__ int frag(int t, int i) {
  return KC ? t + i * G : (i / 4) * 4 * G + t * 4 + i % 4;
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// What a unit is: fwd: the run of `nrun` tiles from walk position `it` (or
// one tile's 128-row block mb); dX / dW: expert e's block (mb, column col).
// `rows`: the unit's valid rows (<= 128).
struct Unit {
  int it, nrun, mb, e, col, rows;
};

// the step sequence of CTA w in the forward: its live steps, then its dead
struct Walk {
  int live0 = 0, nlive = 0, nsteps = 0, p = 1, w = 0, n_span = 0;
  __device__ explicit Walk(const GmmParams& P, bool fwd) {
    if (!fwd) return;
    p = gridDim.x;
    w = blockIdx.x;
    live0 = P.bounds[w];
    nlive = P.bounds[w + 1] - live0;
    const int ndead =
        (P.T - P.n_span > w) ? (P.T - P.n_span - w + p - 1) / p : 0;
    nsteps = nlive + ndead;
    n_span = P.n_span;
  }
  __device__ int step(int it) const {
    return it < nlive ? live0 + it : n_span + w + (it - nlive) * p;
  }
};

// row rr of unit u in its batch: (tile or expert) * rows + row, or -1 past
// the unit's rows; fwd rows are rows of x / out, dX / dW rows of expert e
template <int MODE>
__device__ __forceinline__ long long row_of(const GmmParams& P,
                                            const Walk& wk, const Unit& u,
                                            int rr) {
  if (rr >= u.rows) return -1;
  if constexpr (MODE == FWD) {
    const int bm = P.R;
    const int j = P.max_run > 1 ? rr / bm : 0;
    const int i = P.max_run > 1 ? rr % bm : u.mb * UM + rr;
    return static_cast<long long>(P.order[wk.step(u.it + j)]) * bm + i;
  } else {
    return static_cast<long long>(u.e) * P.M + u.mb * UM + rr;
  }
}

// The products of one stage, k ascending, into acc: KEND = BK for a whole
// stage (straight-line code, so the next fragments load under these
// products), 0 for the last one, which stops at `kend`
template <class C, bool ka, bool kb, int KEND>
__device__ __forceinline__ void products(const float* sa, const float* sb,
                                         int tx, int ty,
                                         float (&acc)[C::TM][C::TN],
                                         int kend) {
  constexpr int LA = ka ? BK + 4 : C::BM + 4;
  constexpr int LB = kb ? BK + 4 : C::BN + 4;
#pragma unroll
  for (int k4 = 0; k4 < BK; k4 += 4) {
    if (KEND == 0 && k4 >= kend) break;
    float a[C::TM][4], b[4][C::TN];
    if constexpr (ka) {
#pragma unroll
      for (int i = 0; i < C::TM; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            sa + frag<C::RG, true>(ty, i) * LA + k4);
        a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
      }
    } else {
      static_assert(C::TM % 4 == 0, "128-bit fragments of m");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < C::TM / 4; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              sa + (k4 + kk) * LA + frag<C::RG, false>(ty, 4 * h));
          a[4 * h][kk] = v.x; a[4 * h + 1][kk] = v.y;
          a[4 * h + 2][kk] = v.z; a[4 * h + 3][kk] = v.w;
        }
    }
    if constexpr (kb) {
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(
            sb + frag<C::CG, true>(tx, j) * LB + k4);
        b[0][j] = v.x; b[1][j] = v.y; b[2][j] = v.z; b[3][j] = v.w;
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < C::TN / 4; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              sb + (k4 + kk) * LB + frag<C::CG, false>(tx, 4 * h));
          b[kk][4 * h] = v.x; b[kk][4 * h + 1] = v.y;
          b[kk][4 * h + 2] = v.z; b[kk][4 * h + 3] = v.w;
        }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (KEND == 0 && k4 + kk >= kend) break;
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int j = 0; j < C::TN; ++j)
          acc[i][j] = fmaf(a[i][kk], b[kk][j], acc[i][j]);
    }
  }
}

// One unit in register tiles of C: every column pass of it, each over the
// whole depth through the cp.async ring.
template <class C, int MODE, bool VEC>
__device__ __forceinline__ void unit(const GmmParams& P, const Walk& wk,
                                     const Unit& u, float* smem) {
  constexpr bool ka = KA<MODE>, kb = KB<MODE>;
  constexpr int LA = ka ? BK + 4 : C::BM + 4;   // row strides of the stages
  constexpr int LB = kb ? BK + 4 : C::BN + 4;
  constexpr int SA = opnd_floats<C::BM, ka>();
  constexpr int SS = max_stage_floats<MODE>();
  constexpr int PER = VEC ? 4 : 1;              // floats a copy
  // copies of a stage, and a thread's share of them
  constexpr int NA = C::BM * BK / PER, NB = C::BN * BK / PER;
  constexpr int QA = (NA + NT - 1) / NT, QB = (NB + NT - 1) / NT;
  const float* xa = static_cast<const float*>(P.a);
  const float* xb = static_cast<const float*>(P.b);
  float* xc = static_cast<float*>(P.c);
  const int tid = threadIdx.x;
  // a warp covers 4 rows x 8 columns of threads, so that each 128-bit
  // fragment load of the warp reads 64 or 128 bytes (one wavefront)
  const int lane = tid % 32, warp = tid / 32;
  const int ty = lane / 8 + 4 * (warp % (C::RG / 4));
  const int tx = lane % 8 + 8 * (warp / (C::RG / 4));
  const int K = P.K;
  const int nk = (K + BK - 1) / BK;
  const long long R = P.R, d = P.d, f = P.f;

  // A's line bases, fixed for the unit when A is k-contiguous (its lines
  // are rows of C); dW's A lines are k
  const float* arow[ka ? QA : 1];
  if constexpr (ka) {
#pragma unroll
    for (int q = 0; q < QA; ++q) {
      const int c = tid + q * NT;
      const int line = VEC ? c / (BK / 4) : c / BK;
      const long long r = c < NA ? row_of<MODE>(P, wk, u, line) : -1;
      arow[q] = r < 0 ? nullptr
                      : (MODE == FWD ? xa + r * d : xa + r * f);
    }
  }

  for (int n0 = u.col; n0 < u.col + UN && n0 < P.N; n0 += C::BN) {
    auto issue = [&](int kt) {
      float* sa = smem + (kt % STAGES) * SS;
      float* sb = sa + SA;
      const int k0 = kt * BK;
#pragma unroll
      for (int q = 0; q < QA; ++q) {
        const int c = tid + q * NT;
        if (c >= NA) break;
        if constexpr (ka) {
          const int line = VEC ? c / (BK / 4) : c / BK;
          const int kc = VEC ? (c % (BK / 4)) * 4 : c % BK;
          const bool ok = arow[q] != nullptr && k0 + kc < K;
          cp_async(sa + line * LA + kc, ok ? arow[q] + k0 + kc : xa,
                   PER * 4, ok);
        } else {   // dW: x[e] (R, d), line k, columns m
          const int line = VEC ? c / (C::BM / 4) : c / C::BM;
          const int mc = VEC ? (c % (C::BM / 4)) * 4 : c % C::BM;
          const int k = k0 + line, m = u.mb * UM + mc;
          const bool ok = k < K && m < P.M && mc < u.rows;
          cp_async(sa + line * LA + mc,
                   ok ? xa + (u.e * R + k) * d + m : xa, PER * 4, ok);
        }
      }
#pragma unroll
      for (int q = 0; q < QB; ++q) {
        const int c = tid + q * NT;
        if (c >= NB) break;
        if constexpr (kb) {   // dX: w[e] (d, f), line n, depth k = f
          const int line = VEC ? c / (BK / 4) : c / BK;
          const int kc = VEC ? (c % (BK / 4)) * 4 : c % BK;
          const int n = n0 + line, k = k0 + kc;
          const bool ok = n < P.N && k < K;
          cp_async(sb + line * LB + kc,
                   ok ? xb + (u.e * d + n) * f + k : xb, PER * 4, ok);
        } else {   // fwd: w[e] (d, f); dW: dy[e] (R, f); line k, columns n
          const int line = VEC ? c / (C::BN / 4) : c / C::BN;
          const int nc = VEC ? (c % (C::BN / 4)) * 4 : c % C::BN;
          const int k = k0 + line, n = n0 + nc;
          const bool ok = k < K && n < P.N;
          const long long base = MODE == FWD ? u.e * d * f : u.e * R * f;
          cp_async(sb + line * LB + nc, ok ? xb + base + k * f + n : xb,
                   PER * 4, ok);
        }
      }
    };

    float acc[C::TM][C::TN];
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) acc[i][j] = 0.f;

    __syncthreads();   // every thread is done with the stages' last use
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) issue(s);
      cp_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_wait<STAGES - 2>();
      __syncthreads();
      if (kt + STAGES - 1 < nk) issue(kt + STAGES - 1);
      cp_commit();
      const float* sa = smem + (kt % STAGES) * SS;
      const float* sb = sa + SA;
      if (K - kt * BK >= BK)
        products<C, ka, kb, BK>(sa, sb, tx, ty, acc, BK);
      else   // the last stage stops at K
        products<C, ka, kb, 0>(sa, sb, tx, ty, acc, K - kt * BK);
    }

    // out: C row-major with row stride N, clipped at the unit's rows and
    // N; runs of 4 columns as one 128-bit store where N % 4 == 0
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const long long r = row_of<MODE>(P, wk, u, frag<C::RG, ka>(ty, i));
      if (r < 0) continue;
      float* out = xc + r * P.N;
      if constexpr (VEC && !kb) {
#pragma unroll
        for (int j = 0; j < C::TN; j += 4) {
          const int n = n0 + frag<C::CG, false>(tx, j);
          if (n < P.N)
            *reinterpret_cast<float4*>(out + n) = make_float4(
                acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < C::TN; ++j) {
          const int n = n0 + frag<C::CG, kb>(tx, j);
          if (n < P.N) out[n] = acc[i][j];
        }
      }
    }
  }
}

template <int MODE, bool VEC>
__device__ __forceinline__ void any_unit(const GmmParams& P, const Walk& wk,
                                         const Unit& u, float* smem) {
  if constexpr (MODE != DW) {   // dW's m-contiguous A needs TM % 4 == 0
    if (u.rows <= 8) {
      unit<C8, MODE, VEC>(P, wk, u, smem);
      return;
    }
  }
  if (u.rows <= 16)
    unit<C16, MODE, VEC>(P, wk, u, smem);
  else if (u.rows <= 32)
    unit<C32, MODE, VEC>(P, wk, u, smem);
  else if (u.rows <= 64)
    unit<C64, MODE, VEC>(P, wk, u, smem);
  else
    unit<C128, MODE, VEC>(P, wk, u, smem);
}

template <int MODE, bool VEC>
__global__ void __launch_bounds__(NT, 1) gmm_f32_kernel(GmmParams P) {
  extern __shared__ __align__(16) float smem[];
  const Walk wk(P, MODE == FWD);
  const int nnb = (P.N + UN - 1) / UN;
  if constexpr (MODE == FWD) {
    const int bm = P.R;
    const int nmb = (bm + UM - 1) / UM;
    for (int it = 0; it < wk.nsteps;) {
      Unit u;
      u.it = it;
      u.e = P.tile_expert[P.order[wk.step(it)]];
      u.nrun = 1;
      while (u.nrun < P.max_run && it + u.nrun < wk.nsteps &&
             P.tile_expert[P.order[wk.step(it + u.nrun)]] == u.e)
        ++u.nrun;
      for (int nb = 0; nb < nnb; ++nb)
        for (int mb = 0; mb < nmb; ++mb) {
          u.col = nb * UN;
          u.mb = mb;
          u.rows = P.max_run > 1 ? u.nrun * bm : min(UM, bm - mb * UM);
          any_unit<MODE, VEC>(P, wk, u, smem);
        }
      it += u.nrun;
    }
  } else {
    const int nmb = (P.M + UM - 1) / UM;
    const int units = P.E * nnb * nmb;
    for (int v = blockIdx.x; v < units; v += gridDim.x) {
      Unit u;
      u.it = 0;
      u.nrun = 1;
      u.e = v / (nnb * nmb);
      u.col = ((v / nmb) % nnb) * UN;
      u.mb = v % nmb;
      u.rows = min(UM, P.M - u.mb * UM);
      any_unit<MODE, VEC>(P, wk, u, smem);
    }
  }
}

template <int MODE, bool VEC>
int launch_vec(const GmmParams& P, int grid, cudaStream_t st) {
  auto kernel = gmm_f32_kernel<MODE, VEC>;
  const int rc = set_smem(reinterpret_cast<const void*>(kernel),
                          smem_bytes<MODE>());
  if (rc != 0) return rc;
  kernel<<<grid, NT, smem_bytes<MODE>(), st>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// VEC: every row stride of the three operands a multiple of 4 floats and
// every base 16-byte aligned, so a 16-byte copy or store never straddles a
// row
template <int MODE>
int launch(const GmmParams& P, int grid, cudaStream_t st) {
  const bool vec = P.d % 4 == 0 && P.f % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(P.a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(P.b) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(P.c) % 16 == 0;
  return vec ? launch_vec<MODE, true>(P, grid, st)
             : launch_vec<MODE, false>(P, grid, st);
}

// units of dX / dW: (expert, 256-column n block, 128-row m block)
inline int units(const GmmParams& P) {
  return P.E * ((P.N + UN - 1) / UN) * ((P.M + UM - 1) / UM);
}

}  // namespace f32

template <int MODE>
int launch(const GmmParams& P, int grid, void* stream) {
  if (grid <= 0) return 0;
  return f32::launch<MODE>(P, grid, static_cast<cudaStream_t>(stream));
}

GmmParams params(const void* a, const void* b, void* c, int E, int R, int d,
                 int f) {
  GmmParams P{};
  P.a = a; P.b = b; P.c = c;
  P.E = E; P.R = R; P.d = d; P.f = f;
  return P;
}

}  // namespace

// x (T, bm, d), w (E, d, f) -> out (T, bm, f): each tile times its
// expert's w, on p persistent CTAs walking the plan as gmm_launch does
extern "C" int gmm_simt_launch(const void* x, const void* w, void* out,
                               const void* order, const void* tile_expert,
                               const void* bounds, int p, int n_span, int T,
                               int bm, int d, int f, int E, int dtype,
                               void* stream) {
  if (p <= 0 || T < 0 || E <= 0 || bm <= 0 || d < 0 || f <= 0 ||
      n_span < 0 || n_span > T || dtype != F32)
    return static_cast<int>(cudaErrorInvalidValue);
  GmmParams P = params(x, w, out, E, bm, d, f);
  P.order = static_cast<const int*>(order);
  P.tile_expert = static_cast<const int*>(tile_expert);
  P.bounds = static_cast<const int*>(bounds);
  P.n_span = n_span; P.T = T;
  P.M = bm; P.N = f; P.K = d;
  P.max_run = bm <= f32::UM ? f32::UM / bm : 1;
  return launch<FWD>(P, T > 0 ? p : 0, stream);
}

// dX (E, R, d) = dy (E, R, f) w[e]^T with w (E, d, f) read in place
extern "C" int gmm_simt_dx_launch(const void* dy, const void* w, void* dx,
                                  int E, int R, int d, int f, int p, int dtype,
                                  void* stream) {
  if (p <= 0 || E <= 0 || R < 0 || d <= 0 || f < 0 || dtype != F32)
    return static_cast<int>(cudaErrorInvalidValue);
  GmmParams P = params(dy, w, dx, E, R, d, f);
  P.M = R; P.N = d; P.K = f;
  const int units = f32::units(P);
  return launch<DX>(P, p < units ? p : units, stream);
}

// dW (E, d, f) = x (E, R, d)^T dy (E, R, f) per expert, rows summed in
// ascending order
extern "C" int gmm_simt_dw_launch(const void* x, const void* dy, void* dw,
                                  int E, int R, int d, int f, int p, int dtype,
                                  void* stream) {
  if (p <= 0 || E <= 0 || R < 0 || d <= 0 || f <= 0 || dtype != F32)
    return static_cast<int>(cudaErrorInvalidValue);
  GmmParams P = params(x, dy, dw, E, R, d, f);
  P.M = d; P.N = f; P.K = R;
  const int units = f32::units(P);
  return launch<DW>(P, p < units ? p : units, stream);
}

extern "C" const char* gmm_simt_error_string(int code) {
  return error_string(code);
}
