// The grouped expert-tile matmul and its two backward products at every
// dtype and shape, for Hopper (sm_90a): the general kernel beside gmm.cu.
//
// Replaces: _gmm_kernel in src/repro/kernels/grouped_matmul/grouped_matmul.py
// where gmm.cu cannot take the call.  The reference's kernel is one
// dot_general over whatever block it is given, fp32 accumulation, the
// output in the input dtype; gmm.cu's TMA boxes and wgmma need bf16 and
// rows, columns and depth in whole 128 / 128 / 32 blocks.  Everything else
// runs here: fp32 and fp16 operands, and any bm, d and f (the MoE demo's
// fp32 call with block_rows 8, d 64, f 32; an fp32 MoE model; a d_ff that
// is not a multiple of 128).  The backward's dX = dY W^T and dW[e] = X[e]^T
// dY[e] (no Pallas kernel: the reference differentiates its einsums) get
// the same general form.
//
// What bounds it on an H100: operations on the CUDA cores.  The products
// are plain fp32 FMA, SIMT, never TF32 (the reference's fp32 dot_general
// is fp32), so the ceiling is the card's 67 TFLOP/s of fp32 FMA, not the
// tensor cores'.  At the qwen3-moe width (d 2048, f 768) a tile of 8 rows
// does 16 FMA per weight element it reads, so the weights, read once per
// tile as in gmm.cu, make the bytes bound close.
//
// Design: one template for the three products C[m][n] = sum_k A(m, k)
// B(k, n), each a pair of index maps:
//   forward  A = x[tile] (bm, d) row-major, B = w[e] (d, f), C = out[tile];
//   dX       A = dy[e] (R, f), B(k, n) = w[e][n][k] read in place, C = dX[e];
//   dW       A(m, k) = x[e][k][m] read in place, B = dy[e] (R, f), C = dW[e].
// A unit is one BM x BN block of C.  256 threads; each owns a TM x TN
// block of the unit and sums over k in ascending order with fmaf, one
// BKD = 16 deep slice at a time staged in shared memory (A as [k][m], B as
// [k][n], rows padded by 4 floats; the next slice is fetched into
// registers while this one's products run), zero-filled past M, N and K,
// so every output element is the fp32 sum of its products in ascending d
// order, as _gmm_kernel sums them, cast once to the input dtype.  Two unit shapes:
// 64 x 64 (4 x 4 a thread), and 16 x 128 (2 x 4) where M <= 16, so that a
// tile of 8 rows does not idle most of the block.
//   * The forward is persistent over the plan exactly as gmm.cu is: p CTAs,
//     CTA w walks steps [bounds[w], bounds[w+1]) of `order`, then the dead
//     steps n_span + w, n_span + w + p, ...; step i reads x tile order[i]
//     and writes output tile order[i], all of its units in turn.  So
//     KernelTilePlan.shares() describes what ran.
//   * dX and dW need no plan: units (expert, n block, m block), m innermost,
//     dealt round-robin over min(p, units) CTAs, as gmm_dx / gmm_dw deal.
//   * No split-k, no atomics: every output is computed by the same
//     instruction sequence whatever CTA runs it, so outputs are
//     bit-identical for every schedule and every p.

#include "simt_common.cuh"

namespace {

using namespace simt;

constexpr int NT = 256;
constexpr int BKD = 16;   // depth of a stage

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
};

// the operands of batch index `bi` (a tile slot, or an expert) of mode MODE:
// element (m, k) of A at A + m * a_sm + k * a_sk, (k, n) of B likewise, C
// row-major with row stride N
template <int MODE, typename T>
struct Views {
  const T *A, *B;
  T* C;
  long long a_sm, a_sk, b_sk, b_sn;
  __device__ Views(const GmmParams& P, int bi, int e) {
    const T* a = static_cast<const T*>(P.a);
    const T* b = static_cast<const T*>(P.b);
    T* c = static_cast<T*>(P.c);
    const long long R = P.R, d = P.d, f = P.f;
    if constexpr (MODE == FWD) {            // x (T, bm, d) @ w (E, d, f)
      A = a + bi * R * d; a_sm = d; a_sk = 1;
      B = b + e * d * f; b_sk = f; b_sn = 1;
      C = c + bi * R * f;
    } else if constexpr (MODE == DX) {      // dy (E, R, f) @ w[e]^T
      A = a + e * R * f; a_sm = f; a_sk = 1;
      B = b + e * d * f; b_sk = 1; b_sn = f;
      C = c + e * R * d;
    } else {                                // x (E, R, d)^T @ dy (E, R, f)
      A = a + e * R * d; a_sm = 1; a_sk = d;
      B = b + e * R * f; b_sk = f; b_sn = 1;
      C = c + e * d * f;
    }
  }
};

// one BKD x X slice of an operand, element (k, x) at G + k * s_k + x * s_x,
// zero past K and X: fetched into registers (the unit-stride index runs
// fastest across threads, so the reads coalesce), then put into S[k][x]
// (row stride LD).  Fetching the next slice before the products of this
// one keeps its loads in flight while they run.
template <int X, int LD, typename T>
struct Slice {
  static constexpr int N = BKD * X / NT;   // elements a thread
  static_assert(N * NT == BKD * X, "a slice divides over the threads");
  float v[N];

  __device__ __forceinline__ static void at(int i, bool k_fast, int& k,
                                            int& x) {
    if (k_fast) {
      k = i % BKD;
      x = i / BKD;
    } else {
      x = i % X;
      k = i / X;
    }
  }
  __device__ __forceinline__ void fetch(const T* G, long long s_k,
                                        long long s_x, int k0, int x0, int K,
                                        int Xn) {
    const bool k_fast = s_k == 1;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      int k, x;
      at(threadIdx.x + j * NT, k_fast, k, x);
      const int gk = k0 + k, gx = x0 + x;
      v[j] = (gk < K && gx < Xn) ? Cvt<T>::in(G[gk * s_k + gx * s_x]) : 0.f;
    }
  }
  __device__ __forceinline__ void put(float* S, long long s_k) const {
    const bool k_fast = s_k == 1;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      int k, x;
      at(threadIdx.x + j * NT, k_fast, k, x);
      S[k * LD + x] = v[j];
    }
  }
};

// C[m0 : m0 + BM, n0 : n0 + BN] of one batch index
template <typename T, int MODE, int BM, int BN, int TM, int TN>
__device__ __forceinline__ void unit(const Views<MODE, T>& V, int M, int N,
                                     int K, int m0, int n0, float* As,
                                     float* Bs) {
  constexpr int LDA = BM + 4, LDB = BN + 4;
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  Slice<BM, LDA, T> sa;
  Slice<BN, LDB, T> sb;
  sa.fetch(V.A, V.a_sk, V.a_sm, 0, m0, K, M);
  sb.fetch(V.B, V.b_sk, V.b_sn, 0, n0, K, N);
  for (int k0 = 0; k0 < K; k0 += BKD) {
    __syncthreads();   // the previous slice (or unit) is read
    sa.put(As, V.a_sk);
    sb.put(Bs, V.b_sk);
    __syncthreads();
    if (k0 + BKD < K) {
      sa.fetch(V.A, V.a_sk, V.a_sm, k0 + BKD, m0, K, M);
      sb.fetch(V.B, V.b_sk, V.b_sn, k0 + BKD, n0, K, N);
    }
#pragma unroll
    for (int k = 0; k < BKD; ++k) {
      float a[TM], b[TN];
      lds<TM>(a, As + k * LDA + ty * TM);
      lds<TN>(b, Bs + k * LDB + tx * TN);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) V.C[static_cast<long long>(m) * N + n] = Cvt<T>::out(acc[i][j]);
    }
  }
}

template <typename T, int MODE, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(NT)
gmm_simt_kernel(GmmParams P) {
  static_assert((BM / TM) * (BN / TN) == NT, "256 threads a unit");
  __shared__ __align__(16) float As[BKD * (BM + 4)];
  __shared__ __align__(16) float Bs[BKD * (BN + 4)];
  const int mb = (P.M + BM - 1) / BM, nb = (P.N + BN - 1) / BN;
  const int p = gridDim.x, w = blockIdx.x;
  if constexpr (MODE == FWD) {
    // the unit sequence of CTA w: its live steps, then its dead ones
    const int live0 = P.bounds[w], nlive = P.bounds[w + 1] - live0;
    const int ndead =
        (P.T - P.n_span > w) ? (P.T - P.n_span - w + p - 1) / p : 0;
    for (int it = 0; it < nlive + ndead; ++it) {
      const int step = it < nlive ? live0 + it : P.n_span + w + (it - nlive) * p;
      const int tile = P.order[step];
      const Views<MODE, T> V(P, tile, P.tile_expert[tile]);
      for (int u = 0; u < mb * nb; ++u)
        unit<T, MODE, BM, BN, TM, TN>(V, P.M, P.N, P.K, (u % mb) * BM,
                                      (u / mb) * BN, As, Bs);
    }
  } else {
    const int units = P.E * nb * mb;
    for (int u = w; u < units; u += p) {
      const int e = u / (nb * mb), r = u % (nb * mb);
      const Views<MODE, T> V(P, 0, e);
      unit<T, MODE, BM, BN, TM, TN>(V, P.M, P.N, P.K, (r % mb) * BM,
                                    (r / mb) * BN, As, Bs);
    }
  }
}

template <typename T, int MODE>
int launch_t(const GmmParams& P, int grid, cudaStream_t st) {
  if (P.M <= 16)
    gmm_simt_kernel<T, MODE, 16, 128, 2, 4><<<grid, NT, 0, st>>>(P);
  else
    gmm_simt_kernel<T, MODE, 64, 64, 4, 4><<<grid, NT, 0, st>>>(P);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch(const GmmParams& P, int grid, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (grid <= 0) return 0;
  switch (dtype) {
    case F32: return launch_t<float, MODE>(P, grid, st);
    case BF16: return launch_t<__nv_bfloat16, MODE>(P, grid, st);
    case F16: return launch_t<__half, MODE>(P, grid, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
      n_span < 0 || n_span > T)
    return static_cast<int>(cudaErrorInvalidValue);
  GmmParams P = params(x, w, out, E, bm, d, f);
  P.order = static_cast<const int*>(order);
  P.tile_expert = static_cast<const int*>(tile_expert);
  P.bounds = static_cast<const int*>(bounds);
  P.n_span = n_span; P.T = T;
  P.M = bm; P.N = f; P.K = d;
  return launch<FWD>(P, T > 0 ? p : 0, dtype, stream);
}

// dX (E, R, d) = dy (E, R, f) w[e]^T with w (E, d, f) read in place
extern "C" int gmm_simt_dx_launch(const void* dy, const void* w, void* dx,
                                  int E, int R, int d, int f, int p, int dtype,
                                  void* stream) {
  if (p <= 0 || E <= 0 || R < 0 || d <= 0 || f < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  GmmParams P = params(dy, w, dx, E, R, d, f);
  P.M = R; P.N = d; P.K = f;
  const int units = E * ((R + 63) / 64) * ((d + 63) / 64);
  return launch<DX>(P, p < units ? p : units, dtype, stream);
}

// dW (E, d, f) = x (E, R, d)^T dy (E, R, f) per expert, rows summed in
// ascending order
extern "C" int gmm_simt_dw_launch(const void* x, const void* dy, void* dw,
                                  int E, int R, int d, int f, int p, int dtype,
                                  void* stream) {
  if (p <= 0 || E <= 0 || R < 0 || d <= 0 || f <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  GmmParams P = params(x, dy, dw, E, R, d, f);
  P.M = d; P.N = f; P.K = R;
  const int units = E * ((d + 63) / 64) * ((f + 63) / 64);
  return launch<DW>(P, p < units ? p : units, dtype, stream);
}

extern "C" const char* gmm_simt_error_string(int code) {
  return error_string(code);
}
