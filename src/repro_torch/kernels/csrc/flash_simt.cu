// Flash-attention forward at every float dtype, for Hopper (sm_90a): the
// general kernel beside flash_dense.cu and flash_sched.cu, with two entry
// points, dense and schedule-aware.
//
// Replaces: _flash_kernel (dense) and _flash_sched_kernel (ragged KV in DLS
// plan order) in src/repro/kernels/flash_attention/flash_attention.py where
// the tensor-core kernels cannot take the call.  The reference casts q, k
// and v to fp32 inside both kernels and so takes any float dtype;
// flash_dense.cu takes bf16 and fp16 and flash_sched.cu bf16 with a head
// dim that is a multiple of 8 and 16-byte aligned rows, and flash_f32.cu
// takes fp32 calls so at head dims up to 128, dense and schedule-aware.
// Everything else runs here: fp32 at head dims 136-256 (recurrentgemma-2b's
// local attention in fp32, whose backward runs on flash_f32_bwd.cu's
// cluster pairs) or at a head dim or strides TMA cannot describe, fp16 at
// the schedule-aware entry, and bf16 and fp16 at a head dim or stride the
// TMA boxes cannot describe.  Head dims up to 256.
//
// What bounds it on an H100: operations on the CUDA cores.  S = Q K^T and
// O += P V are plain fp32 FMA, SIMT, never TF32, as the reference's fp32
// dot_general; the ceiling is the card's 67 TFLOP/s of fp32 FMA.
//
// Design (a simple kernel that is right; its speed is later work):
//   * A unit is one 64-row q tile of one lane (batch, head): an online
//     softmax in fp32 over its live kv tiles in ascending order, exactly
//     the reference's body: S = (Q K^T) scale, masked to NEG_INF (-1e30)
//     outside the causal diagonal, the window, the lane's length `lim`;
//     m, l and the fp32 accumulator rescaled by corr = exp(m - m_new); rows
//     that never saw a live column (m <= NEG_INF / 2) written as 0, as
//     _flash_sched_kernel's _finalize does.
//   * Tiles, per padded head dim HDP (64, 128 or 256; the columns past the
//     real head dim are zero-filled and never written, and the products
//     stop at the head dim rounded up to 4): Q^T (HDP x 64) and K^T
//     (HDP x BK) in shared memory d-major for S, V (BK x HDP) row-major for
//     P V, P (64 x BK, rows padded by 4).  BK is 64 at HDP 64 and 128
//     (65 and 113 KB of shared memory) and 32 at 256 (Q^T 64 KB, K^T and V
//     32 KB each, P 9 KB: 137 KB, where 64 fp32 rows of K and V would take
//     64 KB each).  256 threads as 16 x 16: a thread owns 4 q rows and BK/16
//     kv columns of S, and the same 4 rows times HDP/16 columns of O
//     (columns 4 tx + 64 j); a row's max and sum are reduced over its 16
//     threads with shuffles.
//   * Dense entry: one CTA per (64-row q tile, lane); the kv tiles are
//     those inside the causal diagonal and the window.  With `lse` given it
//     also writes each row's log-sum-exp (m + log l, +inf for a dead row)
//     for the backward (flash_simt_bwd.cu), and with `o_lo` given (fp16)
//     the output's rounding residual o - T(o) in T, which the backward's
//     delta pass adds back as flash_dense.cu's residual (flash_dense_bwd.cu
//     says why).
//   * Schedule-aware entry: persistent over the plan as flash_sched.cu is:
//     p CTAs, CTA w walks descriptors [bounds[w], bounds[w+1]) -- its share
//     of the DLS plan -- group by group (a group runs from a `first` flag to
//     a `last` flag: one (lane, q block) and its live kv blocks); a group's
//     units are its 64-row q tiles in ascending order over the kv columns
//     of its kv blocks.  A unit's result depends on the unit alone, so the
//     output is bit-identical for every schedule and every p.
//   * q, k, v and o are read and written in the model layout (b, s, heads,
//     hd) from their strides, GQA's KV head h / (H / KVH) in place.

#include <math.h>

#include "simt_common.cuh"

namespace {

using namespace simt;

constexpr int NT = 256;
constexpr int BQ = 64;
constexpr float NEG_INF = -1e30f;

struct FwdParams {
  const void *q, *k, *v;
  void* o;
  void* o_lo;                 // dense: o's rounding residual, o's strides, or null
  float* lse;                 // (b, h, s) or null
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb,
      o_sh, o_ss;
  int s, H, group, hd, causal, window, vec;   // vec: 4-element row loads
  float scale;
  const int* desc;            // sched: 6 x G int32 (bi, qi, kj, first, last, lim)
  const int* bounds;          // sched: p + 1
  int G, block_q, block_k;
};

template <int HDP>
struct Tiles {
  static constexpr int BK = HDP == 256 ? 32 : 64;
  static constexpr int TN = BK / 16;          // kv columns of S a thread
  static constexpr int LDP = BK + 4;
  static constexpr int QT = 0;                       // Q^T [HDP][BQ]
  static constexpr int KT = QT + HDP * BQ;           // K^T [HDP][BK]
  static constexpr int VR = KT + HDP * BK;           // V [BK][HDP]
  static constexpr int PM = VR + BK * HDP;           // P [BQ][LDP]
  static constexpr int FLOATS = PM + BQ * LDP;
  static constexpr int BYTES = FLOATS * 4;
};

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffff, x, o);
  return x;
}

// rows [q0, q1) of lane (b, h) against kv columns [c_lo, c_hi) (both ends
// already cut to the lane's length), masked by `lim`, the causal diagonal
// and the window; writes o (and o_lo, lse) of the rows
template <typename T, int HDP>
__device__ void attend_unit(const FwdParams& P, float* sm, int b, int h,
                            int q0, int q1, int c_lo, int c_hi, int lim) {
  using L = Tiles<HDP>;
  constexpr int BK = L::BK, TN = L::TN, NJ = HDP / 64;
  float* Qt = sm + L::QT;
  float* Kt = sm + L::KT;
  float* Vr = sm + L::VR;
  float* Pm = sm + L::PM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int hk = h / P.group;
  const int hd = P.hd, hd4 = (hd + 3) & ~3;
  const bool vec = P.vec != 0;
  const T* q = static_cast<const T*>(P.q) + b * P.q_sb + h * P.q_sh;
  const T* k = static_cast<const T*>(P.k) + b * P.k_sb + hk * P.k_sh;
  const T* v = static_cast<const T*>(P.v) + b * P.v_sb + hk * P.v_sh;

  if (P.causal) c_hi = min(c_hi, q1);
  if (P.window > 0) c_lo = max(c_lo, q0 - P.window + 1);
  float m[4], l[4], o[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) o[i][j] = 0.f;
  }
  __syncthreads();   // the previous unit's tiles are read
  load_t<T, BQ, BQ>(Qt, q + q0 * P.q_ss, P.q_ss, q1 - q0, hd, hd4, vec);
  const int j_end = c_hi > c_lo ? (c_hi + BK - 1) / BK : 0;
  for (int j = c_hi > c_lo ? c_lo / BK : 0; j < j_end; ++j) {
    const int c0 = j * BK;
    const int nv = min(BK, c_hi - c0);
    __syncthreads();   // the previous tile's P V is done
    load_t<T, BK, BK>(Kt, k + c0 * P.k_ss, P.k_ss, nv, hd, hd4, vec);
    load_r<T, BK, HDP>(Vr, v + c0 * P.v_ss, P.v_ss, nv, hd, HDP, vec);
    __syncthreads();
    float sacc[4][TN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) sacc[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd4; ++d) {
      float a[4], bb[TN];
      lds<4>(a, Qt + d * BQ + ty * 4);
      lds<TN>(bb, Kt + d * BK + tx * TN);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) sacc[i][jj] = fmaf(a[i], bb[jj], sacc[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      float x[TN], mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) {
        const int c = c0 + tx * TN + jj;
        bool ok = c < lim;
        if (P.causal) ok = ok && c <= r;
        if (P.window > 0) ok = ok && r - c < P.window;
        x[jj] = ok ? sacc[i][jj] * P.scale : NEG_INF;
        mx = fmaxf(mx, x[jj]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) {
        x[jj] = expf(x[jj] - m_new);
        sum += x[jj];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < 4 * NJ; ++jj) o[i][jj] *= corr;
      float* prow = Pm + (ty * 4 + i) * L::LDP + tx * TN;
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) prow[jj] = x[jj];
    }
    __syncthreads();
    // O += P V over the tile's columns, 4 at a time
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) lds<4>(pr[i], Pm + (ty * 4 + i) * L::LDP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jc = 0; jc < NJ; ++jc) {
          float vv[4];
          lds<4>(vv, Vr + (c + cc) * HDP + tx * 4 + 64 * jc);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              o[i][jc * 4 + e] = fmaf(pr[i][cc], vv[e], o[i][jc * 4 + e]);
        }
      }
    }
  }
  // epilogue: acc / max(l, 1e-30), dead rows 0
  T* out = static_cast<T*>(P.o) + b * P.o_sb + h * P.o_sh;
  T* out_lo = P.o_lo == nullptr
                  ? nullptr
                  : static_cast<T*>(P.o_lo) + b * P.o_sb + h * P.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= q1) continue;
    const bool alive = m[i] > NEG_INF * 0.5f;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jc = 0; jc < NJ; ++jc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = tx * 4 + 64 * jc + e;
        if (d >= hd) continue;
        const float x = alive ? o[i][jc * 4 + e] / lc : 0.f;
        const T y = Cvt<T>::out(x);
        out[r * P.o_ss + d] = y;
        if (out_lo != nullptr)
          out_lo[r * P.o_ss + d] = Cvt<T>::out(x - Cvt<T>::in(y));
      }
    if (P.lse != nullptr && tx == 0)
      P.lse[(static_cast<long long>(b) * P.H + h) * P.s + r] =
          alive ? m[i] + logf(lc) : __int_as_float(0x7f800000);
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(NT)
flash_dense_simt_kernel(FwdParams P) {
  extern __shared__ __align__(16) float sm[];
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / P.H, h = blockIdx.y % P.H;
  attend_unit<T, HDP>(P, sm, b, h, q0, min(q0 + BQ, P.s), 0, P.s, P.s);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(NT)
flash_sched_simt_kernel(FwdParams P) {
  extern __shared__ __align__(16) float sm[];
  const int* bi = P.desc;
  const int* qi = P.desc + P.G;
  const int* kj = P.desc + 2 * P.G;
  const int* last = P.desc + 4 * P.G;
  const int* lim = P.desc + 5 * P.G;
  const int end = P.bounds[blockIdx.x + 1];
  for (int g = P.bounds[blockIdx.x]; g < end;) {
    int e = g;                 // the group's descriptors are [g, e]
    while (!last[e]) ++e;
    const int lane = bi[g], lm = min(lim[g], P.s);
    const int r_lo = qi[g] * P.block_q, r_hi = min(r_lo + P.block_q, P.s);
    const int c_lo = kj[g] * P.block_k;
    const int c_hi = min((kj[e] + 1) * P.block_k, lm);
    for (int q0 = r_lo; q0 < r_hi; q0 += BQ)
      attend_unit<T, HDP>(P, sm, lane / P.H, lane % P.H, q0,
                          min(q0 + BQ, r_hi), c_lo, c_hi, lm);
    g = e + 1;
  }
}

template <typename T, int HDP>
int launch_hd(const FwdParams& P, bool sched, int p, int batch,
              cudaStream_t st) {
  constexpr int bytes = Tiles<HDP>::BYTES;
  if (sched) {
    int rc = set_smem(reinterpret_cast<const void*>(
                          flash_sched_simt_kernel<T, HDP>), bytes);
    if (rc != 0) return rc;
    flash_sched_simt_kernel<T, HDP><<<p, NT, bytes, st>>>(P);
  } else {
    int rc = set_smem(reinterpret_cast<const void*>(
                          flash_dense_simt_kernel<T, HDP>), bytes);
    if (rc != 0) return rc;
    const dim3 grid((P.s + BQ - 1) / BQ, batch * P.H);
    flash_dense_simt_kernel<T, HDP><<<grid, NT, bytes, st>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const FwdParams& P, bool sched, int p, int batch,
             cudaStream_t st) {
  if (P.hd <= 64) return launch_hd<T, 64>(P, sched, p, batch, st);
  if (P.hd <= 128) return launch_hd<T, 128>(P, sched, p, batch, st);
  return launch_hd<T, 256>(P, sched, p, batch, st);
}

int launch(FwdParams& P, bool sched, int p, int batch, int s, int H,
           int group, int hd, int causal, int window, int dtype,
           const long long* str, float scale, void* stream) {
  if (batch <= 0 || s <= 0 || H <= 0 || group <= 0 || H % group != 0 ||
      hd <= 0 || hd > 256 || (sched && p <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  P.q_sb = str[0]; P.q_sh = str[1]; P.q_ss = str[2];
  P.k_sb = str[3]; P.k_sh = str[4]; P.k_ss = str[5];
  P.v_sb = str[6]; P.v_sh = str[7]; P.v_ss = str[8];
  P.o_sb = str[9]; P.o_sh = str[10]; P.o_ss = str[11];
  P.s = s; P.H = H; P.group = group; P.hd = hd;
  P.causal = causal; P.window = window;
  P.scale = scale;
  // 4-element row loads where every row start is aligned to 4 elements
  const int esz = dtype == F32 ? 4 : 2;
  bool vec = hd % 4 == 0;
  for (int i = 0; i < 9; ++i) vec = vec && str[i] % 4 == 0;
  const void* ptrs[3] = {P.q, P.k, P.v};
  for (const void* ptr : ptrs)
    vec = vec && reinterpret_cast<uintptr_t>(ptr) % (4 * esz) == 0;
  P.vec = vec;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32: return launch_t<float>(P, sched, p, batch, st);
    case BF16: return launch_t<__nv_bfloat16>(P, sched, p, batch, st);
    case F16: return launch_t<__half>(P, sched, p, batch, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (b, s, h, hd), k / v (b, s, kvh, hd) -> o (b, s, h, hd), with `o_lo`
// o's rounding residual (o's strides) and with `lse` each row's
// log-sum-exp (b, h, s); strides (batch, head, row) of q, k, v and o in
// elements
extern "C" int flash_dense_simt_launch(
    const void* q, const void* k, const void* v, void* o, void* o_lo,
    void* lse,
    int batch, int s, int H, int group, int hd, int causal, int window,
    int dtype, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    float scale, void* stream) {
  FwdParams P{};
  P.q = q; P.k = k; P.v = v; P.o = o; P.o_lo = o_lo;
  P.lse = static_cast<float*>(lse);
  const long long str[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                             v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  return launch(P, false, 0, batch, s, H, group, hd, causal, window, dtype,
                str, scale, stream);
}

// the schedule-aware form: the descriptors (6 x G int32) in plan order and
// each CTA's span of them (p + 1 int32)
extern "C" int flash_sched_simt_launch(
    const void* q, const void* k, const void* v, void* o, const void* desc,
    const void* bounds, int G, int p, int batch, int s, int H, int group,
    int hd, int block_q, int block_k, int causal, int window, int dtype,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    float scale, void* stream) {
  if (G < 0 || block_q <= 0 || block_k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdParams P{};
  P.q = q; P.k = k; P.v = v; P.o = o;
  P.desc = static_cast<const int*>(desc);
  P.bounds = static_cast<const int*>(bounds);
  P.G = G; P.block_q = block_q; P.block_k = block_k;
  const long long str[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                             v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  return launch(P, true, p, batch, s, H, group, hd, causal, window, dtype,
                str, scale, stream);
}

extern "C" const char* flash_simt_error_string(int code) {
  return error_string(code);
}
