// The dense flash-attention backward at every float dtype, for Hopper
// (sm_90a): the general kernels beside flash_dense_bwd.cu and
// flash_f32_bwd.cu, for the calls neither takes: fp16, fp32 and bf16 at a
// head dim or strides TMA cannot describe.  (fp32 at head dims 136-256,
// whose forward runs on flash_simt.cu, has its backward on
// flash_f32_bwd.cu's cluster pairs.)  Its delta pass serves every fp32
// backward of flash_f32_bwd.cu too.
//
// Replaces no Pallas kernel: the reference differentiates _attend_flash
// (src/repro/models/attention.py:191), the pure-JAX twin of _flash_kernel,
// by autodiff, in fp32.  With S = Q K^T scale (masked), the forward's
// log-sum-exp lse (b, h, s), P = exp(S - lse) and D = rowsum(dO o O):
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),  dQ = dS K scale,
//   dK = dS^T Q scale.
// Three passes, as flash_dense_bwd.cu: delta (D, one warp per row), dkdv
// (one CTA per (kv tile, batch, KV head), the group's q heads and their q
// tiles summed in ascending order inside it, so GQA needs no atomics), dq
// (one CTA per (q tile, lane), its kv tiles ascending).  No atomics, no
// split: the gradients are bit-identical from run to run.
//
// What bounds it on an H100: operations on the CUDA cores (plain fp32 FMA,
// SIMT, never TF32; 67 TFLOP/s): dkdv computes S, dP, dV and dK, dq S, dP
// and dQ, 7 products against the forward's 2.
//
// Tiles and shared memory (HDP: the head dim padded to 64, 128 or 256,
// zero-filled; the products stop at the head dim rounded up to 4; rows of
// the row-major tiles padded by 4 floats):
//   dkdv: K^T, V^T resident (HDP x BK); per q tile Q^T, dO^T (HDP x BQ) for
//     S^T and dP^T, Q, dO (BQ x HDP) row-major for dK and dV, P and dS
//     (BQ x BK).  (BK, BQ) = (64, 64) at HDP 64 (133 KB), (64, 32) at 128
//     (146 KB), (32, 32) at 256 (202 KB).
//   dq: Q^T, dO^T resident (HDP x BQ); per kv tile K^T, V^T (HDP x BK) for S
//     and dP, K (BK x HDP) row-major for dQ, dS^T (BK x BQ).  (BQ, BK) =
//     (64, 64) at HDP 64 (99 KB) and 128 (179 KB), (32, 32) at 256 (165 KB).
// 256 threads as 16 x 16; a thread owns a block of S (S^T in dkdv) and the
// matching rows of its output times the columns 4 tx + 64 j.

#include <math.h>

#include "simt_common.cuh"

namespace {

using namespace simt;

constexpr int NT = 256;

struct BwdParams {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;   // (b, h, s)
  void *dq, *dk, *dv;
  // strides (batch, head, row) of q / dq / dout / o and of k / v / dk / dv:
  // all contiguous (b, s, heads, hd)
  int s, H, group, hd, causal, window, vec;
  float scale;
};

__device__ __forceinline__ bool live(const BwdParams& P, int r, int c) {
  bool ok = r < P.s && c < P.s;
  if (P.causal) ok = ok && c <= r;
  if (P.window > 0) ok = ok && r - c < P.window;
  return ok;
}

// ---------------------------------------------------------------- delta ---
// one warp per (b, row, head): D = sum_d dO o O in fp32 at (b, head, row).
// o_lo, where given, is the forward's rounding residual of O (fp16: O -
// fp16(O) in fp16), so that D is that of the fp32 O as in the reference
template <typename T>
__global__ void __launch_bounds__(128)
delta_simt_kernel(const T* __restrict__ o, const T* __restrict__ o_lo,
                  const T* __restrict__ dout, float* __restrict__ delta,
                  int batch, int s, int H, int hd) {
  const long long row = static_cast<long long>(blockIdx.x) * 4 + threadIdx.x / 32;
  if (row >= static_cast<long long>(batch) * s * H) return;
  const int lane = threadIdx.x % 32;
  const T* orow = o + row * hd;
  const T* drow = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) {
    float a = Cvt<T>::in(orow[d]);
    if (o_lo != nullptr) a += Cvt<T>::in(o_lo[row * hd + d]);
    acc = fmaf(Cvt<T>::in(drow[d]), a, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffff, acc, off);
  if (lane == 0) {
    // row = (b * s + i) * H + head
    const long long head = row % H, bi = row / H;
    const long long b = bi / s, i = bi % s;
    delta[(b * H + head) * s + i] = acc;
  }
}

// ----------------------------------------------------------------- dkdv ---
template <int HDP>
struct KvTiles {
  static constexpr int BK = HDP == 256 ? 32 : 64;
  static constexpr int BQ = HDP == 64 ? 64 : 32;
  static constexpr int LDR = HDP + 4, LDP = BK + 4;
  static constexpr int KT = 0;                     // K^T [HDP][BK]
  static constexpr int VT = KT + HDP * BK;         // V^T [HDP][BK]
  static constexpr int QT = VT + HDP * BK;         // Q^T [HDP][BQ]
  static constexpr int OT = QT + HDP * BQ;         // dO^T [HDP][BQ]
  static constexpr int QR = OT + HDP * BQ;         // Q [BQ][LDR]
  static constexpr int OR = QR + BQ * LDR;         // dO [BQ][LDR]
  static constexpr int PM = OR + BQ * LDR;         // P [BQ][LDP]
  static constexpr int SM = PM + BQ * LDP;         // dS [BQ][LDP]
  static constexpr int LS = SM + BQ * LDP;         // lse, D [2][BQ]
  static constexpr int BYTES = (LS + 2 * BQ) * 4;
};

template <typename T, int HDP>
__global__ void __launch_bounds__(NT)
dkdv_simt_kernel(BwdParams P) {
  using L = KvTiles<HDP>;
  constexpr int BK = L::BK, BQ = L::BQ, TC = BK / 16, TR = BQ / 16,
                NJ = HDP / 64;
  extern __shared__ __align__(16) float sm[];
  float *Kt = sm + L::KT, *Vt = sm + L::VT, *Qt = sm + L::QT,
        *Ot = sm + L::OT, *Qr = sm + L::QR, *Or = sm + L::OR,
        *Pm = sm + L::PM, *Sm = sm + L::SM, *Ls = sm + L::LS, *Ds = Ls + BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int KVH = P.H / P.group;
  const int b = blockIdx.y / KVH, hk = blockIdx.y % KVH;
  const int c0 = blockIdx.x * BK, c1 = min(c0 + BK, P.s);
  const int hd = P.hd, hd4 = (hd + 3) & ~3;
  const bool vec = P.vec != 0;
  const long long qrs = static_cast<long long>(P.H) * hd;   // row strides
  const long long krs = static_cast<long long>(KVH) * hd;
  const long long kv_off = (static_cast<long long>(b) * P.s + c0) * krs + hk * hd;
  load_t<T, BK, BK>(Kt, static_cast<const T*>(P.k) + kv_off, krs, c1 - c0,
                    hd, hd4, vec);
  load_t<T, BK, BK>(Vt, static_cast<const T*>(P.v) + kv_off, krs, c1 - c0,
                    hd, hd4, vec);
  float dv[TC][4 * NJ], dk[TC][4 * NJ];
#pragma unroll
  for (int i = 0; i < TC; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) dv[i][j] = dk[i][j] = 0.f;
  // the q rows that see a column of the tile
  const int r_lo = P.causal ? (c0 / BQ) * BQ : 0;
  const int r_hi = P.window > 0 ? min(P.s, c1 - 1 + P.window) : P.s;
  for (int h = hk * P.group; h < (hk + 1) * P.group; ++h) {
    const long long lrow = (static_cast<long long>(b) * P.H + h) * P.s;
    for (int r0 = r_lo; r0 < r_hi; r0 += BQ) {
      const int nv = min(BQ, P.s - r0);
      const long long q_off = (static_cast<long long>(b) * P.s + r0) * qrs + h * hd;
      const T* q = static_cast<const T*>(P.q) + q_off;
      const T* d_o = static_cast<const T*>(P.dout) + q_off;
      __syncthreads();   // the previous q tile's products are done
      load_t<T, BQ, BQ>(Qt, q, qrs, nv, hd, hd4, vec);
      load_t<T, BQ, BQ>(Ot, d_o, qrs, nv, hd, hd4, vec);
      load_r<T, BQ, L::LDR>(Qr, q, qrs, nv, hd, HDP, vec);
      load_r<T, BQ, L::LDR>(Or, d_o, qrs, nv, hd, HDP, vec);
      for (int i = threadIdx.x; i < BQ; i += NT) {
        Ls[i] = i < nv ? P.lse[lrow + r0 + i] : 0.f;
        Ds[i] = i < nv ? P.delta[lrow + r0 + i] : 0.f;
      }
      __syncthreads();
      // S^T and dP^T: columns ty*TC.., rows tx*TR..
      float st[TC][TR], dpt[TC][TR];
#pragma unroll
      for (int i = 0; i < TC; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < hd4; ++d) {
        float kk[TC], vv[TC], qq[TR], oo[TR];
        lds<TC>(kk, Kt + d * BK + ty * TC);
        lds<TC>(vv, Vt + d * BK + ty * TC);
        lds<TR>(qq, Qt + d * BQ + tx * TR);
        lds<TR>(oo, Ot + d * BQ + tx * TR);
#pragma unroll
        for (int i = 0; i < TC; ++i)
#pragma unroll
          for (int j = 0; j < TR; ++j) {
            st[i][j] = fmaf(kk[i], qq[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], oo[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < TC; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j) {
          const int rr = tx * TR + j, cc = ty * TC + i;
          const float p = live(P, r0 + rr, c0 + cc)
                              ? expf(st[i][j] * P.scale - Ls[rr]) : 0.f;
          Pm[rr * L::LDP + cc] = p;
          Sm[rr * L::LDP + cc] = p * (dpt[i][j] - Ds[rr]);
        }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over the tile's rows
      for (int r = 0; r < nv; ++r) {
        float pv[TC], sv[TC];
        lds<TC>(pv, Pm + r * L::LDP + ty * TC);
        lds<TC>(sv, Sm + r * L::LDP + ty * TC);
#pragma unroll
        for (int jc = 0; jc < NJ; ++jc) {
          float oo[4], qq[4];
          lds<4>(oo, Or + r * L::LDR + tx * 4 + 64 * jc);
          lds<4>(qq, Qr + r * L::LDR + tx * 4 + 64 * jc);
#pragma unroll
          for (int i = 0; i < TC; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dv[i][jc * 4 + e] = fmaf(pv[i], oo[e], dv[i][jc * 4 + e]);
              dk[i][jc * 4 + e] = fmaf(sv[i], qq[e], dk[i][jc * 4 + e]);
            }
        }
      }
    }
  }
  T* dkp = static_cast<T*>(P.dk) + kv_off;
  T* dvp = static_cast<T*>(P.dv) + kv_off;
#pragma unroll
  for (int i = 0; i < TC; ++i) {
    const int c = ty * TC + i;
    if (c0 + c >= c1) continue;
#pragma unroll
    for (int jc = 0; jc < NJ; ++jc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = tx * 4 + 64 * jc + e;
        if (d >= hd) continue;
        dkp[c * krs + d] = Cvt<T>::out(dk[i][jc * 4 + e] * P.scale);
        dvp[c * krs + d] = Cvt<T>::out(dv[i][jc * 4 + e]);
      }
  }
}

// ------------------------------------------------------------------- dq ---
template <int HDP>
struct QTiles {
  static constexpr int BQ = HDP == 256 ? 32 : 64;
  static constexpr int BK = BQ;
  static constexpr int LDR = HDP + 4, LDS = BQ + 4;
  static constexpr int QT = 0;                     // Q^T [HDP][BQ]
  static constexpr int OT = QT + HDP * BQ;         // dO^T [HDP][BQ]
  static constexpr int KT = OT + HDP * BQ;         // K^T [HDP][BK]
  static constexpr int VT = KT + HDP * BK;         // V^T [HDP][BK]
  static constexpr int KR = VT + HDP * BK;         // K [BK][LDR]
  static constexpr int SM = KR + BK * LDR;         // dS^T [BK][LDS]
  static constexpr int LS = SM + BK * LDS;         // lse, D [2][BQ]
  static constexpr int BYTES = (LS + 2 * BQ) * 4;
};

template <typename T, int HDP>
__global__ void __launch_bounds__(NT)
dq_simt_kernel(BwdParams P) {
  using L = QTiles<HDP>;
  constexpr int BK = L::BK, BQ = L::BQ, TC = BK / 16, TR = BQ / 16,
                NJ = HDP / 64;
  extern __shared__ __align__(16) float sm[];
  float *Qt = sm + L::QT, *Ot = sm + L::OT, *Kt = sm + L::KT,
        *Vt = sm + L::VT, *Kr = sm + L::KR, *Sm = sm + L::SM,
        *Ls = sm + L::LS, *Ds = Ls + BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int KVH = P.H / P.group;
  const int b = blockIdx.y / P.H, h = blockIdx.y % P.H, hk = h / P.group;
  const int r0 = blockIdx.x * BQ, r1 = min(r0 + BQ, P.s);
  const int hd = P.hd, hd4 = (hd + 3) & ~3;
  const bool vec = P.vec != 0;
  const long long qrs = static_cast<long long>(P.H) * hd;
  const long long krs = static_cast<long long>(KVH) * hd;
  const long long q_off = (static_cast<long long>(b) * P.s + r0) * qrs + h * hd;
  const long long lrow = (static_cast<long long>(b) * P.H + h) * P.s;
  load_t<T, BQ, BQ>(Qt, static_cast<const T*>(P.q) + q_off, qrs, r1 - r0, hd,
                    hd4, vec);
  load_t<T, BQ, BQ>(Ot, static_cast<const T*>(P.dout) + q_off, qrs, r1 - r0,
                    hd, hd4, vec);
  for (int i = threadIdx.x; i < BQ; i += NT) {
    Ls[i] = r0 + i < r1 ? P.lse[lrow + r0 + i] : 0.f;
    Ds[i] = r0 + i < r1 ? P.delta[lrow + r0 + i] : 0.f;
  }
  float dq[TR][4 * NJ];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) dq[i][j] = 0.f;
  const int c_lo = P.window > 0 ? max(0, r0 - P.window + 1) : 0;
  const int c_hi = P.causal ? r1 : P.s;
  for (int c0 = (c_lo / BK) * BK; c0 < c_hi; c0 += BK) {
    const int nv = min(BK, P.s - c0);
    const long long kv_off = (static_cast<long long>(b) * P.s + c0) * krs + hk * hd;
    __syncthreads();   // the previous kv tile's dQ product is done
    load_t<T, BK, BK>(Kt, static_cast<const T*>(P.k) + kv_off, krs, nv, hd,
                      hd4, vec);
    load_t<T, BK, BK>(Vt, static_cast<const T*>(P.v) + kv_off, krs, nv, hd,
                      hd4, vec);
    load_r<T, BK, L::LDR>(Kr, static_cast<const T*>(P.k) + kv_off, krs, nv,
                          hd, HDP, vec);
    __syncthreads();
    float sc[TR][TC], dp[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < hd4; ++d) {
      float qq[TR], oo[TR], kk[TC], vv[TC];
      lds<TR>(qq, Qt + d * BQ + ty * TR);
      lds<TR>(oo, Ot + d * BQ + ty * TR);
      lds<TC>(kk, Kt + d * BK + tx * TC);
      lds<TC>(vv, Vt + d * BK + tx * TC);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          sc[i][j] = fmaf(qq[i], kk[j], sc[i][j]);
          dp[i][j] = fmaf(oo[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int rr = ty * TR + i, cc = tx * TC + j;
        const float p = live(P, r0 + rr, c0 + cc)
                            ? expf(sc[i][j] * P.scale - Ls[rr]) : 0.f;
        Sm[cc * L::LDS + rr] = p * (dp[i][j] - Ds[rr]);
      }
    __syncthreads();
    for (int c = 0; c < nv; ++c) {
      float sv[TR];
      lds<TR>(sv, Sm + c * L::LDS + ty * TR);
#pragma unroll
      for (int jc = 0; jc < NJ; ++jc) {
        float kk[4];
        lds<4>(kk, Kr + c * L::LDR + tx * 4 + 64 * jc);
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dq[i][jc * 4 + e] = fmaf(sv[i], kk[e], dq[i][jc * 4 + e]);
      }
    }
  }
  T* dqp = static_cast<T*>(P.dq) + q_off;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = ty * TR + i;
    if (r0 + r >= r1) continue;
#pragma unroll
    for (int jc = 0; jc < NJ; ++jc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = tx * 4 + 64 * jc + e;
        if (d < hd) dqp[r * qrs + d] = Cvt<T>::out(dq[i][jc * 4 + e] * P.scale);
      }
  }
}

template <typename T, int HDP>
int launch_hd(const BwdParams& P, int pass, int batch, cudaStream_t st) {
  if (pass == 0) {
    constexpr int bytes = KvTiles<HDP>::BYTES;
    int rc = set_smem(reinterpret_cast<const void*>(dkdv_simt_kernel<T, HDP>),
                      bytes);
    if (rc != 0) return rc;
    const dim3 grid((P.s + KvTiles<HDP>::BK - 1) / KvTiles<HDP>::BK,
                    batch * (P.H / P.group));
    dkdv_simt_kernel<T, HDP><<<grid, NT, bytes, st>>>(P);
  } else {
    constexpr int bytes = QTiles<HDP>::BYTES;
    int rc = set_smem(reinterpret_cast<const void*>(dq_simt_kernel<T, HDP>),
                      bytes);
    if (rc != 0) return rc;
    const dim3 grid((P.s + QTiles<HDP>::BQ - 1) / QTiles<HDP>::BQ,
                    batch * P.H);
    dq_simt_kernel<T, HDP><<<grid, NT, bytes, st>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const BwdParams& P, int pass, int batch, cudaStream_t st) {
  if (P.hd <= 64) return launch_hd<T, 64>(P, pass, batch, st);
  if (P.hd <= 128) return launch_hd<T, 128>(P, pass, batch, st);
  return launch_hd<T, 256>(P, pass, batch, st);
}

int launch(int pass, const void* q, const void* k, const void* v,
           const void* dout, const void* lse, const void* delta, void* dq,
           void* dk, void* dv, int batch, int s, int H, int group, int hd,
           int causal, int window, int dtype, float scale, void* stream) {
  if (batch <= 0 || s <= 0 || H <= 0 || group <= 0 || H % group != 0 ||
      hd <= 0 || hd > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams P{};
  P.q = q; P.k = k; P.v = v; P.dout = dout;
  P.lse = static_cast<const float*>(lse);
  P.delta = static_cast<const float*>(delta);
  P.dq = dq; P.dk = dk; P.dv = dv;
  P.s = s; P.H = H; P.group = group; P.hd = hd;
  P.causal = causal; P.window = window; P.scale = scale;
  // 4-element row loads: rows of hd elements from 4-element aligned bases
  const uintptr_t align = 4 * (dtype == F32 ? 4 : 2);
  P.vec = hd % 4 == 0 && reinterpret_cast<uintptr_t>(q) % align == 0 &&
          reinterpret_cast<uintptr_t>(k) % align == 0 &&
          reinterpret_cast<uintptr_t>(v) % align == 0 &&
          reinterpret_cast<uintptr_t>(dout) % align == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32: return launch_t<float>(P, pass, batch, st);
    case BF16: return launch_t<__nv_bfloat16>(P, pass, batch, st);
    case F16: return launch_t<__half>(P, pass, batch, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// D (b, h, s) = rowsum(dout o (o + o_lo)) of o, dout (b, s, h, hd),
// contiguous, and o_lo (o's rounding residual, the same layout) or null
extern "C" int flash_simt_bwd_delta_launch(const void* o, const void* o_lo,
                                           const void* dout, void* delta,
                                           int batch, int s, int H, int hd,
                                           int dtype, void* stream) {
  if (batch <= 0 || s <= 0 || H <= 0 || hd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(batch) * s * H;
  const unsigned grid = static_cast<unsigned>((rows + 3) / 4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* d = static_cast<float*>(delta);
  switch (dtype) {
    case F32:
      delta_simt_kernel<float><<<grid, 128, 0, st>>>(
          static_cast<const float*>(o), static_cast<const float*>(o_lo),
          static_cast<const float*>(dout), d, batch, s, H, hd);
      break;
    case BF16:
      delta_simt_kernel<__nv_bfloat16><<<grid, 128, 0, st>>>(
          static_cast<const __nv_bfloat16*>(o),
          static_cast<const __nv_bfloat16*>(o_lo),
          static_cast<const __nv_bfloat16*>(dout), d, batch, s, H, hd);
      break;
    case F16:
      delta_simt_kernel<__half><<<grid, 128, 0, st>>>(
          static_cast<const __half*>(o), static_cast<const __half*>(o_lo),
          static_cast<const __half*>(dout), d, batch, s, H, hd);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dK, dV (b, s, kvh, hd) of q (b, s, h, hd), k, v (b, s, kvh, hd), dout, the
// forward's lse and D (b, h, s); all contiguous
extern "C" int flash_simt_bwd_dkdv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch, int s,
    int H, int group, int hd, int causal, int window, int dtype, float scale,
    void* stream) {
  return launch(0, q, k, v, dout, lse, delta, nullptr, dk, dv, batch, s, H,
                group, hd, causal, window, dtype, scale, stream);
}

// dQ (b, s, h, hd), as dkdv
extern "C" int flash_simt_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int batch, int s, int H,
    int group, int hd, int causal, int window, int dtype, float scale,
    void* stream) {
  return launch(1, q, k, v, dout, lse, delta, dq, nullptr, nullptr, batch, s,
                H, group, hd, causal, window, dtype, scale, stream);
}

extern "C" const char* flash_simt_bwd_error_string(int code) {
  return error_string(code);
}
