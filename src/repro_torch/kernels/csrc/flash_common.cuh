// Building blocks shared by the flash-attention kernels for Hopper (sm_90a):
// flash_sched.cu (schedule-aware, DLS-ordered descriptors) and
// flash_dense.cu (dense causal / sliding-window grid).
//
// A CTA of 8 warps owns a 128-row q sub-tile; warp w holds rows
// [16 w, 16 w + 16) as mma.sync A fragments and its online-softmax row state
// (m, l, acc) in registers.  K and V come through shared memory in 64-column
// sub-tiles, staged with cp.async and read with ldmatrix (.trans for V).
// The math is fp32: bf16 products are exact in fp32, so Q K^T on bf16
// tensor cores with fp32 accumulation is fp32 math; P (fp32) is split into
// bf16 hi + lo terms, two MMAs into one fp32 accumulator.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 128;       // q rows per sub-tile: 8 warps x 16
constexpr int BK = 64;        // kv columns per sub-tile
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

// dynamic shared memory of one CTA: two stages of (K, V) sub-tiles
template <int HD>
constexpr int smem_bytes() {
  return 2 * 2 * BK * (HD + 8) * 2;
}

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

// K and V rows [col0, col0 + BK) into one stage (K at Ks, V at Vs, row
// stride HD + 8); rows at or past `cend` are zeros
template <int HD>
__device__ __forceinline__ void load_kv(__nv_bfloat16* Ks, __nv_bfloat16* Vs,
                                        const __nv_bfloat16* kb,
                                        const __nv_bfloat16* vb,
                                        long long k_ss, long long v_ss,
                                        int col0, int cend, int tid) {
  constexpr int KS = HD + 8;
  constexpr int VPR = HD / 8;     // 16-byte vectors per K/V row
  for (int idx = tid; idx < BK * VPR; idx += NTHREADS) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * 8;
    const int col = col0 + r;
    const bool ok = col < cend;
    cp_async16(Ks + r * KS + c, ok ? kb + col * k_ss + c : kb, ok);
    cp_async16(Vs + r * KS + c, ok ? vb + col * v_ss + c : vb, ok);
  }
}

// Q fragments (A operand, 16 rows x HD) straight from device memory; rows
// at or past `qend` are zeros
template <int HD>
__device__ __forceinline__ void load_q(uint32_t (&qf)[HD / 16][4],
                                       const __nv_bfloat16* qb,
                                       long long q_ss, int r_lo, int r_hi,
                                       int qend, int fc) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (i & 1) ? r_hi : r_lo;
      const int col = kk * 16 + fc + ((i & 2) ? 8 : 0);
      qf[kk][i] = row < qend
          ? *reinterpret_cast<const uint32_t*>(qb + row * q_ss + col)
          : 0u;
    }
  }
}

// One 64-column kv sub-tile (staged at Ks / Vs) into the row state of this
// warp's 16 rows: S = Q K^T, scale and mask (columns < climit, causal,
// window), online-softmax update of m and l, acc = acc * corr + P V.
template <int HD>
__device__ __forceinline__ void tile_step(
    const __nv_bfloat16* Ks, const __nv_bfloat16* Vs,
    const uint32_t (&qf)[HD / 16][4], float (&m)[2], float (&l)[2],
    float (&acc)[HD / 8][4], int col0, int climit, int r_lo, int r_hi,
    int causal, int window, float scale, int fc, int lm, int lr) {
  constexpr int KS = HD + 8;

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
      bool ok = col < climit;
      if (causal) ok = ok && col <= row;
      if (window > 0) ok = ok && (row - col) < window;
      const float x = ok ? sacc[nt][i] * scale : NEG_INF;
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
}

// write acc / max(l, 1e-30) as bf16 for rows below `qend`; rows that never
// saw a live column (m <= NEG_INF / 2) are written as 0
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* ob, long long o_ss,
                                           const float (&acc)[HD / 8][4],
                                           const float (&m)[2],
                                           const float (&l)[2], int r_lo,
                                           int r_hi, int qend, int fc) {
  const bool alive0 = m[0] > NEG_INF * 0.5f;
  const bool alive1 = m[1] > NEG_INF * 0.5f;
  const float l0 = fmaxf(l[0], 1e-30f);
  const float l1 = fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    const int col = nt * 8 + fc;
    if (r_lo < qend) {
      *reinterpret_cast<uint32_t*>(ob + r_lo * o_ss + col) = pack_bf16(
          alive0 ? acc[nt][0] / l0 : 0.f, alive0 ? acc[nt][1] / l0 : 0.f);
    }
    if (r_hi < qend) {
      *reinterpret_cast<uint32_t*>(ob + r_hi * o_ss + col) = pack_bf16(
          alive1 ? acc[nt][2] / l1 : 0.f, alive1 ? acc[nt][3] / l1 : 0.f);
    }
  }
}

}  // namespace flash
